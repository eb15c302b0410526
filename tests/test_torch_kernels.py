"""The port's two kernels: each plain PyTorch version against the Pallas
TPU kernel it stands beside (run in interpret mode, as the JAX package's
own tests run it on the CPU), and -- on a machine with a card -- each CUDA
kernel against its plain version (marked `cuda`; skipped without one).

The JAX imports sit inside the tests that compare with JAX, so the `cuda`
tests also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.ops.quant import quantize_tensor
from nemotron_tpu_torch.ops.quant_kernel import (SPLITK_MAX_M, TILED_BM,
                                                 TILED_BN,
                                                 q8_launch_geometry,
                                                 q8_matmul, q8_matmul_as,
                                                 q8_matmul_ref,
                                                 splitk_geometry,
                                                 tiled_geometry)
from nemotron_tpu_torch.ops.ring_attn_kernel import (cluster_size,
                                                     fused_ring_attention,
                                                     pack_int4,
                                                     ring_attention_ref)

torch.set_num_threads(1)

# (Q, KV) of the four latency modes R = 0, 1, 6, 13 at full width
MODE_SHAPES = [(CacheConfig(att_right_context=r).chunk_enc_len,
                CacheConfig(att_right_context=r).kv_len) for r in (0, 1, 6, 13)]
# the encoder's (K, N) matmul shapes at full width
Q8_SHAPES = [(1024, 1024), (1024, 4096), (4096, 1024), (1024, 2048)]
H100_SMS = 132
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ring_inputs(rng, L=3, B=2, H=4, Q=3, KV=9, Dh=16, int8=False):
    f = np.float32
    x = dict(q_u=rng.standard_normal((B, H, Q, Dh)).astype(f),
             k_new=rng.standard_normal((B, H, Q, Dh)).astype(f),
             v_new=rng.standard_normal((B, H, Q, Dh)).astype(f),
             a=rng.standard_normal((B, H, Q, KV + Q)).astype(f))
    if int8:
        x["k_ring"] = rng.integers(-127, 128, (L, B, H, KV, Dh)).astype(np.int8)
        x["v_ring"] = rng.integers(-127, 128, (L, B, H, KV, Dh)).astype(np.int8)
        x["k_cols"] = (rng.random((B, H, KV)) * 0.02).astype(f)
        x["v_cols"] = (rng.random((B, H, KV)) * 0.02).astype(f)
    else:
        x["k_ring"] = rng.standard_normal((L, B, H, KV, Dh)).astype(f)
        x["v_ring"] = rng.standard_normal((L, B, H, KV, Dh)).astype(f)
        x["k_cols"] = np.ones((B, H, KV), f)
        x["v_cols"] = np.ones((B, H, KV), f)
    return x


def call(fn, layer, x, conv, **kw):
    return fn(layer, conv(x["q_u"]), conv(x["k_new"]), conv(x["v_new"]),
              conv(x["k_ring"]), conv(x["v_ring"]), conv(x["a"]),
              conv(x["k_cols"]), conv(x["v_cols"]), **kw)


def test_mode_shapes_are_the_latency_modes():
    assert MODE_SHAPES == [(1, 71), (2, 72), (7, 77), (14, 84)]


@pytest.mark.parametrize("Q,KV", [(3, 9)] + MODE_SHAPES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layer", [0, 2])
def test_ring_attention_ref_matches_pallas_interpret(int8, layer, Q, KV):
    import jax.numpy as jnp

    from nemotron_tpu.ops.ring_attn_kernel import (
        fused_ring_attention as pallas_ring_attention)

    x = ring_inputs(np.random.default_rng(5 + layer + Q), H=2, Q=Q, KV=KV,
                    int8=int8)
    want = call(pallas_ring_attention, layer, x, jnp.asarray, block_b=2,
                interpret=True)
    got = call(ring_attention_ref, layer, x, torch.tensor)
    # the tolerance of the JAX package's fused-vs-einsum encoder test
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    cpu = call(fused_ring_attention, layer, x, torch.tensor)  # CPU -> plain
    np.testing.assert_array_equal(cpu.numpy(), got.numpy())


@pytest.mark.parametrize("M", [1, 8, 14, 37, 300, 128, 804, 896])
def test_q8_matmul_ref_matches_pallas_interpret(M):
    import jax.numpy as jnp

    from nemotron_tpu.ops import quant as jquant
    from nemotron_tpu.ops.quant_kernel import q8_matmul as pallas_q8_matmul

    rng = np.random.default_rng(M)
    K, N = 512, 256
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    x = rng.standard_normal((M, K), dtype=np.float32)
    qt = jquant.quantize_tensor(w)
    want = np.asarray(pallas_q8_matmul(jnp.asarray(x), jnp.asarray(qt.q),
                                       jnp.asarray(qt.scale), interpret=True))
    got = q8_matmul_ref(torch.tensor(x), torch.tensor(qt.q),
                        torch.tensor(qt.scale))
    assert tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    cpu = q8_matmul(torch.tensor(x), torch.tensor(qt.q), torch.tensor(qt.scale))
    np.testing.assert_array_equal(cpu.numpy(), got.numpy())


def test_q8_matmul_ref_rounds_weights_to_the_activation_dtype():
    """bf16 activations: the dequantized weight is rounded to bf16 (as the
    TPU kernel's `.astype(x_ref.dtype)`), the sum stays f32."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.integers(-127, 128, (64, 8)).astype(np.int8))
    s = torch.tensor(rng.random((2, 8)).astype(np.float32) * 1e-2)
    x = torch.tensor(rng.standard_normal((3, 64)).astype(np.float32))
    w = (q.float().reshape(2, 32, 8) * s[:, None]).reshape(64, 8)
    want = (x.bfloat16().float() @ w.bfloat16().float()).bfloat16()
    got = q8_matmul_ref(x.bfloat16(), q, s)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("K,N", Q8_SHAPES)
def test_q8_launch_geometry_fills_an_h100(K, N):
    """The skinny design (M <= M*): one launch a call, at least one full
    wave of blocks on an H100 for every encoder shape at any of its M,
    clusters of at most 8 blocks, whole 32-row scale blocks per cluster
    rank; the grid does not depend on M."""
    grids = set()
    for M in (1, 14, SPLITK_MAX_M):
        g = q8_launch_geometry(M, K, N, H100_SMS)
        assert g.design == "splitk"
        assert g.blocks >= H100_SMS
        assert g.bn in (32, 64) and 1 <= g.split <= 8 and K // 32 >= g.split
        assert g.blocks == -(-N // g.bn) * g.split
        grids.add((g.bn, g.split, g.blocks))
    assert len(grids) == 1


@pytest.mark.parametrize("K,N,want", [(96, 56, (32, 3, 6)),
                                      (32, 4096, (32, 1, 128)),
                                      (1024, 1024, (32, 8, 256))])
def test_q8_launch_geometry_small_and_odd_shapes(K, N, want):
    for M in (1, SPLITK_MAX_M):
        g = q8_launch_geometry(M, K, N, H100_SMS)
        assert g.design == "splitk" and (g.bn, g.split, g.blocks) == want


@pytest.mark.parametrize("M,design,bm", [
    (1, "splitk", 1), (2, "splitk", 2), (3, "splitk", 4), (8, "splitk", 8),
    (9, "splitk", 16), (14, "splitk", 16), (SPLITK_MAX_M - 1, "splitk", 16),
    (SPLITK_MAX_M, "splitk", 16), (SPLITK_MAX_M + 1, "tiled", TILED_BM),
    (112, "tiled", TILED_BM), (804, "tiled", TILED_BM),
    (896, "tiled", TILED_BM), (4096, "tiled", TILED_BM)])
def test_q8_launch_geometry_picks_the_design_by_m(M, design, bm):
    """The skinny design up to M* = 96 rows, the crossover measured on an
    H100 (its row tile 1, 2, 4, 8 or 16), the tiled one (128 x 128 output
    tiles) above, for every encoder shape."""
    assert SPLITK_MAX_M == 96 and (TILED_BM, TILED_BN) == (128, 128)
    for K, N in Q8_SHAPES:
        g = q8_launch_geometry(M, K, N, H100_SMS)
        assert (g.design, g.bm) == (design, bm)
        want = (splitk_geometry if design == "splitk" else tiled_geometry)(
            M, K, N, H100_SMS)
        assert g == want


@pytest.mark.parametrize("M", [804, 896])
@pytest.mark.parametrize("K,N", Q8_SHAPES)
def test_q8_tiled_geometry_fills_an_h100_at_large_m(K, N, M):
    """The full-utterance encoder's M = 804 and the 64-slot engine's 896:
    at least one block an SM for every encoder shape, with the least split
    that gives it."""
    g = q8_launch_geometry(M, K, N, H100_SMS)
    tiles = -(-M // TILED_BM) * -(-N // TILED_BN)
    assert g.design == "tiled" and (g.bm, g.bn) == (TILED_BM, TILED_BN)
    assert g.blocks == tiles * g.split >= H100_SMS
    assert g.split == 1 or tiles * (g.split // 2) < H100_SMS


@pytest.mark.parametrize("K", [32, 64, 96, 160, 1024, 4096])
@pytest.mark.parametrize("N", [56, 1024])
def test_q8_tiled_split_takes_whole_scale_blocks(K, N):
    """Each rank of a cluster takes a run of whole 32-row scale blocks, at
    least one, in order (the kernel's partition r * nsb / split), and a
    cluster has 1, 2, 4 or 8 blocks; a forced split keeps its value."""
    nsb = K // 32
    for M in (SPLITK_MAX_M + 1, 300, 896):
        g = tiled_geometry(M, K, N, H100_SMS)
        assert g.split in (1, 2, 4, 8) and g.split <= nsb
        runs = [(r * nsb // g.split, (r + 1) * nsb // g.split)
                for r in range(g.split)]
        assert runs[0][0] == 0 and runs[-1][1] == nsb
        assert all(b > a for a, b in runs)
        assert all(runs[i][1] == runs[i + 1][0] for i in range(g.split - 1))
    for split in (1, 2, 4, 8):
        if split <= nsb:
            assert tiled_geometry(896, K, N, H100_SMS, split).split == split


@pytest.mark.parametrize("M,K,N,want", [
    (300, 96, 56, (2, 6)), (170, 64, 40, (2, 4)), (165, 32, 136, (1, 4)),
    (200, 1024, 1024, (8, 128)), (SPLITK_MAX_M + 1, 4096, 1024, (8, 64))])
def test_q8_tiled_geometry_small_and_odd_shapes(M, K, N, want):
    """Small K caps the split at K/32; small grids take the largest split
    that K allows; ragged M and N round up to whole tiles."""
    g = q8_launch_geometry(M, K, N, H100_SMS)
    assert g.design == "tiled" and (g.split, g.blocks) == want


def test_ring_attention_cluster_gives_32_blocks_at_one_stream():
    H, C = 8, cluster_size(128)
    assert 1 <= C <= 8
    assert 1 * H * C >= 32
    assert 128 % (4 * C) == 0    # Dh = 128: 4-column groups per rank


def test_ring_attention_cluster_size_follows_dh():
    """The largest C <= 8 with Dh % (4 C) == 0: the full model's Dh = 128,
    Dh = 64, and the trained fixtures' Dh = 16 (d_model 128, 8 heads)."""
    assert [cluster_size(d) for d in (128, 64, 16, 48)] == [8, 8, 4, 6]
    for bad in (8, 24, 0):
        with pytest.raises(ValueError, match="multiple of 16"):
            cluster_size(bad)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def card_ring_inputs(device, B, Q, KV, dtype, int8, seed=11):
    """Full-width ring-attention inputs on the card: compute-dtype
    operands in `dtype`, rings int8 or in `dtype`, f32 dequant columns."""
    x = ring_inputs(np.random.default_rng(seed), L=24, B=B, H=8, Q=Q, KV=KV,
                    Dh=128, int8=int8)
    keep = {"k_cols", "v_cols"} | ({"k_ring", "v_ring"} if int8 else set())
    return {k: torch.tensor(v, device=device) if k in keep
            else torch.tensor(v, device=device).to(dtype)
            for k, v in x.items()}


def ident(a):
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,KV", MODE_SHAPES)
@pytest.mark.parametrize("int8", [False, True])
def test_ring_attention_kernel_matches_plain_on_card(cuda_device, int8, Q, KV,
                                                     dtype, B):
    dt = getattr(torch, dtype)
    x = card_ring_inputs(cuda_device, B, Q, KV, dt, int8)
    before = fused_ring_attention.launches
    got = call(fused_ring_attention, 7, x, ident)
    want = call(ring_attention_ref, 7, x, ident)
    torch.cuda.synchronize()
    assert fused_ring_attention.launches == before + 1
    assert got.dtype == dt and got.shape == want.shape
    # f32: the same products summed in another order (the JAX package's
    # fused-vs-einsum test holds 2e-5); bf16: one rounding of the f32
    # context, two bf16 ulps of the largest output
    scale = max(want.float().abs().max().item(), 1.0)
    atol = 1e-5 if dt == torch.float32 else 2.0 ** -6 * scale
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8", [("float32", False), ("bfloat16", True)])
@pytest.mark.parametrize("Q,KV", MODE_SHAPES)
@pytest.mark.parametrize("Dh", [16, 64])
def test_ring_attention_kernel_small_heads_on_card(cuda_device, Dh, Q, KV,
                                                   dtype, int8):
    """Dh = 16 (clusters of 4) and Dh = 64 (clusters of 8) at the same
    tolerances as Dh = 128."""
    dt = getattr(torch, dtype)
    x = ring_inputs(np.random.default_rng(Dh + Q), L=3, B=2, H=8, Q=Q, KV=KV,
                    Dh=Dh, int8=int8)
    keep = {"k_cols", "v_cols"} | ({"k_ring", "v_ring"} if int8 else set())
    x = {k: torch.tensor(v, device=cuda_device) if k in keep
         else torch.tensor(v, device=cuda_device).to(dt)
         for k, v in x.items()}
    before = fused_ring_attention.launches
    got = call(fused_ring_attention, 2, x, ident)
    want = call(ring_attention_ref, 2, x, ident)
    torch.cuda.synchronize()
    assert fused_ring_attention.launches == before + 1
    scale = max(want.float().abs().max().item(), 1.0)
    atol = 1e-5 if dt == torch.float32 else 2.0 ** -6 * scale
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def int4_ring_inputs(rng, device, dtype, **shape):
    """Ring-attention inputs over packed int4 rings: values uniform in
    [-7, 7] and column scales of an amax/7 size, so that the dequantized
    K/V are O(1) and the ring carries most of the output."""
    x = ring_inputs(rng, int8=True, **shape)
    for k in ("k_ring", "v_ring"):
        x[k] = rng.integers(-7, 8, x[k].shape).astype(np.int8)
    for k in ("k_cols", "v_cols"):
        x[k] = (rng.random(x[k].shape) * 0.3).astype(np.float32)
    return {k: torch.tensor(v, device=device) if k in ("k_cols", "v_cols")
            else pack_int4(torch.tensor(v, device=device))
            if k in ("k_ring", "v_ring")
            else torch.tensor(v, device=device).to(dtype)
            for k, v in x.items()}


def swap_nibbles(p):
    """Packed int4 bytes with their two nibbles exchanged: what a kernel
    that unpacked the pairs in the wrong order would read."""
    v = p.to(torch.int32) & 0xFF
    return (((v & 0xF) << 4) | (v >> 4)).to(torch.uint8).view(torch.int8)


def attn_atol(dt, want):
    """f32: the same products summed in another order; bf16: one rounding
    of the f32 context, two bf16 ulps of the largest output (at least 1)."""
    scale = max(want.float().abs().max().item(), 1.0)
    return 1e-5 if dt == torch.float32 else 2.0 ** -6 * scale


@pytest.mark.parametrize("Dh", [16, 128])
def test_int4_ring_inputs_see_a_nibble_swap(Dh):
    """The int4 inputs are sensitive enough that a ring read with its
    nibbles swapped misses the bf16 tolerance by a wide margin."""
    Q, KV = MODE_SHAPES[-1]
    dt = torch.bfloat16
    x = int4_ring_inputs(np.random.default_rng(Dh), "cpu", dt, L=2, B=2,
                         H=8, Q=Q, KV=KV, Dh=Dh)
    want = call(ring_attention_ref, 1, x, ident, packed_int4=True)
    swapped = dict(x, k_ring=swap_nibbles(x["k_ring"]),
                   v_ring=swap_nibbles(x["v_ring"]))
    assert torch.equal(swap_nibbles(swapped["k_ring"]), x["k_ring"])
    wrong = call(ring_attention_ref, 1, swapped, ident, packed_int4=True)
    err = (wrong.float() - want.float()).abs().max().item()
    assert err > 4 * attn_atol(dt, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,KV", MODE_SHAPES)
@pytest.mark.parametrize("Dh", [16, 128])
def test_ring_attention_kernel_int4_rings_on_card(cuda_device, Dh, Q, KV,
                                                  dtype):
    """Packed int4 rings (Dh/2 bytes a row: 8-byte copies at Dh = 16) at
    the same tolerances as the other ring types; repeated calls
    bit-equal; the kernel's output misses the plain version over
    nibble-swapped rings."""
    dt = getattr(torch, dtype)
    x = int4_ring_inputs(np.random.default_rng(Dh + Q + 1), cuda_device, dt,
                         L=3, B=2, H=8, Q=Q, KV=KV, Dh=Dh)
    before = fused_ring_attention.launches
    got = call(fused_ring_attention, 2, x, ident, packed_int4=True)
    again = call(fused_ring_attention, 2, x, ident, packed_int4=True)
    want = call(ring_attention_ref, 2, x, ident, packed_int4=True)
    wrong = call(ring_attention_ref, 2, dict(
        x, k_ring=swap_nibbles(x["k_ring"]),
        v_ring=swap_nibbles(x["v_ring"])), ident, packed_int4=True)
    torch.cuda.synchronize()
    assert fused_ring_attention.launches == before + 2
    assert torch.equal(got, again)
    atol = attn_atol(dt, want)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got.float() - wrong.float()).abs().max().item() > atol


@pytest.mark.cuda
def test_ring_attention_kernel_refuses_misshaped_int4_ring(cuda_device):
    """The ring type is the caller's: an int8 ring of Dh bytes a row
    handed over as packed int4 is refused, not read as nibbles."""
    Q, KV = MODE_SHAPES[0]
    x = ring_inputs(np.random.default_rng(2), L=2, B=1, H=8, Q=Q, KV=KV,
                    Dh=16, int8=True)
    x = {k: torch.tensor(v, device=cuda_device) for k, v in x.items()}
    with pytest.raises(ValueError, match="k_ring_all"):
        call(fused_ring_attention, 1, x, ident, packed_int4=True)


def tone_pcm(seconds=5.0, n_tones=16, seed=7):
    """A seeded run of 200 ms tones with 50 ms gaps from the trained
    fixtures' inventory (16 log-spaced pitches, 180-3600 Hz) over noise."""
    rng = np.random.default_rng(seed)
    sr = 16000
    freqs = np.geomspace(180.0, 3600.0, n_tones)
    sig = 0.02 * rng.standard_normal(int(seconds * sr))
    t = np.arange(int(0.2 * sr)) / sr
    for pos in range(0, sig.size - t.size, int(0.25 * sr)):
        f = freqs[rng.integers(n_tones)]
        sig[pos:pos + t.size] += rng.uniform(0.5, 0.9) * np.sin(
            2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    return np.clip(sig * 16000, -32767, 32767).astype("<i2")


@pytest.mark.cuda
def test_stream_session_on_trained_fixture_card_equals_cpu(cuda_device):
    """The trained tones fixture (d_model 128, 8 heads: Dh = 16) streamed
    in f32, one stream, R = 13, on the card and on the CPU: the same
    tokens, and every chunk's attention through the kernel."""
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.session import StreamSession

    path = os.path.join(REPO, "weights", "tones_tiny.gguf")
    pcm = tone_pcm()
    tokens = {}
    for dev in ("cpu", "cuda"):
        params, cfg, vocab = load_model(path, device=dev)
        assert cfg.d_head == 16
        sess = StreamSession(params, cfg, vocab, CacheConfig(
            att_right_context=13, n_mels=cfg.n_mels))
        before = fused_ring_attention.launches
        sess.process(pcm)
        sess.finalize()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fused_ring_attention.launches - before == \
                cfg.n_layers * sess.total_chunks > 0
        tokens[dev] = sess.get_tokens(0)
    assert tokens["cuda"] == tokens["cpu"]
    assert len(tokens["cpu"]) > 5


def small_random_model(device, d_model=256, n_heads=4, n_layers=2):
    """A seeded random-weight model with Dh = d_model / n_heads and Q8_0
    encoder matmuls, on `device`. It emits at the 10-symbol cap on every
    frame, switching between tokens; its top two logits are at least 6e-4
    apart at the first step (of max|logit| ~1.1, CPU)."""
    from nemotron_tpu_torch.config import ModelConfig
    from nemotron_tpu_torch.params import (params_from_arrays,
                                           quantize_model_params,
                                           random_weight_arrays)

    cfg = ModelConfig(n_mels=80, d_model=d_model, n_heads=n_heads,
                      d_head=d_model // n_heads, d_ff=4 * d_model,
                      n_layers=n_layers, vocab_size=129, decoder_dim=160,
                      joint_dim=160, subsampling_channels=64)
    arrays = random_weight_arrays(cfg, seed=1)
    params = quantize_model_params(params_from_arrays(arrays, cfg, device),
                                   "q8_0")
    return params, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tones_tiny", "random_dh64_q8"])
def test_transcribe_batch_card_equals_cpu(cuda_device, model):
    """Three ragged utterances through transcribe_batch on the card and on
    the CPU: the same texts, and on Q8_0 weights each encoder matmul one
    Q8 kernel launch (10 a layer) at M = B * T'."""
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.session import transcribe_batch

    utts = [tone_pcm(seconds=s, seed=int(10 * s)) for s in (3.0, 5.0, 4.2)]
    texts, launches = {}, {}
    for dev in ("cpu", "cuda"):
        if model == "tones_tiny":
            params, cfg, vocab = load_model(
                os.path.join(REPO, "weights", "tones_tiny.gguf"), device=dev)
        else:
            params, cfg = small_random_model(dev)
            vocab = [f"t{i} " for i in range(cfg.vocab_size)]
        before = q8_matmul.launches
        texts[dev] = transcribe_batch(params, cfg, vocab, utts)
        launches[dev] = q8_matmul.launches - before
    assert texts["cuda"] == texts["cpu"]
    assert all(len(t) > 5 for t in texts["cpu"])
    assert launches["cpu"] == 0
    assert launches["cuda"] == (10 * cfg.n_layers if model != "tones_tiny"
                                else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", Q8_SHAPES)
@pytest.mark.parametrize("M", [1, 14, 17, 112, 257, 804])
def test_q8_matmul_kernel_matches_plain_on_card(cuda_device, M, K, N, dtype):
    """M of the streaming step (1, 14, 112) and of the full-utterance
    encoder (M = B * T': 804 is 4 utterances of 16 s; 17 and 257 end in a
    one-row tile)."""
    rng = np.random.default_rng(M + K + N)
    dt = getattr(torch, dtype)
    qt = quantize_tensor(rng.standard_normal((K, N)).astype(np.float32))
    x = torch.tensor(rng.standard_normal((M, K)).astype(np.float32),
                     device=cuda_device).to(dt)
    q = torch.tensor(qt.q, device=cuda_device)
    s = torch.tensor(qt.scale, device=cuda_device)
    before = q8_matmul.launches
    got = q8_matmul(x, q, s)
    want = q8_matmul_ref(x, q, s)
    torch.cuda.synchronize()
    assert q8_matmul.launches == before + 1
    assert got.dtype == dt and got.shape == (M, N)
    scale = want.float().abs().max().item()
    tol = 4e-6 if dt == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,offset", [(3, 96, 56, 0), (20, 64, 40, 0),
                                          (14, 1024, 1024, 1)])
def test_q8_matmul_kernel_odd_shapes_on_card(cuda_device, M, K, N, offset,
                                             dtype):
    """N not a multiple of 16 or an x that is not 16-byte aligned (plain
    loads), clusters of 2 and 3 blocks, and M above 16 (two row tiles)."""
    rng = np.random.default_rng(M * K + N)
    dt = getattr(torch, dtype)
    qt = quantize_tensor(rng.standard_normal((K, N)).astype(np.float32))
    xs = torch.tensor(rng.standard_normal(M * K + offset).astype(np.float32),
                      device=cuda_device).to(dt)
    x = xs[offset:].view(M, K)
    q = torch.tensor(qt.q, device=cuda_device)
    s = torch.tensor(qt.scale, device=cuda_device)
    got = q8_matmul(x, q, s)
    want = q8_matmul_ref(x, q, s)
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    tol = 4e-6 if dt == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale,
                               rtol=0)


def card_q8_inputs(device, M, K, N, dtype, seed, offset=0):
    """Seeded Q8_0 weights and activations on the card; x starts `offset`
    elements into its buffer (offset 1: not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    qt = quantize_tensor(rng.standard_normal((K, N)).astype(np.float32))
    xs = torch.tensor(rng.standard_normal(M * K + offset).astype(np.float32),
                      device=device).to(getattr(torch, dtype))
    return (xs[offset:].view(M, K), torch.tensor(qt.q, device=device),
            torch.tensor(qt.scale, device=device))


def assert_q8_close(got, want):
    """f32: 4e-6 of max|out| (another summation order, K up to 4096);
    bf16: two bf16 ulps of max|out|."""
    scale = want.float().abs().max().item()
    tol = 4e-6 if want.dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", Q8_SHAPES)
@pytest.mark.parametrize("M", [SPLITK_MAX_M - 1, SPLITK_MAX_M,
                               SPLITK_MAX_M + 1, 896, 1000])
def test_q8_matmul_kernel_at_the_crossover_and_large_m(cuda_device, M, K, N,
                                                       dtype):
    """Either side of M* (the last skinny and the first tiled row count),
    the engine's M = 896 and a ragged 1000: one launch, within tolerance
    of the plain version."""
    x, q, s = card_q8_inputs(cuda_device, M, K, N, dtype, M + K + N)
    before = q8_matmul.launches
    got = q8_matmul(x, q, s)
    want = q8_matmul_ref(x, q, s)
    torch.cuda.synchronize()
    assert q8_matmul.launches == before + 1
    assert got.dtype == want.dtype and got.shape == (M, N)
    assert_q8_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,offset", [
    (300, 96, 56, 0), (70, 64, 40, 0), (65, 32, 136, 0),
    (804, 1024, 1024, 1), (129, 1024, 4096, 1), (804, 4096, 1000, 0)])
def test_q8_matmul_tiled_edges_on_card(cuda_device, M, K, N, offset, dtype):
    """The tiled design at its edges, at every split K allows: ragged M
    (804 = 12 x 64 + 36) and N (not a multiple of 16 or of the 128-column
    tile: plain loads), K of 1-3 scale blocks, and an x that is not
    16-byte aligned (plain loads)."""
    x, q, s = card_q8_inputs(cuda_device, M, K, N, dtype, M * K + N, offset)
    want = q8_matmul_ref(x, q, s)
    for split in (1, 2, 4, 8):
        if split <= K // 32:
            geo = tiled_geometry(M, K, N, H100_SMS, split)
            assert_q8_close(q8_matmul_as(x, q, s, geo), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", Q8_SHAPES)
def test_q8_matmul_tiled_kernel_is_deterministic_at_896(cuda_device, K, N,
                                                        dtype):
    """No atomics: split-K partials are added in rank order, so repeated
    calls give the same bits."""
    x, q, s = card_q8_inputs(cuda_device, 896, K, N, dtype, 4)
    assert q8_launch_geometry(896, K, N, H100_SMS).design == "tiled"
    first = q8_matmul(x, q, s)
    for _ in range(3):
        assert torch.equal(q8_matmul(x, q, s), first)


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype,int8", [(1, "float32", False),
                                          (8, "bfloat16", True)])
def test_ring_attention_kernel_is_deterministic(cuda_device, B, dtype, int8):
    x = card_ring_inputs(cuda_device, B, 14, 84, getattr(torch, dtype), int8)
    first = call(fused_ring_attention, 23, x, ident)
    for _ in range(3):
        assert torch.equal(call(fused_ring_attention, 23, x, ident), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(14, 4096, 1024), (1, 1024, 4096),
                                   (112, 1024, 1024)])
def test_q8_matmul_kernel_is_deterministic(cuda_device, M, K, N, dtype):
    rng = np.random.default_rng(3)
    qt = quantize_tensor(rng.standard_normal((K, N)).astype(np.float32))
    x = torch.tensor(rng.standard_normal((M, K)).astype(np.float32),
                     device=cuda_device).to(getattr(torch, dtype))
    q = torch.tensor(qt.q, device=cuda_device)
    s = torch.tensor(qt.scale, device=cuda_device)
    first = q8_matmul(x, q, s)
    for _ in range(3):
        assert torch.equal(q8_matmul(x, q, s), first)
