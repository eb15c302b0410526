"""The W8A8 tier of the port against the JAX package on the CPU: the W8A8
kernel's plain version against the Pallas kernel (interpret mode) and
against the per-row XLA path, the quantizers and the params conversions
bit for bit, W8A8 params carried across, `qmm`/`qmm_shared`/`project_pos`
on W8A8 weights, the bf16 Q8_0 matmul, and -- on a machine with a card --
the CUDA kernel against its plain version (marked `cuda`).

The JAX imports sit inside the tests that compare with JAX, so the `cuda`
test also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_w8a8.py
"""

import time

import numpy as np
import pytest
import torch

from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch.ops import quant as tquant
from nemotron_tpu_torch.ops.w8a8_kernel import (SPLITK_MAX_M, TILED_BM,
                                                TILED_BN, W8A8Geometry,
                                                splitk_geometry,
                                                tiled_geometry, tiled_splits,
                                                tiled_takes, w8a8_k_tile,
                                                w8a8_launch_geometry,
                                                w8a8_matmul, w8a8_matmul_as,
                                                w8a8_matmul_ref)

torch.set_num_threads(1)

# the encoder's (K, N): q/k/v/out/pw2, ffn w1, ffn w2, pw1
ENCODER_SHAPES = [(1024, 1024), (1024, 4096), (4096, 1024), (1024, 2048)]


def jax_flat(params) -> dict:
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


def w8a8_inputs(rng, M, K, N):
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    x = rng.standard_normal((M, K), dtype=np.float32)
    x *= rng.random((M, 1), dtype=np.float32) * 3     # rows of unequal scale
    return x, tquant.quantize_tensor_w8a8(w)


def test_w8a8_k_tile_is_the_tpu_kernels_group():
    assert [w8a8_k_tile(k) for k in (4096, 3072, 1024, 2560, 768, 256)] == \
        [1024, 1024, 1024, 512, 256, 256]
    assert [w8a8_k_tile(k) for k in (64, 96, 640, 1000)] == [64, 96, 640, 1000]
    with pytest.raises(ValueError, match="K=1100"):
        w8a8_k_tile(1100)


@pytest.mark.parametrize("M,K,N", [(37, 512, 256), (300, 1024, 512),
                                   (5, 4096, 256)])
def test_w8a8_matmul_ref_matches_pallas_interpret(M, K, N):
    import jax.numpy as jnp

    from nemotron_tpu.ops.w8a8_kernel import w8a8_matmul as pallas_w8a8

    x, qt = w8a8_inputs(np.random.default_rng(M + K), M, K, N)
    want = np.asarray(pallas_w8a8(jnp.asarray(x), jnp.asarray(qt.q),
                                  jnp.asarray(qt.col_scale), interpret=True))
    got = w8a8_matmul_ref(torch.tensor(x), torch.tensor(qt.q),
                          torch.tensor(qt.col_scale))
    assert tuple(got.shape) == (M, N) and got.dtype == torch.float32
    if K <= 1024:       # one group: acc = 0 + p * s, the same float steps
        np.testing.assert_array_equal(got.numpy(), want)
    # several groups: XLA on the CPU contracts acc + p * s into an FMA (one
    # rounding fewer per group), so an output that cancels to near zero
    # differs by one rounding of the accumulator, ~1e-7 of max|out|
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    cpu = w8a8_matmul(torch.tensor(x), torch.tensor(qt.q),
                      torch.tensor(qt.col_scale))     # CPU -> plain version
    torch.testing.assert_close(cpu, got, atol=0, rtol=0)


@pytest.mark.parametrize("M,K,N", [(7, 64, 96), (9, 96, 40), (37, 512, 256),
                                   (300, 1024, 512)])
def test_w8a8_matmul_ref_matches_jax_per_row_path(M, K, N):
    """K <= 1024: one group, the whole row, as JAX's qmm_w8a8. The scale is
    amax * f32(1/127) here and amax / 127 there: at most one ulp apart, so
    an activation on a rounding boundary may round the other way, moving
    the output by at most s * 127 * col_scale."""
    import jax.numpy as jnp

    from nemotron_tpu.ops import quant as jquant

    x, qt = w8a8_inputs(np.random.default_rng(K), M, K, N)
    want = np.asarray(jquant.qmm_w8a8(jnp.asarray(x), jquant.QTensorW8A8(
        q=jnp.asarray(qt.q), col_scale=jnp.asarray(qt.col_scale))))
    got = w8a8_matmul_ref(torch.tensor(x), torch.tensor(qt.q),
                          torch.tensor(qt.col_scale)).numpy()
    amax = np.abs(x).max(axis=1)
    s_port = np.maximum(amax, np.float32(1e-12)) * np.float32(1 / 127)
    s_jax = np.maximum(amax, np.float32(1e-12)) / np.float32(127)
    np.testing.assert_array_max_ulp(s_port, s_jax, maxulp=1)
    flip = s_port.max() * 127 * qt.col_scale.max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=flip + 1e-6 * np.abs(want).max())


def test_w8a8_matmul_ref_within_jax_gate_at_k4096():
    """K = 4096 (the ffn w2 matmul): groups of 1024 here, the whole row in
    JAX's per-row path; both held to the exact product of the quantized
    weight by the JAX package's gate (tests/test_quant.py:194-212)."""
    import jax.numpy as jnp

    from nemotron_tpu.ops import quant as jquant

    x, qt = w8a8_inputs(np.random.default_rng(3), 16, 4096, 256)
    ref = x @ (qt.q.astype(np.float32) * qt.col_scale)
    xla = np.asarray(jquant.qmm_w8a8(jnp.asarray(x), jquant.QTensorW8A8(
        q=jnp.asarray(qt.q), col_scale=jnp.asarray(qt.col_scale))))
    got = w8a8_matmul_ref(torch.tensor(x), torch.tensor(qt.q),
                          torch.tensor(qt.col_scale)).numpy()
    denom = np.abs(ref).max()
    err, err_xla = (np.abs(a - ref).max() / denom for a in (got, xla))
    assert err < max(2 * err_xla, 0.02), (err, err_xla)


def test_w8a8_matmul_ref_nan_row_and_bf16():
    q = torch.tensor(np.random.default_rng(0).integers(
        -127, 128, (64, 8)).astype(np.int8))
    cs = torch.full((8,), 0.01)
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    x[1, 7] = float("nan")
    out = w8a8_matmul_ref(x, q, cs)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()
    xb = x[[0, 2]].bfloat16()
    got = w8a8_matmul_ref(xb, q, cs)
    assert got.dtype == torch.bfloat16
    # bf16 in, f32 arithmetic, one rounding to bf16 at the end
    torch.testing.assert_close(
        got, w8a8_matmul_ref(xb.float(), q, cs).bfloat16(), atol=0, rtol=0)


def _splitk(bm, bn, split, blocks):
    return W8A8Geometry("splitk", bm, bn, split, blocks)


@pytest.mark.parametrize("K,N,want", [
    (1024, 1024, _splitk(16, 32, 8, 256)), (1024, 4096, _splitk(16, 64, 8, 512)),
    (4096, 1024, _splitk(16, 32, 8, 256)), (1024, 2048, _splitk(16, 64, 8, 256)),
    (96, 56, _splitk(16, 32, 1, 2)), (32, 8, _splitk(16, 32, 1, 1)),
    (64, 96, _splitk(16, 32, 2, 6)), (3072, 1024, _splitk(16, 32, 6, 192)),
    (1000, 8, _splitk(16, 32, 1, 1))])
def test_w8a8_launch_geometry(K, N, want):
    """Clusters of C <= 8 blocks along K, each block's slice a multiple of
    32 inside one group (C = 8 for every encoder shape: slices of 128 at
    K = 1024, 512 at K = 4096), bn = 64 only where a wave stays full; a
    single group that holds no multiple of 32 runs with C = 1."""
    geo = w8a8_launch_geometry(1, K, N, 132)
    assert geo == want
    G = w8a8_k_tile(K)
    C = geo.split
    assert C % (K // G) == 0 and G % (C // (K // G)) == 0
    ks = K // C
    assert C == 1 or ks % 32 == 0


@pytest.mark.parametrize("M,K,N,want", [
    (16, 1024, 1024, _splitk(16, 32, 8, 256)),
    (17, 1024, 1024, _splitk(32, 64, 8, 128)),
    (112, 1024, 4096, _splitk(64, 64, 8, 1024)),
    (672, 1024, 1024, _splitk(64, 64, 8, 1408)),
    (112, 4096, 1024, _splitk(32, 64, 8, 512)),
    (112, 1024, 2048, _splitk(64, 64, 8, 512)),
    (40, 96, 56, _splitk(64, 64, 1, 1))])
def test_w8a8_launch_geometry_above_16_rows(M, K, N, want):
    """Above 16 rows a skinny cluster covers 64 columns at every shape:
    each column tile quantizes its own copy of x, and the M tiles'
    clusters fill the card; 64-row tiles, halved where two bf16 blocks
    would not share an SM (32 at K = 4096). The launch takes this design
    up to SPLITK_MAX_M rows."""
    assert splitk_geometry(M, K, N, 132) == want
    if M <= SPLITK_MAX_M or not tiled_takes(K):
        assert w8a8_launch_geometry(M, K, N, 132) == want


@pytest.mark.parametrize("K,N", ENCODER_SHAPES)
@pytest.mark.parametrize("M", [804, 896, 3584])
def test_w8a8_tiled_geometry_fills_the_card(M, K, N):
    """The full-utterance batch (804 rows), the 64-slot engine (896) and
    the 256-slot engine (3584) take the tiled design with at least one
    block an SM at 132 SMs; a split of K keeps every block inside one
    group of w8a8_k_tile(K) rows (so a row's amax over a group is shared
    only between the group's blocks) and a multiple of 64 rows."""
    geo = w8a8_launch_geometry(M, K, N, 132)
    tiles = -(-M // TILED_BM) * -(-N // TILED_BN)
    assert geo.design == "tiled" and (geo.bm, geo.bn) == (128, 128)
    assert geo.blocks == tiles * geo.split >= 132
    G = w8a8_k_tile(K)
    n_groups = K // G
    assert geo.split == 1 or (geo.split % n_groups == 0
                              and (G // (geo.split // n_groups)) % 64 == 0)
    # the least split that fills the card
    smaller = [s for s in tiled_splits(K) if s < geo.split]
    assert all(tiles * s < 132 for s in smaller)


@pytest.mark.parametrize("K,N", ENCODER_SHAPES)
def test_w8a8_crossover_sends_m_star_to_splitk(K, N):
    """M <= M* rows go to the skinny design, M* + 1 to the tiled one."""
    assert w8a8_launch_geometry(SPLITK_MAX_M, K, N, 132).design == "splitk"
    assert w8a8_launch_geometry(SPLITK_MAX_M + 1, K, N, 132).design == "tiled"
    assert w8a8_launch_geometry(1, K, N, 132).design == "splitk"


@pytest.mark.parametrize("M,K,N,design", [
    (897, 96, 56, "splitk"), (3584, 36, 40, "splitk"),
    (897, 1024, 1024, "tiled"), (804, 128, 128, "tiled"),
    (900, 512, 56, "tiled"), (900, 256, 40, "tiled")])
def test_w8a8_tiled_design_refuses_groups_off_its_k_step(M, K, N, design):
    """The tiled design walks K in steps of 64 rows, so it takes K-groups
    of a multiple of 64 (every encoder shape, the tones fixture's d_model
    128) and any N (zero-filled past it); K = 96 or 36 go to the skinny
    design at any M, and tiled_geometry refuses them."""
    assert w8a8_launch_geometry(M, K, N, 132).design == design
    if design == "splitk":
        with pytest.raises(ValueError, match="multiple of 64"):
            tiled_geometry(M, K, N, 132)


def test_w8a8_tiled_splits():
    """Split 1, or whole groups times a power of two, each block's rows a
    multiple of 64 inside one group, at most 8 blocks."""
    assert tiled_splits(1024) == [1, 2, 4, 8]
    assert tiled_splits(4096) == [1, 4, 8]
    assert tiled_splits(3072) == [1, 3, 6]
    assert tiled_splits(128) == [1, 2]
    assert tiled_splits(2560) == [1, 5]
    with pytest.raises(ValueError, match="split 2 not in"):
        tiled_geometry(896, 4096, 1024, 132, split=2)
    assert tiled_geometry(896, 4096, 1024, 132, split=8).blocks == 448


def test_w8a8_matmul_as_refuses_cpu_tensors():
    """The entry point that launches a given geometry takes CUDA tensors
    only; the CPU goes through w8a8_matmul's plain version."""
    x, qt = w8a8_inputs(np.random.default_rng(5), 4, 64, 16)
    with pytest.raises(ValueError, match="one CUDA device"):
        w8a8_matmul_as(torch.tensor(x), torch.tensor(qt.q),
                       torch.tensor(qt.col_scale), None,
                       w8a8_launch_geometry(4, 64, 16, 132))


def test_w8a8_launch_geometry_refuses_more_than_8_groups():
    """K = 4608: 9 groups of 512, more than a cluster's 8 blocks. The
    geometry (which the wrapper asks before any launch) raises; the plain
    version still computes it."""
    with pytest.raises(ValueError, match="9 groups of 512"):
        w8a8_launch_geometry(1, 4608, 64, 132)
    with pytest.raises(ValueError, match="9 groups of 512"):
        w8a8_launch_geometry(4096, 4608, 64, 132)
    x, qt = w8a8_inputs(np.random.default_rng(9), 3, 4608, 64)
    out = w8a8_matmul(torch.tensor(x), torch.tensor(qt.q),
                      torch.tensor(qt.col_scale))        # CPU -> plain
    assert tuple(out.shape) == (3, 64) and torch.isfinite(out).all()


def test_quantize_tensor_w8a8_bit_equal_to_jax():
    from nemotron_tpu.ops import quant as jquant

    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 64, 40), dtype=np.float32) * 0.05
    w[1, :, 5] = 0.0                                  # an all-zero column
    got, want = tquant.quantize_tensor_w8a8(w), jquant.quantize_tensor_w8a8(w)
    assert got.q.dtype == np.int8 and got.col_scale.dtype == np.float32
    np.testing.assert_array_equal(got.q, want.q)
    np.testing.assert_array_equal(got.col_scale, want.col_scale)


@pytest.fixture(scope="module")
def w8a8_models(model_setup):
    """The tiny model in both packages: dense, W8A8, Q8_0 -> W8A8 and
    W8A8 -> Q8_0, each quantized by its own package."""
    from nemotron_tpu.params import quantize_model_params as jquantize

    _arrays, jp, cfg = model_setup
    tp = tparams.params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    jq8 = jquantize(jp, "q8_0")
    tq8 = tparams.params_from_jax_arrays(jax_flat(jq8), cfg,
                                        device="cpu")
    jw = jquantize(jp, "w8a8")
    return dict(cfg=cfg, jp=jp, tp=tp, jw=jw,
                tw=tparams.quantize_model_params(tp, "w8a8"),
                jq8w=jquantize(jq8, "w8a8"),
                tq8w=tparams.quantize_model_params(tq8, "w8a8"),
                jwq8=jquantize(jw, "q8_0"),
                twq8=tparams.quantize_model_params(
                    tparams.quantize_model_params(tp, "w8a8"), "q8_0"))


@pytest.mark.parametrize("pair", ["w", "q8w", "wq8"])
def test_quantize_model_params_bit_equal_to_jax(w8a8_models, pair):
    want = jax_flat(w8a8_models["j" + pair])
    got = tparams.flatten(w8a8_models["t" + pair])
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        g = got[key].numpy()
        assert g.dtype == arr.dtype, key
        np.testing.assert_array_equal(g, arr, key)
    kind = tquant.QTensor if pair == "wq8" else tquant.QTensorW8A8
    assert isinstance(w8a8_models["t" + pair].layers.attn_q_w, kind)
    assert isinstance(w8a8_models["t" + pair].layers.conv_dw_w, torch.Tensor)
    with pytest.raises(KeyError):
        tparams.quantize_model_params(w8a8_models["tp"], "w4")


def test_params_from_jax_arrays_w8a8(w8a8_models):
    m = w8a8_models
    tp = tparams.params_from_jax_arrays(jax_flat(m["jw"]), m["cfg"],
                                       device="cpu")
    want = jax_flat(m["jw"])
    assert "layers.ffn1_w1.col_scale" in want
    got = tparams.flatten(tp)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, key)
    layer = tp.layers.layer(2)
    assert isinstance(layer.attn_k_w, tquant.QTensorW8A8)
    np.testing.assert_array_equal(layer.attn_k_w.q.numpy(),
                                  np.asarray(m["jw"].layers.attn_k_w.q[2]))


def test_cast_params_keeps_quantized_leaves(w8a8_models):
    tw = w8a8_models["tw"]
    cast = tparams.cast_params(tw, torch.bfloat16)
    flat = tparams.flatten(cast)
    for key, arr in flat.items():
        if key.endswith(".q"):
            assert arr.dtype == torch.int8, key
        elif key.endswith((".col_scale", ".scale")):
            assert arr.dtype == torch.float32, key
        else:
            assert arr.dtype == torch.bfloat16, key
    torch.testing.assert_close(cast.layers.ffn1_w1.col_scale,
                               tw.layers.ffn1_w1.col_scale, atol=0, rtol=0)


def test_qmm_and_qmm_shared_w8a8_match_jax(w8a8_models):
    """Per-row activation scales, one group of K = d_model: within the
    scale's one-ulp effect of JAX's qmm and its one shared quantization."""
    import jax.numpy as jnp

    from nemotron_tpu.ops import quant as jquant

    m = w8a8_models
    jl = m["jw"].layers
    tl = m["tw"].layers.layer(1)
    x = np.random.default_rng(2).standard_normal((2, 5, m["cfg"].d_model),
                                                 dtype=np.float32)
    names = ("attn_q_w", "attn_k_w", "attn_v_w")
    jws = [jquant.QTensorW8A8(q=getattr(jl, n).q[1],
                              col_scale=getattr(jl, n).col_scale[1])
           for n in names]
    want = jquant.qmm_shared(jnp.asarray(x), jws)
    got = tquant.qmm_shared(torch.tensor(x), [getattr(tl, n) for n in names])
    for g, w, jw in zip(got, want, jws):
        flip = np.abs(x).max() * float(np.max(jw.col_scale))  # s*127*cs
        assert tuple(g.shape) == (2, 5, m["cfg"].d_model)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=flip + 1e-6)
        np.testing.assert_allclose(
            tquant.qmm(torch.tensor(x), tl.attn_k_w).numpy(),
            np.asarray(jquant.qmm(jnp.asarray(x), jws[1])), rtol=0,
            atol=flip + 1e-6)
    # a static activation scale (SmoothQuant) takes the static product,
    # bit-equal to the JAX package's (tests/test_torch_smoothquant.py)
    got = tquant.qmm(torch.tensor(x), tquant.QTensorW8A8(
        q=tl.attn_q_w.q, col_scale=tl.attn_q_w.col_scale,
        act_scale=torch.tensor(0.1)))
    want = jquant.qmm(jnp.asarray(x), jquant.QTensorW8A8(
        q=jws[0].q, col_scale=jws[0].col_scale, act_scale=np.float32(0.1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_pos_w8a8_matches_jax(w8a8_models, dtype):
    """The W8A8 weight is dequantized in the pos-emb dtype (q and
    col_scale each rounded to it, then multiplied)."""
    import jax.numpy as jnp

    from nemotron_tpu.ops import rel_attention as jrel
    from nemotron_tpu_torch.ops import rel_attention as trel

    m = w8a8_models
    cfg = m["cfg"]
    pos = jrel.pos_emb_descending(20, cfg.d_model)
    jw = m["jw"].layers.attn_pos_w
    want = np.asarray(jrel.project_pos(
        type(jw)(q=jw.q[0], col_scale=jw.col_scale[0]),
        jnp.asarray(pos, getattr(jnp, dtype)), cfg.n_heads, cfg.d_head),
        np.float32)
    got = trel.project_pos(m["tw"].layers.attn_pos_w[0],
                           torch.tensor(pos).to(getattr(torch, dtype)),
                           cfg.n_heads, cfg.d_head)
    assert got.dtype == getattr(torch, dtype)
    # f32: summation order only; bf16: one rounding of the output (2 ulps)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_bf16_q8_qmm_within_two_bf16_ulps_of_jax(w8a8_models):
    """Known difference: in bf16 the port dequantizes a Q8_0 weight as the
    TPU kernel does ((float)q * scale in f32, rounded once to bf16); JAX's
    qmm off the TPU multiplies q and scale each rounded to bf16. The
    outputs stay within two bf16 ulps of max|out|."""
    import jax.numpy as jnp

    from nemotron_tpu.ops import quant as jquant
    from nemotron_tpu.params import quantize_model_params as jquantize

    jq = jquantize(w8a8_models["jp"], "q8_0")
    tq = tparams.params_from_jax_arrays(jax_flat(jq), w8a8_models["cfg"],
                                       device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (6, w8a8_models["cfg"].d_model), dtype=np.float32)
    for name in ("ffn1_w1", "attn_out_w"):
        jw = getattr(jq.layers, name)
        want = np.asarray(jquant.qmm(
            jnp.asarray(x, jnp.bfloat16),
            jquant.QTensor(q=jw.q[0], scale=jw.scale[0])), np.float32)
        got = tquant.qmm(torch.tensor(x).bfloat16(),
                         getattr(tq.layers, name)[0])
        assert got.dtype == torch.bfloat16
        tol = 2 * 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 1024, 1024), (112, 4096, 1024),
                                   (672, 1024, 1024), (3, 96, 56),
                                   (8, 1024, 1024), (16, 1024, 4096),
                                   (56, 1024, 2048), (8, 4096, 1024),
                                   (37, 1024, 1024), (37, 4096, 1024),
                                   (20, 3072, 256), (5, 64, 96),
                                   (3, 5120, 64), (7, 36, 40),
                                   (804, 4096, 1024), (804, 1024, 4096)])
def test_w8a8_matmul_kernel_equals_plain_on_card(cuda_device, M, K, N, dtype):
    x, qt = w8a8_inputs(np.random.default_rng(M), M, K, N)
    x = torch.tensor(x, device=cuda_device).to(getattr(torch, dtype))
    q = torch.tensor(qt.q, device=cuda_device)
    cs = torch.tensor(qt.col_scale, device=cuda_device)
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, q, cs)
    want = w8a8_matmul_ref(x, q, cs)
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(8, 1024, 1024), (16, 1024, 4096),
                                   (112, 4096, 1024), (896, 1024, 2048),
                                   (3, 96, 56), (5, 64, 96)])
def test_w8a8_matmul_kernel_static_mode_equals_plain_on_card(
        cuda_device, M, K, N, dtype):
    """The static mode (a calibrated activation scale on the card, read by
    the kernel) bit for bit, with the scale at half the amax so that half
    the range saturates; one launch a call."""
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul_static_ref

    x, qt = w8a8_inputs(np.random.default_rng(M + 7), M, K, N)
    x = torch.tensor(x, device=cuda_device).to(getattr(torch, dtype))
    q = torch.tensor(qt.q, device=cuda_device)
    cs = torch.tensor(qt.col_scale, device=cuda_device)
    s = (x.float().abs().amax() * 0.5 / 127).reshape(1)
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, q, cs, s[0])
    want = w8a8_matmul_static_ref(x, q, cs, s[0])
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(20, 1024, 1024), (3, 96, 56)])
def test_w8a8_matmul_kernel_unaligned_x_on_card(cuda_device, M, K, N, dtype):
    """An x that is not 16-byte aligned takes the kernel's plain loads."""
    x, qt = w8a8_inputs(np.random.default_rng(K + 1), M, K, N)
    flat = torch.tensor(np.concatenate([[0.0], x.ravel()]).astype(np.float32),
                        device=cuda_device).to(getattr(torch, dtype))
    x = flat[1:].view(M, K)
    assert x.data_ptr() % 16
    q = torch.tensor(qt.q, device=cuda_device)
    cs = torch.tensor(qt.col_scale, device=cuda_device)
    torch.testing.assert_close(w8a8_matmul(x, q, cs), w8a8_matmul_ref(x, q, cs),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_matmul_kernel_one_tile_fragments_on_card(cuda_device, dtype):
    """One 16x8x32 tile (C = 1, one mma k-step): integer activations whose
    rows reach 127 have s = 127 * f32(1/127) = 1 exactly and quantize to
    themselves, so the output is the int64 product of A and B (exact in
    f32, rounded once to bf16) -- a wrong fragment map moves whole
    products."""
    rng = np.random.default_rng(16)
    a = rng.integers(-127, 128, (16, 32))
    a[np.arange(16), rng.integers(0, 32, 16)] = 127
    b = rng.integers(-127, 128, (32, 8)).astype(np.int8)
    dt = getattr(torch, dtype)
    want = torch.tensor(a @ b.astype(np.int64), dtype=torch.float32).to(dt)
    x = torch.tensor(a, dtype=dt, device=cuda_device)
    q = torch.tensor(b, device=cuda_device)
    cs = torch.ones(8, device=cuda_device)
    got = w8a8_matmul(x, q, cs)
    torch.testing.assert_close(got, w8a8_matmul_ref(x, q, cs), atol=0, rtol=0)
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K", [(8, 1024), (112, 4096)])
def test_w8a8_matmul_kernel_nan_row_on_card(cuda_device, M, K, dtype):
    """A NaN in one row makes that row's outputs NaN (its scale is NaN);
    every other row equals the plain version bit for bit."""
    x, qt = w8a8_inputs(np.random.default_rng(K + M), M, K, 256)
    x[M // 2, K - 3] = np.nan
    x = torch.tensor(x, device=cuda_device).to(getattr(torch, dtype))
    q = torch.tensor(qt.q, device=cuda_device)
    cs = torch.tensor(qt.col_scale, device=cuda_device)
    got = w8a8_matmul(x, q, cs)
    want = w8a8_matmul_ref(x, q, cs)
    assert torch.isnan(got[M // 2]).all()
    keep = [m for m in range(M) if m != M // 2]
    torch.testing.assert_close(got[keep], want[keep], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(8, 4096, 1024), (672, 1024, 1024),
                                   (896, 1024, 1024), (896, 4096, 1024),
                                   (3584, 1024, 4096)])
def test_w8a8_matmul_kernel_is_deterministic_and_one_launch(cuda_device, M,
                                                            K, N):
    """Repeated calls give the same bits (no atomics), and one call is one
    kernel launch (no quantize or reduce pass) and one count, under either
    design (kernels named w8a8_matmul_cluster_kernel and
    w8a8_matmul_tiled_kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, qt = w8a8_inputs(np.random.default_rng(1), M, K, N)
    x = torch.tensor(x, device=cuda_device).bfloat16()
    q = torch.tensor(qt.q, device=cuda_device)
    cs = torch.tensor(qt.col_scale, device=cuda_device)
    first = w8a8_matmul(x, q, cs)
    for _ in range(3):
        assert torch.equal(w8a8_matmul(x, q, cs), first)
    torch.cuda.synchronize()
    before = w8a8_matmul.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # CUPTI lost, in bursts of consecutive windows, the records of
        # kernels that ran in a window's first milliseconds, and none of
        # a kernel started 20 ms in (chip_profile_probe.py)
        time.sleep(0.02)
        w8a8_matmul(x, q, cs)
        torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [n for n in names if "w8a8_matmul" in n]
    assert len(mine) == 1, names
    design = w8a8_launch_geometry(M, K, N, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count).design
    assert ("tiled" if design == "tiled" else "cluster") in mine[0]
    assert not [n for n in names if "quantize" in n or "reduce" in n]


def _card_inputs(device, M, K, N, dtype, seed):
    x, qt = w8a8_inputs(np.random.default_rng(seed), M, K, N)
    return (torch.tensor(x, device=device).to(getattr(torch, dtype)),
            torch.tensor(qt.q, device=device),
            torch.tensor(qt.col_scale, device=device))


def _static_scale(x):
    """Half the amax / 127: half the range saturates."""
    return (x.float().abs().amax() * 0.5 / 127).reshape(1)[0].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(1024, 1024), (4096, 1024)])
@pytest.mark.parametrize("M", [SPLITK_MAX_M, SPLITK_MAX_M + 1, 804, 896, 897,
                               3584])
def test_w8a8_matmul_kernel_around_m_star_equals_plain_on_card(
        cuda_device, M, K, N, dtype, mode):
    """Both sides of the crossover, the full-utterance batch, the 64-slot
    engine (and one ragged row more) and the 256-slot engine, bit for bit,
    one launch a call."""
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul_static_ref

    x, q, cs = _card_inputs(cuda_device, M, K, N, dtype, M + K)
    s = _static_scale(x) if mode == "static" else None
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, q, cs, s)
    want = (w8a8_matmul_ref(x, q, cs) if s is None
            else w8a8_matmul_static_ref(x, q, cs, s))
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("K,N", ENCODER_SHAPES)
def test_w8a8_matmul_tiled_every_split_equals_plain_on_card(cuda_device, K,
                                                            N, mode):
    """The tiled design at M = 896 in bf16 with each split of K it takes
    (inside one group, or the whole of K in one block), bit for bit."""
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul_static_ref

    x, q, cs = _card_inputs(cuda_device, 896, K, N, "bfloat16", K + N)
    s = _static_scale(x) if mode == "static" else None
    want = (w8a8_matmul_ref(x, q, cs) if s is None
            else w8a8_matmul_static_ref(x, q, cs, s))
    for split in tiled_splits(K):
        got = w8a8_matmul_as(x, q, cs, s,
                             tiled_geometry(896, K, N, 132, split))
        torch.testing.assert_close(got, want, atol=0, rtol=0,
                                   msg=f"split {split}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(897, 1024, 1024), (896, 4096, 1024),
                                   (900, 96, 56), (900, 512, 56),
                                   (804, 256, 40)])
def test_w8a8_matmul_large_m_edges_on_card(cuda_device, M, K, N, dtype):
    """Above M*: an x that is not 16-byte aligned (plain loads), N off the
    16-byte copies (56, 40), K-groups off the tiled design's step (K = 96,
    which the skinny design takes), and a NaN row (its outputs NaN, every
    other row bit for bit), in both modes where the design takes them."""
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul_static_ref

    x, q, cs = _card_inputs(cuda_device, M, K, N, dtype, M + N)
    flat = torch.cat([x.new_zeros(1), x.ravel()])
    xm = flat[1:].view(M, K)
    assert xm.data_ptr() % 16
    torch.testing.assert_close(w8a8_matmul(xm, q, cs),
                               w8a8_matmul_ref(xm, q, cs), atol=0, rtol=0)
    s = _static_scale(x)
    torch.testing.assert_close(w8a8_matmul(xm, q, cs, s),
                               w8a8_matmul_static_ref(xm, q, cs, s),
                               atol=0, rtol=0)
    x[M // 2, K - 3] = float("nan")
    got = w8a8_matmul(x, q, cs)
    want = w8a8_matmul_ref(x, q, cs)
    assert torch.isnan(got[M // 2]).all()
    keep = [m for m in range(M) if m != M // 2]
    torch.testing.assert_close(got[keep], want[keep], atol=0, rtol=0)


@pytest.mark.cuda
def test_w8a8_matmul_wrapper_refuses_more_than_8_groups_on_card(cuda_device):
    for M in (2, 2048):
        x = torch.zeros((M, 4608), device=cuda_device)
        q = torch.zeros((4608, 64), dtype=torch.int8, device=cuda_device)
        before = w8a8_matmul.launches
        with pytest.raises(ValueError, match="9 groups"):
            w8a8_matmul(x, q, torch.ones(64, device=cuda_device))
        assert w8a8_matmul.launches == before
