"""The rest of the quant tiers in the PyTorch port against the JAX package
on the CPU: int4 K/V rings (packing, ring bytes and scales, encoder output,
realignment, sessions), per-layer and strict right context (encoder output
with and without a step mask, sessions), the attention kernel's plain
version over packed rings, and the streaming CLI's stdout with --kv-int4,
--rc-by-layer and --quantize=w8a8-sq-static."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models import encoder as jenc
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.utils import tones as tones_mod
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import encoder as tenc
from nemotron_tpu_torch.ops.ring_attn_kernel import (pack_int4,
                                                     ring_attention_ref,
                                                     unpack_int4)
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.streaming.session import StreamSession as TSession

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
# f32 encoder output and float caches against JAX (different summation
# orders only), as tests/test_torch_streaming.py holds them
ATOL = 5e-5
# per-segment ring scales: amax / 7 of new K/V that differ in the last bits
SCALE_RTOL = 1e-5


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def models(model_setup):
    _arrays, jp, cfg = model_setup
    return jp, params_from_jax_arrays(jax_flat(jp), cfg, device="cpu"), cfg


def test_int4_packing_is_jax_bitcast():
    """Element 2i in the low nibble, 2i+1 in the high one: the bytes of
    bitcast_convert_type(int4[..., Dh/2, 2] -> int8), and back."""
    q = np.random.default_rng(0).integers(-7, 8, (3, 5, 16)).astype(np.int8)
    want = jax.lax.bitcast_convert_type(
        jnp.asarray(q).reshape(3, 5, 8, 2).astype(jnp.int4), jnp.int8)
    got = pack_int4(torch.tensor(q))
    assert got.dtype == torch.int8 and tuple(got.shape) == (3, 5, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pack_int4(torch.tensor([1, -2], dtype=torch.int8)).view(
        torch.uint8).item() == 0xE1
    for dt in (torch.float32, torch.bfloat16):
        np.testing.assert_array_equal(unpack_int4(got, dt).float().numpy(), q)


def encoder_run(jp, tp, cfg, R, B=2, masks=None, **kv):
    """Chunks enough to wrap the ring through both packages' encode_chunk
    (optionally step-masked); asserts the bounds above chunk by chunk and
    returns the final (JAX state, port state)."""
    jcc = JCC(att_right_context=R, att_left_context=14, n_mels=cfg.n_mels,
              **kv)
    tcc = TCC(att_right_context=R, att_left_context=14, n_mels=cfg.n_mels,
              **kv)
    n_seg = jcc.kv_len // jcc.chunk_enc_len
    jst = jenc.init_encoder_state(cfg, jcc, B)
    tst = tenc.init_encoder_state(cfg, tcc, B, torch.float32, "cpu")
    jph = jenc.precompute_pos_heads(jp, cfg, jcc)
    tph = tenc.precompute_pos_heads(tp, cfg, tcc)
    step = jax.jit(lambda p, mel, st, ph, m: jenc.encode_chunk(
        p, cfg, jcc, mel, st, ph, step_mask=m))
    rng = np.random.default_rng(200 + R)
    for ci in range(n_seg + 2):
        mel = rng.standard_normal((B, jcc.chunk_mel_frames,
                                   cfg.n_mels)).astype(np.float32)
        m = None if masks is None else masks(ci)
        want, jst = step(jp, jnp.asarray(mel), jst, jph,
                         None if m is None else jnp.asarray(m))
        got, tst = tenc.encode_chunk(tp, cfg, tcc, torch.tensor(mel), tst,
                                     tph, step_mask=None if m is None
                                     else torch.tensor(m))
        rows = slice(None) if m is None else m
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                                   atol=ATOL, err_msg=f"chunk {ci}")
        for f in dataclasses.fields(tst):
            g, w = getattr(tst, f.name), np.asarray(getattr(jst, f.name))
            what = f"chunk {ci} {f.name}"
            assert tuple(g.shape) == w.shape and \
                str(g.dtype)[6:] == str(w.dtype), what
            if w.dtype == np.int8 or f.name in ("valid_len", "phase"):
                np.testing.assert_array_equal(g.numpy(), w, what)
            elif f.name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(g.numpy(), w, rtol=SCALE_RTOL,
                                           err_msg=what)
            else:
                np.testing.assert_allclose(g.numpy(), w, atol=ATOL,
                                           err_msg=what)
    return jst, tst


@pytest.mark.parametrize("R", [0, 1, 6, 13])
def test_encode_chunk_int4_matches_jax(models, R):
    """Packed int4 rings: bytes equal to JAX's after the ring wraps, scales
    within 1e-5, encoder output within 5e-5 (f32)."""
    jp, tp, cfg = models
    _jst, tst = encoder_run(jp, tp, cfg, R, kv_cache_int4=True)
    assert tuple(tst.k_cache.shape)[-1] == cfg.d_head // 2
    assert (tst.k_scale != 1).all()


def test_encode_chunk_int4_step_masked_matches_jax(models):
    """Frozen streams keep their packed segment and scale bytes."""
    jp, tp, cfg = models
    encoder_run(jp, tp, cfg, 6, B=3, kv_cache_int4=True,
                masks=lambda ci: np.array([True, ci % 3 != 1, ci % 2 == 0]))


@pytest.mark.parametrize("R,kv", [
    (13, dict(att_right_context_by_layer=(13, 6, 1))),
    (6, dict(att_right_context_by_layer=(6, 1, 0))),
    (1, dict(strict_right_context=True)),
    (13, dict(strict_right_context=True)),
    (13, dict(strict_right_context=True, att_right_context_by_layer=(6, 1, 0),
              kv_cache_int4=True))])
def test_encode_chunk_right_context_matches_jax(models, R, kv):
    """Per-layer and strict right context, with a step mask (the serving
    engine's path): output within 5e-5 of JAX's XLA path, which its
    per-layer masks force (nemotron_tpu/models/encoder.py:357-364)."""
    jp, tp, cfg = models
    encoder_run(jp, tp, cfg, R, **kv,
                masks=lambda ci: np.array([True, ci % 3 != 1]))


def test_rc_schedule_validates_like_jax(models):
    _jp, tp, cfg = models
    for pat in ((13, 6, 1, 0), (14, 6, 1)):
        cc = TCC(att_right_context=13, att_right_context_by_layer=pat)
        with pytest.raises(ValueError):
            tenc.encode_chunk(tp, cfg, cc, torch.zeros(
                (1, cc.chunk_mel_frames, cfg.n_mels)), tenc.init_encoder_state(
                cfg, cc, 1, torch.float32, "cpu"), torch.zeros(1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_int4_matches_jax(models, dtype):
    cfg = models[2]
    jst = jenc.init_encoder_state(cfg, JCC(kv_cache_int4=True), 3,
                                  getattr(jnp, dtype))
    tst = tenc.init_encoder_state(cfg, TCC(kv_cache_int4=True), 3,
                                  getattr(torch, dtype), "cpu")
    for f in dataclasses.fields(tst):
        want, got = np.asarray(getattr(jst, f.name)), getattr(tst, f.name)
        assert str(got.dtype)[6:] == str(want.dtype), f.name
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32), f.name)


def test_realign_packed_rings_matches_jax(models):
    """realign_ring and realign_rings roll packed rings by whole slots."""
    cfg = models[2]
    cc = JCC(att_right_context=6, att_left_context=14, kv_cache_int4=True)
    rng = np.random.default_rng(3)
    jst = jenc.init_encoder_state(cfg, cc, 3)
    leaves = {f.name: rng.integers(-100, 100, np.asarray(
        getattr(jst, f.name)).shape).astype(np.asarray(
            getattr(jst, f.name)).dtype)
        for f in dataclasses.fields(jst)}
    leaves["phase"] = np.array([0, 1, 2], np.int32)

    def jstate():   # realign_ring donates its input
        return jenc.EncoderState(**{k: jnp.asarray(v)
                                    for k, v in leaves.items()})

    def tstate():
        return tenc.EncoderState(**{k: torch.tensor(v)
                                    for k, v in leaves.items()})

    deltas = np.array([2, 0, 1], np.int32)
    pairs = ((jenc.realign_rings(jstate(), jnp.asarray(deltas),
                                 cc.chunk_enc_len),
              tenc.realign_rings(tstate(), torch.tensor(deltas),
                                 cc.chunk_enc_len)),
             (jenc.realign_ring(jstate(), 0, 2, cc.chunk_enc_len),
              tenc.realign_ring(tstate(), 0, 2, cc.chunk_enc_len)))
    for want, got in pairs:
        assert tuple(got.k_cache.shape)[-1] == cfg.d_head // 2
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)))


def test_ring_attention_ref_unpacks_packed_rings():
    """The kernel's plain version over packed int4 rings equals it over the
    same values held as int8 rings."""
    rng = np.random.default_rng(4)
    B, H, Q, KV, Dh, L = 2, 3, 4, 12, 16, 2
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    q, kn, vn, a = f(B, H, Q, Dh), f(B, H, Q, Dh), f(B, H, Q, Dh), \
        f(B, H, Q, KV + Q)
    kr = torch.tensor(rng.integers(-7, 8, (L, B, H, KV, Dh)), dtype=torch.int8)
    vr = torch.tensor(rng.integers(-7, 8, (L, B, H, KV, Dh)), dtype=torch.int8)
    kc, vc = f(B, H, KV).abs(), f(B, H, KV).abs()
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(dt) for t in (q, kn, vn)]
        want = ring_attention_ref(1, *args, kr, vr, a.to(dt), kc, vc)
        got = ring_attention_ref(1, *args, pack_int4(kr), pack_int4(vr),
                                 a.to(dt), kc, vc, packed_int4=True)
        assert torch.equal(got, want)


def test_rel_pos_mha_ring_packed_int4_matches_jax(models):
    """The plain ring attention over packed int4 rings (unpacked inside,
    as nemotron_tpu/ops/rel_attention.py:199-201) against JAX's, with
    dequant scale columns; the fused path's plain version agrees."""
    from nemotron_tpu.ops import rel_attention as jrel
    from nemotron_tpu_torch.ops import rel_attention as trel

    jp, tp, cfg = models
    H, Dh, D = cfg.n_heads, cfg.d_head, cfg.d_model
    B, Q, kv, n_seg = 2, 2, 8, 4
    rng = np.random.default_rng(6)
    j = np.arange(kv)
    age = np.mod(1 - 1 - j // Q, n_seg) + 1
    chron = np.concatenate([(n_seg - 1 - age) * Q + j % Q,
                            (n_seg - 1) * Q + np.arange(Q)])
    pos_perm = (np.arange(kv)[:, None] == chron[None, :]).astype(np.float32)
    mask = np.zeros((B, 1, 1, kv + Q), np.float32)
    x = rng.standard_normal((B, Q, D)).astype(np.float32)
    q4 = rng.integers(-7, 8, (2, cfg.n_layers, B, H, kv, Dh)).astype(np.int8)
    packed = [pack_int4(torch.tensor(r)) for r in q4]
    cols = (rng.random((2, B, H, kv)) * 0.1).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp.layers)
    tl = tp.layers.layer(1)
    pos = jrel.pos_emb_descending(kv, D)
    ph = jrel.project_pos(jl.attn_pos_w, jnp.asarray(pos), H, Dh)
    want, _, _ = jrel.rel_pos_mha_ring(
        jl, jnp.asarray(x), ph, H, Dh, jnp.asarray(packed[0][1].numpy()),
        jnp.asarray(packed[1][1].numpy()), jnp.asarray(pos_perm),
        jnp.asarray(mask), k_scale_cols=jnp.asarray(cols[0]),
        v_scale_cols=jnp.asarray(cols[1]), packed_int4=True)
    tph = torch.tensor(np.asarray(ph))
    got, _, _ = trel.rel_pos_mha_ring(
        tl, torch.tensor(x), tph, H, Dh, packed[0][1], packed[1][1],
        torch.tensor(chron), torch.tensor(mask), torch.tensor(cols[0]),
        torch.tensor(cols[1]), packed_int4=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    fused, _, _ = trel.rel_pos_mha_ring_fused(
        tl, torch.tensor(x), tph, H, Dh, 1, *packed, torch.tensor(chron),
        torch.tensor(mask), torch.tensor(cols[0]), torch.tensor(cols[1]),
        packed_int4=True)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def fixture_models():
    return jload_model(FIXTURE), tload_model(FIXTURE, device="cpu")


@pytest.mark.parametrize("R,kv", [
    (13, dict(kv_cache_int4=True)), (0, dict(kv_cache_int4=True)),
    (13, dict(att_right_context_by_layer=(13, 6))),
    (6, dict(strict_right_context=True, kv_cache_int4=True))])
def test_session_tokens_match_jax(fixture_models, R, kv):
    """Sessions on the trained fixture (f32, 2 streams, ragged feeds): the
    same text at every feed and the same tokens."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    audio, _ = tones_mod.make_eval_streams(2, 5.0, 16, seed=40 + R)
    jsess = JSession(jp, jc, jv, JCC(att_right_context=R, n_mels=jc.n_mels,
                                     **kv), n_streams=2)
    tsess = TSession(tp, tc, tv, TCC(att_right_context=R, n_mels=tc.n_mels,
                                     **kv), n_streams=2)
    cuts = np.sort(np.random.default_rng(R).integers(0, audio.shape[1], 4))
    for piece in np.split(audio, cuts, axis=1):
        if piece.shape[1]:
            assert tsess.process(piece) == jsess.process(piece)
    assert tsess.finalize() == jsess.finalize()
    for s in range(2):
        assert tsess.get_tokens(s) == jsess.get_tokens(s)
        assert len(tsess.get_tokens(s)) > 10


@pytest.mark.parametrize("flags", [
    ["--kv-int4"], ["--rc-by-layer=13,6"],
    ["--quantize=w8a8-sq-static", "--kv-int4"]])
def test_cli_stdout_matches_jax_cli(tmp_path, flags):
    """The streaming CLI with the quant-tier flags prints the JAX CLI's
    stdout and its configuration lines (SmoothQuant calibrates on the
    input's first 20 s in both)."""
    audio, _ = tones_mod.make_eval_streams(1, 4.0, 16, seed=9)
    pcm = tmp_path / "a.pcm"
    audio[0].astype("<i2").tofile(pcm)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    runs = {}
    for name, cmd in (
            ("jax", [os.path.join(REPO, "cli", "transcribe_stream.py")]),
            ("torch", ["-m", "nemotron_tpu_torch.cli"])):
        r = subprocess.run([sys.executable, *cmd, FIXTURE, str(pcm), "80",
                            "13", "--cpu", *flags], capture_output=True,
                           timeout=300, env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr.decode()
        runs[name] = (r.stdout.decode(), r.stderr.decode())
    assert runs["torch"][0] == runs["jax"][0]
    assert len(runs["torch"][0].strip()) > 10
    lines = {"--kv-int4": "int4 K/V cache rings enabled",
             "--rc-by-layer=13,6": "per-layer right context: (13, 6)",
             "--quantize=w8a8-sq-static":
                 "runtime quantization: w8a8-sq-static (calibrated on"}
    for f in flags:
        assert lines[f] in runs["torch"][1] and lines[f] in runs["jax"][1]


def test_cli_sq_needs_calibration_audio_on_stdin(capsys):
    from nemotron_tpu_torch import cli

    assert cli.main(["cli", FIXTURE, "-", "80", "13", "--cpu",
                     "--quantize=w8a8-sq"]) == 1
    assert "needs --calib=FILE" in capsys.readouterr().err
    assert cli.main(["cli", FIXTURE, "a.pcm", "--cpu",
                     "--rc-by-layer=13,6,1"]) == 1
    assert "equal groups" in capsys.readouterr().err
