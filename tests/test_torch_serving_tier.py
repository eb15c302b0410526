"""The W8A8 + int8 K/V serving tier end to end, PyTorch port against the
JAX package on the CPU: encoder chunks, rings and scales over enough
chunks to wrap the ring in all four latency modes (split int8 rings
against both JAX attention paths, and the int8 shared x-ring), the
state constructors, StreamSession transcripts on the trained fixture in
f32 and bf16, and the CLI's stdout with --quantize=w8a8 --kv-int8."""

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
from nemotron_tpu.models import decoder as jdec
from nemotron_tpu.models import encoder as jenc
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.params import quantize_model_params as jquantize
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.utils import tones as tones_mod
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.models import encoder as tenc
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.params import quantize_model_params as tquantize
from nemotron_tpu_torch.streaming.session import StreamSession as TSession

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
# Int8 rounding turns last-bit differences into whole steps. The two
# packages sum matmuls and attention in other orders (~1e-7 relative), and
# the port's W8A8 scale is amax * f32(1/127) where JAX's per-row path
# divides (one ulp apart); an activation or a ring value that lies on a
# rounding boundary then rounds to the neighbouring int8 step: 1/127 of its
# group's amax. JAX's own two attention paths differ in the same way. At
# d_model 64 one such flip moves the chunk's encoder output by up to about
# 5e-3 of max|out| (measured), so the encoder test takes each chunk's state
# from JAX (errors do not compound over chunks) and holds:
#   - outputs and float caches within 1e-2 of max|out| (about one int8 step),
#     and at most half of the chunks off by more than 1e-5 of max|out|
#     (chunks without a flip agree to summation order);
#   - int8 ring entries within one step, per-segment scales within 1e-2;
#   - valid_len and phase exact.
# The sessions below run free and must give the same transcripts.
FLIP_TOL = 1e-2
CLEAN_TOL = 1e-5
SCALE_RTOL = 1e-2
RING_MAX_STEP = 1


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def w8a8_model(model_setup):
    """The tiny model's W8A8 params in both packages (bit-equal int8
    weights: tests/test_torch_w8a8.py) and the config."""
    _arrays, jp, cfg = model_setup
    jw = jquantize(jp, "w8a8")
    return jw, params_from_jax_arrays(jax_flat(jw), cfg, device="cpu"), cfg


def jax_step(cfg, cc):
    """A jitted JAX chunk step traced anew: the attention path is read from
    NEMOTRON_TPU_ATTN at trace time, which a shared jit cache would skip."""
    return jax.jit(lambda p, mel, st, ph: jenc.encode_chunk(p, cfg, cc, mel,
                                                            st, ph))


def to_torch_state(jst) -> tenc.EncoderState:
    return tenc.EncoderState(**{
        f.name: torch.tensor(np.asarray(getattr(jst, f.name)))
        for f in dataclasses.fields(tenc.EncoderState)})


def check_chunk(got, want, tst, jst, what: str) -> bool:
    """Asserts the bounds above for one chunk's output and state; returns
    whether the chunk is off by more than CLEAN_TOL of max|out|."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want).max()
    assert err <= FLIP_TOL * scale, (what, err / scale)
    for f in dataclasses.fields(tst):
        g, w = getattr(tst, f.name), np.asarray(getattr(jst, f.name))
        name = f"{what} {f.name}"
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype)[6:] == str(w.dtype), name
        g = g.numpy()
        if w.size == 0:
            continue
        if f.name in ("valid_len", "phase"):
            np.testing.assert_array_equal(g, w, name)
        elif f.name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, err_msg=name)
        elif w.dtype == np.int8:
            step = np.abs(g.astype(np.int32) - w.astype(np.int32)).max()
            assert step <= RING_MAX_STEP, (name, step)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=FLIP_TOL * scale,
                                       err_msg=name)
    return err > CLEAN_TOL * scale


@pytest.mark.parametrize("layout,impl", [("split", "xla"),
                                         ("split", "pallas-interpret"),
                                         ("shared", "xla")])
@pytest.mark.parametrize("R", [0, 1, 6, 13])
def test_encode_chunk_w8a8_int8_matches_jax(w8a8_model, monkeypatch, R,
                                            layout, impl):
    """W8A8 weights with int8 rings (split K/V, or the shared x-ring: JAX
    runs that layout on its XLA attention path only), B = 2, a 14-frame
    left context so the ring wraps within n_seg + 2 chunks; each chunk
    starts from JAX's state (see the bounds above)."""
    jw, tw, cfg = w8a8_model
    B = 2
    monkeypatch.setenv("NEMOTRON_TPU_ATTN", impl)
    monkeypatch.setenv("NEMOTRON_TPU_ATTN_BLOCK", str(B))
    kw = dict(att_right_context=R, att_left_context=14, n_mels=cfg.n_mels,
              kv_cache_int8=True, shared_cache=layout == "shared")
    jcc, tcc = JCC(**kw), TCC(**kw)
    n_seg = jcc.kv_len // jcc.chunk_enc_len
    jst = jenc.init_encoder_state(cfg, jcc, B)
    jph = jenc.precompute_pos_heads(jw, cfg, jcc)
    tph = tenc.precompute_pos_heads(tw, cfg, tcc)
    step = jax_step(cfg, jcc)
    np.testing.assert_allclose(tph.numpy(), np.asarray(jph), atol=1e-6)
    rng = np.random.default_rng(200 + R)
    n_chunks = max(4, n_seg + 2)
    flipped = 0
    for ci in range(n_chunks):
        mel = rng.standard_normal((B, jcc.chunk_mel_frames,
                                   cfg.n_mels)).astype(np.float32)
        tst = to_torch_state(jst)
        want, jst = step(jw, jnp.asarray(mel), jst, jph)
        got, tst = tenc.encode_chunk(tw, cfg, tcc, torch.tensor(mel), tst,
                                     tph)
        flipped += check_chunk(got, want, tst, jst, f"chunk {ci}")
    assert flipped <= n_chunks // 2, flipped
    assert tst.k_cache.dtype == torch.int8


def test_encode_chunk_dense_shared_ring_matches_jax(w8a8_model, monkeypatch):
    """The shared x-ring kept dense (no --kv-int8), W8A8 weights."""
    jw, tw, cfg = w8a8_model
    monkeypatch.setenv("NEMOTRON_TPU_ATTN", "xla")
    kw = dict(att_right_context=1, att_left_context=14, n_mels=cfg.n_mels,
              shared_cache=True)
    jcc, tcc = JCC(**kw), TCC(**kw)
    jst = jenc.init_encoder_state(cfg, jcc, 2)
    jph = jenc.precompute_pos_heads(jw, cfg, jcc)
    tph = tenc.precompute_pos_heads(tw, cfg, tcc)
    step = jax_step(cfg, jcc)
    rng = np.random.default_rng(9)
    flipped = 0
    for ci in range(10):
        mel = rng.standard_normal((2, jcc.chunk_mel_frames,
                                   cfg.n_mels)).astype(np.float32)
        tst = to_torch_state(jst)
        want, jst = step(jw, jnp.asarray(mel), jst, jph)
        got, tst = tenc.encode_chunk(tw, cfg, tcc, torch.tensor(mel), tst,
                                     tph)
        flipped += check_chunk(got, want, tst, jst, f"chunk {ci}")
    assert flipped <= 5, flipped
    assert tuple(tst.v_cache.shape)[-1] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", [dict(kv_cache_int8=True),
                                dict(shared_cache=True),
                                dict(kv_cache_int8=True, shared_cache=True)])
def test_init_states_match_jax(w8a8_model, kv, dtype):
    cfg = w8a8_model[2]
    jst = jenc.init_encoder_state(cfg, JCC(n_mels=cfg.n_mels, **kv), 3,
                                  getattr(jnp, dtype))
    tst = tenc.init_encoder_state(cfg, TCC(n_mels=cfg.n_mels, **kv), 3,
                                  getattr(torch, dtype), "cpu")
    for f in dataclasses.fields(tst):
        want, got = np.asarray(getattr(jst, f.name)), getattr(tst, f.name)
        assert str(got.dtype)[6:] == str(want.dtype), f.name
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32), f.name)
    jd = jdec.init_decoder_state(cfg, 3, getattr(jnp, dtype))
    td = tdec.init_decoder_state(cfg, 3, getattr(torch, dtype), "cpu")
    for f in ("h", "c", "prev_token"):
        want, got = np.asarray(getattr(jd, f)), getattr(td, f)
        assert str(got.dtype)[6:] == str(want.dtype), f
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32), f)
    # int4 rings are ported (tests/test_torch_quant_tiers.py): packed
    st4 = tenc.init_encoder_state(cfg, TCC(kv_cache_int4=True), 1,
                                  torch.float32, "cpu")
    assert st4.k_cache.dtype == torch.int8
    assert st4.k_cache.shape[-1] == cfg.d_head // 2


def test_bf16_decode_keeps_its_state_in_bf16(w8a8_model):
    _jw, tw, cfg = w8a8_model
    bf = torch.bfloat16
    from nemotron_tpu_torch.params import cast_params

    tb = cast_params(tw, bf)
    enc = torch.randn(2, 4, cfg.d_model, generator=torch.Generator()
                      .manual_seed(0)).to(bf)
    st = tdec.init_decoder_state(cfg, 2, bf, "cpu")
    tokens, st = tdec.greedy_decode(tb, cfg, enc, st)
    assert st.h.dtype == st.c.dtype == bf and st.prev_token.dtype == torch.int32
    with pytest.raises(TypeError, match="compute dtype"):
        tdec.greedy_decode(tb, cfg, enc, tdec.init_decoder_state(
            cfg, 2, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def fixture_w8a8():
    jp, jc, jv = jload_model(FIXTURE)
    tp, tc, tv = tload_model(FIXTURE, device="cpu")
    return ((jquantize(jp, "w8a8"), jc, jv),
            (tquantize(tp, "w8a8"), tc, tv))


def run_sessions(fixture_w8a8, R, S, dtype="float32", seed=0, **kv):
    """The same ragged PCM feeds through both packages' sessions; returns
    (JAX session, port session, [(port text, JAX text) per feed])."""
    (jp, jc, jv), (tp, tc, tv) = fixture_w8a8
    audio, _ = tones_mod.make_eval_streams(S, 5.0, 16, seed=seed + R)
    jsess = JSession(jp, jc, jv, JCC(att_right_context=R, n_mels=jc.n_mels,
                                     **kv),
                     n_streams=S, compute_dtype=getattr(jnp, dtype))
    tsess = TSession(tp, tc, tv, TCC(att_right_context=R, n_mels=tc.n_mels,
                                     **kv),
                     n_streams=S, compute_dtype=getattr(torch, dtype))
    cuts = np.sort(np.random.default_rng(R).integers(0, audio.shape[1], 5))
    feeds = []
    for piece in np.split(audio, cuts, axis=1):
        if piece.shape[1]:
            feeds.append((tsess.process(piece), jsess.process(piece)))
    feeds.append((tsess.finalize(), jsess.finalize()))
    return jsess, tsess, feeds


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("R", [0, 1, 6, 13])
def test_session_w8a8_int8_kv_transcripts_match_jax(fixture_w8a8, R, S):
    jsess, tsess, feeds = run_sessions(fixture_w8a8, R, S, seed=11,
                                       kv_cache_int8=True)
    for got, want in feeds:
        assert got == want
    for s in range(S):
        assert tsess.get_tokens(s) == jsess.get_tokens(s)
        assert len(tsess.get_tokens(s)) > 10
    assert tsess.total_chunks == jsess.total_chunks
    assert tsess.enc_state.k_cache.dtype == torch.int8


def test_session_w8a8_shared_int8_ring_transcripts_match_jax(fixture_w8a8):
    jsess, tsess, feeds = run_sessions(fixture_w8a8, 13, 2, seed=21,
                                       kv_cache_int8=True, shared_cache=True)
    for got, want in feeds:
        assert got == want
    assert tsess.get_tokens(1) == jsess.get_tokens(1)
    assert tsess.enc_state.k_cache.shape[2] == 1


def edit_distance(a: list, b: list) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("R", [1, 13])
def test_bf16_session_w8a8_int8_kv_within_jax_bound(fixture_w8a8, R):
    """bf16 rounds at other places in the two frameworks (the matmuls' and
    the LSTM's summation orders, the Q8/W8A8 dequant points), so tokens
    are held to the JAX package's own bf16 bound: an edit distance under
    5% of the tokens (tests/test_trained_fixture.py:80-95)."""
    jsess, tsess, _ = run_sessions(fixture_w8a8, R, 2, "bfloat16", seed=31,
                                   kv_cache_int8=True)
    assert tsess.params.layers.norm_ff1_w.dtype == torch.bfloat16
    assert tsess.pos_heads.dtype == tsess.enc_state.conv_cache.dtype == \
        tsess.dec_state.h.dtype == torch.bfloat16
    for s in range(2):
        got = [t for t, _ in tsess.get_tokens(s)]
        want = [t for t, _ in jsess.get_tokens(s)]
        assert len(want) > 10
        assert edit_distance(got, want) < 0.05 * len(want), (got, want)


def test_cli_w8a8_int8_kv_stdout_matches_jax_cli(tmp_path):
    audio, _ = tones_mod.make_eval_streams(1, 4.0, 16, seed=5)
    pcm = tmp_path / "a.pcm"
    audio[0].astype("<i2").tofile(pcm)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    runs = {}
    for name, cmd in (
            ("jax", [os.path.join(REPO, "cli", "transcribe_stream.py")]),
            ("torch", ["-m", "nemotron_tpu_torch.cli"])):
        r = subprocess.run([sys.executable, *cmd, FIXTURE, str(pcm), "80",
                            "13", "--cpu", "--quantize=w8a8", "--kv-int8"],
                           capture_output=True, timeout=300, env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr.decode()
        runs[name] = (r.stdout.decode(), r.stderr.decode())
    assert runs["torch"][0] == runs["jax"][0]
    assert len(runs["torch"][0].strip()) > 10
    for line in ("runtime quantization: w8a8", "int8 K/V cache rings enabled"):
        assert line in runs["torch"][1] and line in runs["jax"][1]


@pytest.mark.parametrize("flag", ["--quantize=w8a8-sq", "--kv-int4",
                                  "--rc-by-layer=13,6,1,0", "--quantize=w4"])
def test_cli_refuses_later_slices_and_unknown_modes(flag, capsys,
                                                    monkeypatch):
    """An unknown mode exits 1. The quant-tiers flags are ported: on stdin
    input --quantize=w8a8-sq needs --calib=FILE, and --kv-int4 and
    --rc-by-layer transcribe."""
    import io

    from nemotron_tpu_torch import cli

    audio, _ = tones_mod.make_eval_streams(1, 2.0, 16, seed=2)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(
        audio[0].astype("<i2").tobytes())))
    rc = cli.main(["cli", FIXTURE, "-", "80", "13", "--cpu", flag])
    err = capsys.readouterr().err
    assert "later slice" not in err
    want = {"--quantize=w4": (1, "unknown --quantize mode 'w4'"),
            "--quantize=w8a8-sq": (1, "needs --calib=FILE"),
            "--kv-int4": (0, "int4 K/V cache rings enabled"),
            "--rc-by-layer=13,6,1,0":
                (0, "per-layer right context: (13, 6, 1, 0)")}[flag]
    assert rc == want[0] and want[1] in err
