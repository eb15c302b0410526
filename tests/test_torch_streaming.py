"""The streaming slice end to end, PyTorch port against the JAX package on
the CPU: encoder chunks and every cache leaf over several chunks in all
four latency modes (f32 and Q8_0, against both JAX attention paths),
greedy tokens and decoder state, StreamSession transcripts on the trained
fixture, and the CLI's stdout."""

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
from nemotron_tpu.params import quantize_model_params
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.utils import tones as tones_mod
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.models import encoder as tenc
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.streaming.session import StreamSession as TSession

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
ATOL = 5e-5


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def models(model_setup):
    """{'f32'|'q8': (JAX params, port params)} and the tiny config."""
    _arrays, jp, cfg = model_setup
    jq = quantize_model_params(jp, "q8_0")
    return {name: (p, params_from_jax_arrays(jax_flat(p), cfg,
                                                  device="cpu"))
            for name, p in (("f32", jp), ("q8", jq))}, cfg


@pytest.mark.parametrize("impl", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("quant", ["f32", "q8"])
@pytest.mark.parametrize("R", [0, 1, 6, 13])
def test_encode_chunk_matches_jax(models, monkeypatch, R, quant, impl):
    (jp, tp), cfg = models[0][quant], models[1]
    B = 2
    monkeypatch.setenv("NEMOTRON_TPU_ATTN", impl)
    monkeypatch.setenv("NEMOTRON_TPU_ATTN_BLOCK", str(B))
    # a 14-frame left context makes the ring wrap within a few chunks
    jcc = JCC(att_right_context=R, att_left_context=14, n_mels=cfg.n_mels)
    tcc = TCC(att_right_context=R, att_left_context=14, n_mels=cfg.n_mels)
    n_seg = jcc.kv_len // jcc.chunk_enc_len
    jst = jenc.init_encoder_state(cfg, jcc, B)
    tst = tenc.init_encoder_state(cfg, tcc, B, torch.float32, "cpu")
    jph = jenc.precompute_pos_heads(jp, cfg, jcc)
    tph = tenc.precompute_pos_heads(tp, cfg, tcc)
    np.testing.assert_allclose(tph.numpy(), np.asarray(jph), atol=1e-6)
    # traced anew: the attention path is read from NEMOTRON_TPU_ATTN at
    # trace time, which a jit cache shared across the impls would skip
    jax_step = jax.jit(lambda p, mel, st, ph: jenc.encode_chunk(
        p, cfg, jcc, mel, st, ph))
    rng = np.random.default_rng(100 + R)
    for ci in range(max(4, n_seg + 2)):
        mel = rng.standard_normal((B, jcc.chunk_mel_frames,
                                   cfg.n_mels)).astype(np.float32)
        want, jst = jax_step(jp, jnp.asarray(mel), jst, jph)
        got, tst = tenc.encode_chunk(tp, cfg, tcc, torch.tensor(mel), tst,
                                     tph)
        assert tuple(got.shape) == (B, jcc.valid_out_len, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"chunk {ci}")
        for f in dataclasses.fields(tst):
            np.testing.assert_allclose(
                getattr(tst, f.name).numpy(), np.asarray(getattr(jst, f.name)),
                atol=ATOL, err_msg=f"chunk {ci} {f.name}")
    assert int(tst.phase[0]) == ci + 1 - n_seg * ((ci + 1) // n_seg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_encoder_state_matches_jax(models, dtype):
    cfg = models[1]
    jst = jenc.init_encoder_state(cfg, JCC(n_mels=cfg.n_mels), 2,
                                  getattr(jnp, dtype))
    tst = tenc.init_encoder_state(cfg, TCC(n_mels=cfg.n_mels), 2,
                                  getattr(torch, dtype), "cpu")
    for f in dataclasses.fields(tst):
        want = np.asarray(getattr(jst, f.name))
        got = getattr(tst, f.name).float().numpy()
        assert str(getattr(tst, f.name).dtype)[6:] == str(want.dtype), f.name
        np.testing.assert_array_equal(got, want.astype(np.float32), f.name)


def test_mixed_ring_phase_poisons_output(models):
    (_jp, tp), cfg = models[0]["f32"], models[1]
    cc = TCC(att_right_context=1, att_left_context=12, n_mels=cfg.n_mels)
    ph = tenc.precompute_pos_heads(tp, cfg, cc)
    st = tenc.init_encoder_state(cfg, cc, 2, torch.float32, "cpu")
    mel = torch.zeros((2, cc.chunk_mel_frames, cfg.n_mels))
    out, st = tenc.encode_chunk(tp, cfg, cc, mel, st, ph)
    assert torch.isfinite(out).all()
    st.phase = torch.tensor([0, 1], dtype=torch.int32)
    out, _ = tenc.encode_chunk(tp, cfg, cc, mel, st, ph)
    assert torch.isnan(out).all()


@pytest.mark.parametrize("bias", [0.0, 2.0, 40.0])
def test_greedy_decode_matches_jax(models, bias):
    """Tokens and prev_token exactly equal over chained calls; h/c agree to
    1e-7 -- the LSTM matmuls of the two frameworks sum in different orders
    and differ by about one f32 ulp (2.2e-8), so they are not bit-equal.
    Bias 40 on one token drives every frame to the 10-symbol cap, 0 leaves
    most frames blank."""
    (jp, tp), cfg = models[0]["f32"], models[1]
    out_b = np.asarray(jp.joint.out_b).copy()
    out_b[5] += bias
    jp = dataclasses.replace(jp, joint=dataclasses.replace(
        jp.joint, out_b=out_b))
    tp.joint.out_b = torch.tensor(out_b)
    B, T = 3, 6
    rng = np.random.default_rng(int(bias))
    jst = jdec.init_decoder_state(cfg, B)
    tst = tdec.init_decoder_state(cfg, B, torch.float32, "cpu")
    decode = jax.jit(jdec.greedy_decode, static_argnums=1)
    emitted = 0
    for _ in range(3):
        enc = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
        want, jst = decode(jp, cfg, jnp.asarray(enc), jst)
        got, tst = tdec.greedy_decode(tp, cfg, torch.tensor(enc), tst)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tst.prev_token.numpy(),
                                      np.asarray(jst.prev_token))
        np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), atol=1e-7)
        np.testing.assert_allclose(tst.c.numpy(), np.asarray(jst.c), atol=1e-7)
        emitted += int((got.numpy() != cfg.blank_token).sum())
        assert tdec.extract_emitted(got.numpy(), cfg.blank_token,
                                    np.full(B, 7)) == \
            jdec.extract_emitted(np.asarray(want), cfg.blank_token,
                                 np.full(B, 7))
    if bias == 40.0:
        assert emitted == 3 * B * T * 10
    else:
        assert emitted > 0
    tp.joint.out_b = torch.tensor(np.asarray(models[0]["f32"][0].joint.out_b))


@pytest.fixture(scope="module")
def fixture_models():
    jp, jc, jv = jload_model(FIXTURE)
    tp, tc, tv = tload_model(FIXTURE, device="cpu")
    return (jp, jc, jv), (tp, tc, tv)


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("R", [0, 1, 6, 13])
def test_session_transcripts_match_jax(fixture_models, R, S):
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    audio, _ = tones_mod.make_eval_streams(S, 5.0, 16, seed=7 + R)
    jsess = JSession(jp, jc, jv, JCC(att_right_context=R, n_mels=jc.n_mels),
                     n_streams=S)
    tsess = TSession(tp, tc, tv, TCC(att_right_context=R, n_mels=tc.n_mels),
                     n_streams=S)
    rng = np.random.default_rng(R)
    cuts = np.sort(rng.integers(0, audio.shape[1], 5))
    for piece in np.split(audio, cuts, axis=1):   # ragged feeds, as a CLI
        if piece.shape[1]:
            assert tsess.process(piece) == jsess.process(piece)
    assert tsess.finalize() == jsess.finalize()
    for s in range(S):
        assert tsess.get_tokens(s) == jsess.get_tokens(s)
        assert len(tsess.get_tokens(s)) > 10
    assert tsess.total_chunks == jsess.total_chunks
    tsess.reset()
    assert tsess.get_transcript(0) == "" and tsess.total_chunks == 0


def test_session_process_mel_matches_jax(fixture_models):
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    mel = np.random.default_rng(0).standard_normal(
        (2, 300, jc.n_mels)).astype(np.float32)
    jsess = JSession(jp, jc, jv, JCC(att_right_context=6, n_mels=jc.n_mels),
                     n_streams=2)
    tsess = TSession(tp, tc, tv, TCC(att_right_context=6, n_mels=tc.n_mels),
                     n_streams=2)
    for lo, hi in ((0, 70), (70, 71), (71, 300)):
        assert tsess.process_mel(mel[:, lo:hi]) == \
            jsess.process_mel(mel[:, lo:hi])
    assert tsess.finalize() == jsess.finalize()
    assert tsess.get_tokens(1) == jsess.get_tokens(1)
    assert tsess.total_chunks == jsess.total_chunks > 3


def test_session_q8_tokens_match_jax(models):
    """A session over Q8_0 encoder matmuls (the reference's default GGUF)
    emits the JAX session's tokens; the frontend is bypassed via mel."""
    (jp, tp), cfg = models[0]["q8"], models[1]
    vocab = [f"t{i}" for i in range(cfg.vocab_size)]
    mel = np.random.default_rng(5).standard_normal(
        (1, 200, cfg.n_mels)).astype(np.float32)
    jsess = JSession(jp, cfg, vocab, JCC(att_right_context=1,
                                         n_mels=cfg.n_mels))
    tsess = TSession(tp, cfg, vocab, TCC(att_right_context=1,
                                         n_mels=cfg.n_mels))
    assert tsess.process_mel(mel) == jsess.process_mel(mel)
    assert tsess.finalize() == jsess.finalize()
    assert tsess.get_tokens(0) == jsess.get_tokens(0)
    assert len(tsess.get_tokens(0)) > 0
    assert tsess.total_chunks == jsess.total_chunks > 3


def test_session_refuses_other_decoders(fixture_models, tmp_path):
    """Tracing is ported (tests/test_torch_dump.py holds it to JAX): a
    traced session is built and makes its directory; a beam session is built
    (tests/test_torch_beam.py holds it to JAX), and with confidence it
    raises the JAX package's ValueError; ctc=True on a model without a CTC
    head raises JAX's ValueError (tests/test_torch_ctc.py decodes a hybrid
    model)."""
    _, (tp, tc, tv) = fixture_models
    assert TSession(tp, tc, tv, trace_dir=str(tmp_path / "x")).tracer
    assert (tmp_path / "x").is_dir()
    with pytest.raises(ValueError, match="needs a model with a CTC head"):
        TSession(tp, tc, tv, ctc=True)
    with pytest.raises(ValueError, match="confidence requires greedy"):
        TSession(tp, tc, tv, beam_size=4, confidence=True)
    assert TSession(tp, tc, tv, beam_size=4).beam_state.h.shape[1] == 4


def test_cli_stdout_matches_jax_cli(tmp_path):
    audio, _ = tones_mod.make_eval_streams(1, 4.0, 16, seed=3)
    pcm = tmp_path / "a.pcm"
    audio[0].astype("<i2").tofile(pcm)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    runs = {}
    for name, cmd in (
            ("jax", [os.path.join(REPO, "cli", "transcribe_stream.py")]),
            ("torch", ["-m", "nemotron_tpu_torch.cli"])):
        r = subprocess.run([sys.executable, *cmd, FIXTURE, str(pcm), "80",
                            "6", "--cpu"], capture_output=True, timeout=300,
                           env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr.decode()
        runs[name] = r.stdout.decode()
    assert runs["torch"] == runs["jax"]
    assert len(runs["torch"].strip()) > 10
    r = subprocess.run([sys.executable, "-m", "nemotron_tpu_torch.cli",
                        FIXTURE, "--stdin", "80", "6", "--cpu"],
                       input=pcm.read_bytes(), capture_output=True,
                       timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.decode() == runs["jax"]
    assert "chunks" in r.stderr.decode()
