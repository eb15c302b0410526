"""Session and engine snapshots in the PyTorch port against the JAX package
on the CPU: save, load and continue equals an uninterrupted run bit for bit
(f32 and bf16, int4 rings, confidence, both DSP modes, endpointing); a
snapshot written by one package loads in the other and continues to the
same tokens (sessions both ways; the engine both ways in both DSP modes
with dense, int8 and int4 rings); legacy bf16
leaves; snapshots of decoders this port does not run are refused."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.streaming.serving import ServingEngine as JEngine
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.utils import tones as tones_mod
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.streaming.session import StreamSession as TSession
from nemotron_tpu_torch.utils import npz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(scope="module")
def fixture_models():
    return jload_model(FIXTURE), tload_model(FIXTURE, device="cpu")


@pytest.fixture(scope="module")
def audio():
    a, _ = tones_mod.make_eval_streams(2, 6.0, 16, seed=3)
    return a


def assert_sessions_equal(a, b):
    """Tokens, transcripts and every state leaf bit-equal."""
    assert a.tokens == b.tokens and a.transcripts == b.transcripts
    assert a.frame_offset == b.frame_offset
    for st_a, st_b in ((a.enc_state, b.enc_state), (a.dec_state, b.dec_state)):
        for f in dataclasses.fields(st_a):
            x, y = getattr(st_a, f.name), getattr(st_b, f.name)
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
    np.testing.assert_array_equal(a.mel_buffer, b.mel_buffer)
    # the DSP state through the preprocessor's snapshot (either backend:
    # a CPU session's DSP is the native one, as the JAX session's)
    for k, v in a.preproc.state_dict().items():
        np.testing.assert_array_equal(v, b.preproc.state_dict()[k],
                                      err_msg=k)


@pytest.mark.parametrize("dtype,kv,conf", [
    (F32, {}, False), (BF16, {}, True), (F32, dict(kv_cache_int4=True), True),
    (BF16, dict(kv_cache_int8=True), False)])
def test_session_resume_is_bit_exact(fixture_models, audio, tmp_path, dtype,
                                     kv, conf):
    """Save mid-stream, load into a fresh session, feed the rest: tokens and
    every state leaf equal the uninterrupted run's. The loaded rings are
    fresh tensors: the resumed session's in-place writes leave the
    snapshot's arrays alone."""
    _, (tp, tc, tv) = fixture_models
    cc = TCC(att_right_context=6, n_mels=tc.n_mels, **kv)

    def make():
        return TSession(tp, tc, tv, cc, n_streams=2, compute_dtype=dtype,
                        confidence=conf)

    cut = 37_000
    ref = make()
    ref.process(audio[:, :cut])
    path = str(tmp_path / "s.npz")
    ref.save(path)
    st = ref.state_dict()
    ring = st["enc/k_cache"].copy()
    ref.process(audio[:, cut:])
    ref.finalize()

    res = make()
    res.load(path)
    res.load_state_dict(st)
    res.process(audio[:, cut:])
    res.finalize()
    assert_sessions_equal(ref, res)
    np.testing.assert_array_equal(st["enc/k_cache"], ring)
    assert len(ref.tokens[0]) > 10
    assert all(len(t) == (3 if conf else 2) for t in ref.tokens[1])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_session_snapshot_interchanges_with_jax(fixture_models, audio,
                                                tmp_path, writer):
    """A snapshot written by either package loads in the other and
    continues to the JAX session's tokens (f32, R = 13, 2 streams)."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    jcc = JCC(att_right_context=13, n_mels=jc.n_mels)
    tcc = TCC(att_right_context=13, n_mels=tc.n_mels)
    cut = 41_000
    jref = JSession(jp, jc, jv, jcc, n_streams=2)
    jref.process(audio[:, :cut])
    tpre = TSession(tp, tc, tv, tcc, n_streams=2)
    tpre.process(audio[:, :cut])
    path = str(tmp_path / "s.npz")
    (jref if writer == "jax" else tpre).save(path)
    jref.process(audio[:, cut:])
    jref.finalize()

    reader = (TSession(tp, tc, tv, tcc, n_streams=2) if writer == "jax"
              else JSession(jp, jc, jv, jcc, n_streams=2))
    reader.load(path)
    reader.process(audio[:, cut:])
    reader.finalize()
    for s in range(2):
        assert reader.get_tokens(s) == jref.get_tokens(s)
        assert len(jref.get_tokens(s)) > 10
    assert reader.transcripts == jref.transcripts


def test_session_refuses_other_decoders_snapshots(fixture_models):
    _, (tp, tc, tv) = fixture_models
    sess = TSession(tp, tc, tv)
    st = sess.state_dict()
    for key, value, match in (
            ("ctc_prev", np.zeros(1, np.int64), "CTC"),
            ("tdt_skip", np.zeros(1, np.int32), "TDT"),
            ("beam/h", np.zeros((1, 4, 2, 8), np.float32), "beam state")):
        with pytest.raises(ValueError, match=match):
            sess.load_state_dict(st | {key: value})


def test_npz_leaves_bf16_and_legacy_void(tmp_path):
    """bf16 leaves are written upcast to f32 (the JAX package's format);
    legacy '|V2' leaves come back as bf16; to_tensor never aliases."""
    x = torch.tensor([1.5, -2.25, 3e-3]).to(BF16)
    path = str(tmp_path / "a.npz")
    legacy = x.view(torch.int16).numpy().view(np.dtype("V2"))
    npz.savez(path, {"x": x, "legacy": legacy})
    z = npz.NpzView(np.load(path))
    assert z["x"].dtype == np.float32
    assert torch.equal(npz.to_tensor(z["x"], BF16, "cpu"), x)
    assert torch.equal(npz.to_tensor(z["legacy"], BF16, "cpu"), x)
    a = np.arange(4, dtype=np.int8)
    t = npz.to_tensor(a, torch.int8, "cpu")
    t += 1
    np.testing.assert_array_equal(a, np.arange(4))


def feed_schedule(eng, audio, ticks, start=0, q=4000):
    """Ragged feeds: slot 0 every tick, slot 1 every other one."""
    for t in range(start, start + ticks):
        feed = {0: audio[0, t * q:(t + 1) * q]}
        if t % 2 == 0:
            feed[1] = audio[1, t // 2 * q:(t // 2 + 1) * q]
        eng.feed_audio(feed)
        eng.step()


@pytest.mark.parametrize("dsp,dtype,kw", [
    ("numpy", F32, dict(confidence=True)),
    ("device", BF16, dict(endpoint_silence_s=0.4, keep_segment_audio=True)),
    ("device", F32, {})])
def test_engine_resume_is_bit_exact(fixture_models, audio, tmp_path, dsp,
                                    dtype, kw):
    """An engine saved mid-load (staged PCM in the FIFOs, a lagging slot)
    and loaded into a fresh engine continues exactly as the uninterrupted
    one: tokens, transcripts, endpoint events and every state leaf."""
    _, (tp, tc, tv) = fixture_models
    cc = TCC(att_right_context=6, n_mels=tc.n_mels)

    def make():
        return TEngine(tp, tc, tv, cc, n_slots=3, compute_dtype=dtype,
                       dsp=dsp, **kw)

    ref = make()
    assert ref.add_streams(2) == [0, 1]
    feed_schedule(ref, audio, 9)
    ref.feed_audio({0: audio[0, 36_000:37_500]})   # a partial quantum
    path = str(tmp_path / "e.npz")
    ref.save(path)
    res = make()
    res.load(path)
    for eng in (ref, res):
        eng.feed_audio({0: audio[0, 37_500:40_000]})
        feed_schedule(eng, audio, 4, start=10)
    events = [e.poll_endpoints() for e in (ref, res)]
    finals = [e.finalize_streams([0, 1], return_tokens=True)
              for e in (ref, res)]
    assert finals[0] == finals[1] and events[0] == events[1]
    assert len(finals[0][0][1]) > 10
    for f in dataclasses.fields(ref.enc_state):
        assert torch.equal(getattr(ref.enc_state, f.name),
                           getattr(res.enc_state, f.name)), f.name
    assert res.enc_state.k_cache.dtype == ref.enc_state.k_cache.dtype


RINGS = {"dense": {}, "int8": dict(kv_cache_int8=True),
         "int4": dict(kv_cache_int4=True)}
INTERCHANGE_CASES = [pytest.param("numpy", "dense", w, id=w)
                     for w in ("jax", "torch")] + [
    pytest.param(d, r, w, id=f"{d}-{r}-{w}")
    for d in ("numpy", "device") for r in RINGS for w in ("jax", "torch")
    if (d, r) != ("numpy", "dense")]


@pytest.mark.parametrize("dsp,ring,writer", INTERCHANGE_CASES)
def test_engine_snapshot_interchanges_with_jax(fixture_models, audio,
                                               tmp_path, dsp, ring, writer):
    """The engine (f32, R = 1, endpointing on) with host or device DSP and
    dense, int8 or int4 rings, saved with a partial DSP quantum staged: a
    snapshot written by either package loads in the other, and the reader
    continues to the tokens, transcripts and endpoint state of both
    uninterrupted engines. Finalized with a partial quantum left, each
    reader ends as its own package's engine does: with host DSP both
    packages end alike; with device DSP the JAX engine drops the partial
    quantum (a fault of the reference, ROADMAP Queue 3) and ends one token
    short on that slot."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    kw = dict(n_slots=3, dsp=dsp, endpoint_silence_s=0.4)
    kv = RINGS[ring]

    def jax_engine():
        return JEngine(jp, jc, jv, JCC(att_right_context=1, n_mels=jc.n_mels,
                                       **kv), compute_dtype=jnp.float32, **kw)

    def torch_engine():
        return TEngine(tp, tc, tv, TCC(att_right_context=1, n_mels=tc.n_mels,
                                       **kv), compute_dtype=F32, **kw)

    je, te = jax_engine(), torch_engine()
    for eng in (je, te):
        assert eng.add_streams(2) == [0, 1]
        feed_schedule(eng, audio, 6)
        eng.feed_audio({1: audio[1, 12_000:13_500]})   # a partial quantum
    path = str(tmp_path / "e.npz")
    (je if writer == "jax" else te).save(path)
    reader = torch_engine() if writer == "jax" else jax_engine()
    reader.load(path)
    for eng in (je, te, reader):
        eng.feed_audio({0: audio[0, 24_000:28_000],
                        1: audio[1, 13_500:16_000]})
        eng.step()
        feed_schedule(eng, audio, 4, start=7)
        eng.poll_endpoints()
    for eng in (te, reader):
        assert eng.tokens == je.tokens
        assert eng.transcripts == je.transcripts
        assert (eng.ep_silence == je.ep_silence).all()
    assert len(je.tokens[0]) > 5
    finals = {}
    for name, eng in (("jax", je), ("torch", te), ("reader", reader)):
        eng.feed_audio({1: audio[1, 24_000:27_840]})   # ends mid-quantum
        finals[name] = [eng.finalize_stream(s, return_tokens=True)
                        for s in (0, 1)]
    assert finals["reader"] == finals["torch" if writer == "jax" else "jax"]
    (_, j0), (_, j1) = finals["jax"]
    (_, t0), (_, t1) = finals["torch"]
    assert j0 == t0
    assert j1 == (t1 if dsp == "numpy" else t1[:-1])


def test_engine_load_refusals(fixture_models, tmp_path):
    _, (tp, tc, tv) = fixture_models
    cc = TCC(att_right_context=1, n_mels=tc.n_mels)
    host = TEngine(tp, tc, tv, cc, n_slots=2, compute_dtype=F32, dsp="numpy")
    path = str(tmp_path / "h.npz")
    host.save(path)
    with pytest.raises(ValueError, match="slots"):
        TEngine(tp, tc, tv, cc, n_slots=3, compute_dtype=F32).load(path)
    with pytest.raises(ValueError, match="host-DSP"):
        TEngine(tp, tc, tv, cc, n_slots=2, compute_dtype=F32,
                dsp="device").load(path)
    z = dict(np.load(path, allow_pickle=True))
    np.savez(path, **z, ctc_prev=np.zeros(2, np.int64))
    with pytest.raises(ValueError, match="CTC"):
        host.load(path)
