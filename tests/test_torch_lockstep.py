"""Lockstep serving, PyTorch port against the JAX package on the CPU: the
host wrapper `DeviceFrontend`, and `LockstepEngine` (f32, R = 1 and 13)
against JAX's LockstepEngine and the port's own sessions -- per-tick text,
tokens and device state through plain, pipelined and ragged ticks,
confidence, endpointing and finalize; its snapshots both ways; its
refusals of later slices. On a machine with a card, the engine on the card
against the CPU (marked `cuda`; skipped without one).

The JAX imports sit inside fixtures and tests, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_lockstep.py
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.config import ModelConfig
from nemotron_tpu_torch.frontend.device_frontend import DeviceFrontend
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.params import (load_model, params_from_arrays,
                                       params_from_jax_arrays,
                                       random_weight_arrays)
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine as TLock
from nemotron_tpu_torch.streaming.session import StreamSession as TSession
from nemotron_tpu_torch.utils import npz
from nemotron_tpu_torch.utils import tones as ttones
from nemotron_tpu_torch.utils.text import edit_distance

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
SIL_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_sil.gguf")
# the JAX package's tolerances (ROADMAP north star): log-mel and the DSP
# carry 2e-4, encoder caches 5e-5, decoder state 1e-7, tokens exact; the
# log-posteriors 1e-4
MEL_ATOL = 2e-4
ENC_ATOL = 5e-5
DEC_ATOL = 1e-7
CONF_ATOL = 1e-4
F32 = torch.float32


def cc_kw(R: int, n_mels: int) -> dict:
    """R = 1 as the JAX tests' fixture; R = 13 with a 28-frame left context
    (two chunks: the ring wraps within a few ticks)."""
    return dict(att_right_context=R, att_left_context=12 if R == 1 else 28,
                n_mels=n_mels)


def synth(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 8000
            ).astype(np.int16)


def jax_flat(params) -> dict:
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def tiny(model_setup):
    """(JAX params, port params, config, vocab) of the tiny random model."""
    _arrays, jp, cfg = model_setup
    tp = params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg, [f"w{i}" for i in range(cfg.vocab_size)]


def engines(tiny, R, n_streams, **kw):
    """A JAX lockstep engine and a port one, f32, over the same model."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock

    jp, tp, cfg, vocab = tiny
    ckw = cc_kw(R, cfg.n_mels)
    return (JLock(jp, cfg, vocab, JCC(**ckw), n_streams=n_streams,
                  compute_dtype=jnp.float32, **kw),
            TLock(tp, cfg, vocab, TCC(**ckw), n_streams=n_streams,
                  compute_dtype=F32, **kw))


def assert_states_close(je, te):
    """Encoder caches within 5e-5 (valid_len and phase exact), decoder h/c
    within 1e-7 (prev_token exact), the mel ring and the DSP carry within
    2e-4, the host counters equal."""
    pairs = [(je.enc_state, te.enc_state, ENC_ATOL),
             (je.dec_state, te.dec_state, DEC_ATOL),
             (je.front, te.front, MEL_ATOL)]
    for js, ts, tol in pairs:
        for f in dataclasses.fields(ts):
            got = npz.to_numpy(getattr(ts, f.name)).astype(np.float32)
            want = np.asarray(getattr(js, f.name)).astype(np.float32)
            exact = f.name in ("valid_len", "phase", "prev_token")
            np.testing.assert_allclose(got, want, atol=0 if exact else tol,
                                       rtol=0, err_msg=f.name)
    np.testing.assert_allclose(npz.to_numpy(te.mel_buf),
                               np.asarray(je.mel_buf, np.float32),
                               atol=MEL_ATOL, rtol=0)
    assert (te.buf_len, te.frame_offset, te.total_chunks) == \
        (je.buf_len, je.frame_offset, je.total_chunks)


# -- DeviceFrontend ------------------------------------------------------------


def test_device_frontend_matches_jax(tiny):
    """Ragged PCM sizes (shorter than a window, one hop, odd sizes, 2-D and
    1-D): the log-mel within 2e-4 of JAX's DeviceFrontend, the same frame
    counts, and the DSP carry interchanged both ways through state_dict
    continuing as an uninterrupted run."""
    from nemotron_tpu.frontend.device_frontend import \
        DeviceFrontend as JFront

    from nemotron_tpu_torch.config import PreprocessorConfig

    _jp, tp, cfg, _ = tiny
    pcfg = PreprocessorConfig(n_mels=cfg.n_mels)
    fb = tp.preprocessor.filterbank.numpy()
    win = tp.preprocessor.window.numpy()
    jf = JFront(fb, win, n_streams=3, cfg=pcfg)
    tf = DeviceFrontend(fb, win, n_streams=3, cfg=pcfg, device="cpu")
    assert tf.device == torch.device("cpu")
    for i, n in enumerate((100, 160, 1601, 37, 4000, 399, 2560)):
        assert tf.n_frames_for(n) == jf.n_frames_for(n)
        pcm = synth((3, n), i)
        got, want = tf.process(pcm), jf.process(pcm)
        assert got.shape == want.shape and got.shape[0] == 3
        np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)
        for k, v in tf.state_dict().items():
            np.testing.assert_allclose(v, jf.state_dict()[k], atol=MEL_ATOL,
                                       rtol=0, err_msg=k)
    # the carry handed across: each package continues from the other's
    tf2 = DeviceFrontend(fb, win, n_streams=3, cfg=pcfg, device="cpu")
    jf2 = JFront(fb, win, n_streams=3, cfg=pcfg)
    tf2.load_state_dict(jf.state_dict())
    jf2.load_state_dict(tf.state_dict())
    pcm = synth((3, 3001), 99)
    want = jf.process(pcm)
    for fe in (tf2, jf2, tf):
        np.testing.assert_allclose(fe.process(pcm), want, atol=MEL_ATOL,
                                   rtol=0)
    # one stream, 1-D in and out; reset restores the initial carry
    one = DeviceFrontend(fb, win, device="cpu")
    jone = JFront(fb, win)
    mono = synth(2000, 5)
    got = one.process(mono)
    assert got.ndim == 2
    np.testing.assert_allclose(got, jone.process(mono), atol=MEL_ATOL,
                               rtol=0)
    one.reset()
    assert one.state_dict()["residue"].shape == (1, pcfg.initial_pad)
    np.testing.assert_allclose(one.process(mono), got, atol=0, rtol=0)


# -- the engine against the JAX engine and the session ------------------------


@pytest.mark.parametrize("R", [1, 13])
def test_lockstep_matches_jax_and_session(tiny, R):
    """tests/test_serving.py:587-616: four canonical ticks and a short
    tail, then finalize. Every tick's text and the state after each tick
    equal JAX's; the finals and tokens equal JAX's and a host-frontend
    StreamSession's."""
    jp, tp, cfg, vocab = tiny
    je, te = engines(tiny, R, 3)
    n = te.cc.shift_samples
    audio = synth((3, 4 * n + n // 3), 3)
    for t in range(4):
        blk = audio[:, t * n:(t + 1) * n]
        assert te.tick(blk) == je.tick(blk), t
        assert_states_close(je, te)
    assert te.tick(audio[:, 4 * n:]) == je.tick(audio[:, 4 * n:])
    final = te.finalize()
    assert final == je.finalize()
    assert te.tokens == je.tokens
    assert_states_close(je, te)

    sess = TSession(tp, cfg, vocab, te.cc, n_streams=3)
    sess.process(audio)
    assert final == sess.finalize()
    assert any(final)
    for s in range(3):
        assert te.tokens[s] == sess.get_tokens(s)


@pytest.mark.parametrize("R", [1, 13])
def test_lockstep_pipelined_matches_tick(tiny, R):
    """tests/test_serving.py:641-667: tick_pipelined gives tick()'s
    per-tick dicts one call later, the same transcripts and tokens, and the
    same finals; JAX's pipelined engine gives the same dicts."""
    je, te = engines(tiny, R, 2)
    _, plain = engines(tiny, R, 2)
    n = te.cc.shift_samples
    audio = synth((2, 5 * n), 9)
    outs_plain, outs_pipe, outs_jax = [], [], []
    for t in range(5):
        blk = audio[:, t * n:(t + 1) * n]
        outs_plain.append(plain.tick(blk))
        outs_pipe.append(te.tick_pipelined(blk))
        outs_jax.append(je.tick_pipelined(blk))
    outs_pipe.append(te.flush_pipeline())
    outs_jax.append(je.flush_pipeline())
    assert te.flush_pipeline() == {}
    assert outs_pipe == outs_jax
    assert outs_pipe[0] == {} and outs_plain == outs_pipe[1:]
    assert any(outs_plain)
    assert plain.transcripts == te.transcripts
    assert plain.tokens == te.tokens
    assert plain.finalize() == te.finalize() == je.finalize()


@pytest.mark.parametrize("R", [1, 13])
def test_lockstep_ragged_tick(tiny, R):
    """tests/test_serving.py:670-701: after the first tick fixes the
    canonical size, an oversize block (3.5 canonical ticks) splits into
    canonical sub-ticks plus an exact remainder and a short tail runs at
    its exact size -- sample-exact against canonical pieces, and equal to
    JAX's engine fed the same ragged blocks."""
    je, a = engines(tiny, R, 2)
    _, b = engines(tiny, R, 2)
    n = a.cc.shift_samples
    audio = synth((2, 6 * n + n // 4), 21)
    for blk in (audio[:, :n], audio[:, n:4 * n + n // 2],
                audio[:, 4 * n + n // 2:]):
        assert a.tick(blk) == je.tick(blk)
    for t in range(6):
        b.tick(audio[:, t * n:(t + 1) * n])
    b.tick(audio[:, 6 * n:])
    final = a.finalize()
    assert final == b.finalize() == je.finalize()
    assert a.transcripts == b.transcripts
    assert a.tokens == b.tokens == je.tokens
    assert_states_close(je, a)


def test_lockstep_tick_refuses_a_mel_ring_overflow(tiny):
    """The ragged rule guards the ring: a first tick larger than one chunk
    shift plus a frame would overflow it, and raises (JAX's assert)."""
    _, te = engines(tiny, 1, 1)
    with pytest.raises(AssertionError, match="overflow the mel ring"):
        te.tick(synth((1, 3 * te.cc.shift_samples), 1))


@pytest.mark.parametrize("R", [1, 13])
def test_lockstep_snapshot_resume(tiny, tmp_path, R):
    """tests/test_serving.py:704-731: a snapshot after three ticks, loaded
    into a fresh engine, continues to the same transcripts, tokens and
    finals; the snapshot is a copy (later ticks do not change it) and
    save drains a pending pipelined tick first."""
    _, a = engines(tiny, R, 2)
    n = a.cc.shift_samples
    audio = synth((2, 5 * n), 11)
    for t in range(3):
        a.tick_pipelined(audio[:, t * n:(t + 1) * n])
    ck = str(tmp_path / "lockstep.npz")
    a.save(ck)
    assert a._pending is None
    before = dict(np.load(ck, allow_pickle=True))
    for t in range(3, 5):
        a.tick(audio[:, t * n:(t + 1) * n])
    _, b = engines(tiny, R, 2)
    b.load(ck)
    for t in range(3, 5):
        b.tick(audio[:, t * n:(t + 1) * n])
    assert a.transcripts == b.transcripts
    assert a.tokens == b.tokens
    assert a.finalize() == b.finalize()
    assert any(a.transcripts)
    a.save(ck)
    after = np.load(ck, allow_pickle=True)
    assert not np.array_equal(before["enc/k_cache"], after["enc/k_cache"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lockstep_snapshot_interchanges_with_jax(tiny, tmp_path, writer):
    """A lockstep snapshot (R = 1, confidence and endpointing on) written
    by either package loads in the other, which continues to the writer's
    tokens, transcripts, endpoint state and finals."""
    kw = dict(confidence=True, endpoint_silence_s=0.3, endpoint_reset=True)
    je, te = engines(tiny, 1, 2, **kw)
    n = te.cc.shift_samples
    audio = synth((2, 7 * n + 50), 31)
    for eng in (je, te):
        for t in range(3):
            eng.tick(audio[:, t * n:(t + 1) * n])
    path = str(tmp_path / "l.npz")
    (je if writer == "jax" else te).save(path)
    rj, rt = engines(tiny, 1, 2, **kw)
    reader = rt if writer == "jax" else rj
    reader.load(path)
    events = {}
    for name, eng in (("jax", je), ("torch", te), ("reader", reader)):
        for t in range(3, 7):
            eng.tick(audio[:, t * n:(t + 1) * n])
        events[name] = eng.poll_endpoints()
        eng.tick(audio[:, 7 * n:])
        eng.finalize()
    ref = je if writer == "jax" else te
    for name, eng in (("reader", reader), ("torch", te)):
        assert [(t[0], t[1]) for ts in eng.tokens for t in ts] == \
            [(t[0], t[1]) for ts in je.tokens for t in ts], name
        for ts, tj in zip(eng.tokens, je.tokens):
            np.testing.assert_allclose([t[2] for t in ts],
                                       [t[2] for t in tj], atol=CONF_ATOL)
        assert eng.transcripts == je.transcripts
        assert (eng.ep_silence == ref.ep_silence).all()
        assert [e[:2] for e in events[name]] == \
            [e[:2] for e in events["jax"]]
    assert sum(map(len, je.tokens)) > 5


@pytest.mark.parametrize("R", [1, 13])
def test_lockstep_confidence_matches_jax_and_session(tiny, R):
    """tests/test_serving.py:1184-1218: confidence=True gives the plain
    engine's (id, frame) stream as triples, equal to JAX's with the
    log-posteriors within 1e-4, and to a StreamSession(confidence=True)'s;
    every log-posterior <= 0. With beam_size=2 the port raises the JAX
    package's ValueError for the combination."""
    jp, tp, cfg, vocab = tiny
    je, te = engines(tiny, R, 2, confidence=True)
    _, plain = engines(tiny, R, 2)
    n = te.cc.shift_samples
    audio = synth((2, 3 * n), 11)
    for t in range(3):
        blk = audio[:, t * n:(t + 1) * n]
        assert te.tick(blk) == je.tick(blk) == plain.tick(blk)
    sess = TSession(tp, cfg, vocab, te.cc, n_streams=2, confidence=True)
    sess.process(audio)
    assert any(te.tokens)
    for s in range(2):
        got, want = te.tokens[s], je.tokens[s]
        assert [t[:2] for t in got] == [t[:2] for t in want] == \
            plain.tokens[s] == [t[:2] for t in sess.get_tokens(s)]
        assert all(c <= 1e-6 for *_x, c in got)
        np.testing.assert_allclose([t[2] for t in got],
                                   [t[2] for t in want], atol=CONF_ATOL)
        np.testing.assert_allclose([t[2] for t in got],
                                   [t[2] for t in sess.get_tokens(s)],
                                   atol=1e-6)
    assert te.transcripts == sess.transcripts
    with pytest.raises(ValueError, match="confidence requires greedy"):
        TLock(tp, cfg, vocab, te.cc, n_streams=2, beam_size=2,
              confidence=True)


def test_lockstep_endpoint_state_machine(tiny):
    """tests/test_serving.py:1451-1506 on the port: silence counted from
    the last token's frame, a fired stream gets a fresh prediction network
    (the other stream's untouched), events partition the tokens; the same
    script through JAX's engine gives the same events and resets."""
    import jax.numpy as jnp

    from nemotron_tpu.models import decoder as jdec

    jp, tp, cfg, vocab = tiny
    with pytest.raises(ValueError, match="endpointing requires greedy"):
        TLock(tp, cfg, vocab, TCC(**cc_kw(1, cfg.n_mels)), n_streams=2,
              beam_size=2, endpoint_silence_s=0.5)
    je, te = engines(tiny, 1, 2, endpoint_silence_s=0.8,
                     endpoint_reset=True)
    assert te._ep_frames == je._ep_frames == 10
    je.dec_state = jdec.DecoderState(
        h=jnp.ones_like(je.dec_state.h), c=jnp.ones_like(je.dec_state.c),
        prev_token=jnp.full_like(je.dec_state.prev_token, 3))
    te.dec_state = tdec.DecoderState(
        h=torch.ones_like(te.dec_state.h), c=torch.ones_like(te.dec_state.c),
        prev_token=torch.full_like(te.dec_state.prev_token, 3))
    V = te.cc.valid_out_len
    assert V == 2
    logs = []
    for eng in (je, te):
        log, off = [], 8
        eng.tokens[0] = [(7, 2), (9, 5)]
        eng._ep_update({0: [(7, 2), (9, 5)]}, current_offset=off)  # sil 2
        log.append(eng.poll_endpoints())
        for _ in range(4):                     # sil 4, 6, 8, 10: fires
            off += V
            eng._ep_update({}, current_offset=off)
        log.append(eng.poll_endpoints())
        log.append((np.asarray(npz.to_numpy(eng.dec_state.h)).tolist(),
                    np.asarray(npz.to_numpy(eng.dec_state.prev_token))
                    .tolist()))
        off += V
        eng.tokens[0].append((3, off - 2))
        eng._ep_update({0: [(3, off - 2)]}, current_offset=off)  # sil 1
        log.append(eng.poll_endpoints())
        for _ in range(5):                     # sil 3, 5, 7, 9, 11: fires
            off += V
            eng._ep_update({}, current_offset=off)
        log.append(eng.poll_endpoints())
        log.append((eng.utterances_retired, off))
        logs.append(log)
    want, got = logs
    assert got == want
    assert got[0] == [] and len(got[1]) == 1 and got[1][0][0] == 0
    assert got[1][0][2] == [(7, 2), (9, 5)]
    h, prev = got[2]
    assert np.max(h[0]) == 0 and np.min(h[1]) == 1
    assert prev == [cfg.blank_token, 3]
    assert got[3] == [] and got[4][0][2] == [(3, got[5][1] - 12)]
    assert got[5][0] == 2


@pytest.mark.parametrize("R", [1, 13])
def test_lockstep_endpoint_snapshot(tiny, tmp_path, R):
    """tests/test_serving.py:1509-1526: the endpoint state survives
    save/load, and a pending event too."""
    je, te = engines(tiny, R, 2, endpoint_silence_s=0.8)
    n = te.cc.shift_samples
    pcm = np.concatenate([synth((2, n), 70 + R), synth((2, n), 71)], axis=1)
    for eng in (te, je):
        for t in range(2):
            eng.tick(pcm[:, t * n:(t + 1) * n])
    te._ep_pending.append((1, len(te.tokens[1])))
    p = str(tmp_path / "lk_ep.npz")
    te.save(p)
    _, t2 = engines(tiny, R, 2, endpoint_silence_s=0.8)
    t2.load(p)
    for a, b in ((t2, te), (te, je)):
        assert (a.ep_silence == b.ep_silence).all()
        assert (a.ep_emitted == b.ep_emitted).all()
        assert (a.ep_utt_start == b.ep_utt_start).all()
    assert t2._ep_pending == te._ep_pending


def endpoint_audio(truth1, truth2):
    """Two tone utterances, each followed by 3 s of silence."""
    rng = np.random.default_rng(7)

    def utt(labels, tail_s):
        n = (int(0.30 * len(labels) * ttones.SAMPLE_RATE)
             + int(tail_s * ttones.SAMPLE_RATE))
        return ttones.render_tones(np.asarray(labels),
                                   np.full(len(labels), 0.25), rng, 16, n,
                                   gaps=np.full(len(labels), 0.05))

    return np.concatenate([utt(truth1, 3.0), utt(truth2, 3.0)])


def test_lockstep_endpointing_trained_fixture_matches_jax():
    """Endpointing through real ticks on the trained silence fixture (R =
    13, pipelined, endpoint_reset): two streams, the second a second late;
    the events, tokens and transcripts equal JAX's, and stream 0's two
    utterances are each within Levenshtein 1 of their labels."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.params import load_model as jload_model
    from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock

    truth1, truth2 = [3, 11, 6, 0, 14, 9], [8, 2, 15]
    audio = endpoint_audio(truth1, truth2)
    pcm = np.stack([audio, np.roll(audio, 16000)])
    runs = {}
    for name in ("jax", "torch"):
        kw = dict(n_streams=2, endpoint_silence_s=1.0, endpoint_reset=True)
        if name == "jax":
            params, cfg, vocab = jload_model(SIL_FIXTURE, keep_quantized=False)
            eng = JLock(params, cfg, vocab, JCC(att_right_context=13,
                                                n_mels=cfg.n_mels),
                        compute_dtype=jnp.float32, **kw)
        else:
            params, cfg, vocab = load_model(SIL_FIXTURE, device="cpu")
            eng = TLock(params, cfg, vocab, TCC(att_right_context=13,
                                                n_mels=cfg.n_mels),
                        compute_dtype=F32, **kw)
        n = eng.cc.shift_samples
        events = []
        for t in range(pcm.shape[1] // n):
            eng.tick_pipelined(pcm[:, t * n:(t + 1) * n])
            events.extend(eng.poll_endpoints())
        eng.flush_pipeline()
        events.extend(eng.poll_endpoints())
        runs[name] = (events, eng.tokens, eng.finalize())
    assert runs["torch"] == runs["jax"]
    events = [e for e in runs["torch"][0] if e[0] == 0]
    assert len(events) == 2, events
    for (_s, _text, toks), truth in zip(events, (truth1, truth2)):
        got = [int(vocab[t].replace("▁T", "")) for t, _ in toks]
        assert edit_distance(got, truth) <= 1, (got, truth)


def test_lockstep_bf16_mel_ring(tiny, tmp_path):
    """In bf16 the mel ring is bf16, as JAX's (lockstep.py:379): after a
    tick it equals JAX's bf16 ring within one bf16 step of the log-mel
    (2^-8 relative), the snapshot holds it as f32, exactly, and loads back
    to the same bf16 ring."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock

    jp, tp, cfg, vocab = tiny
    ckw = cc_kw(1, cfg.n_mels)
    je = JLock(jp, cfg, vocab, JCC(**ckw), n_streams=2,
               compute_dtype=jnp.bfloat16)
    te = TLock(tp, cfg, vocab, TCC(**ckw), n_streams=2)
    assert te.dtype == torch.bfloat16 == te.mel_buf.dtype
    n = te.cc.shift_samples
    blk = synth((2, n + 400), 5)
    je.tick(blk)
    te.tick(blk)
    want = np.asarray(je.mel_buf, np.float32)
    got = npz.to_numpy(te.mel_buf)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                               atol=MEL_ATOL)
    p = str(tmp_path / "bf.npz")
    te.save(p)
    z = np.load(p, allow_pickle=True)
    assert z["mel_buf"].dtype == np.float32
    np.testing.assert_array_equal(z["mel_buf"], got)
    t2 = TLock(tp, cfg, vocab, TCC(**ckw), n_streams=2)
    t2.load(p)
    assert t2.mel_buf.dtype == torch.bfloat16
    assert torch.equal(t2.mel_buf, te.mel_buf)
    assert t2.mel_buf.data_ptr() != te.mel_buf.data_ptr()


def test_lockstep_refuses_later_slices_and_defaults(tiny, tmp_path):
    """A one-rank mesh builds an engine over every stream (the multi-GPU
    slice, tests/test_torch_mesh.py), a beam engine too (its rows of the
    beam state, tests/test_torch_mesh_beam.py); beam search is ported
    (tests/test_torch_beam.py) and an LM without a beam raises the JAX
    package's ValueError; so is the TDT/CTC slice (tests/test_torch_tdt.py,
    tests/test_torch_ctc.py): ctc=True without a CTC head raises JAX's
    ValueError, and a TDT config builds a TDT engine. The defaults are
    JAX's (256 streams, bf16) and the device is the params'. Snapshots of
    another stream count or of a beam, CTC or TDT engine are refused."""
    _jp, tp, cfg, vocab = tiny
    cc = TCC(**cc_kw(1, cfg.n_mels))
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    assert TLock(tp, cfg, vocab, cc, n_streams=2, compute_dtype=F32,
                 mesh=mesh, beam_size=4).beam_state.h.shape[:2] == (2, 4)
    assert TLock(tp, cfg, vocab, cc, n_streams=2, compute_dtype=F32,
                 mesh=mesh).dec_state.h.shape[0] == 2
    with pytest.raises(ValueError, match="needs a model with a CTC head"):
        TLock(tp, cfg, vocab, cc, n_streams=2, ctc=True)
    with pytest.raises(ValueError, match="LM shallow fusion requires"):
        TLock(tp, cfg, vocab, cc, n_streams=2, lm=object())
    assert TLock(tp, cfg, vocab, cc, n_streams=2, compute_dtype=F32,
                 beam_size=4).beam_state.tokens.shape[:2] == (2, 4)
    tdt = TLock(tp, dataclasses.replace(cfg, tdt_durations=(0, 1, 2)),
                vocab, cc, n_streams=2)
    assert tdt.tdt and not tdt.ctc and tdt.tdt_skip.shape == (2,)
    with pytest.raises(ValueError, match="compute_dtype"):
        TLock(tp, cfg, vocab, cc, n_streams=2, compute_dtype=torch.float16)
    defaults = inspect.signature(TLock).parameters
    assert defaults["n_streams"].default == 256
    assert defaults["compute_dtype"].default == torch.bfloat16
    eng = TLock(tp, cfg, vocab, cc, n_streams=2, compute_dtype=F32)
    assert eng.device == torch.device("cpu")
    assert eng.refresh_transcripts() == ["", ""]
    assert eng.finalize() == ["", ""] and eng.total_chunks == 0
    path = str(tmp_path / "x.npz")
    eng.save(path)
    with pytest.raises(ValueError, match="stream rows"):
        TLock(tp, cfg, vocab, cc, n_streams=3, compute_dtype=F32).load(path)
    flat = dict(np.load(path, allow_pickle=True))
    for key, what in (("tdt_skip", "TDT"), ("ctc_prev", "CTC"),
                      ("beam/h", "beam")):
        bad = str(tmp_path / f"{what}.npz")
        np.savez(bad, **flat, **{key: np.zeros(2, np.int32)})
        with pytest.raises(ValueError, match=what):
            eng.load(bad)


# -- on the card ---------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def tiny_port_model(device):
    """The JAX tests' tiny config with the port's seeded random weights."""
    cfg = ModelConfig(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                      n_layers=3, kernel_size=9, vocab_size=41,
                      decoder_dim=48, joint_dim=56, subsampling_channels=16)
    arrays = random_weight_arrays(cfg, seed=0)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    return params_from_arrays(arrays, cfg, device), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tiny", "tones"])
def test_lockstep_on_card_equals_cpu(cuda_device, model):
    """The same ticks (plain, pipelined, a ragged oversize block and a
    short tail, confidence on) through the lockstep engine on the card and
    on the CPU, f32, R = 6: the same tokens (log-posteriors within 1e-3)
    and finals, each chunk one attention launch a layer."""
    from nemotron_tpu_torch.ops.ring_attn_kernel import fused_ring_attention

    runs, launches = {}, {}
    for dev in ("cpu", "cuda"):
        if model == "tiny":
            params, cfg = tiny_port_model(dev)
            vocab = [f"w{i} " for i in range(cfg.vocab_size)]
        else:
            params, cfg, vocab = load_model(FIXTURE, device=dev)
        eng = TLock(params, cfg, vocab, TCC(att_right_context=6,
                                            n_mels=cfg.n_mels),
                    n_streams=4, compute_dtype=F32, confidence=True)
        audio, _ = ttones.make_eval_streams(4, 6.0, 16, seed=5)
        n = eng.cc.shift_samples
        before = fused_ring_attention.launches
        eng.tick(audio[:, :n])
        for t in range(1, 4):
            eng.tick_pipelined(audio[:, t * n:(t + 1) * n])
        eng.flush_pipeline()
        eng.tick(audio[:, 4 * n:7 * n + n // 2])
        eng.tick(audio[:, 7 * n + n // 2:8 * n])
        finals = eng.finalize()
        runs[dev] = (finals, eng.tokens, eng.total_chunks)
        launches[dev] = fused_ring_attention.launches - before
    (f_cpu, t_cpu, k), (f_gpu, t_gpu, k_gpu) = runs["cpu"], runs["cuda"]
    assert f_gpu == f_cpu and k_gpu == k and any(f_cpu)
    assert [[x[:2] for x in ts] for ts in t_gpu] == \
        [[x[:2] for x in ts] for ts in t_cpu]
    for a, b in zip(t_gpu, t_cpu):
        np.testing.assert_allclose([x[2] for x in a], [x[2] for x in b],
                                   atol=1e-3)
    assert launches["cpu"] == 0 and launches["cuda"] == k * cfg.n_layers
