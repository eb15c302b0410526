"""The RNN-T beam search, PyTorch port against the JAX package on the CPU:
`beam_decode` over beam widths, expansion counts and ragged lengths (every
slot of the state, empty ones included), the tie rules on a constructed
tie, chunk carry, ragged against solo, `best_hypothesis` and `n_best`;
then the beam through StreamSession (text and snapshots that interchange
both ways), transcribe_batch (texts and n-best lists), both serving
engines in both DSP modes and the lockstep engine (with save / load
interchange), and the trained fixture."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models import beam as jbeam
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock
from nemotron_tpu.streaming.serving import ServingEngine as JEngine
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.streaming.session import transcribe_batch as jtranscribe
from nemotron_tpu.utils import tones as jtones
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import beam as tbeam
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine as TLock
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.streaming.session import StreamSession as TSession
from nemotron_tpu_torch.streaming.session import transcribe_batch as ttrans

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
# scores: 1e-5, plus 1e-6 of the score (the peaked model's totals reach
# -100, where one f32 ulp is 7.6e-6 and the two log-softmax summation
# orders differ by a few ulps); h/c: the LSTM states' tolerance
SCORE_ATOL, SCORE_RTOL = 1e-5, 1e-6
STATE_ATOL = 5e-5
F32 = torch.float32
CC_KW = dict(att_right_context=1, att_left_context=12)


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


def synth(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 8000).astype(
        np.int16)


def peaked_arrays(arrays: dict) -> dict:
    """The tiny random model with its prediction network x20 and joint
    x10: at the seed's scale 0.05 the joint's log-probs are nearly flat,
    and every emission then costs more than its blank, so every beam
    stays empty. Peaked, the hypotheses emit and differ."""
    return {k: v * np.float32(20.0 if k.startswith("decoder.") else 10.0)
            if k.startswith(("decoder.", "joint.")) else v
            for k, v in arrays.items()}


@pytest.fixture(scope="module")
def tiny(model_setup):
    """(JAX params, port params, config, vocab) of the peaked tiny model."""
    from nemotron_tpu import params as jparams

    arrays, _jp, cfg = model_setup
    jp = jparams.params_from_arrays(peaked_arrays(arrays), cfg)
    tp = params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg, [f"w{i}" for i in range(cfg.vocab_size)]


@pytest.fixture(scope="module")
def enc(model_setup):
    cfg = model_setup[2]
    rng = np.random.default_rng(42)
    return rng.standard_normal((3, 6, cfg.d_model)).astype(np.float32) * 0.5


def run_both(tiny, enc, K, E, lengths=None, U=24, jstate=None, tstate=None):
    jp, tp, cfg, _ = tiny
    if jstate is None:
        jstate = jbeam.init_beam_state(cfg, enc.shape[0], K, U)
        tstate = tbeam.init_beam_state(cfg, enc.shape[0], K, U, F32, "cpu")
    js = jbeam.beam_decode(jp, cfg, jnp.asarray(enc), jstate, K, E,
                           None if lengths is None else jnp.asarray(lengths))
    ts = tbeam.beam_decode(tp, cfg, torch.from_numpy(enc), tstate, K, E,
                           None if lengths is None
                           else torch.from_numpy(lengths))
    return js, ts


def assert_beams_equal(js, ts):
    """tokens, lengths and prev_token exact in every slot; scores within
    1e-5 + 1e-6 |score|; h/c (and the LM state) within 5e-5."""
    for k in ("tokens", "lengths", "prev_token"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(ts.scores.numpy(), np.asarray(js.scores),
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)
    for k in ("h", "c", "lm_h", "lm_c"):
        if getattr(js, k) is None:
            assert getattr(ts, k) is None, k
            continue
        np.testing.assert_allclose(getattr(ts, k).float().numpy(),
                                   np.asarray(getattr(js, k), np.float32),
                                   atol=STATE_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("E", [1, 3, 10])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_beam_decode_matches_jax(tiny, enc, K, E, ragged):
    lengths = np.array([6, 2, 0], np.int32) if ragged else None
    js, ts = run_both(tiny, enc, K, E, lengths)
    assert_beams_equal(js, ts)
    assert int(ts.lengths.max()) > 0


def test_rank_ties_follow_jax():
    """_rank on rows full of ties: the values and indices of
    jax.lax.top_k and of the stable jnp.argsort(-x)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-2, 2, size=(5, 40)).astype(np.float32)
    x[1] = -1e30
    x[2, ::3] = -1e30
    for k in (1, 4, 9):
        vals, idx = tbeam._rank(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        order = np.asarray(jnp.argsort(-jnp.asarray(x), axis=1))[:, :k]
        np.testing.assert_array_equal(idx.numpy(), order)


def test_constructed_tie_matches_jax(tiny, enc):
    """A joint whose logits are all equal: every candidate of a frame ties
    (uniform log-probs), so the tie rules alone pick the hypotheses, their
    labels and their states. The port keeps the JAX package's choices in
    every slot."""
    jp, tp, cfg, vocab = tiny
    jz = dataclasses.replace(jp, joint=dataclasses.replace(
        jp.joint, out_w=jnp.zeros_like(jp.joint.out_w),
        out_b=jnp.zeros_like(jp.joint.out_b)))
    tz = params_from_jax_arrays(jax_flat(jz), cfg, device="cpu")
    for K, E in ((2, 3), (4, 2)):
        js, ts = run_both((jz, tz, cfg, vocab), enc, K, E,
                          np.array([6, 4, 1], np.int32))
        assert_beams_equal(js, ts)
        # the ties decided: the labels are the lowest ids of their rows
        toks = ts.tokens.numpy()
        emitted = toks[toks != cfg.blank_token]
        assert emitted.size and emitted.max() < K


def test_chunk_carry_and_ragged_match_solo(tiny, enc):
    """Two chunks carried through the state equal one call over both, in
    both packages; a ragged batch equals each stream decoded alone."""
    _, _, cfg, _ = tiny
    K, E = 3, 4
    whole_j, whole_t = run_both(tiny, enc, K, E)
    js, ts = run_both(tiny, enc[:, :3], K, E)
    js, ts = run_both(tiny, enc[:, 3:], K, E, jstate=js, tstate=ts)
    assert_beams_equal(js, ts)
    assert_beams_equal(whole_j, ts)
    lengths = np.array([6, 3, 1], np.int32)
    _, rag = run_both(tiny, enc, K, E, lengths)
    for b, n in enumerate(lengths):
        _, solo = run_both(tiny, enc[b:b + 1, :n], K, E)
        for f in ("tokens", "lengths", "prev_token"):
            np.testing.assert_array_equal(getattr(rag, f)[b].numpy(),
                                          getattr(solo, f)[0].numpy())
        # batched and solo matmuls round apart in the last bits
        np.testing.assert_allclose(rag.scores[b].numpy(),
                                   solo.scores[0].numpy(), atol=SCORE_ATOL,
                                   rtol=SCORE_RTOL)


@pytest.mark.parametrize("length_norm", [False, True])
def test_best_hypothesis_and_n_best_match_jax(tiny, enc, length_norm):
    js, ts = run_both(tiny, enc, 4, 3)
    outs = [(tbeam.best_hypothesis(ts, length_norm),
             jbeam.best_hypothesis(js, length_norm))]
    outs += [(tbeam.n_best(ts, n, length_norm), jbeam.n_best(js, n,
                                                             length_norm))
             for n in (None, 2)]
    for got, want in outs:
        for g, w in zip(got[:2], want[:2]):      # tokens and lengths
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=SCORE_ATOL, rtol=SCORE_RTOL)


def greedy_path_score(tp, cfg, enc: np.ndarray) -> float:
    """The total log-prob of the greedy decode's path for one stream
    (enc [1, T, D]): each emission's log-prob and each frame's closing
    blank, in the prediction network's states along the path."""
    from nemotron_tpu_torch.models import decoder as tdec
    from nemotron_tpu_torch.ops.lstm import lstm_step

    x = torch.from_numpy(enc)
    toks, _ = tdec.greedy_decode(tp, cfg, x, tdec.init_decoder_state(
        cfg, 1, F32, "cpu"))
    ep = tdec.joint_project_enc(tp.joint, x)[0]
    st = tdec.init_decoder_state(cfg, 1, F32, "cpu")
    h, c, prev, score = st.h, st.c, cfg.blank_token, 0.0
    blank = cfg.blank_token
    for t in range(enc.shape[1]):
        closed = False
        for v in toks[0, t].tolist():
            out, h2, c2 = lstm_step(tp.decoder, tp.decoder.embedding[[prev]],
                                    h, c)
            lp = torch.log_softmax(tdec.joint_logits(tp.joint, ep[t:t + 1],
                                                     out)[0], -1)
            if v == blank:
                score += float(lp[blank])
                closed = True
                break
            score += float(lp[v])
            h, c, prev = h2, c2, v
        if not closed:
            out, _, _ = lstm_step(tp.decoder, tp.decoder.embedding[[prev]],
                                  h, c)
            score += float(torch.log_softmax(tdec.joint_logits(
                tp.joint, ep[t:t + 1], out)[0], -1)[blank])
    return score


def test_beam_size_one_scores_at_least_greedy(tiny, enc):
    """K = 1 is not greedy: greedy commits to the argmax label of each
    step, the beam keeps the best finished hypothesis, which can be the
    one that took blank earlier (tests/test_beam.py gates the same floor:
    the K = 1 path's log-prob is at least the greedy path's). Both
    packages' K = 1 states agree (test_beam_decode_matches_jax)."""
    _, tp, cfg, _ = tiny
    for b in range(enc.shape[0]):
        st = tbeam.init_beam_state(cfg, 1, 1, 64, F32, "cpu")
        st = tbeam.beam_decode(tp, cfg, torch.from_numpy(enc[b:b + 1]), st,
                               1, 10)
        _, _, score = tbeam.best_hypothesis(st)
        assert float(score[0]) >= greedy_path_score(tp, cfg,
                                                    enc[b:b + 1]) - 1e-4


# -- the session ----------------------------------------------------------------


def sessions(tiny, **kw):
    jp, tp, cfg, vocab = tiny
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    return (JSession(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
                     **kw),
            TSession(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **kw))


def test_session_beam_text_and_snapshots_match_jax(tiny, tmp_path):
    """K = 4 over several chunks, with beam_expansions 3: the transcript
    (the best hypothesis, rewritten every chunk) equals the JAX session's
    after every feed, and snapshots interchange both ways mid-stream."""
    pcm = synth(16000, 3)
    js, ts = sessions(tiny, beam_size=4, beam_expansions=3,
                      max_beam_tokens=64)
    for i in range(0, 8000, 2000):
        assert ts.process(pcm[i:i + 2000]) == js.process(pcm[i:i + 2000])
        assert ts.get_transcript() == js.get_transcript()
    assert ts.get_transcript()
    assert_beams_equal(js.beam_state, ts.beam_state)
    js.save(str(tmp_path / "j.npz"))
    ts.save(str(tmp_path / "t.npz"))
    # each package resumes from the other's snapshot
    jr, tr = sessions(tiny, beam_size=4, beam_expansions=3,
                      max_beam_tokens=64)
    jr.load(str(tmp_path / "t.npz"))
    tr.load(str(tmp_path / "j.npz"))
    assert_beams_equal(jr.beam_state, tr.beam_state)
    for a, b in ((js, tr), (jr, ts)):
        a.process(pcm[8000:])
        b.process(pcm[8000:])
        assert b.finalize() == a.finalize()
        assert b.get_tokens(0) == a.get_tokens(0)


def test_session_beam_refusals_match_jax(tiny, tmp_path):
    """Confidence, word timestamps and an LM without a beam raise the JAX
    package's ValueErrors; a greedy snapshot into a beam session, a beam
    snapshot into a greedy one and another width raise too."""
    jp, tp, cfg, vocab = tiny
    for kw in ({"beam_size": 4, "confidence": True},
               {"beam_size": 2, "timestamp_words": True},
               {"lm": object()}):
        with pytest.raises(ValueError) as want:
            JSession(jp, cfg, vocab, **kw)
        with pytest.raises(ValueError, match=str(want.value)[:30]):
            TSession(tp, cfg, vocab, **kw)
    greedy = TSession(tp, cfg, vocab)
    beam4 = TSession(tp, cfg, vocab, beam_size=4, max_beam_tokens=16)
    greedy.save(str(tmp_path / "g.npz"))
    beam4.save(str(tmp_path / "b.npz"))
    for sess, path, match in (
            (beam4, "g.npz", "carries no beam state"),
            (greedy, "b.npz", "decodes greedily"),
            (TSession(tp, cfg, vocab, beam_size=2, max_beam_tokens=16),
             "b.npz", "beam width K=4")):
        with pytest.raises(ValueError, match=match):
            sess.load(str(tmp_path / path))


# -- transcribe_batch --------------------------------------------------------------


def test_transcribe_batch_beam_and_nbest_match_jax(tiny):
    jp, tp, cfg, vocab = tiny
    utts = [synth(9000, 1), synth(4000, 2), synth(14000, 3)]
    for kw in ({"beam_size": 3}, {"beam_size": 4, "beam_expansions": 2},
               {"beam_size": 4, "return_nbest": 3}):
        want = jtranscribe(jp, cfg, vocab, utts, **kw)
        got = ttrans(tp, cfg, vocab, utts, **kw)
        if "return_nbest" in kw:
            for g, w in zip(got, want):
                assert [t for t, _ in g] == [t for t, _ in w]
                np.testing.assert_allclose([s for _, s in g],
                                           [s for _, s in w], atol=1e-4)
        else:
            assert got == want
    assert ttrans(tp, cfg, vocab, utts[0], beam_size=2) == \
        jtranscribe(jp, cfg, vocab, utts[0], beam_size=2)
    with pytest.raises(ValueError, match="n-best output requires"):
        ttrans(tp, cfg, vocab, utts, return_nbest=2)
    with pytest.raises(ValueError, match="confidence requires greedy"):
        ttrans(tp, cfg, vocab, utts, beam_size=2, return_confidence=True)
    with pytest.raises(ValueError, match="word timestamps require greedy"):
        ttrans(tp, cfg, vocab, utts, beam_size=2, timestamp_words=True)


# -- the engines ----------------------------------------------------------------------


def feed_ragged(eng, slots, audio, step: int):
    """Slot i is fed at 1 / (i + 1) of the others' rate."""
    for t in range(0, audio.shape[1], step):
        eng.feed_audio({s: audio[i, t // (i + 1):t // (i + 1) + step
                                 // (i + 1)] for i, s in enumerate(slots)})
        eng.step()


@pytest.mark.parametrize("dsp", ["numpy", "device"])
def test_serving_engine_beam_matches_jax(tiny, dsp, tmp_path):
    """Three slots at ragged rates with K = 3: the refreshed transcripts
    and the whole beam slab equal the JAX engine's; the snapshot of each
    package resumes in the other; finalize gives the JAX texts (host DSP;
    the port's device-DSP finalize also decodes a partial last quantum,
    so there the resumed engines are held to each other)."""
    jp, tp, cfg, vocab = tiny
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(n_slots=4, dsp=dsp, beam_size=3, beam_expansions=3,
              max_beam_tokens=48)
    je = JEngine(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32, **kw)
    te = TEngine(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **kw)
    audio = np.stack([synth(12000, 10 + i) for i in range(3)])
    js, ts = je.add_streams(3), te.add_streams(3)
    assert js == ts
    feed_ragged(je, js, audio[:, :6000], 1200)
    feed_ragged(te, ts, audio[:, :6000], 1200)
    assert te.refresh_transcripts() == je.refresh_transcripts()
    assert any(te.transcripts)
    assert_beams_equal(je.beam_state, te.beam_state)
    je.save(str(tmp_path / "j.npz"))
    te.save(str(tmp_path / "t.npz"))
    te2 = TEngine(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **kw)
    te2.load(str(tmp_path / "j.npz"))
    je2 = JEngine(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
                  **kw)
    je2.load(str(tmp_path / "t.npz"))
    assert_beams_equal(je2.beam_state, te2.beam_state)
    outs = []
    for eng in (je, te, je2, te2):
        feed_ragged(eng, ts, audio[:, 6000:], 1200)
        outs.append([eng.finalize_stream(s) for s in ts])
    if dsp == "numpy":
        assert outs[1] == outs[0] == outs[2] == outs[3]
    else:
        assert outs[3] == outs[1]
    assert not te.active.any()


def test_serving_engine_beam_equals_solo_sessions(tiny):
    """Port only: each slot of a ragged beam engine (host DSP; slot 1 fed
    two blocks every other tick) ends with its solo beam session's text."""
    _, tp, cfg, vocab = tiny
    cc = TCC(**CC_KW, n_mels=cfg.n_mels)
    eng = TEngine(tp, cfg, vocab, cc, n_slots=3, compute_dtype=F32,
                  dsp="numpy", beam_size=2, max_beam_tokens=48)
    audio = np.stack([synth(9600, 20 + i) for i in range(2)])
    slots = eng.add_streams(2)
    for t in range(0, audio.shape[1], 1600):
        feed = {slots[0]: audio[0, t:t + 1600]}
        if (t // 1600) % 2:
            feed[slots[1]] = audio[1, t - 1600:t + 1600]
        eng.feed_audio(feed)
        eng.step()
    got = [eng.finalize_stream(s) for s in slots]
    for i in range(2):
        solo = TSession(tp, cfg, vocab, cc, beam_size=2, max_beam_tokens=48)
        solo.process(audio[i])
        assert got[i] == solo.finalize()
    assert any(got)


def test_engine_beam_refusals_match_jax(tiny, tmp_path):
    jp, tp, cfg, vocab = tiny
    for kw in ({"beam_size": 2, "confidence": True}, {"lm": object()},
               {"beam_size": 2, "endpoint_silence_s": 1.0}):
        for J, T in ((JEngine, TEngine), (JLock, TLock)):
            with pytest.raises(ValueError) as want:
                J(jp, cfg, vocab, compute_dtype=jnp.float32, **kw)
            with pytest.raises(ValueError, match=str(want.value)[:25]):
                T(tp, cfg, vocab, compute_dtype=F32, **kw)
    greedy = TEngine(tp, cfg, vocab, n_slots=2, compute_dtype=F32,
                     dsp="numpy")
    greedy.save(str(tmp_path / "g.npz"))
    beam = TEngine(tp, cfg, vocab, n_slots=2, compute_dtype=F32,
                   dsp="numpy", beam_size=2, max_beam_tokens=16)
    with pytest.raises(ValueError, match="beam-mode mismatch"):
        beam.load(str(tmp_path / "g.npz"))


def test_lockstep_beam_matches_jax(tiny, tmp_path):
    """Three streams, K = 3, plain and pipelined ticks: the refreshed
    transcripts and the beam slab equal the JAX engine's, the snapshots
    interchange, and finalize gives the JAX texts."""
    jp, tp, cfg, vocab = tiny
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(n_streams=3, beam_size=3, beam_expansions=3,
              max_beam_tokens=48)
    je = JLock(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32, **kw)
    te = TLock(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **kw)
    tcc = TCC(**cc)
    audio = np.stack([synth(12000, 30 + i) for i in range(3)])
    q = tcc.shift_samples
    for i in range(0, 6000, q):
        assert te.tick_pipelined(audio[:, i:i + q]) == \
            je.tick_pipelined(audio[:, i:i + q]) == {}
    te.flush_pipeline()
    je.flush_pipeline()
    assert te.refresh_transcripts() == je.refresh_transcripts()
    assert_beams_equal(je.beam_state, te.beam_state)
    je.save(str(tmp_path / "j.npz"))
    te.save(str(tmp_path / "t.npz"))
    te2 = TLock(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **kw)
    te2.load(str(tmp_path / "j.npz"))
    je2 = JLock(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32, **kw)
    je2.load(str(tmp_path / "t.npz"))
    outs = []
    for eng in (je, te, je2, te2):
        for i in range(6000, audio.shape[1], q):
            eng.tick(audio[:, i:i + q])
        outs.append(eng.finalize())
    assert outs[1] == outs[0] == outs[2] == outs[3]
    assert any(outs[1])


def test_trained_fixture_beam_matches_jax():
    """tones_tiny.gguf, K = 4, over three seeded tone streams at R = 13:
    the beam transcripts equal the JAX session's."""
    jp, cfg, vocab = jload_model(FIXTURE)
    tp, tcfg, _ = tload_model(FIXTURE, device="cpu")
    audio, _ = jtones.make_eval_streams(3, 6.0, 16, seed=5)
    kw = dict(n_streams=3, beam_size=4, max_beam_tokens=256)
    js = JSession(jp, cfg, vocab, JCC(att_right_context=13,
                                       n_mels=cfg.n_mels),
                  compute_dtype=jnp.float32, **kw)
    ts = TSession(tp, tcfg, vocab, TCC(att_right_context=13,
                                       n_mels=cfg.n_mels), **kw)
    js.process(audio)
    ts.process(audio)
    want = js.finalize()
    assert ts.finalize() == want
    assert all(len(t) > 10 for t in want)
    assert_beams_equal(js.beam_state, ts.beam_state)
