"""Per-emission confidence and word timestamps, PyTorch port against the
JAX package on the CPU: greedy_decode(with_confidence=True) with and
without a step mask and valid lengths, in f32 and bf16; extract_emitted
with confs; StreamSession(timestamp_words, confidence_words) in the four
latency modes; transcribe_batch(return_confidence=True); and the
ServingEngine with confidence in both DSP modes.

Tolerances. Tokens are exact everywhere. The log-posteriors of one decode
on the same encoder output agree within 1e-6 in f32 (the joint's f32 sums
in another order); in bf16 the LSTM state is rounded to bf16 and is not
bit-equal across the two frameworks (ROADMAP Queue 3), so a one-ulp step
of the decoder output (2^-8 relative) moves the logits: within 1e-3 there.
Through the encoder (sessions, batch, engine) the encoder outputs differ
by up to 5e-5, and the log-posteriors are held within that.
"""

import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models import decoder as jdec
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.streaming import session as jsession
from nemotron_tpu.streaming.serving import ServingEngine as JEngine
from nemotron_tpu.utils import tones as jtones
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.streaming import session as tsession
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
CONF_ATOL = {torch.float32: 1e-6, torch.bfloat16: 1e-3}
CONF_ATOL_ENCODED = 5e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def tiny(model_setup):
    """(JAX params, port params, config) of the tiny random model, token 5
    biased by 2 so that most frames emit."""
    _arrays, jp, cfg = model_setup
    out_b = np.asarray(jp.joint.out_b).copy()
    out_b[5] += 2.0
    jp = dataclasses.replace(jp, joint=dataclasses.replace(jp.joint,
                                                           out_b=out_b))
    tp = params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg


@pytest.fixture(scope="module")
def fixture_models():
    return jload_model(FIXTURE), tload_model(FIXTURE, device="cpu")


def assert_triples_close(got, want, atol):
    """Token lists of (id, frame, log_posterior): ids and frames equal,
    log-posteriors within atol and at most 0, all Python scalars."""
    assert [t[:2] for t in got] == [tuple(t[:2]) for t in want]
    for g, w in zip(got, want):
        assert len(g) == 3 and type(g[0]) is int and type(g[1]) is int
        assert type(g[2]) is float and g[2] <= 0.0
        assert abs(g[2] - w[2]) <= atol, (g, w)


@pytest.mark.parametrize("variant", ["plain", "step_mask", "enc_lengths",
                                     "both"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_greedy_confidence_matches_jax(tiny, dtype, variant):
    """Chained calls: tokens and prev_token exact, confs within the
    dtype's tolerance, 0 wherever the token is blank (masked streams and
    frames past a stream's length included); the tokens equal those of
    the call without confidence."""
    jp, tp, cfg = tiny
    tdt, jdt = DTYPES[dtype]
    B, T = 4, 7
    rng = np.random.default_rng(len(variant))
    mask = np.array([True, False, True, True])
    lens = np.array([7, 3, 0, 5], np.int32)
    kw_j, kw_t = {}, {}
    if variant in ("step_mask", "both"):
        kw_j["step_mask"], kw_t["step_mask"] = (jnp.asarray(mask),
                                                torch.tensor(mask))
    if variant in ("enc_lengths", "both"):
        kw_j["enc_lengths"], kw_t["enc_lengths"] = (jnp.asarray(lens),
                                                    torch.tensor(lens))
    decode = jax.jit(functools.partial(jdec.greedy_decode,
                                       with_confidence=True),
                     static_argnums=1)
    jst = jdec.init_decoder_state(cfg, B, jdt)
    tst = tdec.init_decoder_state(cfg, B, tdt, "cpu")
    emitted = 0
    for _ in range(3):
        enc = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
        want, jst, jconf = decode(jp, cfg, jnp.asarray(enc, jdt), jst, **kw_j)
        plain, _ = tdec.greedy_decode(tp, cfg, torch.tensor(enc).to(tdt), tst,
                                      **kw_t)
        got, tst, conf = tdec.greedy_decode(tp, cfg, torch.tensor(enc).to(tdt),
                                            tst, with_confidence=True, **kw_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        np.testing.assert_array_equal(tst.prev_token.numpy(),
                                      np.asarray(jst.prev_token))
        assert conf.dtype == torch.float32 and conf.shape == got.shape
        np.testing.assert_allclose(conf.numpy(), np.asarray(jconf),
                                   atol=CONF_ATOL[tdt], rtol=0)
        blank = got.numpy() == cfg.blank_token
        assert (conf.numpy()[blank] == 0).all()
        assert (conf.numpy()[~blank] <= 0).all()
        emitted += int((~blank).sum())
    assert emitted > 20


@pytest.mark.parametrize("offsets", [None, [0, 5, 10, 15]])
def test_extract_emitted_confs_matches_jax(offsets):
    """Triples (id, frame + offset, log-posterior) as Python scalars, equal
    to the JAX package's extraction of the same arrays."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 6, (4, 5, 3)).astype(np.int32)
    tokens[1] = 5                                  # a stream that is silent
    confs = np.where(tokens != 5, -rng.random(tokens.shape), 0).astype(
        np.float32)
    off = None if offsets is None else np.asarray(offsets, np.int64)
    got = tdec.extract_emitted(tokens, 5, off, confs=confs)
    want = jdec.extract_emitted(tokens, 5, off, confs=confs)
    assert got == want and 1 not in got
    for toks in got.values():
        for t in toks:
            assert tuple(map(type, t)) == (int, int, float)
    assert tdec.extract_emitted(torch.tensor(tokens), 5,
                                confs=torch.tensor(confs)) == \
        jdec.extract_emitted(tokens, 5, confs=confs)


@pytest.mark.parametrize("R", [0, 1, 6, 13])
def test_session_confidence_and_timestamps_match_jax(fixture_models, R):
    """StreamSession(timestamp_words, confidence_words) on the trained
    fixture, two streams fed in ragged pieces: every increment and the
    transcripts ({sec} and {p=...} annotations) equal to JAX's, the
    token triples within the encoded tolerance; confidence alone gives
    triples and an unannotated transcript."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    audio, _ = jtones.make_eval_streams(2, 5.0, 16, seed=30 + R)
    kw = dict(timestamp_words=True, confidence_words=True, n_streams=2)
    jsess = jsession.StreamSession(
        jp, jc, jv, JCC(att_right_context=R, n_mels=jc.n_mels), **kw)
    tsess = tsession.StreamSession(
        tp, tc, tv, TCC(att_right_context=R, n_mels=tc.n_mels), **kw)
    plain = tsession.StreamSession(
        tp, tc, tv, TCC(att_right_context=R, n_mels=tc.n_mels), n_streams=2,
        confidence=True)
    cuts = np.sort(np.random.default_rng(R).integers(0, audio.shape[1], 4))
    for piece in np.split(audio, cuts, axis=1):
        if piece.shape[1]:
            assert tsess.process(piece) == jsess.process(piece)
            plain.process(piece)
    assert tsess.finalize() == jsess.finalize()
    plain.finalize()
    for s in range(2):
        text = tsess.get_transcript(s)
        assert re.search(r"\{\d+\.\d\d\}\{p=\d\.\d\d\}", text), text
        assert_triples_close(tsess.get_tokens(s), jsess.get_tokens(s),
                             CONF_ATOL_ENCODED)
        assert plain.get_tokens(s) == tsess.get_tokens(s)
        assert "{" not in plain.get_transcript(s)
        assert len(tsess.get_tokens(s)) > 10


def test_transcribe_batch_confidence_matches_jax(fixture_models):
    """return_confidence=True: (texts, token lists) for a batch of ragged
    utterances, (text, token list) for one; texts with timestamps equal
    to JAX's, triples within the encoded tolerance, ids and frames equal
    to the call without confidence."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    audio, _ = jtones.make_eval_streams(3, 6.0, 16, seed=41)
    utts = [audio[0], audio[1, :60000], audio[2, :35000]]
    want_texts, want = jsession.transcribe_batch(
        jp, jc, jv, utts, timestamp_words=True, return_confidence=True)
    got_texts, got = tsession.transcribe_batch(
        tp, tc, tv, utts, timestamp_words=True, return_confidence=True)
    assert got_texts == want_texts
    assert len(got) == 3
    for g, w in zip(got, want):
        assert_triples_close(g, w, CONF_ATOL_ENCODED)
        assert len(g) > 5
    text, toks = tsession.transcribe_batch(tp, tc, tv, utts[1],
                                           return_confidence=True)
    assert text == tsession.transcribe_batch(tp, tc, tv, utts[1])
    assert [t[:2] for t in toks] == [t[:2] for t in got[1]]


@pytest.mark.parametrize("dsp", ["numpy", "device"])
def test_engine_confidence_matches_jax(fixture_models, dsp):
    """ServingEngine(confidence=True), f32, 3 slots at ragged rates with a
    slot evicted and one admitted late: the per-tick text and the slots'
    token triples equal to the JAX engine's within the encoded tolerance,
    finalize_stream(return_tokens=True) carries triples, and the tokens
    equal those of the engine without confidence. Compared over the ticks
    of real audio (the device-DSP finalize differs between the two
    packages, ROADMAP Queue 3)."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    audio, _ = jtones.make_eval_streams(4, 5.0, 16, seed=52)
    cc = dict(att_right_context=6, n_mels=jc.n_mels)
    je = JEngine(jp, jc, jv, JCC(**cc), n_slots=3, compute_dtype=jnp.float32,
                 dsp=dsp, confidence=True)
    te = TEngine(tp, tc, tv, TCC(**cc), n_slots=3, compute_dtype=torch.float32,
                 dsp=dsp, confidence=True)
    plain = TEngine(tp, tc, tv, TCC(**cc), n_slots=3,
                    compute_dtype=torch.float32, dsp=dsp)
    assert te.confidence and te.beam_size == 1 and te.beam_state is None
    q = TCC(**cc).shift_samples
    for eng in (je, te, plain):
        assert eng.add_stream() == 0 and eng.add_stream() == 1
    pos = {0: 0, 1: 0, 2: 0, 3: 0}
    owner = {0: 0, 1: 1}
    for tick in range(audio.shape[1] // q):
        if tick == 4:
            for eng in (je, te, plain):
                assert eng.add_stream() == 2
            owner[2] = 2
        if tick == 8:
            outs = [eng.remove_stream(1, return_tokens=True)
                    for eng in (je, te, plain)]
            assert outs[1][0] == outs[0][0]
            assert_triples_close(outs[1][1], outs[0][1], CONF_ATOL_ENCODED)
            assert [t[:2] for t in outs[1][1]] == outs[2][1]
            for eng in (je, te, plain):
                assert eng.add_stream() == 1
            owner[1] = 3
        feed = {s: audio[a, pos[a]:pos[a] + q] for s, a in owner.items()
                if not (s == 0 and tick % 2)}
        for s, a in owner.items():
            if s in feed:
                pos[a] += q
        for eng in (je, te, plain):
            eng.feed_audio(feed)
        jout, tout = je.step(), te.step()
        plain.step()
        assert tout == jout
    for s in range(3):
        assert_triples_close(te.tokens[s], je.tokens[s], CONF_ATOL_ENCODED)
        assert [t[:2] for t in te.tokens[s]] == plain.tokens[s]
        assert te.transcripts[s] == je.transcripts[s] == plain.transcripts[s]
    assert sum(len(te.tokens[s]) for s in range(3)) > 20
    before = list(te.tokens[0])
    text, toks = te.finalize_stream(0, return_tokens=True)
    assert toks[:len(before)] == before and len(toks) > 5
    assert all(len(t) == 3 and t[2] <= 0.0 for t in toks)
    assert text.startswith(je.transcripts[0])
