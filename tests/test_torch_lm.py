"""The label LM and the logit boost, PyTorch port against the JAX package
on the CPU: `lm_logp`, shallow fusion inside `beam_decode` (a zero weight
equals no LM), `lm_sequence_logp` and `rescore_nbest`, the `nemo-lm` GGUF
read both ways, `parse_boost_spec` / `apply_logit_bias`, and fusion and
rescoring through StreamSession (snapshots with the LM state, both ways),
transcribe_batch, both serving engines and the lockstep engine; the
trained fixtures tones_tiny.gguf + tones_tiny_lm.gguf."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu import params as jparams
from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models import beam as jbeam
from nemotron_tpu.models import lm as jlm
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock
from nemotron_tpu.streaming.serving import ServingEngine as JEngine
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.streaming.session import transcribe_batch as jtranscribe
from nemotron_tpu.utils import tones as jtones
from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import beam as tbeam
from nemotron_tpu_torch.models import lm as tlm
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine as TLock
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.streaming.session import StreamSession as TSession
from nemotron_tpu_torch.streaming.session import transcribe_batch as ttrans
from test_torch_beam import (CC_KW, SCORE_RTOL,
                             assert_beams_equal, feed_ragged, jax_flat,
                             peaked_arrays, synth)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
LM_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_lm.gguf")
F32 = torch.float32
LP_ATOL = 1e-5


@pytest.fixture(scope="module")
def tiny(model_setup):
    arrays, _jp, cfg = model_setup
    jp = jparams.params_from_arrays(peaked_arrays(arrays), cfg)
    tp = params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg, [f"w{i}" for i in range(cfg.vocab_size)]


@pytest.fixture(scope="module")
def lms(model_setup):
    """(on-disk arrays, JAX LMParams, port LMParams): 2 layers of 24, with
    a scale that makes the LM opinionated."""
    cfg = model_setup[2]
    arrays = jlm.random_lm_arrays(cfg.vocab_size, hidden=24, n_layers=2,
                                  seed=7, scale=0.6)
    return (arrays, jlm.lm_params_from_arrays(arrays),
            tlm.lm_params_from_arrays(arrays, device="cpu"))


@pytest.fixture(scope="module")
def enc(model_setup):
    cfg = model_setup[2]
    rng = np.random.default_rng(43)
    return rng.standard_normal((3, 6, cfg.d_model)).astype(np.float32) * 0.5


def test_random_lm_arrays_match_jax(lms, model_setup):
    cfg = model_setup[2]
    got = tlm.random_lm_arrays(cfg.vocab_size, hidden=24, n_layers=2,
                               seed=7, scale=0.6)
    assert got.keys() == lms[0].keys()
    for k, v in lms[0].items():
        np.testing.assert_array_equal(got[k], v)


def test_lm_logp_matches_jax(lms, model_setup):
    """One step from <bos> and one from three labels: log-probs (blank at
    NEG_INF, the rest a distribution) and the next states."""
    cfg = model_setup[2]
    _, jl, tl = lms
    prev = np.array([cfg.blank_token, 0, 5, 17], np.int32)
    jh, jc = jlm.init_lm_state(jl, (4,))
    th, tc = tlm.init_lm_state(tl, (4,), F32, "cpu")
    for _ in range(3):
        jlp, jh, jc = jlm.lm_logp(jl, jnp.asarray(prev), jh, jc,
                                  cfg.blank_token)
        tlp, th, tc = tlm.lm_logp(tl, torch.from_numpy(prev), th, tc,
                                  cfg.blank_token)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp),
                                   atol=LP_ATOL, rtol=1e-6)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        prev = np.asarray(jnp.argmax(jlp, axis=-1), np.int32)
    p = torch.exp(tlp)
    assert float(p[:, cfg.blank_token].max()) == 0.0
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)


def run_fused(tiny, lms, enc, K, E, lm_weight=0.3, lm_bonus=0.0,
              lengths=None, U=24):
    jp, tp, cfg, _ = tiny
    _, jl, tl = lms
    js = jbeam.init_beam_state(cfg, enc.shape[0], K, U, lm=jl)
    ts = tbeam.init_beam_state(cfg, enc.shape[0], K, U, F32, "cpu", lm=tl)
    js = jbeam.beam_decode(jp, cfg, jnp.asarray(enc), js, K, E,
                           None if lengths is None else jnp.asarray(lengths),
                           lm=jl, lm_weight=lm_weight, lm_bonus=lm_bonus)
    ts = tbeam.beam_decode(tp, cfg, torch.from_numpy(enc), ts, K, E,
                           None if lengths is None
                           else torch.from_numpy(lengths), lm=tl,
                           lm_weight=lm_weight, lm_bonus=lm_bonus)
    return js, ts


@pytest.mark.parametrize("K,E,weight,bonus,ragged", [
    (2, 3, 0.3, 0.0, False), (4, 2, 0.5, 0.7, True), (4, 10, 1.5, 0.0, False),
    (1, 3, 0.3, 0.2, True)])
def test_fusion_matches_jax(tiny, lms, enc, K, E, weight, bonus, ragged):
    lengths = np.array([6, 3, 0], np.int32) if ragged else None
    js, ts = run_fused(tiny, lms, enc, K, E, weight, bonus, lengths)
    assert_beams_equal(js, ts)
    assert int(ts.lengths.max()) > 0


def test_zero_weight_equals_no_lm(tiny, lms, enc):
    """lm_weight 0 (no bonus): the same hypotheses and scores as the beam
    without an LM; a heavy weight changes them."""
    _, tp, cfg, _ = tiny
    _, ts0 = run_fused(tiny, lms, enc, 4, 3, lm_weight=0.0)
    plain = tbeam.init_beam_state(cfg, 3, 4, 24, F32, "cpu")
    plain = tbeam.beam_decode(tp, cfg, torch.from_numpy(enc), plain, 4, 3)
    for k in ("tokens", "lengths", "prev_token", "scores", "h", "c"):
        assert torch.equal(getattr(ts0, k), getattr(plain, k)), k
    _, heavy = run_fused(tiny, lms, enc, 4, 3, lm_weight=3.0)
    assert not torch.equal(heavy.tokens, plain.tokens)


def test_sequence_logp_and_rescore_match_jax(tiny, lms, enc):
    """lm_sequence_logp over an n-best list, and rescore_nbest's order and
    combined scores, with and without length normalization."""
    jp, tp, cfg, _ = tiny
    _, jl, tl = lms
    js = jbeam.beam_decode(jp, cfg, jnp.asarray(enc),
                           jbeam.init_beam_state(cfg, 3, 4, 24), 4, 3)
    ntok, nlen, nsc = jbeam.n_best(js, None)
    B, N, U = ntok.shape
    want = jlm.lm_sequence_logp(jl, ntok.reshape(B * N, U),
                                nlen.reshape(B * N), cfg.blank_token)
    got = tlm.lm_sequence_logp(
        tl, torch.from_numpy(np.asarray(ntok).reshape(B * N, U)),
        torch.from_numpy(np.asarray(nlen).reshape(B * N)), cfg.blank_token)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-6)
    args = [torch.from_numpy(np.asarray(a)) for a in (ntok, nlen, nsc)]
    for w, b, norm in ((0.3, 0.0, True), (2.0, 0.5, False)):
        jo, jc = jlm.rescore_nbest(jl, ntok, nlen, nsc, cfg.blank_token, w,
                                   b, norm)
        to, tc = tlm.rescore_nbest(tl, *args, cfg.blank_token, w, b, norm)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4,
                                   rtol=1e-6)


def test_lm_gguf_reads_both_ways(lms, tmp_path):
    """The port reads a GGUF the JAX package wrote and the JAX package one
    the port wrote, leaf for leaf; a model GGUF is refused."""
    arrays, jl, tl = lms
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jlm.save_lm(jpath, arrays)
    tlm.save_lm(tpath, tlm.lm_arrays_from_params(tl))
    from_j = tlm.load_lm(jpath, device="cpu")
    from_t = jlm.load_lm(tpath)
    for name in ("embedding", "w_ih", "w_hh", "b_ih", "b_hh", "out_w",
                 "out_b"):
        want = np.asarray(getattr(jl, name))
        np.testing.assert_array_equal(getattr(from_j, name).numpy(), want)
        np.testing.assert_array_equal(np.asarray(getattr(from_t, name)),
                                      want)
    with pytest.raises(ValueError, match="not an LM GGUF"):
        tlm.load_lm(FIXTURE, device="cpu")


def test_boost_matches_jax(tiny):
    """parse_boost_spec and apply_logit_bias (pieces with and without the
    prefix, ids, a full array): the joint bias bit-equal to the JAX
    package's, on the params' device; the JAX errors."""
    jp, tp, cfg, _ = tiny
    vocab = [f"▁p{i}" if i % 2 else f"p{i}" for i in range(cfg.vocab_size)]
    spec = "p2:1.5,p3:-0.25,7:2,▁p9:0.125"
    assert tparams.parse_boost_spec(spec) == jparams.parse_boost_spec(spec)
    for bias in (tparams.parse_boost_spec(spec),
                 np.linspace(-1, 1, cfg.vocab_size).astype(np.float32)):
        got = tparams.apply_logit_bias(tp, bias, vocab)
        want = jparams.apply_logit_bias(jp, bias, vocab)
        np.testing.assert_array_equal(got.joint.out_b.numpy(),
                                      np.asarray(want.joint.out_b))
        assert got.joint.out_b.device == tp.device
        assert got.joint.out_w is tp.joint.out_w
    for bad, match in (("p2", "bad --boost item"), ("nope:1", "not in the")):
        with pytest.raises(ValueError, match=match):
            tparams.apply_logit_bias(tp, tparams.parse_boost_spec(bad),
                                     vocab)
    with pytest.raises(ValueError, match="bias shape"):
        tparams.apply_logit_bias(tp, np.zeros(3, np.float32))


# -- fusion and rescoring through the entry points ---------------------------------


def lm_kw(lms, side, **kw):
    return dict(kw, lm=lms[1] if side == "jax" else lms[2])


def test_session_fusion_text_and_snapshots_match_jax(tiny, lms, tmp_path):
    """A K = 3 session with the LM (weight 0.5, bonus 0.2): transcripts
    after every feed, the beam and LM state, and snapshots (beam/lm_h,
    beam/lm_c) that resume in the other package; a snapshot without LM
    state into a fused session raises."""
    jp, tp, cfg, vocab = tiny
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(beam_size=3, beam_expansions=3, max_beam_tokens=64,
              lm_weight=0.5, lm_bonus=0.2)

    def pair():
        return (JSession(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
                         **lm_kw(lms, "jax", **kw)),
                TSession(tp, cfg, vocab, TCC(**cc), **lm_kw(lms, "t", **kw)))

    js, ts = pair()
    pcm = synth(14000, 4)
    for i in range(0, 7000, 1750):
        js.process(pcm[i:i + 1750])
        ts.process(pcm[i:i + 1750])
        assert ts.get_transcript() == js.get_transcript()
    assert_beams_equal(js.beam_state, ts.beam_state)
    assert ts.beam_state.lm_h is not None
    js.save(str(tmp_path / "j.npz"))
    ts.save(str(tmp_path / "t.npz"))
    assert "beam/lm_h" in np.load(str(tmp_path / "t.npz")).files
    jr, tr = pair()
    jr.load(str(tmp_path / "t.npz"))
    tr.load(str(tmp_path / "j.npz"))
    for a, b in ((js, tr), (jr, ts)):
        a.process(pcm[7000:])
        b.process(pcm[7000:])
        assert b.finalize() == a.finalize()
    plain = TSession(tp, cfg, vocab, TCC(**cc), beam_size=3,
                     max_beam_tokens=64)
    plain.save(str(tmp_path / "p.npz"))
    with pytest.raises(ValueError, match="LM-fusion mismatch"):
        tr.load(str(tmp_path / "p.npz"))


def test_transcribe_batch_lm_and_rescore_match_jax(tiny, lms):
    jp, tp, cfg, vocab = tiny
    utts = [synth(8000, 6), synth(3000, 7), synth(12000, 8)]
    for kw in ({"beam_size": 3, "lm_weight": 0.6},
               {"beam_size": 4, "lm_weight": 0.8, "lm_bonus": 0.3,
                "lm_rescore": True},
               {"beam_size": 4, "lm_weight": 0.8, "lm_rescore": True,
                "return_nbest": 3},
               {"beam_size": 3, "lm_weight": 0.4, "return_nbest": 2}):
        want = jtranscribe(jp, cfg, vocab, utts, **lm_kw(lms, "jax", **kw))
        got = ttrans(tp, cfg, vocab, utts, **lm_kw(lms, "t", **kw))
        if "return_nbest" in kw:
            for g, w in zip(got, want):
                assert [t for t, _ in g] == [t for t, _ in w]
                np.testing.assert_allclose([s for _, s in g],
                                           [s for _, s in w], atol=1e-4,
                                           rtol=SCORE_RTOL)
        else:
            assert got == want
    with pytest.raises(ValueError, match="lm_rescore needs an LM"):
        ttrans(tp, cfg, vocab, utts, beam_size=2, lm_rescore=True)
    with pytest.raises(ValueError, match="LM shallow fusion requires"):
        ttrans(tp, cfg, vocab, utts, lm=lms[2])


@pytest.mark.parametrize("dsp", ["numpy", "device"])
def test_serving_engine_fusion_matches_jax(tiny, lms, dsp, tmp_path):
    """Three ragged slots, K = 2 with the LM: transcripts and the beam (LM
    state included) equal the JAX engine's, and the snapshot carries the
    LM state into a fresh port engine."""
    jp, tp, cfg, vocab = tiny
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(n_slots=3, dsp=dsp, beam_size=2, beam_expansions=3,
              max_beam_tokens=48, lm_weight=0.5)
    je = JEngine(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
                 **lm_kw(lms, "jax", **kw))
    te = TEngine(tp, cfg, vocab, TCC(**cc), compute_dtype=F32,
                 **lm_kw(lms, "t", **kw))
    audio = np.stack([synth(9600, 40 + i) for i in range(3)])
    slots = je.add_streams(3)
    assert te.add_streams(3) == slots
    feed_ragged(je, slots, audio, 1200)
    feed_ragged(te, slots, audio, 1200)
    assert te.refresh_transcripts() == je.refresh_transcripts()
    assert_beams_equal(je.beam_state, te.beam_state)
    te.save(str(tmp_path / "t.npz"))
    te2 = TEngine(tp, cfg, vocab, TCC(**cc), compute_dtype=F32,
                  **lm_kw(lms, "t", **kw))
    te2.load(str(tmp_path / "t.npz"))
    assert_beams_equal(te.beam_state, te2.beam_state)
    assert [te2.finalize_stream(s) for s in slots] == \
        [te.finalize_stream(s) for s in slots]


def test_lockstep_fusion_matches_jax(tiny, lms):
    jp, tp, cfg, vocab = tiny
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(n_streams=2, beam_size=3, beam_expansions=3,
              max_beam_tokens=48, lm_weight=0.5, lm_bonus=0.1)
    je = JLock(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
               **lm_kw(lms, "jax", **kw))
    te = TLock(tp, cfg, vocab, TCC(**cc), compute_dtype=F32,
               **lm_kw(lms, "t", **kw))
    audio = np.stack([synth(8000, 50 + i) for i in range(2)])
    q = TCC(**cc).shift_samples
    for i in range(0, audio.shape[1], q):
        je.tick(audio[:, i:i + q])
        te.tick(audio[:, i:i + q])
    assert_beams_equal(je.beam_state, te.beam_state)
    assert te.finalize() == je.finalize()


def test_trained_fixtures_fusion_matches_jax():
    """tones_tiny.gguf with tones_tiny_lm.gguf, K = 4, weight 0.3 over
    three seeded tone streams at R = 13: the fused beam's tokens equal the
    JAX package's; and transcribe_batch with lm_rescore and an n-best
    list of 4 on the same audio."""
    jp, cfg, vocab = jload_model(FIXTURE)
    tp, tcfg, _ = tload_model(FIXTURE, device="cpu")
    jl, tl = jlm.load_lm(LM_FIXTURE), tlm.load_lm(LM_FIXTURE, device="cpu")
    audio, _ = jtones.make_eval_streams(3, 6.0, 16, seed=9)
    kw = dict(n_streams=3, beam_size=4, max_beam_tokens=256, lm_weight=0.3)
    js = JSession(jp, cfg, vocab, JCC(att_right_context=13,
                                       n_mels=cfg.n_mels),
                  compute_dtype=jnp.float32, lm=jl, **kw)
    ts = TSession(tp, tcfg, vocab, TCC(att_right_context=13,
                                       n_mels=cfg.n_mels), lm=tl, **kw)
    js.process(audio)
    ts.process(audio)
    assert ts.finalize() == js.finalize()
    for s in range(3):
        assert ts.get_tokens(s) == js.get_tokens(s)
        assert len(ts.get_tokens(s)) > 10
    nb = dict(beam_size=4, return_nbest=4, lm_weight=0.3, lm_rescore=True)
    want = jtranscribe(jp, cfg, vocab, list(audio), lm=jl, **nb)
    got = ttrans(tp, tcfg, vocab, list(audio), lm=tl, **nb)
    for g, w in zip(got, want):
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=1e-3, rtol=SCORE_RTOL)
