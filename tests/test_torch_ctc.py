"""CTC decoding of hybrid checkpoints, PyTorch port against the JAX
package on the CPU: the head's logits and per-frame log-posteriors, the
argmax on a constructed tie, the host collapse (with confidence); GGUF
files with a CTC head both ways and the head's carry through
params_from_jax_arrays, the quant tiers and the casts; then ctc=True
through StreamSession (snapshots both ways), transcribe_batch, both
serving engines and the lockstep engine (save / load interchange), and
the JAX package's refusals. The trained hybrid fixture, the CLIs and the
server: tests/test_torch_tdt_ctc_entry.py.

The model is the JAX tests' tiny random model with a CTC head whose
weight is x8, so that the argmax moves from frame to frame (at the seed's
scale the bias decides most frames); the audio is seeded tone streams."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from nemotron_tpu import params as jparams
from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models import ctc as jctc
from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock
from nemotron_tpu.streaming.serving import ServingEngine as JEngine
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.streaming.session import transcribe_batch as jtranscribe
from nemotron_tpu.utils import tones as jtones
from nemotron_tpu_torch import gguf as tgguf
from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import ctc as tctc
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine as TLock
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.streaming.session import StreamSession as TSession
from nemotron_tpu_torch.streaming.session import transcribe_batch as ttrans

torch.set_num_threads(1)

ATOL = 1e-5
F32 = torch.float32
CC_KW = dict(att_right_context=1, att_left_context=12)


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


def hybrid_arrays(cfg, seed=0) -> dict:
    arrays = jparams.random_weight_arrays(cfg, seed=seed, ctc_head=True)
    arrays["ctc_decoder.decoder_layers.0.weight"] *= np.float32(8.0)
    return arrays


@pytest.fixture(scope="module")
def hybrid():
    """(JAX params, port params, config, vocab) of the tiny hybrid model."""
    cfg = tiny_config()
    jp = jparams.params_from_arrays(hybrid_arrays(cfg), cfg)
    tp = tparams.params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg, [f"w{i}" for i in range(cfg.vocab_size)]


@pytest.fixture(scope="module")
def tones():
    audio, _ = jtones.make_eval_streams(3, 4.0, 16, seed=17)
    return audio


# -- the head and the collapse ------------------------------------------------


def test_ctc_head_matches_jax(hybrid):
    """ctc_logits and frame_log_posteriors within 1e-5 (f32, and bf16
    activations against the JAX package's bf16 product), the argmax ids
    and ctc_greedy_decode's lists (with lengths) equal."""
    jp, tp, cfg, _ = hybrid
    enc = np.random.default_rng(3).standard_normal(
        (3, 12, cfg.d_model)).astype(np.float32)
    x = torch.from_numpy(enc)
    np.testing.assert_allclose(tctc.ctc_logits(tp, x).numpy(),
                               np.asarray(jctc.ctc_logits(jp,
                                                          jnp.asarray(enc))),
                               atol=ATOL, rtol=0)
    ids, lp = tctc.frame_log_posteriors(tp, x)
    jids, jlp = jctc.frame_log_posteriors(jp, jnp.asarray(enc))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=ATOL,
                               rtol=0)
    assert len(np.unique(ids.numpy())) > 4
    lens = np.array([12, 7, 0], np.int32)
    got = tctc.ctc_greedy_decode(tp, cfg, x, enc_lengths=lens)
    assert got == jctc.ctc_greedy_decode(jp, cfg, jnp.asarray(enc),
                                         enc_lengths=jnp.asarray(lens))
    assert got[0] and got[2] == []
    assert tctc.ctc_greedy_decode(tp, cfg, x) == jctc.ctc_greedy_decode(
        jp, cfg, jnp.asarray(enc))
    jb = jctc.ctc_logits(jp, jnp.asarray(enc, jnp.bfloat16))
    tb = tctc.ctc_logits(tp, x.to(torch.bfloat16))
    assert tb.dtype == F32
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL,
                               rtol=1e-6)


def test_ctc_argmax_tie_matches_jax(hybrid):
    """A head whose logits tie at several ids on every frame: the argmax
    takes the lowest of them, in torch.argmax as in jnp.argmax."""
    jp, tp, cfg, _ = hybrid
    V = cfg.vocab_size
    bias = np.zeros(V, np.float32)
    bias[[7, 3, 29, V - 1]] = 2.0
    jz = dataclasses.replace(jp, ctc=dataclasses.replace(
        jp.ctc, out_w=jnp.zeros_like(jp.ctc.out_w), out_b=jnp.asarray(bias)))
    tz = tparams.params_from_jax_arrays(jax_flat(jz), cfg, device="cpu")
    enc = np.random.default_rng(4).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    got = tctc.frame_ids(tz, torch.from_numpy(enc)).numpy()
    want = np.asarray(jnp.argmax(jctc.ctc_logits(jz, jnp.asarray(enc)), -1))
    np.testing.assert_array_equal(got, want)
    assert (got == 3).all()


def test_collapse_matches_jax():
    """collapse and collapse_with_confidence on seeded ids full of repeats
    and blanks, with lengths and a frame offset: equal lists."""
    rng = np.random.default_rng(5)
    blank = 40
    for trial in range(6):
        ids = rng.choice([blank, blank, 1, 2, 3, 7], size=rng.integers(0, 30))
        lp = rng.standard_normal(ids.shape).astype(np.float32)
        n = None if trial % 2 else int(rng.integers(0, len(ids) + 1))
        assert tctc.collapse(ids, blank, n) == jctc.collapse(ids, blank, n)
        assert tctc.collapse_with_confidence(ids, lp, blank, n, 11) == \
            jctc.collapse_with_confidence(ids, lp, blank, n, 11)


# -- GGUF and params ----------------------------------------------------------


def test_ctc_gguf_round_trips_both_ways(hybrid, tmp_path):
    """The port reads the CTC head of a file JAX's save_model wrote, and
    JAX's load_model reads the one the port wrote with gguf.write_gguf."""
    jp, tp, cfg, vocab = hybrid
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jparams.save_model(jpath, jp, cfg, vocab=vocab)
    tp2, tcfg, _ = tparams.load_model(jpath, device="cpu")
    assert not tcfg.tdt_durations
    np.testing.assert_array_equal(tp2.ctc.out_w.numpy(),
                                  np.asarray(jp.ctc.out_w))
    np.testing.assert_array_equal(tp2.ctc.out_b.numpy(),
                                  np.asarray(jp.ctc.out_b))
    arrays = hybrid_arrays(cfg, seed=9)
    conv = {k: (v.squeeze(1).T if k.endswith(".depthwise_conv.weight")
                else v.squeeze(2) if k.endswith((".pointwise_conv1.weight",
                                                 ".pointwise_conv2.weight"))
                else v) for k, v in arrays.items()}
    meta = {"general.architecture": "nemo",
            "tokenizer.vocab": tgguf.encode_vocab(vocab),
            "nemo.n_mels": cfg.n_mels, "nemo.d_model": cfg.d_model,
            "nemo.n_heads": cfg.n_heads, "nemo.d_head": cfg.d_head,
            "nemo.d_ff": cfg.d_ff, "nemo.n_layers": cfg.n_layers,
            "nemo.kernel_size": cfg.kernel_size,
            "nemo.vocab_size": cfg.vocab_size}
    tgguf.write_gguf(tpath, meta, conv)
    jp3, _, _ = jparams.load_model(tpath)
    tp3, _, _ = tparams.load_model(tpath, device="cpu")
    want = jax_flat(jp3)
    got = tparams.flatten(tp3)
    assert set(got) == set(want) and "ctc.out_b" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # a file without the head loads without one
    plain = {k: v for k, v in conv.items() if not k.startswith("ctc_")}
    tgguf.write_gguf(tpath, meta, plain)
    assert tparams.load_model(tpath, device="cpu")[0].ctc is None


def test_ctc_head_carries_through_params(hybrid):
    """params_from_jax_arrays takes the head; the quant tiers leave it
    dense (as JAX's quantize_model_params does), the casts cast it, and
    flatten lists it under the JAX pytree's paths."""
    jp, tp, cfg, _ = hybrid
    assert isinstance(tp.ctc, tparams.CtcParams)
    np.testing.assert_array_equal(tparams.flatten(tp)["ctc.out_w"].numpy(),
                                  jax_flat(jp)["ctc.out_w"])
    for mode in ("q8_0", "w8a8"):
        q = tparams.quantize_model_params(tp, mode)
        jq = jparams.quantize_model_params(jp, mode)
        assert torch.equal(q.ctc.out_w, tp.ctc.out_w)
        np.testing.assert_array_equal(q.ctc.out_w.numpy(),
                                      np.asarray(jq.ctc.out_w))
    cast = tparams.cast_params(tp, torch.bfloat16)
    assert cast.ctc.out_w.dtype == torch.bfloat16
    moved = tparams.to_device(tp, "cpu")
    assert torch.equal(moved.ctc.out_b, tp.ctc.out_b)
    flat = {k: v for k, v in jax_flat(jp).items() if not k.startswith("ctc")}
    assert tparams.params_from_jax_arrays(flat, cfg, device="cpu").ctc is None


# -- the session and transcribe_batch -----------------------------------------


@pytest.mark.parametrize("kw", [{}, {"confidence_words": True,
                                     "timestamp_words": True}])
def test_session_ctc_matches_jax(hybrid, tones, kw, tmp_path):
    """Two streams: the text after every feed, the tokens with their
    frames (and log-posteriors), ctc_prev, and snapshots taken mid-stream
    that each package resumes from the other's."""
    jp, tp, cfg, vocab = hybrid
    cc = dict(CC_KW, n_mels=cfg.n_mels)

    def make():
        return (JSession(jp, cfg, vocab, JCC(**cc), n_streams=2, ctc=True,
                         **kw),
                TSession(tp, cfg, vocab, TCC(**cc), n_streams=2, ctc=True,
                         **kw))

    pcm = tones[:2, :32000]
    js, ts = make()
    assert ts.ctc and not ts.tdt
    for i in range(0, 16000, 3000):
        assert ts.process(pcm[:, i:i + 3000]) == js.process(pcm[:, i:i + 3000])
    np.testing.assert_array_equal(ts.ctc_prev, js.ctc_prev)
    js.save(str(tmp_path / "j.npz"))
    ts.save(str(tmp_path / "t.npz"))
    jr, tr = make()
    jr.load(str(tmp_path / "t.npz"))
    tr.load(str(tmp_path / "j.npz"))
    for a, b in ((js, tr), (jr, ts)):
        a.process(pcm[:, 16000:])
        b.process(pcm[:, 16000:])
        assert b.finalize() == a.finalize()
        for s in range(2):
            got, want = b.get_tokens(s), a.get_tokens(s)
            assert [t[:2] for t in got] == [t[:2] for t in want]
            np.testing.assert_allclose([t[2:] for t in got],
                                       [t[2:] for t in want], atol=ATOL)
    # repeats were collapsed and more than one id emitted
    ids = [t[0] for t in ts.get_tokens(0)]
    assert len(set(ids)) > 1 and ts.total_chunks > 3


def test_session_ctc_refusals_match_jax(hybrid, tmp_path):
    """ctc=True with a beam, with an LM, with tracing and on a model
    without a CTC head raise the JAX package's ValueErrors; a CTC snapshot
    into an RNN-T session and an RNN-T snapshot into a CTC session are
    refused."""
    jp, tp, cfg, vocab = hybrid
    jplain = dataclasses.replace(jp, ctc=None)
    tplain = dataclasses.replace(tp, ctc=None)
    for (j, t), kw in (((jp, tp), {"beam_size": 2}), ((jp, tp), {"lm": 1}),
                       ((jp, tp), {"trace_dir": "x"}),
                       ((jplain, tplain), {})):
        with pytest.raises(ValueError) as want:
            JSession(j, cfg, vocab, ctc=True, **kw)
        with pytest.raises(ValueError,
                               match=re.escape(str(want.value)[:30])):
            TSession(t, cfg, vocab, ctc=True, **kw)
    TSession(tp, cfg, vocab, ctc=True).save(str(tmp_path / "c.npz"))
    TSession(tp, cfg, vocab).save(str(tmp_path / "r.npz"))
    with pytest.raises(ValueError, match="CTC collapse state"):
        TSession(tp, cfg, vocab).load(str(tmp_path / "c.npz"))
    with pytest.raises(ValueError, match="carries no ctc_prev"):
        TSession(tp, cfg, vocab, ctc=True).load(str(tmp_path / "r.npz"))


def test_transcribe_batch_ctc_matches_jax(hybrid, tones):
    """ctc=True over a ragged batch: texts, and with confidence the token
    lists (frames exact, log-posteriors within 1e-5); a beam, word
    timestamps and a model without the head raise JAX's ValueErrors."""
    jp, tp, cfg, vocab = hybrid
    utts = [tones[0, :30000], tones[1, :12000], tones[2]]
    assert ttrans(tp, cfg, vocab, utts, ctc=True) == \
        jtranscribe(jp, cfg, vocab, utts, ctc=True)
    got = ttrans(tp, cfg, vocab, utts, ctc=True, return_confidence=True)
    want = jtranscribe(jp, cfg, vocab, utts, ctc=True,
                       return_confidence=True)
    assert got[0] == want[0] and all(got[0])
    for g, w in zip(got[1], want[1]):
        assert [t[:2] for t in g] == [t[:2] for t in w]
        np.testing.assert_allclose([t[2] for t in g], [t[2] for t in w],
                                   atol=ATOL)
    for p, kw in ((tp, {"beam_size": 2}), (tp, {"timestamp_words": True}),
                  (dataclasses.replace(tp, ctc=None), {})):
        with pytest.raises(ValueError, match="ctc decode is plain|no CTC"):
            ttrans(p, cfg, vocab, utts[1], ctc=True, **kw)


# -- the engines --------------------------------------------------------------


def feed_ragged(eng, slots, audio, step: int):
    """Slot i is fed at 1 / (i + 1) of the others' rate."""
    for t in range(0, audio.shape[1], step):
        eng.feed_audio({s: audio[i, t // (i + 1):t // (i + 1) + step
                                 // (i + 1)] for i, s in enumerate(slots)})
        eng.step()


@pytest.mark.parametrize("dsp,confidence", [("numpy", True),
                                            ("device", False)])
def test_serving_engine_ctc_matches_jax(hybrid, tones, dsp, confidence,
                                        tmp_path):
    """Three slots at ragged rates: tokens (with log-posteriors), texts and
    ctc_prev equal the JAX engine's; each package resumes the other's
    snapshot; finalize gives the JAX texts (host DSP; with device DSP the
    resumed engines are held to each other, the port's finalize decoding
    a partial last quantum that JAX's drops)."""
    jp, tp, cfg, vocab = hybrid
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(n_slots=4, dsp=dsp, ctc=True, confidence=confidence)

    def make():
        return (JEngine(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
                        **kw),
                TEngine(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **kw))

    je, te = make()
    assert te.ctc and not te.tdt
    audio = tones[:, :24000]
    js, ts = je.add_streams(3), te.add_streams(3)
    feed_ragged(je, js, audio[:, :12000], 1200)
    feed_ragged(te, ts, audio[:, :12000], 1200)
    assert te.transcripts == je.transcripts and any(te.transcripts)
    np.testing.assert_array_equal(te.ctc_prev, je.ctc_prev)
    for s in ts:
        assert [t[:2] for t in te.tokens[s]] == [t[:2] for t in je.tokens[s]]
        np.testing.assert_allclose([t[2:] for t in te.tokens[s]],
                                   [t[2:] for t in je.tokens[s]], atol=ATOL)
    je.save(str(tmp_path / "j.npz"))
    te.save(str(tmp_path / "t.npz"))
    je2, te2 = make()
    te2.load(str(tmp_path / "j.npz"))
    je2.load(str(tmp_path / "t.npz"))
    outs = []
    for eng in (je, te, je2, te2):
        feed_ragged(eng, ts, audio[:, 12000:], 1200)
        outs.append([eng.finalize_stream(s) for s in ts])
    if dsp == "numpy":
        assert outs[1] == outs[0] == outs[2] == outs[3]
    else:
        assert outs[3] == outs[1]


def test_lockstep_ctc_matches_jax(hybrid, tones, tmp_path):
    """Three streams, pipelined ticks with confidence: every tick's text,
    the tokens and ctc_prev equal the JAX engine's; the snapshots
    interchange and finalize gives the JAX texts."""
    jp, tp, cfg, vocab = hybrid
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(n_streams=3, ctc=True, confidence=True)

    def make():
        return (JLock(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
                      **kw),
                TLock(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **kw))

    je, te = make()
    audio = tones[:, :24000]
    q = TCC(**cc).shift_samples
    for i in range(0, 12000, q):
        assert te.tick_pipelined(audio[:, i:i + q]) == \
            je.tick_pipelined(audio[:, i:i + q])
    te.flush_pipeline()
    je.flush_pipeline()
    assert te.transcripts == je.transcripts and any(te.transcripts)
    np.testing.assert_array_equal(te.ctc_prev, je.ctc_prev)
    je.save(str(tmp_path / "j.npz"))
    te.save(str(tmp_path / "t.npz"))
    je2, te2 = make()
    te2.load(str(tmp_path / "j.npz"))
    je2.load(str(tmp_path / "t.npz"))
    outs = []
    for eng in (je, te, je2, te2):
        for i in range(12000, audio.shape[1], q):
            eng.tick(audio[:, i:i + q])
        outs.append(eng.finalize())
    assert outs[1] == outs[0] == outs[2] == outs[3]
    for s in range(3):
        assert [t[:2] for t in te.tokens[s]] == [t[:2] for t in je.tokens[s]]


def test_engine_ctc_refusals_match_jax(hybrid, tmp_path):
    """ctc=True with a beam, with endpoint_reset and on a model without
    the head raise the JAX engines' ValueErrors in both engines; a CTC
    snapshot into an RNN-T engine and back are refused."""
    jp, tp, cfg, vocab = hybrid
    jplain = dataclasses.replace(jp, ctc=None)
    tplain = dataclasses.replace(tp, ctc=None)
    for (j, t), kw in (((jp, tp), {"beam_size": 2}),
                       ((jp, tp), {"endpoint_reset": True}),
                       ((jplain, tplain), {})):
        for J, T in ((JEngine, TEngine), (JLock, TLock)):
            with pytest.raises(ValueError) as want:
                J(j, cfg, vocab, compute_dtype=jnp.float32, ctc=True, **kw)
            with pytest.raises(ValueError,
                               match=re.escape(str(want.value)[:30])):
                T(t, cfg, vocab, compute_dtype=F32, ctc=True, **kw)
    for T, kw in ((TEngine, {"n_slots": 2, "dsp": "numpy"}),
                  (TLock, {"n_streams": 2})):
        T(tp, cfg, vocab, compute_dtype=F32, ctc=True, **kw).save(
            str(tmp_path / "c.npz"))
        T(tp, cfg, vocab, compute_dtype=F32, **kw).save(
            str(tmp_path / "r.npz"))
        for ctc, path in ((False, "c.npz"), (True, "r.npz")):
            with pytest.raises(ValueError, match="CTC-mode mismatch"):
                T(tp, cfg, vocab, compute_dtype=F32, ctc=ctc, **kw).load(
                    str(tmp_path / path))
