"""TDT decoding, PyTorch port against the JAX package on the CPU:
`tdt_greedy_decode` (skip carry, step mask, lengths, confidence, the
iteration count) and `tdt_beam_decode` (beam widths, the LM, the step
mask, every slot of the state, empty ones included, a constructed tie,
chunked against one-shot, K = 1 against greedy); GGUF files with TDT
metadata (and a CTC head) both ways; then the TDT decode through
StreamSession (greedy, confidence, beam, beam + LM; snapshots both ways),
both serving engines and the lockstep engine (save / load interchange).
transcribe_batch, the trained fixture and the CLIs:
tests/test_torch_tdt_ctc_entry.py.

The tiny model is the JAX TDT tests' (tests/test_tdt.py: durations 0-3,
seed 3) with a CTC head, its prediction network x5 and joint x3 so that
beam hypotheses emit and differ. Peaked harder (x20 / x10, as
tests/test_torch_beam.py peaks the RNN-T model), the joint's logits grow
until the two packages' matmul rounding moves scores and cell states past
the tolerances; encoder frames at 0.5 keep hypotheses apart beyond f32
rounding (at 3.0, as tests/test_tdt.py draws them, two can tie within an
ulp)."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from nemotron_tpu import params as jparams
from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models import decoder as jdec
from nemotron_tpu.models import tdt as jtdt
from nemotron_tpu.models.lm import lm_params_from_arrays as jlm_from_arrays
from nemotron_tpu.models.lm import random_lm_arrays
from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock
from nemotron_tpu.streaming.serving import ServingEngine as JEngine
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu_torch import gguf as tgguf
from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import beam as tbeam
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.models import tdt as ttdt
from nemotron_tpu_torch.models.lm import lm_params_from_arrays
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine as TLock
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.streaming.session import StreamSession as TSession

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scores: 1e-5 plus 1e-6 of the score (tests/test_torch_beam.py); h/c and
# the LM state: the LSTM's tolerance; confidences 1e-5
SCORE_ATOL, SCORE_RTOL = 1e-5, 1e-6
STATE_ATOL = 5e-5
CONF_ATOL = 1e-5
F32 = torch.float32
CC_KW = dict(att_right_context=1, att_left_context=12)
BEAM_FIELDS = ("tokens", "lengths", "t", "sym", "prev_token")


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


def peaked(arrays: dict) -> dict:
    return {k: v * np.float32(5.0 if k.startswith("decoder.") else 3.0)
            if k.startswith(("decoder.", "joint.")) else v
            for k, v in arrays.items()}


def synth(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 8000).astype(
        np.int16)


@pytest.fixture(scope="module")
def tdt():
    """(JAX params, port params, config, vocab) of the peaked tiny TDT
    model with a CTC head."""
    cfg = dataclasses.replace(tiny_config(), tdt_durations=(0, 1, 2, 3))
    arrays = peaked(jparams.random_weight_arrays(cfg, seed=3, ctc_head=True))
    jp = jparams.params_from_arrays(arrays, cfg)
    tp = tparams.params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg, [f"w{i}" for i in range(cfg.vocab_size)]


@pytest.fixture(scope="module")
def lms(tdt):
    arrays = random_lm_arrays(tdt[2].vocab_size, seed=1)
    return jlm_from_arrays(arrays), lm_params_from_arrays(arrays, "cpu")


@pytest.fixture(scope="module")
def enc(tdt):
    rng = np.random.default_rng(42)
    return rng.standard_normal((3, 8, tdt[2].d_model)).astype(
        np.float32) * 0.5


def assert_beams_equal(js, ts):
    """tokens, lengths, t, sym and prev_token exact in every slot; scores
    within 1e-5 + 1e-6 |score|; h/c and the LM state within 5e-5."""
    for k in BEAM_FIELDS:
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


# -- the greedy walk ----------------------------------------------------------


@pytest.mark.parametrize("opts", ["plain", "skip_in", "masked",
                                  "confidence"])
def test_tdt_greedy_decode_matches_jax(tdt, enc, opts):
    """tokens, skip_out and prev_token exact, the iteration count equal,
    h/c within 5e-5, confidences within 1e-5."""
    jp, tp, cfg, _ = tdt
    B = enc.shape[0]
    kw = {}
    if opts in ("skip_in", "masked"):
        kw["skip_in"] = np.array([0, 2, 1], np.int32)
    if opts == "masked":
        kw["step_mask"] = np.array([True, True, False])
        kw["enc_lengths"] = np.array([8, 5, 8], np.int32)
    if opts == "confidence":
        kw["enc_lengths"] = np.array([8, 3, 6], np.int32)
    conf = opts == "confidence"
    jst = jdec.init_decoder_state(cfg, batch=B)
    tst = tdec.init_decoder_state(cfg, B, F32, "cpu")
    jo = jtdt.tdt_greedy_decode(jp, cfg, jnp.asarray(enc), jst,
                                with_iters=True, with_confidence=conf,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    to = ttdt.tdt_greedy_decode(tp, cfg, torch.from_numpy(enc), tst,
                                with_iters=True, with_confidence=conf,
                                **{k: torch.from_numpy(v)
                                   for k, v in kw.items()})
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    if conf:
        np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]),
                                   atol=CONF_ATOL, rtol=0)
    jstate, jskip, jit = jo[-3:]
    tstate, tskip, tit = to[-3:]
    np.testing.assert_array_equal(tskip.numpy(), np.asarray(jskip))
    assert tit == int(jit) > 1
    np.testing.assert_array_equal(tstate.prev_token.numpy(),
                                  np.asarray(jstate.prev_token))
    for a, b in ((tstate.h, jstate.h), (tstate.c, jstate.c)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=STATE_ATOL,
                                   rtol=0)
    toks = to[0].numpy()
    assert (toks != cfg.blank_token).sum() > 3
    if opts == "masked":       # the frozen stream: untouched, skip passed
        assert (toks[2] == cfg.blank_token).all() and int(tskip[2]) == 1
        assert float(tstate.h[2].abs().max()) == 0.0


# -- the beam -----------------------------------------------------------------


@pytest.mark.parametrize("K,use_lm,masked", [
    (1, False, False), (2, False, False), (4, False, False),
    (2, True, False), (4, True, True), (4, False, True)])
def test_tdt_beam_decode_matches_jax(tdt, lms, enc, K, use_lm, masked):
    """Every TdtBeamState leaf of every slot after two chunks (the second
    with a step mask in the masked cases: the frozen stream keeps its
    whole beam)."""
    jp, tp, cfg, _ = tdt
    jlm, tlm = lms if use_lm else (None, None)
    B, U = enc.shape[0], 48
    js = jtdt.init_tdt_beam_state(cfg, B, K, U, lm=jlm)
    ts = ttdt.init_tdt_beam_state(cfg, B, K, U, F32, "cpu", lm=tlm)
    mask = np.array([True, False, True])
    for part, m in ((enc[:, :4], None), (enc[:, 4:], mask if masked
                                         else None)):
        prev = ts
        js = jtdt.tdt_beam_decode(
            jp, cfg, jnp.asarray(part), js, K,
            step_mask=None if m is None else jnp.asarray(m), lm=jlm)
        ts = ttdt.tdt_beam_decode(
            tp, cfg, torch.from_numpy(part), ts, K,
            step_mask=None if m is None else torch.from_numpy(m), lm=tlm)
        assert_beams_equal(js, ts)
    if masked:
        for k, v in tbeam.leaves(ts).items():
            assert torch.equal(v[1], getattr(prev, k)[1]), k
    assert int(ts.lengths.max()) > 0


def test_tdt_beam_constructed_tie_matches_jax(tdt, enc):
    """A joint whose logits are all equal: every (token, duration)
    candidate of a round ties, so the tie rules alone pick the hypotheses,
    their labels, durations and states. The port keeps the JAX package's
    choices in every slot."""
    jp, tp, cfg, vocab = tdt
    jz = dataclasses.replace(jp, joint=dataclasses.replace(
        jp.joint, out_w=jnp.zeros_like(jp.joint.out_w),
        out_b=jnp.zeros_like(jp.joint.out_b)))
    tz = tparams.params_from_jax_arrays(jax_flat(jz), cfg, device="cpu")
    lengths = np.array([8, 5, 2], np.int32)
    for K in (2, 4):
        js = jtdt.tdt_beam_decode(jz, cfg, jnp.asarray(enc),
                                  jtdt.init_tdt_beam_state(cfg, 3, K, 24), K,
                                  enc_lengths=jnp.asarray(lengths))
        ts = ttdt.tdt_beam_decode(tz, cfg, torch.from_numpy(enc),
                                  ttdt.init_tdt_beam_state(cfg, 3, K, 24, F32,
                                                           "cpu"), K,
                                  enc_lengths=torch.from_numpy(lengths))
        assert_beams_equal(js, ts)
        assert int(ts.lengths.max()) > 0
    # ties in the ranking itself, against lax.top_k
    x = np.random.default_rng(0).integers(-2, 2, size=(3, 64)).astype(
        np.float32)
    x[1] = -1e30
    vals, idx = tbeam._rank(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_tdt_beam_chunked_one_shot_and_k1_greedy(tdt, enc):
    """Port only: chunked decoding with the carried state equals one-shot
    decoding exactly (the chunk boundary is one more frame barrier), and
    K = 1 is the greedy walk (tokens and the overshoot carry), as
    tests/test_tdt.py gates the JAX package."""
    _, tp, cfg, _ = tdt
    x = torch.from_numpy(enc)
    one = ttdt.tdt_beam_decode(tp, cfg, x, ttdt.init_tdt_beam_state(
        cfg, 3, 4, 64, F32, "cpu"), 4)
    st = ttdt.init_tdt_beam_state(cfg, 3, 4, 64, F32, "cpu")
    for a, b in ((0, 3), (3, 5), (5, 8)):
        st = ttdt.tdt_beam_decode(tp, cfg, x[:, a:b], st, 4)
    for k in BEAM_FIELDS:
        assert torch.equal(getattr(st, k), getattr(one, k)), k
    np.testing.assert_allclose(st.scores.numpy(), one.scores.numpy(),
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)
    toks, _, skip = ttdt.tdt_greedy_decode(
        tp, cfg, x, tdec.init_decoder_state(cfg, 3, F32, "cpu"))
    greedy = [[t for t, _ in row] for row in
              tdec.tokens_to_list(toks.numpy(), cfg.blank_token)]
    b1 = ttdt.tdt_beam_decode(tp, cfg, x, ttdt.init_tdt_beam_state(
        cfg, 3, 1, 64, F32, "cpu"), 1)
    btok, blen, _ = tbeam.best_hypothesis(b1)
    assert [btok[b, :int(blen[b])].tolist() for b in range(3)] == greedy
    assert torch.equal(b1.t[:, 0], skip) and any(greedy)


# -- GGUF and params ----------------------------------------------------------


def write_port_gguf(path, arrays, cfg, vocab):
    """A GGUF written with the port's writer as the JAX package's
    save_model writes one: conv weights in the converter's layouts,
    nemo.tdt_durations, the ctc_decoder.* tensors as they are."""
    conv = {}
    for name, a in arrays.items():
        if name.endswith(".conv.depthwise_conv.weight") and a.ndim == 3:
            a = a.squeeze(1).T
        elif name.endswith((".conv.pointwise_conv1.weight",
                            ".conv.pointwise_conv2.weight")) and a.ndim == 3:
            a = a.squeeze(2)
        conv[name] = a
    meta = {"general.architecture": "nemo",
            "tokenizer.vocab": tgguf.encode_vocab(vocab),
            "nemo.n_mels": cfg.n_mels, "nemo.d_model": cfg.d_model,
            "nemo.n_heads": cfg.n_heads, "nemo.d_head": cfg.d_head,
            "nemo.d_ff": cfg.d_ff, "nemo.n_layers": cfg.n_layers,
            "nemo.kernel_size": cfg.kernel_size,
            "nemo.vocab_size": cfg.vocab_size}
    if cfg.tdt_durations:
        meta["nemo.tdt_durations"] = [int(d) for d in cfg.tdt_durations]
    tgguf.write_gguf(path, meta, conv)


def test_tdt_gguf_round_trips_both_ways(tdt, tmp_path):
    """random_weight_arrays draws JAX's numbers for a TDT config with a
    CTC head; the port reads the file JAX's save_model wrote (TDT
    durations, the [J, V + D] joint, the CTC head), and JAX's load_model
    reads the file the port wrote with gguf.write_gguf; both decode
    alike."""
    jp, tp, cfg, vocab = tdt
    ja = jparams.random_weight_arrays(cfg, seed=5, ctc_head=True)
    ta = tparams.random_weight_arrays(cfg, seed=5, ctc_head=True)
    assert list(ta) == list(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jparams.save_model(jpath, jp, cfg, vocab=vocab)
    write_port_gguf(tpath, tparams.random_weight_arrays(cfg, seed=3,
                                                        ctc_head=True),
                    cfg, vocab)
    tp2, tcfg, tvocab = tparams.load_model(jpath, device="cpu")
    jp2, jcfg, _ = jparams.load_model(tpath)
    assert tcfg.tdt_durations == jcfg.tdt_durations == cfg.tdt_durations
    assert tcfg.vocab_size == cfg.vocab_size and tvocab == vocab
    assert tuple(tp2.joint.out_w.shape) == (cfg.joint_dim,
                                            cfg.vocab_size + 4)
    got = tparams.flatten(tp2)
    want = jax_flat(jp)
    assert set(got) == set(want) and "ctc.out_w" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the port's file (unpeaked weights) read by JAX and by the port
    tp3, _, _ = tparams.load_model(tpath, device="cpu")
    want = jax_flat(jp2)
    for k, v in tparams.flatten(tp3).items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    x = np.random.default_rng(1).standard_normal((2, 6, cfg.d_model)).astype(
        np.float32) * 0.5
    a = jtdt.tdt_greedy_decode(jp2, jcfg, jnp.asarray(x),
                               jdec.init_decoder_state(jcfg, batch=2))[0]
    b = ttdt.tdt_greedy_decode(tp3, tcfg, torch.from_numpy(x),
                               tdec.init_decoder_state(tcfg, 2, F32,
                                                       "cpu"))[0]
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# -- the session --------------------------------------------------------------


def sessions(tdt, lms, mode):
    jp, tp, cfg, vocab = tdt
    kw = {"greedy": {}, "confidence": {"confidence_words": True},
          "beam": {"beam_size": 4, "max_beam_tokens": 64},
          "beam_lm": {"beam_size": 3, "max_beam_tokens": 64}}[mode]
    jkw, tkw = dict(kw), dict(kw)
    if mode == "beam_lm":
        jkw["lm"], tkw["lm"] = lms
    cc = dict(CC_KW, n_mels=cfg.n_mels)

    def make():
        return (JSession(jp, cfg, vocab, JCC(**cc), **jkw),
                TSession(tp, cfg, vocab, TCC(**cc), **tkw))
    return make


def assert_tokens_equal(got, want, conf: bool):
    if not conf:
        assert got == want
        return
    assert [t[:2] for t in got] == [t[:2] for t in want]
    np.testing.assert_allclose([t[2] for t in got], [t[2] for t in want],
                               atol=CONF_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["greedy", "confidence", "beam", "beam_lm"])
def test_session_tdt_matches_jax(tdt, lms, mode, tmp_path):
    """The text after every feed, the tokens with their frames (and
    confidences), and snapshots taken mid-stream that each package resumes
    from the other's (tdt_skip, beam/t and beam/sym included)."""
    make = sessions(tdt, lms, mode)
    conf = mode == "confidence"
    pcm = synth(16000, 3)
    js, ts = make()
    for i in range(0, 8000, 2000):
        assert ts.process(pcm[i:i + 2000]) == js.process(pcm[i:i + 2000])
        assert ts.get_transcript() == js.get_transcript()
    assert ts.tdt and ts.get_transcript()
    if ts.beam_state is not None:
        assert_beams_equal(js.beam_state, ts.beam_state)
    else:
        np.testing.assert_array_equal(ts.tdt_skip.numpy(),
                                      np.asarray(js.tdt_skip))
    js.save(str(tmp_path / "j.npz"))
    ts.save(str(tmp_path / "t.npz"))
    z = np.load(str(tmp_path / "t.npz"), allow_pickle=True)
    assert "tdt_skip" in z.files
    assert ("beam/t" in z.files) == (ts.beam_state is not None)
    jr, tr = make()
    jr.load(str(tmp_path / "t.npz"))
    tr.load(str(tmp_path / "j.npz"))
    for a, b in ((js, tr), (jr, ts)):
        a.process(pcm[8000:])
        b.process(pcm[8000:])
        assert b.finalize() == a.finalize()
        assert_tokens_equal(b.get_tokens(0), a.get_tokens(0), conf)


def test_session_tdt_refusals_match_jax(tdt, tmp_path):
    """TDT with tracing and with confidence in a beam raise the JAX
    package's ValueErrors; snapshots of another decode mode are refused
    both ways (greedy TDT against RNN-T, a TDT beam against an RNN-T
    beam)."""
    jp, tp, cfg, vocab = tdt
    rnnt = dataclasses.replace(cfg, tdt_durations=None)
    for kw in ({"trace_dir": "x"}, {"beam_size": 2, "confidence": True}):
        with pytest.raises(ValueError) as want:
            JSession(jp, cfg, vocab, **kw)
        with pytest.raises(ValueError,
                               match=re.escape(str(want.value)[:25])):
            TSession(tp, cfg, vocab, **kw)
    paths = {}
    for name, c, kw in (("tdt", cfg, {}), ("rnnt", rnnt, {}),
                        ("tdt_beam", cfg, {"beam_size": 2}),
                        ("rnnt_beam", rnnt, {"beam_size": 2})):
        paths[name] = str(tmp_path / f"{name}.npz")
        TSession(tp, c, vocab, max_beam_tokens=8, **kw).save(paths[name])
    for c, kw, path, match in (
            (rnnt, {}, "tdt", "TDT skip state"),
            (cfg, {}, "rnnt", "no tdt_skip"),
            (rnnt, {"beam_size": 2}, "tdt_beam", "TDT skip state"),
            (cfg, {"beam_size": 2}, "rnnt_beam", "no tdt_skip")):
        with pytest.raises(ValueError, match=match):
            TSession(tp, c, vocab, max_beam_tokens=8, **kw).load(paths[path])
    st = np.load(paths["tdt_beam"], allow_pickle=True)
    flat = {k: st[k] for k in st.files}
    flat.pop("beam/t")
    np.savez(str(tmp_path / "mixed.npz"), **flat)
    with pytest.raises(ValueError, match="beam-family mismatch"):
        TSession(tp, cfg, vocab, beam_size=2, max_beam_tokens=8).load(
            str(tmp_path / "mixed.npz"))


# -- the engines --------------------------------------------------------------


def feed_ragged(eng, slots, audio, step: int):
    """Slot i is fed at 1 / (i + 1) of the others' rate."""
    for t in range(0, audio.shape[1], step):
        eng.feed_audio({s: audio[i, t // (i + 1):t // (i + 1) + step
                                 // (i + 1)] for i, s in enumerate(slots)})
        eng.step()


ENGINE_MODES = {"greedy": {"confidence": True},
                "beam_lm": {"beam_size": 3, "max_beam_tokens": 48}}


@pytest.mark.parametrize("mode", ["greedy", "beam_lm"])
@pytest.mark.parametrize("dsp", ["numpy", "device"])
def test_serving_engine_tdt_matches_jax(tdt, lms, dsp, mode, tmp_path):
    """Three slots at ragged rates: the (refreshed) transcripts, the jump
    carries or the whole beam slab equal the JAX engine's; each package
    resumes the other's snapshot; finalize gives the JAX texts (host DSP;
    the port's device-DSP finalize also decodes a partial last quantum, so
    there the resumed engines are held to each other)."""
    jp, tp, cfg, vocab = tdt
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(n_slots=4, dsp=dsp, **ENGINE_MODES[mode])
    jkw, tkw = dict(kw), dict(kw)
    if mode == "beam_lm":
        jkw["lm"], tkw["lm"] = lms

    def make():
        return (JEngine(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
                        **jkw),
                TEngine(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **tkw))

    je, te = make()
    assert te.tdt and not te.ctc
    audio = np.stack([synth(12000, 10 + i) for i in range(3)])
    js, ts = je.add_streams(3), te.add_streams(3)
    assert js == ts
    feed_ragged(je, js, audio[:, :6000], 1200)
    feed_ragged(te, ts, audio[:, :6000], 1200)
    assert te.refresh_transcripts() == je.refresh_transcripts()
    assert any(te.transcripts)
    if mode == "greedy":
        np.testing.assert_array_equal(te.tdt_skip.numpy(),
                                      np.asarray(je.tdt_skip))
        for s in ts:
            assert_tokens_equal(te.tokens[s], je.tokens[s], True)
    else:
        assert_beams_equal(je.beam_state, te.beam_state)
    je.save(str(tmp_path / "j.npz"))
    te.save(str(tmp_path / "t.npz"))
    je2, te2 = make()
    te2.load(str(tmp_path / "j.npz"))
    je2.load(str(tmp_path / "t.npz"))
    outs = []
    for eng in (je, te, je2, te2):
        feed_ragged(eng, ts, audio[:, 6000:], 1200)
        outs.append([eng.finalize_stream(s) for s in ts])
    if dsp == "numpy":
        assert outs[1] == outs[0] == outs[2] == outs[3]
    else:
        assert outs[3] == outs[1]
    assert any(outs[1])


@pytest.mark.parametrize("mode", ["greedy", "beam_lm"])
def test_lockstep_tdt_matches_jax(tdt, lms, mode, tmp_path):
    """Three streams, pipelined ticks: the text of every tick (greedy), the
    refreshed transcripts and the jump carries or beam slab equal the JAX
    engine's; the snapshots interchange and finalize gives the JAX
    texts."""
    jp, tp, cfg, vocab = tdt
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    kw = dict(n_streams=3, **ENGINE_MODES[mode])
    jkw, tkw = dict(kw), dict(kw)
    if mode == "beam_lm":
        jkw["lm"], tkw["lm"] = lms

    def make():
        return (JLock(jp, cfg, vocab, JCC(**cc), compute_dtype=jnp.float32,
                      **jkw),
                TLock(tp, cfg, vocab, TCC(**cc), compute_dtype=F32, **tkw))

    je, te = make()
    audio = np.stack([synth(9600, 30 + i) for i in range(3)])
    q = TCC(**cc).shift_samples
    for i in range(0, 4800, q):
        got = te.tick_pipelined(audio[:, i:i + q])
        want = je.tick_pipelined(audio[:, i:i + q])
        assert got == want
    te.flush_pipeline()
    je.flush_pipeline()
    assert te.refresh_transcripts() == je.refresh_transcripts()
    if mode == "greedy":
        np.testing.assert_array_equal(te.tdt_skip.numpy(),
                                      np.asarray(je.tdt_skip))
    else:
        assert_beams_equal(je.beam_state, te.beam_state)
    je.save(str(tmp_path / "j.npz"))
    te.save(str(tmp_path / "t.npz"))
    je2, te2 = make()
    te2.load(str(tmp_path / "j.npz"))
    je2.load(str(tmp_path / "t.npz"))
    outs = []
    for eng in (je, te, je2, te2):
        for i in range(4800, audio.shape[1], q):
            eng.tick(audio[:, i:i + q])
        outs.append(eng.finalize())
    assert outs[1] == outs[0] == outs[2] == outs[3]
    assert any(outs[1])


def test_engine_tdt_snapshot_refusals(tdt, tmp_path):
    """An RNN-T engine refuses a TDT snapshot and a TDT engine an RNN-T
    one (the JAX engines' TDT-mode check), in both engines."""
    _, tp, cfg, vocab = tdt
    rnnt = dataclasses.replace(cfg, tdt_durations=None)
    for T, kw in ((TEngine, {"n_slots": 2, "dsp": "numpy"}),
                  (TLock, {"n_streams": 2})):
        paths = []
        for c in (cfg, rnnt):
            paths.append(str(tmp_path / f"{T.__name__}{len(paths)}.npz"))
            T(tp, c, vocab, compute_dtype=F32, **kw).save(paths[-1])
        for c, path in ((rnnt, paths[0]), (cfg, paths[1])):
            with pytest.raises(ValueError, match="TDT-mode mismatch"):
                T(tp, c, vocab, compute_dtype=F32, **kw).load(path)
