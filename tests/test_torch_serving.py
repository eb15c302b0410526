"""Continuous batching, PyTorch port against the JAX package on the CPU:
the host and device DSP halves, the step-masked encoder (dense, int8 and
shared x-ring) and decoder, ring realignment, and the ragged
ServingEngine in both DSP modes (ragged rates, admission, eviction,
finalize, the fuzz schedules, the W8A8 tier, endpointing), plus the port's
engine against its own solo sessions; and -- on a machine with a card --
the kernels at the engine's shapes and the engine on the card against the
CPU (marked `cuda`; skipped without one).

The JAX imports sit inside fixtures and tests, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_serving.py
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.config import ModelConfig
from nemotron_tpu_torch.frontend import device_frontend as tdf
from nemotron_tpu_torch.frontend.preprocessor import (StreamingPreprocessor,
                                                      pad_window)
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.models import encoder as tenc
from nemotron_tpu_torch.params import (load_model, params_from_arrays,
                                       params_from_jax_arrays,
                                       quantize_model_params,
                                       random_weight_arrays)
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.streaming.session import StreamSession as TSession
from nemotron_tpu_torch.utils import tones as ttones
from nemotron_tpu_torch.utils.text import edit_distance

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
SIL_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_sil.gguf")
# the JAX package's tolerances (ROADMAP north star): log-mel 2e-4, encoder
# outputs and caches 5e-5, decoder state 1e-7 (one f32 ulp of the LSTM's
# summation order, tests/test_torch_streaming.py), tokens exact
MEL_ATOL = 2e-4
ENC_ATOL = 5e-5
DEC_ATOL = 1e-7
CC_KW = dict(att_right_context=1, att_left_context=12)
F32 = torch.float32


def synth(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 8000).astype(
        np.int16)


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


def engines(tiny, n_slots, dsp, **kw):
    """A JAX engine and a port engine, f32, over the same model."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.streaming.serving import ServingEngine as JEngine

    jp, tp, cfg, vocab = tiny
    cc = dict(CC_KW, n_mels=cfg.n_mels)
    return (JEngine(jp, cfg, vocab, JCC(**cc), n_slots=n_slots,
                    compute_dtype=jnp.float32, dsp=dsp, **kw),
            TEngine(tp, cfg, vocab, TCC(**cc), n_slots=n_slots,
                    compute_dtype=F32, dsp=dsp, **kw))


def assert_states_close(je, te):
    """Encoder caches within 5e-5 (valid_len and phase exact), decoder
    h/c within 1e-7, prev_token exact."""
    for f in dataclasses.fields(te.enc_state):
        got = getattr(te.enc_state, f.name).float().numpy()
        want = np.asarray(getattr(je.enc_state, f.name)).astype(np.float32)
        atol = 0 if f.name in ("valid_len", "phase") else ENC_ATOL
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=f.name)
    for name, atol in (("h", DEC_ATOL), ("c", DEC_ATOL), ("prev_token", 0)):
        np.testing.assert_allclose(
            getattr(te.dec_state, name).float().numpy(),
            np.asarray(getattr(je.dec_state, name)).astype(np.float32),
            atol=atol, rtol=0, err_msg=name)


def counts(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if k not in ("latency", "compute_seconds", "aggregate_rtf")}


# -- the two DSP halves -------------------------------------------------------


def test_frame_only_and_spectral_match_jax(tiny):
    """Ragged feeds through frame_only (frames bit-equal to JAX's, the
    residue carried) and one spectral pass over two preprocessors' frames
    (log-mel within 2e-4); process equals spectral(frame_only)."""
    from nemotron_tpu.frontend.preprocessor import (
        StreamingPreprocessor as JPre)

    from nemotron_tpu_torch.config import PreprocessorConfig

    _jp, tp, cfg, _ = tiny
    fb = tp.preprocessor.filterbank.numpy()
    win = tp.preprocessor.window.numpy()
    pcfg = PreprocessorConfig(n_mels=cfg.n_mels)
    jpre = [JPre(fb, win, cfg=pcfg, backend="numpy") for _ in range(2)]
    tpre = [StreamingPreprocessor(fb, win, cfg=pcfg, device="cpu")
            for _ in range(2)]
    whole = StreamingPreprocessor(fb, win, cfg=pcfg, device="cpu")
    for i, n in enumerate((100, 1000, 3333, 160, 4000)):
        audio = [synth(n, 10 * i + s) for s in range(2)]
        jf = [p.frame_only(a[None])[0] for p, a in zip(jpre, audio)]
        tf = [p.frame_only(a[None])[0] for p, a in zip(tpre, audio)]
        for g, w in zip(tf, jf):
            np.testing.assert_array_equal(g, w)
        want_whole = whole.process(audio[0])[0]
        if not tf[0].shape[0]:
            assert want_whole.shape == (0, cfg.n_mels)
            continue
        np.testing.assert_array_equal(tpre[0].spectral(tf[0]), want_whole)
        got = tpre[0].spectral(np.concatenate(tf))
        want = jpre[0].spectral(np.concatenate(jf))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)
    for p, q in zip(tpre, jpre):
        np.testing.assert_array_equal(p.residue, q.residue)


def test_mel_frontend_step_matches_jax(tiny):
    """Chained device-DSP steps (the engine's quantum, then odd sizes):
    log-mel within 2e-4, carries equal; frames_after / residue_after equal
    to JAX's."""
    import jax.numpy as jnp

    from nemotron_tpu.config import PreprocessorConfig as JPC
    from nemotron_tpu.frontend import device_frontend as jdf
    from nemotron_tpu_torch.config import PreprocessorConfig

    _jp, tp, cfg, _ = tiny
    pcfg, jpcfg = PreprocessorConfig(n_mels=cfg.n_mels), JPC(n_mels=cfg.n_mels)
    for r, n in ((256, 640), (0, 100), (300, 4000), (112, 17920)):
        assert tdf.frames_after(r, n, pcfg) == jdf.frames_after(r, n, jpcfg)
        assert tdf.residue_after(r, n, pcfg) == jdf.residue_after(r, n, jpcfg)
    win = pad_window(tp.preprocessor.window.numpy(), pcfg.n_fft)
    fb = tp.preprocessor.filterbank.numpy()
    S = 3
    tst = tdf.init_frontend_state(S, "cpu", pcfg)
    jst = jdf.init_frontend_state(S, jpcfg)
    for i, n in enumerate((640, 640, 100, 2000)):
        pcm = np.stack([synth(n, 50 + 10 * i + s) for s in range(S)])
        got, tst = tdf.mel_frontend_step(torch.from_numpy(pcm), tst,
                                         torch.from_numpy(win),
                                         torch.from_numpy(fb), pcfg)
        want, jst = jdf.mel_frontend_step(jnp.asarray(pcm), jst,
                                          jnp.asarray(win), jnp.asarray(fb),
                                          jpcfg)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MEL_ATOL, rtol=0)
        np.testing.assert_allclose(tst.residue.numpy(),
                                   np.asarray(jst.residue), atol=1e-7)
        np.testing.assert_array_equal(tst.last_sample.numpy(),
                                      np.asarray(jst.last_sample))


# -- the step-masked encoder and decoder, ring realignment --------------------


LAYOUTS = {"dense": {}, "int8": dict(kv_cache_int8=True),
           "shared": dict(shared_cache=True),
           "shared_int8": dict(shared_cache=True, kv_cache_int8=True)}


def snapshot(st) -> dict:
    return {f.name: getattr(st, f.name).clone()
            for f in dataclasses.fields(st)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encode_chunk_step_mask_matches_jax(tiny, layout):
    """Three streams over chunks with a changing step mask, realigned as
    the engine does before a lagging stream advances again; from the second
    chunk on stream 0 is frozen (its phase goes stale: a step that took the
    phase from stream 0 would NaN-poison the others). Advancing streams'
    outputs and caches within 5e-5 of JAX (each chunk from JAX's state, so
    an int8 ring's one-step rounding flip cannot compound); every frozen
    stream's ring bytes, scales, conv cache, valid_len and phase bit-equal
    to what went in."""
    import jax
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.models import encoder as jenc

    jp, tp, cfg, _ = tiny
    kw = dict(CC_KW, n_mels=cfg.n_mels, **LAYOUTS[layout])
    jcc, tcc = JCC(**kw), TCC(**kw)
    B = 3
    jst = jenc.init_encoder_state(cfg, jcc, B)
    jph = jenc.precompute_pos_heads(jp, cfg, jcc)
    tph = tenc.precompute_pos_heads(tp, cfg, tcc)
    step = jax.jit(lambda p, mel, st, ph, m: jenc.encode_chunk(
        p, cfg, jcc, mel, st, ph, step_mask=m))
    rng = np.random.default_rng(7)
    masks = [[1, 1, 1], [0, 1, 1], [0, 1, 0], [0, 1, 1], [0, 0, 1],
             [0, 1, 1], [0, 0, 0], [0, 1, 1]]
    n_seg = jcc.kv_len // jcc.chunk_enc_len
    counter, slot_phase = 0, np.zeros(B, np.int64)
    for ci, m in enumerate(masks):
        m = np.array(m, bool)
        for s in np.flatnonzero(m & (slot_phase != counter)):
            jst = jenc.realign_ring(jst, jnp.int32(s), jnp.int32(
                (counter - slot_phase[s]) % n_seg), jcc.chunk_enc_len)
        counter = (counter + m.any()) % n_seg
        slot_phase[m] = counter
        tst = tenc.EncoderState(**{
            f.name: torch.tensor(np.asarray(getattr(jst, f.name)))
            for f in dataclasses.fields(tenc.EncoderState)})
        before = snapshot(tst)
        mel = rng.standard_normal((B, jcc.chunk_mel_frames,
                                   cfg.n_mels)).astype(np.float32)
        want, jst = step(jp, jnp.asarray(mel), jst, jph, jnp.asarray(m))
        got, tst = tenc.encode_chunk(tp, cfg, tcc, torch.tensor(mel), tst,
                                     tph, step_mask=torch.tensor(m))
        want = np.asarray(want)
        assert np.isfinite(got.numpy()[m]).all(), ci
        np.testing.assert_allclose(got.numpy()[m], want[m], atol=ENC_ATOL,
                                   rtol=0, err_msg=f"chunk {ci}")
        for f in dataclasses.fields(tst):
            g = getattr(tst, f.name)
            w = np.asarray(getattr(jst, f.name))
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == \
                str(w.dtype), f.name
            # the stream axis: dim 1 of the [L, B, ...] leaves, else 0
            ax = 0 if f.name in ("valid_len", "phase") else 1
            sel = [slice(None)] * g.dim()
            sel[ax] = torch.from_numpy(~m)
            assert torch.equal(g[tuple(sel)], before[f.name][tuple(sel)]), \
                (ci, f.name)
            sel[ax] = torch.from_numpy(m)
            g, w = g[tuple(sel)].numpy(), w[tuple(sel)]
            if w.dtype == np.int8:
                step_diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert step_diff.max(initial=0) <= 1, (ci, f.name)
            else:
                np.testing.assert_allclose(
                    g.astype(np.float32), w.astype(np.float32),
                    atol=0 if f.name in ("valid_len", "phase") else ENC_ATOL,
                    rtol=1e-5 if "scale" in f.name else 0,
                    err_msg=f"chunk {ci} {f.name}")


def test_greedy_decode_step_mask_matches_jax(tiny):
    """step_mask alone and with enc_lengths, over chained calls: tokens
    and prev_token exact, h/c within 1e-7; masked streams emit nothing and
    keep their state bit for bit."""
    import jax
    import jax.numpy as jnp

    from nemotron_tpu.models import decoder as jdec

    jp, tp, cfg, _ = tiny
    B, T = 4, 5
    rng = np.random.default_rng(3)
    jst = jdec.init_decoder_state(cfg, B)
    tst = tdec.init_decoder_state(cfg, B, F32, "cpu")
    decode = jax.jit(jdec.greedy_decode, static_argnums=1)
    emitted = 0
    for mask, lengths in (([1, 1, 1, 1], None), ([1, 0, 1, 0], None),
                          ([0, 1, 1, 1], [5, 2, 0, 3]),
                          ([1, 1, 0, 1], [1, 5, 5, 4])):
        mask = np.array(mask, bool)
        enc = (rng.standard_normal((B, T, cfg.d_model)) * 3).astype(
            np.float32)
        jkw = dict(step_mask=jnp.asarray(mask))
        tkw = dict(step_mask=torch.tensor(mask))
        if lengths is not None:
            jkw["enc_lengths"] = jnp.asarray(lengths, jnp.int32)
            tkw["enc_lengths"] = torch.tensor(lengths, dtype=torch.int32)
        before = snapshot(tst)
        want, jst = decode(jp, cfg, jnp.asarray(enc), jst, **jkw)
        got, tst = tdec.greedy_decode(tp, cfg, torch.tensor(enc), tst, **tkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tst.prev_token.numpy(),
                                      np.asarray(jst.prev_token))
        np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h),
                                   atol=DEC_ATOL, rtol=0)
        np.testing.assert_allclose(tst.c.numpy(), np.asarray(jst.c),
                                   atol=DEC_ATOL, rtol=0)
        assert (got.numpy()[~mask] == cfg.blank_token).all()
        for name in ("h", "c", "prev_token"):
            assert torch.equal(getattr(tst, name)[~mask], before[name][~mask])
        emitted += int((got.numpy() != cfg.blank_token).sum())
    assert emitted > 0


@pytest.mark.parametrize("layout", ["dense", "int8", "shared"])
def test_realign_ring_and_rings_match_jax(tiny, layout):
    """realign_ring rolls one slot in place, realign_rings every slot by
    its own delta; both equal the JAX package's exactly."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.models import encoder as jenc

    _jp, _tp, cfg, _ = tiny
    kw = dict(CC_KW, n_mels=cfg.n_mels, **LAYOUTS[layout])
    tcc = TCC(**kw)
    B, Q = 4, tcc.chunk_enc_len
    n_seg = tcc.kv_len // Q
    rng = np.random.default_rng(9)
    tst = tenc.init_encoder_state(cfg, tcc, B, F32, "cpu")
    for f in dataclasses.fields(tst):
        leaf = getattr(tst, f.name)
        if f.name == "phase":
            leaf.copy_(torch.from_numpy(rng.integers(0, n_seg, B)))
        elif leaf.dtype == torch.int8:
            leaf.copy_(torch.from_numpy(rng.integers(-127, 128, leaf.shape)))
        elif leaf.is_floating_point():
            leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape)))
    jst = jenc.EncoderState(**{k: jnp.asarray(v.numpy())
                               for k, v in snapshot(tst).items()})

    def check(got, want):
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)),
                                          f.name)

    deltas = np.array([0, 1, n_seg - 1, n_seg + 2])
    check(tenc.realign_rings(tst, torch.from_numpy(deltas), Q),
          jenc.realign_rings(jst, jnp.asarray(deltas), Q))
    for slot, delta in ((1, 2), (3, n_seg + 1), (0, 0)):
        jst = jenc.realign_ring(jst, jnp.int32(slot), jnp.int32(delta), Q)
        assert tenc.realign_ring(tst, slot, delta, Q) is tst
        check(tst, jst)


# -- the engine against the JAX engine ---------------------------------------


@pytest.mark.parametrize("dsp", ["numpy", "device"])
def test_engine_matches_jax_engine(tiny, dsp):
    """Ragged rates (full, half, a late admission fed partial quanta), bulk
    admission, an evicted slot reused, finalize: every tick's new text,
    the stats counters and the device state equal JAX's, and so do the
    finals -- except that with device DSP the JAX engine drops a partial
    quantum left at finalize, which the port decodes (JAX's finals are then
    a prefix of the port's; see the test below)."""
    je, te = engines(tiny, 4, dsp)
    n = te.cc.shift_samples
    assert je.add_streams(2) == te.add_streams(2) == [0, 1]
    late = None
    for tick in range(9):
        feed = {0: synth(n, tick)}
        if tick % 2 == 0:
            feed[1] = synth(n, 100 + tick)
        if tick == 3:
            late = je.add_stream()
            assert te.add_stream() == late == 2
        if tick >= 3:
            feed[late] = synth(n // 2 + 37 * tick, 200 + tick)
        if tick == 5:
            assert je.remove_stream(1) == te.remove_stream(1)
            assert je.add_stream() == te.add_stream() == 1
        if tick >= 5:
            feed[1] = synth(n, 300 + tick)
        assert je.feed_audio(feed) is te.feed_audio(feed) is None
        assert te.step() == je.step(), tick
    assert_states_close(je, te)
    assert counts(te.stats()) == counts(je.stats())
    partial = dsp == "device" and te.pcm_fifos[late].count > 0
    finals = [(s, je.finalize_stream(s, return_tokens=True),
               te.finalize_stream(s, return_tokens=True)) for s in (2, 0, 1)]
    for s, want, got in finals:
        assert len(got[1]) > 0, s
        if s == late and partial:
            assert got[0].startswith(want[0]) and len(got[0]) > len(want[0])
            assert got[1][:len(want[1])] == want[1]
        else:
            assert got == want, s
    if not partial:
        assert counts(te.stats()) == counts(je.stats())
    assert te.stats()["active_slots"] == 0
    assert te.dsp_mode == dsp


@pytest.mark.parametrize("R", [1, 13])
def test_device_finalize_decodes_the_partial_quantum(tiny, R):
    """A stream whose audio ends inside a DSP quantum: the port's device
    finalize decodes it all -- its tokens equal a session fed the same
    audio and the engine's silence pad -- where the JAX engine's decodes
    one quantum less (a fault of the reference, ROADMAP Queue 3); the
    finals of both decode the same audio before that."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.streaming.serving import ServingEngine as JEngine

    jp, tp, cfg, vocab = tiny
    kw = dict(att_right_context=R, att_left_context=12 if R == 1 else 28,
              n_mels=cfg.n_mels)
    cc = TCC(**kw)
    q = cc.shift_samples
    audio = synth(5 * q + q // 3, 77)
    je = JEngine(jp, cfg, vocab, JCC(**kw), n_slots=2,
                 compute_dtype=jnp.float32, dsp="device")
    te = TEngine(tp, cfg, vocab, cc, n_slots=2, compute_dtype=F32,
                 dsp="device")
    finals = []
    for e in (je, te):
        s = e.add_stream()
        e.feed_audio({s: audio[:2 * q + 5]})
        e.step()
        e.feed_audio({s: audio[2 * q + 5:]})
        e.step()
        finals.append(e.finalize_stream(s, return_tokens=True)[1])
    want, got = finals
    sess = TSession(tp, cfg, vocab, cc)
    sess.process(np.concatenate([audio, np.zeros(2 * q - q // 3, np.int16)]))
    assert got == sess.get_tokens(0) and len(got) > 0
    assert sess.frame_offset * cc.subsampling_factor * cc.hop_length \
        >= audio.size
    assert got[:len(want)] == want
    assert te.stats()["audio_seconds_decoded"] > \
        je.stats()["audio_seconds_decoded"]


@pytest.mark.parametrize("seed", [42, 1337])
def test_engine_fuzz_schedule_matches_jax(tiny, seed):
    """The JAX package's random admission / eviction / feed schedule
    (tests/test_serving.py:344-407) through both engines (host DSP for 42,
    device DSP for 1337): every evicted stream's transcript and tokens, and
    each tick's text, equal JAX's."""
    je, te = engines(tiny, 3, "numpy" if seed == 42 else "device")
    rng = np.random.default_rng(seed)
    live: dict[int, int] = {}      # slot -> blocks fed
    finished = 0
    for tick in range(14):
        if rng.random() < 0.4 and len(live) < 3:
            slot = je.add_stream()
            assert te.add_stream() == slot
            live[slot] = 0
        if live and rng.random() < 0.15:
            slot = list(live)[int(rng.integers(len(live)))]
            live.pop(slot)
            assert te.remove_stream(slot, True) == \
                je.remove_stream(slot, True)
            finished += 1
        feed = {}
        for slot in live:
            if rng.random() < 0.8:
                n = int(rng.integers(1, 4)) * 2000
                feed[slot] = (rng.standard_normal(n) * 8000).astype(np.int16)
                live[slot] += 1
        if feed:
            je.feed_audio(feed)
            te.feed_audio(feed)
        assert te.step() == je.step(), tick
    fed = 0
    for slot in list(live):
        fed += live.pop(slot) > 0
        got = te.remove_stream(slot, True)
        assert got == je.remove_stream(slot, True)
    assert finished + fed >= 2
    assert counts(te.stats()) == counts(je.stats())
    assert te.stats()["tokens_emitted"] > 0


def test_engine_matches_solo_session(tiny):
    """A stream served in a busy slab equals the port's own solo
    StreamSession fed the same audio (tests/test_serving.py:55-76), and a
    slow slot resuming after more ticks than the ring has segments still
    does (the realignment wraps)."""
    _jp, tp, cfg, vocab = tiny
    cc = TCC(**CC_KW, n_mels=cfg.n_mels)
    eng = TEngine(tp, cfg, vocab, cc, n_slots=3, compute_dtype=F32,
                  dsp="numpy")
    slots = [eng.add_stream() for _ in range(3)]
    n = cc.shift_samples
    audio = {s: [synth(n, 10 * s + i) for i in range(14)] for s in slots}
    fed = {s: [] for s in slots}
    for tick in range(14):
        feed = {0: audio[0][tick]}
        if tick < 2 or tick >= 11:       # slot 1 sits out 9 ticks
            feed[1] = audio[1][len(fed[1])]
        if tick % 3 == 0:
            feed[2] = audio[2][len(fed[2])]
        for s, a in feed.items():
            fed[s].append(a)
        eng.feed_audio(feed)
        eng.step()
    assert 9 > eng.n_seg
    for s in slots:
        sess = TSession(tp, cfg, vocab, cc)
        for a in fed[s]:
            sess.process(a)
        assert eng.transcripts[s] == sess.get_transcript(0), s
        assert eng.tokens[s] == sess.get_tokens(0), s
        assert len(eng.tokens[s]) > 0


@pytest.fixture(scope="module")
def tones_w8a8():
    from nemotron_tpu.params import load_model as jload_model
    from nemotron_tpu.params import quantize_model_params as jquantize

    jp, jc, jv = jload_model(FIXTURE)
    tp, tc, tv = load_model(FIXTURE, device="cpu")
    return (jquantize(jp, "w8a8"), jc, jv), (quantize_model_params(
        tp, "w8a8"), tc, tv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_w8a8_int8_kv_matches_jax(tones_w8a8, dtype):
    """The W8A8 + int8 K/V tier on the trained tones fixture, ragged (one
    stream at half rate, one admitted late), R = 13, host DSP: f32
    transcripts equal JAX's; bf16 within the JAX package's bf16 bound, an
    edit distance under 5% of the tokens (tests/test_torch_serving_tier.py)."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.streaming.serving import ServingEngine as JEngine

    (jp, jc, jv), (tp, tc, tv) = tones_w8a8
    kw = dict(att_right_context=13, n_mels=jc.n_mels, kv_cache_int8=True)
    je = JEngine(jp, jc, jv, JCC(**kw), n_slots=3,
                 compute_dtype=getattr(jnp, dtype), dsp="numpy")
    te = TEngine(tp, tc, tv, TCC(**kw), n_slots=3,
                 compute_dtype=getattr(torch, dtype), dsp="numpy")
    audio, _ = ttones.make_eval_streams(3, 7.0, 16, seed=5)
    n = te.cc.shift_samples
    for e in (je, te):
        e.add_streams(2)
    pos = [0, 0, 0]
    for tick in range(6):
        feed = {0: audio[0, pos[0]:pos[0] + n]}
        if tick % 2:
            feed[1] = audio[1, pos[1]:pos[1] + n]
        if tick == 2:
            for e in (je, te):
                assert e.add_stream() == 2
        if tick >= 2:
            feed[2] = audio[2, pos[2]:pos[2] + n]
        for s in feed:
            pos[s] += n
        for e in (je, te):
            e.feed_audio(feed)
            e.step()
    assert te.enc_state.k_cache.dtype == torch.int8
    for s in range(3):
        want = je.finalize_stream(s, return_tokens=True)
        got = te.finalize_stream(s, return_tokens=True)
        assert len(want[1]) > 5, s
        if dtype == "float32":
            assert got == want, s
        else:
            ids = [[t for t, _ in x[1]] for x in (got, want)]
            assert edit_distance(*ids) < 0.05 * len(ids[1]), (s, ids)


# -- endpointing --------------------------------------------------------------


def test_endpoint_state_machine_matches_jax(tiny):
    """The JAX package's endpoint script (tests/test_serving.py:1295-1361)
    through both engines with endpoint_reset and keep_segment_audio: the
    same events (segments included), decoder resets and counters."""
    je, te = engines(tiny, 2, "numpy", endpoint_silence_s=0.8,
                     endpoint_reset=True, keep_segment_audio=True)
    assert te._ep_frames == je._ep_frames == 10
    for e in (je, te):
        e.add_streams(2)
    pcm = synth(50000, 1)
    events = []
    for e, dec_state in ((je, None), (te, tdec.DecoderState)):
        s = 0
        e.feed_audio({s: pcm})   # host DSP: mel buffered, no step taken
        if dec_state is None:
            import jax.numpy as jnp

            from nemotron_tpu.models import decoder as jdec

            e.dec_state = jdec.DecoderState(
                h=jnp.ones_like(e.dec_state.h),
                c=jnp.ones_like(e.dec_state.c),
                prev_token=jnp.full_like(e.dec_state.prev_token, 3))
        else:
            e.dec_state = dec_state(
                h=torch.ones_like(e.dec_state.h),
                c=torch.ones_like(e.dec_state.c),
                prev_token=torch.full_like(e.dec_state.prev_token, 3))
        out = []
        e.frame_offsets[s] = 14
        e._ep_update({}, np.array([s]), 14)
        out.append(e.poll_endpoints(with_audio=True))
        e.tokens[s] = [(7, 2), (9, 5)]
        e._ep_update({s: [(7, 2), (9, 5)]}, np.array([s]), 14)
        out.append(e.poll_endpoints(with_audio=True))
        e.frame_offsets[s] += 14
        e._ep_update({}, np.array([s]), 14)
        out.append(e.poll_endpoints(with_audio=True))
        out.append((np.asarray(e.dec_state.h).tolist(),
                    np.asarray(e.dec_state.prev_token).tolist()))
        e.tokens[s].append((3, 38))
        e.frame_offsets[s] += 14
        e._ep_update({s: [(3, 38)]}, np.array([s]), 14)
        e.tokens[s].append((4, 50))        # lands before the poll
        e.frame_offsets[s] += 28
        e._ep_update({}, np.array([s]), 28)
        out.append(e.poll_endpoints(with_audio=True))
        out.append(e.stats()["utterances_finalized"])
        e.ep_emitted[s] = True
        e._ep_pending.append((s, len(e.tokens[s]), None))
        e.remove_stream(s)
        out.append((e.poll_endpoints(), bool(e.ep_emitted[s]),
                    int(e.ep_silence[s])))
        events.append(out)
    got, want = events[1], events[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, list) and g and isinstance(g[0], tuple):
            assert [x[:3] for x in g] == [x[:3] for x in w]
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x[3], y[3])
        else:
            assert g == w
    assert len(got[2]) == 1 and got[2][0][2] == [(7, 2), (9, 5)]
    assert got[2][0][3].size == 28 * te._seg_spf
    assert got[3][1] == [tiny[2].blank_token, 3]
    assert got[5] == 2
    with pytest.raises(ValueError, match="keep_segment_audio"):
        engines(tiny, 1, "numpy")[1].poll_endpoints(with_audio=True)


def labels_of(ids, vocab):
    return [int(vocab[i].replace("▁T", "")) for i in ids]


def test_endpointing_trained_fixture_matches_jax():
    """tests/test_serving.py:1363-1423 through the port's engine on the
    CPU: two utterances, each followed by 3 s of silence, give two
    endpoint events, each within Levenshtein 1 of its labels; the events
    equal the JAX engine's."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.params import load_model as jload_model
    from nemotron_tpu.streaming.serving import ServingEngine as JEngine

    truth1, truth2 = [3, 11, 6, 0, 14, 9], [8, 2, 15]
    audio = endpoint_audio(truth1, truth2)
    events = {}
    for name in ("jax", "torch"):
        if name == "jax":
            params, cfg, vocab = jload_model(SIL_FIXTURE, keep_quantized=False)
            eng = JEngine(params, cfg, vocab, JCC(att_right_context=13,
                                                  n_mels=cfg.n_mels),
                          n_slots=2, compute_dtype=jnp.float32, dsp="numpy",
                          endpoint_silence_s=1.0, endpoint_reset=True)
        else:
            eng = endpoint_engine("cpu")
        events[name] = run_endpointing(eng, audio)
    assert events["torch"] == events["jax"]
    check_endpoint_events(events["torch"], eng, truth1, truth2)


def endpoint_audio(truth1, truth2):
    rng = np.random.default_rng(7)

    def utt(labels, tail_s):
        n = (int(0.30 * len(labels) * ttones.SAMPLE_RATE)
             + int(tail_s * ttones.SAMPLE_RATE))
        return ttones.render_tones(np.asarray(labels),
                                   np.full(len(labels), 0.25), rng, 16, n,
                                   gaps=np.full(len(labels), 0.05))

    return np.concatenate([utt(truth1, 3.0), utt(truth2, 3.0)])


def endpoint_engine(device):
    params, cfg, vocab = load_model(SIL_FIXTURE, device=device)
    return TEngine(params, cfg, vocab, TCC(att_right_context=13,
                                           n_mels=cfg.n_mels),
                   n_slots=2, compute_dtype=F32, dsp="numpy",
                   endpoint_silence_s=1.0, endpoint_reset=True)


def run_endpointing(eng, audio):
    s = eng.add_stream()
    n = eng.cc.shift_samples
    events = []
    for t in range(len(audio) // n):
        eng.feed_audio({s: audio[t * n:(t + 1) * n]})
        eng.step()
        events.extend(eng.poll_endpoints())
    return events


def check_endpoint_events(events, eng, truth1, truth2):
    assert len(events) == 2, events
    for (_s, _text, toks), truth in zip(events, (truth1, truth2)):
        got = labels_of([t for t, _ in toks], eng.vocab)
        assert edit_distance(got, truth) <= 1, (got, truth)
    assert eng.stats()["utterances_finalized"] == 2


# -- options -------------------------------------------------------------------


def test_engine_refuses_later_slices_and_resolves_auto(tiny, tmp_path):
    _jp, tp, cfg, vocab = tiny
    cc = TCC(**CC_KW, n_mels=cfg.n_mels)
    # the native-bindings slice is ported (tests/test_torch_native.py):
    # dsp="native" builds one C++ frontend over every slot
    native = TEngine(tp, cfg, vocab, cc, n_slots=2, compute_dtype=F32,
                     dsp="native")
    assert native.dsp_mode == "native" and native.native_fe.n_streams == 2
    assert not native.preprocs
    # the multi-GPU slice is ported (tests/test_torch_mesh.py): a one-rank
    # mesh builds an engine over every slot, a beam one too (its rows of
    # the beam state; tests/test_torch_mesh_beam.py)
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    assert TEngine(tp, cfg, vocab, cc, n_slots=2, compute_dtype=F32,
                   mesh=mesh, beam_size=4).beam_state.scores.shape == (2, 4)
    assert TEngine(tp, cfg, vocab, cc, n_slots=2, compute_dtype=F32,
                   mesh=mesh).enc_state.k_cache.shape[1] == 2
    # the TDT/CTC slice is ported (tests/test_torch_tdt.py,
    # tests/test_torch_ctc.py): ctc=True without a CTC head raises the JAX
    # package's ValueError, and a TDT config builds a TDT engine
    with pytest.raises(ValueError, match="needs a model with a CTC head"):
        TEngine(tp, cfg, vocab, cc, n_slots=2, compute_dtype=F32, ctc=True)
    # the beam family is ported (tests/test_torch_beam.py): an LM without
    # a beam and a beam with confidence raise the JAX package's ValueErrors
    for kw, match in (({"lm": object()}, "LM shallow fusion requires"),
                      ({"beam_size": 4, "confidence": True},
                       "confidence requires greedy")):
        with pytest.raises(ValueError, match=match):
            TEngine(tp, cfg, vocab, cc, n_slots=2, compute_dtype=F32, **kw)
    assert TEngine(tp, cfg, vocab, cc, n_slots=2, compute_dtype=F32,
                   beam_size=4).beam_state.scores.shape == (2, 4)
    tdt = TEngine(tp, dataclasses.replace(cfg, tdt_durations=(0, 1, 2)),
                  vocab, cc, n_slots=2)
    assert tdt.tdt and not tdt.ctc and tdt.tdt_skip.shape == (2,)
    with pytest.raises(ValueError, match="endpointing"):
        TEngine(tp, cfg, vocab, cc, n_slots=2, keep_segment_audio=True)
    with pytest.raises(ValueError, match="dsp"):
        TEngine(tp, cfg, vocab, cc, n_slots=2, dsp="scipy")
    # "auto" resolves as the JAX engine's: on CPU params the native
    # frontend, which builds here
    eng = TEngine(tp, cfg, vocab, cc, n_slots=2)
    assert eng.dsp_mode == "native" and eng.dtype == torch.bfloat16
    defaults = inspect.signature(TEngine).parameters
    assert defaults["n_slots"].default == 64
    assert defaults["compute_dtype"].default == torch.bfloat16
    # snapshots are ported (tests/test_torch_snapshots.py): a round trip
    path = str(tmp_path / "x.npz")
    eng.save(path)
    eng.load(path)
    assert not eng.active.any()
    assert eng.stats()["aggregate_rtf"] == 0.0 and \
        eng.latency_percentiles() == {}


# -- on the card ---------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8", [("float32", False), ("bfloat16", True)])
@pytest.mark.parametrize("B", [64, 256])
def test_ring_attention_at_engine_slots_on_card(cuda_device, B, dtype, int8):
    """The attention kernel over every slot of a 64- and 256-slot engine
    (R = 13, full width): one launch, within the kernel tests' bounds."""
    from nemotron_tpu_torch.ops.ring_attn_kernel import (fused_ring_attention,
                                                         ring_attention_ref)

    cc = TCC(att_right_context=13)
    Q, KV, L, H, Dh = cc.chunk_enc_len, cc.kv_len, 2, 8, 128
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(B)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    if int8:
        rings = [torch.randint(-127, 128, (L, B, H, KV, Dh), device="cuda",
                               generator=g, dtype=torch.int8)
                 for _ in range(2)]
        cols = [torch.rand(B, H, KV, device="cuda", generator=g) * 0.02
                for _ in range(2)]
    else:
        rings = [rn(L, B, H, KV, Dh) for _ in range(2)]
        cols = [torch.ones(B, H, KV, device="cuda") for _ in range(2)]
    args = (rn(B, H, Q, Dh).to(dt), rn(B, H, Q, Dh).to(dt),
            rn(B, H, Q, Dh).to(dt), *rings, rn(B, H, Q, KV + Q).to(dt), *cols)
    before = fused_ring_attention.launches
    got = fused_ring_attention(1, *args)
    want = ring_attention_ref(1, *args)
    torch.cuda.synchronize()
    assert fused_ring_attention.launches == before + 1
    scale = max(want.float().abs().max().item(), 1.0)
    atol = 1e-5 if dt == F32 else 2.0 ** -6 * scale
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(1024, 1024), (1024, 4096), (4096, 1024),
                                 (1024, 2048)])
@pytest.mark.parametrize("kernel", ["q8", "w8a8"])
def test_matmuls_at_engine_rows_on_card(cuda_device, kernel, K, N):
    """Q8 (f32) and W8A8 (bf16) at M = 64 slots x 14 frames = 896 rows,
    the engine's R = 13 step: Q8 within 4e-6 of max|out|, W8A8 bit for
    bit."""
    from nemotron_tpu_torch.ops.quant import (quantize_tensor,
                                              quantize_tensor_w8a8)
    from nemotron_tpu_torch.ops.quant_kernel import q8_matmul, q8_matmul_ref
    from nemotron_tpu_torch.ops.w8a8_kernel import (w8a8_matmul,
                                                    w8a8_matmul_ref)

    M = 896
    rng = np.random.default_rng(K + N)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = torch.tensor(rng.standard_normal((M, K)).astype(np.float32)
                     * rng.uniform(0.1, 3, (M, 1)).astype(np.float32),
                     device=cuda_device)
    if kernel == "q8":
        qt = quantize_tensor(w)
        fn, ref = q8_matmul, q8_matmul_ref
        wq = (torch.tensor(qt.q, device=cuda_device),
              torch.tensor(qt.scale, device=cuda_device))
    else:
        qt = quantize_tensor_w8a8(w)
        fn, ref = w8a8_matmul, w8a8_matmul_ref
        wq = (torch.tensor(qt.q, device=cuda_device),
              torch.tensor(qt.col_scale, device=cuda_device))
        x = x.to(torch.bfloat16)
    before = fn.launches
    got = fn(x, *wq)
    want = ref(x, *wq)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.shape == (M, N)
    tol = 4e-6 * want.abs().max().item() if kernel == "q8" else 0
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def tiny_port_model(device):
    """The JAX tests' tiny config with the port's seeded random weights."""
    cfg = ModelConfig(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                      n_layers=3, kernel_size=9, vocab_size=41,
                      decoder_dim=48, joint_dim=56, subsampling_channels=16)
    arrays = random_weight_arrays(cfg, seed=0)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    return params_from_arrays(arrays, cfg, device), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("dsp", ["numpy", "device"])
@pytest.mark.parametrize("model", ["tiny", "tones"])
def test_engine_on_card_equals_cpu(cuda_device, model, dsp):
    """The same ragged schedule (full rate, half rate, a late admission, an
    evicted slot reused) through the engine on the card and on the CPU,
    f32: the same finals and tokens, and each masked step one attention
    launch a layer."""
    from nemotron_tpu_torch.ops.ring_attn_kernel import fused_ring_attention

    finals, launches = {}, {}
    for dev in ("cpu", "cuda"):
        if model == "tiny":
            params, cfg = tiny_port_model(dev)
            vocab = [f"w{i} " for i in range(cfg.vocab_size)]
        else:
            params, cfg, vocab = load_model(FIXTURE, device=dev)
        cc = TCC(att_right_context=6, n_mels=cfg.n_mels)
        eng = TEngine(params, cfg, vocab, cc, n_slots=6, compute_dtype=F32,
                      dsp=dsp)
        audio, _ = ttones.make_eval_streams(4, 6.0, 16, seed=3)
        n = cc.shift_samples
        eng.add_streams(2)
        pos = [0] * 4
        before = fused_ring_attention.launches
        for tick in range(int(audio.shape[1] // n)):
            feed = {0: 0, 1: 1} if tick % 2 == 0 else {0: 0}
            if tick == 3:
                feed[eng.add_stream()] = 2
            if tick == 6:
                eng.remove_stream(1)
                assert eng.add_stream() == 1
                pos[3] = 0
            if tick >= 6:
                feed[1] = 3
            if tick >= 3:
                feed[2] = 2
            eng.feed_audio({s: audio[a, pos[a]:pos[a] + n]
                            for s, a in feed.items()})
            for a in set(feed.values()):
                pos[a] += n
            eng.step()
        finals[dev] = [eng.finalize_stream(s, return_tokens=True)
                       for s in (0, 1, 2)]
        launches[dev] = fused_ring_attention.launches - before
    assert finals["cuda"] == finals["cpu"]
    assert all(len(f[1]) > 0 for f in finals["cpu"])
    assert launches["cpu"] == 0 and launches["cuda"] > 0
    assert launches["cuda"] % cfg.n_layers == 0
