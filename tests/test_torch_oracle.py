"""The port's numpy oracle (`nemotron_tpu_torch.oracle`) on the CPU.

  - against the JAX package's oracle (`nemotron_tpu.oracle`): every public
    function and method on the same arrays -- the ops, OracleModel's
    stages and greedy decode, OracleStream.encode_chunk / process_mel at
    R = 0 and 13 (and per-layer right context), OracleBeam.decode with and
    without an LM, OraclePreprocessor.process over chunked PCM. Both are
    numpy, so the tolerance is bit-equality (assert_array_equal, equal
    dtypes);
  - the port's torch model on the CPU against the port's oracle, at the
    tolerances the JAX package's tests hold the JAX model to its oracle
    (tests/test_encoder.py, test_streaming_encoder.py, test_decoder.py,
    test_preprocessor.py, test_beam.py, test_lm_fusion.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nemotron_tpu import oracle as joracle
from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.frontend.preprocessor import hann_window, \
    mel_filterbank_slaney
from nemotron_tpu.models import lm as jlm
from nemotron_tpu.oracle import beam as jbeam
from nemotron_tpu.oracle import ops as jops
from nemotron_tpu_torch import oracle as toracle
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.config import ModelConfig as TMC
from nemotron_tpu_torch.oracle import beam as tbeam
from nemotron_tpu_torch.oracle import ops as tops

torch.set_num_threads(1)


def equal(a, b):
    """Bit-equality of two oracle results (arrays, numbers, lists, tuples,
    dicts), dtypes included."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def setup(model_setup):
    """The tests' tiny random model: its arrays, the port's config and
    both oracles."""
    arrays, _jp, jcfg = model_setup
    tcfg = TMC(**dataclasses.asdict(jcfg))
    return dict(arrays=arrays, jcfg=jcfg, tcfg=tcfg,
                jm=joracle.OracleModel(arrays, jcfg),
                tm=toracle.OracleModel(arrays, tcfg))


# -- the port's oracle against the JAX package's, bit for bit -----------------

def _op_case(name, rng):
    """(the op, its arguments, its keyword arguments) of a case."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "linear": ("linear", (r(5, 12), r(7, 12), r(7)), {}),
        "layer_norm": ("layer_norm", (r(6, 16), r(16), r(16)), {}),
        "silu": ("silu", (r(4, 9),), {}),
        "sigmoid": ("sigmoid", (r(4, 9),), {}),
        "relu": ("relu", (r(4, 9),), {}),
        "glu": ("glu", (r(5, 18),), {}),
        "softmax": ("softmax", (r(3, 4, 11),), {"axis": 1}),
        "causal_conv2d": ("causal_conv2d",
                          (r(13, 10, 1), r(4, 1, 3, 3), r(4), 2), {}),
        "causal_conv2d_depthwise": ("causal_conv2d",
                                    (r(9, 7, 4), r(4, 1, 3, 3), r(4), 2),
                                    {"groups": 4}),
        "causal_conv2d_pointwise": ("causal_conv2d",
                                    (r(9, 7, 4), r(6, 4, 1, 1), r(6), 1), {}),
        "causal_conv1d_depthwise": ("causal_conv1d_depthwise",
                                    (r(8, 6), r(5, 6)), {}),
        "causal_conv1d_depthwise_cached": ("causal_conv1d_depthwise",
                                           (r(8, 6), r(5, 6), r(4, 6)), {}),
        "lstm_cell": ("lstm_cell", (r(5), r(7), r(7), r(28, 5), r(28, 7),
                                    r(28), r(28)), {}),
        "pos_emb_descending": ("pos_emb_descending", (12, 16), {}),
        "rel_shift": ("rel_shift", (r(3, 7, 13),), {}),
        "rel_shift_cached": ("rel_shift_cached", (r(2, 4, 27), 14), {}),
    }[name]


OPS = ("linear", "layer_norm", "silu", "sigmoid", "relu", "glu", "softmax",
       "causal_conv2d", "causal_conv2d_depthwise", "causal_conv2d_pointwise",
       "causal_conv1d_depthwise", "causal_conv1d_depthwise_cached",
       "lstm_cell", "pos_emb_descending", "rel_shift", "rel_shift_cached")


@pytest.mark.parametrize("name", OPS)
def test_ops_equal_jax(name):
    fn, args, kw = _op_case(name, np.random.default_rng(OPS.index(name)))
    equal(getattr(tops, fn)(*args, **kw), getattr(jops, fn)(*args, **kw))


def test_public_names_are_jax_oracles():
    """The port's oracle has each public name of the JAX package's."""
    for mod_t, mod_j in ((tops, jops), (tbeam, jbeam),
                         (toracle, joracle)):
        names = {n for n in dir(mod_j) if not n.startswith("_")
                 and callable(getattr(mod_j, n))
                 and getattr(getattr(mod_j, n), "__module__", "")
                 .startswith("nemotron_tpu.oracle")}
        assert names and names <= set(dir(mod_t))
    # every public op is a case of test_ops_equal_jax
    ops = {n for n in dir(jops) if not n.startswith("_")
           and getattr(getattr(jops, n), "__module__", "") == jops.__name__}
    assert ops == {_op_case(n, np.random.default_rng(0))[0] for n in OPS}


STAGES = ("conv_subsampling", "encoder", "conformer_layer", "decoder_step",
          "joint", "greedy_decode", "greedy_decode_confidence",
          "greedy_decode_carry")


@pytest.mark.parametrize("stage", STAGES)
def test_model_stage_equals_jax(setup, stage):
    jm, tm, cfg = setup["jm"], setup["tm"], setup["tcfg"]
    rng = np.random.default_rng(STAGES.index(stage))
    mel = rng.standard_normal((41, cfg.n_mels)).astype(np.float32)
    enc = (rng.standard_normal((9, cfg.d_model)) * 3).astype(np.float32)
    h = (rng.standard_normal((2, cfg.decoder_dim)) * 0.3).astype(np.float32)
    if stage in ("conv_subsampling", "encoder"):
        equal(getattr(tm, stage)(mel), getattr(jm, stage)(mel))
    elif stage == "conformer_layer":
        x = rng.standard_normal((11, cfg.d_model)).astype(np.float32)
        pos = tops.pos_emb_descending(11, cfg.d_model)
        equal(tm.conformer_layer(x, pos, 1), jm.conformer_layer(x, pos, 1))
    elif stage == "decoder_step":
        equal(tm.decoder_step(7, h, h * 0.5), jm.decoder_step(7, h, h * 0.5))
    elif stage == "joint":
        equal(tm.joint(enc[0], h[0]), jm.joint(enc[0], h[0]))
    elif stage == "greedy_decode_carry":
        t1, st_t = tm.greedy_decode(enc[:5])
        j1, st_j = jm.greedy_decode(enc[:5])
        equal((t1, st_t), (j1, st_j))
        equal(tm.greedy_decode(enc[5:], st_t), jm.greedy_decode(enc[5:], st_j))
        assert t1
    else:
        conf = stage.endswith("confidence")
        got = tm.greedy_decode(enc, with_confidence=conf)
        equal(got, jm.greedy_decode(enc, with_confidence=conf))
        assert got[0]


@pytest.mark.parametrize("mode", ["R0", "R13", "rc_by_layer"])
def test_stream_equals_jax(setup, mode):
    """encode_chunk chunk by chunk (outputs and every cache), then
    process_mel over ragged mel pieces (tokens and decoder state)."""
    cfg = setup["tcfg"]
    kw = dict(att_right_context=0 if mode == "R0" else 13,
              att_left_context=14, n_mels=cfg.n_mels)
    if mode == "rc_by_layer":
        kw["att_right_context_by_layer"] = (13, 1, 0)
    ts = toracle.OracleStream(setup["tm"], TCC(**kw))
    js = joracle.OracleStream(setup["jm"], JCC(**kw))
    rng = np.random.default_rng(7)
    for _ in range(4):
        mel = rng.standard_normal((ts.cc.chunk_mel_frames,
                                   cfg.n_mels)).astype(np.float32)
        equal(ts.encode_chunk(mel), js.encode_chunk(mel))
        equal([ts.k_cache, ts.v_cache, ts.conv_cache, ts.cache_valid_len],
              [js.k_cache, js.v_cache, js.conv_cache, js.cache_valid_len])
    ts = toracle.OracleStream(setup["tm"], TCC(**kw))
    js = joracle.OracleStream(setup["jm"], JCC(**kw))
    mel = (rng.standard_normal((3 * ts.cc.chunk_mel_frames, cfg.n_mels))
           * 2).astype(np.float32)
    for a, b in ((0, 5), (5, 40), (40, mel.shape[0])):
        equal(ts.process_mel(mel[a:b]), js.process_mel(mel[a:b]))
    equal([ts.tokens, ts.dec_state, ts.mel_buffer],
          [js.tokens, js.dec_state, js.mel_buffer])
    assert ts.tokens


@pytest.fixture(scope="module")
def lm_arrays(setup):
    return jlm.random_lm_arrays(setup["tcfg"].vocab_size, hidden=24,
                                n_layers=2, seed=7)


@pytest.mark.parametrize("with_lm", [False, True])
def test_beam_equals_jax(setup, lm_arrays, with_lm):
    cfg = setup["tcfg"]
    kw = dict(lm=lm_arrays, lm_weight=0.4, lm_bonus=0.35) if with_lm else {}
    tb = tbeam.OracleBeam(setup["arrays"], cfg, **kw)
    jb = jbeam.OracleBeam(setup["arrays"], setup["jcfg"], **kw)
    enc = (np.random.default_rng(42).standard_normal((4, cfg.d_model))
           * 0.5).astype(np.float32)
    for K, expansions in ((1, 3), (4, 2)):
        got = tb.decode(enc, K, expansions, max_tokens=32)
        want = jb.decode(enc, K, expansions, max_tokens=32)
        equal(dataclasses.astuple(got), dataclasses.astuple(want))
    if with_lm:
        h = np.zeros((tb.lm_layers, tb.lm_hidden), np.float32)
        equal(tb._lm_step(3, h, h), jb._lm_step(3, h, h))


def synth_audio(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    return (x * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def fb_win():
    return mel_filterbank_slaney(), hann_window(400)


def test_preprocessor_equals_jax(fb_win):
    """Chunked PCM, with pieces below one frame, an empty piece and the
    pre-emphasis carry: every output and the carried state equal."""
    fb, win = fb_win
    tp, jp = toracle.OraclePreprocessor(fb, win), \
        joracle.OraclePreprocessor(fb, win)
    audio = synth_audio(16000 * 2, seed=1)
    cuts = [0, 100, 100, 2720, 3333, 9000, 16000, 32000]
    equal(tp.n_frames_for(300), jp.n_frames_for(300))
    for a, b in zip(cuts, cuts[1:]):
        equal(tp.process(audio[a:b]), jp.process(audio[a:b]))
        equal([tp.last_sample, tp.audio_buf], [jp.last_sample, jp.audio_buf])
    tp.reset()
    jp.reset()
    equal(tp.process(audio), jp.process(audio))


# -- the port's torch model on the CPU against the port's oracle --------------

@pytest.fixture(scope="module")
def tparams(setup):
    from nemotron_tpu_torch.params import params_from_arrays

    return params_from_arrays(setup["arrays"], setup["tcfg"], device="cpu")


def test_torch_conv_subsampling_matches_oracle(setup, tparams):
    from nemotron_tpu_torch.ops.conv import conv_subsampling

    cfg = setup["tcfg"]
    mel = np.random.default_rng(1234).standard_normal(
        (37, cfg.n_mels)).astype(np.float32)
    want = setup["tm"].conv_subsampling(mel)
    got = conv_subsampling(tparams.subsampling, torch.from_numpy(mel)[None])
    assert got.shape[1:] == want.shape
    np.testing.assert_allclose(got[0].numpy(), want, atol=2e-5)


def test_torch_conformer_layer_and_encoder_match_oracle(setup, tparams):
    from nemotron_tpu_torch.models import encoder as tenc
    from nemotron_tpu_torch.ops.rel_attention import project_pos

    cfg, tm = setup["tcfg"], setup["tm"]
    rng = np.random.default_rng(1234)
    x = rng.standard_normal((11, cfg.d_model)).astype(np.float32)
    pos = tops.pos_emb_descending(11, cfg.d_model)
    lp = tparams.layers.layer(0)
    ph = project_pos(lp.attn_pos_w, torch.from_numpy(pos), cfg.n_heads,
                     cfg.d_head)
    got = tenc.conformer_layer_batch(lp, torch.from_numpy(x)[None], ph,
                                     n_heads=cfg.n_heads, d_head=cfg.d_head)
    np.testing.assert_allclose(got[0].numpy(), tm.conformer_layer(x, pos, 0),
                               atol=3e-5)
    mel = rng.standard_normal((25, cfg.n_mels)).astype(np.float32)
    got = tenc.encode_batch(tparams, cfg, torch.from_numpy(mel)[None])[0]
    np.testing.assert_allclose(got.numpy(), tm.encoder(mel), atol=5e-5)


@pytest.mark.parametrize("right_context,n_chunks",
                         [(0, 6), (1, 4), (6, 3), (13, 3)])
def test_torch_streaming_chunks_match_oracle(setup, tparams, right_context,
                                             n_chunks):
    from nemotron_tpu_torch.models import encoder as tenc

    cfg = setup["tcfg"]
    cc = TCC(att_right_context=right_context, att_left_context=14,
             n_mels=cfg.n_mels)
    ostream = toracle.OracleStream(setup["tm"], cc)
    state = tenc.init_encoder_state(cfg, cc, 1, torch.float32, "cpu")
    pos_heads = tenc.precompute_pos_heads(tparams, cfg, cc)
    rng = np.random.default_rng(1234)
    for ci in range(n_chunks):
        mel = rng.standard_normal((cc.chunk_mel_frames,
                                   cfg.n_mels)).astype(np.float32)
        want = ostream.encode_chunk(mel)
        got, state = tenc.encode_chunk(tparams, cfg, cc,
                                       torch.from_numpy(mel)[None], state,
                                       pos_heads)
        assert got.shape[1:] == want.shape == (cc.valid_out_len, cfg.d_model)
        np.testing.assert_allclose(got[0].numpy(), want, atol=5e-5,
                                   err_msg=f"chunk {ci} R={right_context}")
        np.testing.assert_allclose(state.conv_cache[:, 0].numpy(),
                                   ostream.conv_cache, atol=5e-5)
        assert int(state.valid_len[0]) == ostream.cache_valid_len


def test_torch_lstm_joint_and_greedy_match_oracle(setup, tparams):
    from nemotron_tpu_torch.models import decoder as tdec
    from nemotron_tpu_torch.ops.lstm import lstm_step

    cfg, tm = setup["tcfg"], setup["tm"]
    rng = np.random.default_rng(1234)
    h = (rng.standard_normal((2, cfg.decoder_dim)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((2, cfg.decoder_dim)) * 0.3).astype(np.float32)
    want_out, want_h, want_c = tm.decoder_step(7, h, c)
    emb = tparams.decoder.embedding[torch.tensor([7])]
    got_out, got_h, got_c = lstm_step(tparams.decoder, emb,
                                      torch.from_numpy(h)[None],
                                      torch.from_numpy(c)[None])
    for g, w in ((got_out, want_out), (got_h, want_h), (got_c, want_c)):
        np.testing.assert_allclose(g[0].numpy(), w, atol=1e-5)
    enc_frame = rng.standard_normal((cfg.d_model,)).astype(np.float32)
    ep = tdec.joint_project_enc(tparams.joint,
                                torch.from_numpy(enc_frame)[None])
    np.testing.assert_allclose(
        tdec.joint_logits(tparams.joint, ep, got_out)[0].numpy(),
        tm.joint(enc_frame, want_out), atol=1e-5)

    # greedy: exact tokens, with the state carried over two chunks
    enc1 = (rng.standard_normal((9, cfg.d_model)) * 3).astype(np.float32)
    enc2 = (rng.standard_normal((6, cfg.d_model)) * 3).astype(np.float32)
    want1, ostate = tm.greedy_decode(enc1)
    want2, ostate = tm.greedy_decode(enc2, ostate)
    st = tdec.init_decoder_state(cfg, 1, torch.float32, "cpu")
    toks1, st = tdec.greedy_decode(tparams, cfg, torch.from_numpy(enc1)[None],
                                   st)
    toks2, st = tdec.greedy_decode(tparams, cfg, torch.from_numpy(enc2)[None],
                                   st)
    got1 = tdec.tokens_to_list(toks1[0].numpy(), cfg.blank_token)
    got2 = tdec.tokens_to_list(toks2[0].numpy(), cfg.blank_token)
    assert got1 == [(t, f) for t, f in want1]
    assert got2 == [(t, f - ostate["frame_offset"] + 6) for t, f in want2]
    assert len(got1) + len(got2) > 0
    assert int(st.prev_token[0]) == ostate["prev_token"]
    np.testing.assert_allclose(st.h[0].numpy(), ostate["h"], atol=1e-5)


def test_torch_preprocessor_matches_oracle(fb_win):
    from nemotron_tpu_torch.frontend.preprocessor import \
        StreamingPreprocessor

    fb, win = fb_win
    audio = synth_audio(16000 * 2, seed=1)
    oracle = toracle.OraclePreprocessor(fb, win)
    sp = StreamingPreprocessor(fb, win, device="cpu")
    got, want = [], []
    for i in range(0, len(audio), 2720):
        want.append(oracle.process(audio[i:i + 2720]))
        got.append(np.asarray(sp.process(audio[i:i + 2720])[0]))
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("K,expansions,with_lm",
                         [(1, 3, False), (2, 3, False), (4, 2, False),
                          (4, 3, True)])
def test_torch_beam_matches_oracle(setup, tparams, lm_arrays, K, expansions,
                                   with_lm):
    from nemotron_tpu_torch.models import beam as tbm
    from nemotron_tpu_torch.models.lm import lm_params_from_arrays

    cfg = setup["tcfg"]
    lm = lm_params_from_arrays(lm_arrays, device="cpu") if with_lm else None
    kw = dict(lm_weight=0.4, lm_bonus=0.35) if with_lm else {}
    enc = (np.random.default_rng(42).standard_normal((2, 4, cfg.d_model))
           * 0.5).astype(np.float32)
    st = tbm.init_beam_state(cfg, 2, K, 32, torch.float32, "cpu", lm=lm)
    st = tbm.beam_decode(tparams, cfg, torch.from_numpy(enc), st, K,
                         expansions, lm=lm, **kw)
    tokens, lengths, scores = tbm.best_hypothesis(st)
    oracle = tbeam.OracleBeam(setup["arrays"], cfg,
                              lm=lm_arrays if with_lm else None, **kw)
    for b in range(2):
        want = oracle.decode(enc[b], K, expansions, max_tokens=32)
        assert tokens[b, :lengths[b]].tolist() == want.tokens
        np.testing.assert_allclose(float(scores[b]), want.score, rtol=2e-4)
