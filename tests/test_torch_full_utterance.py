"""The full-utterance path of the port against the JAX package on the CPU:
`rel_pos_mha` (batch mode with the length and chunk masks, and the legacy
shift cache), `encode_batch` on dense and Q8_0 weights, greedy RNN-T with
`enc_lengths`, the per-frame oracle (`decode_frame`,
`greedy_decode_by_frame`), `transcribe_batch` and
`transcribe_batch_with_state`. Same seeded numpy inputs into both."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.models import decoder as jdec
from nemotron_tpu.models import encoder as jenc
from nemotron_tpu.ops import rel_attention as jrel
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.params import quantize_model_params
from nemotron_tpu.streaming import session as jsession
from nemotron_tpu.utils import tones as jtones
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.models import encoder as tenc
from nemotron_tpu_torch.ops import rel_attention as trel
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.streaming import session as tsession

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
ATOL = 5e-5                 # encoder outputs (docs/STATUS.md)
BF16_ULPS2 = 2.0 ** -6      # two bf16 ulps, relative to max|out|
LENGTHS = np.array([17, 9, 13], np.int32)   # encoder frames of 3 utterances


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def models(model_setup):
    """{'f32'|'q8': (JAX params, port params)} and the tiny config."""
    _arrays, jp, cfg = model_setup
    jq = quantize_model_params(jp, "q8_0")
    return {name: (p, params_from_jax_arrays(jax_flat(p), cfg, device="cpu"))
            for name, p in (("f32", jp), ("q8", jq))}, cfg


@pytest.fixture(scope="module")
def fixture_models():
    jp, jc, jv = jload_model(FIXTURE)
    tp, tc, tv = tload_model(FIXTURE, device="cpu")
    return (jp, jc, jv), (tp, tc, tv)


def jenc_layer(jp, l):
    """Layer l of the JAX package's stacked layer params."""
    return jax.tree_util.tree_map(lambda a: a[l], jp.layers)


def batch_mask(T, lengths=None, chunk=None, left=5):
    """encode_batch's additive masks, built in numpy: keys at or beyond each
    length, and keys outside [chunk start - left, chunk end)."""
    mask = np.zeros((1, 1, 1, T), np.float32)
    if lengths is not None:
        mask = np.where(np.arange(T)[None, :] >= lengths[:, None], -1e9,
                        0.0).astype(np.float32)[:, None, None, :]
    if chunk is not None:
        j = np.arange(T)
        start = (j // chunk) * chunk
        vis = (j[None, :] < start[:, None] + chunk) & (
            j[None, :] >= start[:, None] - left)
        mask = mask + np.where(vis, 0.0, -1e9).astype(np.float32)[None, None]
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masks", ["none", "lengths", "chunk", "both"])
def test_rel_pos_mha_matches_jax(models, dtype, masks):
    """Batch mode, f32 within 5e-5, bf16 within two bf16 ulps of max|out|
    (the two frameworks round the same f32 sums at the same points; a sum
    that differs in its last f32 bit can round to the neighbouring bf16)."""
    (jp, tp), cfg = models[0]["f32"], models[1]
    H, Dh, D, T = cfg.n_heads, cfg.d_head, cfg.d_model, 17
    rng = np.random.default_rng(len(masks))
    x = rng.standard_normal((3, T, D)).astype(np.float32)
    mask = batch_mask(T, LENGTHS if masks in ("lengths", "both") else None,
                      3 if masks in ("chunk", "both") else None)
    pos = jrel.pos_emb_descending(T, D)
    jl, tl = jenc_layer(jp, 0), tp.layers.layer(0)
    ph = np.asarray(jrel.project_pos(jl.attn_pos_w, jnp.asarray(pos), H, Dh))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, _, _ = jrel.rel_pos_mha(
        jl, jnp.asarray(x, jdt), jnp.asarray(ph, jdt), H, Dh,
        mask=None if masks == "none" else jnp.asarray(mask))
    got, nk, nv = trel.rel_pos_mha(
        tl, torch.tensor(x).to(tdt), torch.tensor(ph).to(tdt), H, Dh,
        mask=None if masks == "none" else torch.tensor(mask))
    assert got.dtype == tdt and nk is None and nv is None
    want = np.asarray(want.astype(jnp.float32))
    atol = ATOL if dtype == "float32" else BF16_ULPS2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_rel_pos_mha_shift_cache_matches_jax(models):
    """The legacy shift-window cache: keys and values are the cache's C
    frames plus the new Q, and the last C come back as the new caches."""
    (jp, tp), cfg = models[0]["f32"], models[1]
    H, Dh, D, Q, C = cfg.n_heads, cfg.d_head, cfg.d_model, 3, 6
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, Q, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, C, D)).astype(np.float32)
              for _ in range(2))
    pos = jrel.pos_emb_descending(C + Q, D)
    jl, tl = jenc_layer(jp, 1), tp.layers.layer(1)
    ph = np.asarray(jrel.project_pos(jl.attn_pos_w, jnp.asarray(pos), H, Dh))
    want = jrel.rel_pos_mha(jl, jnp.asarray(x), jnp.asarray(ph), H, Dh,
                            kv_cache=(jnp.asarray(kc), jnp.asarray(vc)))
    got = trel.rel_pos_mha(tl, torch.tensor(x), torch.tensor(ph), H, Dh,
                           kv_cache=(torch.tensor(kc), torch.tensor(vc)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    np.testing.assert_array_equal(got[1][:, :C - Q].numpy(), kc[:, Q:])


@pytest.mark.parametrize("quant", ["f32", "q8"])
@pytest.mark.parametrize("masks", ["none", "lengths", "lengths+chunk",
                                   "chunk"])
def test_encode_batch_matches_jax(models, quant, masks):
    """Three ragged utterances in one batch: every frame of the output
    (padded ones too) within 5e-5, on dense and on Q8_0 weights."""
    (jp, tp), cfg = models[0][quant], models[1]
    mel = np.random.default_rng(len(masks)).standard_normal(
        (3, 130, cfg.n_mels)).astype(np.float32)
    kw = {}
    if "lengths" in masks:
        kw["enc_lengths"] = LENGTHS
    if "chunk" in masks:
        kw.update(att_chunk=3, att_left=5)
    want = jenc.encode_batch(jp, cfg, jnp.asarray(mel), **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    got = tenc.encode_batch(tp, cfg, torch.tensor(mel), **{
        k: torch.tensor(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    assert tuple(got.shape) == (3, 18, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def biased(models, bias):
    """The f32 pair with `bias` added to token 5's joint output bias."""
    (jp, tp), _cfg = models[0]["f32"], models[1]
    out_b = np.asarray(jp.joint.out_b).copy()
    out_b[5] += bias
    jp = dataclasses.replace(jp, joint=dataclasses.replace(
        jp.joint, out_b=out_b))
    tp = dataclasses.replace(tp, joint=dataclasses.replace(
        tp.joint, out_b=torch.tensor(out_b)))
    return jp, tp


def assert_state_close(t, j):
    np.testing.assert_array_equal(t.prev_token.numpy(),
                                  np.asarray(j.prev_token))
    np.testing.assert_allclose(t.h.numpy(), np.asarray(j.h), atol=1e-7)
    np.testing.assert_allclose(t.c.numpy(), np.asarray(j.c), atol=1e-7)


@pytest.mark.parametrize("bias", [0.0, 2.0, 40.0])
def test_greedy_decode_enc_lengths_matches_jax(models, bias):
    """Ragged lengths (one of them past T, one 0): exact tokens and
    prev_token, h/c within 1e-7, no token at or beyond a stream's length."""
    jp, tp = biased(models, bias)
    cfg = models[1]
    B, T = 4, 7
    lengths = np.array([7, 3, 0, 11], np.int32)
    rng = np.random.default_rng(int(bias) + 1)
    jst = jdec.init_decoder_state(cfg, B)
    tst = tdec.init_decoder_state(cfg, B, torch.float32, "cpu")
    decode = jax.jit(jdec.greedy_decode, static_argnums=1)
    for _ in range(2):
        enc = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
        want, jst = decode(jp, cfg, jnp.asarray(enc), jst,
                           enc_lengths=jnp.asarray(lengths))
        got, tst = tdec.greedy_decode(tp, cfg, torch.tensor(enc), tst,
                                      enc_lengths=torch.tensor(lengths))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert_state_close(tst, jst)
        for b, n in enumerate(np.minimum(lengths, T)):
            assert (got[b, n:] == cfg.blank_token).all()
    assert (got != cfg.blank_token).any()


@pytest.mark.parametrize("bias", [0.0, 2.0, 40.0])
def test_decode_by_frame_matches_jax_and_greedy(models, bias):
    """The per-frame oracle: decode_frame and greedy_decode_by_frame give
    the JAX functions' tokens and prev_token exactly (h/c within 1e-7),
    and the port's frame-skipping greedy_decode gives the oracle's tokens
    and state."""
    jp, tp = biased(models, bias)
    cfg = models[1]
    B, T = 3, 6
    rng = np.random.default_rng(int(bias) + 7)
    enc = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    ep = np.asarray(jdec.joint_project_enc(jp.joint, jnp.asarray(enc)))
    jst = jdec.init_decoder_state(cfg, B)
    tst = tdec.init_decoder_state(cfg, B, torch.float32, "cpu")

    jst1, jtok = jax.jit(jdec.decode_frame, static_argnums=1)(
        jp, cfg, jst, jnp.asarray(ep[:, 0]))
    tst1, ttok = tdec.decode_frame(tp, cfg, tst, torch.tensor(ep[:, 0]))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert_state_close(tst1, jst1)

    want, jst2 = jax.jit(jdec.greedy_decode_by_frame, static_argnums=1)(
        jp, cfg, jnp.asarray(enc), jst)
    got, tst2 = tdec.greedy_decode_by_frame(tp, cfg, torch.tensor(enc), tst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_close(tst2, jst2)

    fast, tst3 = tdec.greedy_decode(tp, cfg, torch.tensor(enc), tst)
    torch.testing.assert_close(fast, got, atol=0, rtol=0)
    for a, b in ((tst3.h, tst2.h), (tst3.c, tst2.c),
                 (tst3.prev_token, tst2.prev_token)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
    if bias == 40.0:
        assert (got != cfg.blank_token).all()


def test_tokens_to_list_matches_jax():
    rng = np.random.default_rng(3)
    toks = np.where(rng.random((2, 5, 4)) < 0.3,
                    rng.integers(0, 9, (2, 5, 4)), 9).astype(np.int32)
    assert tdec.tokens_to_list(toks, 9) == jdec.tokens_to_list(toks, 9)
    assert tdec.tokens_to_list(toks[1], 9) == jdec.tokens_to_list(toks[1], 9)
    assert len(tdec.tokens_to_list(toks[0], 9)) > 0


def ragged_utterances():
    """Three tone utterances of 3, 5.3 and 4.1 s (seeded)."""
    audio, _ = jtones.make_eval_streams(3, 5.3, 16, seed=11)
    return [audio[0, :48000], audio[1], audio[2, :65600]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("timestamps", [False, True])
def test_transcribe_batch_matches_jax(fixture_models, dtype, timestamps):
    """The trained fixture: the texts of 3 ragged utterances in one batch,
    and of one utterance alone (a str), equal the JAX package's."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    utts = ragged_utterances()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jsession.transcribe_batch(jp, jc, jv, utts,
                                     timestamp_words=timestamps,
                                     compute_dtype=jdt)
    got = tsession.transcribe_batch(tp, tc, tv, utts,
                                    timestamp_words=timestamps,
                                    compute_dtype=tdt)
    assert got == want
    assert all(len(t) > 20 for t in got)
    assert ("{" in got[0]) == timestamps
    one = tsession.transcribe_batch(tp, tc, tv, utts[1],
                                    timestamp_words=timestamps,
                                    compute_dtype=tdt)
    assert isinstance(one, str)
    assert one == jsession.transcribe_batch(jp, jc, jv, utts[1],
                                            timestamp_words=timestamps,
                                            compute_dtype=jdt)


def test_transcribe_batch_q8_and_min_mel_frames_match_jax(models):
    """Q8_0 weights on the tiny config, a tuple of inputs, and a mel padded
    to min_mel_frames: the JAX package's texts, and the unpadded ones."""
    (jp, tp), cfg = models[0]["q8"], models[1]
    vocab = [f"t{i}" for i in range(cfg.vocab_size)]
    rng = np.random.default_rng(4)
    utts = tuple((rng.standard_normal(n) * 3000).astype(np.int16)
                 for n in (9000, 14000))
    got = tsession.transcribe_batch(tp, cfg, vocab, utts)
    assert got == jsession.transcribe_batch(jp, cfg, vocab, utts)
    assert tsession.transcribe_batch(tp, cfg, vocab, utts,
                                     min_mel_frames=150) == got
    assert isinstance(got, list) and any(got)


def test_transcribe_batch_with_state_matches_jax(fixture_models):
    """Two chained segments sharing the decoder state: text, tokens, the
    next frame offset and prev_token equal the JAX package's."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    audio, _ = jtones.make_eval_streams(1, 6.0, 16, seed=5)
    segs = [audio[0, :40000], audio[0, 40000:]]
    jst, tst, joff, toff = None, None, 0, 0
    for seg in segs:
        jt, jtoks, jst, joff = jsession.transcribe_batch_with_state(
            jp, jc, jv, seg, dec_state=jst, frame_offset=joff)
        tt, ttoks, tst, toff = tsession.transcribe_batch_with_state(
            tp, tc, tv, seg, dec_state=tst, frame_offset=toff)
        assert (tt, ttoks, toff) == (jt, jtoks, int(joff))
        # each of the ~40 emissions carries the LSTM's one-ulp
        # summation-order gap (see test_greedy_decode_enc_lengths_matches_jax)
        # into the state: a few f32 ulps of h and of c (|c| up to ~12)
        np.testing.assert_array_equal(tst.prev_token.numpy(),
                                      np.asarray(jst.prev_token))
        for a, b in ((tst.h, jst.h), (tst.c, jst.c)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
        assert len(ttoks) > 5
    assert ttoks[0][1] >= 40000 // 1280


@pytest.mark.parametrize("kw", [{"beam_size": 4}, {"return_nbest": 2},
                                {"lm": object()}, {"ctc": True},
                                {"return_confidence": True}, {"tdt": True}])
def test_transcribe_batch_refuses_later_options(fixture_models, kw):
    _, (tp, tc, tv) = fixture_models
    if kw.pop("tdt", False):
        tc = dataclasses.replace(tc, tdt_durations=(0, 1, 2))
    with pytest.raises(NotImplementedError, match="slice of the port"):
        tsession.transcribe_batch(tp, tc, tv, np.zeros(8000, np.int16), **kw)


def test_transcribe_refuses_other_dtypes(fixture_models):
    _, (tp, tc, tv) = fixture_models
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsession.transcribe_batch(tp, tc, tv, np.zeros(8000, np.int16),
                                  compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsession.transcribe_batch_with_state(tp, tc, tv,
                                             np.zeros(8000, np.int16),
                                             compute_dtype=torch.float64)
