"""SmoothQuant in the PyTorch port against the JAX package on the CPU: the
calibration's LayerNorm amax, the fold (exact in f32), the static
activation scales, the static W8A8 product (bit for bit), the dense GGUF
load SmoothQuant folds, and streaming sessions on the trained fixture
through the w8a8-sq and w8a8-sq-static tiers."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config, write_tiny_gguf
from nemotron_tpu import gguf
from nemotron_tpu import params as jparams
from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.ops import quant as jquant
from nemotron_tpu.ops import smoothquant as jsq
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.utils import tones as tones_mod
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models.encoder import encode_batch as tencode_batch
from nemotron_tpu_torch.ops import quant as tquant
from nemotron_tpu_torch.ops import smoothquant as tsq
from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul_static_ref
from nemotron_tpu_torch.params import flatten, load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.streaming.session import StreamSession as TSession

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
# the calibration runs the batch encoder in both packages, which sum in
# other orders (~1e-7 relative); its amax are held within 1e-5 relative
AMAX_RTOL = 1e-5
# the fold is exact in float: the folded encoder equals the original to
# f32 rounding (the JAX package's own gate, tests/test_smoothquant.py:39)
FOLD_ATOL = 5e-5


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def dense(model_setup):
    _arrays, jp, cfg = model_setup
    return jp, params_from_jax_arrays(jax_flat(jp), cfg, device="cpu"), cfg


def _mel(cfg, seed=3, B=2, T=48):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.n_mels)).astype(np.float32)


@pytest.mark.parametrize("att_chunk", [None, 4])
def test_calibrate_ln_amax_matches_jax(dense, att_chunk):
    jp, tp, cfg = dense
    mel = _mel(cfg)
    want = jsq.calibrate_ln_amax(jp, cfg, mel, att_chunk=att_chunk)
    got = tsq.calibrate_ln_amax(tp, cfg, mel, att_chunk=att_chunk)
    assert set(got) == {s for s, _ in tsq.FOLD_SITES} == set(want)
    for site in want:
        assert got[site].shape == (cfg.n_layers, cfg.d_model)
        assert got[site].dtype == np.float32
        np.testing.assert_allclose(got[site], want[site], rtol=AMAX_RTOL,
                                   err_msg=site)


@pytest.mark.parametrize("att_chunk", [None, 4])
def test_fold_matches_jax_and_is_exact(dense, att_chunk):
    """The same amax (of full or chunked visibility) give the same folded
    f32 weights bit for bit, and the folded encoder equals the original
    within f32 rounding."""
    jp, tp, cfg = dense
    mel = _mel(cfg)
    amax = jsq.calibrate_ln_amax(jp, cfg, mel, att_chunk=att_chunk)
    jsm, js = jsq.smooth_params(jp, amax, alpha=tsq.ALPHA,
                                s_clip=tsq.S_CLIP, return_scales=True)
    tsm, ts = tsq.smooth_params(tp, amax)
    for site, names in tsq.FOLD_SITES:
        np.testing.assert_array_equal(ts[site], js[site])
        for name in (site + "_w", site + "_b") + names:
            np.testing.assert_array_equal(
                getattr(tsm.layers, name).numpy(),
                np.asarray(getattr(jsm.layers, name)), name)
    ref = tencode_batch(tp, cfg, torch.tensor(mel)).numpy()
    got = tencode_batch(tsm, cfg, torch.tensor(mel)).numpy()
    assert np.abs(got - ref).max() < FOLD_ATOL


def test_static_scales_and_params_match_jax(dense):
    """smooth_quantize(static_act=True): the same W8A8 weights and static
    scales as the JAX package's, carried across params_from_jax_arrays and
    flattened to the JAX paths."""
    jp, tp, cfg = dense
    mel = _mel(cfg, seed=4)
    jq = jsq.smooth_quantize(jp, cfg, mel, att_chunk=4, static_act=True)
    tq = tsq.smooth_quantize(tp, cfg, mel, att_chunk=4, static_act=True)
    want = jax_flat(jq)
    got = {k: v.numpy() for k, v in flatten(tq).items()}
    act = [k for k in want if k.endswith(".act_scale")]
    assert len(act) == 6 and set(act) <= set(got)
    for k in act:
        np.testing.assert_allclose(got[k], want[k], rtol=AMAX_RTOL, err_msg=k)
    for k in want:
        if k.endswith((".q", ".col_scale")):
            # int8 weights of the same f32 fold: at most one step where a
            # folded weight lies on a rounding boundary (none seen)
            assert np.abs(got[k].astype(np.float64) - want[k]).max() <= (
                1 if k.endswith(".q") else 1e-6 * np.abs(want[k]).max()), k
    carried = params_from_jax_arrays(want, cfg, device="cpu")
    for k in act:
        np.testing.assert_array_equal(flatten(carried)[k].numpy(), want[k])
    assert carried.layers.layer(1).attn_q_w.act_scale.dim() == 0
    assert carried.layers.attn_out_w.act_scale is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_qmm_bit_equal_to_jax(dense, dtype):
    """The static W8A8 product (qmm, qmm_shared, w8a8_matmul_static_ref)
    equals the JAX package's static qmm_w8a8 bit for bit, scales small
    enough that some activations saturate."""
    _jp, tp, cfg = dense
    rng = np.random.default_rng(8)
    w = rng.standard_normal((3, cfg.d_model, 96)).astype(np.float32) * 0.05
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32) * 3
    jw = jquant.quantize_tensor_w8a8(w)
    act = np.array([0.01, 0.02, 0.03], np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.tensor(x).to(getattr(torch, dtype))
    tw = tquant.QTensorW8A8(q=torch.tensor(jw.q), col_scale=torch.tensor(
        jw.col_scale), act_scale=torch.tensor(act))
    for layer in range(3):
        jl = jquant.QTensorW8A8(q=jw.q[layer], col_scale=jw.col_scale[layer],
                                act_scale=act[layer])
        want = np.asarray(jquant.qmm(jx, jl).astype(jnp.float32))
        got = tquant.qmm(tx, tw[layer])
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
        ref = w8a8_matmul_static_ref(tx.reshape(-1, cfg.d_model),
                                     tw[layer].q, tw[layer].col_scale,
                                     tw[layer].act_scale)
        np.testing.assert_array_equal(ref.float().numpy().reshape(want.shape),
                                      want)
        shared = jquant.qmm_shared(jx, [jl, jl])
        for g, s in zip(tquant.qmm_shared(tx, [tw[layer], tw[layer]]),
                        shared):
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(s.astype(jnp.float32)))
    assert np.abs(x).max() / act[0] > 127   # the clip is exercised


def test_dense_load_matches_jax():
    """load_model(keep_quantized=False) dequantizes a Q8_0 GGUF to the same
    dense f32 weights as the JAX package's."""
    cfg = tiny_config()
    arrays = jparams.random_weight_arrays(cfg, seed=2)
    qnames = {n: gguf.GGML_Q8_0 for n in arrays
              if jquant.should_quantize(n, arrays[n] if arrays[n].ndim != 3
                                        else arrays[n].squeeze())}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "q8.gguf")
        write_tiny_gguf(path, arrays, cfg, quantize=qnames)
        jp, _, _ = jload_model(path, keep_quantized=False)
        tp, _, _ = tload_model(path, device="cpu", keep_quantized=False)
        tk, _, _ = tload_model(path, device="cpu")
    want = jax_flat(jp)
    got = flatten(tp)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], k)
    assert isinstance(tk.layers.ffn1_w1, tquant.QTensor)


@pytest.fixture(scope="module")
def fixture_dense():
    jp, jc, jv = jload_model(FIXTURE, keep_quantized=False)
    tp, tc, tv = tload_model(FIXTURE, device="cpu", keep_quantized=False)
    return (jp, jc, jv), (tp, tc, tv)


def edit_distance(a: list, b: list) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("static,int4", [(False, False), (True, True)])
def test_sq_session_tokens_match_jax(fixture_dense, static, int4):
    """Sessions on the trained fixture through SmoothQuant calibrated on
    the same mel: w8a8-sq with int8 rings, w8a8-sq-static with int4 rings.
    - The JAX package's quantized params carried into the port: the
      static tier is exact (its product bit-equal, int4 ring bytes equal),
      so every token equals JAX's; the dynamic tier's per-row scale is
      amax * f32(1/127) where JAX divides, which moves a token on a
      rounding boundary by a frame, so its token ids are held equal.
    - The port's own calibration (amax within 1e-5 relative, so an int8
      weight on a rounding boundary may differ by one step): token ids
      within the JAX package's bf16 bound, an edit distance under 5%
      (tests/test_trained_fixture.py:80-95)."""
    (jp, jc, jv), (tp, tc, tv) = fixture_dense
    audio, _ = tones_mod.make_eval_streams(2, 6.0, 16, seed=11)
    kv = dict(kv_cache_int4=True) if int4 else dict(kv_cache_int8=True)
    jcc = JCC(att_right_context=6, n_mels=jc.n_mels, **kv)
    tcc = TCC(att_right_context=6, n_mels=tc.n_mels, **kv)
    mel = JSession(jp, jc, jv, jcc).preproc.process(audio[0])
    jq = jsq.smooth_quantize(jp, jc, mel, att_chunk=jcc.chunk_enc_len,
                             static_act=static)
    tq = tsq.smooth_quantize(tp, tc, mel, att_chunk=tcc.chunk_enc_len,
                             static_act=static)
    carried = params_from_jax_arrays(jax_flat(jq), tc, device="cpu")
    runs = []
    for sess in (JSession(jq, jc, jv, jcc, n_streams=2),
                 TSession(carried, tc, tv, tcc, n_streams=2),
                 TSession(tq, tc, tv, tcc, n_streams=2)):
        sess.process(audio)
        sess.finalize()
        runs.append([sess.get_tokens(s) for s in range(2)])
    for want, got, own in zip(*runs):
        assert len(want) > 10
        if static:
            assert got == want
        ids = [t for t, _ in want]
        assert [t for t, _ in got] == ids
        assert edit_distance([t for t, _ in own], ids) < 0.05 * len(ids)
    assert isinstance(tq.layers.attn_q_w, tquant.QTensorW8A8)
    assert (tq.layers.attn_q_w.act_scale is not None) == static


def test_static_scales_need_w8a8_weights(dense):
    _jp, tp, cfg = dense
    amax = tsq.calibrate_ln_amax(tp, cfg, _mel(cfg))
    sm, s = tsq.smooth_params(tp, amax)
    with pytest.raises(TypeError, match="W8A8"):
        tsq.attach_static_act_scales(sm, amax, s)
