"""Op-level parity of the PyTorch port with the JAX package on shared
numpy inputs (CPU): norms, FFN, convolutions, LSTM, relative-position
attention and the mel frontend. Tolerances: log-mel 2e-4, others 5e-5
(docs/STATUS.md "Validated numerics")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.frontend import preprocessor as jpre
from nemotron_tpu.ops import basic as jbasic
from nemotron_tpu.ops import conv as jconv
from nemotron_tpu.ops import lstm as jlstm
from nemotron_tpu.ops import quant as jquant
from nemotron_tpu.ops import rel_attention as jrel
from nemotron_tpu.params import quantize_model_params
from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch.frontend import preprocessor as tpre
from nemotron_tpu_torch.ops import basic as tbasic
from nemotron_tpu_torch.ops import conv as tconv
from nemotron_tpu_torch.ops import lstm as tlstm
from nemotron_tpu_torch.ops import quant as tquant
from nemotron_tpu_torch.ops import rel_attention as trel

torch.set_num_threads(1)

ATOL = 5e-5
MEL_ATOL = 2e-4


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


def T(a):
    return torch.tensor(np.asarray(a))


def close(got, want, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def both(model_setup):
    """The tiny model in both packages, dense and with Q8_0 encoder
    matmuls: whole params (jp/tp, jq/tq), layer-0 params (j0/t0, jq0/tq0)
    and the config."""
    _arrays, jp, cfg = model_setup
    tp = tparams.params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    jq = quantize_model_params(jp, "q8_0")
    tq = tparams.params_from_jax_arrays(jax_flat(jq), cfg, device="cpu")
    j0 = jax.tree_util.tree_map(lambda a: a[0], jp.layers)
    jq0 = jax.tree_util.tree_map(lambda a: a[0], jq.layers)
    return dict(jp=jp, tp=tp, jq=jq, tq=tq, j0=j0, t0=tp.layers.layer(0),
                jq0=jq0, tq0=tq.layers.layer(0), cfg=cfg)


def test_layer_norm_silu_glu(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    close(tbasic.layer_norm(T(x), T(w), T(b)), jbasic.layer_norm(x, w, b))
    close(tbasic.silu(T(x)), jbasic.silu(x))
    close(tbasic.glu(T(x)), jbasic.glu(x))


@pytest.mark.parametrize("quantized", [False, True])
def test_ffn(both, rng, quantized):
    jl, tl = (both["jq0"], both["tq0"]) if quantized else (both["j0"],
                                                          both["t0"])
    x = rng.standard_normal((2, 3, both["cfg"].d_model)).astype(np.float32)
    close(tbasic.ffn(T(x), tl.ffn1_w1, tl.ffn1_w2),
          jbasic.ffn(jnp.asarray(x), jl.ffn1_w1, jl.ffn1_w2))


def test_qmm_matches_jax_dequant_matmul(rng):
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.1
    x = rng.standard_normal((5, 64)).astype(np.float32)
    jq = jquant.quantize_tensor(w)
    tq = tquant.QTensor(q=T(jq.q), scale=T(jq.scale))
    close(tquant.qmm(T(x), tq), jquant.qmm(jnp.asarray(x), jq), atol=1e-5)
    close(tquant.dequantize(tq), jquant.dequantize(jq), atol=0)
    close(tquant.qmm(T(x), T(w)), jquant.qmm(jnp.asarray(x), jnp.asarray(w)),
          atol=1e-5)
    mine = tquant.quantize_tensor(w)
    np.testing.assert_array_equal(mine.q, jq.q)
    np.testing.assert_array_equal(mine.scale, jq.scale)


def test_conv_subsampling(both, rng):
    cfg = both["cfg"]
    mel = rng.standard_normal((2, 25, cfg.n_mels)).astype(np.float32)
    got = tconv.conv_subsampling(both["tp"].subsampling, T(mel))
    want = jconv.conv_subsampling(both["jp"].subsampling, jnp.asarray(mel))
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_depthwise_conv1d_with_cache(both, rng):
    D, K = both["cfg"].d_model, both["cfg"].kernel_size
    x = rng.standard_normal((2, 4, D)).astype(np.float32)
    cache = rng.standard_normal((2, K - 1, D)).astype(np.float32)
    w = np.asarray(both["j0"].conv_dw_w)
    for c in (None, cache):
        got, gc = tconv.depthwise_conv1d(T(x), T(w),
                                         None if c is None else T(c))
        want, wc = jconv.depthwise_conv1d(jnp.asarray(x), w, c)
        close(got, want)
        close(gc, wc)


@pytest.mark.parametrize("quantized", [False, True])
def test_conformer_conv_module(both, rng, quantized):
    jl, tl = (both["jq0"], both["tq0"]) if quantized else (both["j0"],
                                                          both["t0"])
    cfg = both["cfg"]
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    cache = rng.standard_normal((2, cfg.kernel_size - 1,
                                 cfg.d_model)).astype(np.float32)
    got, gc = tconv.conformer_conv_module(tl, T(x), T(cache))
    want, wc = jconv.conformer_conv_module(jl, jnp.asarray(x),
                                           jnp.asarray(cache))
    close(got, want)
    close(gc, wc)


def test_lstm_step(both, rng):
    cfg = both["cfg"]
    H = cfg.decoder_dim
    x = rng.standard_normal((3, H)).astype(np.float32)
    h = rng.standard_normal((3, 2, H)).astype(np.float32)
    c = rng.standard_normal((3, 2, H)).astype(np.float32)
    got = tlstm.lstm_step(both["tp"].decoder, T(x), T(h), T(c))
    want = jlstm.lstm_step(both["jp"].decoder, jnp.asarray(x),
                           jnp.asarray(h), jnp.asarray(c))
    for g, w in zip(got, want):
        close(g, w, atol=1e-6)


@pytest.mark.parametrize("Q,klen", [(1, 5), (3, 9), (14, 28)])
def test_rel_shift(rng, Q, klen):
    raw = rng.standard_normal((2, 3, Q, 2 * klen - 1)).astype(np.float32)
    got = trel.rel_shift(T(raw), klen)
    want = jrel.rel_shift(jnp.asarray(raw), klen)
    close(got, want, atol=0)
    i, j = 1 % Q, 2
    assert got[0, 0, i, j] == raw[0, 0, i, j + Q - 1 - i]


@pytest.mark.parametrize("quantized", [False, True])
def test_project_pos(both, quantized):
    cfg = both["cfg"]
    jl, tl = (both["jq0"], both["tq0"]) if quantized else (both["j0"],
                                                          both["t0"])
    pos = trel.pos_emb_descending(9, cfg.d_model)
    np.testing.assert_array_equal(pos, jrel.pos_emb_descending(9, cfg.d_model))
    close(trel.project_pos(tl.attn_pos_w, T(pos), cfg.n_heads, cfg.d_head),
          jrel.project_pos(jl.attn_pos_w, jnp.asarray(pos), cfg.n_heads,
                           cfg.d_head))


def _ring_geometry(Q, kv, phase, valid_len, B):
    """The encoder's slot geometry for a given phase: (chron [kv+Q], JAX
    one-hot pos_perm [kv, kv+Q], additive mask [B, 1, 1, kv+Q])."""
    n_seg = kv // Q
    j = np.arange(kv)
    age = np.mod(phase - 1 - j // Q, n_seg) + 1
    chron = np.concatenate([(n_seg - 1 - age) * Q + j % Q,
                            (n_seg - 1) * Q + np.arange(Q)])
    pos_perm = (np.arange(kv)[:, None] == chron[None, :]).astype(np.float32)
    valid = np.concatenate([np.broadcast_to(age * Q <= valid_len, (B, kv)),
                            np.ones((B, Q), bool)], axis=1)
    mask = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return chron, pos_perm, mask


@pytest.mark.parametrize("phase,valid_len", [(0, 0), (2, 4), (3, 6)])
def test_rel_pos_mha_ring_plain_and_fused(both, rng, phase, valid_len):
    cfg = both["cfg"]
    H, Dh, D = cfg.n_heads, cfg.d_head, cfg.d_model
    B, Q, kv = 2, 2, 8
    chron, pos_perm, mask = _ring_geometry(Q, kv, phase, valid_len, B)
    x = rng.standard_normal((B, Q, D)).astype(np.float32)
    k_ring = rng.standard_normal((cfg.n_layers, B, H, kv, Dh)).astype(np.float32)
    v_ring = rng.standard_normal((cfg.n_layers, B, H, kv, Dh)).astype(np.float32)
    pos = jnp.asarray(jrel.pos_emb_descending(kv, D))
    ph = jrel.project_pos(both["j0"].attn_pos_w, pos, H, Dh)
    want, wk, wv = jrel.rel_pos_mha_ring(both["j0"], jnp.asarray(x), ph, H,
                                         Dh, jnp.asarray(k_ring[1]),
                                         jnp.asarray(v_ring[1]),
                                         jnp.asarray(pos_perm),
                                         jnp.asarray(mask))
    tph = T(np.asarray(ph))
    got, gk, gv = trel.rel_pos_mha_ring(both["t0"], T(x), tph, H, Dh,
                                        T(k_ring[1]), T(v_ring[1]),
                                        T(chron), T(mask))
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    ones = torch.ones((B, H, kv))
    fused, fk, fv = trel.rel_pos_mha_ring_fused(
        both["t0"], T(x), tph, H, Dh, 1, T(k_ring), T(v_ring), T(chron),
        T(mask), ones, ones)
    close(fused, want)
    jfused, _, _ = jrel.rel_pos_mha_ring_fused(
        both["j0"], jnp.asarray(x), ph, H, Dh, 1, jnp.asarray(k_ring),
        jnp.asarray(v_ring), jnp.asarray(pos_perm), jnp.asarray(mask),
        jnp.ones((B, H, kv)), jnp.ones((B, H, kv)), block_b=B,
        interpret=True)
    close(fused, jfused)


def test_chron_to_slot_matches_one_hot_matmul(rng):
    Q, kv = 3, 12
    for phase in range(kv // Q):
        chron, pos_perm, _ = _ring_geometry(Q, kv, phase, 0, 1)
        x = rng.standard_normal((2, 4, Q, kv)).astype(np.float32)
        close(trel.chron_to_slot(T(x), T(chron)), x @ pos_perm, atol=0)


def test_mel_spectrogram(both, rng):
    pre = both["jp"].preprocessor
    frames = rng.standard_normal((2, 7, 512)).astype(np.float32) * 0.1
    win = jpre.pad_window(np.asarray(pre.window), 512)
    np.testing.assert_array_equal(tpre.pad_window(np.asarray(pre.window),
                                                  512), win)
    got = tpre.mel_spectrogram(T(frames), T(win), T(np.asarray(pre.filterbank)))
    want = jpre.mel_spectrogram(jnp.asarray(frames), jnp.asarray(win),
                                jnp.asarray(pre.filterbank))
    close(got, want, atol=MEL_ATOL)


def test_streaming_preprocessor_matches_jax_and_one_shot(both, rng):
    from nemotron_tpu.config import PreprocessorConfig as JPC
    from nemotron_tpu_torch.config import PreprocessorConfig as TPC

    cfg = both["cfg"]
    pre = both["jp"].preprocessor
    fb, win = np.asarray(pre.filterbank), np.asarray(pre.window)
    audio = (rng.standard_normal((2, 9000)) * 3000).astype(np.int16)
    jp = jpre.StreamingPreprocessor(fb, win, n_streams=2,
                                    cfg=JPC(n_mels=cfg.n_mels),
                                    backend="numpy")
    tp = tpre.StreamingPreprocessor(fb, win, n_streams=2,
                                    cfg=TPC(n_mels=cfg.n_mels), device="cpu")
    one = tpre.StreamingPreprocessor(fb, win, n_streams=2,
                                     cfg=TPC(n_mels=cfg.n_mels), device="cpu")
    got, want = [], []
    for lo, hi in ((0, 100), (100, 2999), (2999, 3000), (3000, 9000)):
        got.append(tp.process(audio[:, lo:hi]))
        want.append(jp.process(audio[:, lo:hi]))
        assert got[-1].shape == want[-1].shape
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    assert got.shape[1] > 40
    close(got, want, atol=MEL_ATOL)
    close(one.process(audio), got, atol=1e-5)
