"""SmoothQuant: activation-to-weight difficulty migration for W8A8.

The port's counterpart of `nemotron_tpu/ops/smoothquant.py`. The W8A8 path
quantizes activations per row, so one outlier channel of a LayerNorm
output crushes the resolution of every other channel in its row. The four
quantized matmuls whose input is a LayerNorm output take the migration
exactly in float:

    y = LN(x) * gamma + beta          (feeds W)
    y @ W == (y / s) @ (s * W)        for any per-channel s > 0

with s_j = amax_act_j^ALPHA / amax_w_j^(1-ALPHA), clipped to
[1/S_CLIP, S_CLIP]. Dividing (gamma, beta) by s and multiplying W's rows by
s changes only the int8 rounding. The static mode
(`attach_static_act_scales`) also freezes one activation scale per site and
layer from the same calibration, so the W8A8 kernel skips its amax stage.

Calibration runs the port's own full-utterance encoder (`encode_batch`
with `ln_capture`) over representative audio, with the streaming step's
chunked visibility when `att_chunk` is given, on the params' device. The
fold and the scales are computed on the host in numpy, as the JAX package
computes them, so both packages fold the same weights to the same f32
values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .quant import QTensorW8A8

# (LN param prefix, matmul weights fed by that LN output)
FOLD_SITES = (
    ("norm_ff1", ("ffn1_w1",)),
    ("norm_attn", ("attn_q_w", "attn_k_w", "attn_v_w")),
    ("norm_conv", ("conv_pw1_w",)),
    ("norm_ff2", ("ffn2_w1",)),
)
# the JAX package's defaults: migration strength, clip of the smoothing
# scales, and headroom of the static activation scales over calibration
ALPHA = 0.5
S_CLIP = 100.0
MARGIN = 1.0


def _host(a) -> np.ndarray:
    return a.detach().to(torch.float32).cpu().numpy()


@torch.no_grad()
def calibrate_ln_amax(params, cfg, mel, att_chunk: int | None = None) -> dict:
    """Per-channel abs-max of every fold-site LayerNorm output.

    params: DENSE model params (on their device). mel: [B, T, n_mels] f32
    (numpy or tensor). Returns {site: np.ndarray [L, D]} f32."""
    from ..models.encoder import encode_batch

    mel = torch.as_tensor(np.asarray(mel, np.float32)).to(params.device)
    caps: list = []
    encode_batch(params, cfg, mel, att_chunk=att_chunk, ln_capture=caps)
    return {site: _host(torch.stack([c[site].abs().amax(dim=(0, 1))
                                     for c in caps]))
            for site, _ in FOLD_SITES}


def smooth_params(params, amax: dict):
    """Fold per-channel smoothing scales into the model (exact in float).
    Returns (new DENSE params on the same device, {site: s [L, D]}): the
    folded model's LN outputs are the originals divided by s. Quantize
    afterwards with `params.quantize_model_params(..., mode="w8a8")`."""
    layers = params.layers
    dev = params.device
    updates: dict = {}
    scales: dict = {}
    for site, weight_names in FOLD_SITES:
        ws = [_host(getattr(layers, w)) for w in weight_names]  # [L, D, out]
        a = np.asarray(amax[site], np.float32)                   # [L, D]
        w_amax = np.max(np.abs(np.concatenate(ws, axis=-1)), axis=-1)
        s = (np.maximum(a, 1e-5) ** ALPHA
             / np.maximum(w_amax, 1e-5) ** (1.0 - ALPHA))
        s = np.clip(s, 1.0 / S_CLIP, S_CLIP)
        scales[site] = s
        g = _host(getattr(layers, site + "_w"))
        b = _host(getattr(layers, site + "_b"))
        folded = {site + "_w": g / s, site + "_b": b / s}
        for name, w in zip(weight_names, ws):
            folded[name] = w * s[..., :, None]
        for name, v in folded.items():
            updates[name] = torch.from_numpy(
                np.ascontiguousarray(v, np.float32)).to(dev)
    out = dataclasses.replace(
        params, layers=dataclasses.replace(layers, **updates))
    return out, scales


def attach_static_act_scales(qparams, amax: dict, fold_scales: dict):
    """Attach static per-tensor activation scales to the fold-site W8A8
    weights: max_j(amax[site][l, j] / s[site][l, j]) * MARGIN / 127 for
    each (site, layer), the folded model's LN-output range (beyond it, int8
    saturates)."""
    layers = qparams.layers
    updates: dict = {}
    for site, weight_names in FOLD_SITES:
        folded_amax = np.asarray(amax[site], np.float32) / fold_scales[site]
        a = np.max(folded_amax, axis=-1) * MARGIN                   # [L]
        act_scale = np.maximum(a, 1e-8).astype(np.float32) / 127.0
        for name in weight_names:
            w = getattr(layers, name)
            if not isinstance(w, QTensorW8A8):
                raise TypeError(f"{name}: static activation scales need W8A8 "
                                f"weights, got {type(w).__name__}")
            updates[name] = dataclasses.replace(
                w, act_scale=torch.from_numpy(act_scale).to(w.q.device))
    return dataclasses.replace(
        qparams, layers=dataclasses.replace(layers, **updates))


def smooth_quantize(params, cfg, mel, att_chunk: int | None = None,
                    static_act: bool = False):
    """Calibrate, fold and W8A8-quantize in one call. params must be dense
    f32 (`load_model(keep_quantized=False)`). static_act=True also attaches
    the static activation scales (mode 'w8a8-sq-static')."""
    from ..params import quantize_model_params

    a = calibrate_ln_amax(params, cfg, mel, att_chunk=att_chunk)
    smoothed, s = smooth_params(params, a)
    qp = quantize_model_params(smoothed, mode="w8a8")
    if static_act:
        qp = attach_static_act_scales(qp, a, s)
    return qp
