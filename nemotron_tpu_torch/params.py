"""Parameter containers and GGUF -> parameters mapping.

The port's counterpart of `nemotron_tpu/params.py`. Tensor-name mapping
mirrors the reference loader (reference src/nemo-ggml.cpp:258-356). The
layouts are the JAX package's, so the tests compare like with like:

  - Linear weights are [in, out] so the forward pass is `x @ w`
    (GGUF/PyTorch store [out, in]; the loader transposes).
  - Conv2d kernels are HWIO: [kT, kF, in_ch, out_ch].
  - The depthwise conv1d weight is [kernel, d_model].
  - Conformer layer params are stacked along a leading layer axis [L, ...].
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import gguf as gguf_mod
from .config import ModelConfig
from .device import resolve_device
from .ops.quant import (QTensor, QTensorW8A8, quantize_tensor,
                        quantize_tensor_w8a8, should_quantize)

_QUANT_FIELDS = {QTensor: ("q", "scale"),
                 QTensorW8A8: ("q", "col_scale", "act_scale")}


@dataclasses.dataclass
class SubsamplingParams:
    """Causal ConvSubsampling (reference src/nemo-ggml.cpp:877-952)."""

    conv0_w: Any   # [3, 3, 1, C]    full conv, stride 2
    conv0_b: Any   # [C]
    conv2_w: Any   # [3, 3, 1, C]    depthwise, stride 2
    conv2_b: Any
    conv3_w: Any   # [1, 1, C, C]    pointwise
    conv3_b: Any
    conv5_w: Any   # [3, 3, 1, C]    depthwise, stride 2
    conv5_b: Any
    conv6_w: Any   # [1, 1, C, C]    pointwise
    conv6_b: Any
    out_w: Any     # [C*F', D]
    out_b: Any     # [D]


@dataclasses.dataclass
class ConformerLayerParams:
    """L stacked Conformer layers (leading layer axis on every leaf);
    `layer(i)` gives one layer's views. Residual structure: reference
    src/nemo-ggml.cpp:768-813."""

    norm_ff1_w: Any      # [D]
    norm_ff1_b: Any
    ffn1_w1: Any         # [D, 4D]
    ffn1_w2: Any         # [4D, D]
    norm_attn_w: Any
    norm_attn_b: Any
    attn_q_w: Any        # [D, D]
    attn_k_w: Any
    attn_v_w: Any
    attn_pos_w: Any
    attn_out_w: Any
    pos_bias_u: Any      # [H, d_head]
    pos_bias_v: Any
    norm_conv_w: Any
    norm_conv_b: Any
    conv_pw1_w: Any      # [D, 2D]
    conv_dw_w: Any       # [K, D]
    conv_ln_w: Any
    conv_ln_b: Any
    conv_pw2_w: Any      # [D, D]
    norm_ff2_w: Any
    norm_ff2_b: Any
    ffn2_w1: Any
    ffn2_w2: Any
    norm_final_w: Any
    norm_final_b: Any

    def layer(self, i: int) -> "ConformerLayerParams":
        return ConformerLayerParams(**{
            f.name: getattr(self, f.name)[i] for f in dataclasses.fields(self)})

    def unstack(self, n: int) -> list["ConformerLayerParams"]:
        """The n layers' views at once. A tensor leaf is unbound along its
        layer axis, so its gradient is one stack of the layers' gradients
        (indexed layer by layer, each layer's backward would add a
        full-size [L, ...] gradient into it); a quantized leaf is
        indexed."""
        cols = {f.name: (x.unbind(0) if isinstance(x, torch.Tensor)
                         else [x[i] for i in range(n)])
                for f in dataclasses.fields(self)
                for x in (getattr(self, f.name),)}
        return [ConformerLayerParams(**{k: v[i] for k, v in cols.items()})
                for i in range(n)]


@dataclasses.dataclass
class DecoderParams:
    """RNN-T prediction network: Embedding + 2-layer LSTM
    (reference src/nemo-ggml.cpp:333-344)."""

    embedding: Any      # [vocab, H]
    w_ih: Any           # [2, H, 4H]  (layer, in, 4*hidden) gates [i,f,g,o]
    w_hh: Any           # [2, H, 4H]
    b_ih: Any           # [2, 4H]
    b_hh: Any           # [2, 4H]


@dataclasses.dataclass
class JointParams:
    """Joint network (reference src/nemo-ggml.cpp:347-352)."""

    enc_w: Any   # [D, J]
    enc_b: Any   # [J]
    dec_w: Any   # [H, J]
    dec_b: Any   # [J]
    out_w: Any   # [J, V]
    out_b: Any   # [V]


@dataclasses.dataclass
class PreprocessorParams:
    filterbank: Any   # [n_mels, 257]
    window: Any       # [400]


@dataclasses.dataclass
class CtcParams:
    """The auxiliary CTC head of a hybrid RNNT-CTC checkpoint
    (`ctc_decoder.decoder_layers.0.{weight,bias}`, a 1x1 conv: a Linear
    d_model -> vocab with blank; models/ctc.py decodes with it)."""

    out_w: Any   # [D, V]
    out_b: Any   # [V]


@dataclasses.dataclass
class ModelParams:
    subsampling: SubsamplingParams
    layers: ConformerLayerParams     # stacked [L, ...]
    decoder: DecoderParams
    joint: JointParams
    preprocessor: PreprocessorParams
    ctc: Any = None                  # CtcParams | None (hybrid checkpoints)
    # parallel.mesh.TensorParallel when the layers hold one rank's share of
    # split products (shard_params), None for whole parameters
    tp: Any = None

    @property
    def device(self) -> torch.device:
        return self.joint.out_b.device


_CONTAINERS = (("subsampling", SubsamplingParams),
               ("layers", ConformerLayerParams),
               ("decoder", DecoderParams),
               ("joint", JointParams),
               ("preprocessor", PreprocessorParams),
               ("ctc", CtcParams))


def _containers(params: ModelParams):
    """(name, class) of each container the params hold (the CTC head only
    where there is one)."""
    return [(name, cls) for name, cls in _CONTAINERS
            if getattr(params, name) is not None]


def map_leaves(fn, params: ModelParams) -> ModelParams:
    """Apply `fn` to every leaf: an array, or a QTensor or QTensorW8A8 as a
    whole (a rank's share keeps its TensorParallel)."""
    return ModelParams(**{
        name: cls(**{f.name: fn(getattr(getattr(params, name), f.name))
                     for f in dataclasses.fields(cls)})
        for name, cls in _containers(params)}, tp=params.tp)


def flatten(params: ModelParams) -> dict[str, Any]:
    """Field path -> leaf, e.g. 'layers.ffn1_w1.q' and '.scale' (QTensor) or
    '.col_scale' and, where set, '.act_scale' (QTensorW8A8); the JAX
    package's ModelParams flattens to the same paths in the tests."""
    out = {}
    for name, cls in _containers(params):
        for f in dataclasses.fields(cls):
            x = getattr(getattr(params, name), f.name)
            if type(x) in _QUANT_FIELDS:
                for part in _QUANT_FIELDS[type(x)]:
                    if getattr(x, part) is not None:
                        out[f"{name}.{f.name}.{part}"] = getattr(x, part)
            else:
                out[f"{name}.{f.name}"] = x
    return out


def _map_quant(fn, x):
    """`fn` on the arrays of a QTensor or QTensorW8A8 (int8 values and f32
    scales, the static activation scales too where set), on `x` itself
    otherwise."""
    if isinstance(x, QTensor):
        return QTensor(q=fn(x.q), scale=fn(x.scale))
    if isinstance(x, QTensorW8A8):
        return QTensorW8A8(q=fn(x.q), col_scale=fn(x.col_scale),
                           act_scale=None if x.act_scale is None
                           else fn(x.act_scale))
    return fn(x)


def to_device(params: ModelParams, device) -> ModelParams:
    """numpy or torch leaves -> torch tensors on `device` (dtypes kept)."""
    device = torch.device(device)

    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return map_leaves(lambda x: _map_quant(conv, x), params)


def cast_params(params: ModelParams, dtype) -> ModelParams:
    """Cast every floating-point leaf to `dtype` (bf16 for serving).
    Quantized leaves are left as they are: int8 values and f32 scales
    (nemotron_tpu/params.py:707-729)."""
    def cast(x):
        if isinstance(x, (QTensor, QTensorW8A8)) or not x.is_floating_point():
            return x
        return x.to(dtype)

    return map_leaves(cast, params)


_QUANT_LAYER_FIELDS = (
    "ffn1_w1", "ffn1_w2", "ffn2_w1", "ffn2_w2",
    "attn_q_w", "attn_k_w", "attn_v_w", "attn_pos_w", "attn_out_w",
    "conv_pw1_w", "conv_pw2_w",
)


def quantize_model_params(params: ModelParams,
                          mode: str = "q8_0") -> ModelParams:
    """Quantize the encoder conformer matmul weights (the reference's
    default quant pattern; nemotron_tpu/params.py:275-308). Subsampling,
    depthwise convs, norms, decoder and joint stay dense.

    mode 'q8_0': weight-only Q8_0 blocks; 'w8a8': per-column int8 weights
    with per-row activation scales. A weight already quantized the other
    way is dequantized in f32 first (a Q8_0 GGUF served as W8A8). The
    quantization runs on the host in numpy, as the JAX package's does, and
    the result goes to the params' device. An unknown mode raises
    KeyError."""
    quantize = {"q8_0": quantize_tensor, "w8a8": quantize_tensor_w8a8}[mode]

    def host(a) -> np.ndarray:
        return a.detach().to(torch.float32).cpu().numpy()

    layers = params.layers
    updates = {}
    for f in _QUANT_LAYER_FIELDS:
        w = getattr(layers, f)
        if isinstance(w, QTensor):
            if mode == "q8_0":
                continue
            *lead, n_in, n_out = w.q.shape
            w = (host(w.q).reshape(*lead, n_in // 32, 32, n_out)
                 * host(w.scale)[..., :, None, :]).reshape(w.q.shape)
        elif isinstance(w, QTensorW8A8):
            if mode == "w8a8":
                continue
            w = host(w.q) * host(w.col_scale)[..., None, :]
        else:
            w = host(w)
        updates[f] = _map_quant(lambda a: torch.from_numpy(a).to(
            params.device), quantize(w))
    return dataclasses.replace(
        params, layers=dataclasses.replace(layers, **updates))


# ---------------------------------------------------------------------------
# name -> array dict -> parameters
# ---------------------------------------------------------------------------

def _conv2d_hwio(w: np.ndarray) -> np.ndarray:
    """PyTorch OIHW [O, I, kT, kF] -> HWIO [kT, kF, I, O]."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _linear(w):
    """PyTorch [out, in] -> [in, out]. QTensor-aware: Q8_0 blocks run along
    the contiguous (in) dim in GGUF, which becomes the contraction-dim
    blocking QTensor expects after the transpose."""
    if isinstance(w, QTensor):
        return QTensor(q=np.ascontiguousarray(w.q.T),
                       scale=np.ascontiguousarray(w.scale.T))
    return np.ascontiguousarray(w.T)


def _stack(xs: list):
    if isinstance(xs[0], QTensor):
        return QTensor(q=np.stack([x.q for x in xs]),
                       scale=np.stack([x.scale for x in xs]))
    return np.stack(xs)


def _numpy_params(t: dict, cfg: ModelConfig) -> ModelParams:
    """The parameters as numpy leaves, from the reference's tensor names."""
    sub = SubsamplingParams(
        conv0_w=_conv2d_hwio(t["encoder.pre_encode.conv.0.weight"]),
        conv0_b=t["encoder.pre_encode.conv.0.bias"],
        conv2_w=_conv2d_hwio(t["encoder.pre_encode.conv.2.weight"]),
        conv2_b=t["encoder.pre_encode.conv.2.bias"],
        conv3_w=_conv2d_hwio(t["encoder.pre_encode.conv.3.weight"]),
        conv3_b=t["encoder.pre_encode.conv.3.bias"],
        conv5_w=_conv2d_hwio(t["encoder.pre_encode.conv.5.weight"]),
        conv5_b=t["encoder.pre_encode.conv.5.bias"],
        conv6_w=_conv2d_hwio(t["encoder.pre_encode.conv.6.weight"]),
        conv6_b=t["encoder.pre_encode.conv.6.bias"],
        out_w=_linear(t["encoder.pre_encode.out.weight"]),
        out_b=t["encoder.pre_encode.out.bias"],
    )

    def layer(i: int) -> dict:
        p = f"encoder.layers.{i}"
        dw = t[f"{p}.conv.depthwise_conv.weight"]
        if dw.ndim == 3:
            dw = dw.squeeze(1).T          # raw NeMo (D, 1, K) -> (K, D)
        pw1 = t[f"{p}.conv.pointwise_conv1.weight"]
        if not isinstance(pw1, QTensor) and pw1.ndim == 3:
            pw1 = pw1.squeeze(2)
        pw2 = t[f"{p}.conv.pointwise_conv2.weight"]
        if not isinstance(pw2, QTensor) and pw2.ndim == 3:
            pw2 = pw2.squeeze(2)
        return dict(
            norm_ff1_w=t[f"{p}.norm_feed_forward1.weight"],
            norm_ff1_b=t[f"{p}.norm_feed_forward1.bias"],
            ffn1_w1=_linear(t[f"{p}.feed_forward1.linear1.weight"]),
            ffn1_w2=_linear(t[f"{p}.feed_forward1.linear2.weight"]),
            norm_attn_w=t[f"{p}.norm_self_att.weight"],
            norm_attn_b=t[f"{p}.norm_self_att.bias"],
            attn_q_w=_linear(t[f"{p}.self_attn.linear_q.weight"]),
            attn_k_w=_linear(t[f"{p}.self_attn.linear_k.weight"]),
            attn_v_w=_linear(t[f"{p}.self_attn.linear_v.weight"]),
            attn_pos_w=_linear(t[f"{p}.self_attn.linear_pos.weight"]),
            attn_out_w=_linear(t[f"{p}.self_attn.linear_out.weight"]),
            pos_bias_u=t[f"{p}.self_attn.pos_bias_u"],
            pos_bias_v=t[f"{p}.self_attn.pos_bias_v"],
            norm_conv_w=t[f"{p}.norm_conv.weight"],
            norm_conv_b=t[f"{p}.norm_conv.bias"],
            conv_pw1_w=_linear(pw1),
            conv_dw_w=np.ascontiguousarray(dw),
            conv_ln_w=t[f"{p}.conv.batch_norm.weight"],
            conv_ln_b=t[f"{p}.conv.batch_norm.bias"],
            conv_pw2_w=_linear(pw2),
            norm_ff2_w=t[f"{p}.norm_feed_forward2.weight"],
            norm_ff2_b=t[f"{p}.norm_feed_forward2.bias"],
            ffn2_w1=_linear(t[f"{p}.feed_forward2.linear1.weight"]),
            ffn2_w2=_linear(t[f"{p}.feed_forward2.linear2.weight"]),
            norm_final_w=t[f"{p}.norm_out.weight"],
            norm_final_b=t[f"{p}.norm_out.bias"],
        )

    per_layer = [layer(i) for i in range(cfg.n_layers)]
    layers = ConformerLayerParams(**{
        k: _stack([d[k] for d in per_layer]) for k in per_layer[0]})

    dp = "decoder.prediction"
    decoder = DecoderParams(
        embedding=t[f"{dp}.embed.weight"],
        w_ih=np.stack([_linear(t[f"{dp}.dec_rnn.lstm.weight_ih_l{i}"])
                       for i in (0, 1)]),
        w_hh=np.stack([_linear(t[f"{dp}.dec_rnn.lstm.weight_hh_l{i}"])
                       for i in (0, 1)]),
        b_ih=np.stack([t[f"{dp}.dec_rnn.lstm.bias_ih_l{i}"] for i in (0, 1)]),
        b_hh=np.stack([t[f"{dp}.dec_rnn.lstm.bias_hh_l{i}"] for i in (0, 1)]),
    )
    joint = JointParams(
        enc_w=_linear(t["joint.enc.weight"]),
        enc_b=t["joint.enc.bias"],
        dec_w=_linear(t["joint.pred.weight"]),
        dec_b=t["joint.pred.bias"],
        out_w=_linear(t["joint.joint_net.2.weight"]),
        out_b=t["joint.joint_net.2.bias"],
    )
    pre = PreprocessorParams(
        filterbank=np.ascontiguousarray(
            t["preprocessor.featurizer.fb"].reshape(-1)[: cfg.n_mels * 257]
            .reshape(cfg.n_mels, 257)),
        window=t["preprocessor.featurizer.window"].reshape(-1),
    )
    ctc = None
    cw = "ctc_decoder.decoder_layers.0.weight"
    if cw in t:
        w = t[cw]
        if not isinstance(w, QTensor) and w.ndim == 3:   # 1x1 conv (V, D, 1)
            w = w.squeeze(2)
        ctc = CtcParams(out_w=_linear(w),
                        out_b=t["ctc_decoder.decoder_layers.0.bias"])
    return ModelParams(sub, layers, decoder, joint, pre, ctc)


def params_from_arrays(t: dict, cfg: ModelConfig,
                       device="cuda") -> ModelParams:
    """Build the parameters on `device` from a name -> array dict using the
    reference's tensor names (values: numpy arrays, or QTensors of numpy
    arrays for quantized weights)."""
    return to_device(_numpy_params(t, cfg), resolve_device(device))


def params_from_jax_arrays(flat: dict, cfg: ModelConfig,
                           device="cuda") -> ModelParams:
    """Carry the JAX package's ModelParams across onto `device` (the card
    unless the caller asks for the CPU): `flat` maps each field path of the
    JAX pytree ('layers.ffn1_w1', or 'layers.ffn1_w1.q' with '.scale' for a
    QTensor or '.col_scale' for a QTensorW8A8) to a numpy array. The CTC
    head ('ctc.out_w', 'ctc.out_b') comes along where `flat` has it."""
    del cfg  # the shapes are in the arrays
    device = resolve_device(device)
    groups = {}
    for name, cls in _CONTAINERS:
        if name == "ctc" and "ctc.out_w" not in flat:
            continue
        fields = {}
        for f in dataclasses.fields(cls):
            key = f"{name}.{f.name}"
            if key in flat:
                fields[f.name] = np.asarray(flat[key])
            elif f"{key}.scale" in flat:
                fields[f.name] = QTensor(q=np.asarray(flat[f"{key}.q"]),
                                         scale=np.asarray(flat[f"{key}.scale"]))
            elif f"{key}.col_scale" in flat:
                act = flat.get(f"{key}.act_scale")
                fields[f.name] = QTensorW8A8(
                    q=np.asarray(flat[f"{key}.q"]),
                    col_scale=np.asarray(flat[f"{key}.col_scale"]),
                    act_scale=None if act is None
                    else np.asarray(act, np.float32))
            else:
                raise KeyError(f"missing parameter {key}")
        groups[name] = cls(**fields)
    return to_device(ModelParams(**groups), device)


def load_model(path: str, device="cuda", keep_quantized: bool = True,
               use_native: bool | str = "auto",
               ) -> tuple[ModelParams, ModelConfig, list[str]]:
    """Load a GGUF file onto `device`: (params, config, vocab).

    Runs on the card unless the caller asks for the CPU, and raises when
    CUDA is asked for and absent. Mirrors the reference loader's hparam
    handling, including inferring kernel_size from the depthwise weight
    (reference src/nemo-ggml.cpp:320-324) rather than trusting the stale
    metadata value. A TDT checkpoint's `nemo.tdt_durations` becomes
    cfg.tdt_durations (its joint then emits V + len(durations) logits, the
    trailing ones the duration head), and a hybrid checkpoint's
    `ctc_decoder.*` tensors become params.ctc. With keep_quantized (the
    default), Q8_0 and Q4_0
    encoder matmul weights stay int8 plus per-block f32 scales (QTensor),
    bit-identical to the file's blocks, and go through the Q8 kernel;
    without it every tensor is dequantized to dense f32 (what SmoothQuant
    folds; nemotron_tpu/params.py:311-333). use_native: gguf.read_gguf's
    (the mmap loader when it builds, as the JAX package's load_model
    reads); the parameters are the same with it and without it."""
    device = resolve_device(device)
    return model_from_gguf(gguf_mod.read_gguf(path, use_native=use_native),
                           device, keep_quantized)


def model_from_gguf(g, device, keep_quantized: bool = True,
                    ) -> tuple[ModelParams, ModelConfig, list[str]]:
    """load_model on a GGUF already read (gguf.read_gguf), for a caller
    that also reads its tensors: (params, config, vocab) on `device`."""
    md = g.metadata

    def u32(key, default):
        return int(md.get(key, default))

    arrays: dict[str, object] = {}
    for name, tt in g.tensors.items():
        quantized_2d = (
            keep_quantized
            and tt.ggml_type in (gguf_mod.GGML_Q8_0, gguf_mod.GGML_Q4_0)
            and len(tt.shape) == 2 and tt.shape[1] % 32 == 0
            and should_quantize(name, np.empty((0, 0))))
        if quantized_2d:
            unpack = (gguf_mod.q8_0_to_int8
                      if tt.ggml_type == gguf_mod.GGML_Q8_0
                      else gguf_mod.q4_0_to_int8)
            vals, scales = unpack(tt.raw, tt.n_elements)
            arrays[name] = QTensor(
                q=vals.reshape(tt.shape),
                scale=scales.reshape(tt.shape[0], tt.shape[1] // 32))
        else:
            arrays[name] = tt.to_numpy()
    dw = arrays.get("encoder.layers.0.conv.depthwise_conv.weight")
    kernel_size = 9
    if dw is not None:
        kernel_size = dw.shape[0] if dw.ndim == 2 else dw.shape[-1]

    # Dims the GGUF metadata doesn't carry (or carries stale -- the reference
    # hardcodes decoder dims, src/nemo-ggml.h:130-133) come from weight shapes.
    emb = arrays["decoder.prediction.embed.weight"]
    cfg = ModelConfig(
        n_mels=u32("nemo.n_mels", 128),
        d_model=u32("nemo.d_model", 1024),
        n_heads=u32("nemo.n_heads", 8),
        d_head=u32("nemo.d_head", 128),
        d_ff=u32("nemo.d_ff", 4096),
        n_layers=u32("nemo.n_layers", 24),
        kernel_size=kernel_size,
        vocab_size=u32("nemo.vocab_size", emb.shape[0]),
        decoder_dim=emb.shape[1],
        joint_dim=arrays["joint.enc.weight"].shape[0],
        subsampling_channels=arrays["encoder.pre_encode.conv.0.weight"].shape[0],
    )
    td = md.get("nemo.tdt_durations")
    if td:  # TDT checkpoint: the trailing joint logits are the duration head
        cfg = dataclasses.replace(
            cfg, tdt_durations=tuple(int(x) for x in td))

    vocab_blob = md.get("tokenizer.vocab", b"")
    if isinstance(vocab_blob, str):
        vocab_blob = vocab_blob.encode("utf-8", errors="surrogateescape")
    vocab = gguf_mod.decode_vocab(vocab_blob, cfg.vocab_size) if vocab_blob else []
    return params_from_arrays(arrays, cfg, device), cfg, vocab


def params_to_arrays(params: ModelParams, cfg: ModelConfig,
                     ) -> dict[str, np.ndarray]:
    """Inverse of params_from_arrays (nemotron_tpu/params.py:382-475): the
    parameters as reference-named f32 numpy arrays in the PyTorch layouts,
    conv weights in the converter's 2-D storage, ready for
    gguf.write_gguf. Quantized leaves are dequantized first (Q8_0 as
    q * scale, W8A8 as q * col_scale, in f32)."""
    def dense(w) -> np.ndarray:
        if isinstance(w, QTensor):
            *lead, n_in, n_out = w.q.shape
            w = (w.q.to(torch.float32).reshape(*lead, n_in // 32, 32, n_out)
                 * w.scale.to(torch.float32)[..., :, None, :]
                 ).reshape(w.q.shape)
        elif isinstance(w, QTensorW8A8):
            w = w.q.to(torch.float32) * w.col_scale.to(torch.float32)[
                ..., None, :]
        return w.detach().to("cpu", torch.float32).numpy()

    def lin(w) -> np.ndarray:      # [in, out] -> [out, in]
        return np.ascontiguousarray(dense(w).T)

    def conv(w) -> np.ndarray:     # HWIO -> OIHW
        return np.ascontiguousarray(dense(w).transpose(3, 2, 0, 1))

    t: dict[str, np.ndarray] = {}
    s = params.subsampling
    for i, (wf, bf) in ((0, ("conv0_w", "conv0_b")),
                        (2, ("conv2_w", "conv2_b")),
                        (3, ("conv3_w", "conv3_b")),
                        (5, ("conv5_w", "conv5_b")),
                        (6, ("conv6_w", "conv6_b"))):
        t[f"encoder.pre_encode.conv.{i}.weight"] = conv(getattr(s, wf))
        t[f"encoder.pre_encode.conv.{i}.bias"] = dense(getattr(s, bf))
    t["encoder.pre_encode.out.weight"] = lin(s.out_w)
    t["encoder.pre_encode.out.bias"] = dense(s.out_b)

    for i in range(cfg.n_layers):
        lp = params.layers.layer(i)
        p = f"encoder.layers.{i}"
        t[f"{p}.norm_feed_forward1.weight"] = dense(lp.norm_ff1_w)
        t[f"{p}.norm_feed_forward1.bias"] = dense(lp.norm_ff1_b)
        t[f"{p}.feed_forward1.linear1.weight"] = lin(lp.ffn1_w1)
        t[f"{p}.feed_forward1.linear2.weight"] = lin(lp.ffn1_w2)
        t[f"{p}.norm_self_att.weight"] = dense(lp.norm_attn_w)
        t[f"{p}.norm_self_att.bias"] = dense(lp.norm_attn_b)
        t[f"{p}.self_attn.linear_q.weight"] = lin(lp.attn_q_w)
        t[f"{p}.self_attn.linear_k.weight"] = lin(lp.attn_k_w)
        t[f"{p}.self_attn.linear_v.weight"] = lin(lp.attn_v_w)
        t[f"{p}.self_attn.linear_pos.weight"] = lin(lp.attn_pos_w)
        t[f"{p}.self_attn.linear_out.weight"] = lin(lp.attn_out_w)
        t[f"{p}.self_attn.pos_bias_u"] = dense(lp.pos_bias_u)
        t[f"{p}.self_attn.pos_bias_v"] = dense(lp.pos_bias_v)
        t[f"{p}.norm_conv.weight"] = dense(lp.norm_conv_w)
        t[f"{p}.norm_conv.bias"] = dense(lp.norm_conv_b)
        t[f"{p}.conv.pointwise_conv1.weight"] = lin(lp.conv_pw1_w)
        t[f"{p}.conv.depthwise_conv.weight"] = dense(lp.conv_dw_w)
        t[f"{p}.conv.batch_norm.weight"] = dense(lp.conv_ln_w)
        t[f"{p}.conv.batch_norm.bias"] = dense(lp.conv_ln_b)
        t[f"{p}.conv.pointwise_conv2.weight"] = lin(lp.conv_pw2_w)
        t[f"{p}.norm_feed_forward2.weight"] = dense(lp.norm_ff2_w)
        t[f"{p}.norm_feed_forward2.bias"] = dense(lp.norm_ff2_b)
        t[f"{p}.feed_forward2.linear1.weight"] = lin(lp.ffn2_w1)
        t[f"{p}.feed_forward2.linear2.weight"] = lin(lp.ffn2_w2)
        t[f"{p}.norm_out.weight"] = dense(lp.norm_final_w)
        t[f"{p}.norm_out.bias"] = dense(lp.norm_final_b)

    dp = "decoder.prediction"
    d = params.decoder
    t[f"{dp}.embed.weight"] = dense(d.embedding)
    for i in (0, 1):
        t[f"{dp}.dec_rnn.lstm.weight_ih_l{i}"] = lin(d.w_ih[i])
        t[f"{dp}.dec_rnn.lstm.weight_hh_l{i}"] = lin(d.w_hh[i])
        t[f"{dp}.dec_rnn.lstm.bias_ih_l{i}"] = dense(d.b_ih[i])
        t[f"{dp}.dec_rnn.lstm.bias_hh_l{i}"] = dense(d.b_hh[i])

    j = params.joint
    t["joint.enc.weight"] = lin(j.enc_w)
    t["joint.enc.bias"] = dense(j.enc_b)
    t["joint.pred.weight"] = lin(j.dec_w)
    t["joint.pred.bias"] = dense(j.dec_b)
    t["joint.joint_net.2.weight"] = lin(j.out_w)
    t["joint.joint_net.2.bias"] = dense(j.out_b)

    pre = params.preprocessor
    t["preprocessor.featurizer.fb"] = dense(pre.filterbank)
    t["preprocessor.featurizer.window"] = dense(pre.window)

    if params.ctc is not None:
        t["ctc_decoder.decoder_layers.0.weight"] = lin(params.ctc.out_w)
        t["ctc_decoder.decoder_layers.0.bias"] = dense(params.ctc.out_b)
    return t


def save_model(path: str, params: ModelParams, cfg: ModelConfig,
               vocab: list[str] | None = None,
               quantize_mode: str | None = None) -> None:
    """Write the parameters to a GGUF that this port, the JAX package and
    the reference loader read (nemotron_tpu/params.py:478-507): dense f32
    tensors, or the encoder matmul weights as Q8_0 / Q4_0 blocks with
    quantize_mode 'q8_0' / 'q4_0'; a TDT config's durations in
    `nemo.tdt_durations`; the CTC head where there is one; vocab entries
    cut to the 7-byte slot (gguf.fit_vocab_token). A rank's share of
    split params (parallel.mesh.shard_params) is gathered first, so the
    file holds the JAX package's global keys and shapes; every rank calls
    it, rank 0 writes."""
    from .parallel.mesh import gather_params, is_writer, sync

    if params.tp is not None:
        params = gather_params(params)
    if not is_writer():
        sync()
        return
    arrays = params_to_arrays(params, cfg)
    meta: dict[str, object] = {"general.architecture": "nemo"}
    if vocab:
        meta["tokenizer.vocab"] = gguf_mod.encode_vocab(
            [gguf_mod.fit_vocab_token(v) for v in vocab])
    meta.update({
        "nemo.n_mels": cfg.n_mels, "nemo.d_model": cfg.d_model,
        "nemo.n_heads": cfg.n_heads, "nemo.d_head": cfg.d_head,
        "nemo.d_ff": cfg.d_ff, "nemo.n_layers": cfg.n_layers,
        "nemo.kernel_size": cfg.kernel_size,
        "nemo.vocab_size": cfg.vocab_size,
    })
    if cfg.tdt_durations:
        meta["nemo.tdt_durations"] = [int(d) for d in cfg.tdt_durations]
    quantize = {}
    if quantize_mode:
        gtype = {"q8_0": gguf_mod.GGML_Q8_0,
                 "q4_0": gguf_mod.GGML_Q4_0}[quantize_mode]
        quantize = {n: gtype for n, a in arrays.items()
                    if should_quantize(n, a)}
    gguf_mod.write_gguf(path, meta, arrays, quantize=quantize)
    sync()


def parse_boost_spec(spec: str) -> dict:
    """The CLIs' `--boost=piece:weight,...` as the dict `apply_logit_bias`
    takes (nemotron_tpu/params.py:643-657): a piece is a vocab string (with
    or without the SentencePiece prefix) or an integer token id."""
    bias: dict = {}
    for item in spec.split(","):
        key, _, w = item.rpartition(":")
        if not key:
            raise ValueError(f"bad --boost item {item!r} "
                             "(want piece:weight)")
        try:
            bias[int(key)] = float(w)
        except ValueError:
            bias[key] = float(w)
    return bias


def apply_logit_bias(params: ModelParams, bias,
                     vocab: list[str] | None = None) -> ModelParams:
    """Contextual biasing ("hotword boosting"): params whose joint emits
    logits + bias (nemotron_tpu/params.py:660-700). The bias is folded into
    the joint's output bias in f32 on the params' device, which adds it to
    every decode step's logits: greedy, beam, the engines and confidence
    alike.

    bias: a full [vocab] array, or a dict mapping a token id (int) or a
    vocab piece (str, matched exactly or with the "▁" prefix) to a
    log-space boost. An unknown piece raises ValueError."""
    out_b = params.joint.out_b.detach().to("cpu", torch.float32).numpy()
    out_b = out_b.copy()
    if isinstance(bias, dict):
        for key, w in bias.items():
            if isinstance(key, str):
                if vocab is None:
                    raise ValueError("string keys need the vocab")
                if key in vocab:
                    idx = vocab.index(key)
                elif "▁" + key in vocab:
                    idx = vocab.index("▁" + key)
                else:
                    raise ValueError(f"piece {key!r} not in the vocab")
            else:
                idx = int(key)
            out_b[idx] += float(w)
    else:
        b = np.asarray(bias, np.float32)
        if b.shape != out_b.shape:
            raise ValueError(f"bias shape {b.shape} != vocab "
                             f"{out_b.shape}")
        out_b = out_b + b
    return dataclasses.replace(params, joint=dataclasses.replace(
        params.joint, out_b=torch.from_numpy(out_b).to(params.device)))


# ---------------------------------------------------------------------------
# Random init (tests and the chip smoke run, when no real GGUF is at hand)
# ---------------------------------------------------------------------------

def random_weight_arrays(cfg: ModelConfig, seed: int = 0,
                         scale: float = 0.05, init: str = "bench",
                         ctc_head: bool = False) -> dict[str, np.ndarray]:
    """Random weights in the *reference's* name/shape convention
    (docs/TENSOR_SHAPES.md), so they round-trip through GGUF, norms at
    identity. The same numbers as the JAX package's `random_weight_arrays`
    for the same seed and init (nemotron_tpu/params.py:514-632):

      'bench'  -- every weight ~ N(0, scale^2).
      'glorot' -- fan-scaled Glorot/Xavier (std = sqrt(2 / (fan_in +
                  fan_out)), conv fans include the kernel taps), zero
                  biases, LSTM forget-gate biases 1.0: what training from
                  scratch needs (the flat 0.05 starves the subsampling
                  convs, fan_in 9).

    A TDT config widens the joint's output by its duration head; ctc_head
    adds a hybrid checkpoint's CTC head (drawn last, as JAX draws it)."""
    if init not in ("bench", "glorot"):
        raise ValueError(f"unknown init {init!r} (bench | glorot)")
    rng = np.random.default_rng(seed)
    D, FF, H, DH = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.d_head
    V, DD = cfg.vocab_size, cfg.decoder_dim
    K = cfg.kernel_size

    def w(*shape):
        if init == "glorot":
            if len(shape) == 1:
                return np.zeros(shape, dtype=np.float32)   # biases
            if len(shape) == 2:                            # [out, in]
                fan_in, fan_out = shape[1], shape[0]
            else:                                          # [Co, Ci, *k]
                rf = int(np.prod(shape[2:]))
                fan_in, fan_out = shape[1] * rf, shape[0] * rf
            std = np.sqrt(2.0 / (fan_in + fan_out))
            return rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(std)
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    def ones(*shape):
        return np.ones(shape, dtype=np.float32)

    def zeros(*shape):
        return np.zeros(shape, dtype=np.float32)

    t: dict[str, np.ndarray] = {}
    C = cfg.subsampling_channels
    t["encoder.pre_encode.conv.0.weight"] = w(C, 1, 3, 3)
    t["encoder.pre_encode.conv.0.bias"] = w(C)
    t["encoder.pre_encode.conv.2.weight"] = w(C, 1, 3, 3)
    t["encoder.pre_encode.conv.2.bias"] = w(C)
    t["encoder.pre_encode.conv.3.weight"] = w(C, C, 1, 1)
    t["encoder.pre_encode.conv.3.bias"] = w(C)
    t["encoder.pre_encode.conv.5.weight"] = w(C, 1, 3, 3)
    t["encoder.pre_encode.conv.5.bias"] = w(C)
    t["encoder.pre_encode.conv.6.weight"] = w(C, C, 1, 1)
    t["encoder.pre_encode.conv.6.bias"] = w(C)
    t["encoder.pre_encode.out.weight"] = w(D, cfg.pre_encode_out_dim)
    t["encoder.pre_encode.out.bias"] = w(D)

    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}"
        t[f"{p}.norm_feed_forward1.weight"] = ones(D)
        t[f"{p}.norm_feed_forward1.bias"] = zeros(D)
        t[f"{p}.feed_forward1.linear1.weight"] = w(FF, D)
        t[f"{p}.feed_forward1.linear2.weight"] = w(D, FF)
        t[f"{p}.norm_self_att.weight"] = ones(D)
        t[f"{p}.norm_self_att.bias"] = zeros(D)
        t[f"{p}.self_attn.linear_q.weight"] = w(D, D)
        t[f"{p}.self_attn.linear_k.weight"] = w(D, D)
        t[f"{p}.self_attn.linear_v.weight"] = w(D, D)
        t[f"{p}.self_attn.linear_pos.weight"] = w(D, D)
        t[f"{p}.self_attn.linear_out.weight"] = w(D, D)
        t[f"{p}.self_attn.pos_bias_u"] = w(H, DH)
        t[f"{p}.self_attn.pos_bias_v"] = w(H, DH)
        t[f"{p}.norm_conv.weight"] = ones(D)
        t[f"{p}.norm_conv.bias"] = zeros(D)
        t[f"{p}.conv.pointwise_conv1.weight"] = w(2 * D, D, 1)
        t[f"{p}.conv.depthwise_conv.weight"] = w(D, 1, K)
        t[f"{p}.conv.batch_norm.weight"] = ones(D)
        t[f"{p}.conv.batch_norm.bias"] = zeros(D)
        t[f"{p}.conv.pointwise_conv2.weight"] = w(D, D, 1)
        t[f"{p}.norm_feed_forward2.weight"] = ones(D)
        t[f"{p}.norm_feed_forward2.bias"] = zeros(D)
        t[f"{p}.feed_forward2.linear1.weight"] = w(FF, D)
        t[f"{p}.feed_forward2.linear2.weight"] = w(D, FF)
        t[f"{p}.norm_out.weight"] = ones(D)
        t[f"{p}.norm_out.bias"] = zeros(D)

    dp = "decoder.prediction"
    t[f"{dp}.embed.weight"] = w(V, DD)
    for i in (0, 1):
        t[f"{dp}.dec_rnn.lstm.weight_ih_l{i}"] = w(4 * DD, DD)
        t[f"{dp}.dec_rnn.lstm.weight_hh_l{i}"] = w(4 * DD, DD)
        t[f"{dp}.dec_rnn.lstm.bias_ih_l{i}"] = w(4 * DD)
        t[f"{dp}.dec_rnn.lstm.bias_hh_l{i}"] = w(4 * DD)
    if init == "glorot":
        for i in (0, 1):
            # forget-gate bias 1.0 (gate order [i, f, g, o], ops/lstm.py)
            t[f"{dp}.dec_rnn.lstm.bias_ih_l{i}"][DD:2 * DD] = 1.0

    t["joint.enc.weight"] = w(cfg.joint_dim, D)
    t["joint.enc.bias"] = w(cfg.joint_dim)
    t["joint.pred.weight"] = w(cfg.joint_dim, DD)
    t["joint.pred.bias"] = w(cfg.joint_dim)
    V_out = V + len(cfg.tdt_durations or ())
    t["joint.joint_net.2.weight"] = w(V_out, cfg.joint_dim)
    t["joint.joint_net.2.bias"] = w(V_out)

    t["preprocessor.featurizer.fb"] = np.abs(w(cfg.n_mels, 257))
    t["preprocessor.featurizer.window"] = np.hanning(400).astype(np.float32)
    if ctc_head:
        t["ctc_decoder.decoder_layers.0.weight"] = w(V, D)
        t["ctc_decoder.decoder_layers.0.bias"] = w(V)
    return t
