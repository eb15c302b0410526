"""Convert a NeMo checkpoint to GGUF (reference scripts/convert_to_gguf.py).
The counterpart of `scripts/convert_to_gguf.py`:

    python -m nemotron_tpu_torch.scripts.convert_to_gguf
        <model.nemo | model_weights.ckpt> <out.gguf>
        [--quantize q8_0|q4_0] [--vocab vocab.txt] [--cpu]

Accepts either a .nemo tar archive (containing model_config.yaml,
model_weights.ckpt and a tokenizer .model/.vocab) or a bare torch checkpoint.
Reproduces the reference converter's storage conventions so the output is
readable by both packages and the reference C++ loader, byte for byte the
JAX script's file:

  - conv weight 2D reshapes: pointwise_conv [D,D,1] -> [D,D] squeeze,
    depthwise_conv [D,1,K] -> [K,D] squeeze+transpose
    (reference scripts/convert_to_gguf.py:196-209, 322-336)
  - vocab as fixed 8-byte NUL-padded entries in tokenizer.vocab
    (reference scripts/convert_to_gguf.py:252-260)
  - nemo.* metadata keys incl. the reference's stale kernel_size=31 (kept
    for byte-level compatibility; both loaders infer the real kernel from
    the weight shape, reference src/nemo-ggml.cpp:320-324)
  - default quantization pattern: encoder conformer-layer matmul weights
    only (reference scripts/convert_to_gguf.py:212-238)

A host tool: it resolves the device as the other entry points do (the
card unless --cpu) and computes nothing there.
"""

from __future__ import annotations

import os
import sys
import tarfile
import tempfile

import numpy as np
import torch

from .. import gguf
from ..ops.quant import should_quantize
from ._common import device_of, positionals


def load_checkpoint(path: str):
    """Returns (state_dict as name->np.ndarray f32, vocab list or None,
    config dict or {})."""
    vocab = None
    config = {}
    ckpt_path = path

    with tempfile.TemporaryDirectory(prefix="nemo_extract_") as tmpdir:
        if path.endswith(".nemo") or tarfile.is_tarfile(path):
            with tarfile.open(path) as tar:
                tar.extractall(tmpdir, filter="data")
            for root, _dirs, files in os.walk(tmpdir):
                for f in files:
                    full = os.path.join(root, f)
                    if f.endswith(".ckpt"):
                        ckpt_path = full
                    elif f == "model_config.yaml":
                        try:
                            import yaml

                            with open(full) as fh:
                                config = yaml.safe_load(fh)
                        except ImportError:
                            print("warning: pyyaml unavailable, skipping "
                                  "config", file=sys.stderr)
                    elif f.endswith(".vocab"):
                        with open(full, encoding="utf-8") as fh:
                            vocab = [line.split("\t")[0] for line in fh]

        sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    arrays = {}
    for name, t in sd.items():
        if not hasattr(t, "numpy"):
            continue
        arrays[name] = t.to(dtype=torch.float32).numpy()
    return arrays, vocab, config


def convert_conv_weights(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Reference conv-weight 2D storage (scripts/convert_to_gguf.py:196-209)."""
    out = {}
    for name, a in arrays.items():
        if name.endswith(".conv.depthwise_conv.weight") and a.ndim == 3:
            a = np.ascontiguousarray(a.squeeze(1).T)   # [D,1,K] -> [K,D]
        elif name.endswith((".conv.pointwise_conv1.weight",
                            ".conv.pointwise_conv2.weight")) and a.ndim == 3:
            a = np.ascontiguousarray(a.squeeze(2))     # [O,I,1] -> [O,I]
        out[name] = a
    return out


def infer_metadata(arrays: dict[str, np.ndarray], config: dict) -> dict:
    enc = config.get("encoder", {}) if isinstance(config, dict) else {}
    d_model = int(enc.get("d_model",
                          arrays["encoder.pre_encode.out.weight"].shape[0]))
    pbu = arrays.get("encoder.layers.0.self_attn.pos_bias_u")
    n_heads = int(enc.get("n_heads",
                          pbu.shape[0] if pbu is not None else 8))
    n_layers = len({n.split(".")[2] for n in arrays
                    if n.startswith("encoder.layers.")})
    ffw = arrays.get("encoder.layers.0.feed_forward1.linear1.weight")
    fb = arrays.get("preprocessor.featurizer.fb")
    emb = arrays.get("decoder.prediction.embed.weight")
    return {
        "general.architecture": "nemo",
        "general.name": "nemotron-speech-streaming",
        "nemo.n_mels": int(fb.shape[0]) if fb is not None else 128,
        "nemo.d_model": d_model,
        "nemo.n_heads": n_heads,
        "nemo.d_head": d_model // n_heads if n_heads else 128,
        "nemo.d_ff": int(ffw.shape[0]) if ffw is not None else 4096,
        "nemo.n_layers": n_layers or 24,
        # stale on purpose -- matches the reference converter's output; both
        # loaders infer the real kernel size from the weight shape
        "nemo.kernel_size": 31,
        "nemo.vocab_size": int(emb.shape[0]) if emb is not None else 1025,
    }


def read_vocab_file(path: str) -> list[str]:
    """A vocab file's tokens: the first tab-separated field of each line."""
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n").split("\t")[0] for line in f]


def main(argv: list[str]) -> int:
    args = positionals(argv, ("--quantize", "--vocab"))
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    device_of("--cpu" in argv)
    src, dst = args[0], args[1]
    quant_mode = None
    if "--quantize" in argv:
        quant_mode = argv[argv.index("--quantize") + 1].lower()
    vocab_path = None
    if "--vocab" in argv:
        vocab_path = argv[argv.index("--vocab") + 1]

    arrays, vocab, config = load_checkpoint(src)
    if vocab_path:
        vocab = read_vocab_file(vocab_path)
    arrays = convert_conv_weights(arrays)
    meta = infer_metadata(arrays, config)

    if vocab is not None:
        if len(vocab) == meta["nemo.vocab_size"] - 1:
            vocab = vocab + ["<blank>"]
        meta["tokenizer.vocab"] = gguf.encode_vocab(
            [gguf.fit_vocab_token(v) for v in vocab])
    else:
        print("warning: no vocab found; GGUF will lack tokenizer.vocab",
              file=sys.stderr)

    quantize = {}
    if quant_mode:
        gtype = {"q8_0": gguf.GGML_Q8_0, "q4_0": gguf.GGML_Q4_0}[quant_mode]
        for name, a in arrays.items():
            if should_quantize(name, a):
                quantize[name] = gtype

    gguf.write_gguf(dst, meta, arrays, quantize=quantize)
    total = sum(a.nbytes for a in arrays.values())
    print(f"wrote {dst}: {len(arrays)} tensors, "
          f"{os.path.getsize(dst) / 1e6:.1f} MB "
          f"(f32 equivalent {total / 1e6:.1f} MB, "
          f"{len(quantize)} quantized {quant_mode or ''})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
