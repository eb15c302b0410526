"""Legacy NEMO-binary weight converter (reference scripts/convert_weights.py
parity, SURVEY.md §2.3 "Legacy NEMO-format converter"). The counterpart
of `scripts/convert_weights.py`, through the port's utils/nemo_bin.py.

Converts between the flat "NEMO" v1 binary format (reference
src/reference/ggml_weights.cpp:19-157 — the file the reference's C++ oracle
loads) and this framework's artifacts:

    python -m nemotron_tpu_torch.scripts.convert_weights
        model_weights.ckpt model.bin       # ckpt/.nemo -> bin
        model.gguf model.bin               # gguf -> bin
        model.bin model.gguf               # bin -> gguf
        --info model.bin|model.ckpt        # grouped summary
    --f16        store bin payloads as float16
    --vocab F    tokenizer vocab file for GGUF output (the NEMO bin
                 format carries tensors only, so bin -> gguf needs it
                 for a servable model)
    --cpu        resolve the CPU, not the card (a host tool: nothing is
                 computed on the device)

ckpt -> bin writes the raw state-dict (names and shapes untouched), exactly
what the reference converter produces; a file written here loads in the
reference oracle and vice versa. bin -> gguf runs the same normalization
as convert_to_gguf (conv 2D storage, inferred metadata), producing a
GGUF both packages serve from. The files are byte for byte the JAX
script's.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import gguf
from ..utils.nemo_bin import read_nemo_bin, write_nemo_bin
from ._common import device_of
from .convert_to_gguf import (convert_conv_weights, infer_metadata,
                              load_checkpoint, read_vocab_file)


def load_arrays(path: str) -> tuple[dict[str, np.ndarray], bytes | None]:
    """Load ({name: f32 array}, vocab blob or None) from .bin/.gguf/.ckpt/.nemo.

    The NEMO bin format carries tensors only (reference
    src/reference/ggml_weights.cpp) — vocab survives only GGUF->GGUF."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"NEMO":
        return read_nemo_bin(path), None
    if magic == b"GGUF":
        gf = gguf.read_gguf(path)
        blob = gf.metadata.get("tokenizer.vocab")
        if isinstance(blob, str):
            blob = blob.encode("utf-8", errors="surrogateescape")
        return {name: t.to_numpy() for name, t in gf.tensors.items()}, blob
    arrays, vocab, _config = load_checkpoint(path)
    blob = gguf.encode_vocab([gguf.fit_vocab_token(v) for v in vocab]) \
        if vocab else None
    return arrays, blob


def print_info(arrays: dict[str, np.ndarray]) -> None:
    groups: dict[str, list] = {}
    for name, a in arrays.items():
        groups.setdefault(name.split(".")[0], []).append((name, a))
    total = 0
    for prefix in sorted(groups):
        n_params = sum(a.size for _n, a in groups[prefix])
        total += n_params
        print(f"{prefix}: {len(groups[prefix])} tensors, {n_params:,} params")
        for name, a in groups[prefix][:4]:
            print(f"  {name}: {list(a.shape)}")
        if len(groups[prefix]) > 4:
            print(f"  ... and {len(groups[prefix]) - 4} more")
    print(f"total: {total:,} params "
          f"({total * 4 / 1e6:.1f} MB f32 / {total * 2 / 1e6:.1f} MB f16)")


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="convert_weights", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src")
    ap.add_argument("dst", nargs="?")
    ap.add_argument("--f16", action="store_true")
    ap.add_argument("--info", action="store_true")
    ap.add_argument("--vocab")
    ap.add_argument("--cpu", action="store_true")
    ns = ap.parse_args(argv[1:])
    device_of(ns.cpu)
    if ns.info:
        print_info(load_arrays(ns.src)[0])
        return 0
    if not ns.dst:
        ap.error("dst required unless --info")
    src, dst, f16 = ns.src, ns.dst, ns.f16
    arrays, vocab_blob = load_arrays(src)
    if ns.vocab:
        vocab_blob = gguf.encode_vocab(
            [gguf.fit_vocab_token(v) for v in read_vocab_file(ns.vocab)])
    if dst.endswith(".gguf"):
        arrays = convert_conv_weights(arrays)
        meta = infer_metadata(arrays, {})
        if vocab_blob is not None:
            meta["tokenizer.vocab"] = vocab_blob
        else:
            print("warning: no vocab available (the NEMO bin format carries "
                  "tensors only); pass --vocab FILE for a servable GGUF",
                  file=sys.stderr)
        gguf.write_gguf(dst, meta, arrays)
    else:
        write_nemo_bin(dst, arrays, f16=f16)
    total = sum(a.size for a in arrays.values())
    print(f"wrote {dst}: {len(arrays)} tensors, {total:,} params, "
          f"{os.path.getsize(dst) / 1e6:.1f} MB", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
