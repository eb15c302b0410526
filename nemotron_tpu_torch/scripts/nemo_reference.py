"""NeMo's own cache-aware streaming inference as ground truth, with
per-module dumps.

The port's counterpart of scripts/nemo_reference.py: run NVIDIA NeMo's
cache-aware model on an audio file with forward hooks on the subsampling
(`pre_encode_out`) and every encoder layer (`layer_NN_out`), each writing
its output through `utils.dump.DumpTracer` -- the names and format of a
`StreamSession(trace_dir=...)` capture -- so that
`python -m nemotron_tpu_torch.scripts.compare_tensors` can diff NeMo
against the port. Prints NeMo's transcript.

    python -m nemotron_tpu_torch.scripts.nemo_reference <model.nemo>
        <audio.wav|pcm> [--dump-dir DIR] [--right-context R] [--cpu]

Needs the `nemo_toolkit` package, which this repository does not install:
without it the script exits 3 with a message. It targets the cache-aware
streaming API of nemo_toolkit >= 1.20 (`ASRModel.restore_from`,
`encoder.set_default_att_context_size`, `register_forward_hook` on the
layers and on `pre_encode`, `model.transcribe`); check those names against
the installed version before trusting the dumps. The model is restored
onto the card unless --cpu (`map_location`); the JAX script restores it
onto the CPU.
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.dump import DumpTracer
from ._common import device_of, opt, positionals


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    device = device_of("--cpu" in argv)
    try:
        import torch
        from nemo.collections.asr.models import ASRModel
    except ImportError:
        print("nemo_toolkit is not installed; this tool runs NeMo as the "
              "ground truth on a machine that has it.", file=sys.stderr)
        return 3

    args = positionals(argv, ("--dump-dir", "--right-context"))
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    dump_dir = opt(argv, "--dump-dir", "nemo_dumps", str)
    R = opt(argv, "--right-context", 13, int)

    tracer = DumpTracer(dump_dir)
    model = ASRModel.restore_from(args[0], map_location=str(device))
    model.eval()
    model.encoder.set_default_att_context_size([70, R])

    # every encoder layer's output and the subsampling's, named as a
    # StreamSession(trace_dir=...) capture names them
    def hook(name):
        def fn(_mod, _inp, out):
            tracer(name, out[0] if isinstance(out, tuple) else out)
        return fn

    for i, layer in enumerate(model.encoder.layers):
        layer.register_forward_hook(hook(f"layer_{i:02d}_out"))
    model.encoder.pre_encode.register_forward_hook(hook("pre_encode_out"))

    if args[1].endswith(".pcm"):
        audio = np.fromfile(args[1], dtype="<i2").astype(np.float32) / 32768.0
    else:
        import soundfile as sf

        audio, sr = sf.read(args[1], dtype="float32")
        if sr != 16000:
            print(f"error: expected 16 kHz audio, got {sr}", file=sys.stderr)
            return 1

    with torch.no_grad():
        text = model.transcribe([audio])[0]
    text = getattr(text, "text", text)
    print(text)
    print(f"dumps written to {dump_dir}/ -- diff against a "
          f"StreamSession(trace_dir=...) run with "
          f"python -m nemotron_tpu_torch.scripts.compare_tensors",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
