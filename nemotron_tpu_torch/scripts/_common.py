"""What the evaluation entry points share: token edit distance, token error
rate against a truth, the tones fixtures' labels of a vocabulary piece or
a transcript, the fixtures' directory, the entry points' device, their
`--json` writer, and what the oracle tools share (a GGUF's dense model
beside the tensors the numpy oracle reads, loaded once for a run of
several tools; tensors to the host; the positional arguments), and what
the bench scripts share (their model, its blank bias, the tick
percentiles, the device sync).

Each JAX script under `scripts/` carries its own copy of these helpers
(scripts/token_agreement.py:47-59, scripts/beam_quality.py:34-45,
scripts/tdt_quality.py:31-39, scripts/emission_delay.py:80-84); the
port keeps one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ..device import resolve_device

# the repository's trained fixtures (weights/tones_tiny*.gguf)
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "weights")


def levenshtein(a, b) -> int:
    """Edit distance between two sequences (insertions, deletions and
    substitutions each cost one)."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def ter(got: list, truths: list) -> float:
    """Token error rate: each stream's edit distance to its truth, summed,
    over the truth's tokens (the WER analogue of the tones task, one token
    a word)."""
    return (sum(levenshtein(g, t) for g, t in zip(got, truths))
            / max(sum(len(t) for t in truths), 1))


def label_of(vocab: list[str], tok_id: int) -> int:
    """The tone label of a tones-fixture piece ("▁T<label>"), -1 for any
    other piece."""
    try:
        return int(vocab[tok_id].replace("▁T", ""))
    except ValueError:
        return -1


def text_labels(text: str) -> list[int]:
    """The tone labels of a transcript's words ("T3 T11 ..."): what the
    beam harnesses read back from transcribe_batch's texts."""
    return [int(w[1:]) for w in text.replace("▁", " ").split()
            if w[1:].isdigit()]


def device_of(cpu: bool) -> torch.device:
    """The entry point's device: the card unless --cpu; raises when the
    card is asked for and absent."""
    return resolve_device("cpu" if cpu else "cuda")


def write_json(path: str | None, obj, **kw) -> None:
    """`obj` as indented JSON to `path` (the --json flag), if given."""
    if path:
        with open(path, "w") as f:
            json.dump(obj, f, indent=1, **kw)


def positionals(argv: list[str], value_flags: tuple = ()) -> list[str]:
    """argv's positional arguments: argv[1:] without its flags and without
    the value that follows each flag of `value_flags`."""
    skip = {i + 1 for i, a in enumerate(argv) if a in value_flags}
    return [a for i, a in enumerate(argv) if i > 0 and i not in skip
            and not a.startswith("--")]


def host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


# dense_model's loads (by file and device) and the bench scripts' weights
# while a sharing_loads block lasts
_LOADS: dict | None = None


@contextlib.contextmanager
def sharing_loads():
    """Within the block, dense_model loads each GGUF once for each device
    (a file rewritten in between is read anew), and bench_params and
    bench_w8a8 make their weights once: the tools that run one after
    another in one process share them. A nested block shares the
    outermost one's."""
    global _LOADS
    if _LOADS is not None:
        yield
        return
    _LOADS = {}
    try:
        yield
    finally:
        _LOADS = None


def dense_model(path: str, device: torch.device):
    """A GGUF as the oracle tools hold it: (params with every tensor
    dequantized to dense f32 on `device`, config, vocab, {name: f32
    array} as the numpy oracle reads the file's tensors, the file as
    gguf.read_gguf gives it). The file is read once; inside sharing_loads
    it is loaded once."""
    from .. import gguf
    from ..params import model_from_gguf

    st = os.stat(path)
    key = (os.path.realpath(path), st.st_mtime_ns, st.st_size, str(device))
    if _LOADS is not None and key in _LOADS:
        return _LOADS[key]
    g = gguf.read_gguf(path)
    params, cfg, vocab = model_from_gguf(g, device, keep_quantized=False)
    model = (params, cfg, vocab,
             {n: t.to_numpy() for n, t in g.tensors.items()}, g)
    if _LOADS is not None:
        _LOADS[key] = model
    return model


# -- the bench scripts --------------------------------------------------------

# the joint's blank bias of every bench script: greedy decode then emits at
# a speech-like rate, ~1 label-loop iteration a frame (bench.py:9-13)
BENCH_BLANK_BIAS = 12.0
# the port's serving cell (ROADMAP, "Parked"): the batch a bench script
# takes where the JAX script names a TPU's batch
SERVING_SLOTS = 64


def bench_config(quick: bool):
    """The bench scripts' model: the published widths, or their --quick
    model (scripts/bench_engine.py:44-46)."""
    from ..config import ModelConfig

    if quick:
        return ModelConfig(n_mels=32, d_model=128, n_heads=8, d_head=16,
                           d_ff=256, n_layers=2, vocab_size=64,
                           decoder_dim=64, joint_dim=64,
                           subsampling_channels=16)
    return ModelConfig()


def bench_params(cfg, device):
    """Seeded random weights (seed 0, as every JAX bench script draws them)
    with the blank-biased joint, as f32 params on `device`; made once for
    each config and device inside a sharing_loads block (bench scripts run
    one after another in one process)."""
    from ..params import params_from_arrays, random_weight_arrays

    key = ("bench", cfg, str(device))
    if _LOADS is not None and key in _LOADS:
        return _LOADS[key]
    arrays = random_weight_arrays(cfg, seed=0)
    arrays["joint.joint_net.2.bias"][cfg.vocab_size - 1] = BENCH_BLANK_BIAS
    params = params_from_arrays(arrays, cfg, device=device)
    if _LOADS is not None:
        _LOADS[key] = params
    return params


def bench_w8a8(base):
    """quantize_model_params(base, "w8a8"), made once for each base inside a
    sharing_loads block."""
    from ..params import quantize_model_params

    key = ("w8a8", id(base))
    if _LOADS is not None and key in _LOADS:
        return _LOADS[key][1]
    params = quantize_model_params(base, mode="w8a8")
    if _LOADS is not None:
        _LOADS[key] = (base, params)     # the base kept alive with its id
    return params


def bench_states(cfg, cc, batch, dtype, device, beam=1) -> tuple:
    """`batch` streams' device state for a bench step: (EncoderState,
    DecoderState, or with beam > 1 the beam's BeamState with room for 4096
    tokens a hypothesis)."""
    from ..models import beam as beam_mod
    from ..models import decoder as dec_mod
    from ..models import encoder as enc_mod

    enc = enc_mod.init_encoder_state(cfg, cc, batch, dtype, device)
    if beam > 1:
        return enc, beam_mod.init_beam_state(cfg, batch, beam, 4096, dtype,
                                             device)
    return enc, dec_mod.init_decoder_state(cfg, batch, dtype, device)


def percentiles(ts) -> dict:
    """p50 / p90 / mean in ms (2 decimals) and the count of a list of
    seconds (scripts/bench_engine.py:57-62)."""
    t = np.asarray(ts) * 1e3
    return {"p50_ms": round(float(np.percentile(t, 50)), 2),
            "p90_ms": round(float(np.percentile(t, 90)), 2),
            "mean_ms": round(float(t.mean()), 2),
            "n": len(ts)}


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU):
    every timed region of a bench script ends here, so a host clock reads
    the work and not its enqueueing."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    """What the JSON's "device" key says: the card's name, or "cpu"."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def opt(argv: list, name: str, default, cast=int):
    """The value after flag `name` in argv, cast, or `default` without the
    flag; a value that does not cast exits 1 with a message, as the JAX
    bench scripts' `opt` does (scripts/bench_cohorts.py:55-63)."""
    if name not in argv:
        return default
    i = argv.index(name) + 1
    raw = argv[i] if i < len(argv) else ""
    try:
        return cast(raw)
    except ValueError:
        print(f"error: invalid value for {name}: {raw!r}", file=sys.stderr)
        raise SystemExit(1)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a parameter or state tree: ModelParams (by
    its flattened leaves, a QTensor's parts each), or any dataclass of
    tensors (EncoderState, DecoderState, BeamState)."""
    from ..params import ModelParams, flatten

    if isinstance(tree, ModelParams):
        leaves = flatten(tree).values()
    else:
        leaves = (getattr(tree, f.name) for f in dataclasses.fields(tree))
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))
