"""What the evaluation entry points share: token edit distance, token error
rate against a truth, the tones fixtures' labels of a vocabulary piece or
a transcript, the fixtures' directory, the entry points' device, their
`--json` writer, and what the oracle tools share (a GGUF's dense model
beside the tensors the numpy oracle reads, loaded once for a run of
several tools; tensors to the host; the positional arguments).

Each JAX script under `scripts/` carries its own copy of these helpers
(scripts/token_agreement.py:47-59, scripts/beam_quality.py:34-45,
scripts/tdt_quality.py:31-39, scripts/emission_delay.py:80-84); the
port keeps one.
"""

from __future__ import annotations

import contextlib
import json
import os

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


# dense_model's loads while a sharing_loads block lasts, by (file, device)
_LOADS: dict | None = None


@contextlib.contextmanager
def sharing_loads():
    """Within the block, dense_model loads each GGUF once for each device
    (a file rewritten in between is read anew): the oracle tools that run
    one after another in one process share the load. A nested block shares
    the outermost one's."""
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
