"""A (data, model) mesh over torch.distributed ranks.

The port's counterpart of `nemotron_tpu/parallel/mesh.py`. A JAX mesh is
devices in one process, and GSPMD inserts the collectives from the
shardings. Here the mesh is ONE RANK PER DEVICE in a torch.distributed
process group (NCCL when every rank has a card of its own, gloo
otherwise), and the port writes the collectives out
(parallel/collectives.py):

  - DATA axis: the stream (batch) rows of all device state are split over
    the data ranks. No collective in the step itself; per-stream results
    are gathered over the data axis once a step.
  - MODEL axis: tensor parallelism over the FFN hidden dim and the
    attention heads; a sum over the model axis after w2 and after
    attn_out_w.

Ranks are laid out as JAX reshapes its devices: rank r sits at
(r // model, r % model), so a model group is `model` consecutive ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..ops.quant import QTensor, QTensorW8A8
from ..ops.w8a8_kernel import w8a8_k_tile
from .collectives import gather_along


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) grid of ranks."""

    data: int                 # size of the data axis
    model: int                # size of the model axis
    rank: int
    data_index: int           # this rank's coordinates
    model_index: int
    device: torch.device      # this rank's device
    backend: str              # "nccl" or "gloo"
    data_group: Any           # the ranks that share this model index
    model_group: Any          # the ranks that share this data index

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def row_span(self, n_rows: int) -> tuple[int, int]:
        """The half-open span of the `n_rows` stream rows this rank holds
        (those of its data index)."""
        if n_rows % self.data:
            raise ValueError(f"{n_rows} stream rows not divisible by the "
                             f"data axis ({self.data})")
        k = n_rows // self.data
        return self.data_index * k, (self.data_index + 1) * k


def default_device() -> torch.device:
    """This rank's device: a card of its own where there are enough
    (LOCAL_RANK, else the rank, modulo the cards), else the shared card;
    the CPU without one."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    import os

    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(n_ranks: int, device: str | None = None) -> str:
    """NCCL when every rank can have a card of its own, else gloo (ranks
    sharing a card, or the CPU)."""
    if device == "cpu" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"


def init_world(init_method: str, world_size: int, rank: int,
               backend: str | None = None) -> str:
    """Join (rank 0: create) the process group; returns the backend. A
    world already initialized is left as it is."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or backend_for(world_size)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return backend


def make_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """The mesh over every rank of the process group (a one-rank world in
    this process when none is initialized): data = ranks / model_parallel.
    Raises ValueError when the rank count is not divisible by
    model_parallel (nemotron_tpu/parallel/mesh.py:25-36). Every rank must
    call it, in the same order as its other group creations."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(1, None if device is None
                                            else str(device)),
                                store=dist.HashStore(), world_size=1, rank=0)
    n = dist.get_world_size()
    mp = int(model_parallel)
    if mp < 1 or n % mp:
        raise ValueError(f"{n} devices not divisible by model_parallel="
                         f"{model_parallel}")
    nd = n // mp
    rank = dist.get_rank()
    model_groups = [dist.new_group([d * mp + m for m in range(mp)])
                    for d in range(nd)]
    data_groups = [dist.new_group([d * mp + m for d in range(nd)])
                   for m in range(mp)]
    di, mi = divmod(rank, mp)
    return Mesh(data=nd, model=mp, rank=rank, data_index=di, model_index=mi,
                device=torch.device(device) if device is not None
                else default_device(),
                backend=dist.get_backend(), data_group=data_groups[mi],
                model_group=model_groups[di])


# ---------------------------------------------------------------------------
# parameters over the model axis
# ---------------------------------------------------------------------------

def _pspec_for_param(path: str, ndim: int) -> tuple:
    """Sharding rule for a parameter leaf, by field name, as JAX's
    (nemotron_tpu/parallel/mesh.py:39-65), path '/'-separated.

    Layer params are stacked [L, ...]; dim 0 (layers) is never sharded.
    FFN: w1 [L, D, FF] shards FF, w2 [L, FF, D] shards FF (contracting).
    Attention q/k/v/pos shard the head-packed output dim; out_w shards its
    input dim. QTensor leaves (.../q, .../scale) inherit the parent
    weight's rule; a W8A8 col_scale [L, out] follows the parent's OUT-dim
    rule; a static act_scale [L] stays whole."""
    if path.endswith("/col_scale"):
        parent = _pspec_for_param(path.rsplit("/", 1)[0], 3)
        return (parent[0], parent[-1])
    if path.endswith(("/q", "/scale")):
        path = path.rsplit("/", 1)[0]
    if "ffn" in path and path.endswith("w1"):
        return (None, None, "model")
    if "ffn" in path and path.endswith("w2"):
        return (None, "model", None)
    if path.endswith(("attn_q_w", "attn_k_w", "attn_v_w", "attn_pos_w")):
        return (None, None, "model")
    if path.endswith("attn_out_w"):
        return (None, "model", None)
    if path.endswith(("pos_bias_u", "pos_bias_v")):
        return (None, "model", None)  # [L, H, dh]: shard heads
    if path.endswith("conv_pw1_w"):
        return (None, None, None)  # GLU halves interact; keep replicated
    return (None,) * ndim


# the products whose leaves split together: a pair is split only when
# every leaf of it divides (see param_shardings)
PAIRS = {
    "ffn1": ("ffn1_w1", "ffn1_w2"),
    "ffn2": ("ffn2_w1", "ffn2_w2"),
    "attn": ("attn_q_w", "attn_k_w", "attn_v_w", "attn_pos_w", "attn_out_w",
             "pos_bias_u", "pos_bias_v"),
}


def _parts(x) -> dict:
    """A leaf's arrays by part name ('' for a plain tensor)."""
    if isinstance(x, QTensor):
        return {"q": x.q, "scale": x.scale}
    if isinstance(x, QTensorW8A8):
        parts = {"q": x.q, "col_scale": x.col_scale}
        if x.act_scale is not None:
            parts["act_scale"] = x.act_scale
        return parts
    return {"": x}


def _leaf_axes(field: str, leaf) -> dict:
    """Part name -> the axis JAX's rule shards (None: whole)."""
    out = {}
    for part, a in _parts(leaf).items():
        spec = _pspec_for_param(f"layers/{field}" + (f"/{part}" if part
                                                     else ""), a.dim())
        out[part] = next((i for i, s in enumerate(spec) if s), None)
    return out


def _pair_splits(layers, field_names, mp: int) -> bool:
    """Whether every leaf of a pair splits exactly over `mp` ranks: each
    sharded axis divides, and a dynamic W8A8 weight split along K keeps
    whole activation-scale groups of the unsplit weight (w8a8_k_tile of
    the whole K), so the rank's row amax is the whole weight's."""
    for f in field_names:
        leaf = getattr(layers, f)
        for part, axis in _leaf_axes(f, leaf).items():
            a = _parts(leaf)[part]
            if axis is not None and a.shape[axis] % mp:
                return False
        if isinstance(leaf, QTensorW8A8) and leaf.act_scale is None:
            K = leaf.q.shape[-2]
            if _leaf_axes(f, leaf)["q"] == leaf.q.dim() - 2 and \
                    (K // mp) % w8a8_k_tile(K):
                return False
    return True


def param_shardings(params, mesh: Mesh) -> dict:
    """{'layers.<field>[.<part>]': axis or None} for every layer leaf
    (TP over 'model', replicated over 'data'); every other leaf is whole.

    JAX's rule falls back to replication per leaf when an axis does not
    divide the mesh axis (nemotron_tpu/parallel/mesh.py:70-83), and GSPMD
    repairs any mix of split and whole leaves with its own collectives.
    The port decides per PRODUCT instead: a QTensor or QTensorW8A8 is one
    unit, and (w1, w2) of each FFN and (q/k/v/pos, out, pos_bias_u/v) of
    the attention are pairs. A pair is split only when every leaf of it
    divides (and a dynamic W8A8 weight split along K keeps whole scale
    groups); otherwise every rank computes it whole. On the tiny test
    config (d_ff 96, Q8 blocks of 32) w2's scale axis has 3 blocks, so the
    Q8 FFNs stay whole there."""
    mp = mesh.model
    layers = params.layers
    split = {f: mp > 1 and _pair_splits(layers, fields, mp)
             for fields in PAIRS.values() for f in fields}
    out = {}
    for f in dataclasses.fields(layers):
        leaf = getattr(layers, f.name)
        for part, axis in _leaf_axes(f.name, leaf).items():
            key = f"layers.{f.name}" + (f".{part}" if part else "")
            out[key] = axis if split.get(f.name) else None
    return out


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What the encoder needs to run a rank's share of the layers: the
    model group, and which products are split (the others run whole)."""

    group: Any
    size: int
    index: int
    ffn1: bool
    ffn2: bool
    attn: bool
    n_heads: int             # this rank's attention heads
    axes: dict               # param_shardings' map (the split leaves)


def _slice(a: torch.Tensor, axis: int, size: int, index: int):
    n = a.shape[axis] // size
    return a.narrow(axis, index * n, n).clone(
        memory_format=torch.contiguous_format)


def shard_params(params, mesh: Mesh):
    """This rank's share of `params`: every split leaf sliced to the
    rank's part of its axis (QTensor q/scale and QTensorW8A8
    q/col_scale/act_scale alike), the others whole, on the mesh's device;
    the result carries a TensorParallel (`params.tp`) when a product is
    split, None otherwise."""
    from ..params import ModelParams, to_device

    axes = param_shardings(params, mesh)
    mp, mi = mesh.model, mesh.model_index

    def one(field, leaf):
        def cut(part, a):
            axis = axes[f"layers.{field}" + (f".{part}" if part else "")]
            return a if axis is None else _slice(a, axis, mp, mi)
        if isinstance(leaf, QTensor):
            return QTensor(q=cut("q", leaf.q), scale=cut("scale", leaf.scale))
        if isinstance(leaf, QTensorW8A8):
            return QTensorW8A8(
                q=cut("q", leaf.q), col_scale=cut("col_scale",
                                                  leaf.col_scale),
                act_scale=None if leaf.act_scale is None
                else cut("act_scale", leaf.act_scale))
        return cut("", leaf)

    layers = params.layers
    local = dataclasses.replace(layers, **{
        f.name: one(f.name, getattr(layers, f.name))
        for f in dataclasses.fields(layers)})
    split = {name: axes[f"layers.{fields[0]}" + (
        ".q" if isinstance(getattr(layers, fields[0]),
                           (QTensor, QTensorW8A8)) else "")] is not None
        for name, fields in PAIRS.items()}
    tp = None
    if any(split.values()):
        tp = TensorParallel(group=mesh.model_group, size=mp, index=mi,
                            ffn1=split["ffn1"], ffn2=split["ffn2"],
                            attn=split["attn"],
                            n_heads=local.pos_bias_u.shape[1], axes=axes)
    out = dataclasses.replace(params, layers=local, tp=tp)
    return to_device(out, mesh.device) if out.device != mesh.device else out


def gather_param(x: torch.Tensor, key: str, tp) -> torch.Tensor:
    """The whole leaf `key` (a flatten() key) from its shards over the
    model axis; a whole leaf as it is."""
    axis = None if tp is None else tp.axes.get(key)
    if axis is None:
        return x
    return gather_along(x, axis, tp.group, tp.size, tp.index)


def slice_param(x: torch.Tensor, key: str, tp) -> torch.Tensor:
    """This rank's share of the whole leaf `key` (gather_param's
    inverse)."""
    axis = None if tp is None else tp.axes.get(key)
    return x if axis is None else _slice(x, axis, tp.size, tp.index)


def gather_params(params):
    """The whole parameters from a rank's share (the JAX package's global
    keys and shapes: what save_model and the snapshots write)."""
    from ..params import flatten, map_leaves

    tp = params.tp
    if tp is None:
        return params
    flat = {k: gather_param(v, k, tp) for k, v in flatten(params).items()}
    return _unflatten_like(params, flat)


def is_writer() -> bool:
    """Whether this process writes a file that every rank of the world
    computes alike (rank 0, or a process outside any world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync() -> None:
    """Wait for every rank of the world (after rank 0 wrote a file)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _unflatten_like(params, flat: dict):
    """params with every leaf replaced from `flat` (flatten()'s keys); the
    result carries no TensorParallel."""
    from ..params import _containers

    groups = {}
    for name, cls in _containers(params):
        fields = {}
        for f in dataclasses.fields(cls):
            leaf = getattr(getattr(params, name), f.name)
            key = f"{name}.{f.name}"
            if isinstance(leaf, QTensor):
                fields[f.name] = QTensor(q=flat[key + ".q"],
                                         scale=flat[key + ".scale"])
            elif isinstance(leaf, QTensorW8A8):
                fields[f.name] = QTensorW8A8(
                    q=flat[key + ".q"], col_scale=flat[key + ".col_scale"],
                    act_scale=flat.get(key + ".act_scale"))
            else:
                fields[f.name] = flat[key]
        groups[name] = cls(**fields)
    return type(params)(**groups)


# ---------------------------------------------------------------------------
# stream state over the data axis (and rings over the model axis)
# ---------------------------------------------------------------------------

def rings_split(params, cc) -> bool:
    """Whether the K/V rings (and their scales) of an engine over `params`
    hold a rank's share of the heads: the attention pair split, and split
    rings (the shared x-ring stays whole on every rank)."""
    tp = params.tp
    return tp is not None and tp.attn and not cc.shared_cache


# per-leaf stream axis by rank, as JAX's state_shardings: encoder caches
# [L, B, ...] (axis 1), decoder state [B, ...] and per-stream scalars [B]
# (axis 0)
STREAM_AXIS_BY_RANK = {5: 1, 4: 1, 3: 0, 2: 0, 1: 0}


def state_shardings(state, mesh: Mesh, heads_split: bool = False) -> dict:
    """{field: (stream axis, head axis or None)} of an EncoderState or
    DecoderState (any dataclass of tensors): the stream rows split over
    the data axis; with `heads_split` (the attention pair split over the
    model axis and split rings), the head axis of the K/V rings and their
    scales over the model axis."""
    out = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        heads = (2 if heads_split and f.name in ("k_cache", "v_cache",
                                                 "k_scale", "v_scale")
                 else None)
        out[f.name] = (STREAM_AXIS_BY_RANK.get(x.dim()), heads)
    return out


def shard_state(state, mesh: Mesh, heads_split: bool = False,
                rows: bool = True):
    """This rank's rows (and heads) of a whole state, on its device
    (rows=False: the state holds the rank's rows already)."""
    spec = state_shardings(state, mesh, heads_split)
    vals = {}
    for f, (axis, heads) in spec.items():
        x = getattr(state, f)
        if rows:
            lo, hi = mesh.row_span(x.shape[axis])
            x = x.narrow(axis, lo, hi - lo)
        if heads is not None:
            x = _slice(x, heads, mesh.model, mesh.model_index)
        vals[f] = x.to(mesh.device).clone(
            memory_format=torch.contiguous_format)
    return type(state)(**vals)


def gather_state(state, mesh: Mesh, heads_split: bool = False):
    """The whole state from every rank's rows (and heads): shard_state's
    inverse; every rank gets it."""
    spec = state_shardings(state, mesh, heads_split)
    vals = {}
    for f, (axis, heads) in spec.items():
        x = getattr(state, f)
        if heads is not None:
            x = gather_along(x, heads, mesh.model_group, mesh.model,
                             mesh.model_index)
        vals[f] = gather_along(x, axis, mesh.data_group, mesh.data,
                               mesh.data_index)
    return type(state)(**vals)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """Per-stream results of this rank's rows -> every row, gathered over
    the data axis."""
    return gather_along(x, axis, mesh.data_group, mesh.data, mesh.data_index)


def shard_stream_major(tree, mesh: Mesh):
    """This rank's rows of a dataclass whose every set leaf is
    stream-major ([S, ...]: a BeamState or TdtBeamState), on its device,
    as JAX's shard_stream_major puts such leaves on the data axis
    (nemotron_tpu/parallel/mesh.py:106-116; state_shardings' rank map is
    for [L, B, ...] encoder caches and would pick the wrong axis)."""
    vals = {}
    for f in dataclasses.fields(tree):
        x = getattr(tree, f.name)
        if x is not None:
            lo, hi = mesh.row_span(x.shape[0])
            x = x[lo:hi].to(mesh.device).clone(
                memory_format=torch.contiguous_format)
        vals[f.name] = x
    return type(tree)(**vals)


def gather_stream_major(tree, mesh: Mesh):
    """shard_stream_major's inverse: every row of every set leaf, on every
    rank."""
    return type(tree)(**{
        f.name: (None if getattr(tree, f.name) is None
                 else gather_rows(getattr(tree, f.name), mesh))
        for f in dataclasses.fields(tree)})
