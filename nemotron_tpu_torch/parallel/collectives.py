"""The collectives the mesh writes out where GSPMD would insert them.

Tensor parallelism over the model axis follows the Megatron pair:

  - `model_copy` before a column-split product (q/k/v/pos, w1): identity
    forward, a sum of the input gradients over the model axis backward;
  - `model_sum` after a row-split product (attn_out, w2): a sum of the
    partial outputs over the model axis forward, identity backward.

Between them every rank of a model group holds the same replicated
activations, so the whole-weight leaves (LayerNorms, the conv module, the
subsampling, decoder and joint) get the same gradient on every rank.

`gather_along` assembles a tensor split over a group (stream rows over the
data axis, heads over the model axis). It is built from all_reduce alone:
gloo takes CUDA tensors for broadcast and all_reduce only (the
torch.distributed backend table), and the sum runs over the tensor's bytes
with zeros outside each rank's slice, so the result is bit-exact in every
dtype (a float sum would turn -0.0 into 0.0).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Sum(torch.autograd.Function):
    """all_reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """Identity forward, all_reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial products over the model axis (`group`
    None: no split, `x` as it is)."""
    return x if group is None else _Sum.apply(x, group)


def model_copy(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-split product: `x` itself, whose gradient is
    summed over the model axis in the backward pass."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Copy.apply(x, group)


def all_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of `x` over `group` (a data-axis gradient, a norm)."""
    dist.all_reduce(x, group=group)
    return x


def gather_along(x: torch.Tensor, axis: int, group, size: int,
                 index: int) -> torch.Tensor:
    """The whole tensor from each rank's equal slice along `axis`: rank
    `index` of `group` (of `size` ranks) holds slice `index`. Every rank
    gets the same bytes. A group of one still goes through the collective,
    so a one-rank mesh exercises its backend."""
    x = x.detach().contiguous()
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = n * size
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(axis, index * n, n).copy_(x)
    if out.dim() == 0 or out.numel() == 0:
        return out
    dist.all_reduce(out.view(torch.uint8), group=group)
    return out
