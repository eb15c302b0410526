"""Dynamic-activation int8 matmul (W8A8): the CUDA kernel's wrapper and its
plain PyTorch version.

out[M, N] = (sum over K-groups t of (xq_t @ q_t)_int * s[:, t]) * col_scale

Each row of x is quantized on the fly with one scale per K-group of
`w8a8_k_tile(K)` columns: s = max(amax|x_t|, 1e-12) * f32(1/127),
xq = clip(round_half_even(x_t / s), -127, 127). The group width is part of
the function, not a tiling choice: it is the Pallas kernel's K tile
(`nemotron_tpu/ops/w8a8_kernel.py:63-64`), so where that kernel applies
(K % 256 == 0) this reproduces it, and where the group is the whole row it
equals the JAX package's per-row path up to the scale's multiply-vs-divide.

With a static activation scale s (SmoothQuant's calibrated scale, one f32
scalar a weight) the function is the JAX package's static `qmm_w8a8`
(`nemotron_tpu/ops/quant.py:137-148`), with no K grouping:

out[M, N] = f32((clip(round_half_even(x / s), -127, 127) @ q)_int)
            * (s * col_scale).

The kernel (`csrc/w8a8_matmul.cu`) replaces the Pallas TPU kernel
`nemotron_tpu/ops/w8a8_kernel.py:w8a8_matmul`. A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel (one launch a call),
or the wrapper raises. The kernel has two designs, and
`w8a8_launch_geometry` picks one from M: "splitk" for the streaming step's
few rows, "tiled" above `SPLITK_MAX_M` rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import cuda_build
from .quant_kernel import sm_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGNS = {"splitk": 0, "tiled": 1}
MAX_CLUSTER = 8   # the portable thread-block cluster size
KSTEP = 32        # K depth of the kernel's int8 tensor-core step


def w8a8_k_tile(K: int) -> int:
    """Activation-scale group width along K: 1024, 512 or 256 when K is a
    multiple of it (the TPU kernel's rule), else the whole row up to 1024."""
    for tk in (1024, 512, 256):
        if K % tk == 0:
            return tk
    if K <= 1024:
        return K
    raise ValueError(f"w8a8: K={K} is above 1024 and not a multiple of 256")


def w8a8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    col_scale: torch.Tensor) -> torch.Tensor:
    """Plain version, group by group in order. The integer dot is an f32
    matmul of integer values: with groups of at most 1024 every partial sum
    is below 127 * 127 * 1024 < 2^24, so it is exact in any order."""
    M, K = x.shape
    G = w8a8_k_tile(K)
    xf = x.to(torch.float32)
    qf = q.to(torch.float32)
    inv = torch.full((), 1.0 / 127.0, dtype=torch.float32, device=x.device)
    acc = torch.zeros((M, q.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, K, G):
        xt = xf[:, k0:k0 + G]
        s = torch.clamp_min(xt.abs().amax(dim=1, keepdim=True), 1e-12) * inv
        xq = torch.clamp(torch.round(xt / s), -127.0, 127.0)
        acc = acc + (xq @ qf[k0:k0 + G]) * s
    return (acc * col_scale.to(torch.float32)).to(x.dtype)


def w8a8_matmul_static_ref(x: torch.Tensor, q: torch.Tensor,
                           col_scale: torch.Tensor,
                           act_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the static mode: x / s correctly rounded in f32,
    the integer product exact in float64 (every partial sum is an integer
    below 2^53), rounded to f32 as an int32 accumulator converts."""
    s = act_scale.to(torch.float32)
    xq = torch.clamp(torch.round(x.to(torch.float32) / s), -127.0, 127.0)
    acc = (xq.to(torch.float64) @ q.to(torch.float64)).to(torch.float32)
    return (acc * (s * col_scale.to(torch.float32))).to(x.dtype)


# M*: the skinny design takes M <= SPLITK_MAX_M rows, the tiled one more
# (where it takes K: `tiled_takes`). Measured on an H100 (chip_smoke.py's
# crossover rows, bf16, one layer's ten calls; PERF.md kernel table): the
# skinny design wins at 256 rows and the tiled one at 288 (it takes a
# third 128-row tile from 257), in both the dynamic and the static mode.
SPLITK_MAX_M = 256
TILED_BM, TILED_BN, TILED_BK = 128, 128, 64   # the tiled design's tile
_TWO_PER_SM = 113 * 1024   # a skinny block's shared memory, two an SM
_PAD = 16                  # bytes of padding of a skinny shared-memory row


class W8A8Geometry(NamedTuple):
    """One launch of the kernel. design "splitk": for each M tile of bm
    rows, ceil(N/bn) clusters of `split` blocks along K; "tiled":
    ceil(M/bm) x ceil(N/bn) output tiles, each a cluster of `split` blocks
    along K. `blocks` is the grid's size."""
    design: str
    bm: int
    bn: int
    split: int
    blocks: int


def _groups(K: int) -> tuple[int, int]:
    """(G, n_groups); raises where a cluster cannot take the groups."""
    G = w8a8_k_tile(K)
    n_groups = K // G
    if n_groups > MAX_CLUSTER:
        raise ValueError(f"w8a8_matmul: K={K} has {n_groups} groups of {G}; "
                         f"the kernel's cluster takes at most {MAX_CLUSTER}")
    return G, n_groups


def _splitk_smem(bm: int, bn: int, ksp: int, C: int, n_groups: int,
                 xsize: int) -> int:
    """Bytes of a skinny block's shared memory (the kernel's `Layout`)."""
    def r16(v):
        return -(-v // 16) * 16
    row, cw = ksp + _PAD, -(-bn // C)
    return (bn * row + r16(max(bm * row, ksp * bn)) + bm * ksp * xsize
            + r16(C * bm * cw * 4) + C * bm * 4 + r16(n_groups * bm * 4)
            + r16(cw * 4))


def splitk_geometry(M: int, K: int, N: int, sms: int,
                    xsize: int = 2) -> W8A8Geometry:
    """The skinny design on a card with `sms` streaming multiprocessors, x
    of `xsize` bytes an element. A cluster of C = n_groups * c <= 8 blocks
    splits K, c the largest power of two that keeps each block's slice
    K / C a multiple of 32 inside one group of `w8a8_k_tile(K)` columns
    (C = 8 for K = 1024 and 4096; a single group that holds no multiple of
    32 runs with C = 1). A cluster covers bn = 64 columns above 16 rows
    (more than one M tile fills the card, and every column tile quantizes
    its own copy of x, which wider tiles halve) or where that still gives
    one full wave of blocks; else 32. M tiles of bm = 16 rows up to
    M = 16, 32 up to 32, else 64, halved while two blocks would not share
    an SM."""
    G, n_groups = _groups(K)
    c = 1
    while (n_groups * 2 * c <= MAX_CLUSTER and G % (2 * c) == 0
           and (G // (2 * c)) % KSTEP == 0):
        c *= 2
    C = n_groups * c
    bn = 64 if M > 16 or -(-N // 64) * C >= sms else 32
    ksp = -(-(G // c) // KSTEP) * KSTEP
    bm = 16 if M <= 16 else 32 if M <= 32 else 64
    while bm > 16 and _splitk_smem(bm, bn, ksp, C, n_groups,
                                   xsize) > _TWO_PER_SM:
        bm //= 2
    return W8A8Geometry("splitk", bm, bn, C, -(-M // bm) * -(-N // bn) * C)


def tiled_splits(K: int) -> list[int]:
    """The tiled design's splits of K: 1 (a block walks every group), or
    n_groups * c <= 8 blocks, c a power of two, each block taking a
    multiple of TILED_BK rows inside one group."""
    G, n_groups = _groups(K)
    out = [1]
    c = 1
    while n_groups * c <= MAX_CLUSTER:
        if n_groups * c > 1 and G % c == 0 and (G // c) % TILED_BK == 0:
            out.append(n_groups * c)
        c *= 2
    return out


def tiled_takes(K: int) -> bool:
    """Whether the tiled design takes this K: groups of a multiple of
    TILED_BK rows (every encoder shape; not K = 96 or 36)."""
    return w8a8_k_tile(K) % TILED_BK == 0


def tiled_geometry(M: int, K: int, N: int, sms: int,
                   split: int | None = None) -> W8A8Geometry:
    """The tiled design: 128 x 128 output tiles, K split over a cluster of
    `split` blocks (one of `tiled_splits(K)`). By default the smallest
    split that gives at least one block an SM, else the largest."""
    if not tiled_takes(K):
        raise ValueError(f"w8a8_matmul: the tiled design needs K-groups of "
                         f"a multiple of {TILED_BK} (K={K})")
    splits = tiled_splits(K)
    tiles = -(-M // TILED_BM) * -(-N // TILED_BN)
    if split is None:
        split = next((s for s in splits if tiles * s >= sms), splits[-1])
    elif split not in splits:
        raise ValueError(f"w8a8_matmul: split {split} not in {splits} for "
                         f"K={K}")
    return W8A8Geometry("tiled", TILED_BM, TILED_BN, split, tiles * split)


@functools.lru_cache(maxsize=None)
def w8a8_launch_geometry(M: int, K: int, N: int, sms: int,
                         xsize: int = 2) -> W8A8Geometry:
    """The launch for x [M, K] (`xsize` bytes an element) @ q [K, N] on a
    card with `sms` streaming multiprocessors: the skinny design up to
    SPLITK_MAX_M rows and wherever the tiled one does not take K, the
    tiled one above. Raises ValueError above 8 K-groups. Cached: the
    encoder asks it for the same few shapes 240 times a step."""
    _groups(K)
    if M > SPLITK_MAX_M and tiled_takes(K):
        return tiled_geometry(M, K, N, sms)
    return splitk_geometry(M, K, N, sms, xsize)


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = cuda_build.load("w8a8_matmul")
    if lib.w8a8_matmul_launch.argtypes is not None:
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.w8a8_matmul_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i,
                                       i, i, i, p]
    lib.w8a8_matmul_launch.restype = i
    return lib


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor, col_scale: torch.Tensor,
                act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x [M, K] f32 or bf16; q int8 [K, N]; col_scale f32 [N]; act_scale
    None (per-row activation scales) or a one-element f32 tensor on x's
    device, the static scale (read by the kernel, so no host sync).
    Returns [M, N] in x's dtype.

    On the card: one kernel launch, nothing allocated but the output; the
    activation's quantization is fused in and the products run on the int8
    tensor cores. The geometry is `w8a8_launch_geometry(M, K, N, SMs)`:
    - up to SPLITK_MAX_M rows (the streaming step's 8-112), the skinny
      design: ceil(N/bn) thread-block clusters of up to 8 blocks along K
      for each tile of 16, 32 or 64 rows, each block quantizing its own
      slice of x;
    - above (the 64-slot engine's 896 rows, the full-utterance 804), the
      tiled design: 128 x 128 output tiles walking K in steps of 64 rows
      through a 4-stage cp.async ring, each x element quantized once a
      block for all 128 columns, K split over a cluster where the tiles
      alone do not give a block an SM."""
    if x.device.type == "cpu":
        if act_scale is not None:
            return w8a8_matmul_static_ref(x, q, col_scale, act_scale)
        return w8a8_matmul_ref(x, q, col_scale)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {x.device}")
    M, K = x.shape
    N = q.shape[1] if q.dim() == 2 else 0
    return w8a8_matmul_as(x, q, col_scale, act_scale, w8a8_launch_geometry(
        M, K, N, sm_count(x.device), x.element_size()))


def w8a8_matmul_as(x: torch.Tensor, q: torch.Tensor, col_scale: torch.Tensor,
                   act_scale: torch.Tensor | None,
                   geometry: W8A8Geometry) -> torch.Tensor:
    """The kernel on CUDA tensors with a given geometry (w8a8_matmul's
    own, or the other design's, to time the two side by side). Counts the
    launch."""
    M, K = x.shape
    if q.dim() != 2 or q.shape[0] != K or M < 1:
        raise ValueError(f"w8a8_matmul: x {tuple(x.shape)} vs q "
                         f"{tuple(q.shape)}")
    N = q.shape[1]
    G = w8a8_k_tile(K)
    if tuple(col_scale.shape) != (N,):
        raise ValueError(f"w8a8_matmul: col_scale {tuple(col_scale.shape)} "
                         f"!= {(N,)}")
    if x.dtype not in _DTYPES or q.dtype != torch.int8 \
            or col_scale.dtype != torch.float32:
        raise TypeError(f"w8a8_matmul: dtypes x {x.dtype}, q {q.dtype}, "
                        f"col_scale {col_scale.dtype}")
    if x.device.type != "cuda" or not (q.device == col_scale.device
                                       == x.device):
        raise ValueError("w8a8_matmul: operands must be on one CUDA device")
    if not (x.is_contiguous() and q.is_contiguous()
            and col_scale.is_contiguous()):
        raise ValueError("w8a8_matmul: operands must be contiguous")
    if act_scale is not None and (
            act_scale.numel() != 1 or act_scale.dtype != torch.float32
            or act_scale.device != x.device):
        raise ValueError(f"w8a8_matmul: act_scale must be one f32 value on "
                         f"{x.device}, got {tuple(act_scale.shape)} "
                         f"{act_scale.dtype} on {act_scale.device}")
    lib = _lib()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    vec_x = int(K * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(N % 16 == 0 and q.data_ptr() % 16 == 0)
    rc = lib.w8a8_matmul_launch(
        _DTYPES[x.dtype], x.data_ptr(), q.data_ptr(), col_scale.data_ptr(),
        None if act_scale is None else act_scale.data_ptr(),
        out.data_ptr(), M, K, N, G, _DESIGNS[geometry.design], geometry.bm,
        geometry.bn, geometry.split, vec_x, vec_w,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w8a8_matmul kernel launch failed: CUDA error {rc}")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
