"""Blockwise-int8 (Q8_0) weight matmul: the CUDA kernel's wrapper and its
plain PyTorch version.

out[M, N] = x[M, K] @ (q[K, N] * expand(scale[K//32, N]))

The kernel (`csrc/q8_matmul.cu`) replaces the Pallas TPU kernel
`nemotron_tpu/ops/quant_kernel.py:q8_matmul`. A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel (one launch a call), or the
wrapper raises. The kernel has two designs, and `q8_launch_geometry` picks
one from M: "splitk" for the streaming step's few rows, "tiled" above
`SPLITK_MAX_M` rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build

QK = 32
MAX_CLUSTER = 8     # blocks of a thread-block cluster along K (portable)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGNS = {"splitk": 0, "tiled": 1}
_sm_counts: dict[int, int] = {}


def q8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """Plain version: dequantize into the activation dtype ((float)q * scale
    in f32, then rounded), matmul with f32 accumulation, output in x's
    dtype."""
    K, N = q.shape
    w = (q.to(torch.float32).reshape(K // QK, QK, N)
         * scale.to(torch.float32)[:, None, :]).reshape(K, N)
    w = w.to(x.dtype).to(torch.float32)
    return (x.to(torch.float32) @ w).to(x.dtype)


# M*: the skinny design takes M <= SPLITK_MAX_M rows, the tiled one more.
# Measured on an H100 (chip_q8_sweep.py, chip_smoke.py; PERF.md kernel
# table): per layer of the encoder's ten calls the two designs tie at
# M = 96; the skinny one wins by 15% at M = 80, the tiled one by 14% at 112.
SPLITK_MAX_M = 96
TILED_BM, TILED_BN = 128, 128   # the tiled design's output tile


class Q8Geometry(NamedTuple):
    """One launch of the kernel. design "splitk": ceil(N/bn) clusters of
    `split` blocks along K, each block taking M in tiles of bm <= 16 rows;
    "tiled": ceil(M/bm) x ceil(N/bn) output tiles, each a cluster of
    `split` blocks along K. Either way a cluster's blocks take whole 32-row
    scale blocks of K; `blocks` is the grid's size."""
    design: str
    bm: int
    bn: int
    split: int
    blocks: int


def splitk_geometry(M: int, K: int, N: int, sms: int) -> Q8Geometry:
    """The skinny design on a card with `sms` streaming multiprocessors:
    clusters of min(8, K/32) blocks split K; a cluster covers 64 columns
    where that still gives one full wave of blocks, else 32; the grid does
    not depend on M. A block takes M in tiles of bm = 1, 2, 4, 8 or 16 rows
    (the least power of two that holds M, at most 16)."""
    ck = min(MAX_CLUSTER, K // QK)
    tn = 64 if -(-N // 64) * ck >= sms else 32
    tm = min(16, 1 << (M - 1).bit_length())
    return Q8Geometry("splitk", tm, tn, ck, -(-N // tn) * ck)


def tiled_geometry(M: int, K: int, N: int, sms: int,
                   split: int | None = None) -> Q8Geometry:
    """The tiled design: 128 x 128 output tiles, K split over a cluster of
    1, 2, 4 or 8 blocks (at most K/32). By default the smallest split that
    gives at least one block an SM."""
    tiles = -(-M // TILED_BM) * -(-N // TILED_BN)
    if split is None:
        split = 1
        while tiles * split < sms and 2 * split <= min(MAX_CLUSTER, K // QK):
            split *= 2
    return Q8Geometry("tiled", TILED_BM, TILED_BN, split, tiles * split)


def q8_launch_geometry(M: int, K: int, N: int, sms: int) -> Q8Geometry:
    """The launch for x [M, K] @ q [K, N] on a card with `sms` streaming
    multiprocessors: the skinny design up to SPLITK_MAX_M rows, the tiled
    one above."""
    if M <= SPLITK_MAX_M:
        return splitk_geometry(M, K, N, sms)
    return tiled_geometry(M, K, N, sms)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_counts[dev]


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = cuda_build.load("q8_matmul")
    if lib.q8_matmul_launch.argtypes is not None:
        return lib
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.q8_matmul_launch.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i,
                                     p]
    lib.q8_matmul_launch.restype = i
    return lib


def q8_matmul(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] f32 or bf16; q int8 [K, N]; scale f32 [K//32, N].
    Returns [M, N] in x's dtype. K must be a multiple of 32.

    On the card: one kernel launch, no workspace, deterministic; the
    geometry is `q8_launch_geometry(M, K, N, SMs)`.
    - Up to SPLITK_MAX_M rows (the streaming step's 1-14 at one stream),
      the skinny design: ceil(N/bn) thread-block clusters of min(8, K/32)
      blocks split K, 128 threads a block, M in tiles of up to 16 rows
      inside the block. It streams the weight once and is bound by HBM
      bytes and the per-launch floor.
    - Above, the tiled design, for the FMA-bound GEMM of a batch (the
      full-utterance encoder's M = 804, the 64-slot engine's 896): 128 x
      128 output tiles of 128 threads (8 x 16 outputs a thread), each
      weight tile dequantized once a block into shared memory while the
      copies of the next two K steps are in flight, K split over a cluster
      where the tiles alone do not give a block an SM. Bound by the f32
      FMAs and, beside them, shared-memory bandwidth."""
    if x.device.type == "cpu":
        return q8_matmul_ref(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"q8_matmul: unsupported device {x.device}")
    M, K = x.shape
    N = q.shape[1] if q.dim() == 2 else 0
    return q8_matmul_as(x, q, scale,
                        q8_launch_geometry(M, K, N, sm_count(x.device)))


def q8_matmul_as(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 geometry: Q8Geometry) -> torch.Tensor:
    """The kernel on CUDA tensors with a given geometry (q8_matmul's own,
    or the other design's, to time the two side by side). Counts the
    launch."""
    M, K = x.shape
    if q.dim() != 2 or q.shape[0] != K or K % QK:
        raise ValueError(f"q8_matmul: x {tuple(x.shape)} vs q {tuple(q.shape)}")
    N = q.shape[1]
    if tuple(scale.shape) != (K // QK, N):
        raise ValueError(f"q8_matmul: scale {tuple(scale.shape)} != "
                         f"{(K // QK, N)}")
    if x.dtype not in _DTYPES or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"q8_matmul: dtypes x {x.dtype}, q {q.dtype}, "
                        f"scale {scale.dtype}")
    if x.device.type != "cuda" or not (q.device == scale.device == x.device):
        raise ValueError("q8_matmul: operands must be on one CUDA device")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q8_matmul: operands must be contiguous")
    lib = _lib()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    vec = int(N % 16 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x, q, scale)))
    rc = lib.q8_matmul_launch(
        _DTYPES[x.dtype], x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), M, K, N, _DESIGNS[geometry.design], geometry.bm,
        geometry.bn, geometry.split, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"q8_matmul kernel launch failed: CUDA error {rc}")
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0
