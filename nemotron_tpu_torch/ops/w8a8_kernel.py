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

The kernel (`csrc/w8a8_matmul.cu`) replaces the Pallas TPU kernel
`nemotron_tpu/ops/w8a8_kernel.py:w8a8_matmul`. A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .quant_kernel import sm_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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


def w8a8_launch_geometry(K: int, N: int, sms: int,
                         M: int = 1) -> tuple[int, int, int]:
    """(bn, C, blocks) of the kernel's launch for an [M, K] x [K, N] call
    on a card with `sms` streaming multiprocessors; `blocks` counts one M
    tile's clusters, which the kernel repeats for each tile of M. A cluster
    of C = n_groups * c <= 8 blocks splits K, c the largest power of two
    that keeps each block's slice K / C a multiple of 32 inside one group
    of `w8a8_k_tile(K)` columns (C = 8 for K = 1024 and 4096; a single
    group that holds no multiple of 32 runs with C = 1). A cluster covers
    bn = 64 columns above 16 rows (more than one M tile fills the card, and
    every column tile quantizes its own copy of x, which wider tiles halve)
    or where that still gives one full wave of blocks; else 32. Raises
    ValueError where no such C exists: more than 8 groups."""
    G = w8a8_k_tile(K)
    n_groups = K // G
    if n_groups > MAX_CLUSTER:
        raise ValueError(f"w8a8_matmul: K={K} has {n_groups} groups of {G}; "
                         f"the kernel's cluster takes at most {MAX_CLUSTER}")
    c = 1
    while (n_groups * 2 * c <= MAX_CLUSTER and G % (2 * c) == 0
           and (G // (2 * c)) % KSTEP == 0):
        c *= 2
    C = n_groups * c
    bn = 64 if M > 16 or -(-N // 64) * C >= sms else 32
    return bn, C, -(-N // bn) * C


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = cuda_build.load("w8a8_matmul")
    if lib.w8a8_matmul_launch.argtypes is not None:
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.w8a8_matmul_launch.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i,
                                       p]
    lib.w8a8_matmul_launch.restype = i
    return lib


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor,
                col_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] f32 or bf16; q int8 [K, N]; col_scale f32 [N].
    Returns [M, N] in x's dtype.

    On the card: one kernel launch, nothing allocated but the output. The
    grid is `w8a8_launch_geometry(K, N, SMs, M)`: ceil(N/bn) thread-block
    clusters of C blocks along K; the activation's quantization is fused
    in and the products run on the int8 tensor cores; each tile of 16, 32
    or 64 rows of M (4 warps, 8 above 16 rows) has its own clusters."""
    if x.device.type == "cpu":
        return w8a8_matmul_ref(x, q, col_scale)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {x.device}")
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
    if not (q.device == col_scale.device == x.device):
        raise ValueError("w8a8_matmul: operands on different devices")
    if not (x.is_contiguous() and q.is_contiguous()
            and col_scale.is_contiguous()):
        raise ValueError("w8a8_matmul: operands must be contiguous")
    bn, C, _ = w8a8_launch_geometry(K, N, sm_count(x.device), M)
    lib = _lib()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    vec_x = int(K * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(N % 16 == 0 and q.data_ptr() % 16 == 0)
    rc = lib.w8a8_matmul_launch(
        _DTYPES[x.dtype], x.data_ptr(), q.data_ptr(), col_scale.data_ptr(),
        out.data_ptr(), M, K, N, G, bn, C, vec_x, vec_w,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w8a8_matmul kernel launch failed: CUDA error {rc}")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
