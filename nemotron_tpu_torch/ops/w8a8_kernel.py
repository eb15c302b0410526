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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = cuda_build.load("w8a8_matmul")
    if lib.w8a8_matmul_launch.argtypes is not None:
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.w8a8_matmul_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
    lib.w8a8_matmul_launch.restype = i
    lib.w8a8_matmul_scratch_bytes.argtypes = [i, i, i, i]
    lib.w8a8_matmul_scratch_bytes.restype = ctypes.c_long
    return lib


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor,
                col_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] f32 or bf16; q int8 [K, N]; col_scale f32 [N].
    Returns [M, N] in x's dtype."""
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
    lib = _lib()
    scratch = torch.empty(lib.w8a8_matmul_scratch_bytes(M, K, N, G),
                          dtype=torch.uint8, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    vec = int(N % 4 == 0 and q.data_ptr() % 4 == 0)
    rc = lib.w8a8_matmul_launch(
        _DTYPES[x.dtype], x.data_ptr(), q.data_ptr(), col_scale.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), M, K, N, G, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w8a8_matmul kernel launch failed: CUDA error {rc}")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
