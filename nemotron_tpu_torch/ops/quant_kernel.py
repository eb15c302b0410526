"""Blockwise-int8 (Q8_0) weight matmul: the CUDA kernel's wrapper and its
plain PyTorch version.

out[M, N] = x[M, K] @ (q[K, N] * expand(scale[K//32, N]))

The kernel (`csrc/q8_matmul.cu`) replaces the Pallas TPU kernel
`nemotron_tpu/ops/quant_kernel.py:q8_matmul`. A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel (one launch a call), or the
wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

QK = 32
MAX_CLUSTER = 8     # blocks of a thread-block cluster along K (portable)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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


def q8_launch_geometry(K: int, N: int, sms: int) -> tuple[int, int, int]:
    """(tn, ck, blocks) of the kernel's launch on a card with `sms`
    streaming multiprocessors: clusters of ck = min(8, K/32) blocks split K
    by whole 32-row scale blocks; a cluster covers tn = 64 columns where
    that still gives one full wave of blocks, else 32. The grid is
    ceil(N/tn) clusters, whatever M is."""
    ck = min(MAX_CLUSTER, K // QK)
    tn = 64 if -(-N // 64) * ck >= sms else 32
    return tn, ck, -(-N // tn) * ck


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
    lib.q8_matmul_launch.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p]
    lib.q8_matmul_launch.restype = i
    return lib


def q8_matmul(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] f32 or bf16; q int8 [K, N]; scale f32 [K//32, N].
    Returns [M, N] in x's dtype. K must be a multiple of 32.

    On the card: one kernel launch, no workspace. The grid is
    `q8_launch_geometry(K, N, SMs)`: ceil(N/tn) thread-block clusters of
    ck = min(8, K/32) blocks (tn = 32 or 64 columns, at least 132 blocks on
    an H100 for every encoder shape), 128 threads a block; M is taken in
    tiles of up to 16 rows inside the block."""
    if x.device.type == "cpu":
        return q8_matmul_ref(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"q8_matmul: unsupported device {x.device}")
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
    if not (q.device == scale.device == x.device):
        raise ValueError("q8_matmul: operands on different devices")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q8_matmul: operands must be contiguous")
    lib = _lib()
    tn, ck, _ = q8_launch_geometry(K, N, sm_count(x.device))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    vec = int(N % 16 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x, q, scale)))
    rc = lib.q8_matmul_launch(
        _DTYPES[x.dtype], x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), M, K, N, tn, ck, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"q8_matmul kernel launch failed: CUDA error {rc}")
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0
