"""Fused ring-buffer attention of the streaming encoder: the CUDA kernel's
wrapper and its plain PyTorch version.

ctx [B, H, Q, Dh] = softmax((q_u . [ring_l | k_new]) / sqrt(Dh) + a)
                    . [ring_l | v_new],

with the layer l selected from the stacked rings [L, B, H, KV, Dh] and the
per-slot dequant columns k_cols/v_cols [B, H, KV] (ones for dense rings)
folded into the scores (keys) and the softmax weights (values).

The kernel (`csrc/ring_attn.cu`) replaces the Pallas TPU kernel
`nemotron_tpu/ops/ring_attn_kernel.py:fused_ring_attention`. A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel, or the
wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CLUSTER = 8   # the portable thread-block cluster size


def cluster_size(Dh: int) -> int:
    """Blocks of the thread-block cluster per (stream, head): the largest
    C <= 8 with Dh % (4 * C) == 0, so that each block owns Dh / C output
    columns in whole groups of 4 (8 at Dh = 128 and 64, 4 at Dh = 16).
    The kernel also needs Dh % 16 == 0 (16-byte rows of int8 rings)."""
    if Dh <= 0 or Dh % 16:
        raise ValueError(f"fused_ring_attention: Dh={Dh} is not a positive "
                         f"multiple of 16")
    return max(c for c in range(1, MAX_CLUSTER + 1) if Dh % (4 * c) == 0)


def ring_attention_ref(layer: int, q_u, k_new, v_new, k_ring_all, v_ring_all,
                       a, k_cols, v_cols):
    """Plain version, the arithmetic of the TPU kernel's body
    (nemotron_tpu/ops/ring_attn_kernel.py:52-82): f32 dots over
    compute-dtype operands, f32 softmax, value-side weights rounded to the
    compute dtype, context stored in the compute dtype."""
    dt = q_u.dtype
    f32 = torch.float32
    kv = k_ring_all.shape[3]
    scale = float(1.0 / (q_u.shape[-1] ** 0.5))
    qu = q_u.to(f32)
    k_r = k_ring_all[layer].to(dt).to(f32)
    v_r = v_ring_all[layer].to(dt).to(f32)
    c_r = torch.einsum("bhid,bhjd->bhij", qu, k_r) * k_cols[:, :, None, :]
    c_n = torch.einsum("bhid,bhjd->bhij", qu, k_new.to(f32))
    scores = torch.cat([c_r, c_n], dim=-1) * scale + a.to(f32)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    w = e / e.sum(dim=-1, keepdim=True)
    w_r = (w[..., :kv] * v_cols[:, :, None, :]).to(dt).to(f32)
    ctx = (torch.einsum("bhij,bhjd->bhid", w_r, v_r)
           + torch.einsum("bhij,bhjd->bhid", w[..., kv:].to(dt).to(f32),
                          v_new.to(f32)))
    return ctx.to(dt)


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = cuda_build.load("ring_attn")
    if lib.ring_attn_launch.argtypes is not None:
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ring_attn_launch.argtypes = [i, i, p, p, p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, ctypes.c_float, p]
    lib.ring_attn_launch.restype = i
    lib.ring_attn_max_q.argtypes = []
    lib.ring_attn_max_q.restype = i
    return lib


def fused_ring_attention(layer: int, q_u, k_new, v_new, k_ring_all,
                         v_ring_all, a, k_cols, v_cols):
    """q_u/k_new/v_new [B, H, Q, Dh] f32 or bf16; k_ring_all/v_ring_all
    [L, B, H, KV, Dh] in the compute dtype or int8 (read only);
    a [B, H, Q, KV+Q] in the compute dtype; k_cols/v_cols [B, H, KV] f32.
    Returns ctx [B, H, Q, Dh] in the compute dtype.

    On the card: one launch of B*H thread-block clusters of
    C = cluster_size(Dh) blocks (256 threads each; 64 blocks at B = 1,
    H = 8, Dh = 128), block r of a cluster taking keys [r*S/C, (r+1)*S/C)
    of the S = KV+Q keys. Needs Q <= 16, Dh a multiple of 16 and 16-byte
    aligned q_u, k_new, v_new and rings."""
    if q_u.device.type == "cpu":
        return ring_attention_ref(layer, q_u, k_new, v_new, k_ring_all,
                                  v_ring_all, a, k_cols, v_cols)
    if q_u.device.type != "cuda":
        raise ValueError(f"fused_ring_attention: unsupported device "
                         f"{q_u.device}")
    B, H, Q, Dh = q_u.shape
    L, _, _, KV, _ = k_ring_all.shape
    dt = q_u.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused_ring_attention: compute dtype {dt}")
    ring_dt = k_ring_all.dtype
    if ring_dt not in (dt, torch.int8) or v_ring_all.dtype != ring_dt:
        raise TypeError(f"fused_ring_attention: ring dtypes {ring_dt}, "
                        f"{v_ring_all.dtype} with compute dtype {dt}")
    shapes = {"k_new": (k_new, (B, H, Q, Dh), dt),
              "v_new": (v_new, (B, H, Q, Dh), dt),
              "k_ring_all": (k_ring_all, (L, B, H, KV, Dh), ring_dt),
              "v_ring_all": (v_ring_all, (L, B, H, KV, Dh), ring_dt),
              "a": (a, (B, H, Q, KV + Q), dt),
              "k_cols": (k_cols, (B, H, KV), torch.float32),
              "v_cols": (v_cols, (B, H, KV), torch.float32)}
    for name, (t, shape, want_dt) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != want_dt:
            raise ValueError(f"fused_ring_attention: {name} is "
                             f"{tuple(t.shape)} {t.dtype}, want {shape} "
                             f"{want_dt}")
        if t.device != q_u.device or not t.is_contiguous():
            raise ValueError(f"fused_ring_attention: {name} must be a "
                             f"contiguous tensor on {q_u.device}")
    if not q_u.is_contiguous():
        raise ValueError("fused_ring_attention: q_u must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"fused_ring_attention: layer {layer} of {L}")
    C = cluster_size(Dh)
    for name, t in (("q_u", q_u), ("k_new", k_new), ("v_new", v_new),
                    ("k_ring_all", k_ring_all), ("v_ring_all", v_ring_all)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_ring_attention: {name} is not 16-byte "
                             f"aligned")
    lib = _lib()
    if Q > lib.ring_attn_max_q():
        raise ValueError(f"fused_ring_attention: Q={Q} exceeds the kernel's "
                         f"{lib.ring_attn_max_q()} query rows")
    out = torch.empty_like(q_u)
    rc = lib.ring_attn_launch(
        _DTYPES[dt], int(ring_dt == torch.int8), q_u.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), k_ring_all.data_ptr(),
        v_ring_all.data_ptr(), a.data_ptr(), k_cols.data_ptr(),
        v_cols.data_ptr(), out.data_ptr(), int(layer), B * H, Q, KV, Dh,
        C, float(1.0 / (Dh ** 0.5)),
        torch.cuda.current_stream(q_u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring attention kernel launch failed: "
                           f"CUDA error {rc}")
    fused_ring_attention.launches += 1
    return out


fused_ring_attention.launches = 0
