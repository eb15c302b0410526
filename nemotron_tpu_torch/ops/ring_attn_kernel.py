"""Fused ring-buffer attention of the streaming encoder: the CUDA kernel's
wrapper and its plain PyTorch version.

ctx [B, H, Q, Dh] = softmax((q_u . [ring_l | k_new]) / sqrt(Dh) + a)
                    . [ring_l | v_new],

with the layer l selected from the stacked rings [L, B, H, KV, Dh] and the
per-slot dequant columns k_cols/v_cols [B, H, KV] (ones for dense rings)
folded into the scores (keys) and the softmax weights (values). The rings
are in the compute dtype, int8, or int4 packed two a byte
([L, B, H, KV, Dh/2] int8, element 2i in the low nibble: the JAX package's
bitcast of int4[..., Dh/2, 2]).

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


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., Dh] -> packed bytes [..., Dh/2] int8:
    element 2i in the low nibble, 2i+1 in the high one (int8 [1, -2] packs
    to 0xe1), byte-equal to the JAX package's
    bitcast_convert_type(int4[..., Dh/2, 2] -> int8)."""
    v = q.to(torch.int32).reshape(*q.shape[:-1], q.shape[-1] // 2, 2)
    b = (v[..., 0] & 0xF) | ((v[..., 1] & 0xF) << 4)
    return b.to(torch.uint8).view(torch.int8)


def unpack_int4(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Packed bytes [..., Dh/2] int8 -> [..., Dh] in `dtype`, each nibble
    sign-extended (nemotron_tpu/ops/rel_attention.py:unpack_int4)."""
    b = p.to(torch.int32)
    lo = (b << 28) >> 28
    hi = b >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        *p.shape[:-1], p.shape[-1] * 2).to(dtype)


def ring_attention_ref(layer: int, q_u, k_new, v_new, k_ring_all, v_ring_all,
                       a, k_cols, v_cols, *, packed_int4: bool = False):
    """Plain version, the arithmetic of the TPU kernel's body
    (nemotron_tpu/ops/ring_attn_kernel.py:52-82): f32 dots over
    compute-dtype operands, f32 softmax, value-side weights rounded to the
    compute dtype, context stored in the compute dtype. packed_int4: the
    rings are [L, B, H, KV, Dh/2] nibble pairs, unpacked first."""
    dt = q_u.dtype
    f32 = torch.float32
    kv = k_ring_all.shape[3]
    scale = float(1.0 / (q_u.shape[-1] ** 0.5))
    qu = q_u.to(f32)
    k_r, v_r = k_ring_all[layer], v_ring_all[layer]
    if packed_int4:
        k_r, v_r = unpack_int4(k_r, dt), unpack_int4(v_r, dt)
    k_r = k_r.to(dt).to(f32)
    v_r = v_r.to(dt).to(f32)
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
                         v_ring_all, a, k_cols, v_cols, *,
                         packed_int4: bool = False):
    """q_u/k_new/v_new [B, H, Q, Dh] f32 or bf16; k_ring_all/v_ring_all
    [L, B, H, KV, Dh] in the compute dtype or int8, or with packed_int4
    [L, B, H, KV, Dh/2] int8 of packed int4 pairs (read only);
    a [B, H, Q, KV+Q] in the compute dtype; k_cols/v_cols [B, H, KV] f32.
    Returns ctx [B, H, Q, Dh] in the compute dtype.

    On the card: one launch of B*H thread-block clusters of
    C = cluster_size(Dh) blocks (256 threads each; 64 blocks at B = 1,
    H = 8, Dh = 128), block r of a cluster taking keys [r*S/C, (r+1)*S/C)
    of the S = KV+Q keys. Needs Q <= 16, Dh a multiple of 16 and 16-byte
    aligned q_u, k_new, v_new and rings. Packed int4 rows are read as
    they are (8-byte copies at Dh = 16) and unpacked in the kernel."""
    if q_u.device.type == "cpu":
        return ring_attention_ref(layer, q_u, k_new, v_new, k_ring_all,
                                  v_ring_all, a, k_cols, v_cols,
                                  packed_int4=packed_int4)
    if q_u.device.type != "cuda":
        raise ValueError(f"fused_ring_attention: unsupported device "
                         f"{q_u.device}")
    B, H, Q, Dh = q_u.shape
    L, _, _, KV, _ = k_ring_all.shape
    dt = q_u.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused_ring_attention: compute dtype {dt}")
    ring_dt = k_ring_all.dtype
    if (ring_dt not in (dt, torch.int8) or v_ring_all.dtype != ring_dt
            or (packed_int4 and ring_dt != torch.int8)):
        raise TypeError(f"fused_ring_attention: ring dtypes {ring_dt}, "
                        f"{v_ring_all.dtype} with compute dtype {dt}"
                        f"{' (packed int4)' if packed_int4 else ''}")
    # ring type: 0 compute dtype, 1 int8, 2 packed int4 (Dh/2 bytes a row)
    ring_type = 2 if packed_int4 else (0 if ring_dt == dt else 1)
    d_ring = Dh // 2 if packed_int4 else Dh
    shapes = {"k_new": (k_new, (B, H, Q, Dh), dt),
              "v_new": (v_new, (B, H, Q, Dh), dt),
              "k_ring_all": (k_ring_all, (L, B, H, KV, d_ring), ring_dt),
              "v_ring_all": (v_ring_all, (L, B, H, KV, d_ring), ring_dt),
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
        _DTYPES[dt], ring_type, q_u.data_ptr(),
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
