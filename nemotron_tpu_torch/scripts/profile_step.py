"""Profile the fused chunk step and rank its device work.

The port's counterpart of scripts/profile_step.py, with its flags and
lines: `--steps` fused chunk steps (`streaming.session.chunk_step`, each
a `chunk_step` range) run under torch.profiler (`utils/profiler.profile`,
which waits 20 ms after the window opens: CUPTI loses the kernels of a
window's first milliseconds), the Chrome trace goes to `--dir`, and the
device's work is printed:

  - the total device time over the steps and a step;
  - the `--top` kernels (and copies) ranked by their device time, which is
    their self time (kernels do not nest), with each one's launches;
  - the device time by category (the port's three kernels, GEMMs,
    elementwise, reductions, copies, other);
  - the launches of each of the port's three kernels by name
    (`ring_attn*`, `q8_matmul*`, `w8a8_matmul*`), in all and a step.

    python -m nemotron_tpu_torch.scripts.profile_step [--batch 64]
        [--mode w8a8-int8kv|bf16] [--steps 3] [--dir DIR] [--top 25]
        [--rc 13] [--shared] [--quick] [--cpu]

Differences from the JAX script: the trace is torch.profiler's, not an
xplane; the batch defaults to the port's serving cell, 64 streams (the
JAX script's 800 was a TPU's); `--dir` defaults to `profile_step` under
the temporary directory; the JAX script's "by model stage" buckets read
XLA's fused-op names, which a CUDA kernel's name does not carry, so the
port prints the categories above instead. With --cpu there is no device
activity: the table then ranks the host's operators by their self time
and says so. Runs on the card unless --cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

from ._common import (SERVING_SLOTS, bench_config, bench_params, bench_states,
                      bench_w8a8, device_of, sync)

# the port's kernels by wrapper, and the prefix of their CUDA kernels' names
KERNELS = {"fused_ring_attention": "ring_attn", "q8_matmul": "q8_matmul",
           "w8a8_matmul": "w8a8_matmul"}
CATEGORIES = (("ring attention kernel", ("ring_attn",)),
              ("q8 kernel", ("q8_matmul",)),
              ("w8a8 kernel", ("w8a8_matmul",)),
              ("gemm", ("gemm", "cutlass", "cublas", "xmma", "matmul")),
              ("copy / fill", ("memcpy", "memset", "copy", "fill")),
              ("reduction", ("reduce", "softmax", "norm", "argmax")),
              ("elementwise", ("elementwise", "vectorized", "unrolled")))


def kernel_name(raw: str) -> str:
    """A CUDA kernel's name without its `void`, anonymous namespace and
    parameter list."""
    name = raw.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        name = name.rsplit("(", 1)[0]
    return name.removeprefix("void ")


def device_work(prof) -> tuple[dict, dict]:
    """({name: device us}, {name: launches}) of the device activity of a
    finished torch.profiler run (kernels, copies, fills; not the
    record_function ranges mirrored on the device's timeline), read from
    the raw activity records."""
    from torch.autograd import DeviceType

    us, count = {}, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", bool)()):
            name = kernel_name(e.name())
            us[name] = us.get(name, 0.0) + e.duration_ns() / 1e3
            count[name] = count.get(name, 0) + 1
    return us, count


def host_work(prof) -> tuple[dict, dict]:
    """({op: self host us}, {op: calls}): the ranking where no device ran."""
    us, count = {}, {}
    for e in prof.key_averages():
        if e.key.startswith("ProfilerStep") or e.key == "chunk_step":
            continue
        us[e.key] = e.self_cpu_time_total
        count[e.key] = e.count
    return us, count


def launches_by_kernel(count: dict) -> dict:
    """{wrapper: launches} from a {kernel name: launches} table."""
    return {w: sum(n for name, n in count.items() if name.startswith(p))
            for w, p in KERNELS.items()}


def category(name: str) -> str:
    low = name.lower()
    for cat, pats in CATEGORIES:
        if any(p in low for p in pats):
            return cat
    return "other"


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog="profile_step")
    ap.add_argument("--batch", type=int, default=SERVING_SLOTS)
    ap.add_argument("--mode", default="w8a8-int8kv",
                    choices=("w8a8-int8kv", "bf16"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "profile_step"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--rc", type=int, default=13,
                    help="latency mode (att_right_context)")
    ap.add_argument("--shared", action="store_true",
                    help="shared x-ring cache layout")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv[1:])

    from ..config import CacheConfig
    from ..models import encoder as enc_mod
    from ..params import cast_params
    from ..streaming.session import CHUNK_STEP_RANGE, chunk_step
    from ..utils import profiler

    device = device_of(args.cpu)
    cfg = bench_config(args.quick)
    if args.quick:
        args.batch = min(args.batch, 8)
    dtype = torch.bfloat16
    cc = CacheConfig(att_right_context=args.rc, n_mels=cfg.n_mels)
    if args.mode.endswith("int8kv"):
        cc = dataclasses.replace(cc, kv_cache_int8=True)
    if args.shared:
        cc = dataclasses.replace(cc, shared_cache=True)
    base = bench_params(cfg, device)
    if args.mode.startswith("w8a8"):
        base = bench_w8a8(base)
    params = cast_params(base, dtype)

    B = args.batch
    with torch.no_grad():
        pos_heads = enc_mod.precompute_pos_heads(params, cfg, cc, dtype)
        enc_state, dec_state = bench_states(cfg, cc, B, dtype, device)
        rng = np.random.default_rng(0)
        mel = torch.from_numpy(rng.standard_normal(
            (B, cc.chunk_mel_frames, cfg.n_mels))).to(device, dtype)
        # the first step's one-time work outside the trace
        _, enc_state, dec_state = chunk_step(params, cfg, cc, mel, enc_state,
                                             dec_state, pos_heads)
        sync(device)
        with profiler.profile(args.dir) as prof:
            for _ in range(args.steps):
                with torch.profiler.record_function(CHUNK_STEP_RANGE):
                    _, enc_state, dec_state = chunk_step(
                        params, cfg, cc, mel, enc_state, dec_state,
                        pos_heads)
    print(f"trace: {profiler.latest_trace(args.dir)}", file=sys.stderr)

    us, count = device_work(prof)
    where = "device"
    if not us:
        us, count = host_work(prof)
        where = "host (no device activity)"
    rows = sorted(us.items(), key=lambda kv: -kv[1])
    total = sum(us.values())
    steps = args.steps
    print(f"\ntotal {where} self time: {total / 1e3:.2f} ms over "
          f"{steps} steps ({total / 1e3 / steps:.2f} ms/step)")
    print(f"{'self ms/step':>12s}  {'%':>5s}  {'launches':>8s}  op")
    for name, t in rows[: args.top]:
        print(f"{t / 1e3 / steps:12.3f}  {100 * t / max(total, 1e-9):5.1f}  "
              f"{count[name]:8d}  {name[:90]}")
    by_cat: dict[str, float] = {}
    for name, t in rows:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + t
    print("\nby category (ms/step):")
    for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {v / 1e3 / steps:8.3f}  {k}")
    print("\nlaunches of the port's kernels by name:")
    for wrapper, n in launches_by_kernel(count).items():
        print(f"  {wrapper}: {n} launches ({n / steps:g} a step; "
              f"{KERNELS[wrapper]}*)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
