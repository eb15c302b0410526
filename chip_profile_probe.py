#!/usr/bin/env python3
"""How often torch.profiler's CUDA trace loses a kernel launch, on one GPU.

    python3 chip_profile_probe.py [--windows N] [--child]

A launch check that reads a profile (one W8A8 launch a call, tests/
test_torch_w8a8.py::test_w8a8_matmul_kernel_is_deterministic_and_one_
launch) once found no CUDA event in its window, and the CTC decode's few
launches showed up only in part in chip_smoke.py's engine profile. This
script opens N profiler windows of each kind below around launches whose
count is known and prints, for each kind, the windows that came back with
fewer kernel records than launches, with the trace's start and the first
kernel records of a few of them:

  cuda_only       activities=[CUDA], one W8A8 launch, synchronize inside
                  (the test's window, at its largest and smallest shape;
                  10 N windows at the largest)
  cpu_and_cuda    the same with the CPU activity as well
  tail            CUDA only, the launch, a synchronize, then one short
                  kernel (torch.cuda._sleep's spin_kernel) and a
                  synchronize before the window closes
                  (10 N windows at the largest shape)
  ctc             CUDA only, CTC's frame_ids at a 64-slot chunk, against
                  its kernel count in a window with the CPU activity too
  head            CUDA only, HEAD_S of host sleep inside the window
                  before the launch (10 N windows at the largest shape)
  ctc_download    CPU and CUDA, one bf16 CTC decode of a 64-slot chunk
                  with its ids downloaded (chip_smoke.py's decode window),
                  10 N windows; ctc_download_tail and ctc_download_head
                  the same with the tail or the head

For the windows that did record the counted kernels, the offset of the
first one from the trace's start (ms: min, median, max) is printed too.

The child process (--child) runs the same windows with
DISABLE_CUPTI_LAZY_REINIT=1, so that CUPTI is not re-initialised between
profiler sessions. The last line is one JSON object of the counts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HEAD_S = 0.02


def kernels_of(prof) -> list:
    """(name, start_ns, end_ns) of every CUDA kernel record of a finished
    profile, from the raw activity records."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def window(fn, cpu: bool = False):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    start = getattr(prof.profiler.kineto_results, "trace_start_ns",
                    lambda: None)()
    return kernels_of(prof), start


def probe(n: int) -> dict:
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nemotron_tpu_torch.ops import cuda_build
    from nemotron_tpu_torch.ops.quant import quantize_tensor_w8a8
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul

    cuda_build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    shapes = {}
    for M, K, N in ((3584, 1024, 4096), (8, 4096, 1024)):
        qt = quantize_tensor_w8a8(rng.standard_normal((K, N)).astype(
            np.float32) * 0.05)
        x = torch.tensor(rng.standard_normal((M, K)).astype(np.float32),
                         device=dev).bfloat16()
        q = torch.tensor(qt.q, device=dev)
        cs = torch.tensor(qt.col_scale, device=dev)
        w8a8_matmul(x, q, cs)
        shapes[f"{M}x{K}x{N}"] = (x, q, cs)
    out: dict = {}

    def count_misses(name, fn, n_windows, want, cpu=False, match=None):
        misses, examples, offsets = 0, [], []
        t0 = time.perf_counter()
        for i in range(n_windows):
            ks, start = window(fn, cpu=cpu)
            got = [k for k in ks if match is None or match in k[0]]
            if len(got) < want:
                misses += 1
                if len(examples) < 3:
                    examples.append(dict(window=i, trace_start=start,
                                         kernels=ks[:4], got=len(got)))
            elif start is not None and got:
                offsets.append((min(k[1] for k in got) - start) / 1e6)
        out[name] = dict(windows=n_windows, misses=misses,
                         examples=examples,
                         seconds=time.perf_counter() - t0,
                         first_kernel_ms=[float(np.min(offsets)),
                                          float(np.median(offsets)),
                                          float(np.max(offsets))]
                         if offsets else None)

    for shape, (x, q, cs) in shapes.items():
        big = shape.startswith("3584")
        for kind in ("cuda_only", "cpu_and_cuda", "tail", "head"):
            def fn(x=x, q=q, cs=cs, kind=kind):
                if kind == "head":
                    time.sleep(HEAD_S)
                w8a8_matmul(x, q, cs)
                if kind == "tail":
                    torch.cuda.synchronize()
                    torch.cuda._sleep(100)
            count_misses(f"{kind} {shape}", fn,
                         10 * n if big and kind != "cpu_and_cuda" else n, 1,
                         cpu=kind == "cpu_and_cuda", match="w8a8_matmul")

    # CTC: frame_ids of a 64-slot R = 13 chunk, the count of kernels
    from nemotron_tpu_torch.config import ModelConfig
    from nemotron_tpu_torch.models.ctc import frame_ids
    from nemotron_tpu_torch.params import (params_from_arrays,
                                           random_weight_arrays)

    cfg = ModelConfig(n_layers=1)
    params = params_from_arrays(random_weight_arrays(cfg, ctc_head=True),
                                cfg, device=dev)
    enc = torch.tensor(rng.standard_normal((64, 14, cfg.d_model)).astype(
        np.float32), device=dev)
    frame_ids(params, enc)
    want = len(window(lambda: frame_ids(params, enc), cpu=True)[0])
    counts = [len(window(lambda: frame_ids(params, enc))[0])
              for _ in range(n)]
    out["ctc frame_ids"] = dict(windows=n, kernels_with_cpu=want,
                                counts=sorted(set(counts)),
                                misses=sum(c != want for c in counts))

    # chip_smoke.py's window: one bf16 decode with its ids downloaded
    from nemotron_tpu_torch.params import cast_params

    p16 = cast_params(params, torch.bfloat16)
    e16 = enc.bfloat16()

    def decode():
        frame_ids(p16, e16).cpu()

    def decode_tail():
        decode()
        torch.cuda.synchronize()
        torch.cuda._sleep(100)

    decode()
    want = len(window(decode, cpu=True)[0])
    count_misses("ctc_download", decode, 10 * n, want, cpu=True)
    count_misses("ctc_download_tail", decode_tail, 10 * n, want + 1,
                 cpu=True)

    def decode_head():
        time.sleep(HEAD_S)
        decode()

    count_misses("ctc_download_head", decode_head, 10 * n, want, cpu=True)
    out["ctc_download"]["kernels"] = want
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    n = int(argv[argv.index("--windows") + 1]) if "--windows" in argv else 100
    res = {"lazy_reinit_default": probe(n)}
    if "--child" in argv:
        print(json.dumps(res))
        return 0
    env = dict(os.environ, DISABLE_CUPTI_LAZY_REINIT="1")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        "--windows", str(n)], capture_output=True, text=True,
                       env=env, timeout=1200)
    child = (json.loads(r.stdout.strip().splitlines()[-1]) if r.returncode
             == 0 else {"error": r.stderr[-2000:]})
    res["DISABLE_CUPTI_LAZY_REINIT=1"] = child.get("lazy_reinit_default",
                                                    child)
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    res["card"] = r.stdout.strip()
    res["torch"] = torch.__version__
    for mode, rows in res.items():
        if isinstance(rows, dict):
            for k, v in rows.items():
                print(f"{mode:28s} {k:32s} misses {v.get('misses')} of "
                      f"{v.get('windows')}; first kernel at "
                      f"{v.get('first_kernel_ms')} ms", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
