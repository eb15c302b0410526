"""Per-step device times from a torch.profiler trace.

The port's counterpart of `nemotron_tpu/utils/xplane.py`, which reads the
TPU profiler's per-module execution times. Here a step is a
`torch.profiler.record_function` range (the session's chunk step is one,
`streaming.session.CHUNK_STEP_RANGE`), and a trace is the Chrome trace
JSON that torch.profiler exports (`*.pt.trace.json`). A range's device
time is the span, on the device's timeline, from the first start to the
last end of the device work launched inside it: its kernels, copies and
memsets, matched to the range's launch calls through their correlation
ids, whatever stream they ran on. A trace without launch records falls
back to the profiler's own device-side copies of the ranges (category
`gpu_user_annotation`, one a range and stream, merged a range), and a
trace with no device activity at all (a CPU run) gives each range its
own host duration.

`profile(dir)` opens such a trace window: it waits PROFILE_HEAD_S after
starting the profiler, because CUPTI drops the records of kernels that
run in a window's first milliseconds (PERF.md §7), and exports the trace
into `dir` when it closes.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import socket
import time

# the wait after a profiler window opens (chip_profile_probe.py: 0 of 4200
# windows lost a kernel 20 ms in)
PROFILE_HEAD_S = 0.02
TRACE_SUFFIX = ".pt.trace.json"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile(trace_dir: str):
    """Profile the body (CPU activity, and CUDA where there is a card) and
    write its Chrome trace to `trace_dir/<host>_<pid>.<ns>.pt.trace.json`;
    yields the profiler. The body starts PROFILE_HEAD_S after the window
    opens."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(PROFILE_HEAD_S)
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                   f"{time.time_ns()}{TRACE_SUFFIX}"))


def latest_trace(trace_dir: str) -> str:
    """Newest *.pt.trace.json under a trace directory."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {trace_dir}")
    return paths[-1]


def _events(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _kernel_spans(ranges: list[dict], events: list[dict]) -> list[float]:
    """Each host range's device time (ms): from the first start to the
    last end of the device work launched inside it."""
    device = {}
    for e in events:
        if e.get("cat") in _DEVICE_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                device.setdefault(c, []).append(e)
    launches = [e for e in events if e.get("cat") in _LAUNCH_CATS]
    out = []
    for r in ranges:
        lo, hi = r["ts"], r["ts"] + r["dur"]
        work = [k for e in launches
                if e.get("tid") == r.get("tid") and lo <= e["ts"] <= hi
                for k in device.get(e.get("args", {}).get("correlation"), ())]
        out.append((max(k["ts"] + k["dur"] for k in work)
                    - min(k["ts"] for k in work)) / 1e3 if work else 0.0)
    return out


def _merged_annotations(events: list[dict]) -> list[float]:
    """Device-side annotations of one range name, one per stream an
    execution: overlapping ones merged into one span each (ms)."""
    spans = []
    for e in sorted(events, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if spans and lo <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], hi)
        else:
            spans.append([lo, hi])
    return [(hi - lo) / 1e3 for lo, hi in spans]


def module_durations_ms(trace_path: str) -> dict[str, list[float]]:
    """Device time (ms) of every execution of every record_function range,
    in start order, keyed by the range's name: the span of the device work
    launched inside it; without launch records in the trace, from its
    `gpu_user_annotation` events; with no device activity at all, the
    range's host duration."""
    events = _events(trace_path)
    host, gpu = {}, {}
    for e in events:
        if e.get("cat") == "user_annotation":
            host.setdefault(e["name"], []).append(e)
        elif e.get("cat") == "gpu_user_annotation":
            gpu.setdefault(e["name"], []).append(e)
    launched = any(e.get("cat") in _LAUNCH_CATS for e in events)
    has_device = any(e.get("cat") in _DEVICE_CATS for e in events)
    out = {}
    for name in host.keys() | gpu.keys():
        ranges = sorted(host.get(name, ()), key=lambda e: e["ts"])
        if ranges and launched:
            out[name] = _kernel_spans(ranges, events)
        elif name in gpu:
            out[name] = _merged_annotations(gpu[name])
        else:
            out[name] = ([e["dur"] / 1e3 for e in ranges] if not has_device
                         else [0.0] * len(ranges))
    return out


def step_percentiles(trace_dir: str, match: str = "",
                     drop_first: int = 1) -> dict:
    """Percentile summary of per-execution device times of the range whose
    name contains `match` (default: the range with the most executions)
    in the newest trace under `trace_dir`. `drop_first` leading executions
    are discarded (the first step often carries one-time work).

    Returns {module, n_steps, p50_ms, p90_ms, p99_ms, mean_ms, max_ms}."""
    import numpy as np

    durs = module_durations_ms(latest_trace(trace_dir))
    if match:
        durs = {k: v for k, v in durs.items() if match in k}
    if not durs:
        raise ValueError(f"no record_function ranges matching {match!r}")
    name = max(durs, key=lambda k: len(durs[k]))
    t = np.asarray(durs[name][drop_first:] or durs[name])
    return {
        "module": name,
        "n_steps": int(t.size),
        "p50_ms": float(np.percentile(t, 50)),
        "p90_ms": float(np.percentile(t, 90)),
        "p99_ms": float(np.percentile(t, 99)),
        "mean_ms": float(t.mean()),
        "max_ms": float(t.max()),
    }
