"""The benchmark's own tracer: ranges around the port's layer entry points,
and the reading of a torch.profiler trace into per-range device time,
host time, synchronisations, device busy time and idle gaps.

Ranges are `torch.profiler.record_function` wrappers installed over the
names the calling modules hold, only for the traced ticks. A name that
the port no longer has is skipped, and the metrics that read its range
are then left out of the result.

The trace reading is copied from the port's `utils/profiler.py` (the
Chrome trace, launch-to-device matching by correlation id, the 20 ms wait
after the profiler opens, since CUPTI loses the records of a window's
first kernels), so that later changes to the program cannot move it. A
range's device time here is the summed duration of the device work its
launches caused, not the span from its first to its last kernel.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import shutil
import tempfile
import time

import torch

PROFILE_HEAD_S = 0.02
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")

# range name -> (module, attribute) the calling code reaches the layer by
TARGETS = {
    "bench.frontend": [("nemotron_tpu_torch.streaming.lockstep",
                        "mel_frontend_step")],
    "bench.encoder": [("nemotron_tpu_torch.models.encoder",
                       "encode_chunk")],
    "bench.decode": [("nemotron_tpu_torch.models.decoder",
                      "greedy_decode")],
    "bench.attn": [("nemotron_tpu_torch.ops.rel_attention",
                    "fused_ring_attention")],
    "bench.qmm": [("nemotron_tpu_torch.ops.basic", "qmm"),
                  ("nemotron_tpu_torch.ops.conv", "qmm"),
                  ("nemotron_tpu_torch.ops.rel_attention", "qmm"),
                  ("nemotron_tpu_torch.ops.rel_attention", "qmm_shared"),
                  ("nemotron_tpu_torch.models.encoder", "qmm")],
}
TICK = "bench.tick"
COLLECT = "bench.collect"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class Spans:
    """Installs the ranges; records the shapes of the matmul and attention
    calls made inside them."""

    def __init__(self):
        self.calls = {"qmm": [], "attn": []}
        self._undo = []

    def _record_qmm(self, args):
        x, w = args[0], args[1]
        ws = w if isinstance(w, (list, tuple)) else [w]
        M = x.numel() // x.shape[-1]
        for wi in ws:
            q = getattr(wi, "q", wi)
            self.calls["qmm"].append((M, int(q.shape[-2]), int(q.shape[-1]),
                                      _dtype_name(x), _dtype_name(q)))

    def _record_attn(self, args):
        q_u, ring = args[1], args[4]
        B, H, Q, Dh = q_u.shape
        self.calls["attn"].append((B, H, Q, int(ring.shape[3]), Dh,
                                   _dtype_name(q_u), _dtype_name(ring)))

    def _wrap(self, name, fn, record=None):
        def wrapped(*args, **kwargs):
            if record is not None:
                record(args)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    def install(self, engine) -> None:
        rec = {"bench.qmm": self._record_qmm, "bench.attn": self._record_attn}
        for name, targets in TARGETS.items():
            for mod_name, attr in targets:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr, None)
                if fn is None:
                    continue
                setattr(mod, attr, self._wrap(name, fn, rec.get(name)))
                self._undo.append((mod, attr, fn))
        if hasattr(engine, "_collect"):
            engine._collect = self._wrap(COLLECT, engine._collect)
            self._undo.append((engine, "_collect", None))

    def remove(self) -> None:
        for obj, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
        self._undo = []


def profile_ticks(tick_fn, n: int, device) -> tuple[dict, list[float]]:
    """Run `tick_fn(i)` for i < n under torch.profiler, each tick in a
    `bench.tick` range; returns the trace read by `read_trace` and the
    ticks' host times (s)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    times = []
    try:
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(PROFILE_HEAD_S)
            for i in range(n):
                t0 = time.perf_counter()
                with torch.profiler.record_function(TICK):
                    tick_fn(i)
                times.append(time.perf_counter() - t0)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return read_trace([e for e in events
                       if e.get("ph") == "X" and "dur" in e]), times


def _merge(spans):
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def read_trace(events: list[dict]) -> dict:
    """Per range name: device seconds of the work launched inside it
    (`device_s`), host seconds (`host_s`), executions (`count`) and
    synchronising calls (`syncs`); the traced window (`window_s`, from the
    first tick's start to the last tick's end), the device's busy seconds
    in it (`busy_s`), the device operations by total time and the idle
    gaps by the host range they fell in (`breakdown`)."""
    ranges, launches, device = {}, [], {}
    host_ops = []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
            host_ops.append(e)
        elif cat == "cpu_op":
            host_ops.append(e)
        elif cat in LAUNCH_CATS:
            launches.append(e)
        elif cat in DEVICE_CATS:
            c = e.get("args", {}).get("correlation")
            device.setdefault(c, []).append(e)
    by_tid = {}
    for e in launches:
        by_tid.setdefault(e.get("tid"), []).append(e)
    for v in by_tid.values():
        v.sort(key=lambda e: e["ts"])
    keys = {t: [e["ts"] for e in v] for t, v in by_tid.items()}

    def inside(r):
        v, k = by_tid.get(r.get("tid"), []), keys.get(r.get("tid"), [])
        lo = bisect.bisect_left(k, r["ts"])
        hi = bisect.bisect_right(k, r["ts"] + r["dur"])
        return v[lo:hi]

    out = {"device_s": {}, "host_s": {}, "count": {}, "syncs": {}}
    for name, rs in ranges.items():
        dev = syncs = 0.0
        for r in rs:
            for e in inside(r):
                if e["name"].split("_v")[0] in SYNC_CALLS:
                    syncs += 1
                c = e.get("args", {}).get("correlation")
                dev += sum(k["dur"] for k in device.get(c, ()))
        out["device_s"][name] = dev / 1e6
        out["host_s"][name] = sum(r["dur"] for r in rs) / 1e6
        out["count"][name] = len(rs)
        out["syncs"][name] = int(syncs)

    ticks = sorted(ranges.get(TICK, []), key=lambda e: e["ts"])
    all_dev = [k for ks in device.values() for k in ks]
    if not ticks:
        out.update(window_s=0.0, busy_s=0.0, breakdown=None)
        return out
    w0, w1 = ticks[0]["ts"], ticks[-1]["ts"] + ticks[-1]["dur"]
    busy = _merge([(max(k["ts"], w0), min(k["ts"] + k["dur"], w1))
                   for k in all_dev if k["ts"] < w1 and k["ts"] + k["dur"] > w0])
    out["window_s"] = (w1 - w0) / 1e6
    out["busy_s"] = sum(hi - lo for lo, hi in busy) / 1e6

    per_op = {}
    for k in all_dev:
        if k["ts"] < w1 and k["ts"] + k["dur"] > w0:
            per_op[k["name"][:160]] = per_op.get(k["name"][:160], 0.0) \
                + k["dur"] / 1e6
    gaps, edges = [], [w0] + [x for s in busy for x in s] + [w1]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi > lo:
            gaps.append((lo, hi))
    main_tid = ticks[0].get("tid")
    hosts = sorted((e for e in host_ops if e.get("tid") == main_tid),
                   key=lambda e: e["ts"])
    starts = [e["ts"] for e in hosts]
    idle = {}
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        j = bisect.bisect_right(starts, mid)
        bench, op = None, None
        # the open host events at the gap's middle: the innermost bench
        # range and the innermost operation
        for e in hosts[max(0, j - 400):j]:
            if e["ts"] + e["dur"] >= mid:
                if e["name"].startswith("bench.") and e["name"] != TICK:
                    bench = e["name"]
                op = e["name"]
        label = bench or TICK
        if op is not None and op != label:
            label = f"{label} > {op}"
        idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e6
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    out["breakdown"] = {"device_ops": top(per_op), "idle_gaps": top(idle)}
    return out
