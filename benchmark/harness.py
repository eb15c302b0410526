"""One run of one cell: set-up, the measured window, the traced ticks and
the correctness check, driven entirely by data.

A cell is found by its name in `BENCHMARK.json`: its entry names a
configuration (whose file the entry of `configs` gives) and a traffic
mix (`benchmark/traffic/<traffic>.json`); the cell's own file
(`benchmark/workloads/<cell>.json`) holds the limits of its check. Each
per-layer metric is read by `benchmark/metrics/<name>.py`. Adding a cell,
a configuration or a metric adds files and entries; nothing here names
one.

The window drives `LockstepEngine.tick` of `nemotron_tpu_torch` in a
closed loop: every stream gets one chunk's shift of PCM a tick, and the
next tick starts when `tick` has returned every stream's new text.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, model, roofline, trace
from . import traffic as traffic_mod

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "nemotron_tpu")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell names, by file."""
    bench = _load(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(work))})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "benchmark"
    return {"bench": bench, "workload": w,
            "config": _load(root / conf["file"]),
            "traffic": _load(here / "traffic" / f"{w['traffic']}.json"),
            "cell": _load(here / "workloads" / f"{name}.json"),
            "root": root}


def applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether a metric belongs to a cell: listed, or unlisted and the
    end-to-end metric it moves is reported there."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def base(name: str) -> str:
    """A metric's quantity: its name up to the first '.'. `x.r0` is the
    quantity `x` in the cells whose end-to-end metrics carry `.r0`."""
    return name.split(".")[0]


def reader(name: str, root: Path = ROOT):
    """The `read(ctx)` of benchmark/metrics/<name>.py, or, where a metric
    has no reader of its own, of its quantity's (`base`)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{base(name)}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: nemotron_tpu_torch is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
             "nounits", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def build_engine(c: dict, w: dict, device, overrides: dict | None = None):
    """The program under test over the benchmark's weights `w`: the port's
    parameters (quantized by the port where the configuration says W8A8)
    and a LockstepEngine over every stream of the traffic."""
    from nemotron_tpu_torch import params as P
    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine

    config = dict(c["config"], **(overrides or {}))
    tr = c["traffic"]
    params = model.port_params(w, config)
    if config["matmul"] != "dense":
        # the dense draw is not served: keep no view of it
        params = P.map_leaves(lambda x: x.clone()
                              if isinstance(x, torch.Tensor) else x, params)
    cc = CacheConfig(att_right_context=tr["latency_mode"],
                     kv_cache_int8=config["kv_cache"] == "int8",
                     kv_cache_int4=config["kv_cache"] == "int4")
    cfg = model.model_config(config)
    return LockstepEngine(params, cfg, vocab=model.vocab(cfg.vocab_size),
                          cache_config=cc, n_streams=tr["streams"],
                          compute_dtype=model.DTYPES[config["compute_dtype"]])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(name: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, root: Path = ROOT, overrides: dict | None = None,
        log=print) -> dict:
    """One run of cell `name`; returns the result line's object.
    `overrides` replace keys of the configuration on the program's side
    only (a control: the reference keeps the configuration's precision)."""
    c = load_cell(name, root)
    config, tr, cell = c["config"], c["traffic"], c["cell"]
    m, S = config["model"], tr["streams"]
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    stages = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    bank = traffic_mod.make_bank(tr, seed, device)
    K = bank.shape[0]
    w = model.make_weights(config, device)
    _sync(device)
    stages["inputs"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    engine = build_engine(c, w, device, overrides)
    del w
    _sync(device)
    stages["engine"] = time.perf_counter() - t
    t = time.perf_counter()
    tick = 0
    for _ in range(tr["warm_ticks"]):
        engine.tick(bank[tick % K])
        tick += 1
    _sync(device)
    stages["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    audio_tick_s = traffic_mod.shift_samples(tr["latency_mode"]) / 16000.0

    # -- the window ---------------------------------------------------------
    times, tokens0 = [], sum(len(t) for t in engine.tokens)
    tr_out = None
    t0 = time.perf_counter()
    if traced:
        spans = trace.Spans()
        spans.install(engine)
        chunks0 = engine.total_chunks

        def one(_):
            nonlocal tick
            engine.tick(bank[tick % K])
            tick += 1
        try:
            tr_out, times = trace.profile_ticks(one, tr["trace_ticks"], device)
        finally:
            spans.remove()
        tr_out["calls"] = spans.calls
        tr_out["ticks"] = len(times)
        tr_out["chunks"] = engine.total_chunks - chunks0
        tr_out["tokens"] = sum(len(t) for t in engine.tokens) - tokens0
        tr_out["tick_s"] = times
        times = list(times)
    while True:
        ts = time.perf_counter()
        engine.tick(bank[tick % K])
        tick += 1
        te = time.perf_counter()
        times.append(te - ts)
        if te - t0 >= seconds:
            break
    window_s = te - t0
    n_window = len(times)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {', '.join(bad)}")

    # -- the check -------------------------------------------------------------
    emitted = sum(len(t) for t in engine.tokens) - tokens0
    served = check.served_tick(engine, bank[tick % K])
    tick += 1
    streams = check.sample_streams(engine.tokens, cell["check_streams"],
                                   seed)
    snap = check.snapshot(engine, streams, served)
    del served
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    w = model.make_weights(config, device)
    t_check = time.perf_counter()
    got = check.compare(snap, w, config, tr, bank, tick, device)
    check_s = time.perf_counter() - t_check
    del w, snap
    limits = cell["limits"]
    checks = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    # -- the metrics -----------------------------------------------------------
    bench = c["bench"]
    dev = device_info(device)
    dev["memory_peak_bytes"] = int(peak)
    rate = S * audio_tick_s * n_window / window_s
    e2e = {"audio_throughput": rate,
           "tick_p95_ms": float(np.percentile(np.asarray(times) * 1e3, 95)),
           "peak_gib": peak / 2 ** 30, "setup_s": setup_s}
    units = {x["name"]: x["unit"] for x in bench["end_to_end"]
             + bench["per_layer"]}
    reported = {x["name"] for x in bench["end_to_end"]
                if applies(x, name)}
    metrics = {}
    if not traced:
        for k in sorted(reported):
            metrics[k] = {"value": e2e[base(k)], "unit": units[k]}
    else:
        ctx = {"trace": tr_out, "config": config, "traffic": tr,
               "roofline": roofline, "streams": S, "device": dev,
               "window_tick_s": times[tr_out["ticks"]:]}
        for x in bench["per_layer"]:
            if not applies(x, name, reported):
                continue
            v = reader(x["name"], root)(ctx)
            if v is not None:
                metrics[x["name"]] = {"value": v, "unit": units[x["name"]]}
        dev["busy_s"] = tr_out["busy_s"]
        dev["window_s"] = tr_out["window_s"]
    out = {"correct": bool(correct), "attempted": n_window * S, "failed": 0,
           "metrics": metrics, "device": dev}
    if traced and tr_out.get("breakdown"):
        out["breakdown"] = tr_out["breakdown"]
    log(f"window {window_s:.3f} s, {n_window} ticks after {tr['warm_ticks']}"
        f" warm, {emitted} tokens emitted "
        f"({emitted / (S * audio_tick_s * n_window):.4f} per audio second "
        f"a stream); check over {got['streams']} streams, {got['tokens']} "
        f"tokens, {got['decisions']} decisions ({got['flips']} not the "
        f"reference's best) in {check_s:.1f} s; e2e "
        + json.dumps(e2e))
    log("set-up " + json.dumps(stages))
    for k, v in checks.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    out["tokens_per_audio_s"] = emitted / (S * audio_tick_s * n_window)
    out["setup_stages_s"] = stages
    # the window's untraced ticks in thirds: whether a run's rate drifts
    # within it or only from run to run
    plain = np.asarray(times[tr_out["ticks"]:] if traced else times)
    out["thirds_tick_ms"] = [float(x.mean() * 1e3)
                             for x in np.array_split(plain, 3) if len(x)]
    if traced:
        # what the profiler adds to a tick, against the window's
        out["profiled_tick_ms"] = float(np.mean(tr_out["tick_s"]) * 1e3)
        out["window_tick_ms"] = float(plain.mean() * 1e3)
    out["readings"] = {k: got[k] for k in (
        "tokens", "decisions", "flips", "logit_gap", "rows_missing",
        "pred_rel",
        "joint_rel", "state_rel", "state_first", "state_layers")}
    out["checks"] = checks
    return out
