"""Per-step device times from torch.profiler traces (utils/profiler.py,
the port's counterpart of nemotron_tpu/utils/xplane.py) on the CPU: the
three functions on synthetic Chrome traces with known durations (device
annotations, kernels matched to their launches by correlation id, and a
trace without device activity), a real CPU profile of a tiny session
whose annotated chunk steps are counted, and `cli --profile=DIR --cpu`
writing a trace and printing the JAX CLI's line, with the JAX CLI's
transcript on stdout."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.params import load_model
from nemotron_tpu_torch.streaming.session import (CHUNK_STEP_RANGE,
                                                  StreamSession)
from nemotron_tpu_torch.utils import profiler
from nemotron_tpu_torch.utils import tones as ttones

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
STEP_MS = [5.0, 1.0, 2.0, 3.0, 4.0, 10.0]


def write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def annotated_trace():
    """Host ranges "step" (one per STEP_MS entry, started out of order in
    the file) with their device annotations, plus a "load" range."""
    ev = []
    for i, ms in enumerate(STEP_MS):
        t0 = 1000.0 * (i + 1) * 20
        ev.append(x("step", "user_annotation", t0, 900.0))
        ev.append(x("step", "gpu_user_annotation", t0 + 50, ms * 1e3, tid=7))
    ev.append(x("load", "user_annotation", 10.0, 5.0))
    ev.append(x("load", "gpu_user_annotation", 12.0, 3000.0, tid=7))
    ev.append({"ph": "M", "name": "process_name", "pid": 1})
    return ev[::-1]


def correlated_trace():
    """Host ranges without device annotations: each launches two kernels
    (correlation ids), one range launches none, and a launch on another
    thread inside a range's span belongs to that thread only."""
    ev, cid = [], 0
    for i, (a, b) in enumerate(((100.0, 400.0), (50.0, 2000.0))):
        t0 = 10000.0 * (i + 1)
        ev.append(x("step", "user_annotation", t0, 100.0))
        for j, (start, dur) in enumerate(((t0 + 500, a), (t0 + 800, b))):
            cid += 1
            ev.append(x("cudaLaunchKernel", "cuda_runtime",
                        t0 + 10 + j, 2.0, correlation=cid))
            ev.append(x("k", "kernel", start, dur, tid=9, correlation=cid))
    ev.append(x("step", "user_annotation", 50000.0, 100.0))
    cid += 1
    ev.append(x("cudaLaunchKernel", "cuda_runtime", 50010.0, 2.0, tid=2,
                correlation=cid))
    ev.append(x("k", "kernel", 50500.0, 77.0, tid=9, correlation=cid))
    return ev


def test_module_durations_from_device_annotations(tmp_path):
    path = str(tmp_path / "a.pt.trace.json")
    write_trace(path, annotated_trace())
    got = profiler.module_durations_ms(path)
    assert got == {"step": STEP_MS, "load": [3.0]}


def test_module_durations_from_correlated_kernels(tmp_path):
    """The span from the first kernel's start to the last one's end
    (the gaps between kernels included); a range that launched nothing on
    its thread gets 0."""
    path = str(tmp_path / "c.pt.trace.json")
    write_trace(path, correlated_trace())
    got = profiler.module_durations_ms(path)["step"]
    assert got == pytest.approx([(10800 + 400 - 10500) / 1e3,
                                 (20800 + 2000 - 20500) / 1e3, 0.0])


def test_module_durations_without_device_activity(tmp_path):
    """A CPU-only trace: each range's own duration."""
    path = str(tmp_path / "h.pt.trace.json")
    write_trace(path, [x("step", "user_annotation", 10.0 * i, 1000.0 * i)
                       for i in (3, 1, 2)] + [x("op", "cpu_op", 0.0, 5.0)])
    assert profiler.module_durations_ms(path) == {"step": [1.0, 2.0, 3.0]}


def test_step_percentiles_and_latest_trace(tmp_path):
    """The range with the most executions by default (or the one `match`
    names), `drop_first` leading executions dropped, from the newest
    trace under the directory (subdirectories included)."""
    old = tmp_path / "run" / "old.pt.trace.json"
    old.parent.mkdir()
    write_trace(str(old), [x("step", "user_annotation", 0.0, 1.0)])
    time.sleep(0.01)
    new = tmp_path / "run" / "deeper" / "new.pt.trace.json"
    new.parent.mkdir()
    write_trace(str(new), annotated_trace())
    os.utime(old, (1, 1))
    assert profiler.latest_trace(str(tmp_path)) == str(new)
    t = np.asarray(STEP_MS[1:])
    want = {"module": "step", "n_steps": 5,
            "p50_ms": float(np.percentile(t, 50)),
            "p90_ms": float(np.percentile(t, 90)),
            "p99_ms": float(np.percentile(t, 99)),
            "mean_ms": float(t.mean()), "max_ms": 10.0}
    assert profiler.step_percentiles(str(tmp_path)) == want
    got = profiler.step_percentiles(str(tmp_path), match="loa", drop_first=0)
    assert (got["module"], got["n_steps"], got["max_ms"]) == ("load", 1, 3.0)
    # dropping every execution keeps them all, as JAX's does
    assert profiler.step_percentiles(str(tmp_path), match="load")[
        "n_steps"] == 1
    with pytest.raises(ValueError, match="nope"):
        profiler.step_percentiles(str(tmp_path), match="nope")
    with pytest.raises(FileNotFoundError):
        profiler.latest_trace(str(tmp_path / "run" / "empty"))


def test_profile_of_a_session_counts_its_chunk_steps(tmp_path):
    """profile() around a tiny session on the CPU: one trace file, one
    chunk_step range per chunk, each with a positive time; step_percentiles
    reports the chunks less drop_first."""
    p, cfg, vocab = load_model(FIXTURE, device="cpu")
    audio, _ = ttones.make_eval_streams(1, 3.0, 16, seed=4)
    sess = StreamSession(p, cfg, vocab, TCC(att_right_context=6,
                                            n_mels=cfg.n_mels))
    d = str(tmp_path / "prof")
    with profiler.profile(d):
        sess.process(audio[0])
    assert len(os.listdir(d)) == 1 and sess.total_chunks >= 4
    durs = profiler.module_durations_ms(profiler.latest_trace(d))
    assert len(durs[CHUNK_STEP_RANGE]) == sess.total_chunks
    assert min(durs[CHUNK_STEP_RANGE]) > 0
    st = profiler.step_percentiles(d, match=CHUNK_STEP_RANGE)
    assert st["module"] == CHUNK_STEP_RANGE
    assert st["n_steps"] == sess.total_chunks - 1
    assert 0 < st["p50_ms"] <= st["max_ms"]


def test_cli_profile_writes_a_trace_and_prints_jax_line(tmp_path):
    """`python -m nemotron_tpu_torch.cli ... --profile=DIR --cpu` exits 0,
    writes one Chrome trace whose chunk steps are the CLI's chunk count,
    prints "profiler trace written to DIR" on stderr as the JAX CLI does,
    and its stdout is the JAX CLI's."""
    audio, _ = ttones.make_eval_streams(1, 3.0, 16, seed=5)
    pcm = tmp_path / "a.pcm"
    audio[0].astype("<i2").tofile(pcm)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    d = str(tmp_path / "prof")
    r = subprocess.run([sys.executable, "-m", "nemotron_tpu_torch.cli",
                        FIXTURE, str(pcm), "80", "13", "--cpu",
                        f"--profile={d}"], capture_output=True, text=True,
                       timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert f"profiler trace written to {d}\n" in r.stderr
    chunks = int(r.stderr.split("processed ")[1].split()[0])
    durs = profiler.module_durations_ms(profiler.latest_trace(d))
    assert len(durs[CHUNK_STEP_RANGE]) == chunks > 1
    j = subprocess.run([sys.executable,
                        os.path.join(REPO, "cli", "transcribe_stream.py"),
                        FIXTURE, str(pcm), "80", "13", "--cpu"],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert j.returncode == 0, j.stderr
    assert r.stdout == j.stdout and len(r.stdout.strip()) > 5
