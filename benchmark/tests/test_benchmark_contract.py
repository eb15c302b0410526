"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric it names resolved to its file."""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

import torch

from benchmark import check, harness
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_limits():
    b = bench()
    assert set(b) == KEYS
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    for n in names:
        assert NAME.match(n), n
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert line(w["why"]) and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert line(c["why"]) and line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])


def test_metrics_entries():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", cells):
            assert harness.applies(e2e[m["moves"]], cell)
    for cell in cells:
        assert harness.applies(e2e["setup_s"], cell)
        assert any(harness.applies(m, cell) for m in b["per_layer"])
        assert sum(harness.applies(m, cell) for m in b["end_to_end"]) >= 2


def test_every_cell_resolves_to_its_files():
    b = bench()
    used = set()
    for w in b["workloads"]:
        c = harness.load_cell(w["name"])
        used.add(w["config"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["latency_mode"] in (0, 1, 6, 13)
        assert set(c["cell"]["limits"]) <= set(check.NUMBERS)
    assert used == {c["name"] for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith(b["paths"][0] + "/") and (ROOT / f).is_file()
    for m in b["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_cell_config_and_metric_are_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and new entries: the harness runs the cell and reads the
    metric without an edit anywhere else. So is a quantity under a name
    of the cell's own (`x.added`, with a bound of its own): entries
    alone, read by the quantity's file."""
    root = tiny.make_root(tmp_path, name="added", blank_bias=2.0)
    here = root / "benchmark"
    (here / "metrics" / "tick_count.py").write_text(
        "def read(ctx):\n    return float(ctx['trace']['ticks'])\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "tick_count", "unit": "ticks",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine (streaming/lockstep)",
                           "moves": "audio_throughput",
                           "workloads": ["added"]})
    b["end_to_end"].append({"name": "audio_throughput.added",
                            "unit": "audio_s/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["added"]})
    b["per_layer"].append({"name": "collect_ms.added", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "engine (streaming/lockstep)",
                           "moves": "audio_throughput.added",
                           "workloads": ["added"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    out = harness.run("added", 3, 0.2, True, torch.device("cpu"),
                      time.perf_counter(), root=root, log=lambda s: None)
    assert out["metrics"]["tick_count"]["value"] == 2.0
    assert out["metrics"]["collect_ms.added"]["value"] > 0
    plain = harness.run("added", 3, 0.2, False, torch.device("cpu"),
                        time.perf_counter(), root=root, log=lambda s: None)
    assert plain["metrics"]["audio_throughput.added"]["value"] > 0
    assert out["correct"]
    assert list(out)[-1] == "checks"
    shutil.rmtree(root / "benchmark")
