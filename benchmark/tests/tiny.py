"""A tiny cell in a temporary root, for the CPU tests: the real metric
readers and BENCHMARK.json's metrics, a small model and few streams."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"n_mels": 32, "d_model": 64, "n_heads": 4, "d_head": 16,
              "d_ff": 128, "n_layers": 2, "kernel_size": 9,
              "vocab_size": 33, "decoder_dim": 32, "decoder_layers": 2,
              "joint_dim": 32, "subsampling_channels": 16,
              "subsampling_factor": 8}


def make_root(tmp: Path, *, matmul="dense", kv_cache="dense", R=13,
              streams=4, dtype="float32", blank_bias=2.0,
              limits=None, name="tiny", weights_seed=6) -> Path:
    """tmp as a checkout holding one cell `name` (and the real per-layer
    metric readers); returns tmp."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp / "benchmark"
    for d in ("configs", "traffic", "workloads"):
        (here / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "benchmark" / "metrics", here / "metrics",
                    dirs_exist_ok=True)
    conf = json.loads((ROOT / "benchmark" / "configs" /
                       "nemotron-0.6b-bf16.json").read_text())
    conf.update(name=f"{name}-config", model=TINY_MODEL,
                compute_dtype=dtype, matmul=matmul, kv_cache=kv_cache)
    conf["init"] = {"scale": 0.2}
    conf["assumed"] = dict(conf["assumed"], blank_bias=blank_bias)
    conf["weights_seed"] = weights_seed
    (here / "configs" / f"{name}-config.json").write_text(json.dumps(conf))
    tr = json.loads((ROOT / "benchmark" / "traffic" /
                     "closed-r13-1024.json").read_text())
    tr.update(latency_mode=R, streams=streams, bank_ticks=3,
              warm_ticks=70 // (1 + R) + 1, trace_ticks=2)
    (here / "traffic" / f"{name}-traffic.json").write_text(json.dumps(tr))
    cell = {"check_streams": 3,
            "limits": limits or {"logit_gap": 1e-3, "state_rel": 1e-3}}
    (here / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    bench["configs"] = [{"name": f"{name}-config", "source": "test",
                         "file": f"benchmark/configs/{name}-config.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": name, "config": f"{name}-config",
                           "traffic": f"{name}-traffic", "chips": 1,
                           "why": "test"}]
    for m in bench["per_layer"]:
        m["workloads"] = [name]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
