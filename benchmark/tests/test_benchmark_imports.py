"""Nothing the benchmark loads is JAX or the JAX package: top-level
module names compared whole, so the port (nemotron_tpu_torch) passes."""

from __future__ import annotations

import subprocess
import sys
import types
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nemotron_tpu_torch_fake",
                        types.ModuleType("nemotron_tpu_torch_fake"))
    assert "nemotron_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nemotron_tpu.fake",
                        types.ModuleType("nemotron_tpu.fake"))
    assert harness.forbidden_modules() == ["nemotron_tpu"]


def test_a_tiny_run_loads_no_jax():
    """A whole tiny run in a fresh process, then the loaded modules."""
    code = (
        "import time, tempfile, torch\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "root = tiny.make_root(Path(tempfile.mkdtemp()), blank_bias=2.0)\n"
        "harness.run('tiny', 1, 0.1, True, torch.device('cpu'),\n"
        "            time.perf_counter(), root=root, log=lambda s: None)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "bf16-r13-1024", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build")})
    assert out.returncode != 0 and out.stdout == ""
