"""On the card: a tiny cell's whole run through the port's kernels, traced,
with the check at the limits a sound f32 run meets. Skips without a
card."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("matmul,kv", [("dense", "dense"), ("w8a8", "int8")])
def test_tiny_cell_on_the_card(tmp_path, matmul, kv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny.make_root(tmp_path, blank_bias=2.0, matmul=matmul,
                          kv_cache=kv, limits={"logit_gap": 0.5,
                                               "state_rel": 0.05})
    out = harness.run("tiny", 77, 0.5, True, torch.device("cuda", 0),
                      time.perf_counter(), root=root, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    for name in ("encoder_ms", "attn_roofline", "matmul_roofline",
                 "step_mfu", "device_idle", "collect_ms"):
        assert name in out["metrics"], name
    assert out["metrics"]["attn_roofline"]["value"] <= 105.0
    assert out["metrics"]["matmul_roofline"]["value"] <= 105.0
