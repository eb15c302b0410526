"""The plain reference against the port at a tiny width on the CPU: the
harness's own check, over a whole run of a tiny cell, with nothing
broken. In f32 the two differ only in summation order."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import model as ref
from benchmark.tests import tiny


def run_tiny(tmp_path, **kw):
    root = tiny.make_root(tmp_path, blank_bias=2.0, **kw)
    return harness.run("tiny", 20260101, 0.2, False, torch.device("cpu"),
                       time.perf_counter(), root=root, log=lambda s: None)


@pytest.mark.parametrize("R", [13, 0])
@pytest.mark.parametrize("matmul,kv", [("dense", "dense"),
                                       ("w8a8", "int8")])
def test_reference_agrees_in_f32(tmp_path, R, matmul, kv):
    tol = 1e-5 if matmul == "dense" else 1e-2
    out = run_tiny(tmp_path, R=R, matmul=matmul, kv_cache=kv,
                   limits={"logit_gap": 1e-3, "state_rel": tol})
    assert out["correct"]
    # dense: the two differ in summation order only. W8A8: an activation
    # that the two put on either side of a rounding boundary takes the
    # neighbouring int8 value (1/127 of its row's amax), and the caches
    # carry such steps from chunk to chunk (up to 1.5e-3 seen here)
    assert out["checks"]["state_rel"]["value"] < tol
    assert out["readings"]["decisions"] > out["readings"]["tokens"] > 0


def test_reference_near_in_bf16(tmp_path):
    out = run_tiny(tmp_path, dtype="bfloat16",
                   limits={"logit_gap": 1.0, "state_rel": 0.05})
    assert out["correct"]


def test_log_mel_frames_match_streaming_framing():
    """Whole-recording framing equals a frontend fed block by block: 256
    zeros of history, a frame every 160 samples once 512 are there."""
    pcm = torch.randint(-3000, 3000, (2, 5 * 1280), dtype=torch.int16)
    fb = torch.rand(16, 257)
    mel = ref.log_mel(pcm, torch.hann_window(400, periodic=False), fb)
    assert mel.shape == (2, (256 + 5 * 1280 - 512) // 160 + 1, 16)
    first = ref.log_mel(pcm[:, :1280], torch.hann_window(400,
                                                          periodic=False), fb)
    torch.testing.assert_close(mel[:, :first.shape[1]], first)


def test_w8a8_matmul_exact_on_integer_grid():
    """Inputs already on the quantization grid come back exactly."""
    w = {"layers.ffn1_w1": (torch.randint(-127, 128, (1, 64, 32)).float()
                            * 0.01)}
    W = ref.Weights(w, "w8a8")
    x = torch.randint(-127, 128, (5, 64)).float()
    x[:, 0] = 127.0
    got = W.matmul(x, "ffn1_w1", 0)
    q, s = W.q["ffn1_w1"]
    torch.testing.assert_close(got, (x @ q[0]) * s[0], rtol=1e-6, atol=1e-4)
