#!/usr/bin/env python3
"""Check and time the Q8 matmul kernel's two designs on one card.

    python3 chip_q8_sweep.py [--ms 16,32,64,...] [--out FILE]

Builds `nemotron_tpu_torch/csrc/q8_matmul.cu` (and prints nvcc's register,
shared-memory and spill report of each instantiation), then:
  1. holds both designs against the plain version (`q8_matmul_ref`) in f32
     (4e-6 of max|out|) and bf16 (2^-6 of max|out|): the encoder's four
     (K, N) at several M, every split of the tiled design, ragged M and N,
     and an x that is not 16-byte aligned; the tiled design bit for bit
     repeatable at M = 896;
  2. times, in f32, for each M and each (K, N) of a layer, the skinny
     design, the tiled design at every split (1, 2, 4, 8 up to K/32; the
     geometry's own marked), and `torch.matmul` on the dequantized weight
     (`chip_smoke.time_calls`: CUDA-graph replay, weights cycled beyond
     L2), and sums each over a layer's ten calls.
Prints the card's name and power limit, a table in us, and one JSON line;
exits non-zero without a card or when a check fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_MS = (16, 32, 64, 80, 96, 112, 128, 256, 804, 896)
SEED = 0


def smoke():
    """chip_smoke.py of this checkout (timing helper and layer shapes)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report(cuda_build) -> str:
    """nvcc's -Xptxas -v lines for the kernel source (registers, spills)."""
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", os.path.join(tmp, "lib.so"),
             str(cuda_build.CSRC / "q8_matmul.cu")],
            capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    keep = [ln for ln in (r.stdout + r.stderr).splitlines()
            if "Compiling entry" in ln or "registers" in ln
            or "spill" in ln]
    return "\n".join(keep)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ms", default=",".join(map(str, DEFAULT_MS)))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nemotron_tpu_torch.ops import cuda_build
    from nemotron_tpu_torch.ops import quant_kernel as qk

    cs = smoke()
    card = cs.gpu_name_and_power()
    print(f"device: {card}", flush=True)
    print(ptxas_report(cuda_build), flush=True)
    cuda_build.load("q8_matmul")
    sms = qk.sm_count(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    failures: list[str] = []

    def weights(K, N, n=1):
        return [(torch.randint(-127, 128, (K, N), device="cuda", generator=g,
                               dtype=torch.int8),
                 torch.rand(K // 32, N, device="cuda", generator=g) * 1e-3)
                for _ in range(n)]

    def splits(K):
        return [s for s in (1, 2, 4, 8) if s <= K // 32]

    def hold(name, x, q, s, geo):
        got = qk.q8_matmul_as(x, q, s, geo)
        want = qk.q8_matmul_ref(x, q, s)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = (cs.TOL_F32_Q8_REL if x.dtype == torch.float32
               else cs.TOL_BF16_REL) * want.float().abs().max().item()
        worst[0] = max(worst[0], err / tol)
        worst[1] += 1
        if not err <= tol:
            failures.append(f"{name} {geo} {str(x.dtype)[6:]}: max_abs_err "
                            f"{err:.3e} > tol {tol:.3e}")

    worst = [0.0, 0]      # largest err / tol, checks made
    for M in (1, 14, 33, 64, 100, 804, 896, 1000):
        for K, N in cs.Q8_SHAPES:
            (q, s), = weights(K, N)
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(M, K, device="cuda", generator=g).to(dt)
                geos = [qk.splitk_geometry(M, K, N, sms)] if M <= 112 else []
                geos += [qk.tiled_geometry(M, K, N, sms, sp)
                         for sp in splits(K)] if M > 1 else []
                for geo in geos:
                    hold(f"M={M} K={K} N={N}", x, q, s, geo)
    # ragged N (plain loads), small K, misaligned x, through the tiled design
    for M, K, N, off in ((300, 96, 56, 0), (70, 64, 40, 0), (200, 1024, 1024, 1),
                         (129, 1024, 4096, 1), (65, 32, 136, 0)):
        (q, s), = weights(K, N)
        for dt in (torch.float32, torch.bfloat16):
            xs = torch.randn(M * K + off, device="cuda", generator=g).to(dt)
            x = xs[off:].view(M, K)
            for sp in splits(K):
                hold(f"odd M={M} K={K} N={N} offset={off}", x, q, s,
                     qk.tiled_geometry(M, K, N, sms, sp))
    print(f"checks: {worst[1]} against q8_matmul_ref, worst err/tol "
          f"{worst[0]:.3f}, {len(failures)} failed", flush=True)
    for f in failures[:20]:
        print(f"  FAILED: {f}", flush=True)
    for K, N in ((1024, 1024), (4096, 1024)):
        (q, s), = weights(K, N)
        x = torch.randn(896, K, device="cuda", generator=g)
        geo = qk.q8_launch_geometry(896, K, N, sms)
        first = qk.q8_matmul_as(x, q, s, geo)
        same = all(torch.equal(qk.q8_matmul_as(x, q, s, geo), first)
                   for _ in range(3))
        print(f"  M=896 K={K} N={N} {geo}: repeated calls bit-equal {same}")
        if not same:
            failures.append(f"M=896 K={K} N={N}: not deterministic")

    print("times (f32, us a call; weights cycled beyond L2)", flush=True)
    rows = {}
    for M in (int(m) for m in args.ms.split(",")):
        iters = 300 if M <= 64 else 100
        for K, N in cs.Q8_SHAPES:
            n = max(2, (192 << 20) // (K * N))
            ws = weights(K, N, n)
            x = torch.randn(M, K, device="cuda", generator=g)
            own = qk.q8_launch_geometry(M, K, N, sms)
            geos = {"splitk": qk.splitk_geometry(M, K, N, sms)}
            geos |= {f"tiled{sp}": qk.tiled_geometry(M, K, N, sms, sp)
                     for sp in splits(K)}
            row = {}
            for key, geo in geos.items():
                row[key] = 1e3 * cs.time_calls(
                    [lambda q=q, s=s, geo=geo: qk.q8_matmul_as(x, q, s, geo)
                     for q, s in ws], iters)
            dense = [(q.float().reshape(K // 32, 32, N)
                      * s[:, None, :]).reshape(K, N) for q, s in ws[:8]]
            row["matmul"] = 1e3 * cs.time_calls(
                [lambda w=w: torch.matmul(x, w) for w in dense], iters)
            row["own"] = next(k for k, v in geos.items() if v == own)
            flops = 2 * M * K * N
            row["bound"] = 1e6 * max(
                flops / cs.PEAK_FLOPS["float32"],
                (M * K * 4 + K * N + K // 32 * N * 4 + M * N * 4)
                / cs.HBM_BYTES_PER_S)
            rows[(M, K, N)] = row
            print(f"  M={M} K={K} N={N} " + " ".join(
                f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
            del ws, dense
    layer = {}
    for M in sorted({m for m, _, _ in rows}):
        t = {}
        for (K, N), c in cs.Q8_SHAPES.items():
            r = rows[(M, K, N)]
            for k, v in r.items():
                if k == "own":
                    k, v = "own", r[v]
                if isinstance(v, float):
                    t[k] = t.get(k, 0.0) + c * v
        best = min(t[k] for k in t if k.startswith(("splitk", "tiled")))
        layer[M] = t | {"best": best}
        print(f"layer M={M}: " + " ".join(f"{k} {v:.2f}"
                                          for k, v in layer[M].items()))
    result = {"card": card, "rows": {f"{m},{k},{n}": r
                                     for (m, k, n), r in rows.items()},
              "layer": layer, "failures": failures}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"layer": layer}))
    print(card)
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
