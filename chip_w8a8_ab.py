#!/usr/bin/env python3
"""Time the W8A8 matmul kernel of several checkouts on one card, side by side.

    python3 chip_w8a8_ab.py TREE [TREE ...] [--engine] [--out FILE]

Each TREE is a directory holding a `nemotron_tpu_torch/` package (this
repository at some commit, e.g. unpacked with `git archive`). Each tree's
`w8a8_matmul` kernel is built from that tree's sources (one nvcc each, all
at once), then timed in its own process, in the order given, on the same
seeded inputs: bf16 activations at the streaming main path's M = 8, 16, 56
and 112 (8 streams x 1, 2, 7 and 14 frames), the 64-slot engine's M = 896
and the 256-slot engine's M = 3584 (64 and 256 slots x 14 frames) for the
ten weight matmuls of a layer, and M = 672 (the shared x-ring's K/V
recompute) for (1024, 1024). Every timed call is first checked bit for bit
against the tree's own plain version. The timing is `chip_smoke.time_calls`
(CUDA-graph replay, weights cycled beyond L2). With --engine, each tree
also drives the W8A8 + int8 K/V serving engine (bf16, device DSP, R = 13)
at full width with seeded random weights (`chip_smoke.write_full_width_gguf`,
written once) at 64 and 256 slots: the tick p50 of 7 ticks with every slot
at the real-time rate, and a profile of 3 ticks (device busy share, busy
ms and W8A8 kernel ms a tick). Give the same tree twice, e.g. A B B A, to
see the spread between runs. Prints the card's name and power limit, a
table of us a call and a layer, and one JSON line; exits non-zero without a
card or when a tree's kernel fails to build, launch or match.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
MS = (8, 16, 56, 112, 672, 896, 3584)
ENGINE_SLOTS = (64, 256)
SEED = 0


def smoke():
    """chip_smoke.py of this checkout (timing helper and layer shapes)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_module(tree: str):
    """The tree's w8a8_kernel module; refuses to run another tree's."""
    sys.path.insert(0, tree)
    from nemotron_tpu_torch.ops import w8a8_kernel

    where = os.path.realpath(w8a8_kernel.__file__)
    if not where.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"{tree}: imported {where}")
    return w8a8_kernel


def build(tree: str) -> None:
    kernel_module(tree).cuda_build.load("w8a8_matmul")


def time_tree(tree: str) -> dict:
    import torch

    cs_mod = smoke()
    wk = kernel_module(tree)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for M in MS:
        for K, N in (cs_mod.Q8_SHAPES if M != 672 else [(1024, 1024)]):
            n = max(2, (192 << 20) // (K * N))
            ws = [(torch.randint(-127, 128, (K, N), device="cuda", generator=g,
                                 dtype=torch.int8),
                   torch.rand(N, device="cuda", generator=g) * 1e-2 + 1e-4)
                  for _ in range(n)]
            scale = torch.rand(M, 1, device="cuda", generator=g) * 3 + 0.1
            x = (torch.randn(M, K, device="cuda", generator=g)
                 * scale).bfloat16()
            for q, cs in ws[:4]:
                if not torch.equal(wk.w8a8_matmul(x, q, cs),
                                   wk.w8a8_matmul_ref(x, q, cs)):
                    raise RuntimeError(f"{tree}: M={M} K={K} N={N} differs "
                                       "from the plain version")
            ms = cs_mod.time_calls([lambda q=q, cs=cs: wk.w8a8_matmul(x, q, cs)
                                    for q, cs in ws],
                                   500 if M <= 112 else 100 if M <= 1000
                                   else 30)
            out[f"{M},{K},{N}"] = ms * 1e3
            del ws
    layer = {M: sum(out[f"{M},{K},{N}"] * c
                    for (K, N), c in cs_mod.Q8_SHAPES.items())
             for M in MS if M != 672}
    return dict(call_us=out, layer_us=layer)


def engine_tree(gguf: str) -> dict:
    """The tree's W8A8 engine at ENGINE_SLOTS: tick p50, busy share, busy
    and W8A8 ms a tick (chip_smoke's schedule and profile)."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model, quantize_model_params
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    cs_mod = smoke()
    params, cfg, vocab = load_model(gguf, device="cuda")
    w8 = quantize_model_params(params, mode="w8a8")
    del params
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                     kv_cache_int8=True)

    def engine(slots):
        return ServingEngine(w8, cfg, vocab, cc, n_slots=slots,
                             compute_dtype=torch.bfloat16, dsp="device")

    out = {}
    for slots in ENGINE_SLOTS:
        run = cs_mod.engine_schedule(
            engine(slots),
            lambda sid: cs_mod.seeded_pcm(sid, 2 * cs_mod.ENGINE_SECONDS),
            finalize=False)
        prof = cs_mod.engine_step_profile(engine(slots))
        w8_us = sum(us for k, us in prof["by_name"]
                    if k.startswith("w8a8_matmul"))
        out[str(slots)] = dict(
            tick_p50_ms=run["latency"]["p50"] * 1e3,
            busy_share=prof["busy_us"] / prof["wall_us"],
            busy_ms_per_tick=prof["busy_us"] / 3e3,
            w8a8_ms_per_tick=w8_us / 3e3,
            w8a8_launches_per_tick=cs_mod.launches_of(prof, "w8a8_matmul") / 3)
        torch.cuda.synchronize()
    return out


def run_child(flag: str, tree: str, *extra: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                           tree, *extra], capture_output=True, text=True,
                          timeout=900)


def main(argv: list[str]) -> int:
    if len(argv) in (2, 3) and argv[0] in ("--build", "--time"):
        if argv[0] == "--build":
            build(argv[1])
        else:
            res = time_tree(argv[1])
            if len(argv) == 3:
                res["engine"] = engine_tree(argv[2])
            print(json.dumps(res))
        return 0
    want_engine = "--engine" in argv
    argv = [a for a in argv if a != "--engine"]
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    trees = argv
    if not trees:
        print(__doc__, file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(smoke().gpu_name_and_power(), flush=True)
    unique = list(dict.fromkeys(trees))
    with ThreadPoolExecutor(len(unique)) as pool:
        built = dict(zip(unique, pool.map(lambda t: run_child("--build", t),
                                          unique)))
    for t, r in built.items():
        if r.returncode:
            print(f"{t}: build failed\n{r.stdout}{r.stderr}", file=sys.stderr)
            return 1
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        extra = ()
        if want_engine:
            extra = (os.path.join(tmp, "full_width_q8.gguf"),)
            smoke().write_full_width_gguf(extra[0])
        for t in trees:
            r = run_child("--time", t, *extra)
            if r.returncode:
                print(f"{t}: timing failed\n{r.stdout}{r.stderr}",
                      file=sys.stderr)
                return 1
            runs.append(dict(tree=t, **json.loads(
                r.stdout.strip().splitlines()[-1])))
            print(f"{t}: layer us " + ", ".join(
                f"M={M} {v:.2f}" for M, v in runs[-1]["layer_us"].items())
                + f"; M=672 call {runs[-1]['call_us']['672,1024,1024']:.2f}"
                + "".join(f"; engine {n} slots: tick p50 "
                          f"{e['tick_p50_ms']:.2f} ms, busy "
                          f"{100 * e['busy_share']:.1f}% "
                          f"({e['busy_ms_per_tick']:.2f} ms a tick), W8A8 "
                          f"{e['w8a8_ms_per_tick']:.2f} ms a tick in "
                          f"{e['w8a8_launches_per_tick']:g} launches"
                          for n, e in runs[-1].get("engine", {}).items()),
                flush=True)
    keys = list(runs[0]["call_us"])
    print("us a call: " + " | ".join(os.path.basename(t.rstrip("/")) or t
                                     for t in trees))
    for k in keys:
        print(f"  M,K,N={k}: " + " | ".join(f"{r['call_us'][k]:.2f}"
                                           for r in runs))
    line = json.dumps(dict(runs=runs))
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
