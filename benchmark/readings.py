"""Readings of one cell over many seeds in one process: what its limits
were set from (the program's, or the control's).

    python3 -m benchmark.readings --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--trace 0|1] [--control]

Prints one JSON line a run: the seed, the result line's object and the
run's wall. --control runs the program with the configuration's
`control` precision (the reference keeps the configuration's). A run
that raises prints its error and the next seed runs.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("benchmark.readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    overrides = cell["config"]["control"] if args.control else None
    failed = 0
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            out = harness.run(args.workload, seed, args.seconds,
                              bool(args.trace), device, t,
                              overrides=overrides,
                              log=lambda s: print(s, file=sys.stderr,
                                                  flush=True))
            print(json.dumps({"seed": seed, "control": args.control,
                              "wall_s": time.perf_counter() - t,
                              **out}), flush=True)
        except Exception:  # one seed's failure is a reading too
            failed += 1
            print(json.dumps({"seed": seed, "error":
                              traceback.format_exc()[-2000:]}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
