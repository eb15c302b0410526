"""Headline regression gate over a bench record.

The port's counterpart of scripts/check_regression.py, with its flags,
its messages and its exit codes. The headline contract (BASELINE.md) is a
p50 per-chunk latency under 120 ms at the shipped capacity; this gate
fails loudly before a change eats the headroom.

    python -m nemotron_tpu_torch.scripts.check_regression RECORD.json
    python -m nemotron_tpu_torch.scripts.check_regression --run [--quick] [--cpu]
    python -m nemotron_tpu_torch.scripts.check_regression x.json --p50-max 119.5 --min-streams N

Exit codes: 0 pass, 1 regression, 2 bad or missing input (or a failed
bench run).

Thresholds:
  --p50-max 119.5   the p50 per-chunk latency ceiling in ms (0.5 ms inside
                    the 120 ms bar, which is the product's contract, not a
                    measurement); applied to the single-slab p50 and to
                    the cohort step
  --min-streams N   the fewest streams that pass; without the flag the
                    streams are not gated (the JAX script's default of
                    5400 was a TPU's headline, and the card has no
                    baseline yet)
The p50 checked is the device-trace p50 when the record has one (per-step
percentiles), else the host chain-mean p50. A record may be the bench's
JSON line itself or a wrapper object whose "tail" string holds the
bench's output (its last JSON line is read). --run runs `python -m nemotron_tpu_torch.scripts.bench`
(with --quick and --cpu when given) and gates its line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def gate(rec: dict, p50_max: float, min_streams: int | None) -> list[str]:
    """The record's failures against the thresholds (empty: a pass)."""
    fails = []
    p50 = rec.get("device_p50_ms") or rec.get("p50_chunk_latency_ms")
    src = "device_p50_ms" if rec.get("device_p50_ms") else \
        "p50_chunk_latency_ms"
    if p50 is None:
        fails.append("no p50 latency in record")
    elif p50 > p50_max:
        fails.append(f"{src} {p50:.2f} ms > gate {p50_max} ms "
                     f"(bar 120 ms)")
    v = rec.get("value")
    if v is None:
        fails.append("no 'value' (streams) in record")
    elif min_streams is not None and v < min_streams:
        fails.append(f"streams {v} < gate {min_streams}")
    co = rec.get("cohorts")
    if co and co.get("step_p50_ms") is not None \
            and co["step_p50_ms"] > p50_max:
        # with cohort stacking the COHORT step is each chunk's latency
        fails.append(f"cohort step_p50_ms {co['step_p50_ms']:.2f} ms > "
                     f"gate {p50_max} ms (bar 120 ms)")
    return fails


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv

    def opt(name, default, cast):
        if name not in argv:
            return default
        i = argv.index(name) + 1
        try:
            return cast(argv[i])
        except (IndexError, ValueError):
            print(f"gate: {name} needs a number")
            raise SystemExit(2)

    p50_max = opt("--p50-max", 119.5, float)
    min_streams = opt("--min-streams", None, int)

    if "--run" in argv:
        from ._common import device_of

        device_of("--cpu" in argv)   # the card unless --cpu: fail here
        cmd = [sys.executable, "-m", "nemotron_tpu_torch.scripts.bench"]
        cmd += [f for f in ("--quick", "--cpu") if f in argv]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=3600, cwd=REPO)
        sys.stderr.write(r.stderr)
        if r.returncode != 0:
            print(f"gate: bench failed (exit {r.returncode})")
            return 2
        rec = json.loads(r.stdout.strip().splitlines()[-1])
    else:
        value_flags = {"--p50-max", "--min-streams"}
        paths = [a for i, a in enumerate(argv[1:], 1)
                 if not a.startswith("--") and argv[i - 1] not in value_flags]
        if not paths:
            print(__doc__, file=sys.stderr)
            return 2
        try:
            with open(paths[0]) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"gate: cannot read {paths[0]}: {e}")
            return 2
        if not isinstance(rec, dict):
            print(f"gate: {paths[0]} holds no JSON object")
            return 2
        if "metric" not in rec and "tail" in rec:
            # a wrapper: the bench line is the last JSON object inside
            # "tail"
            lines = [ln for ln in rec["tail"].splitlines()
                     if ln.startswith("{")]
            if not lines:
                print(f"gate: no bench JSON line in {paths[0]} tail")
                return 2
            rec = json.loads(lines[-1])

    fails = gate(rec, p50_max, min_streams)
    if fails:
        for f in fails:
            print(f"GATE FAIL: {f}")
        return 1
    streams_gate = (f">= {min_streams} streams" if min_streams is not None
                    else "streams not gated")
    print(f"gate pass: {rec.get('value')} streams, p50 "
          f"{rec.get('device_p50_ms') or rec.get('p50_chunk_latency_ms')}"
          f" ms (gates: {streams_gate}, <= {p50_max} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
