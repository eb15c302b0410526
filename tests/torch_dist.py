"""Helpers of the port's multi-rank tests: a world of subprocess ranks on
gloo (the CPU), each with its own timeout, all killed when one fails."""

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    """The ranks' environment: the CPU, one thread a rank, no JAX."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


def run_ranks(script: str, world: int, args: list, timeout: float = 300.0,
              argv=None) -> list[str]:
    """Run `script` (python source; argv: repo, address, rank, world,
    *args) as `world` ranks; returns each rank's output. A rank that
    fails, or the timeout, kills every rank and raises AssertionError
    with their outputs. argv(rank) -> list replaces the command line."""
    addr = f"127.0.0.1:{free_port()}"
    procs = []
    for r in range(world):
        cmd = (argv(r) if argv is not None else
               [sys.executable, "-c", script, REPO, addr, str(r), str(world),
                *map(str, args)])
        procs.append(subprocess.Popen(cmd, env=rank_env(),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, "\n".join(
        f"--- rank {r} (exit {c}) ---\n{log[-4000:]}"
        for r, (c, log) in enumerate(zip(codes, logs)))
    return logs
