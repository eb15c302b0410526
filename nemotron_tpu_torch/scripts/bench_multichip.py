"""Multi-rank structure of the serving step and the train step.

The port's counterpart of scripts/bench_multichip.py, with its JSON keys.
For a mesh of N ranks (N = 1, 2, 4, 8; model parallel 2 when N is even,
else 1, the rest the data axis), each of N
torch.distributed ranks on gloo (`--worker` processes started by this
script) runs the tiny model's serving chunk step (encode_chunk + greedy
decode) and one full training step (loss, backward, clipped AdamW), and
rank 0 reports:

  - the collectives each step makes, by kind, count and bytes, counted
    where the port writes them (parallel/collectives.py: every one is an
    all_reduce), in all (`collectives`) and by mesh axis
    (`collectives_by_axis`: the serving step makes none on the data axis,
    where each rank serves its own streams);
  - the parameter and state bytes a rank holds (`param_bytes_per_device`,
    `state_bytes_per_device`; `state_bytes_per_stream` over its rows): the
    port's layout, whose K/V rings hold a rank's share of the heads where
    the attention pair is split (parallel/mesh.rings_split);
  - the predicted link time of those bytes a step
    (`predicted_ici_us_per_step`), at NVLink 4's rate: 900 GB/s a card in
    all, 450 GB/s each way (NVIDIA H100 SXM5 data sheet), so 450e9 bytes a
    second one way;
  - the wall time of a step (`virtual_mesh_wall_ms_per_step`): gloo ranks
    time-sharing this host, which says nothing about NCCL between cards.

    python -m nemotron_tpu_torch.scripts.bench_multichip [--out FILE] [--cpu]

The rows print as JSON lines; the document (a note, the mesh rule, the
rows) goes to --out (default: multichip_scaling.json in the temporary
directory). Differences from the JAX script: the collectives are counted
as the port makes them, not read from compiled HLO (XLA may fuse or split
what GSPMD inserts); the link rate is the H100's NVLink, not a TPU v5e's
ICI (45 GB/s); the state bytes are the port's layout (JAX's counts the
rings' heads whole on every rank). Without --cpu the
ranks run on the card (gloo, sharing it where there are fewer cards).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

# NVLink 4 on the H100 SXM5: 900 GB/s a GPU in both directions together
# (NVIDIA H100 Tensor Core GPU data sheet), 450 GB/s one way
LINK_BYTES_PER_S = 450e9
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def mesh_config():
    """The JAX script's model and cache (scripts/bench_multichip.py:
    108-113): the tiny widths with a 9-tap conv, R = 1, 8 frames left."""
    from ..config import CacheConfig, ModelConfig

    cfg = ModelConfig(n_mels=32, d_model=128, n_heads=8, d_head=16,
                      d_ff=256, n_layers=2, kernel_size=9, vocab_size=64,
                      decoder_dim=64, joint_dim=64, subsampling_channels=16)
    cc = CacheConfig(att_right_context=1, att_left_context=8,
                     n_mels=cfg.n_mels)
    return cfg, cc


class CollectiveCounter:
    """Stands in for torch.distributed inside parallel/collectives.py:
    counts each all_reduce (bytes: the tensor's) under the mesh axis of
    its group, then makes it."""

    def __init__(self, dist, mesh):
        self._dist = dist
        self._axes = {id(mesh.data_group): "data",
                      id(mesh.model_group): "model"}
        self.calls: list[tuple[str, int]] = []

    def all_reduce(self, t, *args, group=None, **kw):
        self.calls.append((self._axes.get(id(group), "world"),
                           t.numel() * t.element_size()))
        return self._dist.all_reduce(t, *args, group=group, **kw)

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def take(self) -> tuple[dict, dict]:
        """(by kind, by axis) of the calls since the last take."""
        calls, self.calls = self.calls, []
        kind = {}
        if calls:
            kind["all-reduce"] = {"count": len(calls),
                                  "bytes": sum(b for _, b in calls)}
        axes = {}
        for axis, b in calls:
            e = axes.setdefault(axis, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += b
        return kind, axes


def _summary(kind: dict, axes: dict, wall_ms: float) -> dict:
    total = sum(v["bytes"] for v in kind.values())
    return {"collectives": kind, "collectives_by_axis": axes,
            "bytes_per_step": total,
            "predicted_ici_us_per_step": round(
                total / LINK_BYTES_PER_S * 1e6, 2),
            "virtual_mesh_wall_ms_per_step": round(wall_ms, 2)}


def one_rank(n: int, addr: str, rank: int, cpu: bool) -> dict | None:
    """A rank's share of the run: build, shard, step, count; rank 0's row
    (None on the others)."""
    import numpy as np
    import torch

    from ..models import decoder as dec_mod
    from ..models import encoder as enc_mod
    from ..parallel import collectives
    from ..parallel import mesh as mesh_mod
    from ..params import params_from_arrays, random_weight_arrays
    from ..training import make_optimizer, make_train_step, trainable
    from ._common import device_of, sync, tree_bytes

    device = device_of(cpu)
    torch.set_num_threads(1)
    cfg, cc = mesh_config()
    mp = 2 if n % 2 == 0 else 1
    mesh_mod.init_world(f"tcp://{addr}", n, rank, backend="gloo")
    try:
        mesh = mesh_mod.make_mesh(model_parallel=mp, device=device)
        counter = CollectiveCounter(collectives.dist, mesh)
        collectives.dist = counter
        dp = mesh.data
        batch = 2 * dp
        rows = batch // dp
        f32 = torch.float32
        params = params_from_arrays(random_weight_arrays(cfg, seed=0), cfg,
                                    device=device)
        local = mesh_mod.shard_params(params, mesh)
        pos_heads = enc_mod.precompute_pos_heads(local, cfg, cc, f32)
        enc_state = enc_mod.init_encoder_state(
            cfg, cc, rows, f32, device,
            n_heads=enc_mod.local_heads(local, cfg))
        dec_state = dec_mod.init_decoder_state(cfg, rows, f32, device)
        state_bytes = tree_bytes(enc_state) + tree_bytes(dec_state)
        row = {"n_devices": n, "data_parallel": dp, "model_parallel": mp,
               "batch": batch,
               "param_bytes_per_device": tree_bytes(local),
               "state_bytes_per_device": state_bytes,
               "state_bytes_per_stream": state_bytes // rows}

        mel = torch.zeros((rows, cc.chunk_mel_frames, cfg.n_mels), dtype=f32,
                          device=device)

        def serve():
            nonlocal enc_state, dec_state
            enc_out, enc_state = enc_mod.encode_chunk(
                local, cfg, cc, mel, enc_state, pos_heads)
            _, dec_state = dec_mod.greedy_decode(local, cfg, enc_out,
                                                 dec_state)

        with torch.no_grad():
            counter.take()
            serve()
            kind, axes = counter.take()
            serve()
            sync(device)
            t0 = time.perf_counter()
            for _ in range(5):
                serve()
            sync(device)
            serve_ms = (time.perf_counter() - t0) / 5 * 1e3
        row["serving"] = _summary(kind, axes, serve_ms)

        rng = np.random.default_rng(0)
        U = 3
        train_batch = {
            "mel": torch.from_numpy(rng.standard_normal(
                (batch, 25, cfg.n_mels))).to(device, f32),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab_size - 1, (batch, U))).to(device, torch.int32),
            "mel_lengths": torch.full((batch,), 4, dtype=torch.int32,
                                      device=device),
            "label_lengths": torch.full((batch,), U, dtype=torch.int32,
                                        device=device)}
        tparams = trainable(local)
        opt, sched = make_optimizer(tparams, 1e-4)
        step = make_train_step(cfg, opt, sched, mesh=mesh)
        counter.take()
        step(tparams, train_batch)
        kind, axes = counter.take()
        step(tparams, train_batch)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            loss = step(tparams, train_batch)
        float(loss)
        train_ms = (time.perf_counter() - t0) / 3 * 1e3
        row["training"] = _summary(kind, axes, train_ms)
        return row if rank == 0 else None
    finally:
        mesh_mod.leave_world()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh(n: int, cpu: bool, timeout: float = 1800.0) -> dict:
    """N rank processes of this module; rank 0's row. A rank that fails
    (or the timeout) kills the others and raises SystemExit."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nemotron_tpu_torch.scripts.bench_multichip",
         "--worker", str(n), addr, str(r)] + (["--cpu"] if cpu else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for r in range(n)]
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
    if any(p.returncode for p in procs):
        for r, log in enumerate(logs):
            print(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                  f"{log[-4000:]}", file=sys.stderr)
        raise SystemExit(f"n={n}: a rank failed")
    for line in logs[0].splitlines():
        if line.startswith("ROW "):
            return json.loads(line[4:])
    raise SystemExit(f"n={n}: no ROW in rank 0's output")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    cpu = "--cpu" in argv
    if argv[1:2] == ["--worker"]:
        row = one_rank(int(argv[2]), argv[3], int(argv[4]), cpu)
        if row is not None:
            print("ROW " + json.dumps(row), flush=True)
        return 0

    from ._common import device_of, opt

    device_of(cpu)     # the card unless --cpu: fail here, not in the ranks
    out_path = opt(argv, "--out", os.path.join(tempfile.gettempdir(),
                                               "multichip_scaling.json"), str)
    rows = []
    for n in (1, 2, 4, 8):
        rows.append(run_mesh(n, cpu))
        print(json.dumps(rows[-1]), flush=True)

    doc = {
        "note": ("gloo ranks on one host: wall times validate the mesh "
                 "program only and say nothing about NCCL between cards; "
                 "collective counts and bytes are what the port's "
                 "collectives send. predicted_ici_us assumes "
                 f"{LINK_BYTES_PER_S / 1e9:.0f} GB/s one way (NVLink 4, "
                 "H100 SXM5)."),
        "mesh_rule": "model_parallel=2 when n_devices is even, else 1; "
                     "rest of the mesh is the data (stream) axis",
        "rows": rows,
    }
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
