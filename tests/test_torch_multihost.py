"""Multi-process serving of the port (parallel/multihost.py) against one
process, on the CPU: two ranks on gloo, each a subprocess that imports
the port and never JAX, held to the port's and the JAX package's
one-process engines on the same seeded PCM (JAX's own cases,
tests/test_multihost.py); the row helpers and the refusals; and the
entry points: `serve --mesh` and `serve --coordinator` with two
processes, and `asr_server --coordinator` (no such flag in
scripts/asr_server.py)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_dist import REPO, free_port, rank_env, run_ranks

from nemotron_tpu_torch.parallel import multihost as tmh

torch.set_num_threads(1)

FIXTURE = f"{REPO}/weights/tones_tiny.gguf"

WORKER = r'''
import json, sys
repo, addr, rank, world, gguf, out = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import numpy as np, torch
torch.set_num_threads(1)
from nemotron_tpu_torch.parallel.multihost import (MultihostLockstep,
                                                   MultihostServing,
                                                   init_multihost)
init_multihost(addr, world, rank, cpu_gloo=True)
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.params import load_model

params, cfg, vocab = load_model(gguf, device="cpu")
cc = CacheConfig(att_right_context=1, att_left_context=12, n_mels=cfg.n_mels)
F32 = torch.float32
res = {"refusals": []}

def synth(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 8000).astype(np.int16)

def lockstep(mode, mp=1):
    eng = MultihostLockstep(params, cfg, vocab, cc, n_streams=8,
                            compute_dtype=F32, model_parallel=mp)
    N = cc.shift_samples
    rows = [int(r) for r in eng.local_rows]
    audio = {r: synth(N * 4, 1000 + r) for r in rows}
    block = lambda t: np.stack([audio[r][t * N:(t + 1) * N] for r in rows])
    if mode == "resume":
        # 2 ticks -> collective shard snapshot -> FRESH engine -> load ->
        # 2 more ticks: must equal 4 uninterrupted ticks exactly
        for t in range(2):
            eng.tick(block(t))
        snap = out + f".snap{mp}"
        eng.save(snap)
        eng = MultihostLockstep(params, cfg, vocab, cc, n_streams=8,
                                compute_dtype=F32, model_parallel=mp)
        eng.load(snap)
        for t in range(2, 4):
            eng.tick(block(t))
    else:
        for t in range(4):
            eng.tick(block(t))
    eng.finalize()
    return {str(r): {"text": eng.transcripts[i],
                     "tokens": [[int(t), int(f)] for t, f in eng.tokens[i]]}
            for i, r in enumerate(rows)}

res["straight"] = lockstep("straight")
res["resume"] = lockstep("resume")
res["straight_mp2"] = lockstep("straight", mp=2)
res["resume_mp2"] = lockstep("resume", mp=2)

# the ragged engine: steady real-time cadence (one chunk a collective
# step); rows[0] full rate, rows[1] half rate, rows[2] admitted at step 2,
# rows[3] never admitted
eng = MultihostServing(params, cfg, vocab, cc, n_slots=8, compute_dtype=F32,
                       endpoint_silence_s=2.0, endpoint_reset=True)
rows = [int(r) for r in eng.local_rows]
n = cc.shift_samples
s_full = eng.add_stream()
s_half = eng.add_stream()
s_late = None
audio = {r: synth(n * 6, 5000 + r) for r in rows}
for tick in range(6):
    feed = {s_full: audio[s_full][tick * n:(tick + 1) * n]}
    if tick % 2 == 0:
        feed[s_half] = audio[s_half][(tick // 2) * n:(tick // 2 + 1) * n]
    if tick == 2:
        s_late = eng.add_stream()
    if s_late is not None and tick >= 2:
        feed[s_late] = audio[s_late][(tick - 2) * n:(tick - 1) * n]
    eng.feed_audio(feed)
    eng.step()           # collective: BOTH processes step every tick
res["serving"] = {str(s): {"text": eng.transcripts[s],
                           "tokens": [[int(t), int(f)]
                                      for t, f in eng.tokens[s]]}
                  for s in (s_full, s_half, s_late)}

def refuses(fn, exc, match):
    try:
        fn()
    except exc as e:
        assert match in str(e), str(e)
        res["refusals"].append(match)

refuses(lambda: eng.finalize_stream(s_full), NotImplementedError,
        "finalize_stream is slot-locally data-dependent")
refuses(lambda: MultihostLockstep(params, cfg, vocab, cc, n_streams=8,
                                  endpoint_reset=True), ValueError,
        "endpoint_reset is not supported multihost")
refuses(lambda: MultihostServing(params, cfg, vocab, cc, n_slots=8,
                                 dsp="device"), ValueError,
        "host-DSP only")
refuses(lambda: MultihostServing(params, cfg, vocab, cc, n_slots=8,
                                 beam_size=4), ValueError,
        "beam decode is not wired multihost")
refuses(lambda: MultihostLockstep(params, cfg, vocab, cc, n_streams=5),
        ValueError, "not divisible by the data axis")
json.dump(res, open(f"{out}.{rank}.json", "w"))
'''


def synth(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 8000).astype(np.int16)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, model_setup):
    """Both ranks' results (merged by global row) and the GGUF."""
    from conftest import write_tiny_gguf

    arrays, _, cfg = model_setup
    d = tmp_path_factory.mktemp("multihost")
    gguf = str(d / "tiny.gguf")
    write_tiny_gguf(gguf, arrays, cfg)
    out = str(d / "out")
    run_ranks(WORKER, 2, [gguf, out], timeout=420)
    ranks = [json.load(open(f"{out}.{r}.json")) for r in (0, 1)]
    merged = {}
    for k in ranks[0]:
        if k == "refusals":
            merged[k] = [r[k] for r in ranks]
            continue
        merged[k] = {}
        for r in ranks:
            merged[k].update(r[k])
    return merged, gguf


def one_process_lockstep(gguf, jax: bool):
    """Every row's (text, tokens) of the one-process LockstepEngine (the
    port's or the JAX package's) on the workers' audio."""
    if jax:
        import jax.numpy as jnp

        from nemotron_tpu import params as pm
        from nemotron_tpu.config import CacheConfig
        from nemotron_tpu.streaming.lockstep import LockstepEngine
        dt = jnp.float32
        p, cfg, vocab = pm.load_model(gguf)
    else:
        from nemotron_tpu_torch import params as pm
        from nemotron_tpu_torch.config import CacheConfig
        from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
        dt = torch.float32
        p, cfg, vocab = pm.load_model(gguf, device="cpu")
    cc = CacheConfig(att_right_context=1, att_left_context=12,
                     n_mels=cfg.n_mels)
    eng = LockstepEngine(p, cfg, vocab, cc, n_streams=8, compute_dtype=dt)
    N = cc.shift_samples
    audio = {r: synth(N * 4, 1000 + r) for r in range(8)}
    for t in range(4):
        eng.tick(np.stack([audio[r][t * N:(t + 1) * N] for r in range(8)]))
    eng.finalize()
    return {str(r): {"text": eng.transcripts[r],
                     "tokens": [[int(t), int(f)] for t, f in eng.tokens[r]]}
            for r in range(8)}


@pytest.mark.parametrize("jax", [False, True], ids=["port", "jax"])
@pytest.mark.parametrize("run", ["straight", "resume", "straight_mp2",
                                 "resume_mp2"])
def test_two_process_lockstep_matches_one_process(two_ranks, run, jax):
    """MultihostLockstep over two ranks (data 2, or one model group of 2)
    == the one-process engine, every row exactly; the per-process
    save -> fresh engines -> load resume equals the straight run."""
    multi, gguf = two_ranks
    got = multi[run]
    assert sorted(map(int, got)) == list(range(8))
    assert got == one_process_lockstep(gguf, jax)
    assert any(v["tokens"] for v in got.values())


@pytest.mark.parametrize("jax", [False, True], ids=["port", "jax"])
def test_two_process_serving_matches_one_process(two_ranks, jax):
    """Ragged MultihostServing (staggered admissions and rates, staged
    resets, the staged endpoint_reset, the batched realign) == the
    one-process ServingEngine, slot for slot (JAX's
    tests/test_multihost.py:176-310)."""
    multi, gguf = two_ranks
    if jax:
        import jax.numpy as jnp

        from nemotron_tpu import params as pm
        from nemotron_tpu.config import CacheConfig
        from nemotron_tpu.streaming.serving import ServingEngine
        dt = jnp.float32
        p, cfg, vocab = pm.load_model(gguf)
    else:
        from nemotron_tpu_torch import params as pm
        from nemotron_tpu_torch.config import CacheConfig
        from nemotron_tpu_torch.streaming.serving import ServingEngine
        dt = torch.float32
        p, cfg, vocab = pm.load_model(gguf, device="cpu")
    cc = CacheConfig(att_right_context=1, att_left_context=12,
                     n_mels=cfg.n_mels)
    eng = ServingEngine(p, cfg, vocab, cc, n_slots=8, compute_dtype=dt,
                        dsp="numpy", endpoint_silence_s=2.0,
                        endpoint_reset=True)
    n = cc.shift_samples
    audio = {r: synth(n * 6, 5000 + r) for r in range(8)}

    def claim(r):
        # rank p admits from its rows [4p, 4p+4); the one-process API has
        # no admit-this-slot call, so mimic add_stream's body
        assert not eng.active[r]
        eng.active[r] = True
        eng._clear_slot(r)
        return r

    slots = {(p_, k): claim(r) for p_ in (0, 1)
             for k, r in (("full", 4 * p_), ("half", 4 * p_ + 1))}
    late = {}
    for tick in range(6):
        feed = {}
        for p_ in (0, 1):
            s = slots[(p_, "full")]
            feed[s] = audio[s][tick * n:(tick + 1) * n]
            if tick % 2 == 0:
                s = slots[(p_, "half")]
                feed[s] = audio[s][(tick // 2) * n:(tick // 2 + 1) * n]
        if tick == 2:
            for p_ in (0, 1):
                late[p_] = claim(4 * p_ + 2)
        for p_ in late:
            s = late[p_]
            feed[s] = audio[s][(tick - 2) * n:(tick - 1) * n]
        eng.feed_audio(feed)
        eng.step()
    got = multi["serving"]
    assert sorted(map(int, got)) == [0, 1, 2, 4, 5, 6]
    for s in map(int, got):
        assert got[str(s)]["text"] == eng.transcripts[s], f"slot {s}"
        assert got[str(s)]["tokens"] == [[int(t), int(f)] for t, f in
                                         eng.tokens[s]], f"slot {s}"
    assert any(v["tokens"] for v in got.values())


def test_multihost_refusals(two_ranks):
    """finalize_stream raises, endpoint_reset / device DSP / a beam /
    rows not divisible by the data axis are refused, on both ranks."""
    multi, _ = two_ranks
    assert [len(r) for r in multi["refusals"]] == [5, 5]


def test_multihost_requires_a_world(model_setup):
    """A one-rank world refuses, as JAX's process_count() < 2."""
    from nemotron_tpu_torch.params import params_from_arrays

    arrays, _, cfg = model_setup
    p = params_from_arrays(arrays, cfg, device="cpu")
    for cls in (tmh.MultihostLockstep, tmh.MultihostServing):
        with pytest.raises(RuntimeError, match="torch.distributed"):
            cls(p, cfg)


def test_local_row_spans_and_fetch_rows():
    """One rank owns every row, in order; fetch_stream_rows takes global
    rows of a tensor that holds the rows from first_row on."""
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    spans, rows = tmh.local_row_spans(make_mesh(device="cpu"), 16)
    assert rows.tolist() == list(range(16)) and spans == [(0, 16)]
    x = torch.arange(24.0).reshape(2, 6, 2)
    got = tmh.fetch_stream_rows(x, 1, np.array([1, 4]))
    np.testing.assert_array_equal(got, x.numpy()[:, [1, 4]])
    got = tmh.fetch_stream_rows(x[:, 3:], 1, np.array([4, 5]), first_row=3)
    np.testing.assert_array_equal(got, x.numpy()[:, [4, 5]])


# -- the entry points ---------------------------------------------------------


@pytest.fixture(scope="module")
def pcm_file(tmp_path_factory):
    pcm = synth(24000, 0)
    path = str(tmp_path_factory.mktemp("serve") / "m.pcm")
    pcm.astype("<i2").tofile(path)
    return path


def serve(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "nemotron_tpu_torch.serve",
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=rank_env(), cwd=REPO)


def slot_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith("[slot ")]


def test_serve_mesh_cpu(pcm_file):
    """`serve --mesh 4 --cpu` (JAX tests/test_scripts.py:183-192): four
    ranks, each naming its backend and device; rank 0's summary, and the
    transcripts of the unsharded run."""
    flags = [FIXTURE, pcm_file, "--streams", "2", "--slots", "4",
             "--right-context", "1", "--seconds", "2", "--cpu"]
    r = serve(*flags, "--mesh", "4")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "aggregate real-time" in r.stderr
    for rank in range(4):
        assert f"rank {rank}/4: backend gloo, device cpu" in r.stderr
    one = serve(*flags)
    assert one.returncode == 0, one.stderr
    assert slot_lines(r.stdout) == slot_lines(one.stdout)
    assert len(slot_lines(r.stdout)) == 2


def test_serve_coordinator_two_processes(pcm_file):
    """`serve --lockstep --coordinator` with two processes: each serves its
    own rows of one slab; process 0's two rows decode as the one-process
    lockstep run's."""
    flags = [FIXTURE, pcm_file, "--streams", "4", "--right-context", "1",
             "--seconds", "2", "--cpu", "--lockstep"]
    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nemotron_tpu_torch.serve", *flags,
         "--coordinator", addr, "--num-processes", "2", "--process-id",
         str(i)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=rank_env(), cwd=REPO) for i in (0, 1)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    for i, (out, err) in enumerate(outs):
        assert "aggregate real-time" in err
        assert f"process {i}/2: backend gloo, device cpu" in err
    one = serve(*flags)
    assert slot_lines(outs[0][0]) == slot_lines(one.stdout)[:2]


def test_serve_coordinator_needs_lockstep_and_two_processes(pcm_file,
                                                            capsys):
    """JAX's rule (--coordinator requires --lockstep) and its one-process
    refusal, before anything loads."""
    from nemotron_tpu_torch import serve as serve_mod

    base = ["serve", FIXTURE, pcm_file, "--cpu", "--coordinator", "h:1"]
    assert serve_mod.main(base) == 1
    assert "requires --lockstep" in capsys.readouterr().err
    assert serve_mod.main(base + ["--lockstep", "--num-processes", "1"]) == 1
    assert "two or more ranks" in capsys.readouterr().err
    assert serve_mod.main(base + ["--lockstep", "--mesh", "2"]) == 1
    assert "exclude each other" in capsys.readouterr().err


def test_asr_server_has_no_coordinator(capsys):
    """scripts/asr_server.py has no --coordinator flag: the port's server
    answers it as any flag it does not know (exit 1)."""
    from nemotron_tpu_torch import asr_server

    assert asr_server.main(["asr_server", FIXTURE, "--coordinator",
                            "h:1"]) == 1
    err = capsys.readouterr().err
    assert "unsupported flag --coordinator" in err and "slice" not in err
