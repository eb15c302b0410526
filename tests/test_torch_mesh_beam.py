"""Beam decode on the port's (data, model) mesh against the JAX package's
mesh engines and the port's unsharded engines, on the CPU: four ranks
on gloo (data 2 x model 2, and data 4), each a subprocess that imports
the port and never JAX.

  - ServingEngine(mesh=, beam_size=4) over a ragged schedule (admission,
    eviction, a reused slot, finalize) and LockstepEngine(mesh=,
    beam_size=4): tokens and text equal to JAX's engines on a JAX mesh of
    the same shape and to the unsharded port engine, every beam score
    within the beam tests' tolerance of both; at model-parallel 1 every
    beam-state leaf and cache bit-equal to the unsharded port engine;
  - snapshots: a mesh beam engine's snapshot resumes in JAX's mesh engine,
    and JAX's in the mesh engine, to the uninterrupted JAX run;
  - MultihostServing and MultihostLockstep refuse a beam, as JAX's
    MultihostServing does.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_beam import peaked_arrays
from test_torch_mesh import SCHEDULE, _ns, as_json
from torch_dist import run_ranks

torch.set_num_threads(1)

WORLD = 4
N_SLOTS = 8
TICKS = 6
K = 4
CC_KW = dict(att_right_context=1, att_left_context=12)
# tests/test_torch_beam.py's tolerances: scores, and the caches
SCORE_ATOL, SCORE_RTOL = 1e-5, 1e-6
STATE_ATOL = 5e-5

WORKER = r'''
import json, os, sys
repo, addr, rank, world, cases_path, out_dir = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import numpy as np, torch
torch.set_num_threads(1)
from nemotron_tpu_torch.parallel.mesh import (gather_state,
                                              gather_stream_major,
                                              init_world, make_mesh)
init_world(f"tcp://{addr}", world, rank, "gloo")
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.models import beam as beam_mod
from nemotron_tpu_torch.params import load_model
from nemotron_tpu_torch.parallel.multihost import (MultihostLockstep,
                                                   MultihostServing)
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
from nemotron_tpu_torch.streaming.serving import ServingEngine
from nemotron_tpu_torch.utils import npz
ns = {}
exec(open(os.path.join(out_dir, "schedule.py")).read(), ns)

def leaves(eng):
    beam = gather_stream_major(eng.beam_state, eng.mesh)
    enc = gather_state(eng.enc_state, eng.mesh, eng._heads_split())
    out = {f"beam/{k}": npz.to_numpy(v)
           for k, v in beam_mod.leaves(beam).items()}
    out |= {f"enc/{k}": npz.to_numpy(v) for k, v in vars(enc).items()}
    return out

cases = json.load(open(cases_path))
p, cfg, vocab = load_model(cases[0]["gguf"], device="cpu")
refusals = []
for case in cases:
    if case["kind"] == "refusals":
        for cls, kw in ((MultihostServing, dict(n_slots=8)),
                        (MultihostLockstep, dict(n_streams=8))):
            try:
                cls(p, cfg, vocab, CacheConfig(**case["cc"]), beam_size=4,
                    **kw)
            except ValueError as e:
                refusals.append(str(e))
        continue
    mesh = make_mesh(model_parallel=case["mp"], device="cpu")
    cc = CacheConfig(**case["cc"])
    kw = dict(compute_dtype=torch.float32, mesh=mesh, beam_size=4)
    if case["kind"] == "serving":
        eng = ServingEngine(p, cfg, vocab, cc, n_slots=8, dsp="numpy", **kw)
        if case.get("load"):
            eng.load(case["load"])
        t1 = case.get("stop", 6)
        res = ns["drive_serving"](eng, case.get("start", 0), t1,
                                  finalize=False)
        state = leaves(eng)
        if case.get("save"):
            eng.save(case["save"])
        else:
            res |= ns["drive_serving"](eng, t1, t1, finalize=True)
    else:
        eng = LockstepEngine(p, cfg, vocab, cc, n_streams=8, **kw)
        n = cc.shift_samples
        audio = np.stack([ns["synth"](n * 4, 500 + s) for s in range(8)])
        for t in range(4):
            eng.tick(audio[:, t * n:(t + 1) * n])
        state = leaves(eng)
        eng.finalize()
        res = {"finals": {s: (eng.transcripts[s], list(eng.tokens[s]))
                          for s in range(8)}}
    if rank == 0:
        json.dump(res, open(os.path.join(out_dir, case["name"] + ".json"),
                            "w"))
        np.savez(os.path.join(out_dir, case["name"] + ".npz"), **state)
    print("case", case["name"], "done", flush=True)
if rank == 0:
    json.dump(refusals, open(os.path.join(out_dir, "refusals.json"), "w"))
'''

CASES = {
    # name: (kind, model parallel)
    "serving_mp2": ("serving", 2),
    "serving_data4": ("serving", 1),
    "lockstep_mp2": ("lockstep", 2),
    "lockstep_data4": ("lockstep", 1),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory, model_setup):
    """tests/test_torch_beam.py's peaked tiny model (its beams emit on
    noise) as an f32 GGUF, and a scratch directory."""
    from conftest import write_tiny_gguf

    arrays, _, cfg = model_setup
    d = tmp_path_factory.mktemp("mesh_beam")
    path = str(d / "tiny_peaked.gguf")
    write_tiny_gguf(path, peaked_arrays(arrays), cfg)
    return {"gguf": path, "dir": d}


def jax_engine(kind, path, mp):
    """JAX's beam engine on a JAX mesh of the ranks' shape (the tests'
    eight virtual CPU devices)."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.params import load_model as jload
    from nemotron_tpu.parallel.mesh import make_mesh as jmesh
    from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock
    from nemotron_tpu.streaming.serving import ServingEngine as JEngine

    p, cfg, vocab = jload(path)
    cc = JCC(**CC_KW, n_mels=cfg.n_mels)
    kw = dict(compute_dtype=jnp.float32, beam_size=K,
              mesh=jmesh(WORLD, model_parallel=mp))
    if kind == "serving":
        return JEngine(p, cfg, vocab, cc, n_slots=N_SLOTS, dsp="numpy", **kw)
    return JLock(p, cfg, vocab, cc, n_streams=N_SLOTS, **kw)


def port_engine(kind, path):
    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    p, cfg, vocab = load_model(path, device="cpu")
    cc = CacheConfig(**CC_KW, n_mels=cfg.n_mels)
    kw = dict(compute_dtype=torch.float32, beam_size=K)
    if kind == "serving":
        return ServingEngine(p, cfg, vocab, cc, n_slots=N_SLOTS, dsp="numpy",
                             **kw)
    return LockstepEngine(p, cfg, vocab, cc, n_streams=N_SLOTS, **kw)


def beam_leaves(eng) -> dict:
    """Every beam-state leaf and K/V cache of an unsharded engine (either
    package) as f32 numpy copies (the port writes them in place)."""
    def f32(v):
        return (v.float().numpy().copy() if isinstance(v, torch.Tensor)
                else np.asarray(v).astype(np.float32))

    out = {f"beam/{f}": f32(getattr(eng.beam_state, f))
           for f in ("h", "c", "prev_token", "scores", "tokens", "lengths")}
    out |= {f"enc/{k}": f32(getattr(eng.enc_state, k))
            for k in ("k_cache", "v_cache")}
    return out


def run(eng, kind):
    """(results, leaves before finalize) of the schedule."""
    ns = _ns()
    if kind == "serving":
        res = ns["drive_serving"](eng, 0, TICKS, finalize=False)
        state = beam_leaves(eng)
        res |= ns["drive_serving"](eng, TICKS, TICKS, finalize=True)
        return as_json(res), state
    n = eng.cc.shift_samples
    audio = np.stack([ns["synth"](n * 4, 500 + s) for s in range(N_SLOTS)])
    for t in range(4):
        eng.tick(audio[:, t * n:(t + 1) * n])
    state = beam_leaves(eng)
    eng.finalize()
    return as_json({"finals": {s: (eng.transcripts[s], list(eng.tokens[s]))
                               for s in range(N_SLOTS)}}), state


@pytest.fixture(scope="module")
def ranks(files):
    """Every case on four ranks, the snapshot crossings and the multihost
    refusals; {case: (results, leaves)} and the refusals."""
    d = files["dir"]
    (d / "schedule.py").write_text(SCHEDULE)
    cc = dict(CC_KW, n_mels=128)
    from nemotron_tpu_torch.params import load_model

    cc["n_mels"] = load_model(files["gguf"], device="cpu")[1].n_mels
    cases = [dict(name=n, kind=k, mp=mp, gguf=files["gguf"], cc=cc)
             for n, (k, mp) in CASES.items()]
    je = jax_engine("serving", files["gguf"], 2)
    _ns()["drive_serving"](je, 0, 3, finalize=False)
    je.save(str(d / "jax_snap.npz"))
    cases += [dict(name="snap_save", kind="serving", mp=2,
                   gguf=files["gguf"], cc=cc, stop=3,
                   save=str(d / "mesh_snap.npz")),
              dict(name="snap_load", kind="serving", mp=2,
                   gguf=files["gguf"], cc=cc, start=3,
                   load=str(d / "jax_snap.npz")),
              dict(name="refusals", kind="refusals", gguf=files["gguf"],
                   cc=cc)]
    (d / "cases.json").write_text(json.dumps(cases))
    run_ranks(WORKER, WORLD, [d / "cases.json", d], timeout=420)
    out = {c["name"]: (json.load(open(d / (c["name"] + ".json"))),
                       dict(np.load(d / (c["name"] + ".npz"))))
           for c in cases if c["kind"] != "refusals"}
    return out, json.load(open(d / "refusals.json"))


def assert_scores_close(got, want, what):
    np.testing.assert_allclose(got["beam/scores"], want["beam/scores"],
                               atol=SCORE_ATOL, rtol=SCORE_RTOL,
                               err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_beam_matches_jax_mesh_and_unsharded(ranks, files, case):
    """Tokens and text equal to JAX's mesh engine of the same shape and to
    the unsharded port engine; beam scores within the beam tests'
    tolerance of both, and the beam's tokens and lengths equal; at
    model-parallel 1 every beam leaf and cache bit-equal to the unsharded
    port engine (at 2, the hypotheses' LSTM states and the caches within
    5e-5)."""
    kind, mp = CASES[case]
    got, got_state = ranks[0][case]
    want, jax_state = run(jax_engine(kind, files["gguf"], mp), kind)
    port, port_state = run(port_engine(kind, files["gguf"]), kind)
    assert got == port
    assert got["finals"] == want["finals"]
    assert any(v[1] for v in got["finals"].values())
    for ref, what in ((jax_state, "jax"), (port_state, "port")):
        assert_scores_close(got_state, ref, what)
        for k in ("beam/tokens", "beam/lengths", "beam/prev_token"):
            np.testing.assert_array_equal(got_state[k], ref[k],
                                          err_msg=f"{what} {k}")
    for k, v in port_state.items():
        if mp == 1:
            np.testing.assert_array_equal(got_state[k], v, err_msg=k)
        elif k != "beam/scores":            # held above
            np.testing.assert_allclose(got_state[k], v, atol=STATE_ATOL,
                                       rtol=0, err_msg=k)


def test_mesh_beam_snapshot_resumes_in_jax_mesh_engine(ranks, files):
    """A beam engine's snapshot saved on the 2 x 2 mesh after 3 ticks (the
    beam state gathered over the data axis) resumes in JAX's mesh engine
    to the uninterrupted JAX run's finals."""
    want, _ = run(jax_engine("serving", files["gguf"], 2), "serving")
    je = jax_engine("serving", files["gguf"], 2)
    je.load(str(files["dir"] / "mesh_snap.npz"))
    got = _ns()["drive_serving"](je, 3, TICKS, finalize=True)
    assert as_json(got)["finals"] == want["finals"]


def test_jax_beam_snapshot_resumes_in_mesh_engine(ranks, files):
    """JAX's mesh beam engine's snapshot after 3 ticks resumes on the
    port's 2 x 2 mesh (each rank taking its rows of the beam state) to the
    uninterrupted JAX run's finals."""
    want, _ = run(jax_engine("serving", files["gguf"], 2), "serving")
    got, _ = ranks[0]["snap_load"]
    assert got["finals"] == want["finals"]


def test_multihost_engines_refuse_beam(ranks):
    """MultihostServing and MultihostLockstep refuse a beam, with JAX's
    MultihostServing's error, on a world of ranks."""
    assert ranks[1] == ["beam decode is not wired multihost (staged "
                        "beam-slot resets not implemented)"] * 2


@pytest.mark.parametrize("lockstep", [False, True])
def test_serve_mesh_beam_cpu(files, lockstep):
    """`serve --mesh 2 --beam 4 --cpu` (either engine): two gloo ranks
    serve one beam slab, and rank 0 prints the unsharded beam run's
    `[slot s]` lines."""
    import subprocess
    import sys

    from torch_dist import REPO, rank_env

    pcm = str(files["dir"] / "serve.pcm")
    (np.random.default_rng(0).standard_normal(24000) * 8000).astype(
        "<i2").tofile(pcm)
    flags = [files["gguf"], pcm, "--streams", "2", "--slots", "4",
             "--right-context", "1", "--seconds", "2", "--cpu", "--beam",
             str(K), *(["--lockstep"] if lockstep else [])]

    def serve(*extra):
        r = subprocess.run([sys.executable, "-m", "nemotron_tpu_torch.serve",
                            *flags, *extra], capture_output=True, text=True,
                           timeout=300, env=rank_env(), cwd=REPO)
        assert r.returncode == 0, r.stdout + r.stderr
        return [ln for ln in r.stdout.splitlines() if ln.startswith("[slot")]

    got = serve("--mesh", "2")
    assert got == serve() and len(got) == 2
    assert any(ln.split("] ", 1)[1:] != [""] for ln in got)
