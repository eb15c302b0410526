"""The port's (data, model) mesh against the JAX package and against the
port's unsharded engines, on the CPU: four ranks on gloo (data 2 x model
2, and data 4), each a subprocess that imports the port and never JAX.

  - ServingEngine(mesh=): f32 with host and device DSP, Q8_0, W8A8 with
    dynamic and static activation scales, and W8A8 at d_ff 2048, where
    the FFN pair splits (w2 along K, in whole scale groups of the whole
    weight); LockstepEngine(mesh=) with int8
    and int4 rings and the shared x-ring: tokens and text equal to the
    JAX engines' and the unsharded port engine's, K caches within 2e-4 of
    both (JAX holds its own mesh so: tests/test_serving.py:79-104), every
    state leaf bit-equal to the unsharded port engine at model-parallel 1;
  - snapshots: one saved on a mesh loads in JAX's engine, and the reverse;
  - the sharding rule (JAX's per-field rule, the port's per-pair
    decision), and the W8A8 trouble spot: a dynamic W8A8 weight split
    along K with the local K's activation groups misses the tolerance that
    the whole-group split meets.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_dist import run_ranks

from nemotron_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

WORLD = 4
N_SLOTS = 8
TICKS = 6
CC_KW = dict(att_right_context=1, att_left_context=12)
K_ATOL = 2e-4
# a split FFN against the whole one (the product alone): the partial sums
# meet in another order. A dynamic W8A8 w2 split with the local K's own
# scale groups misses it by ~1e3 (test_w8a8_k_split_needs_whole_groups).
# Free-running, a W8A8 engine turns that last-bit difference into whole
# int8 steps (the split d_ff-2048 case: K gap 4e-5 in one row of layer 1
# after 4 ticks, 9e-3 in layer 2), so that case holds its tokens to the
# unsharded port's and JAX's and its FFN to this bound, not its caches to
# K_ATOL.
PROBE_REL = 1e-5
# the W8A8 tiers against JAX: int8 rounding turns the two packages'
# last-bit differences (summation order, amax * f32(1/127) where JAX
# divides) into whole int8 steps that compound over an engine's chunks, so
# the repo holds free-running W8A8 runs to JAX's tokens only
# (tests/test_torch_serving_tier.py); here too, and the mesh's caches to
# K_ATOL against the unsharded port

# the schedule every engine runs (the ranks, the unsharded port engine and
# the JAX engine): ragged rates, a late admission, an eviction and its slot
# reused, finalize. drive(..., t0, t1) replays the schedule's bookkeeping
# from tick 0 and calls the engine from tick t0 on (a resumed snapshot).
SCHEDULE = r'''
import numpy as np

RATE = [1, 1, 2, 1, 3, 1, 1, 2]


def synth(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 8000).astype(
        np.int16)


def drive_serving(eng, t0=0, t1=6, finalize=True):
    n = eng.cc.shift_samples
    pos, seed, out = {}, {}, {}
    active = set()
    for t in range(t1):
        call = t >= t0
        if t == 0:
            slots = eng.add_streams(6) if call else list(range(6))
            for s in slots:
                active.add(s); pos[s] = 0; seed[s] = 100 + s
        if t == 2:
            s = eng.add_stream() if call else 6
            active.add(s); pos[s] = 0; seed[s] = 200
        if t == 3:
            if call:
                out["removed"] = eng.remove_stream(2, return_tokens=True)
            active.discard(2)
        if t == 4:
            s = eng.add_stream() if call else 2
            active.add(s); pos[s] = 0; seed[s] = 300
        feed = {}
        for s in sorted(active):
            if (t + s) % RATE[s] == 0:
                feed[s] = synth(n * 6, seed[s])[pos[s]:pos[s] + n]
                pos[s] += n
        if call:
            eng.feed_audio(feed)
            eng.step()
    if finalize:
        out["finals"] = {s: eng.finalize_stream(s, return_tokens=True)
                         for s in sorted(active)}
    return out

'''

# one rank: every case in turn (rank 0 writes the results)
WORKER = r'''
import json, os, sys
repo, addr, rank, world, cases_path, out_dir = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import numpy as np, torch
torch.set_num_threads(1)
from nemotron_tpu_torch.parallel.mesh import (gather_state, init_world,
                                              make_mesh)
init_world(f"tcp://{addr}", world, rank, "gloo")
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.params import load_model, quantize_model_params
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
from nemotron_tpu_torch.streaming.serving import ServingEngine
from nemotron_tpu_torch.utils import npz
ns = {}
exec(open(os.path.join(out_dir, "schedule.py")).read(), ns)

def model(case):
    p, cfg, vocab = load_model(case["gguf"], device="cpu")
    if case.get("quant") == "w8a8":
        p = quantize_model_params(p, "w8a8")
    if case.get("params"):     # the JAX package's calibration, carried
        p = torch.load(case["params"], weights_only=False)
    return p, cfg, vocab

def state_leaves(eng):
    enc = gather_state(eng.enc_state, eng.mesh, eng._heads_split())
    dec = gather_state(eng.dec_state, eng.mesh)
    return {**{f"enc/{k}": npz.to_numpy(v) for k, v in vars(enc).items()},
            **{f"dec/{k}": npz.to_numpy(v) for k, v in vars(dec).items()}}

def ffn_probe(p, cfg):
    """Layer 0's first FFN (the rank's share, summed over the model axis
    where it is split) on seeded rows."""
    from nemotron_tpu_torch.models.encoder import _group
    from nemotron_tpu_torch.ops.basic import ffn
    lp = p.layers.unstack(cfg.n_layers)[0]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (40, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        return ffn(x, lp.ffn1_w1, lp.ffn1_w2, _group(p.tp, "ffn1"))

for case in json.load(open(cases_path)):
    p, cfg, vocab = model(case)
    mesh = make_mesh(model_parallel=case["mp"], device="cpu")
    cc = CacheConfig(**case["cc"])
    name = case["name"]
    kw = dict(compute_dtype=torch.float32, mesh=mesh)
    if case["kind"] == "serving":
        eng = ServingEngine(p, cfg, vocab, cc, n_slots=8, dsp=case["dsp"],
                            **kw)
        if case.get("load"):
            eng.load(case["load"])
        t1 = case.get("stop", 6)
        res = ns["drive_serving"](eng, case.get("start", 0), t1,
                                  finalize=False)
        state = state_leaves(eng)
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
        state = state_leaves(eng)
        eng.finalize()
        res = {"finals": {s: (eng.transcripts[s], list(eng.tokens[s]))
                          for s in range(8)}}
    res["split"] = None if eng.params.tp is None else [
        eng.params.tp.ffn1, eng.params.tp.ffn2, eng.params.tp.attn]
    state["probe/ffn1"] = ffn_probe(eng.params, cfg).numpy()
    if rank == 0:
        json.dump(res, open(os.path.join(out_dir, name + ".json"), "w"))
        np.savez(os.path.join(out_dir, name + ".npz"), **state)
    print("case", name, "done", flush=True)
'''


def _ns() -> dict:
    ns = {}
    exec(SCHEDULE, ns)
    return ns


def _cc(extra=()):
    return dict(CC_KW, **dict(extra))


CASES = {
    # name: (kind, gguf, quant, dsp, mp, cache extras)
    "serving_f32_numpy": ("serving", "f32", None, "numpy", 2, ()),
    "serving_f32_device": ("serving", "f32", None, "device", 2, ()),
    "serving_q8_numpy": ("serving", "q8", None, "numpy", 2, ()),
    "serving_w8a8_numpy": ("serving", "f32", "w8a8", "numpy", 2, ()),
    "serving_w8a8_static": ("serving", "f32", "w8a8-sq-static", "numpy", 2,
                            ()),
    "serving_f32_data4": ("serving", "f32", None, "numpy", 1, ()),
    # d_ff 2048: the dynamic W8A8 FFN pair splits (w2's local K 1024 holds
    # whole groups of the whole weight's w8a8_k_tile, 1024)
    "serving_w8a8_ffn_split": ("serving", "wide", "w8a8", "numpy", 2, ()),
    "lockstep_int8": ("lockstep", "f32", None, None, 2,
                      (("kv_cache_int8", True),)),
    "lockstep_int4": ("lockstep", "f32", None, None, 2,
                      (("kv_cache_int4", True),)),
    "lockstep_shared_int8": ("lockstep", "f32", None, None, 2,
                             (("shared_cache", True),
                              ("kv_cache_int8", True))),
    "lockstep_data4": ("lockstep", "f32", None, None, 1, ()),
}
# which products split at model-parallel 2 on the tiny config: the Q8_0
# FFNs stay whole (w2's scale axis has 3 blocks), and so does every W8A8
# pair (a dynamic weight split along K would take the local K's scale
# groups, not the whole weight's; the static SmoothQuant tier keeps w2 and
# attn_out dynamic). At d_ff 2048 (the "wide" model) and at full width
# the W8A8 FFNs split and the attention stays whole (attn_out's local K
# would take groups of its own).
SPLITS = {"serving_f32_numpy": [True, True, True],
          "serving_f32_device": [True, True, True],
          "serving_q8_numpy": [False, False, True],
          "serving_w8a8_numpy": None,
          "serving_w8a8_static": None,
          "serving_w8a8_ffn_split": [True, True, False],
          "serving_f32_data4": None, "lockstep_data4": None}


@pytest.fixture(scope="module")
def files(tmp_path_factory, model_setup):
    """The tiny model's GGUFs (f32 and Q8_0), the tiny model at d_ff 2048
    (f32, "wide") and a scratch directory."""
    from conftest import write_tiny_gguf

    from nemotron_tpu import gguf
    from nemotron_tpu.ops import quant

    arrays, _, cfg = model_setup
    d = tmp_path_factory.mktemp("mesh")
    f32 = str(d / "tiny.gguf")
    q8 = str(d / "tiny_q8.gguf")
    write_tiny_gguf(f32, arrays, cfg)
    qn = {n: gguf.GGML_Q8_0 for n in arrays
          if quant.should_quantize(n, arrays[n] if arrays[n].ndim != 3
                                   else arrays[n].squeeze())}
    write_tiny_gguf(q8, arrays, cfg, quantize=qn)
    from nemotron_tpu import params as jparams

    wide_cfg = dataclasses.replace(cfg, d_ff=2048)
    wide = str(d / "tiny_wide.gguf")
    write_tiny_gguf(wide, jparams.random_weight_arrays(wide_cfg, seed=0),
                    wide_cfg)
    return {"f32": f32, "q8": q8, "wide": wide, "dir": d}


def jax_model(path, quant=None):
    """(params, cfg, vocab) of the JAX package, quantized as the ranks'
    (w8a8-sq-static: SmoothQuant calibrated on seeded mel, static
    activation scales)."""
    from nemotron_tpu import params as jparams

    p, cfg, vocab = jparams.load_model(path)
    if quant == "w8a8":
        p = jparams.quantize_model_params(p, "w8a8")
    elif quant == "w8a8-sq-static":
        from nemotron_tpu.ops import smoothquant as jsq

        mel = np.random.default_rng(3).standard_normal(
            (2, 48, cfg.n_mels)).astype(np.float32)
        p = jsq.smooth_quantize(p, cfg, mel, att_chunk=4, static_act=True)
    return p, cfg, vocab


def carried_static(path, out):
    """The JAX package's static SmoothQuant params carried into the port
    (the tier is exact given the same params; the port's own calibration
    differs by a rounding step in some weights: test_torch_smoothquant),
    saved to `out` for the ranks."""
    import jax

    from nemotron_tpu_torch.params import params_from_jax_arrays

    jp, cfg, _ = jax_model(path, "w8a8-sq-static")
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    flat = {jax.tree_util.keystr(k)[1:]: np.asarray(v) for k, v in leaves}
    torch.save(params_from_jax_arrays(flat, cfg, device="cpu"), out)
    return out


def jax_engine(kind, path, quant, dsp, cc_extra):
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.streaming.lockstep import LockstepEngine as JLock
    from nemotron_tpu.streaming.serving import ServingEngine as JEngine

    p, cfg, vocab = jax_model(path, quant)
    cc = JCC(**_cc(cc_extra), n_mels=cfg.n_mels)
    if kind == "serving":
        return JEngine(p, cfg, vocab, cc, n_slots=N_SLOTS,
                       compute_dtype=jnp.float32, dsp=dsp)
    return JLock(p, cfg, vocab, cc, n_streams=N_SLOTS,
                 compute_dtype=jnp.float32)


def port_engine(kind, path, quant, dsp, cc_extra):
    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model, quantize_model_params
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    p, cfg, vocab = load_model(path, device="cpu")
    if quant == "w8a8":
        p = quantize_model_params(p, "w8a8")
    elif quant == "w8a8-sq-static":
        p = torch.load(os.path.join(os.path.dirname(path), "static.pt"),
                       weights_only=False)
    cc = CacheConfig(**_cc(cc_extra), n_mels=cfg.n_mels)
    if kind == "serving":
        return ServingEngine(p, cfg, vocab, cc, n_slots=N_SLOTS,
                             compute_dtype=torch.float32, dsp=dsp)
    return LockstepEngine(p, cfg, vocab, cc, n_streams=N_SLOTS,
                          compute_dtype=torch.float32)


def run(eng, kind):
    """(results, state leaves before finalize) of the schedule."""
    ns = _ns()
    if kind == "serving":
        res = ns["drive_serving"](eng, 0, TICKS, finalize=False)
        state = leaves(eng)
        res |= ns["drive_serving"](eng, TICKS, TICKS, finalize=True)
        return res, state
    n = eng.cc.shift_samples
    audio = np.stack([ns["synth"](n * 4, 500 + s) for s in range(N_SLOTS)])
    for t in range(4):
        eng.tick(audio[:, t * n:(t + 1) * n])
    state = leaves(eng)
    eng.finalize()
    return {"finals": {s: (eng.transcripts[s], list(eng.tokens[s]))
                       for s in range(N_SLOTS)}}, state


def leaves(eng) -> dict:
    out = {}
    for side in ("enc", "dec"):
        st = getattr(eng, f"{side}_state")
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            out[f"{side}/{f.name}"] = (v.float().numpy().copy()
                                       if isinstance(v, torch.Tensor)
                                       else np.asarray(v).astype(np.float32))
    return out


def ffn_probe(eng) -> np.ndarray:
    """The worker's probe on an unsharded engine: layer 0's first FFN."""
    ns = {"torch": torch, "np": np}
    exec(WORKER[WORKER.index("def ffn_probe"):WORKER.index("for case in")],
         ns)
    return ns["ffn_probe"](eng.params, eng.cfg).numpy()


def as_json(res) -> dict:
    """Results in the ranks' JSON form (tuples as lists, str keys)."""
    return json.loads(json.dumps(res, default=lambda o: o.item()))


@pytest.fixture(scope="module")
def ranks(files):
    """Every case on four ranks (data 2 x model 2, or data 4), and the two
    snapshot crossings; {case: (results, state leaves)}."""
    d = files["dir"]
    (d / "schedule.py").write_text(SCHEDULE)
    static = carried_static(files["f32"], str(d / "static.pt"))
    cases = [dict(name=name, kind=kind, gguf=files[g], quant=q, dsp=dsp,
                  mp=mp, cc=_cc(extra),
                  params=static if q == "w8a8-sq-static" else None)
             for name, (kind, g, q, dsp, mp, extra) in CASES.items()]
    # a mesh snapshot after 3 ticks (JAX resumes it), and a mesh engine
    # resuming the JAX engine's snapshot after 3 ticks
    je = jax_engine("serving", files["f32"], None, "numpy", ())
    _ns()["drive_serving"](je, 0, 3, finalize=False)
    je.save(str(d / "jax_snap.npz"))
    cases += [dict(name="snap_save", kind="serving", gguf=files["f32"],
                   dsp="numpy", mp=2, cc=_cc(), stop=3,
                   save=str(d / "mesh_snap.npz")),
              dict(name="snap_load", kind="serving", gguf=files["f32"],
                   dsp="numpy", mp=2, cc=_cc(), start=3,
                   load=str(d / "jax_snap.npz"))]
    (d / "cases.json").write_text(json.dumps(cases))
    run_ranks(WORKER, WORLD, [d / "cases.json", d], timeout=420)
    out = {}
    for c in cases:
        res = json.load(open(d / (c["name"] + ".json")))
        out[c["name"]] = (res, dict(np.load(d / (c["name"] + ".npz"))))
    return out


def assert_k_close(got: dict, want: dict, what: str):
    """K/V caches within K_ATOL (the shared x-ring has no V)."""
    for k in ("enc/k_cache", "enc/v_cache"):
        np.testing.assert_allclose(got[k], want[k], atol=K_ATOL, rtol=0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_matches_jax_and_unsharded(ranks, files, case):
    """Tokens and text equal to the JAX engine's and the unsharded port
    engine's, K/V caches within 2e-4 of both (on the W8A8 tiers, of the
    unsharded port's: see K_ATOL; the split W8A8 FFN case holds its
    FFN instead: see PROBE_REL); at model-parallel 1 every state leaf
    bit-equal to the unsharded port engine; the products split as the
    pair rule says; layer 0's first FFN within PROBE_REL of the unsharded
    product (bit-equal at model-parallel 1)."""
    kind, g, quant, dsp, mp, extra = CASES[case]
    got, got_state = ranks[case]
    assert got["split"] == SPLITS.get(case, [True, True, True]), case
    port, port_state = run(port_engine(kind, files[g], quant, dsp, extra),
                           kind)
    jaxr, jax_state = run(jax_engine(kind, files[g], quant, dsp, extra),
                          kind)
    port, jaxr = as_json(port), as_json(jaxr)
    assert got == dict(port, split=got["split"])
    assert got["finals"] == jaxr["finals"]
    assert any(v[1] for v in got["finals"].values())
    if not (quant or "").startswith("w8a8"):
        assert_k_close(got_state, jax_state, "jax")
    probe = ffn_probe(port_engine(kind, files[g], quant, dsp, extra))
    if mp == 1:
        for k, v in port_state.items():
            np.testing.assert_array_equal(got_state[k], v, err_msg=k)
        np.testing.assert_array_equal(got_state["probe/ffn1"], probe)
    else:
        np.testing.assert_allclose(got_state["probe/ffn1"], probe, rtol=0,
                                   atol=PROBE_REL * np.abs(probe).max())
        w8a8_ffn_split = quant == "w8a8" and bool(got["split"]) and \
            got["split"][1]
        if not w8a8_ffn_split:
            assert_k_close(got_state, port_state, "port")


def test_mesh_snapshot_loads_in_jax_engine(ranks, files):
    """A ServingEngine snapshot saved on the 2 x 2 mesh after 3 ticks
    resumes in a fresh JAX engine to the JAX engine's uninterrupted
    results."""
    want, _ = run(jax_engine("serving", files["f32"], None, "numpy", ()),
                  "serving")
    je = jax_engine("serving", files["f32"], None, "numpy", ())
    je.load(str(files["dir"] / "mesh_snap.npz"))
    ns = _ns()
    got = ns["drive_serving"](je, 3, TICKS, finalize=True)
    assert as_json(got)["finals"] == as_json(want)["finals"]


def test_jax_snapshot_loads_in_mesh_engine(ranks, files):
    """The JAX engine's snapshot after 3 ticks resumes in a fresh engine on
    the 2 x 2 mesh to the JAX engine's uninterrupted results."""
    want, _ = run(jax_engine("serving", files["f32"], None, "numpy", ()),
                  "serving")
    got, _ = ranks["snap_load"]
    assert got["finals"] == as_json(want)["finals"]


def test_mesh_snapshot_equals_unsharded_snapshot(ranks, files):
    """ServingEngine.save on the mesh writes the file the unsharded engine
    writes: the same keys, shapes and values (caches within 2e-4)."""
    eng = port_engine("serving", files["f32"], None, "numpy", ())
    _ns()["drive_serving"](eng, 0, 3, finalize=False)
    path = str(files["dir"] / "port_snap.npz")
    eng.save(path)
    got = np.load(str(files["dir"] / "mesh_snap.npz"), allow_pickle=True)
    want = np.load(path, allow_pickle=True)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        if got[k].dtype == object:
            assert list(got[k]) == list(want[k]), k
        else:
            np.testing.assert_allclose(got[k].astype(np.float64),
                                       want[k].astype(np.float64),
                                       atol=K_ATOL, rtol=0, err_msg=k)


# -- the sharding rule --------------------------------------------------------


def test_pspec_rule_is_jax_rule(model_setup):
    """Every layer leaf path of a Q8_0 and a W8A8 (static) model gets JAX's
    per-field PartitionSpec from the port's copy of the rule."""
    from nemotron_tpu.parallel.mesh import _pspec_for_param as jrule

    fields = [f.name for f in dataclasses.fields(
        model_setup[1].layers)]
    for f in fields:
        for part, nd in (("", 3), ("/q", 3), ("/scale", 3),
                         ("/col_scale", 2), ("/act_scale", 1)):
            path = f"layers/{f}{part}"
            assert tmesh._pspec_for_param(path, nd) == tuple(
                jrule(path, nd)), path


def _fake_mesh(model):
    return tmesh.Mesh(data=1, model=model, rank=0, data_index=0,
                      model_index=0, device=torch.device("cpu"),
                      backend="gloo", data_group=None, model_group=None)


@pytest.mark.parametrize("quant,split", [
    (None, {"ffn1": 2, "ffn2": 2, "attn": 2}),
    ("q8_0", {"ffn1": None, "ffn2": None, "attn": 2}),
    ("w8a8", {"ffn1": None, "ffn2": None, "attn": None})])
def test_pair_rule_on_tiny_config(model_setup, quant, split):
    """A pair splits only when every leaf of it divides: on the tiny
    config (d_ff 96) the Q8_0 FFNs stay whole (w2's scale axis has 3
    blocks), the dynamic W8A8 pairs too (the local K's groups are not the
    whole weight's); whole pairs keep every leaf whole."""
    from nemotron_tpu_torch.params import (params_from_arrays,
                                           quantize_model_params)

    arrays, _, cfg = model_setup
    p = params_from_arrays(arrays, cfg, device="cpu")
    if quant:
        p = quantize_model_params(p, quant)
    axes = tmesh.param_shardings(p, _fake_mesh(2))
    for pair, fields in tmesh.PAIRS.items():
        for f in fields:
            keys = [k for k in axes if k.startswith(f"layers.{f}")]
            assert keys
            if split[pair] is None:
                assert all(axes[k] is None for k in keys), (pair, keys)
            else:
                assert any(axes[k] is not None for k in keys), (pair, keys)
    assert all(v is None for v in tmesh.param_shardings(
        p, _fake_mesh(1)).values())


def test_make_mesh_refuses_indivisible_model_parallel():
    """JAX's ValueError: the rank count not divisible by model_parallel
    (a one-rank world in this process)."""
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        tmesh.make_mesh(model_parallel=2, device="cpu")
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.row_span(8) == (0, 8)


def test_w8a8_k_split_needs_whole_groups():
    """The trouble spot: a dynamic W8A8 weight split along K into halves
    whose local K gives its own activation-scale group (K = 1024 -> two
    halves of 512, groups of 512 instead of the whole weight's 1024) sums
    to a product that misses the tolerance which the whole-group split
    (K = 2048 -> two halves of 1024, the whole weight's groups) meets;
    the pair rule takes the second and refuses the first."""
    from nemotron_tpu_torch.ops.quant import QTensorW8A8, quantize_tensor_w8a8
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul_ref

    rng = np.random.default_rng(0)
    tol = 1e-5
    errs = {}
    for K in (1024, 2048):
        x = rng.standard_normal((16, K)).astype(np.float32)
        # one outlier column per half changes the local group amax
        x[:, K // 4] *= 40.0
        w = quantize_tensor_w8a8(rng.standard_normal((K, 64)).astype(
            np.float32) * 0.05)
        q = torch.from_numpy(w.q)
        cs = torch.from_numpy(w.col_scale)
        xt = torch.from_numpy(x)
        whole = w8a8_matmul_ref(xt, q, cs)
        h = K // 2
        split = (w8a8_matmul_ref(xt[:, :h].contiguous(), q[:h], cs)
                 + w8a8_matmul_ref(xt[:, h:].contiguous(), q[h:], cs))
        errs[K] = float((split - whole).abs().max()
                        / whole.abs().max())
        layer = type("L", (), {})()
        layer.ffn1_w1 = QTensorW8A8(q=q[None].transpose(1, 2), col_scale=(
            torch.ones(1, K)))
        layer.ffn1_w2 = QTensorW8A8(q=q[None], col_scale=cs[None])
        assert tmesh._pair_splits(layer, ("ffn1_w1", "ffn1_w2"), 2) == (
            K == 2048)
    assert errs[2048] <= tol < errs[1024], errs


def test_state_shards_round_trip():
    """shard_state / gather_state over a one-rank mesh give back every
    leaf bit for bit; state_shardings puts the stream axis where JAX's
    rank map does ([L, B, ...] caches on 1, [B, ...] on 0) and the head
    axis of the split rings on 2; a one-rank mesh's row span is every
    row."""
    from nemotron_tpu_torch.config import CacheConfig, ModelConfig
    from nemotron_tpu_torch.models import decoder as tdec
    from nemotron_tpu_torch.models import encoder as tenc

    cfg = ModelConfig(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                      n_layers=3, vocab_size=41, decoder_dim=48,
                      joint_dim=56, subsampling_channels=16)
    cc = CacheConfig(**CC_KW, n_mels=cfg.n_mels)
    mesh = tmesh.make_mesh(device="cpu")
    enc = tenc.init_encoder_state(cfg, cc, 4, torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    for f in dataclasses.fields(enc):
        v = getattr(enc, f.name)
        v.copy_(torch.randint(0, 100, v.shape, generator=g).to(v.dtype))
    spec = tmesh.state_shardings(enc, mesh, heads_split=True)
    assert spec["k_cache"] == (1, 2) and spec["conv_cache"] == (1, None)
    assert spec["valid_len"] == (0, None)
    back = tmesh.gather_state(tmesh.shard_state(enc, mesh, True), mesh, True)
    for f in dataclasses.fields(enc):
        assert torch.equal(getattr(back, f.name), getattr(enc, f.name))
    dec = tdec.init_decoder_state(cfg, 4, torch.float32, "cpu")
    assert tmesh.state_shardings(dec, mesh)["h"] == (0, None)
    assert mesh.row_span(4) == (0, 4)
