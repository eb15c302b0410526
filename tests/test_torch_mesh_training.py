"""Training over the port's mesh against the unsharded step, on the CPU:
two ranks on gloo (model-parallel 2, and data-parallel 2), each a
subprocess that imports the port and never JAX. A step's loss within
1e-6 (relative) of the unsharded step's and of JAX's loss_fn's, every
clipped gradient within 1e-5 of its leaf's largest |g|, the clip norm;
save_model on a mesh writes the unsharded file byte for byte, and a
mesh's train state resumes in one process. The train entry point with
--model-parallel against scripts/train.py's lines, in one process and
over two ranks started by torch.distributed.run."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_dist import REPO, free_port, rank_env, run_ranks

from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch import training as ttrain
from nemotron_tpu_torch.train import synthetic_batch

torch.set_num_threads(1)

LR = 1e-3
ATT_CHUNK = 2

WORKER = r'''
import json, os, sys
repo, addr, rank, world, out = sys.argv[1:6]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import numpy as np, torch
torch.set_num_threads(1)
from nemotron_tpu_torch.parallel.mesh import (gather_param, init_world,
                                              make_mesh, shard_params)
init_world(f"tcp://{addr}", world, rank, "gloo")
from nemotron_tpu_torch import params as P
from nemotron_tpu_torch import training as T
from nemotron_tpu_torch.config import ModelConfig
from nemotron_tpu_torch.train import synthetic_batch

cfg = ModelConfig(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                  n_layers=3, kernel_size=9, vocab_size=41, decoder_dim=48,
                  joint_dim=56, subsampling_channels=16)
arrays = P.random_weight_arrays(cfg, seed=0)
batch = synthetic_batch(cfg, 4)
res = {}
for name, mp in (("model2", 2), ("data2", 1)):
    mesh = make_mesh(model_parallel=mp, device="cpu")
    params = T.trainable(shard_params(
        P.params_from_arrays(arrays, cfg, device="cpu"), mesh))
    if name == "model2":
        P.save_model(f"{out}.mesh.gguf", params, cfg)
    opt, sched = T.make_optimizer(params, 1e-3, 10)
    step = T.make_train_step(cfg, opt, sched, att_chunk=2, mesh=mesh)
    loss = float(step(params, batch))
    norm = float(step.grad_norm)
    grads = {k: gather_param(v.grad, k, params.tp).numpy()
             for k, v in P.flatten(params).items()}
    if name == "model2":
        T.save_train_state(f"{out}.ck", params, opt, sched, step=1)
    loss2 = float(step(params, batch))
    res[name] = {"loss": loss, "norm": norm, "loss2": loss2,
                 "split": None if params.tp is None else
                 [params.tp.ffn1, params.tp.ffn2, params.tp.attn]}
    if rank == 0:
        np.savez(f"{out}.{name}.npz", **grads)
if rank == 0:
    json.dump(res, open(f"{out}.json", "w"))
'''


def tiny_cfg():
    from nemotron_tpu_torch.config import ModelConfig

    return ModelConfig(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                       n_layers=3, kernel_size=9, vocab_size=41,
                       decoder_dim=48, joint_dim=56, subsampling_channels=16)


def unsharded():
    cfg = tiny_cfg()
    arrays = tparams.random_weight_arrays(cfg, seed=0)
    params = ttrain.trainable(tparams.params_from_arrays(arrays, cfg,
                                                         device="cpu"))
    opt, sched = ttrain.make_optimizer(params, LR, 10)
    step = ttrain.make_train_step(cfg, opt, sched, att_chunk=ATT_CHUNK)
    return cfg, arrays, params, opt, sched, step


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    out = str(d / "out")
    run_ranks(WORKER, 2, [out], timeout=420)
    res = json.load(open(out + ".json"))
    grads = {n: dict(np.load(f"{out}.{n}.npz")) for n in res}
    return res, grads, out


@pytest.fixture(scope="module")
def reference():
    """The unsharded step: (loss, norm, clipped grads, second loss), and
    the save_model bytes of the fresh params."""
    cfg, _, params, opt, sched, step = unsharded()
    batch = synthetic_batch(cfg, 4)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"unsharded_{os.getpid()}.gguf")
    tparams.save_model(path, params, cfg)
    with open(path, "rb") as f:
        saved = f.read()
    os.remove(path)
    loss = float(step(params, batch))
    norm = float(step.grad_norm)
    grads = {k: v.grad.numpy().copy()
             for k, v in tparams.flatten(params).items()}
    loss2 = float(step(params, batch))
    return {"loss": loss, "norm": norm, "grads": grads, "loss2": loss2,
            "gguf": saved}


@pytest.mark.parametrize("mesh", ["model2", "data2"])
def test_mesh_step_equals_unsharded_step(ranks, reference, mesh):
    """Loss within 1e-6 (relative), the clip norm within 1e-6, every
    clipped gradient within 1e-5 of its leaf's max |g|; the next step's
    loss too (AdamW on the shards)."""
    res, grads, _ = ranks
    got = res[mesh]
    assert got["split"] == ([True, True, True] if mesh == "model2"
                            else None)
    for k in ("loss", "norm", "loss2"):
        np.testing.assert_allclose(got[k], reference[k], rtol=1e-6,
                                   err_msg=k)
    want = reference["grads"]
    assert set(grads[mesh]) == set(want)
    for k, g in want.items():
        assert grads[mesh][k].shape == g.shape, k
        np.testing.assert_allclose(
            grads[mesh][k], g, rtol=0,
            atol=1e-5 * max(np.abs(g).max(), 1e-30), err_msg=k)


def test_mesh_step_loss_matches_jax(ranks, model_setup):
    """The model-parallel step's loss is JAX's loss_fn on the same batch
    (within 1e-5, the JAX tests' loss tolerance)."""
    import jax.numpy as jnp

    from nemotron_tpu import params as jparams
    from nemotron_tpu import training as jtrain

    cfg = tiny_cfg()
    arrays = tparams.random_weight_arrays(cfg, seed=0)
    jp = jparams.params_from_arrays(arrays, cfg)
    b = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg, 4).items()}
    want = float(jtrain.loss_fn(jp, cfg, b, att_chunk=ATT_CHUNK))
    np.testing.assert_allclose(ranks[0]["model2"]["loss"], want, rtol=1e-5)


def test_mesh_save_model_writes_the_unsharded_file(ranks, reference):
    """save_model of a rank's share gathers the heads and FFN columns: the
    GGUF equals the unsharded params' byte for byte (JAX's global keys
    and shapes)."""
    with open(ranks[2] + ".mesh.gguf", "rb") as f:
        assert f.read() == reference["gguf"]


def test_mesh_train_state_resumes_in_one_process(ranks, reference):
    """The model-parallel train state after one step, loaded into an
    unsharded trainer, takes the second step to the mesh's second loss."""
    _, _, params, opt, sched, step = unsharded()
    assert ttrain.load_train_state(ranks[2] + ".ck", params, opt,
                                   sched) == 1
    loss2 = float(step(params, synthetic_batch(tiny_cfg(), 4)))
    np.testing.assert_allclose(loss2, ranks[0]["model2"]["loss2"],
                               rtol=1e-6)


# -- the entry point ----------------------------------------------------------


def jax_script(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_lines(text: str) -> list:
    """(step, loss) of a train run's 'step N  loss L  [Ts]' lines."""
    return [(int(ln.split()[1]), float(ln.split()[3]))
            for ln in text.splitlines() if ln.startswith("step ")]


def mesh_line(text: str) -> str:
    return next(ln for ln in text.splitlines() if ln.startswith("devices:"))


ARGV = ["--random", "--config", "tiny", "--steps", "3", "--batch", "8",
        "--eval-every", "1", "--cpu", "--model-parallel", "2"]


@pytest.fixture(scope="module")
def jax_train_run():
    """scripts/train.py with the same flags, on the tests' 8 CPU devices
    (a data 4 x model 2 mesh)."""
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert jax_script("scripts/train.py").main(["train", *ARGV]) == 0
    return err.getvalue()


def test_train_model_parallel_matches_jax_script(jax_train_run, capsys):
    """`train --model-parallel 2 --cpu` in one process: scripts/train.py's
    rule gives a one-rank mesh (2 does not divide 1), its `devices: n,
    mesh {...}` line as JAX prints it, and JAX's step lines (losses within
    1e-5: JAX sums over its 8-device mesh in another order)."""
    from nemotron_tpu_torch import train

    assert train.main(["train", *ARGV]) == 0
    err = capsys.readouterr().err
    want = mesh_line(jax_train_run)
    assert want.startswith("devices: 8, mesh {'data': 4, 'model': 2}, ")
    assert mesh_line(err) == want.replace(
        "devices: 8, mesh {'data': 4, 'model': 2}",
        "devices: 1, mesh {'data': 1, 'model': 1}")
    got, ref = step_lines(err), step_lines(jax_train_run)
    assert [s for s, _ in got] == [s for s, _ in ref] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in ref],
                               rtol=1e-5)


def test_train_model_parallel_over_two_ranks(jax_train_run, tmp_path):
    """Two ranks started by torch.distributed.run: a model-parallel-2 mesh
    (rank 0 prints JAX's line with the port's mesh), the step lines of
    the one-rank run, and a --save GGUF that loads whole."""
    out = str(tmp_path / "mp2.gguf")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(free_port()), "-m",
         "nemotron_tpu_torch.train", *ARGV, "--save", out],
        capture_output=True, text=True, timeout=180, env=rank_env(),
        cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    assert mesh_line(r.stderr).startswith(
        "devices: 2, mesh {'data': 1, 'model': 2}, batch 8")
    got, ref = step_lines(r.stderr), step_lines(jax_train_run)
    assert [s for s, _ in got] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in ref],
                               rtol=1e-5)
    p, cfg, _ = tparams.load_model(out, device="cpu")
    assert p.layers.attn_q_w.shape == (cfg.n_layers, cfg.d_model,
                                       cfg.n_heads * cfg.d_head)
