"""Training, PyTorch port against the JAX package on the CPU: the
prediction network over label prefixes (with and without warm-up
history), loss_fn and its gradients (RNN-T with and without the delay
penalty, TDT, and the hybrid CTC term), the refusals (quantized params,
delay penalty under TDT), the clipped AdamW update and its schedule
against optax, the train step, remat, the train-state checkpoint, the
mel-padding invariance, the tones sampler and dataset, save_model both
ways, the Glorot init and the Slaney filterbank, lm_sequence_nll, and the
`train` / `train_lm` entry points with --cpu against the JAX scripts.
One train step on the card against the CPU: tests/test_torch_on_card.py.

The model is the JAX tests' tiny config (conftest.tiny_config); batches
are seeded with numpy."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from nemotron_tpu import params as jparams
from nemotron_tpu import training as jtrain
from nemotron_tpu.frontend import preprocessor as jpre
from nemotron_tpu.models import lm as jlm
from nemotron_tpu.ops import quant as jquant
from nemotron_tpu.utils import tones as jtones
from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch import train as ttrain_entry
from nemotron_tpu_torch import train_lm as tlm_entry
from nemotron_tpu_torch import training as ttrain
from nemotron_tpu_torch.frontend import preprocessor as tpre
from nemotron_tpu_torch.models import lm as tlm
from nemotron_tpu_torch.utils import tones as ttones

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.array(v) for p, v in leaves}


def port_of(jp, cfg):
    """The JAX params as fresh trainable port tensors on the CPU."""
    return ttrain.trainable(tparams.params_from_jax_arrays(
        jax_flat(jp), cfg, device="cpu"))


def model(kind: str, seed: int = 0):
    """(cfg, JAX params, port params) of the tiny model: plain RNN-T,
    TDT (durations 0-3) or hybrid (a CTC head)."""
    cfg = tiny_config()
    if kind == "tdt":
        cfg = dataclasses.replace(cfg, tdt_durations=(0, 1, 2, 3))
    arrays = jparams.random_weight_arrays(cfg, seed=seed,
                                          ctc_head=kind == "hybrid")
    jp = jparams.params_from_arrays(arrays, cfg)
    return cfg, jp, port_of(jp, cfg)


def make_batch(cfg, seed, B=2, Tm=41, U=3, lens=(6, 5), ulens=None,
               history=0) -> dict:
    r = np.random.default_rng(seed)
    b = {"mel": r.standard_normal((B, Tm, cfg.n_mels)).astype(np.float32),
         "labels": r.integers(0, cfg.vocab_size - 1, (B, U)).astype(np.int32),
         "mel_lengths": np.asarray(lens, np.int32),
         "label_lengths": np.asarray(ulens or [U] + [U - 1] * (B - 1),
                                     np.int32)}
    if history:
        b["history"] = r.integers(0, cfg.vocab_size - 1,
                                  (B, history)).astype(np.int32)
    return b


def jbatch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def grads_of(tp) -> dict:
    return {k: (v.grad.numpy() if v.grad is not None
                else np.zeros(v.shape, np.float32))
            for k, v in tparams.flatten(tp).items()}


def jax_script(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the prediction network and the loss --------------------------------------


@pytest.mark.parametrize("history", [0, 5])
def test_prediction_network_matches_jax(history):
    """dec_out [B, U+1, H] within 1e-6 of JAX, with and without warm-up
    history."""
    cfg, jp, tp = model("rnnt")
    b = make_batch(cfg, 2, U=4, history=history)
    hist = b.get("history")
    want = jtrain.prediction_network(
        jp, cfg, jnp.asarray(b["labels"]),
        history=None if hist is None else jnp.asarray(hist))
    got = ttrain.prediction_network(
        tp, cfg, torch.from_numpy(b["labels"]),
        history=None if hist is None else torch.from_numpy(hist))
    assert got.shape == (2, 5, cfg.decoder_dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_prediction_network_history_warmup():
    """Row u with history equals the plain network over [history, labels]
    at row R + u; None and a zero-width history are the same
    (tests/test_training.py::test_prediction_network_history_warmup)."""
    cfg, _, tp = model("rnnt")
    rng = np.random.default_rng(3)
    B, U, R = 2, 4, 6
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size - 1, (B, U)))
    hist = torch.from_numpy(rng.integers(0, cfg.vocab_size - 1, (B, R)))
    with torch.no_grad():
        out = ttrain.prediction_network(tp, cfg, labels, history=hist)
        full = ttrain.prediction_network(tp, cfg,
                                         torch.cat([hist, labels], dim=1))
        out0 = ttrain.prediction_network(tp, cfg, labels, history=None)
        outz = ttrain.prediction_network(
            tp, cfg, labels, history=torch.zeros((B, 0), dtype=torch.int64))
    assert out.shape[1] == U + 1
    np.testing.assert_allclose(out.numpy(), full[:, R:].numpy(), atol=1e-6)
    assert torch.equal(out0, outz)


LOSS_CASES = {
    # kind, loss_fn keywords, batch keywords
    "rnnt": ("rnnt", dict(att_chunk=2), dict(history=4)),
    "rnnt_delay": ("rnnt", dict(delay_penalty=0.01), dict()),
    "tdt": ("tdt", dict(tdt_sigma=0.05), dict(history=3)),
    "hybrid_ctc": ("hybrid", dict(ctc_weight=0.3), dict()),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_fn_and_grads_match_jax(case):
    """loss_fn within 1e-5 of JAX's, and the gradient of every leaf within
    1e-4 of that leaf's largest |g| (RNN-T with chunked attention and
    history, the delay penalty, TDT, the hybrid CTC term)."""
    kind, kw, bkw = LOSS_CASES[case]
    cfg, jp, tp = model(kind)
    b = make_batch(cfg, 0, **bkw)
    jb = jbatch(b)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, cfg, jb, **kw)))(jp)
    lt = ttrain.loss_fn(tp, cfg, b, **kw)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5,
                               atol=0)
    want, got = jax_flat(gj), grads_of(tp)
    assert set(want) == set(got)
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("mode", ["q8_0", "w8a8"])
def test_loss_fn_refuses_quantized_params(mode):
    """A Q8_0 or W8A8 leaf raises ValueError: the quantized kernels have
    no backward, so training through them would be silently wrong."""
    cfg, _, tp = model("rnnt")
    q = tparams.quantize_model_params(tparams.map_leaves(
        lambda x: x.detach(), tp), mode)
    b = make_batch(cfg, 0)
    with pytest.raises(ValueError, match="quantized"):
        ttrain.loss_fn(q, cfg, b)
    with pytest.raises(ValueError, match="quantized"):
        ttrain.make_optimizer(q, 1e-3)


def test_loss_fn_refuses_delay_penalty_under_tdt():
    cfg, jp, tp = model("tdt")
    b = make_batch(cfg, 0)
    with pytest.raises(ValueError, match="RNN-T lattice only"):
        ttrain.loss_fn(tp, cfg, b, delay_penalty=0.01)
    with pytest.raises(ValueError, match="RNN-T lattice only"):
        jtrain.loss_fn(jp, cfg, jbatch(b), delay_penalty=0.01)


# -- the optimizer -------------------------------------------------------------


@pytest.mark.parametrize("steps", [None, 50, 1000])
def test_schedule_matches_optax(steps):
    """warmup_cosine at every count of the run (and past its end) against
    optax.warmup_cosine_decay_schedule as scripts/train.py builds it;
    steps=None is the constant rate."""
    import optax

    lr = 3e-4
    n = 60 if steps is None else steps + 5
    if steps is None:
        want = [lr] * n
    else:
        warm = min(100, max(steps // 10, 1))
        sched = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps=warm, decay_steps=max(steps, warm + 1),
            end_value=lr * 0.1)
        want = [float(sched(c)) for c in range(n)]
    got = [ttrain.warmup_cosine(c, lr, steps) for c in range(n)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    if steps is not None:
        assert got[0] == 0.0


def test_clipped_adamw_update_matches_optax():
    """On identical gradients (global norms above and below 1) and
    identical parameters at each step, the port's clip + AdamW + schedule
    step gives optax.chain(clip_by_global_norm(1.0), adamw(sched))'s
    parameters within 1e-7 (relative and absolute), weight decay on every
    leaf."""
    import optax

    cfg, jp, tp = model("rnnt")
    steps, lr = 50, 3e-3
    warm = min(100, max(steps // 10, 1))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=warm, decay_steps=max(steps, warm + 1),
        end_value=lr * 0.1)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(sched, weight_decay=1e-4))
    state = opt.init(jp)
    update = jax.jit(opt.update)
    topt, tsched = ttrain.make_optimizer(tp, lr, steps)
    names = list(tparams.flatten(tp))
    leaves = list(tparams.flatten(tp).values())
    treedef = jax.tree_util.tree_structure(jp)
    r = np.random.default_rng(0)
    for i in range(6):
        scale = 0.002 if i % 2 else 1.0          # norm below / above 1
        g = {k: (r.standard_normal(v.shape) * scale).astype(np.float32)
             for k, v in zip(names, leaves)}
        upd, state = update(jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(g[k]) for k in names]), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in zip(names, leaves):
            p.grad = torch.from_numpy(g[k])
        ttrain.clip_by_global_norm([p.grad for p in leaves])
        topt.step()
        tsched.step()
        want = jax_flat(jp)
        for k, p in zip(names, leaves):
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-7,
                                       atol=1e-7, err_msg=f"step {i} {k}")
            with torch.no_grad():
                p.copy_(torch.from_numpy(want[k]))


def test_train_step_reduces_loss():
    """8 steps of AdamW at 3e-4 on one fixed batch lower the loss
    (tests/test_training.py::test_train_step_reduces_loss)."""
    cfg, _, tp = model("rnnt")
    b = make_batch(cfg, 0, U=3, lens=(6, 6))
    loss0 = ttrain.loss_fn(tp, cfg, b).item()
    assert np.isfinite(loss0)
    opt, sched = ttrain.make_optimizer(tp, 3e-4)
    step = ttrain.make_train_step(cfg, opt, sched)
    for _ in range(8):
        loss = float(step(tp, b))
    assert loss < loss0 and np.isfinite(loss)


def test_remat_gradients_match():
    """Checkpointed layers give the same loss and gradients
    (tests/test_training.py::test_remat_gradients_match's tolerances)."""
    cfg, _, tp = model("rnnt")
    b = make_batch(cfg, 3, Tm=33, U=2, lens=(5, 5), ulens=[2, 2])
    leaves = list(tparams.flatten(tp).values())
    out = []
    for remat in (False, True):
        loss = ttrain.loss_fn(tp, cfg, b, remat=remat)
        out.append((loss.item(), torch.autograd.grad(loss, leaves,
                                                     allow_unused=True)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, c in zip(out[0][1], out[1][1]):
        assert (a is None) == (c is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4,
                                       atol=1e-6)


def test_train_state_checkpoint_resume(tmp_path):
    """Interrupted at step 2, checkpointed, resumed into fresh params and a
    fresh optimizer under the same schedule: the resumed losses equal the
    uninterrupted run's (rtol 1e-6); a checkpoint of another structure is
    refused."""
    cfg, jp, _ = model("rnnt")
    b = make_batch(cfg, 1, Tm=33, U=2, lens=(5, 5), ulens=[2, 2])

    def fresh():
        p = port_of(jp, cfg)
        opt, sched = ttrain.make_optimizer(p, 3e-4, steps=10)
        return p, opt, sched, ttrain.make_train_step(cfg, opt, sched)

    p, _, _, step = fresh()
    losses = [float(step(p, b)) for _ in range(4)]
    p2, opt2, sched2, step2 = fresh()
    for _ in range(2):
        step2(p2, b)
    ck = str(tmp_path / "train.pt")
    ttrain.save_train_state(ck, p2, opt2, sched2, step=2)
    assert not os.path.exists(ck + ".tmp")
    p3, opt3, sched3, step3 = fresh()
    assert ttrain.load_train_state(ck, p3, opt3, sched3) == 2
    resumed = [float(step3(p3, b)) for _ in range(2)]
    np.testing.assert_allclose(resumed, losses[2:], rtol=1e-6)

    other_cfg, ojp, _ = model("hybrid")
    op = port_of(ojp, other_cfg)
    oopt, osched = ttrain.make_optimizer(op, 3e-4)
    with pytest.raises(ValueError, match="structure"):
        ttrain.load_train_state(ck, op, oopt, osched)


def test_loss_invariant_to_mel_padding():
    """Padding the mel with zeros past the valid frames changes neither the
    encoder's valid frames nor the loss
    (tests/test_training.py::test_loss_invariant_to_mel_padding)."""
    from nemotron_tpu_torch.models.encoder import encode_batch

    cfg, _, tp = model("rnnt")
    rng = np.random.default_rng(1234)
    B, U, Tm, Tpad = 2, 3, 25, 41
    mel1 = rng.standard_normal((B, Tm, cfg.n_mels)).astype(np.float32)
    mel2 = np.zeros((B, Tpad, cfg.n_mels), np.float32)
    mel2[:, :Tm] = mel1
    labels = rng.integers(0, cfg.vocab_size - 1, (B, U)).astype(np.int32)
    lens = np.full(B, 3, np.int32)
    with torch.no_grad():
        e1 = encode_batch(tp, cfg, torch.from_numpy(mel1),
                          enc_lengths=torch.from_numpy(lens))
        e2 = encode_batch(tp, cfg, torch.from_numpy(mel2),
                          enc_lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(e1[:, :3].numpy(), e2[:, :3].numpy(),
                               atol=2e-5)

    def batch(mel):
        return {"mel": mel, "labels": labels, "mel_lengths": lens,
                "label_lengths": np.full(B, U, np.int32)}

    l1 = ttrain.loss_fn(tp, cfg, batch(mel1)).item()
    l2 = ttrain.loss_fn(tp, cfg, batch(mel2)).item()
    np.testing.assert_allclose(l1, l2, rtol=2e-5)


def test_hybrid_train_step_decreases_loss():
    """make_train_step(ctc_weight=0.3) on the memorize batch: the combined
    loss falls over 8 steps at 3e-3 and the CTC head moves
    (tests/test_ctc.py::test_hybrid_train_step_decreases_loss)."""
    cfg, _, tp = model("hybrid")
    b = ttrain_entry.synthetic_batch(cfg, 4)
    opt, sched = ttrain.make_optimizer(tp, 3e-3)
    step = ttrain.make_train_step(cfg, opt, sched, ctc_weight=0.3)
    head0 = tp.ctc.out_w.detach().clone()
    losses = [float(step(tp, b)) for _ in range(8)]
    assert losses[-1] < losses[0]
    assert (tp.ctc.out_w.detach() - head0).abs().max() > 0


# -- the tones task --------------------------------------------------------------


def tones_frontend(n_mels=32):
    fb = tpre.mel_filterbank_slaney(n_mels).astype(np.float32)
    return fb, np.hanning(400).astype(np.float32)


def test_filterbank_window_and_glorot_match_jax():
    """mel_filterbank_slaney and hann_window equal JAX's; the Glorot init
    draws JAX's numbers for the same seed (forget-gate biases at 1), and
    'bench' stays the default."""
    for n in (32, 80, 128):
        np.testing.assert_array_equal(tpre.mel_filterbank_slaney(n),
                                      jpre.mel_filterbank_slaney(n))
    np.testing.assert_array_equal(tpre.hann_window(400),
                                  jpre.hann_window(400))
    cfg = tiny_config()
    for init in ("glorot", "bench"):
        got = tparams.random_weight_arrays(cfg, seed=4, init=init,
                                           ctc_head=True)
        want = jparams.random_weight_arrays(cfg, seed=4, init=init,
                                            ctc_head=True)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    default = tparams.random_weight_arrays(cfg, seed=4)
    np.testing.assert_array_equal(default["joint.enc.weight"],
                                  got["joint.enc.weight"])
    with pytest.raises(ValueError, match="init"):
        tparams.random_weight_arrays(cfg, init="xavier")


@pytest.mark.parametrize("kw", [dict(), dict(history_max=192),
                                dict(long_gap_prob=0.9, tones_per_utt_min=1)])
def test_tones_sampler_matches_jax(kw):
    """For the same seed and step: labels, lengths and history equal to
    JAX's, mel within the frontend's 2e-4; make_dataset too."""
    fb, win = tones_frontend()
    common = dict(n_mels=32, n_tones=8, tones_per_utt=3, batch=3, seed=9,
                  dur_range=(0.10, 0.14), **kw)
    js = jtones.TonesSampler(fb, win, **common)
    ts = ttones.TonesSampler(fb, win, device="cpu", **common)
    for step in (0, 5):
        a, b = js.sample(step), ts.sample(step)
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "mel":
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=2e-4)
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    a = jtones.make_dataset(4, 3, 8, fb, win, 32, seed=2)
    b = ttones.make_dataset(4, 3, 8, fb, win, 32, seed=2, device="cpu")
    for k in a:
        if k == "mel":
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=2e-4)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_tones_sampler_fresh_and_deterministic():
    """Static shapes across steps, deterministic in (seed, step) across
    instances and repeated calls, fresh between steps
    (tests/test_training.py::test_tones_sampler_fresh_and_deterministic)."""
    fb, win = tones_frontend()
    kw = dict(n_mels=32, n_tones=8, tones_per_utt=3, batch=2, seed=7,
              dur_range=(0.10, 0.14), device="cpu")
    s1 = ttones.TonesSampler(fb, win, **kw)
    s2 = ttones.TonesSampler(fb, win, **kw)
    b0, b1 = s1.sample(0), s1.sample(1)
    assert b0["mel"].shape == b1["mel"].shape
    assert b0["labels"].shape == (2, 3)
    assert not np.array_equal(b0["mel"], b1["mel"])
    b0b = s2.sample(0)
    np.testing.assert_array_equal(b0["labels"], b0b["labels"])
    np.testing.assert_allclose(b0["mel"], b0b["mel"], atol=1e-6)
    np.testing.assert_allclose(b0["mel"], s1.sample(0)["mel"], atol=1e-6)
    np.testing.assert_array_equal(b0["mel_lengths"], b0b["mel_lengths"])


def test_tones_sampler_history():
    """R is a multiple of 64 up to history_max, deterministic, and takes
    at least three values over 12 steps
    (tests/test_training.py::test_tones_sampler_history)."""
    fb, win = tones_frontend()
    kw = dict(n_mels=32, n_tones=8, tones_per_utt=3, batch=2, seed=11,
              dur_range=(0.10, 0.14), history_max=192, device="cpu")
    s1 = ttones.TonesSampler(fb, win, **kw)
    s2 = ttones.TonesSampler(fb, win, **kw)
    widths = set()
    for i in range(12):
        b1, b2 = s1.sample(i), s2.sample(i)
        w = b1.get("history", np.zeros((2, 0))).shape[1]
        assert w % 64 == 0 and w <= 192
        widths.add(w)
        if w:
            np.testing.assert_array_equal(b1["history"], b2["history"])
            assert b1["history"].min() >= 0 and b1["history"].max() < 8
    assert len(widths) >= 3


def test_tones_sampler_long_gaps():
    """long_gap_prob lengthens the audio and some utterances, keeps the
    labels and determinism, and 0.0 is the base sampler
    (tests/test_training.py::test_tones_sampler_long_gaps)."""
    fb, win = tones_frontend()
    kw = dict(n_mels=32, n_tones=8, tones_per_utt=3, batch=4, seed=5,
              dur_range=(0.10, 0.14), device="cpu")
    base = ttones.TonesSampler(fb, win, **kw)
    aug1 = ttones.TonesSampler(fb, win, long_gap_prob=0.9, **kw)
    aug2 = ttones.TonesSampler(fb, win, long_gap_prob=0.9, **kw)
    off = ttones.TonesSampler(fb, win, long_gap_prob=0.0, **kw)
    assert aug1.n_samples > base.n_samples
    assert off.n_samples == base.n_samples
    grew = False
    for i in range(4):
        bb, b1, b2, bo = (base.sample(i), aug1.sample(i), aug2.sample(i),
                          off.sample(i))
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
        np.testing.assert_array_equal(b1["mel"], b2["mel"])
        np.testing.assert_array_equal(bb["labels"], bo["labels"])
        np.testing.assert_array_equal(bb["mel"], bo["mel"])
        np.testing.assert_array_equal(bb["labels"], b1["labels"])
        grew |= bool((b1["mel_lengths"] > bb["mel_lengths"]).any())
    assert grew


# -- save_model ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rnnt", "tdt_ctc"])
def test_save_model_interchanges_with_jax(kind, tmp_path):
    """The port's save_model read by JAX's load_model gives every leaf
    exactly, and JAX's save_model read by the port's load_model too (the
    TDT durations and the CTC head included), with the config and the
    vocab; params_to_arrays equals JAX's."""
    cfg = tiny_config()
    if kind == "tdt_ctc":
        cfg = dataclasses.replace(cfg, tdt_durations=(0, 1, 2, 3))
    arrays = jparams.random_weight_arrays(cfg, seed=6,
                                          ctc_head=kind == "tdt_ctc")
    jp = jparams.params_from_arrays(arrays, cfg)
    tp = tparams.params_from_arrays(arrays, cfg, device="cpu")
    vocab = [f"t{i}" for i in range(cfg.vocab_size)]
    want_arrays = jparams.params_to_arrays(jp, cfg)
    got_arrays = tparams.params_to_arrays(tp, cfg)
    assert list(got_arrays) == list(want_arrays)
    for k in want_arrays:
        np.testing.assert_array_equal(got_arrays[k], want_arrays[k])

    path = str(tmp_path / "port.gguf")
    tparams.save_model(path, tp, cfg, vocab=vocab)
    lp, lcfg, lvocab = jparams.load_model(path)
    assert dataclasses.asdict(lcfg) == dataclasses.asdict(cfg)
    assert lvocab == vocab
    want = jax_flat(jp)
    got = jax_flat(lp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    path = str(tmp_path / "jax.gguf")
    jparams.save_model(path, jp, cfg, vocab=vocab)
    lp, lcfg, lvocab = tparams.load_model(path, device="cpu")
    assert dataclasses.asdict(lcfg) == dataclasses.asdict(cfg)
    assert lvocab == vocab
    assert (lp.ctc is not None) == (kind == "tdt_ctc")
    got = {k: v.numpy() for k, v in tparams.flatten(lp).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_save_model_quantized_and_long_vocab(tmp_path):
    """quantize_mode 'q8_0' writes the encoder matmuls as Q8_0 blocks that
    both loaders read to the same QTensors; a too-long vocab entry is cut
    to its 7-byte slot with a warning, as JAX's writer does; a Q8_0 leaf
    is written dequantized."""
    cfg, jp, tp = model("rnnt")
    vocab = [f"▁token{i}" for i in range(cfg.vocab_size)]
    path = str(tmp_path / "q.gguf")
    with pytest.warns(UserWarning, match="truncated"):
        tparams.save_model(path, tp, cfg, vocab=vocab, quantize_mode="q8_0")
    lt, _, lvocab = tparams.load_model(path, device="cpu")
    lj, _, jvocab = jparams.load_model(path)
    assert lvocab == jvocab and lvocab[0] == "▁toke"
    assert isinstance(lt.layers.ffn1_w1, tparams.QTensor)
    want = jax_flat(lj)
    for k, v in tparams.flatten(lt).items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    again = str(tmp_path / "deq.gguf")
    tparams.save_model(again, lt, cfg)
    dense, _, _ = tparams.load_model(again, device="cpu")
    np.testing.assert_array_equal(
        dense.layers.ffn1_w1.numpy(),
        np.asarray(jquant.dequantize(lj.layers.ffn1_w1)))


# -- the label LM ----------------------------------------------------------------


@pytest.mark.parametrize("noisy", [False, True])
def test_lm_sequence_nll_matches_jax(noisy):
    """lm_sequence_nll (with teacher-forced or given inputs, ragged
    lengths) within 1e-6 of JAX's, and its gradients within 1e-5 of each
    leaf's largest |g|."""
    V, blank = 20, 19
    arrays = jlm.random_lm_arrays(V, hidden=12, n_layers=2, seed=3,
                                  scale=0.2)
    jl = jax.tree_util.tree_map(jnp.asarray, jlm.lm_params_from_arrays(arrays))
    tl = tlm.lm_params_from_arrays(arrays, device="cpu")
    for f in dataclasses.fields(tl):
        getattr(tl, f.name).requires_grad_(True)
    r = np.random.default_rng(4)
    labels = r.integers(0, blank, (3, 7)).astype(np.int32)
    lengths = np.array([7, 4, 1], np.int32)
    inputs = None
    if noisy:
        inputs = np.concatenate([np.full((3, 1), blank, np.int32),
                                 r.integers(0, blank, (3, 6))], axis=1
                                ).astype(np.int32)
    want, g = jax.value_and_grad(jlm.lm_sequence_nll)(
        jl, jnp.asarray(labels), jnp.asarray(lengths), blank,
        None if inputs is None else jnp.asarray(inputs))
    got = tlm.lm_sequence_nll(
        tl, torch.from_numpy(labels).long(), torch.from_numpy(lengths),
        blank, None if inputs is None else torch.from_numpy(inputs).long())
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    got.backward()
    for f in dataclasses.fields(tl):
        gw = np.asarray(getattr(g, f.name))
        np.testing.assert_allclose(
            getattr(tl, f.name).grad.numpy(), gw, rtol=0,
            atol=1e-5 * max(np.abs(gw).max(), 1e-30), err_msg=f.name)


# -- the entry points --------------------------------------------------------------


def stderr_steps(text: str) -> list[str]:
    """The 'step N  loss L' part of a train run's stderr lines (the
    wall-time field dropped)."""
    return [line.split("  [")[0] + line.split("]", 1)[1]
            for line in text.splitlines() if line.startswith("step ")]


def test_train_entry_point_matches_jax_script(tmp_path, capsys):
    """`python -m nemotron_tpu_torch.train --random --config tiny --cpu`
    prints the JAX script's step lines (losses within 1e-5); its --save
    GGUF transcribes through the port's batch CLI as through JAX's."""
    from nemotron_tpu_torch import cli_transcribe

    # batch 8: the JAX script shards the batch over the test mesh's 8
    # CPU devices
    argv = ["train", "--random", "--config", "tiny", "--steps", "3",
            "--batch", "8", "--eval-every", "1", "--cpu"]
    capsys.readouterr()
    assert jax_script("scripts/train.py").main(list(argv)) == 0
    want = stderr_steps(capsys.readouterr().err)
    out = str(tmp_path / "out.gguf")
    assert ttrain_entry.main(argv + ["--save", out]) == 0
    err = capsys.readouterr().err
    got = stderr_steps(err)
    # the JAX run shards the batch over 8 devices (another summation
    # order): the losses agree to 1e-5, not always in the 4th decimal
    assert [g.split()[:2] for g in got] == [w.split()[:2] for w in want]
    np.testing.assert_allclose([float(g.split()[3]) for g in got],
                               [float(w.split()[3]) for w in want],
                               rtol=1e-5)
    assert len(want) == 3
    assert f"saved trained weights to {out}" in err
    audio, _ = jtones.make_eval_streams(1, 2.0, 16, seed=3)
    pcm = str(tmp_path / "a.pcm")
    audio[0].astype("<i2").tofile(pcm)
    assert cli_transcribe.main(["t", out, pcm, "--cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_script("cli/transcribe.py").main(["t", out, pcm,
                                                 "--cpu"]) == 0
    assert got == capsys.readouterr().out and got.count("\n") == 1


def test_train_entry_point_tones_checkpoint_resume(tmp_path, capsys):
    """Fine-tuning the tones fixture with --cpu: 2 steps with --checkpoint,
    then --resume to 4, print the step lines (loss and val TER) of one
    uninterrupted 4-step run; the saved GGUF carries the tones vocab."""
    base = ["train", FIXTURE, "--task", "tones", "--tones", "16",
            "--utt-tones", "6", "--utt-tones-min", "2", "--history-max", "64",
            "--batch", "2", "--val", "4", "--eval-every", "1", "--cpu"]
    capsys.readouterr()
    assert ttrain_entry.main(base + ["--steps", "4"]) == 0
    whole = stderr_steps(capsys.readouterr().err)
    ck = str(tmp_path / "ck.pt")
    assert ttrain_entry.main(base + ["--steps", "2", "--checkpoint", ck]) == 0
    first = stderr_steps(capsys.readouterr().err)
    out = str(tmp_path / "ft.gguf")
    assert ttrain_entry.main(base + ["--steps", "4", "--resume", ck,
                                     "--save", out]) == 0
    err = capsys.readouterr().err
    assert f"resumed from {ck} at step 2" in err
    assert first + stderr_steps(err) == whole and len(whole) == 4
    assert "val TER" in whole[0]
    _, _, vocab = tparams.load_model(out, device="cpu")
    assert vocab[:2] == ["▁T0", "▁T1"] and vocab[-1] == "<blank>"


@pytest.mark.parametrize("argv,msg", [
    (["--random", "--config", "tiny", "--model-parallel", "0"],
     "the model axis needs at least one rank"),
    (["--random", "--config", "tiny", "--tdt-durations", "0,1,2",
      "--delay-penalty", "0.01"], "RNN-T lattice only"),
    ([FIXTURE, "--ctc-weight", "0.3"], "needs a model with a CTC head"),
])
def test_train_entry_point_refusals(argv, msg, capsys):
    assert ttrain_entry.main(["train", *argv, "--cpu", "--steps", "1"]) == 1
    assert msg in capsys.readouterr().err


def test_train_lm_entry_point_matches_jax_script(tmp_path, capsys):
    """`python -m nemotron_tpu_torch.train_lm --cpu` prints the JAX
    script's NLL lines and result; the saved LM loads with load_lm and
    scores its grammar below uniform."""
    argv = ["--steps", "40", "--batch", "8", "--seq-len", "16", "--cpu"]
    mod = jax_script("scripts/train_lm.py")
    import sys

    old = sys.argv
    sys.argv = ["train_lm.py", *argv]
    try:
        capsys.readouterr()
        assert mod.main() == 0
    finally:
        sys.argv = old
    want = capsys.readouterr()
    path = str(tmp_path / "lm.gguf")
    assert tlm_entry.main(argv + ["--save", path]) == 0
    got = capsys.readouterr()
    assert got.out == want.out
    assert [ln for ln in got.err.splitlines() if ln.startswith("step")] == [
        ln for ln in want.err.splitlines() if ln.startswith("step")]
    lm = tlm.load_lm(path, device="cpu")
    assert lm.embedding.shape == (64, 48)       # the fixture's vocab
