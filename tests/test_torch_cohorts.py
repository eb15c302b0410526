"""Phase-staggered cohorts and the many-stream `serve` entry point of the
PyTorch port, against the JAX package on the CPU: CohortScheduler (lockstep
cohorts) and ServingCohorts (ragged engine cohorts) share one copy of the
weights (the same `data_ptr`), each cohort equals a solo engine of the port
and JAX's cohort on the same audio, phases, snapshots, removal and reuse;
`python -m nemotron_tpu_torch.serve --cpu` with and without --lockstep
prints what the engine driven directly gives, and refuses the flags of
later slices. On a machine with a card, both cohort kinds on the card
against the CPU (marked `cuda`; skipped without one).

The JAX imports sit inside fixtures and tests, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_cohorts.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.config import ModelConfig
from nemotron_tpu_torch.params import (flatten, load_model,
                                       params_from_arrays,
                                       params_from_jax_arrays,
                                       random_weight_arrays)
from nemotron_tpu_torch.streaming.cohorts import (CohortScheduler,
                                                  ServingCohorts)
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine as TLock
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.utils import tones as ttones

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
F32, BF16 = torch.float32, torch.bfloat16


def synth(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 8000).astype(
        np.int16)


def jax_flat(params) -> dict:
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def tiny(model_setup):
    """(JAX params, port params, config, vocab) of the tiny random model."""
    _arrays, jp, cfg = model_setup
    tp = params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg, [f"w{i}" for i in range(cfg.vocab_size)]


def lockstep_cc(cfg):
    return TCC(att_right_context=1, att_left_context=12, n_mels=cfg.n_mels)


def assert_weights_shared(engines):
    """Every weight leaf, the position projections (and, for lockstep
    engines, the DSP window and filterbank) of each later engine are
    engine 0's tensors: the same data_ptr."""
    first = engines[0]
    leaves0 = flatten(first.params)
    for eng in engines[1:]:
        leaves = flatten(eng.params)
        assert leaves.keys() == leaves0.keys()
        for k, v in leaves.items():
            assert v.data_ptr() == leaves0[k].data_ptr(), k
        assert eng.pos_heads.data_ptr() == first.pos_heads.data_ptr()
        if isinstance(eng, TLock):
            assert eng.window.data_ptr() == first.window.data_ptr()
            assert eng.filterbank.data_ptr() == first.filterbank.data_ptr()
        assert eng.enc_state.k_cache.data_ptr() != \
            first.enc_state.k_cache.data_ptr()


# -- CohortScheduler (lockstep cohorts) -----------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_lockstep_cohorts_share_weights(tiny, dtype):
    """tests/test_cohorts.py:36-46: three cohorts, one weight set (engine
    0 casts, the later engines' casts return its tensors), in f32 and
    bf16."""
    _jp, tp, cfg, vocab = tiny
    sched = CohortScheduler(tp, cfg, vocab, lockstep_cc(cfg), n_streams=2,
                            n_cohorts=3, compute_dtype=dtype)
    assert_weights_shared(sched.engines)
    assert sched.engines[2].params.layers.ffn1_w1.dtype == dtype
    with pytest.raises(ValueError, match="n_cohorts"):
        CohortScheduler(tp, cfg, vocab, n_streams=2, n_cohorts=0)


@pytest.mark.parametrize("pipelined", [False, True])
def test_lockstep_cohorts_match_solo_engines_and_jax(tiny, pipelined):
    """tests/test_cohorts.py:49-82: cohort 0 ticks, then cohort 1, three
    rounds (plain or pipelined ticks); each cohort's finals equal a solo
    port LockstepEngine fed the same audio with plain ticks, and every
    tick's text and the finals equal JAX's CohortScheduler; stream ids map
    both ways."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.streaming.cohorts import CohortScheduler as JSched

    jp, tp, cfg, vocab = tiny
    B, C, T = 2, 2, 3
    cc = lockstep_cc(cfg)
    n = cc.shift_samples
    audio = {c: np.stack([np.concatenate([synth(n, 100 * c + 10 * t + s)
                                          for t in range(T)])
                          for s in range(B)])
             for c in range(C)}
    sched = CohortScheduler(tp, cfg, vocab, cc, n_streams=B, n_cohorts=C,
                            compute_dtype=F32)
    jsched = JSched(jp, cfg, vocab, JCC(att_right_context=1,
                                        att_left_context=12,
                                        n_mels=cfg.n_mels),
                    n_streams=B, n_cohorts=C, compute_dtype=jnp.float32)
    for t in range(T):
        for c in range(C):
            blk = audio[c][:, t * n:(t + 1) * n]
            out = sched.tick(c, blk, pipelined=pipelined)
            assert out == jsched.tick(c, blk, pipelined=pipelined)
            assert all(sched.locate(sid)[0] == c for sid in out)
    finals = sched.finalize()
    assert finals == jsched.finalize() == sched.transcripts
    assert any(finals)
    for c in range(C):
        solo = TLock(tp, cfg, vocab, cc, n_streams=B, compute_dtype=F32)
        for t in range(T):
            solo.tick(audio[c][:, t * n:(t + 1) * n])
        want = solo.finalize()
        for s in range(B):
            sid = sched.stream_id(c, s)
            assert finals[sid] == want[s], (c, s)
            assert sched.locate(sid) == (c, s)
            assert sched.engines[c].tokens[s] == solo.tokens[s]
    assert sched.refresh_transcripts() == finals


def test_lockstep_cohort_assign_phase(tiny):
    """tests/test_cohorts.py:85-95: an arrival goes to the cohort whose
    phase comes next, within period/C."""
    _jp, tp, cfg, vocab = tiny
    cc = lockstep_cc(cfg)
    sched = CohortScheduler(tp, cfg, vocab, cc, n_streams=1, n_cohorts=4,
                            compute_dtype=F32)
    period = cc.chunk_samples / cc.sample_rate
    for frac, want in [(0.0, 0), (0.05, 1), (0.26, 2), (0.74, 3),
                       (0.76, 0), (0.99, 0)]:
        got = sched.assign(frac * period)
        assert got == want, (frac, got, want)
        assert (got / 4 - frac) % 1.0 < 1 / 4 + 1e-9


def test_lockstep_cohort_snapshot_roundtrip(tiny, tmp_path):
    """tests/test_cohorts.py:98-111: one snapshot file a cohort; a fresh
    scheduler loads them and ticks to the same text and transcripts."""
    _jp, tp, cfg, vocab = tiny
    cc = lockstep_cc(cfg)

    def make():
        return CohortScheduler(tp, cfg, vocab, cc, n_streams=2, n_cohorts=2,
                               compute_dtype=F32)

    sched = make()
    n = cc.shift_samples
    for c in range(2):
        sched.tick(c, np.stack([synth(n, c * 7 + s) for s in range(2)]))
    sched.save(str(tmp_path / "snap"))
    assert sorted(os.listdir(tmp_path)) == ["snap.cohort0.npz",
                                            "snap.cohort1.npz"]
    fresh = make()
    fresh.load(str(tmp_path / "snap"))
    for c in range(2):
        blk = np.stack([synth(n, 50 + c * 7 + s) for s in range(2)])
        assert sched.tick(c, blk) == fresh.tick(c, blk)
    assert sched.transcripts == fresh.transcripts
    assert any(sched.transcripts)


# -- ServingCohorts (ragged engine cohorts) --------------------------------------


def _audio(seed, n=4000):
    return synth(n, seed)


@pytest.mark.parametrize("dsp", ["numpy", "device"])
def test_serving_cohorts_match_solo_and_jax(tiny, dsp):
    """tests/test_serving_cohorts.py:19-72: three streams in two cohorts
    at ragged rates over staggered rounds; every round's text equals JAX's
    ServingCohorts, each stream's transcript and tokens equal a solo port
    engine fed the same audio, and the engines share the weights (with
    device DSP each keeps its own DSP buffers)."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.streaming.cohorts import ServingCohorts as JCohorts

    jp, tp, cfg, _ = tiny
    kw = dict(att_right_context=1, att_left_context=14, n_mels=cfg.n_mels)
    vocab = [f"t{i}" for i in range(cfg.vocab_size)]
    sched = ServingCohorts(tp, cfg, vocab, TCC(**kw), n_slots=2, n_cohorts=2,
                           compute_dtype=F32, dsp=dsp)
    jsched = JCohorts(jp, cfg, vocab, JCC(**kw), n_slots=2, n_cohorts=2,
                      compute_dtype=jnp.float32, dsp=dsp)
    assert_weights_shared(sched.engines)
    if dsp == "device":
        e0, e1 = sched.engines
        assert e0.mel_buf_dev.data_ptr() != e1.mel_buf_dev.data_ptr()
        assert e0.front_res.data_ptr() != e1.front_res.data_ptr()

    ids = [(sched.add_stream(cohort=c), jsched.add_stream(cohort=c))
           for c in (0, 0, 1)]
    assert all(a == b for a, b in ids)
    a, b, c = (i for i, _ in ids)
    feeds = {a: [_audio(s) for s in range(10, 14)],
             b: [_audio(s) for s in range(20, 22)],
             c: [_audio(s) for s in range(30, 33)]}
    fed = {k: 0 for k in feeds}
    for r in range(4):
        batch = {}
        for gid in (a, b):
            if fed[gid] < len(feeds[gid]) and (gid != b or r % 2 == 0):
                batch[gid] = feeds[gid][fed[gid]]
                fed[gid] += 1
        for s in (sched, jsched):
            s.feed_audio(batch)
        assert sched.step(0) == jsched.step(0), r
        if fed[c] < len(feeds[c]):
            for s in (sched, jsched):
                s.feed_audio({c: feeds[c][fed[c]]})
            fed[c] += 1
        assert sched.step(1) == jsched.step(1), r
    assert all(fed[k] == len(v) for k, v in feeds.items())
    assert sched.transcripts == jsched.transcripts
    assert sched.tokens == jsched.tokens
    assert any(sched.transcripts.values())

    for gid in (a, b, c):
        solo = TEngine(tp, cfg, vocab, TCC(**kw), n_slots=1,
                       compute_dtype=F32, dsp=dsp)
        s = solo.add_stream()
        for chunk in feeds[gid]:
            solo.feed_audio({s: chunk})
            solo.step()
        assert sched.transcripts[gid] == solo.transcripts[s], gid
        assert sched.tokens[gid] == solo.tokens[s], gid
    st = sched.stats()
    assert st["active_slots"] == 3 and st["n_cohorts"] == 2
    assert st["engine_steps"] == jsched.stats()["engine_steps"]


def test_serving_cohorts_assign_phases(tiny):
    """tests/test_serving_cohorts.py:75-86."""
    _jp, tp, cfg, _ = tiny
    cc = TCC(att_right_context=1, n_mels=cfg.n_mels)
    sched = ServingCohorts(tp, cfg, None, cc, n_slots=1, n_cohorts=3,
                           compute_dtype=F32)
    period = cc.chunk_samples / cc.sample_rate
    assert {sched.assign(f * period) for f in (0.01, 0.34, 0.67)} == \
        {0, 1, 2}
    assert sched.assign(0.0) == 0
    assert sched.add_stream(arrival_s=0.34 * period) == sched.stream_id(2, 0)
    with pytest.raises(ValueError, match="n_cohorts"):
        ServingCohorts(tp, cfg, None, cc, n_slots=1, n_cohorts=0)


def test_serving_cohorts_remove_and_reuse(tiny):
    """tests/test_serving_cohorts.py:89-101: a removed stream's slot is
    free again; least-loaded admission takes slot 0 of either cohort."""
    _jp, tp, cfg, _ = tiny
    cc = TCC(att_right_context=1, n_mels=cfg.n_mels)
    vocab = [f"t{i}" for i in range(cfg.vocab_size)]
    sched = ServingCohorts(tp, cfg, vocab, cc, n_slots=1, n_cohorts=2,
                           compute_dtype=F32)
    x = sched.add_stream(cohort=1)
    assert x == sched.n_slots
    sched.feed_audio({x: _audio(5, 6000)})
    sched.step(1)
    text = sched.remove_stream(x)
    assert isinstance(text, str)
    assert sched.stats()["active_slots"] == 0 and sched.transcripts == {}
    y = sched.add_stream()
    assert y in (0, sched.n_slots)
    z = sched.add_stream()
    assert {y, z} == {0, sched.n_slots}
    with pytest.raises(RuntimeError, match="no free"):
        sched.add_stream(cohort=0)


# -- the serve entry point -------------------------------------------------------


@pytest.fixture(scope="module")
def serve_files(tmp_path_factory):
    """A tiny random GGUF (joint bias on token 5, so text is emitted) and
    1.5 s of seeded PCM."""
    from conftest import tiny_config, write_tiny_gguf

    from nemotron_tpu import params as P

    d = tmp_path_factory.mktemp("serve")
    cfg = tiny_config()
    arrays = P.random_weight_arrays(cfg, seed=0)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    gguf_path = str(d / "t.gguf")
    write_tiny_gguf(gguf_path, arrays, cfg)
    pcm = synth(24000, 0)
    audio = str(d / "s.pcm")
    pcm.astype("<i2").tofile(audio)
    return gguf_path, audio, pcm


def run_serve(*args):
    return subprocess.run(
        [sys.executable, "-m", "nemotron_tpu_torch.serve", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def direct_slot_lines(gguf_path, pcm, lockstep, n_streams=2, R=1,
                      seconds=2.0, dsp="auto"):
    """The `[slot s]` lines of the same run, driving the port's engine
    directly with serve's staggered blocks (bf16, as serve runs; `dsp`
    the ragged engine's)."""
    params, cfg, vocab = load_model(gguf_path, device="cpu")
    cc = TCC(att_right_context=R, n_mels=cfg.n_mels)
    q = cc.shift_samples
    offsets = [(i * len(pcm)) // n_streams for i in range(n_streams)]

    def block(i):
        blk = np.resize(np.roll(pcm, -(offsets[i] % len(pcm)))[:q], q)
        offsets[i] += q
        return blk

    n_ticks = int(seconds * 16000 / q)
    if lockstep:
        eng = TLock(params, cfg, vocab, cc, n_streams=n_streams)
        for _ in range(n_ticks):
            eng.tick_pipelined(np.stack([block(i) for i in range(n_streams)]))
        eng.flush_pipeline()
        slots = range(n_streams)
    else:
        eng = TEngine(params, cfg, vocab, cc, n_slots=max(8, n_streams),
                      dsp=dsp)
        slots = eng.add_streams(n_streams)
        for _ in range(n_ticks):
            eng.feed_audio({s: block(i) for i, s in enumerate(slots)})
            eng.step()
    return [f"[slot {s}] {eng.transcripts[s][:70]}" for s in list(slots)[:3]]


@pytest.mark.parametrize("lockstep", [True, False])
def test_serve_entry_point_matches_direct_engine(serve_files, lockstep):
    """tests/test_serving.py:734-757 on the port: `python -m
    nemotron_tpu_torch.serve --cpu` (with and without --lockstep) exits 0,
    prints the summary with "aggregate real-time" and the tick
    percentiles, and its `[slot s]` lines equal the engine driven directly
    with the same blocks."""
    gguf_path, audio, pcm = serve_files
    r = run_serve(gguf_path, audio, "--streams", "2", "--right-context",
                  "1", "--seconds", "2", "--cpu",
                  *(["--lockstep"] if lockstep else []))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "aggregate real-time" in r.stderr
    assert "per-tick latency p50" in r.stderr and "p99" in r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[slot ")]
    assert lines == direct_slot_lines(gguf_path, pcm, lockstep)
    assert len(lines) == 2 and "t5" in lines[0]


@pytest.mark.parametrize("flags,slice_name", [
    (["--ctc"], "TDT/CTC"),
    (["--mesh", "2"], "multi-GPU"), (["--coordinator", "h:1"], "multi-GPU"),
    (["--dsp", "native"], "native-bindings")])
def test_serve_refuses_later_slices(serve_files, flags, slice_name, capsys):
    """Each flag of a later slice exits 1 naming the slice (run in process:
    the refusal comes before anything loads). The TDT/CTC slice's --ctc is
    ported: on a model without a CTC head the engine refuses it with the
    JAX package's error (tests/test_torch_ctc.py drives it on a hybrid
    model). The multi-GPU slice's --mesh and --coordinator are ported
    (tests/test_torch_multihost.py runs them): here their refusals before
    anything starts -- streams not divisible by the ranks, and a
    one-process multihost world. The native-bindings slice's --dsp native
    is ported: the ragged engine serves with the C++ frontend, its
    `[slot s]` lines those of the native engine driven directly."""
    from nemotron_tpu_torch import serve

    gguf_path, audio, pcm = serve_files
    if slice_name == "native-bindings":
        assert serve.main(["serve", gguf_path, audio, "--cpu", "--streams",
                           "2", "--right-context", "1", "--seconds", "2",
                           *flags]) == 0
        out, err = capsys.readouterr()
        assert "slice" not in err and "aggregate real-time" in err
        lines = [ln for ln in out.splitlines() if ln.startswith("[slot ")]
        assert lines == direct_slot_lines(gguf_path, pcm, False, dsp="native")
        return
    extra = {"--mesh": ["--streams", "3"],
             "--coordinator": ["--num-processes", "1"]}.get(flags[0], [])
    assert serve.main(["serve", gguf_path, audio, "--cpu", "--lockstep",
                       *flags, *extra]) == 1
    err = capsys.readouterr().err
    if slice_name == "TDT/CTC":
        assert "ctc=True needs a model with a CTC head" in err
        assert "slice" not in err
        return
    if slice_name == "multi-GPU":
        assert "slice" not in err
        assert ("divisible by the ranks" if flags[0] == "--mesh"
                else "two or more ranks") in err
        return
    assert slice_name in err and flags[0] in err


def test_serve_module_exits_1_on_a_later_flag(serve_files):
    """The module's exit status, not only main's return value (no flag
    names a later slice any more: --mesh 2 over 3 lockstep streams is
    refused before anything starts)."""
    gguf_path, audio, _ = serve_files
    r = run_serve(gguf_path, audio, "--cpu", "--lockstep", "--mesh", "2",
                  "--streams", "3")
    assert r.returncode == 1
    assert "divisible by the ranks" in r.stderr and not r.stdout


def test_serve_rejects_bad_arguments(serve_files, capsys):
    from nemotron_tpu_torch import serve

    gguf_path, audio, _ = serve_files
    assert serve.main(["serve", gguf_path]) == 1
    assert serve.main(["serve", gguf_path, audio, "--cpu", "--bogus"]) == 1
    assert "unsupported flag --bogus" in capsys.readouterr().err
    assert serve.main(["serve", gguf_path, audio, "--cpu", "--streams"]) == 1
    assert serve.main(["serve", gguf_path, audio + ".missing", "--cpu"]) == 1
    assert "not found" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["serve", gguf_path, audio, "--cpu", "--streams", "x"])


# -- on the card ---------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def tiny_port_model(device):
    """The JAX tests' tiny config with the port's seeded random weights."""
    cfg = ModelConfig(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                      n_layers=3, kernel_size=9, vocab_size=41,
                      decoder_dim=48, joint_dim=56, subsampling_channels=16)
    arrays = random_weight_arrays(cfg, seed=0)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    return params_from_arrays(arrays, cfg, device), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tiny", "tones"])
def test_cohorts_on_card_equal_cpu(cuda_device, model):
    """Both cohort kinds (2 cohorts, f32, R = 6) on the card and on the
    CPU: the same text every tick and the same finals; the cohorts share
    the weights on the card too."""
    out = {}
    for dev in ("cpu", "cuda"):
        if model == "tiny":
            params, cfg = tiny_port_model(dev)
            vocab = [f"w{i} " for i in range(cfg.vocab_size)]
        else:
            params, cfg, vocab = load_model(FIXTURE, device=dev)
        cc = TCC(att_right_context=6, n_mels=cfg.n_mels)
        n = cc.shift_samples
        audio, _ = ttones.make_eval_streams(4, 4.0, 16, seed=9)
        lock = CohortScheduler(params, cfg, vocab, cc, n_streams=2,
                               n_cohorts=2, compute_dtype=F32)
        ragged = ServingCohorts(params, cfg, vocab, cc, n_slots=2,
                                n_cohorts=2, compute_dtype=F32, dsp="device")
        assert_weights_shared(lock.engines)
        assert_weights_shared(ragged.engines)
        gids = [ragged.add_stream(cohort=c) for c in (0, 0, 1, 1)]
        texts = []
        for t in range(audio.shape[1] // n):
            for c in range(2):
                texts.append(lock.tick(c, audio[2 * c:2 * c + 2,
                                                t * n:(t + 1) * n]))
                ragged.feed_audio({g: audio[i, t * n:(t + 1) * n]
                                   for i, g in enumerate(gids)
                                   if ragged.locate(g)[0] == c})
                texts.append(ragged.step(c))
        out[dev] = (texts, lock.finalize(), ragged.tokens)
    assert out["cuda"] == out["cpu"]
    assert any(out["cpu"][1])
