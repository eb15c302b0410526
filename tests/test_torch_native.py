"""The native bindings, PyTorch port against the JAX package on the CPU:
the port's NativeFrontend bit-equal to JAX's binding (whole, chunked,
multi-stream with per-stream reset, ragged, slot state round trips) and
within the log-mel tolerance of the port's numpy backend;
StreamingPreprocessor(backend=) and its snapshots; NativeGGUF's views
against the plain reader's bytes, load_model with and without it; the
builder (a changed source is rebuilt, a failed build raises, native/ is
never written); and ServingEngine(dsp="native") against JAX's native
engine, through snapshots both ways, its refusal when the library
cannot be built, and `asr_server --dsp native` serving clients."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_serving import (assert_states_close, counts, engines,
                                jax_flat, synth)

from nemotron_tpu.frontend import native as jnative
from nemotron_tpu_torch import gguf as tgguf
from nemotron_tpu_torch import gguf_native, native_build
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.config import PreprocessorConfig
from nemotron_tpu_torch.frontend import native as tnative
from nemotron_tpu_torch.frontend.preprocessor import (StreamingPreprocessor,
                                                      pad_window)
from nemotron_tpu_torch.params import load_model, params_from_jax_arrays
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
MEL_ATOL = 2e-4          # the JAX package's log-mel tolerance


@pytest.fixture(scope="module")
def tiny(model_setup):
    _arrays, jp, cfg = model_setup
    tp = params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg, [f"w{i}" for i in range(cfg.vocab_size)]


@pytest.fixture(scope="module")
def dsp_inputs():
    """(filterbank, padded window, PreprocessorConfig) of the trained
    fixture."""
    p, cfg, _ = load_model(FIXTURE, device="cpu")
    pcfg = PreprocessorConfig(n_mels=cfg.n_mels)
    fb = p.preprocessor.filterbank.numpy()
    win = p.preprocessor.window.numpy()
    return fb, win, pcfg


def frontends(dsp_inputs, n_streams):
    """The port's and JAX's NativeFrontend over the same filterbank."""
    fb, win, pcfg = dsp_inputs
    kw = dict(n_streams=n_streams, n_fft=pcfg.n_fft,
              hop=pcfg.n_window_stride, n_mels=pcfg.n_mels,
              preemph=pcfg.preemph, log_zero_guard=pcfg.log_zero_guard)
    wp = pad_window(win, pcfg.n_fft)
    return tnative.NativeFrontend(fb, wp, **kw), \
        jnative.NativeFrontend(fb, wp, **kw)


# -- the frontend ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("S", [1, 3])
def test_native_frontend_bit_equal_to_jax(dsp_inputs, mode, S):
    """process over the whole signal, or ragged chunks of it (0, 1, 159,
    160 and 401 samples among them), gives JAX's binding's mel bit for
    bit, and the same frame counts and state."""
    t, j = frontends(dsp_inputs, S)
    audio = np.stack([synth(24000, 7 + s) for s in range(S)])
    cuts = ([0, 24000] if mode == "whole" else
            [0, 0, 1, 160, 160, 319, 720, 1121, 3000, 9000, 24000])
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        assert t.n_frames_for(hi - lo) == j.n_frames_for(hi - lo)
        got, want = t.process(audio[:, lo:hi]), j.process(audio[:, lo:hi])
        np.testing.assert_array_equal(got, want)
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[k], v, err_msg=k)


def test_native_frontend_stream_reset_bit_equal_to_jax(dsp_inputs):
    """Three streams, one reset mid-way (and then all): JAX's mel bit for
    bit."""
    t, j = frontends(dsp_inputs, 3)
    audio = np.stack([synth(12000, 30 + s) for s in range(3)])
    for i, (lo, hi) in enumerate(((0, 3000), (3000, 7001), (7001, 12000))):
        if i == 1:
            t.reset(1)
            j.reset(1)
        if i == 2:
            t.reset()
            j.reset()
        np.testing.assert_array_equal(t.process(audio[:, lo:hi]),
                                      j.process(audio[:, lo:hi]))


def test_native_frontend_ragged_and_slot_state_bit_equal_to_jax(dsp_inputs):
    """process_ragged over changing subsets of 4 slots at their own sample
    counts, reset_fresh of a slot, and slot states saved and loaded into
    fresh frontends: JAX's mel, frame counts and slot states bit for
    bit."""
    t, j = frontends(dsp_inputs, 4)
    rng = np.random.default_rng(9)
    for tick in range(8):
        slots = [s for s in range(4) if (tick + s) % 3 != 0]
        feed = {s: synth(int(rng.integers(0, 3000)), 100 * tick + s)
                for s in slots}
        if tick == 4:
            t.reset_fresh(2)
            j.reset_fresh(2)
        for s, a in feed.items():
            assert t.n_frames_for_slot(s, a.size) == \
                j.n_frames_for_slot(s, a.size)
        got, want = t.process_ragged(feed), j.process_ragged(feed)
        assert got.keys() == want.keys()
        for s in want:
            np.testing.assert_array_equal(got[s], want[s])
    t2, j2 = frontends(dsp_inputs, 4)
    for s in range(4):
        st = t.slot_state_dict(s)
        for k, v in j.slot_state_dict(s).items():
            np.testing.assert_array_equal(st[k], v, err_msg=k)
        t2.load_slot_state_dict(s, st)
        j2.load_slot_state_dict(s, j.slot_state_dict(s))
    feed = {s: synth(2500 + s, 900 + s) for s in range(4)}
    want = t.process_ragged(feed)
    for got in (t2.process_ragged(feed), j2.process_ragged(feed)):
        for s in want:
            np.testing.assert_array_equal(got[s], want[s])


@pytest.mark.parametrize("S", [1, 2])
def test_native_backend_within_tolerance_of_numpy(dsp_inputs, S):
    """StreamingPreprocessor's native backend (the C++ radix-2 FFT) within
    2e-4 of its numpy backend (torch's FFT), chunk by chunk, and their
    frame counts and states equal."""
    fb, win, pcfg = dsp_inputs
    nat = StreamingPreprocessor(fb, win, S, pcfg, device="cpu",
                                backend="native")
    num = StreamingPreprocessor(fb, win, S, pcfg, device="cpu",
                                backend="numpy")
    assert (nat.backend, num.backend) == ("native", "numpy")
    audio = np.stack([synth(20000, 50 + s) for s in range(S)])
    for lo, hi in ((0, 1000), (1000, 1001), (1001, 8000), (8000, 20000)):
        assert nat.n_frames_for(hi - lo) == num.n_frames_for(hi - lo)
        a = audio[:, lo:hi]
        np.testing.assert_allclose(nat.process(a), num.process(a),
                                   atol=MEL_ATOL, rtol=0)
    for k, v in num.state_dict().items():
        np.testing.assert_allclose(nat.state_dict()[k], v, atol=1e-6)


@pytest.mark.parametrize("src,dst", [("native", "native"),
                                     ("native", "numpy"),
                                     ("numpy", "native")])
def test_preprocessor_snapshot_round_trips_across_backends(dsp_inputs, src,
                                                           dst):
    """A state_dict taken from one backend and loaded into a fresh one of
    either backend continues the stream: bit-equal to the uninterrupted
    run on the same backend, within 2e-4 across backends."""
    fb, win, pcfg = dsp_inputs
    audio = np.stack([synth(16000, 60 + s) for s in range(2)])
    a = StreamingPreprocessor(fb, win, 2, pcfg, device="cpu", backend=src)
    a.process(audio[:, :7777])
    b = StreamingPreprocessor(fb, win, 2, pcfg, device="cpu", backend=dst)
    b.load_state_dict(a.state_dict())
    ref = StreamingPreprocessor(fb, win, 2, pcfg, device="cpu", backend=dst)
    ref.process(audio[:, :7777])
    got, want = b.process(audio[:, 7777:]), ref.process(audio[:, 7777:])
    if src == dst:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)


def test_backend_resolution_and_refusals(dsp_inputs, monkeypatch):
    """"auto" is native on the CPU when the library loads, else numpy;
    a CUDA device takes numpy (the FFT on the card); frame_only needs the
    numpy backend; an unknown backend raises; backend="native" raises
    when the library cannot be built, "auto" then falls back."""
    from nemotron_tpu_torch.frontend import preprocessor as tpre

    fb, win, pcfg = dsp_inputs
    auto = StreamingPreprocessor(fb, win, cfg=pcfg, device="cpu",
                                 backend="auto")
    assert auto.backend == "native"
    assert StreamingPreprocessor(fb, win, cfg=pcfg,
                                 device="cpu").backend == "numpy"
    assert tpre.resolve_backend("auto", torch.device("cuda")) == "numpy"
    with pytest.raises(ValueError, match="numpy backend"):
        auto.frame_only(synth(1000, 1))
    with pytest.raises(ValueError, match="backend"):
        StreamingPreprocessor(fb, win, cfg=pcfg, device="cpu",
                              backend="scipy")
    broken(monkeypatch)
    with pytest.raises(RuntimeError, match="unavailable"):
        StreamingPreprocessor(fb, win, cfg=pcfg, device="cpu",
                              backend="native")
    assert StreamingPreprocessor(fb, win, cfg=pcfg, device="cpu",
                                 backend="auto").backend == "numpy"


def broken(monkeypatch):
    """Make the native libraries unbuildable in this process: a compiler
    that does not exist, and nothing loaded or built yet."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(gguf_native, "_lib", None)
    monkeypatch.setattr(native_build, "_loaded", {})
    # the compiler is part of the library's hash: nothing built matches
    monkeypatch.setenv("CXX", "/nonexistent/g++")


# -- the GGUF loader -------------------------------------------------------------


@pytest.fixture(scope="module")
def q8_gguf(tmp_path_factory, model_setup):
    from conftest import write_tiny_gguf

    from nemotron_tpu import gguf
    from nemotron_tpu.ops import quant

    arrays, _, cfg = model_setup
    path = str(tmp_path_factory.mktemp("native") / "tiny_q8.gguf")
    qn = {n: gguf.GGML_Q8_0 for n in arrays
          if quant.should_quantize(n, arrays[n] if arrays[n].ndim != 3
                                   else arrays[n].squeeze())}
    write_tiny_gguf(path, arrays, cfg, quantize=qn)
    return path


@pytest.mark.parametrize("which", ["fixture", "q8"])
def test_native_gguf_views_equal_plain_reader(q8_gguf, which):
    """NativeGGUF's tensor table and zero-copy views hold the plain
    reader's names, types, shapes and bytes; read_gguf serves them
    read-only, and its metadata is the plain reader's."""
    path = FIXTURE if which == "fixture" else q8_gguf
    nat = tgguf.read_gguf(path, use_native=True)
    plain = tgguf.read_gguf(path, use_native=False)
    assert isinstance(nat._native, gguf_native.NativeGGUF)
    assert plain._native is None
    assert nat.metadata == plain.metadata
    assert list(nat.tensors) == list(plain.tensors)
    table = {n: (t, s) for n, t, s, _ in nat._native.tensors()}
    for name, want in plain.tensors.items():
        got = nat.tensors[name]
        assert (got.shape, got.ggml_type) == (want.shape, want.ggml_type)
        assert table[name] == (want.ggml_type, want.shape)
        assert not got.raw.flags.writeable
        assert got.raw.tobytes() == want.raw, name
        np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("which", ["fixture", "q8"])
def test_load_model_params_equal_with_and_without_native(q8_gguf, which):
    """load_model's parameters and config are identical with the native
    loader and without it (Q8_0 QTensors included)."""
    import dataclasses

    path = FIXTURE if which == "fixture" else q8_gguf
    a, ca, va = load_model(path, device="cpu", use_native=True)
    b, cb, vb = load_model(path, device="cpu", use_native=False)
    assert ca == cb and va == vb
    n = 0
    for group in ("subsampling", "layers", "decoder", "joint",
                  "preprocessor"):
        ga, gb = getattr(a, group), getattr(b, group)
        for f in dataclasses.fields(ga):
            x, y = getattr(ga, f.name), getattr(gb, f.name)
            pairs = ([(x.q, y.q), (x.scale, y.scale)] if hasattr(x, "q")
                     else [(x, y)])
            for u, v in pairs:
                if isinstance(u, torch.Tensor):
                    assert u.dtype == v.dtype and torch.equal(u, v), f.name
                    n += 1
    assert n > 40


def test_read_gguf_native_refusals(tmp_path, monkeypatch):
    """use_native=True raises on a file the loader refuses, "auto" then
    reads with the plain reader's error; without a library, True raises
    and "auto" reads plainly."""
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"NOPE" + b"\0" * 64)
    with pytest.raises(ValueError):
        tgguf.read_gguf(str(bad), use_native=True)
    with pytest.raises(ValueError, match="not a GGUF file"):
        tgguf.read_gguf(str(bad))
    broken(monkeypatch)
    assert not gguf_native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        tgguf.read_gguf(FIXTURE, use_native=True)
    assert tgguf.read_gguf(FIXTURE)._native is None


# -- the builder ------------------------------------------------------------------


def test_builder_rebuilds_on_a_changed_source(tmp_path):
    """The library name carries the source's hash: the same source is
    built once (a second build is the same file, untouched), an edited one
    builds anew beside it; the build leaves no temporary file and native/
    is not written."""
    before = {f: os.stat(os.path.join(native_build.NATIVE_DIR, f)).st_mtime_ns
              for f in os.listdir(native_build.NATIVE_DIR)}
    src = tmp_path / "frontend.cpp"
    src.write_bytes((native_build.NATIVE_DIR / "frontend.cpp").read_bytes())
    out = tmp_path / "build"
    first = native_build.build(src, "fe", out)
    stamp = first.stat().st_mtime_ns
    assert native_build.build(src, "fe", out) == first
    assert first.stat().st_mtime_ns == stamp
    src.write_text(src.read_text() + "\n// edited\n")
    second = native_build.build(src, "fe", out)
    assert second != first and second.exists() and first.exists()
    assert sorted(p.name for p in out.glob("*.so")) == sorted(
        [first.name, second.name])
    after = {f: os.stat(os.path.join(native_build.NATIVE_DIR, f)).st_mtime_ns
             for f in os.listdir(native_build.NATIVE_DIR)}
    assert after == before


def test_builder_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError carrying the
    compiler's diagnostics, and leaves no library; a missing compiler
    raises too."""
    src = tmp_path / "broken.cpp"
    src.write_text("int f() { return undefined_name; }\n")
    with pytest.raises(RuntimeError, match="undefined_name"):
        native_build.build(src, "broken", tmp_path / "b")
    assert not list((tmp_path / "b").glob("*.so"))
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    with pytest.raises(RuntimeError, match="building"):
        native_build.build(src, "broken", tmp_path / "b")


# -- the serving engine -----------------------------------------------------------


def test_native_engine_matches_jax_native_engine(tiny):
    """Ragged rates, a late admission fed partial chunks, an evicted slot
    reused and finalize, with one ragged C++ call a tick: every tick's new
    text, the counters, the device state and the finals equal JAX's
    engine with dsp="native"."""
    je, te = engines(tiny, 4, "native")
    assert te.dsp_mode == je.dsp_mode == "native"
    n = te.cc.shift_samples
    assert je.add_streams(2) == te.add_streams(2) == [0, 1]
    for tick in range(9):
        feed = {0: synth(n, tick)}
        if tick % 2 == 0:
            feed[1] = synth(n, 100 + tick)
        if tick == 3:
            assert je.add_stream() == te.add_stream() == 2
        if tick >= 3:
            feed[2] = synth(n // 2 + 37 * tick, 200 + tick)
        if tick == 5:
            assert je.remove_stream(1) == te.remove_stream(1)
            assert je.add_stream() == te.add_stream() == 1
        if tick >= 5:
            feed[1] = synth(n, 300 + tick)
        je.feed_audio(feed)
        te.feed_audio(feed)
        assert te.step() == je.step(), tick
    assert_states_close(je, te)
    assert counts(te.stats()) == counts(je.stats())
    for s in (2, 0, 1):
        got = te.finalize_stream(s, return_tokens=True)
        assert got == je.finalize_stream(s, return_tokens=True), s
        assert got[1], s


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_native_engine_snapshot_interchanges_with_jax(tiny, tmp_path,
                                                      direction):
    """A native engine's snapshot after 4 ticks (its slot DSP states from
    C++) resumes in a fresh native engine of the other package to the
    uninterrupted run's finals."""
    def run(eng, t0, t1):
        n = eng.cc.shift_samples
        for tick in range(t0, t1):
            eng.feed_audio({0: synth(n, tick),
                            1: synth(n // 3 + 11 * tick, 50 + tick)})
            eng.step()

    je, te = engines(tiny, 2, "native")
    want = engines(tiny, 2, "native")[1]
    for eng in (je, te, want):
        eng.add_streams(2)
    run(want, 0, 8)
    want = [want.finalize_stream(s, return_tokens=True) for s in (0, 1)]
    src, dst = (te, je) if direction == "port_to_jax" else (je, te)
    run(src, 0, 4)
    path = str(tmp_path / "snap.npz")
    src.save(path)
    dst.load(path)
    run(dst, 4, 8)
    assert [dst.finalize_stream(s, return_tokens=True)
            for s in (0, 1)] == want


def test_native_engine_refuses_without_the_library(tiny, monkeypatch):
    """dsp="native" raises when the library cannot be built (no quiet
    fallback); "auto" then resolves to "numpy"."""
    _jp, tp, cfg, vocab = tiny
    cc = TCC(att_right_context=1, n_mels=cfg.n_mels)
    broken(monkeypatch)
    with pytest.raises(RuntimeError, match="native frontend library "
                                           "unavailable"):
        TEngine(tp, cfg, vocab, cc, n_slots=2, dsp="native")
    assert TEngine(tp, cfg, vocab, cc, n_slots=2).dsp_mode == "numpy"


def test_asr_server_serves_with_native_dsp(tmp_path):
    """`python -m nemotron_tpu_torch.asr_server --dsp native --cpu`: a
    client's FINAL text is the native engine's transcript of the same
    audio driven in process; an unbuildable library exits 1."""
    from test_torch_server import start_asr_server

    from nemotron_tpu_torch.utils import tones as ttones

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    audio, _ = ttones.make_eval_streams(1, 3.0, 16, seed=81)
    pcm = tmp_path / "a.pcm"
    audio[0].astype("<i2").tofile(pcm)
    params, cfg, vocab = load_model(FIXTURE, device="cpu")
    eng = TEngine(params, cfg, vocab, TCC(att_right_context=13,
                                          n_mels=cfg.n_mels),
                  n_slots=1, dsp="native")
    slot = eng.add_stream()
    eng.feed_audio({slot: audio[0]})
    text = eng.finalize_stream(slot)
    assert text.strip()
    proc, ports = start_asr_server([FIXTURE, "--cpu", "--slots", "4",
                                    "--dsp", "native"], env)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "nemotron_tpu_torch.asr_client",
             f"127.0.0.1:{ports['tcp']}", str(pcm), "--rate", "max"],
            capture_output=True, timeout=120, env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr.decode()
        assert r.stdout.decode() == text + "\n"
    finally:
        proc.kill()
        proc.communicate(timeout=60)
    r = subprocess.run(
        [sys.executable, "-m", "nemotron_tpu_torch.asr_server", FIXTURE,
         "--cpu", "--dsp", "native", "--port", "0"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(env, CXX="/nonexistent/g++"))
    assert r.returncode == 1
    assert "native frontend library unavailable" in r.stderr
