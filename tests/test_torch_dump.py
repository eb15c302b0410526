"""Dump tracing, PyTorch port against the JAX package on the CPU: the
binary dump format byte for byte (headers, leading singleton dims,
appends), read_dump both ways, compare's statistics, the encoder's
capture (tokens and every state leaf bit-equal to the step without it,
dense K/V rings and the shared x-ring, its intermediates against JAX's),
a traced session against the JAX traced session dump by dump, and the
JAX package's refusals of tracing."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models import encoder as jenc
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.utils import dump as jdump
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.models import encoder as tenc
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.streaming import session as tsession
from nemotron_tpu_torch.streaming.session import StreamSession as TSession
from nemotron_tpu_torch.utils import dump as tdump
from nemotron_tpu_torch.utils import tones as ttones

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
# the JAX package's tolerance for streaming chunk outputs (ROADMAP)
ATOL = 5e-5
TRACE_NAMES = ("mel", "pre_encode_out", "encoder_out", "tokens")


def jax_flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def tiny(model_setup):
    _arrays, jp, cfg = model_setup
    return jp, params_from_jax_arrays(jax_flat(jp), cfg, device="cpu"), cfg


# -- the format -----------------------------------------------------------------


@pytest.mark.parametrize("shapes", [
    [(7,)], [(3, 5)], [(2, 3, 4)], [(2, 3, 4, 5)], [(1, 4, 6)],
    [(1, 1, 2, 3)], [(1,)], [(4, 6), (2, 6), (3, 6)],
    [(1, 14, 8), (1, 14, 8), (1, 14, 8)], [(3,), (5,)],
    [(2, 2, 3), (4, 2, 3)]], ids=lambda s: "+".join(
        "x".join(map(str, t)) for t in s))
def test_dump_bytes_equal_jax(tmp_path, shapes):
    """The same arrays appended in the same order make byte-identical
    files in both packages (32-byte reversed-shape header, f32 payload,
    leading singleton dims stripped, appends growing the leading axis)."""
    rng = np.random.default_rng(len(shapes) * 10 + len(shapes[0]))
    got, want = tmp_path / "port.bin", tmp_path / "jax.bin"
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float64)
        tdump.append_dump(str(got), a)
        jdump.append_dump(str(want), a)
    assert got.read_bytes() == want.read_bytes()
    np.testing.assert_array_equal(tdump.read_dump(str(got)),
                                  jdump.read_dump(str(want)))


def test_dump_refuses_what_jax_refuses(tmp_path):
    """More than 4 dims and an append of another trailing shape raise the
    JAX package's ValueErrors; a file that is not whole records does too."""
    for mod, name in ((tdump, "p"), (jdump, "j")):
        with pytest.raises(ValueError, match="<=4 dims"):
            mod.append_dump(str(tmp_path / f"{name}5.bin"),
                            np.zeros((2, 2, 2, 2, 2)))
        path = str(tmp_path / f"{name}.bin")
        mod.append_dump(path, np.zeros((2, 3)))
        with pytest.raises(ValueError, match="incompatible"):
            mod.append_dump(path, np.zeros((2, 4)))
    bad = tmp_path / "bad.bin"
    bad.write_bytes((tmp_path / "p.bin").read_bytes() + b"\0" * 4)
    with pytest.raises(ValueError, match="not divisible"):
        tdump.read_dump(str(bad))


def test_read_dump_round_trips_both_ways(tmp_path):
    """Each package reads the other's files; the tracer writes tensors
    (bf16 upcast) as the JAX tracer writes arrays."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 14, 8)).astype(np.float32)
    tdump.append_dump(str(tmp_path / "p.bin"), a)
    jdump.append_dump(str(tmp_path / "j.bin"), a)
    for path in ("p.bin", "j.bin"):
        for mod in (tdump, jdump):
            np.testing.assert_array_equal(mod.read_dump(str(tmp_path / path)),
                                          a)
    tt, jt = tdump.DumpTracer(str(tmp_path / "t")), \
        jdump.DumpTracer(str(tmp_path / "jt"))
    x = torch.from_numpy(a).to(torch.bfloat16)
    tt("x", x)
    jt("x", jnp.asarray(a, jnp.bfloat16))
    assert (tmp_path / "t" / "x.bin").read_bytes() == \
        (tmp_path / "jt" / "x.bin").read_bytes()
    np.testing.assert_array_equal(tdump.read_dump(str(tmp_path / "t/x.bin")),
                                  x.float().numpy().reshape(3, 14, 8))


@pytest.mark.parametrize("case", ["noise", "equal", "scaled", "ragged",
                                  "constant", "single", "zeros"])
def test_compare_matches_jax(case):
    """compare's statistics within 1e-12 of the JAX package's."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(500)
    b = {"noise": a + 1e-3 * rng.standard_normal(500), "equal": a.copy(),
         "scaled": 2 * a, "ragged": a[:321] + 1e-4,
         "constant": np.full(500, 3.0), "single": a[:1] + 1.0,
         "zeros": np.zeros(500)}[case]
    if case == "zeros":
        a = np.zeros(500)
    got, want = tdump.compare(a, b), jdump.compare(a, b)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


# -- the captured step ----------------------------------------------------------


@pytest.mark.parametrize("ring", ["dense", "shared", "int8"])
def test_capture_leaves_tokens_and_state_bit_equal(tiny, ring):
    """encode_chunk(capture=True) and the captured chunk step give the
    output, the tokens and every state leaf of the step without capture
    bit for bit, over enough chunks to wrap the ring; the intermediates
    are the encoder output and each layer's output, within 5e-5 of the
    JAX package's capture."""
    jp, tp, cfg = tiny
    extra = {"dense": {}, "shared": {"shared_cache": True},
             "int8": {"kv_cache_int8": True}}[ring]
    kw = dict(att_right_context=1, att_left_context=12, n_mels=cfg.n_mels,
              **extra)
    tcc, jcc = TCC(**kw), JCC(**kw)
    B = 2
    st = [tenc.init_encoder_state(cfg, tcc, B, torch.float32, "cpu")
          for _ in range(2)]
    dec = [tdec.init_decoder_state(cfg, B, torch.float32, "cpu")
           for _ in range(2)]
    jst = jenc.init_encoder_state(cfg, jcc, B)
    tph = tenc.precompute_pos_heads(tp, cfg, tcc)
    jph = jenc.precompute_pos_heads(jp, cfg, jcc)
    jstep = jax.jit(lambda p, m, s, ph: jenc.encode_chunk(
        p, cfg, jcc, m, s, ph, capture=True))
    rng = np.random.default_rng(5)
    n_seg = tcc.kv_len // tcc.chunk_enc_len
    for ci in range(n_seg + 2):
        mel = torch.from_numpy(rng.standard_normal(
            (B, tcc.chunk_mel_frames, cfg.n_mels)).astype(np.float32))
        tok0, st[0], dec[0] = tsession.chunk_step(tp, cfg, tcc, mel, st[0],
                                                  dec[0], tph)
        tok1, st[1], dec[1], inter = tsession.chunk_step_captured(
            tp, cfg, tcc, mel, st[1], dec[1], tph)
        assert torch.equal(tok0, tok1), ci
        for a, b in ((st[0], st[1]), (dec[0], dec[1])):
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                    (ci, f.name)
        assert tuple(inter["layer_out"].shape) == (
            cfg.n_layers, B, tcc.chunk_enc_len, cfg.d_model)
        np.testing.assert_array_equal(
            inter["encoder_out"].numpy(),
            inter["layer_out"][-1, :, :tcc.valid_out_len].numpy())
        _, jst, jinter = jstep(jp, jnp.asarray(mel.numpy()), jst, jph)
        for k in ("pre_encode_out", "layer_out", "encoder_out"):
            np.testing.assert_allclose(inter[k].numpy(),
                                       np.asarray(jinter[k]), atol=ATOL,
                                       err_msg=f"chunk {ci} {k}")


# -- the traced session -----------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_models():
    return jload_model(FIXTURE), tload_model(FIXTURE, device="cpu")


@pytest.mark.parametrize("R,S", [(13, 1), (1, 2)])
def test_traced_session_matches_jax(fixture_models, tmp_path, R, S):
    """A traced session on the trained fixture (with the JAX session's
    native frontend) writes the JAX traced session's files under the same
    names, every dump within 5e-5 of JAX's (tokens exact), and its
    transcripts and tokens equal both JAX's and its own untraced run's."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    audio, _ = ttones.make_eval_streams(S, 4.0, 16, seed=20 + R)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsess = JSession(jp, jc, jv, JCC(att_right_context=R, n_mels=jc.n_mels),
                     n_streams=S, trace_dir=jdir)
    # the JAX session's frontend: its native DSP ("auto")
    tsess = TSession(tp, tc, tv, TCC(att_right_context=R, n_mels=tc.n_mels),
                     n_streams=S, trace_dir=tdir, frontend="native")
    plain = TSession(tp, tc, tv, TCC(att_right_context=R, n_mels=tc.n_mels),
                     n_streams=S, frontend="native")
    for piece in np.array_split(audio, 3, axis=1):
        assert tsess.process(piece) == jsess.process(piece) == \
            plain.process(piece)
    assert tsess.finalize() == jsess.finalize() == plain.finalize()
    for s in range(S):
        assert tsess.get_tokens(s) == jsess.get_tokens(s) == \
            plain.get_tokens(s)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert names == sorted([f"{n}.bin" for n in TRACE_NAMES]
                           + [f"layer_{l:02d}_out.bin"
                              for l in range(tc.n_layers)])
    for name in names:
        got = tdump.read_dump(os.path.join(tdir, name))
        want = jdump.read_dump(os.path.join(jdir, name))
        assert got.shape == want.shape, name
        if name == "tokens.bin":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
    # a record of S streams grows the leading axis by S, one stream's
    # [1, T, D] (leading 1 stripped) by T
    T = TCC(att_right_context=R, n_mels=tc.n_mels).valid_out_len
    enc = tdump.read_dump(os.path.join(tdir, "encoder_out.bin"))
    assert enc.shape[0] == tsess.total_chunks * (S if S > 1 else T)


@pytest.mark.parametrize("kw", [
    {"beam_size": 4}, {"confidence": True}, {"confidence_words": True},
    {"beam_size": 4, "timestamp_words": True}], ids=lambda k: "+".join(k))
def test_tracing_refusals_match_jax(fixture_models, tmp_path, kw):
    """Tracing with a beam or with confidence raises the JAX package's
    ValueError, in JAX's order (a beam with word timestamps names the
    timestamps first); no trace directory is made (TDT and CTC:
    tests/test_torch_tdt.py, tests/test_torch_ctc.py)."""
    (jp, jc, jv), (tp, tc, tv) = fixture_models
    with pytest.raises(ValueError) as want:
        JSession(jp, jc, jv, trace_dir=str(tmp_path / "j"), **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        TSession(tp, tc, tv, trace_dir=str(tmp_path / "p"), **kw)
    assert not (tmp_path / "p").exists()


def test_cli_trace_matches_jax_cli(tmp_path):
    """`cli --trace=DIR --cpu` writes the JAX CLI's dump files: the same
    names and shapes, the tokens exact, the mel within the log-mel
    tolerance (the port's session computes it with torch's FFT, JAX's
    with its native frontend), and the JAX CLI's stdout."""
    import subprocess
    import sys

    audio, _ = ttones.make_eval_streams(1, 3.0, 16, seed=9)
    pcm = tmp_path / "a.pcm"
    audio[0].astype("<i2").tofile(pcm)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = {}
    for name, cmd in (
            ("jax", [os.path.join(REPO, "cli", "transcribe_stream.py")]),
            ("port", ["-m", "nemotron_tpu_torch.cli"])):
        d = tmp_path / name
        r = subprocess.run([sys.executable, *cmd, FIXTURE, str(pcm), "80",
                            "6", "--cpu", f"--trace={d}"],
                           capture_output=True, text=True, timeout=300,
                           env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr
        out[name] = (r.stdout, {f: tdump.read_dump(str(d / f))
                                for f in os.listdir(d)})
    (jout, jd), (tout, td) = out["jax"], out["port"]
    assert tout == jout and len(tout.strip()) > 5
    assert sorted(td) == sorted(jd) and len(td) == 4 + 4
    for name, want in jd.items():
        assert td[name].shape == want.shape, name
    np.testing.assert_array_equal(td["tokens.bin"], jd["tokens.bin"])
    np.testing.assert_allclose(td["mel.bin"], jd["mel.bin"], atol=2e-4)
