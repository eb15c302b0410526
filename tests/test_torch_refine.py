"""Two-pass serving and the beam family's entry points, PyTorch port
against the JAX package on the CPU: `SegmentRefiner` (a ragged batch, LM
fusion and rescoring, and `drain` over an endpointing engine), the
ASRServer with a refiner (UTTERANCE events with "refined", the fallback
when the refiner fails) and with a beam engine (revisable PARTIALs), and
the beam, n-best, LM, rescoring and boost flags of the streaming and batch
CLIs (stdout equal to the JAX scripts'), of the server module and of the
serve module."""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu import params as jparams
from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models import lm as jlm
from nemotron_tpu.params import load_model as jload_model
from nemotron_tpu.streaming.refine import SegmentRefiner as JRefiner
from nemotron_tpu.streaming.serving import ServingEngine as JEngine
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models import lm as tlm
from nemotron_tpu_torch.params import load_model as tload_model
from nemotron_tpu_torch.params import params_from_jax_arrays
from nemotron_tpu_torch.server import ASRServer
from nemotron_tpu_torch.streaming.lockstep import LockstepEngine as TLock
from nemotron_tpu_torch.streaming.refine import SegmentRefiner as TRefiner
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.utils import tones as ttones
from test_torch_beam import jax_flat, peaked_arrays, synth
from test_torch_server import serve_and_collect, sil_audio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
SIL_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_sil.gguf")
LM_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_lm.gguf")
F32 = torch.float32
EP_KW = dict(n_slots=2, dsp="numpy", endpoint_silence_s=1.0,
             endpoint_reset=True, keep_segment_audio=True)


@pytest.fixture(scope="module")
def tiny(model_setup):
    arrays, _jp, cfg = model_setup
    jp = jparams.params_from_arrays(peaked_arrays(arrays), cfg)
    tp = params_from_jax_arrays(jax_flat(jp), cfg, device="cpu")
    return jp, tp, cfg, [f"w{i}" for i in range(cfg.vocab_size)]


@pytest.fixture(scope="module")
def sil():
    """The silence-robust fixture in both packages and the tones LM."""
    jp, cfg, vocab = jload_model(SIL_FIXTURE, keep_quantized=False)
    tp, tcfg, _ = tload_model(SIL_FIXTURE, device="cpu")
    return (jp, tp, cfg, vocab, jlm.load_lm(LM_FIXTURE),
            tlm.load_lm(LM_FIXTURE, device="cpu"))


@pytest.mark.parametrize("kw", [
    {"beam_size": 2}, {"beam_size": 3, "beam_expansions": 2},
    {"beam_size": 4, "lm": True, "lm_weight": 0.5, "lm_bonus": 0.2},
    {"beam_size": 4, "lm": True, "lm_weight": 0.8, "lm_rescore": True}])
def test_refine_matches_jax(tiny, kw):
    """Three ragged segments (one shorter than a window, padded to it) in
    one bucketed batch: the texts equal the JAX refiner's."""
    jp, tp, cfg, vocab = tiny
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("lm"):
        arrays = jlm.random_lm_arrays(cfg.vocab_size, hidden=16, seed=3,
                                      scale=0.6)
        jkw["lm"] = jlm.lm_params_from_arrays(arrays)
        tkw["lm"] = tlm.lm_params_from_arrays(arrays, device="cpu")
    segs = [synth(5000, 1), synth(300, 2), synth(12000, 3)]
    want = JRefiner(jp, cfg, vocab, compute_dtype=jnp.float32,
                    **jkw).refine(segs)
    got = TRefiner(tp, cfg, vocab, **tkw).refine(segs)
    assert got == want and len(got) == 3 and any(got)
    assert TRefiner(tp, cfg, vocab, beam_size=2).refine([]) == []
    with pytest.raises(ValueError, match="beam re-decode"):
        TRefiner(tp, cfg, vocab, beam_size=1)


def test_drain_matches_jax(sil):
    """Online greedy with endpointing on tones_tiny_sil.gguf segments two
    utterances; each package's refiner (K = 4 with the tones LM) re-decodes
    the captured segments to the same texts, and the port's online text
    and tokens equal the JAX engine's."""
    jp, tp, cfg, vocab, jl, tl = sil
    pcm = sil_audio()
    je = JEngine(jp, cfg, vocab, JCC(att_right_context=13, n_mels=cfg.n_mels),
                 compute_dtype=jnp.float32, **EP_KW)
    te = TEngine(tp, cfg, vocab, TCC(att_right_context=13, n_mels=cfg.n_mels),
                 compute_dtype=F32, **EP_KW)
    jr = JRefiner(jp, cfg, vocab, beam_size=4, lm=jl,
                  compute_dtype=jnp.float32)
    tr = TRefiner(tp, cfg, vocab, beam_size=4, lm=tl)
    events = []
    for eng, ref in ((je, jr), (te, tr)):
        s = eng.add_stream()
        got = []
        n = eng.cc.shift_samples
        for t in range(len(pcm) // n):
            eng.feed_audio({s: pcm[t * n:(t + 1) * n]})
            eng.step()
            got.extend(ref.drain(eng))
        events.append(got)
    assert len(events[1]) == len(events[0]) == 2
    for g, w in zip(*events[::-1]):
        assert g[:3] == w[:3] and [tuple(x) for x in g[3]] == \
            [tuple(x) for x in w[3]]
        assert g[2]


def test_server_refined_events_match_jax(sil):
    """tones_tiny_sil.gguf behind each package's ASRServer with a refiner
    (K = 4, the tones LM): READY says "refined": true, and the WebSocket
    stream's two UTTERANCE events carry the JAX server's "refined" texts
    beside its online texts; the FINAL and REST payloads are equal."""
    from nemotron_tpu import client as jclient
    from nemotron_tpu import server as jserver
    from nemotron_tpu_torch import client as tclient

    jp, tp, cfg, vocab, jl, tl = sil
    kw = dict(EP_KW, n_slots=3)
    audio, _ = ttones.make_eval_streams(1, 3.0, 16, seed=62)
    want = serve_and_collect(
        functools.partial(jserver.ASRServer, refiner=JRefiner(
            jp, cfg, vocab, beam_size=4, lm=jl, compute_dtype=jnp.float32)),
        jclient, JEngine(jp, cfg, vocab,
                         JCC(att_right_context=13, n_mels=cfg.n_mels),
                         compute_dtype=jnp.float32, **kw),
        [audio[0]], audio[0, :30000], [sil_audio()])
    got = serve_and_collect(
        functools.partial(ASRServer, refiner=TRefiner(tp, cfg, vocab,
                                                      beam_size=4, lm=tl)),
        tclient, TEngine(tp, cfg, vocab,
                         TCC(att_right_context=13, n_mels=cfg.n_mels),
                         compute_dtype=F32, **kw),
        [audio[0]], audio[0, :30000], [sil_audio()])
    assert got["ready"] == want["ready"]
    assert got["ready"][0]["refined"] is True
    assert got["final"] == want["final"] and got["rest"] == want["rest"]
    assert len(got["utterances"][0]) == 2
    for g, w in zip(got["utterances"][0], want["utterances"][0]):
        assert g == w and g["refined"]


def test_server_refiner_failure_keeps_the_event(sil, capsys):
    """A refiner that raises: the UTTERANCE events still arrive, with the
    online text and no "refined" field, and the failure goes to stderr."""
    from nemotron_tpu_torch import client as tclient

    _, tp, cfg, vocab, _, _ = sil

    class Broken:
        def refine(self, segments):
            raise RuntimeError("refiner down")

    got = serve_and_collect(
        functools.partial(ASRServer, refiner=Broken()), tclient,
        TEngine(tp, cfg, vocab, TCC(att_right_context=13, n_mels=cfg.n_mels),
                compute_dtype=F32, **dict(EP_KW, n_slots=3)),
        [], synth(8000, 5), [sil_audio()])
    events = got["utterances"][0]
    assert len(events) == 2
    assert all("refined" not in e and e["text"] for e in events)
    assert "refiner failed" in capsys.readouterr().err


def test_server_beam_engine_matches_jax():
    """A K = 3 beam engine on tones_tiny.gguf behind each package's
    server: READY ("decode": "beam"), the FINAL texts and tokens (frames
    0, no word timings) and the REST answer equal the JAX server's; every
    PARTIAL resends the whole transcript (replace=true)."""
    from nemotron_tpu import client as jclient
    from nemotron_tpu import server as jserver
    from nemotron_tpu_torch import client as tclient

    jp, cfg, vocab = jload_model(FIXTURE, keep_quantized=False)
    tp, _, _ = tload_model(FIXTURE, device="cpu")
    kw = dict(n_slots=3, dsp="numpy", beam_size=3, max_beam_tokens=256)
    audio, _ = ttones.make_eval_streams(2, 3.0, 16, seed=63)
    want = serve_and_collect(
        jserver.ASRServer, jclient,
        JEngine(jp, cfg, vocab, JCC(att_right_context=13, n_mels=cfg.n_mels),
                compute_dtype=jnp.float32, **kw), [audio[0]], audio[1], [])
    got = serve_and_collect(
        ASRServer, tclient,
        TEngine(tp, cfg, vocab, TCC(att_right_context=13, n_mels=cfg.n_mels),
                compute_dtype=F32, **kw), [audio[0]], audio[1], [])
    assert got["ready"] == want["ready"]
    assert got["ready"][0]["decode"] == "beam"
    assert got["final"] == want["final"] and got["rest"] == want["rest"]
    assert "words" not in got["final"][0] and got["final"][0]["text"]
    assert all(t[1] == 0 for t in got["final"][0]["tokens"])
    # the last PARTIAL (a whole transcript) is a hypothesis of the FINAL's
    assert got["partials"][0]


# -- the CLIs -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pcm_file(tmp_path_factory):
    audio, _ = ttones.make_eval_streams(2, 3.0, 16, seed=64)
    paths = []
    for i in range(2):
        p = tmp_path_factory.mktemp("beam_cli") / f"a{i}.pcm"
        audio[i].astype("<i2").tofile(p)
        paths.append(str(p))
    return paths


def run(cmd):
    return subprocess.run([sys.executable, *cmd], capture_output=True,
                          timeout=300, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))


@pytest.mark.parametrize("flags", [
    ["--beam=3"],
    ["--beam=4", f"--lm={LM_FIXTURE}", "--lm-weight=0.5", "--lm-bonus=0.2"],
    ["--boost=T3:1.5,T7:-1"]])
def test_stream_cli_beam_flags_match_jax(pcm_file, flags):
    want = run([os.path.join(REPO, "cli", "transcribe_stream.py"), FIXTURE,
                pcm_file[0], "80", "13", "--cpu", *flags])
    got = run(["-m", "nemotron_tpu_torch.cli", FIXTURE, pcm_file[0], "80",
               "13", "--cpu", *flags])
    assert want.returncode == 0, want.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert got.stdout == want.stdout and len(got.stdout.strip()) > 5
    if flags[0].startswith("--boost"):
        assert b"logit boost applied: T3:1.5,T7:-1" in got.stderr


@pytest.mark.parametrize("flags", [
    ["--beam=3"], ["--nbest=3"],
    ["--beam=4", "--nbest=2", f"--lm={LM_FIXTURE}", "--lm-rescore"],
    ["--beam=3", f"--lm={LM_FIXTURE}", "--lm-weight=0.4"],
    ["--boost=T3:2", "--timestamps"]])
def test_batch_cli_beam_flags_match_jax(pcm_file, flags):
    want = run([os.path.join(REPO, "cli", "transcribe.py"), FIXTURE,
                *pcm_file, "--cpu", *flags])
    got = run(["-m", "nemotron_tpu_torch.cli_transcribe", FIXTURE,
               *pcm_file, "--cpu", *flags])
    assert want.returncode == 0, want.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert got.stdout == want.stdout and got.stdout.count(b"\n") >= 2


@pytest.mark.parametrize("flags,want", [
    (["--beam=x"], "--beam/--nbest take an integer"),
    (["--beam=2", "--srt"], "--srt/--vtt require greedy decode"),
    (["--beam=2", "--confidence"], "confidence requires greedy decode"),
    (["--lm=missing.gguf", "--beam=2"], "missing.gguf"),
    ([f"--lm={FIXTURE}", "--beam=2"], "not an LM GGUF"),
    (["--boost=nope:1"], "not in the vocab"),
    ([f"--lm={LM_FIXTURE}"], "LM shallow fusion requires beam_size > 1")])
def test_batch_cli_beam_errors(capsys, flags, want):
    from nemotron_tpu_torch import cli_transcribe

    assert cli_transcribe.main(["t", FIXTURE, os.path.join(
        REPO, "weights", "train_mid.log"), "--cpu", *flags]) == 1
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("argv,want", [
    (["--refine"], "keep_segment_audio needs endpointing"),
    (["--beam", "2", "--endpoint-silence", "1"],
     "endpointing requires greedy decode"),
    (["--refine", "--endpoint-silence", "1", "--refine-beam", "1"],
     "refinement is a beam re-decode"),
    (["--lm", LM_FIXTURE], "LM shallow fusion requires beam_size > 1"),
    (["--lm", "missing.gguf", "--beam", "2"], "missing.gguf")])
def test_asr_server_beam_flag_errors(capsys, argv, want):
    """The server module takes the beam, LM and refine flags; wrong
    combinations exit 1 with the JAX engines' errors."""
    from nemotron_tpu_torch import asr_server

    assert asr_server.main(["asr_server", FIXTURE, "--cpu", *argv]) == 1
    assert want in capsys.readouterr().err


def test_serve_beam_matches_direct_engine(pcm_file):
    """`python -m nemotron_tpu_torch.serve --beam 2 --lm ... --lockstep`:
    its `[slot s]` lines are the lockstep engine's, driven directly with
    serve's staggered blocks (bf16, as serve runs)."""
    r = run(["-m", "nemotron_tpu_torch.serve", FIXTURE, pcm_file[0],
             "--streams", "2", "--right-context", "13", "--seconds", "3",
             "--cpu", "--lockstep", "--beam", "2", "--lm", LM_FIXTURE])
    assert r.returncode == 0, r.stderr.decode()
    params, cfg, vocab = tload_model(FIXTURE, device="cpu")
    cc = TCC(att_right_context=13, n_mels=cfg.n_mels)
    pcm = np.fromfile(pcm_file[0], "<i2")
    q = cc.shift_samples
    offsets = [(i * len(pcm)) // 2 for i in range(2)]

    def block(i):
        blk = np.resize(np.roll(pcm, -(offsets[i] % len(pcm)))[:q], q)
        offsets[i] += q
        return blk

    eng = TLock(params, cfg, vocab, cc, n_streams=2, beam_size=2,
                lm=tlm.load_lm(LM_FIXTURE, device="cpu"))
    for _ in range(int(3 * 16000 / q)):
        eng.tick_pipelined(np.stack([block(i) for i in range(2)]))
    eng.flush_pipeline()
    eng.refresh_transcripts()
    want = [f"[slot {s}] {eng.transcripts[s][:70]}" for s in range(2)]
    lines = [ln for ln in r.stdout.decode().splitlines()
             if ln.startswith("[slot ")]
    assert lines == want and any(eng.transcripts)
