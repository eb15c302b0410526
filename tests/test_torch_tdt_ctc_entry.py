"""The TDT and CTC families at their entry points, PyTorch port against
the JAX package on the CPU: transcribe_batch on the TDT model of
tests/test_torch_tdt.py (greedy with confidence, n-best lists with LM
fusion and with rescoring); the trained fixtures `tones_tiny_tdt.gguf`
(greedy, and K = 4 with `tones_tiny_lm.gguf`) and
`tones_tiny_hybrid.gguf` (ctc=True), tokens equal to JAX's and token
error under the JAX gate's 10% (tests/test_trained_fixture.py); a TDT
checkpoint through the streaming and batch CLIs with no flag, --ctc in
both CLIs, the serve module and the network server, against the JAX
scripts (run in this process, so that JAX is imported once)."""

import asyncio
import importlib.util
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import torch

from nemotron_tpu import client as jclient
from nemotron_tpu import params as jparams
from nemotron_tpu import server as jserver
from nemotron_tpu.config import CacheConfig as JCC
from nemotron_tpu.models.lm import load_lm as jload_lm
from nemotron_tpu.streaming.serving import ServingEngine as JEngine
from nemotron_tpu.streaming.session import StreamSession as JSession
from nemotron_tpu.streaming.session import transcribe_batch as jtranscribe
from nemotron_tpu.utils import tones as jtones
from nemotron_tpu_torch import cli, cli_transcribe, serve
from nemotron_tpu_torch import client as tclient
from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.models.lm import load_lm as tload_lm
from nemotron_tpu_torch.server import ASRServer
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.streaming.session import StreamSession as TSession
from nemotron_tpu_torch.streaming.session import transcribe_batch as ttrans
from nemotron_tpu_torch.utils.text import edit_distance
from test_torch_tdt import assert_tokens_equal, lms, synth, tdt  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TDT_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_tdt.gguf")
HYBRID_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_hybrid.gguf")
LM_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_lm.gguf")
TIMEOUT = 60.0


# -- transcribe_batch (TDT) ---------------------------------------------------


def test_transcribe_batch_tdt_matches_jax(tdt, lms):
    """Greedy with confidence, the beam's n-best lists with LM fusion and
    with LM rescoring over a ragged batch (plain greedy: the batch CLI
    below)."""
    jp, tp, cfg, vocab = tdt
    jlm, tlm = lms
    utts = [synth(9000, 1), synth(4000, 2), synth(14000, 3)]
    for kw in ({"return_confidence": True},
               {"beam_size": 4, "return_nbest": 3, "lm": 1},
               {"beam_size": 4, "return_nbest": 2, "lm": 1,
                "lm_rescore": True}):
        jkw, tkw = dict(kw), dict(kw)
        if "lm" in kw:
            jkw["lm"], tkw["lm"] = jlm, tlm
        want = jtranscribe(jp, cfg, vocab, utts, **jkw)
        got = ttrans(tp, cfg, vocab, utts, **tkw)
        if "return_nbest" in kw:
            for g, w in zip(got, want):
                assert [t for t, _ in g] == [t for t, _ in w]
                np.testing.assert_allclose([s for _, s in g],
                                           [s for _, s in w], atol=1e-4)
        elif "return_confidence" in kw:
            assert got[0] == want[0]
            for g, w in zip(got[1], want[1]):
                assert_tokens_equal(g, w, True)
        else:
            assert got == want, kw
        assert any(got if isinstance(got, list) else got[0])


# -- the trained fixtures and the CLIs ---------------------------------------


def test_trained_tdt_fixture_matches_jax():
    """tones_tiny_tdt.gguf at R = 13: greedy over the JAX gate's streams
    (tests/test_trained_fixture.py: two of 15 s, seed 123, token error
    under its 10%) and K = 4 with tones_tiny_lm.gguf over two of 8 s give
    the JAX session's tokens."""
    jp, jcfg, vocab = jparams.load_model(TDT_FIXTURE)
    tp, tcfg, _ = tparams.load_model(TDT_FIXTURE, device="cpu")
    assert tcfg.tdt_durations == jcfg.tdt_durations == (0, 1, 2, 3, 4)
    jlm, tlm = jload_lm(LM_FIXTURE), tload_lm(LM_FIXTURE, device="cpu")
    for kw, jx, tx, (secs, seed) in (
            ({}, {}, {}, (15.0, 123)),
            ({"beam_size": 4, "max_beam_tokens": 256}, {"lm": jlm},
             {"lm": tlm}, (8.0, 5))):
        audio, truths = jtones.make_eval_streams(2, secs, 16, seed=seed)
        cc = dict(att_right_context=13, n_mels=jcfg.n_mels)
        js = JSession(jp, jcfg, vocab, JCC(**cc), n_streams=2, **kw, **jx)
        ts = TSession(tp, tcfg, vocab, TCC(**cc), n_streams=2, **kw, **tx)
        js.process(audio)
        ts.process(audio)
        assert ts.finalize() == js.finalize()
        got = [ts.get_tokens(s) for s in range(2)]
        assert got == [js.get_tokens(s) for s in range(2)]
        labels = [[t for t, _ in g] for g in got]
        assert all(len(g) > 10 for g in labels)
        if not kw:    # the JAX gate's (greedy); the beam with the LM
            # scores 10.2% on its streams, in both packages
            errs = sum(edit_distance(g, t) for g, t in zip(labels, truths))
            assert errs / sum(len(t) for t in truths) < 0.10


def jax_script(rel: str):
    """A JAX script (cli/*.py, scripts/*.py) loaded as a module, so that
    its main(argv) runs in this process."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stdout_of(main, argv, capsys) -> str:
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def test_tdt_checkpoint_runs_through_the_clis(tmp_path, capsys):
    """A TDT GGUF runs through the streaming and the batch CLI with no
    flag: stdout equals the JAX CLIs'."""
    audio, _ = jtones.make_eval_streams(2, 5.0, 16, seed=91)
    paths = [str(tmp_path / "a.pcm"), str(tmp_path / "b.pcm")]
    audio[0].astype("<i2").tofile(paths[0])
    audio[1, :48000].astype("<i2").tofile(paths[1])
    argv = [TDT_FIXTURE, paths[0], "80", "13", "--cpu"]
    want = stdout_of(jax_script("cli/transcribe_stream.py").main,
                     ["cli", *argv], capsys)
    assert stdout_of(cli.main, ["cli", *argv], capsys) == want
    assert len(want.strip()) > 10
    argv = [TDT_FIXTURE, *paths, "--cpu"]
    want = stdout_of(jax_script("cli/transcribe.py").main, ["t", *argv],
                     capsys)
    assert stdout_of(cli_transcribe.main, ["t", *argv], capsys) == want
    assert want.count("\t") == 2


def test_trained_hybrid_fixture_ctc_matches_jax():
    """tones_tiny_hybrid.gguf with ctc=True over the JAX gate's streams
    (two of 15 s, seed 123, R = 13): the JAX session's tokens, token error
    under 10%."""
    jp, jcfg, vocab = jparams.load_model(HYBRID_FIXTURE)
    tp, tcfg, _ = tparams.load_model(HYBRID_FIXTURE, device="cpu")
    assert tp.ctc is not None and not tcfg.tdt_durations
    audio, truths = jtones.make_eval_streams(2, 15.0, 16, seed=123)
    cc = dict(att_right_context=13, n_mels=jcfg.n_mels)
    js = JSession(jp, jcfg, vocab, JCC(**cc), n_streams=2, ctc=True)
    ts = TSession(tp, tcfg, vocab, TCC(**cc), n_streams=2, ctc=True)
    js.process(audio)
    ts.process(audio)
    assert ts.finalize() == js.finalize()
    got = [ts.get_tokens(s) for s in range(2)]
    assert got == [js.get_tokens(s) for s in range(2)]
    labels = [[t for t, _ in g] for g in got]
    errs = sum(edit_distance(g, t) for g, t in zip(labels, truths))
    assert errs / sum(len(t) for t in truths) < 0.10


def test_ctc_flag_in_the_clis_matches_jax(tmp_path, capsys):
    """--ctc on the hybrid fixture: the streaming CLI's and the batch CLI's
    stdout equal the JAX CLIs'; --ctc with subtitles (batch) and with a
    beam (streaming) exit 1 with the JAX CLIs' errors."""
    audio, _ = jtones.make_eval_streams(2, 5.0, 16, seed=93)
    paths = [str(tmp_path / "a.pcm"), str(tmp_path / "b.pcm")]
    audio[0].astype("<i2").tofile(paths[0])
    audio[1, :48000].astype("<i2").tofile(paths[1])
    jstream = jax_script("cli/transcribe_stream.py").main
    jbatch = jax_script("cli/transcribe.py").main
    argv = [HYBRID_FIXTURE, paths[0], "80", "13", "--cpu", "--ctc",
            "--timestamps"]
    want = stdout_of(jstream, ["cli", *argv], capsys)
    assert stdout_of(cli.main, ["cli", *argv], capsys) == want
    assert "{" in want and len(want.strip()) > 10
    argv = [HYBRID_FIXTURE, *paths, "--cpu", "--ctc"]
    want = stdout_of(jbatch, ["t", *argv], capsys)
    assert stdout_of(cli_transcribe.main, ["t", *argv], capsys) == want
    assert want.count("\t") == 2
    for main_j, main_t, argv in (
            (jbatch, cli_transcribe.main,
             ["t", HYBRID_FIXTURE, paths[0], "--cpu", "--ctc", "--srt"]),
            (jstream, cli.main,
             ["cli", HYBRID_FIXTURE, paths[0], "--cpu", "--ctc",
              "--beam=2"])):
        assert main_j(argv) == 1
        want = capsys.readouterr().err.splitlines()[-1]
        assert main_t(argv) == 1
        assert capsys.readouterr().err.splitlines()[-1] == want
        assert "ctc" in want


def test_serve_ctc_matches_jax(tmp_path, capsys):
    """The serve module with --ctc, lockstep and continuous batching: the
    `[slot s]` lines equal scripts/serve.py's."""
    audio, _ = jtones.make_eval_streams(1, 4.0, 16, seed=95)
    path = str(tmp_path / "a.pcm")
    audio[0].astype("<i2").tofile(path)
    jserve = jax_script("scripts/serve.py").main
    for extra in (["--lockstep"], []):
        argv = ["serve", HYBRID_FIXTURE, path, "--streams", "2",
                "--right-context", "13", "--seconds", "3", "--cpu", "--ctc",
                *extra]
        want = stdout_of(jserve, argv, capsys)
        got = stdout_of(serve.main, argv, capsys)
        lines = [ln for ln in got.splitlines() if ln.startswith("[slot ")]
        assert lines == [ln for ln in want.splitlines()
                         if ln.startswith("[slot ")]
        assert len(lines) == 2 and all(len(ln) > 12 for ln in lines)


class _Server:
    """A server (the port's or the JAX package's ASRServer) on its own
    event loop in a daemon thread, with the HTTP sidecar."""

    def __init__(self, server_cls, engine):
        self.loop = asyncio.new_event_loop()
        self.srv = server_cls(engine, port=0, tick_interval=0.02,
                              http_stats_port=0)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.srv.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(TIMEOUT), "server failed to start"

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.srv.stop(),
                                         self.loop).result(TIMEOUT)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


def served(server_cls, client_mod, engine, audio, rest_audio) -> dict:
    """READY and FINAL of one TCP stream, and a POST /transcribe reply."""
    s = _Server(server_cls, engine)
    try:
        with client_mod.ASRClient("127.0.0.1", s.srv.port,
                                  timeout=TIMEOUT) as c:
            ready = c.start()
            for i in range(0, len(audio), 1000):
                c.send_audio(audio[i:i + 1000])
            final = c.end()
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.srv.http_stats_port}/transcribe",
            data=rest_audio.tobytes(), method="POST")
        rest = json.loads(urllib.request.urlopen(req,
                                                 timeout=TIMEOUT).read())
    finally:
        s.stop()
    return dict(ready=ready, final=final, rest=rest)


def test_server_ctc_matches_jax_server():
    """A CTC engine (the hybrid fixture, R = 13, f32, host DSP, with
    confidence) behind the port's server and the JAX server: READY
    ("decode": "ctc"), FINAL and the REST reply equal, log-posteriors
    within 5e-5."""
    jp, jc, jv = jparams.load_model(HYBRID_FIXTURE, keep_quantized=False)
    tp, tc, tv = tparams.load_model(HYBRID_FIXTURE, device="cpu")
    audio, _ = jtones.make_eval_streams(2, 4.0, 16, seed=97)
    kw = dict(n_slots=2, dsp="numpy", confidence=True, ctc=True)
    want = served(jserver.ASRServer, jclient,
                  JEngine(jp, jc, jv, JCC(att_right_context=13,
                                          n_mels=jc.n_mels),
                          compute_dtype=jnp.float32, **kw),
                  audio[0], audio[1])
    got = served(ASRServer, tclient,
                 TEngine(tp, tc, tv, TCC(att_right_context=13,
                                         n_mels=tc.n_mels),
                         compute_dtype=torch.float32, **kw),
                 audio[0], audio[1])
    assert got["ready"] == want["ready"]
    assert got["ready"]["decode"] == got["rest"]["decode"] == "ctc"
    for k in ("final", "rest"):
        g, w = got[k], want[k]
        assert g.keys() == w.keys() and g["text"] == w["text"] and g["text"]
        assert [t[:2] for t in g["tokens"]] == [t[:2] for t in w["tokens"]]
        np.testing.assert_allclose([t[2] for t in g["tokens"]],
                                   [t[2] for t in w["tokens"]], atol=5e-5)
