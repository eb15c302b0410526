"""The port's network server (nemotron_tpu_torch/server.py) and client over
loopback on the CPU, on ephemeral ports with in-process event loops.

Two gates. Against the JAX package: the same audio through the port's
server and the JAX server (both over f32 engines with host DSP) gives
equal READY, PARTIAL text, FINAL, UTTERANCE and REST payloads -- text,
tokens and word timings exact, log-posteriors within 5e-5 (the encoded
tolerance of tests/test_torch_confidence.py). Against the port's own
engine: the counterparts of tests/test_server.py (server path == the
directly driven engine; concurrency, a full slab and its reuse, protocol
errors, the pending cap, stats, disconnects, HTTP and WebSocket). And on
a machine with a card: the server on the trained tones fixture over
loopback against the CPU (marked `cuda`; skipped without one).

The JAX imports sit inside fixtures and tests, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_server.py

Every socket wait has a timeout (the clients' 60 s, server start and stop
60 s), so a wedged loopback fails its test instead of hanging the run.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nemotron_tpu_torch.client import ASRClient, ASRServerError, WSASRClient
from nemotron_tpu_torch.config import CacheConfig as TCC
from nemotron_tpu_torch.params import load_model, params_from_arrays
from nemotron_tpu_torch.server import ASRServer
from nemotron_tpu_torch.streaming.serving import ServingEngine as TEngine
from nemotron_tpu_torch.utils import tones as ttones
from nemotron_tpu_torch.utils.subtitles import tokens_to_words

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")
SIL_FIXTURE = os.path.join(REPO, "weights", "tones_tiny_sil.gguf")
CONF_ATOL = 5e-5
TIMEOUT = 60.0


def synth(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 8000).astype(
        np.int16)


class _Server:
    """Run a server (the port's or the JAX package's ASRServer) on its own
    event loop in a daemon thread."""

    def __init__(self, server_cls, engine, tick_interval=0.02, **srv_kw):
        self.loop = asyncio.new_event_loop()
        self.srv = server_cls(engine, port=0, tick_interval=tick_interval,
                              **srv_kw)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.srv.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(TIMEOUT), "server failed to start"

    @property
    def addr(self):
        return "127.0.0.1", self.srv.port

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.srv.stop(),
                                         self.loop).result(TIMEOUT)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


@pytest.fixture(scope="module")
def tiny(model_setup):
    """The port's params, config and vocab of the JAX tests' tiny random
    model."""
    arrays, _jp, cfg = model_setup
    return params_from_arrays(arrays, cfg, "cpu"), cfg, \
        [f"w{i}" for i in range(cfg.vocab_size)]


@pytest.fixture()
def cc(tiny):
    return TCC(att_right_context=1, att_left_context=12, n_mels=tiny[1].n_mels)


def make_engine(tiny, cc, n_slots=4, **kw):
    params, cfg, vocab = tiny
    return TEngine(params, cfg, vocab, cc, n_slots=n_slots,
                   compute_dtype=torch.float32, **kw)


@pytest.fixture()
def server_factory(tiny, cc):
    servers = []

    def make(_srv_kw=None, **engine_kw):
        s = _Server(ASRServer, make_engine(tiny, cc, **engine_kw),
                    **(_srv_kw or {}))
        servers.append(s)
        return s

    yield make
    for s in servers:
        s.stop()


def reference_final(tiny, cc, audio, chunk, **engine_kw):
    """The same audio through a directly driven engine."""
    eng = make_engine(tiny, cc, **engine_kw)
    slot = eng.add_stream()
    for i in range(0, len(audio), chunk):
        eng.feed_audio({slot: audio[i:i + chunk]})
        eng.step()
    return eng.finalize_stream(slot, return_tokens=True)


def client(addr, cls=ASRClient):
    return cls(*addr, timeout=TIMEOUT)


# -- the port's server against the JAX server --------------------------------


def assert_tokens_close(got, want):
    assert [t[:2] for t in got] == [t[:2] for t in want]
    assert all(abs(g[2] - w[2]) <= CONF_ATOL for g, w in zip(got, want))


def assert_payload_close(got: dict, want: dict):
    """Equal payloads, the log-posteriors of "tokens" within CONF_ATOL."""
    assert got.keys() == want.keys()
    for k in got:
        if k == "tokens" and got[k] and len(got[k][0]) == 3:
            assert_tokens_close(got[k], want[k])
        else:
            assert got[k] == want[k], k


def serve_and_collect(server_cls, client_mod, engine, streams, rest_audio,
                      utterances):
    """Stream each of `streams` over TCP (1000-sample blocks) and
    `utterances` over WebSocket, POST `rest_audio` to /transcribe; returns
    the READY, FINAL and UTTERANCE payloads, the PARTIAL texts joined, the
    REST response and the STATS keys."""
    s = _Server(server_cls, engine, http_stats_port=0, ws_port=0)
    out = {"ready": [], "final": [], "partials": [], "utterances": []}
    try:
        for audio in streams:
            with client_mod.ASRClient(*s.addr, timeout=TIMEOUT) as c:
                out["ready"].append(c.start())
                for i in range(0, len(audio), 1000):
                    c.send_audio(audio[i:i + 1000])
                out["final"].append(c.end())
                out["partials"].append(c.transcript)
                out["stats_keys"] = sorted(c.stats())
        for audio in utterances:
            with client_mod.WSASRClient("127.0.0.1", s.srv.ws_port,
                                        timeout=TIMEOUT) as c:
                out["ready"].append(c.start())
                c.send_audio(audio)
                deadline = time.time() + TIMEOUT
                while len(c.utterances) < 2 and time.time() < deadline:
                    c.pump()
                    time.sleep(0.02)
                out["final"].append(c.end())
                out["utterances"].append(list(c.utterances))
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.srv.http_stats_port}/transcribe",
            data=rest_audio.tobytes(), method="POST")
        out["rest"] = json.loads(urllib.request.urlopen(
            req, timeout=TIMEOUT).read())
    finally:
        s.stop()
    return out


def sil_audio():
    """Two tone utterances, each followed by 3 s of silence (the JAX
    package's endpointing test, tests/test_serving.py:1363-1423)."""
    rng = np.random.default_rng(7)

    def utt(labels, tail_s):
        n = int(0.30 * len(labels) * 16000) + int(tail_s * 16000)
        return ttones.render_tones(np.asarray(labels),
                                   np.full(len(labels), 0.25), rng, 16, n,
                                   gaps=np.full(len(labels), 0.05))

    return np.concatenate([utt([3, 11, 6, 0, 14, 9], 3.0),
                           utt([8, 2, 15], 3.0)])


@pytest.mark.parametrize("fixture,confidence", [
    ("tones_tiny", True), ("tones_tiny", False), ("tones_tiny_sil", True)])
def test_payloads_match_jax_server(fixture, confidence):
    """The trained fixtures (R = 13, f32, host DSP; the silence-robust one
    with endpointing): two TCP streams, one WebSocket stream of two
    utterances (tones_tiny_sil: two UTTERANCE events), one REST request,
    through both servers: READY, FINAL, UTTERANCE and REST payloads
    equal, the PARTIAL texts joined to the FINAL text, FINAL words equal
    to tokens_to_words of its tokens."""
    import jax.numpy as jnp

    from nemotron_tpu import client as jclient
    from nemotron_tpu import server as jserver
    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.params import load_model as jload_model
    from nemotron_tpu.streaming.serving import ServingEngine as JEngine
    from nemotron_tpu_torch import client as tclient

    path = os.path.join(REPO, "weights", fixture + ".gguf")
    jp, jc, jv = jload_model(path, keep_quantized=False)
    tp, tc, tv = load_model(path, device="cpu")
    kw = dict(n_slots=3, dsp="numpy", confidence=confidence)
    if fixture == "tones_tiny_sil":
        kw.update(endpoint_silence_s=1.0, endpoint_reset=True)
    audio, _ = ttones.make_eval_streams(3, 4.0, 16, seed=61)
    streams = [audio[0], audio[1, :50000]]
    utts = [sil_audio()] if fixture == "tones_tiny_sil" else []
    want = serve_and_collect(
        jserver.ASRServer, jclient,
        JEngine(jp, jc, jv, JCC(att_right_context=13, n_mels=jc.n_mels),
                compute_dtype=jnp.float32, **kw), streams, audio[2], utts)
    got = serve_and_collect(
        ASRServer, tclient,
        TEngine(tp, tc, tv, TCC(att_right_context=13, n_mels=tc.n_mels),
                compute_dtype=torch.float32, **kw), streams, audio[2], utts)
    assert got["ready"] == want["ready"]
    assert got["ready"][0]["confidence"] is confidence
    assert got["stats_keys"] == want["stats_keys"]
    assert got["partials"] == want["partials"]
    for g, w in zip(got["final"], want["final"]):
        assert_payload_close(g, w)
    for g, p in zip(got["final"], got["partials"]):
        assert g["text"] == p and len(g["tokens"]) > 3
        assert g["words"] == [list(x) for x in tokens_to_words(
            [tuple(t) for t in g["tokens"]], tv)]
        assert all(len(t) == (3 if confidence else 2) for t in g["tokens"])
    assert_payload_close(got["rest"], want["rest"])
    assert got["rest"]["decode"] == "greedy" and got["rest"]["words"]
    assert len(got["utterances"]) == len(want["utterances"])
    for g, w in zip(got["utterances"], want["utterances"]):
        assert len(g) == len(w) == 2
        for gu, wu in zip(g, w):
            assert_payload_close(gu, wu)
            assert gu["words"] and gu["text"]


# -- the port's counterparts of tests/test_server.py -------------------------


def test_roundtrip_matches_engine(tiny, cc, server_factory):
    s = server_factory()
    n = cc.chunk_samples
    audio = np.concatenate([synth(n, 1), synth(n, 2), synth(n // 3, 3)])
    with client(s.addr) as c:
        info = c.start()
        assert info["sample_rate"] == 16000 and info["chunk_samples"] == n
        assert info["decode"] == "greedy" and info["beam"] == 1
        assert info["refined"] is False and info["confidence"] is False
        for i in range(0, len(audio), 1000):
            c.send_audio(audio[i:i + 1000])
        final = c.end()
    want_text, want_toks = reference_final(tiny, cc, audio, n)
    assert final["text"] == want_text and want_toks
    assert [tuple(t) for t in final["tokens"]] == want_toks
    assert c.transcript == want_text
    assert final["words"] == [list(w) for w in
                              tokens_to_words(want_toks, s.srv.engine.vocab)]


def test_concurrent_clients_isolated(tiny, cc, server_factory):
    s = server_factory()
    n = cc.chunk_samples
    audios = {k: np.concatenate([synth(n, 10 + k), synth(n, 20 + k)])
              for k in range(3)}
    clients = {k: client(s.addr) for k in audios}
    for c in clients.values():
        c.start()
    for i in range(0, 2 * n, n // 2):
        for k, c in clients.items():
            c.send_audio(audios[k][i:i + n // 2])
    finals = {k: c.end() for k, c in clients.items()}
    for c in clients.values():
        c.close()
    for k, audio in audios.items():
        want_text, want_toks = reference_final(tiny, cc, audio, n)
        assert finals[k]["text"] == want_text, f"client {k} diverged"
        assert [tuple(t) for t in finals[k]["tokens"]] == want_toks


def test_server_full_and_reuse(cc, server_factory):
    s = server_factory(n_slots=2)
    a, b, c = client(s.addr), client(s.addr), client(s.addr)
    a.start()
    b.start()
    with pytest.raises(ASRServerError, match="free"):
        c.start()
    a.send_audio(synth(cc.chunk_samples, 0))
    a.end()
    assert c.start()["slot"] == 0
    for cl in (a, b, c):
        cl.close()


def test_protocol_errors(server_factory):
    s = server_factory()
    with client(s.addr) as c:
        c._send(2, b"\x00\x01")              # AUDIO before START
        with pytest.raises(ASRServerError, match="before START"):
            c._wait_for(0x82)
    with client(s.addr) as c:
        c._send(3)                           # END before START
        with pytest.raises(ASRServerError, match="END before START"):
            c._wait_for(0x82)
    with client(s.addr) as c:
        c.start()
        c._send(2, b"\x00")                  # odd-length PCM
        with pytest.raises(ASRServerError, match="odd-length"):
            c._wait_for(0x82)
        c._send(1)                           # START twice
        with pytest.raises(ASRServerError, match="already started"):
            c._wait_for(0x82)
        c._send(0x7E)                        # an unknown frame type
        with pytest.raises(ASRServerError, match="unknown frame type"):
            c._wait_for(0x82)
    with client(s.addr) as c:
        c._send(1, b"\xffnot json")
        with pytest.raises(ASRServerError, match="not JSON"):
            c._wait_for(0x82)


def test_pending_cap_recovers(cc, server_factory, monkeypatch):
    """A burst over the staging cap is rejected, not counted: the slot
    keeps accepting paced audio afterwards."""
    import nemotron_tpu_torch.server as server_mod

    monkeypatch.setattr(server_mod, "MAX_PENDING_SECONDS",
                        cc.chunk_samples / 2 / 16000.0)
    s = server_factory()
    with client(s.addr) as c:
        c.start()
        c._send(2, synth(cc.chunk_samples, 11).tobytes())
        with pytest.raises(ASRServerError, match="slow down"):
            c._wait_for(0x82)
        for i in range(8):
            for _ in range(400):
                if c.stats().get("staged_samples", 0) == 0:
                    break
                time.sleep(0.05)
            else:
                raise AssertionError("ticker never drained staged audio")
            c.send_audio(synth(cc.chunk_samples // 4, 20 + i))
        assert "text" in c.end()


def test_stats_roundtrip(cc, server_factory):
    s = server_factory()
    with client(s.addr) as c:
        c.start()
        c.send_audio(synth(cc.chunk_samples, 5))
        st = c.stats()
        assert st["n_slots"] == 4 and st["active_slots"] >= 1
        assert st["connections"] == 1 and st["connections_total"] >= 1
        assert {"uptime_s", "staged_samples", "latency"} <= st.keys()
        c.end()


def test_disconnect_frees_slot(cc, server_factory):
    s = server_factory(n_slots=2)
    c = client(s.addr)
    c.start()
    c.send_audio(synth(cc.chunk_samples // 2, 7))
    c.close()
    deadline = time.time() + 30
    while time.time() < deadline and s.srv.engine.active.sum():
        time.sleep(0.05)
    assert s.srv.engine.active.sum() == 0, "slot not reclaimed"


def test_confidence_final_tokens(tiny, cc, server_factory):
    s = server_factory(confidence=True)
    n = cc.chunk_samples
    audio = np.concatenate([synth(n, 30), synth(n, 31)])
    with client(s.addr) as c:
        assert c.start()["confidence"] is True
        c.send_audio(audio)
        final = c.end()
    want_text, want_toks = reference_final(tiny, cc, audio, n,
                                           confidence=True)
    assert final["text"] == want_text
    # the log-posteriors survive JSON exactly (Python floats, repr
    # round-trip)
    assert [tuple(t) for t in final["tokens"]] == want_toks
    assert want_toks and all(t[2] <= 0.0 for t in want_toks)


def test_utterance_endpoint_events(server_factory, cc):
    """An endpoint injected into the engine's queue (as _ep_update queues
    it) becomes an UTTERANCE event on the owning connection, with text,
    tokens, words and a per-connection index."""
    s = server_factory(endpoint_silence_s=1.0)
    with client(s.addr) as c:
        info = c.start()
        assert info["endpointing"] is True
        c.send_audio(synth(cc.chunk_samples, 60))
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and not c.transcript:
            c.pump()
            time.sleep(0.05)
        assert c.transcript, "tiny model emitted nothing"
        eng, slot = s.srv.engine, info["slot"]
        s.loop.call_soon_threadsafe(
            eng._ep_pending.append, (slot, len(eng.tokens[slot]), None))
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and not c.utterances:
            c.pump()
            time.sleep(0.05)
        assert c.utterances, "no UTTERANCE event arrived"
        utt = c.utterances[0]
        assert utt["index"] == 0 and utt["text"] and utt["tokens"]
        assert utt["tokens"] == [list(t) for t in
                                 eng.tokens[slot][:len(utt["tokens"])]]
        assert utt["words"] == [list(w) for w in tokens_to_words(
            [tuple(t) for t in utt["tokens"]], eng.vocab)]
        c.end()


def http_server(tiny, cc, n_slots):
    return _Server(ASRServer, make_engine(tiny, cc, n_slots=n_slots),
                   http_stats_port=0)


def test_http_stats_endpoint(tiny, cc):
    s = http_server(tiny, cc, 2)
    try:
        base = f"http://127.0.0.1:{s.srv.http_stats_port}"
        body = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=TIMEOUT).read().decode()
        assert "nemotron_asr_n_slots 2" in body
        assert "nemotron_asr_active_slots 0" in body
        assert "nemotron_asr_connections " in body
        for ln in body.strip().splitlines():
            float(ln.rsplit(" ", 1)[1])
        st = json.loads(urllib.request.urlopen(f"{base}/stats",
                                               timeout=TIMEOUT).read())
        assert st["n_slots"] == 2
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=TIMEOUT)
    finally:
        s.stop()


def wav_bytes(samples):
    import struct

    data = samples.tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2,
                                    16)
            + b"data" + struct.pack("<I", len(data)) + data)


def test_http_transcribe_roundtrip(tiny, cc):
    """POST /transcribe (raw PCM, and the same audio as WAV) returns the
    text and tokens of the directly driven engine."""
    audio = synth(cc.chunk_samples * 3, 7)
    want_text, want_toks = reference_final(tiny, cc, audio, cc.chunk_samples)
    s = http_server(tiny, cc, 2)
    try:
        base = f"http://127.0.0.1:{s.srv.http_stats_port}"
        for body in (audio.tobytes(), wav_bytes(audio)):
            req = urllib.request.Request(f"{base}/transcribe", data=body,
                                         method="POST")
            resp = json.loads(urllib.request.urlopen(req,
                                                     timeout=TIMEOUT).read())
            assert resp["text"] == want_text
            assert [tuple(t) for t in resp["tokens"]] == want_toks
            assert resp["decode"] == "greedy"
            assert abs(resp["audio_s"] - audio.size / 16000.0) < 1e-6
            assert resp["frame_seconds"] == pytest.approx(
                cc.subsampling_factor * cc.hop_length / cc.sample_rate)
        assert int(np.sum(s.srv.engine.active)) == 0
    finally:
        s.stop()


def test_http_transcribe_errors(tiny, cc):
    """Empty body 400/411, malformed WAV 400, oversized Content-Length 413,
    slab full 503, an engine exception 500 -- and no slot leaks."""
    import http.client

    s = http_server(tiny, cc, 1)
    try:
        base = f"http://127.0.0.1:{s.srv.http_stats_port}"

        def post(body):
            req = urllib.request.Request(f"{base}/transcribe", data=body,
                                         method="POST")
            return urllib.request.urlopen(req, timeout=TIMEOUT)

        with pytest.raises(urllib.error.HTTPError) as e:
            post(b"")
        assert e.value.code in (400, 411)
        with pytest.raises(urllib.error.HTTPError) as e:
            post(b"RIFF" + b"\x00" * 4 + b"WAVE" + b"junkjunk")
        assert e.value.code == 400
        assert "malformed WAV" in json.loads(e.value.read())["error"]
        conn = http.client.HTTPConnection("127.0.0.1",
                                          s.srv.http_stats_port,
                                          timeout=TIMEOUT)
        conn.putrequest("POST", "/transcribe")
        conn.putheader("Content-Length", str(ASRServer.MAX_HTTP_BODY + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
        cl = ASRClient("127.0.0.1", s.srv.port, timeout=TIMEOUT)
        cl.start()
        with pytest.raises(urllib.error.HTTPError) as e:
            post(synth(cc.chunk_samples, 1).tobytes())
        assert e.value.code == 503
        cl.close()
        deadline = time.time() + 30
        while time.time() < deadline and int(np.sum(s.srv.engine.active)):
            time.sleep(0.05)
        orig = s.srv.engine.feed_audio
        s.srv.engine.feed_audio = \
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                post(synth(cc.chunk_samples, 2).tobytes())
            assert e.value.code == 500
            assert "boom" in json.loads(e.value.read())["error"]
        finally:
            s.srv.engine.feed_audio = orig
        assert int(np.sum(s.srv.engine.active)) == 0
    finally:
        s.stop()


def test_ws_roundtrip_matches_tcp(tiny, cc, server_factory):
    s = server_factory(_srv_kw={"ws_port": 0})
    n = cc.chunk_samples
    audio = np.concatenate([synth(n, 41), synth(n, 42), synth(n // 2, 43)])
    with client(("127.0.0.1", s.srv.ws_port), WSASRClient) as w:
        assert w.start()["sample_rate"] == 16000
        for i in range(0, len(audio), 777):
            w.send_audio(audio[i:i + 777])
        ws_final = w.end()
        assert w.stats()["connections_total"] >= 1
    with client(s.addr) as t:
        t.start()
        for i in range(0, len(audio), 1000):
            t.send_audio(audio[i:i + 1000])
        tcp_final = t.end()
    want_text, want_toks = reference_final(tiny, cc, audio, n)
    assert ws_final == tcp_final
    assert ws_final["text"] == want_text == w.transcript
    assert [tuple(x) for x in ws_final["tokens"]] == want_toks


def test_ws_protocol_errors_and_ping(server_factory):
    import socket

    from nemotron_tpu_torch import websocket as ws

    s = server_factory(_srv_kw={"ws_port": 0})
    c = client(("127.0.0.1", s.srv.ws_port), WSASRClient)
    with pytest.raises(ASRServerError, match="AUDIO before START"):
        c._send(0x02, synth(100, 1).tobytes())
        c._wait_for(0x7F)
    c.close()

    sock = socket.create_connection(("127.0.0.1", s.srv.ws_port),
                                    timeout=TIMEOUT)
    req, expect = ws.client_handshake_request("x")
    sock.sendall(req)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(1 << 16)
    head, _, buf = buf.partition(b"\r\n\r\n")
    assert b" 101 " in head.split(b"\r\n")[0] and expect.encode() in head

    def read_one():
        nonlocal buf
        while True:
            res = ws.parse_frame(buf)
            if res is not None:
                _fin, opcode, _m, payload, consumed = res
                buf = buf[consumed:]
                return opcode, payload
            data = sock.recv(1 << 16)
            if not data:
                raise ConnectionError("eof")
            buf += data

    sock.sendall(ws.encode_frame(ws.OP_PING, b"hb-17", mask=True))
    assert read_one() == (ws.OP_PONG, b"hb-17")
    sock.sendall(ws.encode_frame(
        ws.OP_TEXT, json.dumps({"type": "bogus"}).encode(), mask=True))
    opcode, payload = read_one()
    assert opcode == ws.OP_TEXT
    assert "unknown control type" in json.loads(payload)["error"]
    sock.sendall(ws.encode_frame(ws.OP_TEXT, b"{}", mask=True))
    assert "\"type\" field" in json.loads(read_one()[1])["error"]
    sock.sendall(ws.encode_frame(ws.OP_BINARY, b"\0\0", mask=False))
    assert "unmasked" in json.loads(read_one()[1])["error"]
    sock.close()


def test_ws_disconnect_frees_slot(cc, server_factory):
    s = server_factory(_srv_kw={"ws_port": 0}, n_slots=1)
    c = client(("127.0.0.1", s.srv.ws_port), WSASRClient)
    c.start()
    c.send_audio(synth(cc.chunk_samples, 5))
    c.sock.close()
    deadline = time.time() + 30
    while time.time() < deadline:
        with client(("127.0.0.1", s.srv.ws_port), WSASRClient) as c2:
            try:
                c2.start()
                break
            except ASRServerError:
                time.sleep(0.1)
    else:
        pytest.fail("slot was never reclaimed after WS disconnect")


def test_refiner_requires_segment_audio_and_a_later_slice(tiny, cc):
    """A refiner needs an engine built with keep_segment_audio (the JAX
    package's ValueError); with one, the server takes it (the refiner is
    ported: tests/test_torch_refine.py)."""
    with pytest.raises(ValueError, match="keep_segment_audio"):
        ASRServer(make_engine(tiny, cc), refiner=object())
    eng = make_engine(tiny, cc, endpoint_silence_s=1.0,
                      keep_segment_audio=True)
    refiner = object()
    assert ASRServer(eng, refiner=refiner).refiner is refiner


def test_endpoint_inside_finalize_is_dropped_as_in_jax():
    """A fault of the reference, kept by the port (ROADMAP Queue 3): an
    utterance endpoint that fires inside finalize_stream -- audio that no
    tick has stepped yet when END or POST /transcribe arrives -- is
    queued and then dropped with the slot, so the server never relays
    it. The same audio stepped and polled before the finalize gives both
    events."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.params import load_model as jload_model
    from nemotron_tpu.streaming.serving import ServingEngine as JEngine

    pcm = sil_audio()
    jp, jc, jv = jload_model(SIL_FIXTURE, keep_quantized=False)
    tp, tc, tv = load_model(SIL_FIXTURE, device="cpu")
    kw = dict(n_slots=2, dsp="numpy", endpoint_silence_s=1.0,
              endpoint_reset=True)
    for step_first in (False, True):
        events = []
        for eng in (JEngine(jp, jc, jv, JCC(att_right_context=13,
                                            n_mels=jc.n_mels),
                            compute_dtype=jnp.float32, **kw),
                    TEngine(tp, tc, tv, TCC(att_right_context=13,
                                            n_mels=tc.n_mels),
                            compute_dtype=torch.float32, **kw)):
            s = eng.add_stream()
            eng.feed_audio({s: pcm})
            got = 0
            if step_first:
                eng.step()
                got = len(eng.poll_endpoints())
            eng.finalize_stream(s)
            events.append(got + len(eng.poll_endpoints()))
        assert events == ([2, 2] if step_first else [0, 0])


# -- the entry points: asr_server and asr_client as a user runs them ----------


def start_asr_server(args, env):
    """`python -m nemotron_tpu_torch.asr_server` on free ports; returns the
    process and its TCP, HTTP and WebSocket ports read from its stderr."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "nemotron_tpu_torch.asr_server", *args,
         "--port", "0", "--http-stats", "0", "--ws-port", "0",
         "--tick-ms", "20"], stderr=subprocess.PIPE, stdout=subprocess.PIPE,
        env=env, cwd=REPO, text=True)
    ports, lines = {}, []
    deadline = time.time() + 120
    while len(ports) < 3 and time.time() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        for key, marker in (("tcp", "listening on "), ("http", "http on "),
                            ("ws", "websocket on ws://")):
            if line.startswith(marker):
                ports[key] = int(line[len(marker):].split()[0].rstrip("/")
                                 .rsplit(":", 1)[1])
    if len(ports) < 3:
        proc.kill()
        raise AssertionError("asr_server did not start: " + "".join(lines))
    threading.Thread(target=proc.stderr.read, daemon=True).start()
    return proc, ports


def test_asr_server_and_client_entry_points(tmp_path):
    """The server module on the CPU with the trained fixture and
    --confidence; asr_client replays a WAV over TCP and a PCM over
    WebSocket and writes SRT/VTT from the FINAL word timings: stdout is
    the in-process engine's transcript, the files are the subtitles of
    its tokens; stdout of the server stays empty."""
    from nemotron_tpu_torch.utils.subtitles import (format_srt, format_vtt,
                                                    words_to_cues)

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    audio, _ = ttones.make_eval_streams(1, 4.0, 16, seed=71)
    pcm = tmp_path / "a.pcm"
    audio[0].astype("<i2").tofile(pcm)
    wav = tmp_path / "a.wav"
    wav.write_bytes(wav_bytes(audio[0]))
    params, cfg, vocab = load_model(FIXTURE, device="cpu")
    cc = TCC(att_right_context=13, n_mels=cfg.n_mels)
    eng = TEngine(params, cfg, vocab, cc, n_slots=1, confidence=True)
    slot = eng.add_stream()
    eng.feed_audio({slot: audio[0]})
    text, toks = eng.finalize_stream(slot, return_tokens=True)
    words = [list(w) for w in tokens_to_words(toks, vocab)]
    proc, ports = start_asr_server(
        [FIXTURE, "--cpu", "--slots", "4", "--confidence"], env)
    try:
        for src, extra, fmt in ((wav, [], "srt"),
                                (pcm, ["--ws"], "vtt")):
            out = tmp_path / f"out.{fmt}"
            port = ports["ws"] if extra else ports["tcp"]
            r = subprocess.run(
                [sys.executable, "-m", "nemotron_tpu_torch.asr_client",
                 f"127.0.0.1:{port}", str(src), "--rate", "max", "--stats",
                 f"--{fmt}", str(out), *extra], capture_output=True,
                timeout=120, env=env, cwd=REPO)
            assert r.returncode == 0, r.stderr.decode()
            assert r.stdout.decode() == text + "\n"
            cues = words_to_cues(words)
            want = (format_srt if fmt == "srt" else format_vtt)(cues)
            assert out.read_text() == want and cues
            assert b"server stats" in r.stderr
    finally:
        proc.send_signal(signal.SIGINT)
        stdout, _ = proc.communicate(timeout=60)
    assert stdout == ""


def test_asr_server_refuses_later_flags(capsys):
    from nemotron_tpu_torch import asr_server

    # --dsp native is ported (tests/test_torch_native.py serves with it):
    # taken, so without --cpu the missing card is the error
    assert asr_server.main(["asr_server", FIXTURE, "--dsp", "native"]) == 1
    err = capsys.readouterr().err
    assert "CUDA" in err and "slice" not in err
    # scripts/asr_server.py has no --coordinator: an unsupported flag
    # (tests/test_torch_multihost.py), not a later slice
    assert asr_server.main(["asr_server", FIXTURE, "--coordinator",
                            "h:1"]) == 1
    err = capsys.readouterr().err
    assert "unsupported flag --coordinator" in err and "slice" not in err
    # --ctc is ported (tests/test_torch_ctc.py serves a hybrid model): on
    # a model without a CTC head the engine refuses it, as JAX's does
    assert asr_server.main(["asr_server", FIXTURE, "--cpu", "--ctc"]) == 1
    err = capsys.readouterr().err
    assert "ctc=True needs a model with a CTC head" in err
    assert "slice" not in err
    assert asr_server.main(["asr_server", FIXTURE, "--bogus"]) == 1
    assert "unsupported flag --bogus" in capsys.readouterr().err
    # the quant-tiers and beam-family flags are ported: taken, the missing
    # model first
    assert asr_server.main(["asr_server", "missing.gguf", "--kv-int4",
                            "--rc-by-layer", "13,6,1,0", "--beam", "4",
                            "--lm", "lm.gguf", "--lm-weight", "0.5",
                            "--refine", "--refine-beam", "2"]) == 1
    err = capsys.readouterr().err
    assert "model file not found" in err and "slice" not in err
    assert asr_server.main(["asr_server", FIXTURE, "--cpu", "--rc-by-layer",
                            "13,6,1"]) == 1
    assert "bad --rc-by-layer pattern" in capsys.readouterr().err
    assert asr_server.main(["asr_server"]) == 1
    assert "--endpoint-silence" in capsys.readouterr().err


# -- on the card ---------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dsp", ["numpy", "device"])
def test_server_on_card_equals_cpu(cuda_device, dsp):
    """The trained tones fixture served from the card over loopback (TCP,
    WebSocket and REST, confidence on, f32, R = 13): each FINAL and the
    REST response carry the CPU engine's tokens (log-posteriors within
    1e-4) and words, and the ticks launch the attention kernel."""
    from nemotron_tpu_torch import client as tclient
    from nemotron_tpu_torch.ops.ring_attn_kernel import fused_ring_attention

    audio, _ = ttones.make_eval_streams(3, 6.0, 16, seed=81)
    results = {}
    for dev in ("cpu", "cuda"):
        params, cfg, vocab = load_model(FIXTURE, device=dev)
        eng = TEngine(params, cfg, vocab,
                      TCC(att_right_context=13, n_mels=cfg.n_mels),
                      n_slots=4, compute_dtype=torch.float32, dsp=dsp,
                      confidence=True)
        before = fused_ring_attention.launches
        results[dev] = serve_and_collect(ASRServer, tclient, eng,
                                         [audio[0], audio[1]], audio[2], [])
        results[dev]["launches"] = fused_ring_attention.launches - before
    for g, w in zip(results["cuda"]["final"], results["cpu"]["final"]):
        assert [t[:2] for t in g["tokens"]] == [t[:2] for t in w["tokens"]]
        assert max(abs(a[2] - b[2]) for a, b in
                   zip(g["tokens"], w["tokens"])) <= 1e-4
        assert g["words"] == w["words"] and g["text"] == w["text"]
    assert results["cuda"]["rest"]["text"] == results["cpu"]["rest"]["text"]
    assert results["cuda"]["launches"] > 0 == results["cpu"]["launches"]
