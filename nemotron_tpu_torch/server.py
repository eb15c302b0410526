"""Network streaming ASR server over the continuous-batching ServingEngine.

The port's counterpart of `nemotron_tpu/server.py`, over the port's
`streaming.serving.ServingEngine` (RNN-T greedy or beam, with the
two-pass `streaming.refine.SegmentRefiner`). The reference is a single-process
CLI (src/transcribe_stream.cpp:52-198); its serving story ends at
stdin/stdout. This module adds the deployment
piece a production operator needs: an asyncio TCP server that multiplexes
many client audio streams onto one ServingEngine slab, so one fused device
tick serves every connection that has a full chunk buffered (true
continuous batching over the network).

Wire protocol -- length-prefixed frames, binary-safe, big-endian:

    frame := type:u8  length:u32  payload[length]

client -> server:
    0x01 START  JSON options (may be empty / "{}"): reserve a slot.
    0x02 AUDIO  raw s16le 16 kHz mono PCM.
    0x03 END    finalize: flush buffered audio, emit FINAL, free the slot.
    0x04 STATS  request engine statistics.

server -> client:
    0x80 READY   {"slot": n, "chunk_samples": c, "sample_rate": 16000, ...}
    0x81 PARTIAL {"text": t, "replace": r}   incremental transcript; in
                 beam mode hypotheses are revisable, so the full current
                 transcript is resent with replace=true
    0x82 FINAL   {"text": full, "tokens": [[id, frame(, logp)], ...],
                  "words": [[start_s, end_s, word], ...]}  word timings
                 for client-side captions/subtitles (clients cannot
                 detokenize ids themselves)
    0x83 ERROR   {"error": msg}
    0x84 STATS   engine.stats() JSON
    0x85 UTTERANCE {"index": k, "text": t, "tokens": [...]}  one per
                 utterance endpoint, when the engine was built with
                 endpoint_silence_s (greedy only): the slot emitted
                 tokens then stayed silent for the configured span;
                 with a refiner it also carries "refined", the offline
                 beam (+LM) re-decode of the utterance's audio

A connection returns to the idle state after FINAL and may START again.
All engine calls are serialized behind one lock and executed off the event
loop, in the loop's default thread pool (the greedy loop syncs with the
device on every iteration, so a tick blocks its thread for its whole
length; every kernel launch goes to the default CUDA stream from those
threads); the ticker coroutine batches every
connection's staged audio into one feed_audio + step per interval.

HTTP sidecar (http_stats_port): GET /metrics (Prometheus) and GET /stats
(JSON) observability, plus POST /transcribe — a one-shot REST
transcription endpoint (body = WAV at any rate or raw s16le 16 kHz PCM;
response JSON {"text", "tokens", "audio_s", "decode"}). A REST request
is admitted as just another stream on the same slab and drained with the
engine's finalize, so offline requests continuous-batch with the live
streaming connections.

WebSocket transport (ws_port): the same session semantics for browser
clients (which cannot speak raw TCP), over RFC 6455 frames
(nemotron_tpu_torch/websocket.py). Client->server: TEXT frames carry JSON
control ({"type": "start"|"end"|"stats", ...options}); BINARY frames
carry raw s16le PCM. Server->client: TEXT frames with the same JSON
payloads as the TCP protocol plus a "type" field ("ready"/"partial"/
"final"/"error"/"stats"/"utterance"). Both transports multiplex onto the
SAME engine slab and ticker.
"""

from __future__ import annotations

import asyncio
import json
import struct
import sys
import time

import numpy as np

from . import websocket as ws
from .utils.audio import read_audio_bytes
from .utils.subtitles import tokens_to_words

# frame types
T_START = 0x01
T_AUDIO = 0x02
T_END = 0x03
T_STATS = 0x04
T_READY = 0x80
T_PARTIAL = 0x81
T_FINAL = 0x82
T_ERROR = 0x83
T_STATS_R = 0x84
T_UTTERANCE = 0x85

_HDR = struct.Struct("!BI")
MAX_FRAME_BYTES = 1 << 24  # 16 MiB; a frame is at most ~8 min of PCM
# Stage at most this much un-ticked audio per slot before erroring the
# client (a stuck engine otherwise buffers unboundedly).
MAX_PENDING_SECONDS = 300.0


def pack_frame(ftype: int, payload: bytes = b"") -> bytes:
    return _HDR.pack(ftype, len(payload)) + payload


def pack_json(ftype: int, obj: dict) -> bytes:
    # numpy scalars (token ids, latency stats) are not JSON-native
    payload = json.dumps(
        obj, default=lambda o: o.item() if hasattr(o, "item") else str(o))
    return pack_frame(ftype, payload.encode("utf-8"))


async def read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes]:
    hdr = await reader.readexactly(_HDR.size)
    ftype, length = _HDR.unpack(hdr)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {length} bytes exceeds the "
                         f"{MAX_FRAME_BYTES}-byte limit")
    payload = await reader.readexactly(length) if length else b""
    return ftype, payload


class _Conn:
    """Per-connection state. `is_ws` selects the outbound framing: TCP
    length-prefixed frames or WebSocket TEXT frames (same JSON)."""

    __slots__ = ("writer", "slot", "sent_len", "last_text", "pending",
                 "utterances", "is_ws")

    def __init__(self, writer: asyncio.StreamWriter, is_ws: bool = False):
        self.writer = writer
        self.slot: int | None = None
        self.sent_len = 0          # chars of transcript already pushed
        self.last_text = ""        # beam mode: last full transcript sent
        self.pending = 0           # staged-but-unticked samples
        self.utterances = 0        # endpoint events relayed (UTTERANCE idx)
        self.is_ws = is_ws


# WebSocket event names for each server->client frame type (the TCP
# protocol distinguishes events by the u8 type; WS JSON carries it inline)
_WS_EVENT = {T_READY: "ready", T_PARTIAL: "partial", T_FINAL: "final",
             T_ERROR: "error", T_STATS_R: "stats", T_UTTERANCE: "utterance"}


class ASRServer:
    """TCP streaming ASR server around one ServingEngine.

    tick_interval: seconds between engine ticks; defaults to a quarter of
    the chunk's audio duration (the engine masks slots that don't have a
    full chunk yet, so ticking early only costs a no-op check).
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 tick_interval: float | None = None,
                 http_stats_port: int | None = None,
                 ws_port: int | None = None,
                 refiner=None):
        """http_stats_port: additionally serve `GET /metrics`
        (Prometheus text exposition of stats()), `GET /stats` (JSON) and
        `POST /transcribe` (one-shot REST transcription on the same slab)
        on that port — 0 picks an ephemeral port (read back from
        `self.http_stats_port` after start()); None disables.
        ws_port: additionally accept WebSocket clients (browsers) on that
        port — same semantics: 0 ephemeral, None disabled.
        refiner: a streaming.refine.SegmentRefiner for two-pass serving
        (the engine must be built with endpointing and
        keep_segment_audio): each UTTERANCE event then carries a "refined"
        field with the offline beam (+LM) re-decode of its segment."""
        self.engine = engine
        self.refiner = refiner
        if refiner is not None and not getattr(engine, "keep_segment_audio",
                                               False):
            raise ValueError("a refiner needs an engine built with "
                             "keep_segment_audio=True")
        self.host = host
        self.port = port
        self.http_stats_port = http_stats_port
        self.ws_port = ws_port
        if tick_interval is None:
            tick_interval = max(
                0.01, engine.cc.chunk_samples / 16000.0 / 4.0)
        self.tick_interval = tick_interval
        self._lock = asyncio.Lock()        # serializes every engine call
        self._conns: dict[int, _Conn] = {}  # slot -> connection
        self._staged: dict[int, list[np.ndarray]] = {}  # slot -> pcm parts
        self._server: asyncio.base_events.Server | None = None
        self._ticker: asyncio.Task | None = None
        self.started_at = time.time()
        self.connections_total = 0

    def _word_timings(self, toks) -> list | None:
        """Word timings for client-side captions, or None when the engine's
        token frames are not emission-aligned: beam mode refreshes
        transcripts from stored hypotheses whose frames are all 0, so
        every word would get the garbage span [0.0, frame_seconds).
        Clients must treat
        a missing "words" field as "no timings available", not as silence.

        Uses the engine's cc-derived frame clock, matching the
        frame_seconds advertised in HELLO/REST responses."""
        eng = self.engine
        if getattr(eng, "beam_size", 1) > 1:
            return None
        cc = eng.cc
        spf = cc.subsampling_factor * cc.hop_length / cc.sample_rate
        return [list(w) for w in tokens_to_words(
            toks, eng.vocab, seconds_per_frame=spf)]

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._http_server = None
        if self.http_stats_port is not None:
            self._http_server = await asyncio.start_server(
                self._handle_http, self.host, self.http_stats_port)
            self.http_stats_port = \
                self._http_server.sockets[0].getsockname()[1]
        self._ws_server = None
        if self.ws_port is not None:
            self._ws_server = await asyncio.start_server(
                self._handle_ws, self.host, self.ws_port)
            self.ws_port = self._ws_server.sockets[0].getsockname()[1]
        self._ticker = asyncio.get_running_loop().create_task(
            self._tick_loop())

    async def stop(self) -> None:
        if self._ticker is not None:
            self._ticker.cancel()
            try:
                await self._ticker
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if getattr(self, "_http_server", None) is not None:
            self._http_server.close()
            await self._http_server.wait_closed()
        if getattr(self, "_ws_server", None) is not None:
            self._ws_server.close()
            await self._ws_server.wait_closed()
        for conn in list(self._conns.values()):
            conn.writer.close()
        self._conns.clear()
        self._staged.clear()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- engine access (always under lock, off the event loop) -------------

    async def _engine_call(self, fn, *args, **kw):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: fn(*args, **kw))

    # -- the ticker ---------------------------------------------------------

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(self.tick_interval)
            try:
                await self._tick_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 -- keep the server alive
                # an engine failure poisons every stream: surface it to all
                # clients rather than dying silently
                for conn in list(self._conns.values()):
                    self._emit(conn, T_ERROR, {"error": repr(e)})

    async def _tick_once(self) -> None:
        async with self._lock:
            staged, self._staged = self._staged, {}
            if staged:
                feed = {s: np.concatenate(parts) if len(parts) > 1
                        else parts[0] for s, parts in staged.items()}
                await self._engine_call(self.engine.feed_audio, feed)
                for s in feed:
                    if s in self._conns:
                        self._conns[s].pending = 0
            elif not any(c.slot is not None for c in self._conns.values()):
                return
            await self._engine_call(self.engine.step)
            await self._push_partials()
            await self._push_endpoints()

    async def _push_partials(self) -> None:
        """Push transcript growth to every connected slot. Reads the
        engine's accumulated transcripts (rather than step()'s return
        value) so text emitted by internal flushes is never lost."""
        eng = self.engine
        if eng.beam_state is not None:
            await self._engine_call(eng.refresh_transcripts)
        for slot, conn in list(self._conns.items()):
            if conn.slot is None:
                continue
            full = eng.transcripts[slot]
            if eng.beam_state is not None:
                if full != conn.last_text:
                    conn.last_text = full
                    self._emit(conn, T_PARTIAL, {"text": full, "replace": True})
            elif len(full) > conn.sent_len:
                delta = full[conn.sent_len:]
                conn.sent_len = len(full)
                self._emit(conn, T_PARTIAL,
                           {"text": delta, "replace": False})

    async def _push_endpoints(self) -> None:
        """Relay utterance-endpoint events (engines built with
        endpoint_silence_s) to their owning connections, with a
        per-connection utterance index."""
        eng = self.engine
        if getattr(eng, "_ep_frames", None) is None:
            return
        if self.refiner is not None:
            polled = eng.poll_endpoints(with_audio=True)
            # the re-decode is expensive: skip slots whose connection
            # vanished between the endpoint firing and this tick
            live = [ev for ev in polled
                    if ev[0] in self._conns
                    and self._conns[ev[0]].slot is not None]
            refined: list = []
            if live:
                try:
                    refined = await self._engine_call(
                        self.refiner.refine, [seg for *_x, seg in live])
                except Exception as e:  # noqa: BLE001
                    # a refinement failure must never lose the utterance
                    # event: deliver the online greedy text unrefined
                    # (poll_endpoints already drained the engine's queue)
                    print(f"refiner failed ({e!r}); delivering online "
                          "text unrefined", file=sys.stderr, flush=True)
                    refined = [None] * len(live)
            events = [(s, text, toks, r) for (s, text, toks, _seg), r
                      in zip(live, refined)]
        else:
            events = [(s, text, toks, None)
                      for s, text, toks in eng.poll_endpoints()]
        for slot, text, toks, refined_text in events:
            conn = self._conns.get(slot)
            if conn is None or conn.slot is None:
                continue
            payload = {
                "index": conn.utterances,
                "text": text,
                "tokens": [list(t) for t in toks]}
            # word timings [[start_s, end_s, word], ...] so clients can
            # render captions without the vocab (tokens alone are ids;
            # only the server can detokenize); omitted in beam mode
            words = self._word_timings(toks)
            if words is not None:
                payload["words"] = words
            if refined_text is not None:
                payload["refined"] = refined_text
            self._emit(conn, T_UTTERANCE, payload)
            conn.utterances += 1

    # -- HTTP stats (observability sidecar) ----------------------------------

    def _metrics_text(self) -> str:
        """stats() flattened to the Prometheus text exposition format:
        one `nemotron_asr_<key> <value>` line per numeric stat (nested
        dicts joined with '_'). Strings are skipped — Prometheus metrics
        are numbers."""
        lines = []

        def emit(prefix: str, obj) -> None:
            if isinstance(obj, dict):
                for k, v in obj.items():
                    emit(f"{prefix}_{k}", v)
            elif isinstance(obj, bool):
                lines.append(f"{prefix} {int(obj)}")
            elif isinstance(obj, (int, float, np.integer, np.floating)):
                lines.append(f"{prefix} {float(obj):g}")

        emit("nemotron_asr", self.stats())
        return "\n".join(lines) + "\n"

    # POST /transcribe body cap: 64 MiB covers ~5 min of 48 kHz float32
    # stereo WAV and ~35 min of raw s16le 16 kHz.
    MAX_HTTP_BODY = 64 << 20

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """Minimal HTTP/1.0: GET /metrics (Prometheus text exposition),
        GET /stats (JSON), and POST /transcribe (one-shot offline
        transcription: body = WAV or raw s16le 16 kHz PCM, response =
        {"text", "tokens", "audio_s", "decode"}). Anything else is 404.
        One request per connection (Connection: close)."""
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10)
            headers: dict[str, str] = {}
            for _ in range(100):   # drain headers, bounded (no slow-drip)
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
                key, sep, val = line.decode("latin-1").partition(":")
                if sep:
                    headers[key.strip().lower()] = val.strip()
            else:
                writer.close()
                return
            parts = request.decode("latin-1").split()
            method = parts[0] if parts else ""
            path = parts[1] if len(parts) >= 2 else ""
            if method == "GET" and path == "/metrics":
                # stats reads engine state: serialize behind the engine
                # lock, off the event loop, like every other engine call
                async with self._lock:
                    text = await self._engine_call(self._metrics_text)
                body = text.encode()
                ctype = b"text/plain; version=0.0.4"
                status = b"200 OK"
            elif method == "GET" and path == "/stats":
                async with self._lock:
                    st = await self._engine_call(self.stats)
                body = json.dumps(
                    st,
                    default=lambda o: o.item() if hasattr(o, "item")
                    else str(o)).encode()
                ctype = b"application/json"
                status = b"200 OK"
            elif method == "POST" and path == "/transcribe":
                try:
                    body, ctype, status = await self._http_transcribe(
                        reader, headers)
                except (asyncio.TimeoutError, ConnectionError,
                        asyncio.IncompleteReadError):
                    raise
                except Exception as e:  # noqa: BLE001 -- engine failure:
                    # answer 500 instead of dropping the connection
                    body = json.dumps({"error": repr(e)}).encode() + b"\n"
                    ctype = b"application/json"
                    status = b"500 Internal Server Error"
            else:
                body, ctype, status = b"not found\n", b"text/plain", \
                    b"404 Not Found"
            writer.write(b"HTTP/1.0 " + status + b"\r\nContent-Type: "
                         + ctype + b"\r\nContent-Length: "
                         + str(len(body)).encode()
                         + b"\r\nConnection: close\r\n\r\n" + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError,
                asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _http_transcribe(self, reader: asyncio.StreamReader,
                               headers: dict[str, str]
                               ) -> tuple[bytes, bytes, bytes]:
        """One-shot REST transcription: the request is just another stream
        on the same slab (admission -> feed -> finalize), so REST requests
        continuous-batch with live streaming connections; decode mode,
        beam width etc. are the engine's. Returns (body, ctype, status)."""
        def err(status: bytes, msg: str):
            return (json.dumps({"error": msg}).encode() + b"\n",
                    b"application/json", status)

        try:
            length = int(headers.get("content-length", ""))
        except ValueError:
            return err(b"411 Length Required",
                       "POST /transcribe needs a Content-Length body "
                       "(WAV or raw s16le 16 kHz PCM)")
        if length <= 0:
            return err(b"400 Bad Request", "empty audio body")
        if length > self.MAX_HTTP_BODY:
            return err(b"413 Payload Too Large",
                       f"body of {length} bytes exceeds the "
                       f"{self.MAX_HTTP_BODY}-byte limit")
        data = await asyncio.wait_for(reader.readexactly(length), timeout=60)
        try:
            pcm = np.ascontiguousarray(read_audio_bytes(data))
        except ValueError as e:
            return err(b"400 Bad Request", str(e))
        async with self._lock:
            try:
                slot = await self._engine_call(self.engine.add_stream)
            except RuntimeError as e:        # slab full
                return err(b"503 Service Unavailable", str(e))
            try:
                if pcm.size:
                    await self._engine_call(self.engine.feed_audio,
                                            {slot: pcm})
                text, toks = await self._engine_call(
                    self.engine.finalize_stream, slot, return_tokens=True)
            except Exception:
                # never leak the slot; finalize (no audio left) frees it
                if self.engine.active[slot]:
                    await self._engine_call(self.engine.remove_stream, slot)
                raise
            # finalize's internal steps may have advanced live streams too
            await self._push_partials()
        eng = self.engine
        cc = eng.cc
        rest_payload = {
            "text": text,
            "tokens": [list(t) for t in toks],
            "audio_s": pcm.size / 16000.0,
            "frame_seconds": (cc.subsampling_factor * cc.hop_length
                              / cc.sample_rate),
            "decode": ("ctc" if getattr(eng, "ctc", False)
                       else "tdt" if getattr(eng, "tdt", False)
                       else "beam" if eng.beam_size > 1 else "greedy"),
        }
        words = self._word_timings(toks)
        if words is not None:
            rest_payload["words"] = words
        body = json.dumps(
            rest_payload,
            default=lambda o: o.item() if hasattr(o, "item") else str(o))
        return body.encode() + b"\n", b"application/json", b"200 OK"

    # -- per-connection protocol -------------------------------------------

    # a client that stops reading otherwise grows the write buffer without
    # bound while its slot keeps emitting partials
    MAX_WRITE_BUFFER = 8 << 20

    def _send(self, writer: asyncio.StreamWriter, data: bytes) -> None:
        if writer.is_closing():
            return
        if writer.transport.get_write_buffer_size() > self.MAX_WRITE_BUFFER:
            writer.close()      # slow consumer: drop; cleanup frees the slot
            return
        writer.write(data)

    def _emit(self, conn: _Conn, ftype: int, obj: dict) -> None:
        """One server->client event, framed for the connection's
        transport: TCP length-prefixed JSON, or a WebSocket TEXT frame
        with the event name inlined as "type"."""
        if conn.is_ws:
            # event name LAST so no payload key can clobber it
            payload = json.dumps(
                {**obj, "type": _WS_EVENT[ftype]},
                default=lambda o: o.item() if hasattr(o, "item") else str(o))
            self._send(conn.writer,
                       ws.encode_frame(ws.OP_TEXT, payload.encode("utf-8")))
        else:
            self._send(conn.writer, pack_json(ftype, obj))

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.connections_total += 1
        conn = _Conn(writer)
        try:
            while True:
                try:
                    ftype, payload = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if ftype == T_START:
                    await self._on_start(conn, payload)
                elif ftype == T_AUDIO:
                    await self._on_audio(conn, payload)
                elif ftype == T_END:
                    await self._on_end(conn)
                elif ftype == T_STATS:
                    st = await self._engine_call(self.stats)
                    self._send(writer, pack_json(T_STATS_R, st))
                else:
                    self._send(writer, pack_json(
                        T_ERROR, {"error": f"unknown frame type {ftype}"}))
                await writer.drain()
        except ValueError as e:
            self._send(writer, pack_json(T_ERROR, {"error": str(e)}))
        finally:
            await self._cleanup_conn(conn)
            writer.close()

    async def _cleanup_conn(self, conn: _Conn) -> None:
        """Drop the slot of a connection that vanished mid-stream."""
        if conn.slot is not None:
            async with self._lock:
                slot, conn.slot = conn.slot, None
                self._conns.pop(slot, None)
                self._staged.pop(slot, None)
                if self.engine.active[slot]:
                    await self._engine_call(
                        self.engine.remove_stream, slot)

    async def _handle_ws(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        """One WebSocket client: RFC 6455 upgrade, then TEXT frames for
        JSON control ({"type": "start"|"end"|"stats", ...}) and BINARY
        frames for s16le PCM. Outbound events go through _emit as TEXT
        frames. The session semantics are identical to the TCP path —
        both transports share _on_start/_on_audio/_on_end and the slab."""
        self.connections_total += 1
        conn = _Conn(writer, is_ws=True)
        try:
            if not await ws.server_handshake(reader, writer):
                return
            messages = ws.MessageReader(reader, MAX_FRAME_BYTES)
            while True:
                try:
                    opcode, payload = await messages.next()
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if opcode == ws.OP_CLOSE:
                    # echo the close (status code payload, if any) per
                    # §5.5.1; a close payload must be 0 or >=2 bytes, so a
                    # malformed 1-byte payload is echoed as empty
                    self._send(writer,
                               ws.encode_frame(
                                   ws.OP_CLOSE,
                                   payload[:2] if len(payload) >= 2 else b""))
                    break
                if opcode == ws.OP_PING:
                    self._send(writer, ws.encode_frame(ws.OP_PONG, payload))
                elif opcode == ws.OP_PONG:
                    pass
                elif opcode == ws.OP_BINARY:
                    await self._on_audio(conn, payload)
                elif opcode == ws.OP_TEXT:
                    try:
                        msg = json.loads(payload.decode("utf-8"))
                        mtype = msg.pop("type")
                    except (UnicodeDecodeError, json.JSONDecodeError,
                            KeyError, AttributeError):
                        self._emit(conn, T_ERROR, {
                            "error": "control message must be JSON with "
                                     "a \"type\" field"})
                        await writer.drain()
                        continue
                    if mtype == "start":
                        await self._on_start(
                            conn, json.dumps(msg).encode("utf-8"))
                    elif mtype == "end":
                        await self._on_end(conn)
                    elif mtype == "stats":
                        st = await self._engine_call(self.stats)
                        self._emit(conn, T_STATS_R, st)
                    else:
                        self._emit(conn, T_ERROR, {
                            "error": f"unknown control type {mtype!r}"})
                else:
                    self._emit(conn, T_ERROR, {
                        "error": f"unsupported WS opcode {opcode}"})
                await writer.drain()
        except ws.WSProtocolError as e:
            self._emit(conn, T_ERROR, {"error": str(e)})
        finally:
            await self._cleanup_conn(conn)
            writer.close()

    async def _on_start(self, conn: _Conn, payload: bytes) -> None:
        if conn.slot is not None:
            self._emit(conn, T_ERROR, {"error": "stream already started"})
            return
        if payload:
            try:
                json.loads(payload.decode("utf-8"))  # reserved for options
            except (UnicodeDecodeError, json.JSONDecodeError):
                self._emit(conn, T_ERROR,
                           {"error": "START payload is not JSON"})
                return
        async with self._lock:
            try:
                slot = await self._engine_call(self.engine.add_stream)
            except RuntimeError as e:          # slab full
                self._emit(conn, T_ERROR, {"error": str(e)})
                return
            conn.slot = slot
            conn.sent_len = 0
            conn.last_text = ""
            conn.pending = 0
            conn.utterances = 0
            self._conns[slot] = conn
        cc = self.engine.cc
        self._emit(conn, T_READY, {
            "slot": slot,
            "sample_rate": 16000,
            "chunk_samples": cc.chunk_samples,
            "shift_samples": cc.shift_samples,
            # FINAL/UTTERANCE token frames -> seconds scale (one encoder
            # frame = subsampling * hop samples; 80 ms at the standard
            # geometry), so clients can compute word timestamps without
            # knowing the model geometry
            "frame_seconds": (cc.subsampling_factor * cc.hop_length
                              / cc.sample_rate),
            "beam": self.engine.beam_size,
            "confidence": bool(self.engine.confidence),
            "decode": ("ctc" if getattr(self.engine, "ctc", False)
                       else "tdt" if getattr(self.engine, "tdt", False)
                       else "beam" if self.engine.beam_size > 1
                       else "greedy"),
            "endpointing": getattr(self.engine, "_ep_frames", None)
            is not None,
            "refined": self.refiner is not None,
        })

    async def _on_audio(self, conn: _Conn, payload: bytes) -> None:
        if conn.slot is None:
            self._emit(conn, T_ERROR, {"error": "AUDIO before START"})
            return
        if len(payload) % 2:
            self._emit(conn, T_ERROR,
                       {"error": "odd-length PCM payload (s16le)"})
            return
        pcm = np.frombuffer(payload, np.int16)
        # check-before-count: a rejected burst must not inflate `pending`
        # (it is never staged, so nothing would ever reset the counter and
        # the slot would refuse audio forever)
        if conn.pending + pcm.size > MAX_PENDING_SECONDS * 16000:
            self._emit(conn, T_ERROR, {
                "error": f"over {MAX_PENDING_SECONDS:.0f} s of audio "
                         "staged and unprocessed; slow down"})
            return
        conn.pending += pcm.size
        self._staged.setdefault(conn.slot, []).append(pcm)

    async def _on_end(self, conn: _Conn) -> None:
        if conn.slot is None:
            self._emit(conn, T_ERROR, {"error": "END before START"})
            return
        async with self._lock:
            slot, conn.slot = conn.slot, None
            self._conns.pop(slot, None)
            parts = self._staged.pop(slot, None)
            if parts:
                feed = {slot: np.concatenate(parts) if len(parts) > 1
                        else parts[0]}
                await self._engine_call(self.engine.feed_audio, feed)
            text, toks = await self._engine_call(
                self.engine.finalize_stream, slot, return_tokens=True)
            # finalize's internal steps may have advanced OTHER slots too
            await self._push_partials()
        final_payload = {
            "text": text,
            "tokens": [list(t) for t in toks],
        }
        # word timings for client-side captions (see UTTERANCE); omitted
        # in beam mode where frames are not emission-aligned
        words = self._word_timings(toks)
        if words is not None:
            final_payload["words"] = words
        self._emit(conn, T_FINAL, final_payload)

    def stats(self) -> dict:
        st = dict(self.engine.stats())
        st["connections"] = len(self._conns)
        st["connections_total"] = self.connections_total
        st["uptime_s"] = time.time() - self.started_at
        # audio accepted but not yet fed to the engine (drained by the
        # ticker); lets clients/tests see backpressure instead of guessing
        st["staged_samples"] = sum(
            sum(p.size for p in parts) for parts in self._staged.values())
        return st
