"""Blocking client for the ASRServer wire protocol (see server.py).

The port's counterpart of `nemotron_tpu/client.py`, over the port's own
server constants and WebSocket codec.

Small and dependency-free on purpose: operators embed this in feed
pipelines; tests drive the server with it. The socket is read
opportunistically on every send so PARTIAL events arrive while audio is
still streaming.
"""

from __future__ import annotations

import json
import socket
import struct

import numpy as np

from .server import (MAX_FRAME_BYTES, T_AUDIO, T_END, T_ERROR, T_FINAL,
                     T_PARTIAL, T_READY, T_START, T_STATS, T_STATS_R,
                     T_UTTERANCE, _WS_EVENT, pack_frame)

_HDR = struct.Struct("!BI")


class ASRServerError(RuntimeError):
    pass


class ASRClient:
    """One streaming session over TCP.

    Usage:
        c = ASRClient(host, port)
        info = c.start()
        c.send_audio(pcm_chunk)        # any chunking; s16le np.int16
        ...
        final = c.end()                # blocks until the FINAL event
        print(final["text"], c.transcript)
    """

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.timeout = timeout
        self._rbuf = b""
        self.events: list[tuple[int, dict]] = []  # every event received
        self.transcript = ""     # running transcript from PARTIAL events
        self.utterances: list[dict] = []  # UTTERANCE endpoint events

    # -- framing -------------------------------------------------------------

    def _sendall(self, data: bytes) -> None:
        # pump() leaves the socket non-blocking (settimeout(0.0)); sendall
        # on a non-blocking socket raises BlockingIOError mid-frame when
        # the kernel buffer fills, corrupting the stream — restore the
        # blocking timeout for every send
        self.sock.settimeout(self.timeout)
        self.sock.sendall(data)

    def _send(self, ftype: int, payload: bytes = b"") -> None:
        self._sendall(pack_frame(ftype, payload))

    def _recv_some(self, blocking: bool) -> bool:
        """Pull whatever bytes are available; returns False on EOF."""
        self.sock.settimeout(self.timeout if blocking else 0.0)
        try:
            data = self.sock.recv(1 << 16)
        except (BlockingIOError, socket.timeout) as e:
            if blocking and isinstance(e, socket.timeout):
                raise TimeoutError("server response timed out") from e
            return True
        if not data:
            return False
        self._rbuf += data
        return True

    def _pop_frame(self) -> tuple[int, bytes] | None:
        if len(self._rbuf) < _HDR.size:
            return None
        ftype, length = _HDR.unpack_from(self._rbuf)
        end = _HDR.size + length
        if len(self._rbuf) < end:
            return None
        payload = self._rbuf[_HDR.size:end]
        self._rbuf = self._rbuf[end:]
        return ftype, payload

    def _handle(self, ftype: int, payload: bytes) -> dict:
        obj = json.loads(payload.decode("utf-8")) if payload else {}
        self.events.append((ftype, obj))
        if ftype == T_PARTIAL:
            if obj.get("replace"):
                self.transcript = obj["text"]
            else:
                self.transcript += obj["text"]
        elif ftype == T_FINAL:
            self.transcript = obj["text"]
        elif ftype == T_UTTERANCE:
            self.utterances.append(obj)
        return obj

    def pump(self) -> None:
        """Drain every event currently available, without blocking."""
        while True:
            frame = self._pop_frame()
            if frame is None:
                if not self._recv_some(blocking=False):
                    return
                frame = self._pop_frame()
                if frame is None:
                    return
            self._handle(*frame)

    def _wait_for(self, want: int) -> dict:
        """Block until a frame of type `want` arrives; ERROR raises."""
        while True:
            frame = self._pop_frame()
            if frame is None:
                if not self._recv_some(blocking=True):
                    raise ConnectionError("server closed the connection")
                continue
            ftype, payload = frame
            obj = self._handle(ftype, payload)
            if ftype == T_ERROR:
                raise ASRServerError(obj.get("error", "unknown error"))
            if ftype == want:
                return obj

    # -- protocol ------------------------------------------------------------

    def start(self, **options) -> dict:
        self._send(T_START,
                   json.dumps(options).encode("utf-8") if options else b"")
        return self._wait_for(T_READY)

    def send_audio(self, pcm) -> None:
        if isinstance(pcm, np.ndarray):
            pcm = np.ascontiguousarray(pcm, np.int16).tobytes()
        self._send(T_AUDIO, pcm)
        self.pump()

    def end(self) -> dict:
        """Finalize the stream; returns the FINAL event
        {"text": ..., "tokens": [[id, frame(, logp)], ...]}."""
        self._send(T_END)
        return self._wait_for(T_FINAL)

    def stats(self) -> dict:
        self._send(T_STATS)
        return self._wait_for(T_STATS_R)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- WebSocket variant --------------------------------------------------------

_WS_SEND = {T_START: "start", T_END: "end", T_STATS: "stats"}
# derived from the server's own event-name map so a new server event can
# never silently desync this client
_WS_RECV = {name: ftype for ftype, name in _WS_EVENT.items()}


class WSASRClient(ASRClient):
    """The same session surface over the server's WebSocket transport
    (ASRServer(ws_port=...)). Browsers speak this natively; this blocking
    Python client exists for tests and feed pipelines that want one
    protocol everywhere. Control goes as masked TEXT frames
    ({"type": "start"|"end"|"stats", ...}), audio as masked BINARY frames;
    events arrive as TEXT JSON with a "type" field, mapped back onto the
    shared ASRClient event machinery."""

    def __init__(self, host: str, port: int, timeout: float = 120.0,
                 path: str = "/"):
        super().__init__(host, port, timeout=timeout)
        from . import websocket as ws
        self._ws = ws
        req, expect = ws.client_handshake_request(f"{host}:{port}", path)
        self.sock.sendall(req)
        # read the HTTP response head; anything past it is WS frames
        head = b""
        self.sock.settimeout(timeout)
        while b"\r\n\r\n" not in head:
            data = self.sock.recv(1 << 16)
            if not data:
                raise ConnectionError("server closed during WS handshake")
            head += data
            if len(head) > (1 << 16):
                raise ValueError("oversized WS handshake response")
        head, _, rest = head.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        if " 101 " not in lines[0] + " ":
            raise ConnectionError(f"WS upgrade refused: {lines[0]}")
        accept = ""
        for ln in lines[1:]:
            name, _, value = ln.partition(":")
            if name.strip().lower() == "sec-websocket-accept":
                accept = value.strip()
        if accept != expect:
            raise ConnectionError("bad Sec-WebSocket-Accept")
        self._rbuf = rest

    def _send(self, ftype: int, payload: bytes = b"") -> None:
        ws = self._ws
        if ftype == T_AUDIO:
            frame = ws.encode_frame(ws.OP_BINARY, payload, mask=True)
        else:
            obj = json.loads(payload.decode("utf-8")) if payload else {}
            obj["type"] = _WS_SEND[ftype]
            frame = ws.encode_frame(
                ws.OP_TEXT, json.dumps(obj).encode("utf-8"), mask=True)
        self._sendall(frame)

    def _pop_frame(self) -> tuple[int, bytes] | None:
        ws = self._ws
        while True:
            res = ws.parse_frame(self._rbuf, MAX_FRAME_BYTES)
            if res is None:
                return None
            fin, opcode, _masked, payload, consumed = res
            if not fin:
                raise ValueError("fragmented server frame (server never "
                                 "fragments)")
            self._rbuf = self._rbuf[consumed:]
            if opcode == ws.OP_PING:
                self._sendall(
                    ws.encode_frame(ws.OP_PONG, payload, mask=True))
                continue
            if opcode == ws.OP_CLOSE:
                raise ConnectionError("server closed the WebSocket")
            if opcode != ws.OP_TEXT:
                continue
            obj = json.loads(payload.decode("utf-8"))
            ftype = _WS_RECV.get(obj.pop("type"))
            if ftype is None:
                continue   # unknown event from a newer server: skip
            # re-encode without "type" so the shared _handle sees exactly
            # the TCP-protocol payload
            return ftype, json.dumps(obj).encode("utf-8")
