"""Minimal RFC 6455 WebSocket codec (stdlib-only, server + client side).

The port's own copy of `nemotron_tpu/websocket.py`.

Why this exists: the TCP wire protocol (server.py) is the efficient path
for backend feed pipelines, but the canonical consumer of a streaming ASR
service is a browser, and browsers can only speak WebSocket. This module
implements exactly the subset the ASR server needs — HTTP/1.1 upgrade
handshake, frame encode/decode with client masking, fragmented-message
reassembly, ping/pong, close — with no external dependencies (the image
ships no websockets/aiohttp; the reference has no network serving at all,
src/transcribe_stream.cpp is stdin/stdout only).

Framing (RFC 6455 §5.2): FIN|rsv|opcode byte, MASK|len7 byte, extended
length (16/64-bit big-endian), 4-byte mask key if masked, payload XOR'd
with the repeating key. Client->server frames MUST be masked; the server
rejects unmasked ones (§5.1), and server->client frames are never masked.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import struct

import numpy as np

# opcodes (RFC 6455 §5.2)
OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"   # RFC 6455 §1.3


class WSProtocolError(ValueError):
    pass


def accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key (§4.2.2)."""
    digest = hashlib.sha1((client_key + _GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _mask_bytes(payload: bytes, key: bytes) -> bytes:
    """XOR payload with the repeating 4-byte key (vectorized: audio
    frames are ~100 KB and a Python byte loop would dominate the tick)."""
    if not payload:
        return payload
    data = np.frombuffer(payload, np.uint8)
    mask = np.frombuffer((key * (len(payload) // 4 + 1))[:len(payload)],
                         np.uint8)
    return (data ^ mask).tobytes()


def encode_frame(opcode: int, payload: bytes, mask: bool = False,
                 fin: bool = True) -> bytes:
    """One frame. Servers send mask=False, clients mask=True (§5.1)."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        head.append(mbit | n)
    elif n < (1 << 16):
        head.append(mbit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(mbit | 127)
        head += struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        return bytes(head) + key + _mask_bytes(payload, key)
    return bytes(head) + payload


def parse_frame(buf: bytes, max_bytes: int | None = None
                ) -> tuple[bool, int, bool, bytes, int] | None:
    """Parse one frame from the head of `buf`.

    Returns (fin, opcode, masked, payload, bytes_consumed), or None if the
    buffer does not yet hold a complete frame. Used by the blocking client
    (client.py pumps a socket into a buffer); the asyncio server side uses
    read_frame() instead. `max_bytes` rejects a frame from its declared
    length alone (same role as read_frame's cap) — without it a peer
    declaring a huge length would make the caller buffer unboundedly
    waiting for a frame that never completes.
    """
    if len(buf) < 2:
        return None
    b0, b1 = buf[0], buf[1]
    if b0 & 0x70:
        raise WSProtocolError("nonzero RSV bits (no extension negotiated)")
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    masked, ln = bool(b1 & 0x80), b1 & 0x7F
    pos = 2
    if ln == 126:
        if len(buf) < pos + 2:
            return None
        ln = struct.unpack_from("!H", buf, pos)[0]
        pos += 2
    elif ln == 127:
        if len(buf) < pos + 8:
            return None
        ln = struct.unpack_from("!Q", buf, pos)[0]
        pos += 8
    if max_bytes is not None and ln > max_bytes:
        raise WSProtocolError(
            f"frame of {ln} bytes exceeds the {max_bytes}-byte limit")
    key = b""
    if masked:
        if len(buf) < pos + 4:
            return None
        key = buf[pos:pos + 4]
        pos += 4
    if len(buf) < pos + ln:
        return None
    payload = buf[pos:pos + ln]
    if masked:
        payload = _mask_bytes(payload, key)
    return fin, opcode, masked, payload, pos + ln


async def read_frame(reader: asyncio.StreamReader,
                     max_bytes: int) -> tuple[bool, int, bool, bytes]:
    """Read exactly one frame from an asyncio stream (server side)."""
    b0, b1 = await reader.readexactly(2)
    if b0 & 0x70:
        raise WSProtocolError("nonzero RSV bits (no extension negotiated)")
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    masked, ln = bool(b1 & 0x80), b1 & 0x7F
    if ln == 126:
        ln = struct.unpack("!H", await reader.readexactly(2))[0]
    elif ln == 127:
        ln = struct.unpack("!Q", await reader.readexactly(8))[0]
    if ln > max_bytes:
        raise WSProtocolError(
            f"frame of {ln} bytes exceeds the {max_bytes}-byte limit")
    key = await reader.readexactly(4) if masked else b""
    payload = await reader.readexactly(ln) if ln else b""
    if masked:
        payload = _mask_bytes(payload, key)
    return fin, opcode, masked, payload


class MessageReader:
    """Message-level reader (server side): reassembles fragmented data
    messages; control frames (ping/pong/close) are returned immediately —
    they may interleave with an open fragmented message (§5.4) and are
    never fragmented themselves (§5.5), so the assembly state must
    SURVIVE a control-frame return (it lives on the instance, not in
    locals). Enforces §5.1: every client->server frame must be masked."""

    def __init__(self, reader: asyncio.StreamReader, max_bytes: int):
        self._reader = reader
        self._max = max_bytes
        self._opcode: int | None = None   # open fragmented message, if any
        self._parts: list[bytes] = []
        self._total = 0

    async def next(self) -> tuple[int, bytes]:
        while True:
            fin, opcode, masked, payload = await read_frame(
                self._reader, self._max)
            if opcode in (OP_CLOSE, OP_PING, OP_PONG):
                if not fin:
                    raise WSProtocolError("fragmented control frame")
                return opcode, payload
            if not masked:
                raise WSProtocolError("unmasked client frame")
            if opcode == OP_CONT:
                if self._opcode is None:
                    raise WSProtocolError(
                        "continuation with no message open")
            else:
                if self._opcode is not None:
                    raise WSProtocolError(
                        "new data frame inside a fragmented message")
                self._opcode = opcode
            self._parts.append(payload)
            self._total += len(payload)
            if self._total > self._max:
                raise WSProtocolError(
                    f"message over the {self._max}-byte limit")
            if fin:
                opcode0 = self._opcode
                msg = b"".join(self._parts)
                self._opcode, self._parts, self._total = None, [], 0
                return opcode0, msg


async def read_message(reader: asyncio.StreamReader,
                       max_bytes: int) -> tuple[int, bytes]:
    """One-shot convenience over MessageReader (no fragment state carried
    between calls — use MessageReader for a connection loop)."""
    return await MessageReader(reader, max_bytes).next()


async def server_handshake(reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           timeout: float = 10.0) -> bool:
    """Read the HTTP/1.1 upgrade request and answer 101 (§4.2).

    Returns True on success; on a malformed request writes a plain HTTP
    error and returns False (caller closes). Bounded reads: no slow-drip.
    """
    try:
        request = await asyncio.wait_for(reader.readline(), timeout)
        headers: dict[str, str] = {}
        for _ in range(100):
            line = await asyncio.wait_for(reader.readline(), timeout)
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        else:
            return False
    except (asyncio.TimeoutError, ConnectionError):
        return False
    parts = request.decode("latin-1").split()
    key = headers.get("sec-websocket-key", "")
    if (len(parts) < 3 or parts[0] != "GET"
            or "websocket" not in headers.get("upgrade", "").lower()
            or not key):
        writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n"
                     b"Connection: close\r\n\r\n")
        try:
            await writer.drain()
        except ConnectionError:
            pass
        return False
    writer.write(
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\n"
        b"Connection: Upgrade\r\n"
        b"Sec-WebSocket-Accept: " + accept_key(key).encode("ascii")
        + b"\r\n\r\n")
    await writer.drain()
    return True


def client_handshake_request(host: str, path: str = "/") -> tuple[bytes,
                                                                  str]:
    """(request bytes, expected Sec-WebSocket-Accept) for a client."""
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    req = (f"GET {path} HTTP/1.1\r\n"
           f"Host: {host}\r\n"
           "Upgrade: websocket\r\n"
           "Connection: Upgrade\r\n"
           f"Sec-WebSocket-Key: {key}\r\n"
           "Sec-WebSocket-Version: 13\r\n\r\n").encode("ascii")
    return req, accept_key(key)
