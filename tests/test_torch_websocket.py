"""The port's copy of the RFC 6455 codec (nemotron_tpu_torch/websocket.py):
every case of tests/test_websocket.py run against it (frame round-trips
across every length class, client masking, fragmented message reassembly,
control-frame interleaving, handshake keys), and frames written by either
package's codec read by the other's."""

import asyncio
import io

import pytest

from nemotron_tpu_torch import websocket as ws


def test_accept_key_rfc_vector():
    # the worked example from RFC 6455 section 1.3
    assert (ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==")
            == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=")


@pytest.mark.parametrize("n", [0, 1, 125, 126, 127, 65535, 65536, 100_001])
@pytest.mark.parametrize("mask", [False, True])
def test_frame_roundtrip_lengths(n, mask):
    payload = bytes(i % 251 for i in range(n))
    raw = ws.encode_frame(ws.OP_BINARY, payload, mask=mask)
    parsed = ws.parse_frame(raw + b"trailing")
    assert parsed is not None
    fin, opcode, masked, out, consumed = parsed
    assert fin and opcode == ws.OP_BINARY and masked == mask
    assert out == payload
    assert consumed == len(raw)


def test_parse_frame_incomplete_returns_none():
    raw = ws.encode_frame(ws.OP_TEXT, b"hello world", mask=True)
    for cut in range(len(raw)):
        assert ws.parse_frame(raw[:cut]) is None


def test_parse_frame_rejects_rsv_bits():
    raw = bytearray(ws.encode_frame(ws.OP_TEXT, b"x"))
    raw[0] |= 0x40
    with pytest.raises(ws.WSProtocolError, match="RSV"):
        ws.parse_frame(bytes(raw))


def test_parse_frame_rejects_oversized_declared_length():
    """The cap fires on the declared length ALONE (before any payload
    arrives) -- otherwise a peer declaring a huge frame makes the caller
    buffer unboundedly waiting for a frame that never completes."""
    hdr = bytes([0x80 | ws.OP_BINARY, 127]) + (1 << 40).to_bytes(8, "big")
    with pytest.raises(ws.WSProtocolError, match="exceeds"):
        ws.parse_frame(hdr, max_bytes=1 << 24)
    # within the cap, an incomplete frame still just returns None
    raw = ws.encode_frame(ws.OP_BINARY, b"abc")
    assert ws.parse_frame(raw[:-1], max_bytes=1 << 24) is None
    fin, op, _m, payload, consumed = ws.parse_frame(raw, max_bytes=1 << 24)
    assert (fin, op, payload, consumed) == (True, ws.OP_BINARY, b"abc",
                                            len(raw))


def _feed_reader(chunks: list[bytes]) -> asyncio.StreamReader:
    reader = asyncio.StreamReader()
    for c in chunks:
        reader.feed_data(c)
    reader.feed_eof()
    return reader


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_read_message_reassembles_fragments():
    # TEXT split in three, with a PING interleaved between fragments
    frames = [
        ws.encode_frame(ws.OP_TEXT, b"hel", mask=True, fin=False),
        ws.encode_frame(ws.OP_PING, b"hb", mask=True),
        ws.encode_frame(ws.OP_CONT, b"lo ", mask=True, fin=False),
        ws.encode_frame(ws.OP_CONT, b"world", mask=True, fin=True),
    ]
    reader = _feed_reader(frames)

    async def drive():
        messages = ws.MessageReader(reader, 1 << 20)
        first = await messages.next()
        second = await messages.next()
        return first, second

    first, second = _run(drive())
    assert first == (ws.OP_PING, b"hb")          # control pops out first
    assert second == (ws.OP_TEXT, b"hello world")


def test_read_message_rejects_unmasked_and_oversize():
    reader = _feed_reader([ws.encode_frame(ws.OP_BINARY, b"xx", mask=False)])
    with pytest.raises(ws.WSProtocolError, match="unmasked"):
        _run(ws.read_message(reader, 1 << 20))

    reader = _feed_reader(
        [ws.encode_frame(ws.OP_BINARY, b"x" * 100, mask=True)])
    with pytest.raises(ws.WSProtocolError, match="limit"):
        _run(ws.read_message(reader, 10))


def test_read_message_rejects_bad_fragmentation():
    # continuation with no message open
    reader = _feed_reader([ws.encode_frame(ws.OP_CONT, b"x", mask=True)])
    with pytest.raises(ws.WSProtocolError, match="continuation"):
        _run(ws.read_message(reader, 1 << 20))
    # a new data frame inside an open fragmented message
    reader = _feed_reader([
        ws.encode_frame(ws.OP_TEXT, b"a", mask=True, fin=False),
        ws.encode_frame(ws.OP_TEXT, b"b", mask=True, fin=True),
    ])
    with pytest.raises(ws.WSProtocolError, match="inside"):
        _run(ws.read_message(reader, 1 << 20))


def test_client_handshake_request_shape():
    req, expect = ws.client_handshake_request("h:1", "/asr")
    text = req.decode("ascii")
    assert text.startswith("GET /asr HTTP/1.1\r\n")
    assert "Sec-WebSocket-Version: 13" in text
    key = [ln.split(": ", 1)[1] for ln in text.split("\r\n")
           if ln.startswith("Sec-WebSocket-Key: ")][0]
    assert ws.accept_key(key) == expect


@pytest.mark.parametrize("n", [0, 5, 126, 70000])
@pytest.mark.parametrize("mask", [False, True])
def test_frames_cross_with_jax_codec(n, mask):
    """A frame encoded by one package's codec parses to the same fields in
    the other's (masked frames carry a random key, so the bytes differ)."""
    from nemotron_tpu import websocket as jws

    payload = bytes((7 * i) % 256 for i in range(n))
    for enc, dec in ((ws, jws), (jws, ws)):
        raw = enc.encode_frame(enc.OP_TEXT, payload, mask=mask, fin=False)
        fin, op, masked, out, consumed = dec.parse_frame(raw)
        assert (fin, op, masked, out, consumed) == (False, dec.OP_TEXT, mask,
                                                    payload, len(raw))
    if not mask:
        assert ws.encode_frame(ws.OP_BINARY, payload) == \
            jws.encode_frame(jws.OP_BINARY, payload)
    req, expect = ws.client_handshake_request("h:1", "/x")
    key = req.decode().split("Sec-WebSocket-Key: ")[1].split("\r\n")[0]
    assert jws.accept_key(key) == expect == ws.accept_key(key)
