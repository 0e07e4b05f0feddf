"""Minimal stdlib RFC 6455 WebSocket server glue for the viewer (a copy of
``ray_tracer_2_tpu/viewer/ws.py``, which imports nothing of JAX either).

The reference viewer gets sub-frame input latency for free from winit's
in-process event queue (src/core/app.rs:172-272). The browser equivalent of
an in-process queue is a WebSocket: one persistent TCP connection instead of
a POST request (connection + headers + body + response) per input event.
This module implements just enough of RFC 6455 for that: the HTTP upgrade
handshake, client->server masked text frames, server->client unmasked text
frames, and ping/pong/close control frames. No extensions, no fragmented
messages beyond reassembly, no binary payloads — the viewer only ever sends
small JSON strings.

Runs inside a ThreadingHTTPServer handler thread (the PNG push stream
already uses the same long-lived-handler pattern).
"""
from __future__ import annotations

import base64
import hashlib
import struct

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BIN = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


class WebSocket:
    """A handshaken WebSocket over a raw socket file pair."""

    def __init__(self, rfile, wfile):
        self.rfile = rfile
        self.wfile = wfile
        self.open = True

    # --------------------------------------------------------------- send
    def send_text(self, payload: str) -> None:
        data = payload.encode()
        header = bytes([0x80 | OP_TEXT])
        n = len(data)
        if n < 126:
            header += bytes([n])
        elif n < (1 << 16):
            header += bytes([126]) + struct.pack(">H", n)
        else:
            header += bytes([127]) + struct.pack(">Q", n)
        self.wfile.write(header + data)
        self.wfile.flush()

    def _send_control(self, op: int, data: bytes = b"") -> None:
        self.wfile.write(bytes([0x80 | op, len(data)]) + data)
        self.wfile.flush()

    def close(self) -> None:
        if self.open:
            try:
                self._send_control(OP_CLOSE)
            except OSError:
                pass
            self.open = False

    # --------------------------------------------------------------- recv
    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.rfile.read(n - len(buf))
            if not chunk:
                raise ConnectionResetError("websocket closed")
            buf += chunk
        return buf

    def recv_text(self) -> str | None:
        """Next complete text message, transparently answering pings.
        Returns None when the peer closes."""
        message = b""
        while True:
            b0, b1 = self._read_exact(2)
            fin = b0 & 0x80
            op = b0 & 0x0F
            masked = b1 & 0x80
            n = b1 & 0x7F
            if n == 126:
                n = struct.unpack(">H", self._read_exact(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", self._read_exact(8))[0]
            if n > (1 << 20):  # viewer messages are tiny; refuse abuse
                raise ConnectionResetError("oversized websocket frame")
            mask = self._read_exact(4) if masked else b"\x00" * 4
            payload = self._read_exact(n)
            if masked:
                payload = bytes(c ^ mask[i % 4]
                                for i, c in enumerate(payload))
            if op == OP_CLOSE:
                self.open = False
                return None
            if op == OP_PING:
                self._send_control(OP_PONG, payload)
                continue
            if op == OP_PONG:
                continue
            if op in (OP_TEXT, OP_CONT, OP_BIN):
                message += payload
                if fin:
                    return message.decode("utf-8", errors="replace")


def upgrade(handler) -> WebSocket | None:
    """Perform the server handshake on a BaseHTTPRequestHandler whose
    request carried ``Upgrade: websocket``. Returns None (and sends 400)
    if the request is not a valid upgrade."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if (handler.headers.get("Upgrade", "").lower() != "websocket"
            or key is None):
        handler.send_response(400)
        handler.end_headers()
        return None
    handler.send_response_only(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.wfile.flush()
    return WebSocket(handler.rfile, handler.wfile)
