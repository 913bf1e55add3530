"""Minimal RFC 6455 websocket client — the transport under the streaming
Speech SDK transformer (services/speech.py SpeechToTextSDK).

The reference ships Microsoft's Speech SDK native websocket stack
(cognitive/.../services/speech/SpeechToTextSDK.scala); this is a dependency-
free client implementing the pieces that protocol needs: the HTTP Upgrade
handshake, client-masked text/binary frames (FIN-only, no fragmentation on
send), ping/pong, and close. The socket is injectable so tests drive the full
protocol against an in-process fake server (SURVEY §4.6 fake-backend style).

The port's copy of the JAX package's ``io/websocket.py``.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import ssl
import struct
from typing import Dict, Optional, Tuple
from urllib.parse import urlparse

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


class WebSocketError(RuntimeError):
    pass


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WebSocketError("connection closed mid-frame")
        buf += chunk
    return buf


def encode_frame(opcode: int, payload: bytes, mask: bool = True,
                 fin: bool = True) -> bytes:
    """One websocket frame (client frames are masked per RFC 6455 §5.3)."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < (1 << 16):
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def decode_frame(sock) -> Tuple[int, bool, bytes]:
    """Read one frame → (opcode, fin, payload). Unmasks if masked."""
    b0, b1 = _recv_exact(sock, 2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack(">H", _recv_exact(sock, 2))[0]
    elif n == 127:
        n = struct.unpack(">Q", _recv_exact(sock, 8))[0]
    key = _recv_exact(sock, 4) if masked else None
    payload = _recv_exact(sock, n) if n else b""
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, fin, payload


class WebSocketClient:
    """Client connection. ``sock`` may be injected (tests / custom
    transports); otherwise TCP (+TLS for wss) is opened from the url."""

    def __init__(self, url: str, headers: Optional[Dict[str, str]] = None,
                 sock=None, timeout: float = 30.0):
        self.url = url
        u = urlparse(url)
        self.host = u.hostname or "localhost"
        self.port = u.port or (443 if u.scheme == "wss" else 80)
        self.resource = (u.path or "/") + (f"?{u.query}" if u.query else "")
        self.headers = dict(headers or {})
        self._sock = sock
        self.timeout = timeout
        self._open = False

    def connect(self) -> "WebSocketClient":
        if self._sock is None:
            raw = socket.create_connection((self.host, self.port),
                                           timeout=self.timeout)
            if self.url.startswith("wss"):
                raw = ssl.create_default_context().wrap_socket(
                    raw, server_hostname=self.host)
            self._sock = raw
        key = base64.b64encode(os.urandom(16)).decode()
        lines = [f"GET {self.resource} HTTP/1.1",
                 f"Host: {self.host}:{self.port}",
                 "Upgrade: websocket", "Connection: Upgrade",
                 f"Sec-WebSocket-Key: {key}", "Sec-WebSocket-Version: 13"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        self._sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        # read the 101 response
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise WebSocketError("handshake: connection closed")
            resp += chunk
        status = resp.split(b"\r\n", 1)[0].decode()
        if " 101 " not in status + " ":
            raise WebSocketError(f"handshake rejected: {status}")
        accept_expected = base64.b64encode(hashlib.sha1(
            (key + _GUID).encode()).digest()).decode()
        for line in resp.split(b"\r\n"):
            if line.lower().startswith(b"sec-websocket-accept:"):
                got = line.split(b":", 1)[1].strip().decode()
                if got != accept_expected:
                    raise WebSocketError("handshake: bad Sec-WebSocket-Accept")
        self._open = True
        return self

    def send_text(self, text: str) -> None:
        self._sock.sendall(encode_frame(OP_TEXT, text.encode()))

    def send_binary(self, payload: bytes) -> None:
        self._sock.sendall(encode_frame(OP_BINARY, payload))

    def recv(self) -> Tuple[int, bytes]:
        """Next data frame → (opcode, payload). Answers pings; reassembles
        fragmented messages; raises on close."""
        msg = b""
        op_first = None
        while True:
            opcode, fin, payload = decode_frame(self._sock)
            if opcode == OP_PING:
                self._sock.sendall(encode_frame(OP_PONG, payload))
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self._open = False
                raise WebSocketError("closed by peer")
            if opcode in (OP_TEXT, OP_BINARY):
                op_first = opcode if op_first is None else op_first
                msg += payload
            elif opcode == OP_CONT:
                msg += payload
            if fin:
                return op_first if op_first is not None else opcode, msg

    def close(self) -> None:
        if self._open and self._sock is not None:
            try:
                self._sock.sendall(encode_frame(OP_CLOSE, b""))
            except OSError:
                pass
        self._open = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self.connect() if not self._open else self

    def __exit__(self, *exc):
        self.close()


def server_handshake(sock) -> Dict[str, str]:
    """Server side of the Upgrade handshake (used by the in-process fake
    Speech server in tests). Returns the request headers."""
    req = b""
    while b"\r\n\r\n" not in req:
        chunk = sock.recv(4096)
        if not chunk:
            raise WebSocketError("handshake: client hung up")
        req += chunk
    headers = {}
    for line in req.split(b"\r\n")[1:]:
        if b":" in line:
            k, v = line.split(b":", 1)
            headers[k.strip().decode().lower()] = v.strip().decode()
    key = headers.get("sec-websocket-key", "")
    accept = base64.b64encode(hashlib.sha1(
        (key + _GUID).encode()).digest()).decode()
    sock.sendall((f"HTTP/1.1 101 Switching Protocols\r\n"
                  f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
    return headers
