"""Local endpoints for the tests of the port's HTTP client layer.

``StubServer`` is a ``ThreadingHTTPServer`` on 127.0.0.1 port 0 that
records every request (method, path, headers, body) and answers from a
reply function; ``RecordingOpener`` is an ``opener`` (the transport that
``send_with_retries`` and every service transformer take) that records the
request a client built, URL and all, and forwards it to a ``StubServer`` at
the same path, so a client aimed at an Azure endpoint reaches the stub;
``FakeSpeechServer`` speaks the server side of RFC 6455 and the Speech USP
framing over one socket pair. Every wait is bounded (``torch_waits``).
"""

import json
import socket
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

from synapseml_tpu_torch.io.websocket import (OP_BINARY, OP_TEXT,
                                              decode_frame, encode_frame,
                                              server_handshake)
from torch_waits import join_thread


def json_reply(obj, status: int = 200, headers=None):
    """A reply function's result: ``obj`` as a JSON body."""
    return status, dict(headers or {}), json.dumps(obj).encode()


class StubServer:
    """``reply(method, path, headers, body) -> (status, headers, body)``
    answers each request; ``requests`` holds ``(method, path, headers,
    body)`` in arrival order (headers as a dict keyed in lower case, body
    as bytes)."""

    def __init__(self, reply):
        self.reply = reply
        self.requests = []
        self.lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            disable_nagle_algorithm = True

            def _handle(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                headers = {k.lower(): v for k, v in self.headers.items()}
                with stub.lock:
                    stub.requests.append((self.command, self.path, headers,
                                          body))
                status, out_headers, out = stub.reply(
                    self.command, self.path, headers, body)
                self.send_response(status)
                for k, v in out_headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            do_GET = do_POST = do_PUT = do_DELETE = _handle

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.02},
            name="stub-server", daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        join_thread(self.thread, what="the stub server")


class RecordingOpener:
    """Records ``(url, method, headers, entity)`` of every request a client
    opens, then sends it to ``base`` (a ``StubServer``'s url) at the same
    path and query."""

    def __init__(self, base: str):
        self.base = base
        self.calls = []
        self.lock = threading.Lock()

    def open(self, request, timeout=None):
        with self.lock:
            self.calls.append((request.full_url, request.get_method(),
                               sorted(request.header_items()), request.data))
        u = urlsplit(request.full_url)
        path = u.path + (f"?{u.query}" if u.query else "")
        fwd = urllib.request.Request(
            self.base + path, data=request.data,
            headers=dict(request.header_items()),
            method=request.get_method())
        return urllib.request.urlopen(fwd, timeout=timeout)


class FakeSpeechServer:
    """Accepts one websocket session over a socket pair and speaks the
    Speech USP protocol: it reads speech.config and the audio messages up
    to the empty one, then sends hypotheses, a phrase and turn.end.
    ``usp`` is the ``services.speech`` module whose framing helpers
    build the replies."""

    def __init__(self, usp, hypotheses=("hel", "hello")):
        self.usp = usp
        self.hypotheses = hypotheses
        self.messages = []          # (opcode, unmasked payload) received
        self.request_headers = None
        self.error = None
        self.sock, self.client_sock = socket.socketpair()
        self.sock.settimeout(30.0)
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="fake-speech")
        self.thread.start()

    def _send_text(self, path, body):
        msg = self.usp.usp_text_message(path, "rid", body)
        self.sock.sendall(encode_frame(OP_TEXT, msg.encode(), mask=False))

    def _run(self):
        try:
            self.request_headers = server_handshake(self.sock)
            while True:
                opcode, fin, payload = decode_frame(self.sock)
                self.messages.append((opcode, payload))
                if opcode == OP_BINARY:
                    hlen = int.from_bytes(payload[:2], "big")
                    if not payload[2 + hlen:]:
                        break
            self._send_text("speech.startDetected", {})
            for h in self.hypotheses:
                self._send_text("speech.hypothesis", {"Text": h})
            self._send_text("speech.phrase", {
                "RecognitionStatus": "Success", "DisplayText": "hello world",
                "Offset": 0, "Duration": 12345})
            self._send_text("turn.end", {})
        except Exception as e:      # noqa: BLE001 — read by the test
            self.error = e

    def join(self):
        join_thread(self.thread, what="the fake speech server")
        self.sock.close()
