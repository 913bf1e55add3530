"""A local stub of the Azure OpenAI embeddings endpoint.

    python tools/embedding_stub.py [--width 1536] [--texts N] [--port 0]

Answers ``POST .../embeddings`` (``{"input": text}``) with the body the
service returns, one ``width``-wide float32 vector per text, drawn from a
generator seeded by the text's SHA-256 (``embedding_of``), written as the
shortest decimal that reads back to the same float32. The replies of the
first ``--texts`` texts of ``embed_texts`` are built before the server
starts, so a client's rate is the client's; any other text is answered as
it comes. Prints the port on stdout once it serves, and serves until it is
terminated. It imports numpy and the standard library only.
"""

import argparse
import hashlib
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

WORDS = ("good", "bad", "fast", "slow", "card", "model", "tree", "kernel",
         "loss", "server", "query", "image", "token", "batch", "price",
         "service")


def embed_texts(n: int) -> list:
    """``n`` seeded review-like texts, each distinct."""
    rng = np.random.default_rng(26)
    words = np.array(WORDS)
    return [f"review {i}: " + " ".join(rng.choice(words, 8))
            for i in range(n)]


def embedding_of(text: str, width: int) -> np.ndarray:
    """The stub's vector for ``text``: ``width`` float32 draws of a
    generator seeded by the text's SHA-256."""
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little")
    return np.random.default_rng(seed).standard_normal(width).astype(
        np.float32)


def reply_body(text: str, width: int) -> bytes:
    """The embeddings response for ``text``, each component as the
    shortest decimal of its float32 (``str`` of a numpy float32)."""
    vec = ", ".join(str(x) for x in embedding_of(text, width))
    return ('{"object": "list", "data": [{"object": "embedding", '
            f'"index": 0, "embedding": [{vec}]}}], '
            '"model": "text-embedding-ada-002"}').encode()


def serve(width: int, texts: int, port: int) -> ThreadingHTTPServer:
    bodies = {t: reply_body(t, width) for t in embed_texts(texts)}

    class Handler(BaseHTTPRequestHandler):
        disable_nagle_algorithm = True

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            text = json.loads(self.rfile.read(n))["input"]
            out = bodies.get(text) or reply_body(text, width)
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    httpd.daemon_threads = True
    return httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1536)
    ap.add_argument("--texts", type=int, default=0,
                    help="replies of embed_texts(N) built ahead")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    httpd = serve(args.width, args.texts, args.port)
    print(httpd.server_address[1], flush=True)
    try:
        httpd.serve_forever(poll_interval=0.05)
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
