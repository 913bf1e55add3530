"""The port's websocket client and the Speech SDK's USP framing against
the JAX package's (the port's mirror of ``tests/test_speech_sdk.py``).

Frames and USP messages built by one package are read by the other; both
``SpeechToTextSDK`` and ``ConversationTranscription`` run a session against
the same in-process fake Speech server (``torch_http_server``), and the
port must send the JAX package's messages and read the same events. Time
and ids (``uuid4``, the USP timestamp) are fixed in both packages; a frame's
mask is random, so frames are compared unmasked.
"""

import socket
import threading
import types

import numpy as np
import pytest

from synapseml_tpu.core.table import Table as JTable
from synapseml_tpu.io import websocket as jws
from synapseml_tpu.services import speech as jspeech

from synapseml_tpu_torch.core.table import Table as TTable
from synapseml_tpu_torch.io import websocket as tws
from synapseml_tpu_torch.services import speech as tspeech
from torch_http_server import FakeSpeechServer
from torch_waits import join_thread

PAIRS = ((jws, jspeech, JTable), (tws, tspeech, TTable))


@pytest.fixture(autouse=True)
def fixed_speech_ids(monkeypatch):
    ids = types.SimpleNamespace(
        uuid4=lambda: types.SimpleNamespace(hex="ab" * 16))
    for mod in (jspeech, tspeech):
        monkeypatch.setattr(mod, "_uuid", ids)
        monkeypatch.setattr(mod, "_usp_timestamp",
                            lambda: "2026-10-19T00:00:00.000Z")


@pytest.mark.parametrize("n", [0, 5, 125, 126, 65535, 65536, 70000])
@pytest.mark.parametrize("mask", [True, False])
def test_frames_cross_decode(n, mask):
    """Every length form (7-bit, 16-bit, 64-bit), masked or not: each
    package decodes the other's frames, and unmasked frames are the same
    bytes."""
    payload = bytes(np.random.default_rng(n).integers(0, 256, n,
                                                      dtype=np.uint8))
    for enc, dec in ((jws, tws), (tws, jws)):
        a, b = socket.socketpair()
        try:
            a.sendall(enc.encode_frame(enc.OP_BINARY, payload, mask=mask,
                                       fin=n != 5))
            assert dec.decode_frame(b) == (dec.OP_BINARY, n != 5, payload)
        finally:
            a.close()
            b.close()
    if not mask:
        assert tws.encode_frame(2, payload, mask=False) == \
            jws.encode_frame(2, payload, mask=False)
    assert (tws.OP_CONT, tws.OP_TEXT, tws.OP_BINARY, tws.OP_CLOSE,
            tws.OP_PING, tws.OP_PONG) == (jws.OP_CONT, jws.OP_TEXT,
                                          jws.OP_BINARY, jws.OP_CLOSE,
                                          jws.OP_PING, jws.OP_PONG)


def test_usp_framing_equals_the_reference():
    body = {"context": {"system": {"name": "x"}}, "n": [1, 2.5, None]}
    assert tspeech.usp_text_message("speech.config", "r1", body) == \
        jspeech.usp_text_message("speech.config", "r1", body)
    for chunk in (b"", b"\xde\xad\xbe\xef" * 100):
        assert tspeech.usp_audio_message("r1", chunk) == \
            jspeech.usp_audio_message("r1", chunk)
    for msg in (jspeech.usp_text_message("turn.end", "r", {}).encode(),
                b"Path: x\r\nX-RequestId: r\r\n\r\nnot json",
                b"Path: y\r\n\r\n"):
        assert tspeech.usp_parse_text(msg) == jspeech.usp_parse_text(msg)


def _client_session(ws_mod, headers):
    """A client connect / send / recv / close against a server thread that
    answers a ping, sends a fragmented text message and closes; returns
    (what the client read, the server's view)."""
    a, b = socket.socketpair()
    seen = {}

    def server():
        seen["headers"] = tws.server_handshake(b)
        seen["first"] = tws.decode_frame(b)
        b.sendall(tws.encode_frame(tws.OP_PING, b"hb", mask=False))
        b.sendall(tws.encode_frame(tws.OP_TEXT, b"hel", mask=False,
                                   fin=False))
        b.sendall(tws.encode_frame(tws.OP_CONT, b"lo", mask=False))
        seen["pong"] = tws.decode_frame(b)
        b.sendall(tws.encode_frame(tws.OP_CLOSE, b"", mask=False))

    t = threading.Thread(target=server, daemon=True)
    t.start()
    ws = ws_mod.WebSocketClient("wss://speech.test:8443/path?x=1",
                                headers=headers, sock=a)
    with ws:
        ws.send_text("hi")
        got = [ws.recv()]
        with pytest.raises(ws_mod.WebSocketError, match="closed"):
            ws.recv()
    join_thread(t, what="the websocket server")
    b.close()
    return got, seen


def test_client_session_equals_the_reference():
    (jgot, jseen), (tgot, tseen) = [
        _client_session(m, {"X-ConnectionId": "c1"}) for m in (jws, tws)]
    assert jgot == tgot == [(1, b"hello")]
    for seen in (jseen, tseen):
        assert seen["first"] == (1, True, b"hi")
        assert seen["pong"] == (10, True, b"hb")
    drop = {"sec-websocket-key"}
    assert {k: v for k, v in jseen["headers"].items() if k not in drop} == \
        {k: v for k, v in tseen["headers"].items() if k not in drop}
    assert tseen["headers"]["host"] == "speech.test:8443"


def test_handshake_rejection_raises_as_the_reference():
    for ws_mod in (jws, tws):
        a, b = socket.socketpair()

        def bad_server():
            b.recv(65536)
            b.sendall(b"HTTP/1.1 403 Forbidden\r\n\r\n")

        t = threading.Thread(target=bad_server, daemon=True)
        t.start()
        with pytest.raises(ws_mod.WebSocketError, match="handshake rejected"):
            ws_mod.WebSocketClient("ws://x.local/", sock=a).connect()
        join_thread(t, what="the rejecting server")
        a.close()
        b.close()


def _transcribe(speech, table_cls, cls_name, audio, **params):
    servers = []

    def transport(url, headers):
        servers.append(FakeSpeechServer(speech))
        return servers[-1].client_sock

    stage = (getattr(speech, cls_name)(**params)
             .set("url", "wss://fake.local").set("subscriptionKey", "k")
             .set("wsTransport", transport)
             .set("outputCol", "events").set("errorCol", "errs"))
    out = stage.transform(table_cls({"audio": audio}))
    for s in servers:
        s.join()
        assert s.error is None
    return out, servers


@pytest.mark.parametrize("cls_name,params", [
    ("SpeechToTextSDK", {}),
    ("SpeechToTextSDK", dict(streamIntermediateResults=True, chunkSize=997,
                             language="de-DE", mode="dictation")),
    ("ConversationTranscription", {})])
def test_speech_sessions_equal_the_reference(cls_name, params):
    audio = np.empty(3, dtype=object)
    audio[:] = [bytes(np.arange(4000, dtype=np.uint8)), None, b"\x01" * 64]
    runs = [_transcribe(speech, table_cls, cls_name, audio, **params)
            for _, speech, table_cls in PAIRS]
    (jout, jservers), (tout, tservers) = runs
    assert list(tout["events"]) == list(jout["events"])
    assert list(tout["errs"]) == list(jout["errs"]) == [None] * 3
    assert len(tservers) == len(jservers) == 2
    for js, ts, a in zip(jservers, tservers, (audio[0], audio[2])):
        assert ts.messages == js.messages
        drop = {"sec-websocket-key"}
        assert {k: v for k, v in ts.request_headers.items()
                if k not in drop} == {k: v for k, v in
                                      js.request_headers.items()
                                      if k not in drop}
        sent = b"".join(p[2 + int.from_bytes(p[:2], "big"):]
                        for op, p in ts.messages if op == tws.OP_BINARY)
        assert sent == a
    events = tout["events"][0]
    want = (["speech.hypothesis"] * 2 if params.get(
        "streamIntermediateResults") else []) + ["speech.phrase"]
    assert [e["_path"] for e in events] == want
    assert events[-1]["DisplayText"] == "hello world"


def test_ws_urls_equal_the_reference():
    for cls_name in ("SpeechToTextSDK", "ConversationTranscription"):
        for loc in ("eastus", "westeurope"):
            j = getattr(jspeech, cls_name)(language="fr-FR").setLocation(loc)
            t = getattr(tspeech, cls_name)(language="fr-FR").setLocation(loc)
            assert t._ws_url(None, None) == j._ws_url(None, None)
    s = tspeech.SpeechToTextSDK().setLocation("eastus")
    assert s._ws_url(None, None).startswith(
        "wss://eastus.stt.speech.microsoft.com/speech/recognition/"
        "conversation/cognitiveservices/v1?language=en-US")


def test_a_failed_session_fills_the_error_column_as_the_reference():
    outs = []
    for _, speech, table_cls in PAIRS:
        def transport(url, headers):
            a, b = socket.socketpair()
            b.close()
            return a
        stage = (speech.SpeechToTextSDK().set("url", "wss://fake.local")
                 .set("wsTransport", transport)
                 .set("outputCol", "events").set("errorCol", "errs"))
        audio = np.empty(1, dtype=object)
        audio[0] = b"\x00" * 10
        out = stage.transform(table_cls({"audio": audio}))
        outs.append((list(out["events"]), list(out["errs"])))
    assert outs[0] == outs[1] and outs[1][0] == [None]
    assert "error" in outs[1][1][0]
