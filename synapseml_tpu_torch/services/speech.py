"""Speech service transformers.

Reference: cognitive/.../services/speech/ (~1265 LoC: SpeechToText REST +
SpeechToTextSDK websocket streaming + ConversationTranscription,
TextToSpeech). The REST short-audio path posts bytes → transcript JSON;
SpeechToTextSDK implements the Speech websocket protocol (USP framing:
header-block text messages, length-prefixed binary audio messages, turn
lifecycle) over io/websocket.py with an injectable transport so tests drive
it against an in-process fake service.

The port's copy of the JAX package's ``services/speech.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import datetime as _dt
import json as _json
import uuid as _uuid
from typing import List

import numpy as np

from ..core.params import Param
from ..core.table import Table
from .base import CognitiveServiceBase, HasAsyncReply


class SpeechToText(CognitiveServiceBase):
    """Short-audio recognition (reference SpeechToText.scala)."""

    audioDataCol = Param("audioDataCol", "column of WAV bytes", str, "audio")
    language = Param("language", "recognition language", str, "en-US")
    format = Param("format", "simple or detailed", str, "simple")
    profanity = Param("profanity", "masked|removed|raw", str, "masked")

    def setLocation(self, location: str):
        return self.set("url", f"https://{location}.stt.speech.microsoft.com/"
                               "speech/recognition/conversation/cognitiveservices/v1")

    def _prepare_url(self, df, i):
        return (super()._prepare_url(df, i)
                + f"?language={self._resolve('language', df, i, 'en-US')}"
                  f"&format={self.getFormat()}"
                  f"&profanity={self.getProfanity()}")

    def _prepare_headers(self, df, i):
        h = super()._prepare_headers(df, i)
        h["Content-Type"] = "audio/wav; codecs=audio/pcm; samplerate=16000"
        return h

    def _prepare_body(self, df, i):
        b = df[self.getAudioDataCol()][i]
        return bytes(b) if b is not None else None


def _usp_timestamp() -> str:
    return _dt.datetime.now(_dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


def usp_text_message(path: str, request_id: str, body: dict) -> str:
    """Speech USP text message: header block + blank line + JSON body."""
    return (f"Path: {path}\r\nX-RequestId: {request_id}\r\n"
            f"X-Timestamp: {_usp_timestamp()}\r\n"
            "Content-Type: application/json; charset=utf-8\r\n\r\n"
            + _json.dumps(body))


def usp_audio_message(request_id: str, chunk: bytes) -> bytes:
    """Speech USP binary message: big-endian u16 header length + headers +
    audio payload (empty payload = end of stream)."""
    headers = (f"Path: audio\r\nX-RequestId: {request_id}\r\n"
               f"X-Timestamp: {_usp_timestamp()}\r\n"
               "Content-Type: audio/x-wav\r\n").encode()
    return len(headers).to_bytes(2, "big") + headers + chunk


def usp_parse_text(msg: bytes):
    """(headers-dict, json-body) of a server USP text message."""
    head, _, body = msg.partition(b"\r\n\r\n")
    headers = {}
    for line in head.split(b"\r\n"):
        if b":" in line:
            k, v = line.split(b":", 1)
            headers[k.strip().decode().lower()] = v.strip().decode()
    try:
        parsed = _json.loads(body.decode("utf-8")) if body else {}
    except ValueError:
        parsed = {"raw": body.decode("utf-8", "replace")}
    return headers, parsed


class SpeechToTextSDK(SpeechToText):
    """Streaming recognition over the Speech websocket protocol (reference
    speech/SpeechToTextSDK.scala — the SDK's USP transport): connect,
    send speech.config + audio chunks, collect speech.phrase events until
    turn.end. ``wsTransport`` injects a connected socket-like object (tests /
    tunnels); by default a TLS websocket is opened to the region endpoint.
    """

    mode = Param("mode", "conversation|dictation|interactive", str,
                 "conversation")
    chunkSize = Param("chunkSize", "audio bytes per websocket message", int,
                      8192)
    streamIntermediateResults = Param(
        "streamIntermediateResults",
        "include speech.hypothesis events in the output", bool, False)
    wsTransport = Param("wsTransport", "callable url,headers -> socket-like "
                        "(test/tunnel injection)", is_complex=True)

    def _ws_path(self, df, i) -> str:
        mode = self._resolve("mode", df, i, "conversation")
        return f"/speech/recognition/{mode}/cognitiveservices/v1"

    def _ws_url(self, df, i):
        base = self.get("url") or ""
        if base.startswith("http"):
            base = "ws" + base[4:]
        lang = self._resolve("language", df, i, "en-US")
        if "/speech/" not in base and "/transcribe" not in base:
            base = base.rstrip("/") + self._ws_path(df, i)
        sep = "&" if "?" in base else "?"
        return f"{base}{sep}language={lang}&format={self.getFormat()}"

    def setLocation(self, location: str):
        return self.set(
            "url", f"wss://{location}.stt.speech.microsoft.com")

    def _recognize_one(self, audio: bytes, df, i) -> List[dict]:
        from ..io.websocket import WebSocketClient, WebSocketError

        url = self._ws_url(df, i)
        headers = {"X-ConnectionId": _uuid.uuid4().hex}
        key = self._resolve("subscriptionKey", df, i)
        if key:
            headers["Ocp-Apim-Subscription-Key"] = str(key)
        tok = self._resolve("AADToken", df, i)
        if tok:
            headers["Authorization"] = f"Bearer {tok}"
        transport = self.get("wsTransport")
        sock = transport(url, headers) if transport else None
        ws = WebSocketClient(url, headers=headers, sock=sock,
                             timeout=self.getTimeout())
        request_id = _uuid.uuid4().hex
        events: List[dict] = []
        with ws:
            ws.send_text(usp_text_message("speech.config", request_id, {
                "context": {"system": {"name": "synapseml_tpu"},
                            "os": {"platform": "python"}}}))
            cs = max(1, self.getChunkSize())
            for off in range(0, len(audio), cs):
                ws.send_binary(usp_audio_message(request_id,
                                                 audio[off:off + cs]))
            ws.send_binary(usp_audio_message(request_id, b""))  # end stream
            want_hyp = self.get("streamIntermediateResults")
            while True:
                try:
                    opcode, payload = ws.recv()
                except WebSocketError:
                    break
                if opcode != 1:          # only text messages carry events
                    continue
                hdrs, body = usp_parse_text(payload)
                path = hdrs.get("path", "")
                if path == "speech.phrase" or (want_hyp and
                                               path == "speech.hypothesis"):
                    events.append(dict(body, **{"_path": path}))
                if path == "turn.end":
                    break
        return events

    def _transform(self, df: Table) -> Table:
        n = df.num_rows
        out = np.empty(n, dtype=object)
        err = np.empty(n, dtype=object)
        col = self.getAudioDataCol()
        for i in range(n):
            b = df[col][i]
            if b is None:
                out[i] = None
                err[i] = None
                continue
            try:
                out[i] = self._recognize_one(bytes(b), df, i)
                err[i] = None
            except Exception as e:  # noqa: BLE001 — per-row error column
                out[i] = None
                err[i] = {"error": str(e)[:500]}
        res = df.with_column(self.get("outputCol"), out)
        return res.with_column(self.get("errorCol"), err)


class ConversationTranscription(SpeechToTextSDK):
    """Multi-speaker transcription over the same websocket protocol
    (reference speech/ConversationTranscription.scala): the conversation
    transcription service endpoint (cts domain, /transcribe path), same USP
    framing."""

    def _ws_path(self, df, i) -> str:
        return "/speech/recognition/transcribe/cognitiveservices/v1"

    def setLocation(self, location: str):
        return self.set(
            "url", f"wss://{location}.cts.speech.microsoft.com")


class SpeakerEmotionInference(CognitiveServiceBase):
    """SSML voice-style inference for dialog text (reference
    speech/SpeakerEmotionInference.scala): POST text → per-segment style
    annotations used to build expressive SSML."""

    textCol = Param("textCol", "column of texts", str, "text")
    locale = Param("locale", "text locale", str, "en-US")
    voiceName = Param("voiceName", "voice for synthesis hints", str,
                      "en-US-JennyNeural")

    def setLocation(self, location: str):
        return self.set("url", f"https://{location}.api.cognitive.microsoft."
                               "com/cognitiveservices/v1/ssml/inference")

    def _prepare_body(self, df, i):
        text = df[self.getTextCol()][i]
        if text is None:
            return None
        return {"text": str(text),
                "locale": self._resolve("locale", df, i, "en-US"),
                "voiceName": self._resolve("voiceName", df, i)}


class TextToSpeech(CognitiveServiceBase):
    """SSML → audio bytes (reference TextToSpeech.scala)."""

    textCol = Param("textCol", "column of texts", str, "text")
    voiceName = Param("voiceName", "synthesis voice", str,
                      "en-US-JennyNeural")
    language = Param("language", "voice language", str, "en-US")
    outputFormat = Param("outputFormat", "audio format", str,
                         "riff-16khz-16bit-mono-pcm")

    def setLocation(self, location: str):
        return self.set("url", f"https://{location}.tts.speech.microsoft.com/"
                               "cognitiveservices/v1")

    def _prepare_headers(self, df, i):
        h = super()._prepare_headers(df, i)
        h["Content-Type"] = "application/ssml+xml"
        h["X-Microsoft-OutputFormat"] = self.getOutputFormat()
        return h

    def _prepare_body(self, df, i):
        from xml.sax.saxutils import escape, quoteattr

        text = df[self.getTextCol()][i]
        if text is None:
            return None
        voice = self._resolve("voiceName", df, i, "en-US-JennyNeural")
        lang = self._resolve("language", df, i, "en-US")
        ssml = (f"<speak version='1.0' xml:lang={quoteattr(str(lang))}>"
                f"<voice name={quoteattr(str(voice))}>"
                f"{escape(str(text))}</voice></speak>")
        return ssml.encode()

    def _parse_response(self, parsed, df, i):
        return parsed  # audio bytes arrive via text fallback; kept raw


class AnalyzeDocument(HasAsyncReply):
    """Document Intelligence (Form Recognizer) analyze with LRO polling
    (reference cognitive/.../services/form/FormRecognizer.scala, ~849 LoC —
    AnalyzeDocument submits then polls the operation-location via the shared
    HasAsyncReply flow)."""

    imageBytesCol = Param("imageBytesCol", "column of document bytes", str)
    imageUrlCol = Param("imageUrlCol", "column of document urls", str)
    modelId = Param("modelId", "prebuilt-layout, prebuilt-invoice, ...", str,
                    "prebuilt-layout")
    apiVersion = Param("apiVersion", "API version", str, "2023-07-31")

    def setLocation(self, location: str):
        return self.set("url",
                        f"https://{location}.api.cognitive.microsoft.com")

    def _prepare_url(self, df, i):
        return (f"{self.get('url').rstrip('/')}/formrecognizer/documentModels/"
                f"{self.getModelId()}:analyze?api-version={self.getApiVersion()}")

    def _prepare_headers(self, df, i):
        h = super()._prepare_headers(df, i)
        if self.isSet("imageBytesCol"):
            h["Content-Type"] = "application/octet-stream"
        return h

    def _prepare_body(self, df, i):
        if self.isSet("imageBytesCol"):
            b = df[self.getImageBytesCol()][i]
            return bytes(b) if b is not None else None
        u = df[self.getImageUrlCol()][i]
        return {"urlSource": str(u)} if u is not None else None

