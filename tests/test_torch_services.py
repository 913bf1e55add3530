"""The port's AI-service transformers against the JAX package's, class by
class: every public name of the JAX ``services/__init__`` runs in both
packages on the same rows through a ``RecordingOpener`` in front of one
local ``StubServer``. Both must send the same requests (URL, method,
headers and entity bytes, in order) and parse the same canned replies into
equal output and error columns. The stub answers every request 202 with an
``Operation-Location`` and a body that carries what each parser reads; a
poll of that location is first "running", then terminal, so every
long-running-operation class polls. Time and ids in the Speech protocol
(``uuid4``, the USP timestamp) are fixed in both packages.
"""

import json
import types

import numpy as np
import pytest

import synapseml_tpu.services as jservices
from synapseml_tpu.core.params import Param as JParam
from synapseml_tpu.core.table import Table as JTable
from synapseml_tpu.services import speech as jspeech

import synapseml_tpu_torch.services as tservices
from synapseml_tpu_torch.core.params import Param as TParam
from synapseml_tpu_torch.core.table import Table as TTable
from synapseml_tpu_torch.services import speech as tspeech
from torch_http_server import (FakeSpeechServer, RecordingOpener, StubServer,
                               json_reply)

KEY = "key-0123456789abcdef"
TEXTS = ("I love it", None, "terrible service")
URL = "https://res.openai.azure.com/"
PNG_BYTES = b"\x89PNG\r\n\x1a\n" + bytes(range(40))
BODY = {
    "results": {"documents": [{"id": "0", "sentiment": "positive",
                               "keyPhrases": ["service"]}]},
    "choices": [{"text": " yes, no",
                 "message": {"role": "assistant", "content": "cat, dog"}}],
    "data": [{"embedding": [0.25, -1.5, 3.0]}],
    "value": [{"contentUrl": "http://img.test/1.jpg", "key": "1",
               "status": True}],
    "addresses": [{"address": {"freeformAddress": "1 Main St"}}],
    "result": {"pointInPolygon": True},
    "isAnomaly": False}
RUNNING = {"status": "running", "modelInfo": {"status": "RUNNING"},
           "summary": {"status": "running"}}
DONE = {"status": "succeeded", "modelInfo": {"status": "READY"},
        "summary": {"status": "succeeded"},
        "analyzeResult": {"documents": [{"fields": {
            "Total": {"type": "number", "valueNumber": 12.5},
            "Vendor": {"type": "string", "valueString": "Contoso"}}}]}}


def col(*values):
    a = np.empty(len(values), dtype=object)
    a[:] = values
    return a


def texts():
    return {"text": col(*TEXTS)}


def series():
    pts = [{"timestamp": f"2026-01-0{d}T00:00:00Z", "value": float(v)}
           for d, v in zip(range(1, 6), (1, 1, 2, 1, 9))]
    return {"series": col(pts, None, pts[:4])}


def images():
    return {"url": col("http://img.test/a.jpg", None, "http://img.test/b.jpg")}


def image_bytes():
    return {"bytes": col(PNG_BYTES, None, PNG_BYTES[::-1])}


class Service:
    """A stub that answers as the module docstring says; ``reset`` starts
    a package's run afresh (the same locations, the same polls)."""

    def __init__(self):
        self.stub = StubServer(self.reply)

    def reset(self):
        self.ops, self.polls = 0, {}
        self.stub.requests.clear()

    def reply(self, method, path, headers, body):
        if path.startswith("/operations/"):
            self.polls[path] = self.polls.get(path, 0) + 1
            return json_reply(RUNNING if self.polls[path] == 1 else
                              dict(DONE, op=path))
        self.ops += 1
        loc = f"{self.stub.url}/operations/{self.ops}"
        if method == "POST" and path.split("?")[0].endswith(
                "multivariate/models"):
            return 201, {"Location": loc}, b""
        return json_reply(dict(BODY, seen=path), 202,
                          {"Operation-Location": loc})


@pytest.fixture(scope="module")
def service():
    s = Service()
    with s.stub:
        yield s


@pytest.fixture(autouse=True)
def fixed_speech_ids(monkeypatch):
    """uuid4 and the USP timestamp fixed in both packages."""
    ids = types.SimpleNamespace(
        uuid4=lambda: types.SimpleNamespace(hex="0" * 31 + "7"))
    for mod in (jspeech, tspeech):
        monkeypatch.setattr(mod, "_uuid", ids)
        monkeypatch.setattr(mod, "_usp_timestamp",
                            lambda: "2026-01-01T00:00:00.000Z")


def _subclass(pkg, base):
    """A concrete stage over each abstract base class, built the same way
    in both packages: a ``language`` param; a JSON body of the row's text
    and its language, or (``HasServiceParams``) the resolved language as
    the output column."""
    Param = (JParam if pkg is jservices else TParam)
    attrs = {"urlPath": "echo/v1",
             "language": Param("language", "language hint", str, "en")}
    if base == "HasServiceParams":
        def _transform(self, df):
            vals = col(*(self._resolve("language", df, i, "en")
                         for i in range(df.num_rows)))
            return df.with_column("out", vals).with_column(
                "err", col(*([None] * df.num_rows)))
        attrs["_transform"] = _transform
    else:
        attrs["_prepare_body"] = lambda self, df, i: (
            None if df["text"][i] is None
            else {"text": str(df["text"][i]),
                  "lang": self._resolve("language", df, i, "en")})
    return type(f"Echo{base}", (getattr(pkg, base),), attrs)


# name -> (setup(stage) -> stage, columns())
CASES = {
    "CognitiveServiceBase": (lambda s: s.set("url", URL + "echo"), texts),
    "HasAsyncReply": (lambda s: s.setParams(url=URL + "echo",
                                            pollInterval=0.0), texts),
    "HasServiceParams": (lambda s: s.setLanguageCol("lang"),
                         lambda: {"text": col(*TEXTS),
                                  "lang": col("de", "fr", "es")}),
    "HasSetLocation": (lambda s: s.setLocation("usgovvirginia"), texts),
    "OpenAICompletion": (lambda s: s.setParams(
        url=URL, deploymentName="gpt-35", maxTokens=5, temperature=0.25,
        stop=["\n"]), lambda: {"prompt": col("great movie!", "meh")}),
    "OpenAIChatCompletion": (lambda s: s.setParams(
        url=URL, deploymentName="gpt-4", user="u1", topP=0.5),
        lambda: {"messages": col(
            [{"role": "user", "content": "hi"}],
            [{"role": "system", "content": "s"},
             {"role": "user", "content": "yo"}])}),
    "OpenAIEmbedding": (lambda s: s.setParams(url=URL,
                                              deploymentName="ada-002"),
                        lambda: {"text": col("alpha", "béta ünïcode")}),
    "OpenAIPrompt": (lambda s: s.setParams(
        url=URL, deploymentName="gpt", promptTemplate="Classify: {text}",
        systemPrompt="be brief", postProcessing="csv"),
        lambda: {"text": col("the farm", "the sea")}),
    "TextSentiment": (lambda s: s.setLocation("eastus"), texts),
    "KeyPhraseExtractor": (lambda s: s.setLocation("westeurope"), texts),
    "NER": (lambda s: s.setCustomServiceName("my-lang"), texts),
    "PII": (lambda s: s.setParams(domain="phi").setLocation("eastus"),
            texts),
    "EntityLinking": (lambda s: s.setLocation("eastus"), texts),
    "EntityDetector": (lambda s: s.setLocation("eastus"), texts),
    "LanguageDetector": (lambda s: s.setLocation("eastus"), texts),
    "AnalyzeHealthText": (lambda s: s.setParams(
        language="fr").setLocation("eastus"), texts),
    "AnalyzeText": (lambda s: s.setParams(
        kind="KeyPhraseExtraction").setLocation("eastus"), texts),
    "TextAnalyze": (lambda s: s.setParams(
        tasks={"SentimentAnalysis": {},
               "KeyPhraseExtraction": {"modelVersion": "latest"}},
        pollInterval=0.0).setLocation("eastus"), texts),
    "Translate": (lambda s: s.setParams(toLanguage=["de", "fr"],
                                        fromLanguage="en",
                                        subscriptionRegion="eastus"),
                  lambda: {"text": col("Hello", None, ["a", "b"])}),
    "Transliterate": (lambda s: s.setParams(language="ja",
                                            fromScript="Jpan",
                                            toScript="Latn"), texts),
    "Detect": (lambda s: s, texts),
    "BreakSentence": (lambda s: s, texts),
    "DictionaryLookup": (lambda s: s.setParams(fromLanguage="en",
                                               toLanguage="es"), texts),
    "DictionaryExamples": (lambda s: s.setParams(
        toLanguage="es", translationCol="tr"),
        lambda: {"text": col("fly", None, "time"),
                 "tr": col("volar", "x", "tiempo")}),
    "DocumentTranslator": (lambda s: s.setParams(
        serviceName="svc", sourceUrl="https://a.blob/src?sv=1",
        targetUrl="https://a.blob/dst", filterPrefix="docs/"),
        lambda: {"text": col("x", "y")}),
    "AnalyzeImage": (lambda s: s.setParams(
        imageUrlCol="url", visualFeatures=["Tags", "Faces"],
        details=["Landmarks"]).setLocation("eastus"), images),
    "DescribeImage": (lambda s: s.setParams(
        imageBytesCol="bytes", maxCandidates=2).setLocation("eastus"),
        image_bytes),
    "TagImage": (lambda s: s.setParams(imageUrlCol="url").setLocation(
        "eastus"), images),
    "OCR": (lambda s: s.setParams(imageBytesCol="bytes",
                                  detectOrientation=False).setLocation(
        "eastus"), image_bytes),
    "GenerateThumbnails": (lambda s: s.setParams(
        imageUrlCol="url", width=32, smartCropping=False).setLocation(
        "eastus"), images),
    "ReadImage": (lambda s: s.setParams(
        imageUrlCol="url", pollInterval=0.0).setLocation("eastus"), images),
    "RecognizeText": (lambda s: s.setParams(
        imageBytesCol="bytes", mode="Handwritten",
        pollInterval=0.0).setLocation("eastus"), image_bytes),
    "RecognizeDomainSpecificContent": (lambda s: s.setParams(
        imageUrlCol="url", model="landmarks").setLocation("eastus"),
        images),
    "DetectFace": (lambda s: s.setParams(
        imageUrlCol="url", returnFaceAttributes=["age", "glasses"],
        returnFaceLandmarks=True).setLocation("eastus"), images),
    "FindSimilarFace": (lambda s: s.setParams(
        faceListId="fl", faceIds=["a", "b"]).setLocation("eastus"),
        lambda: {"faceId": col("f1", None, "f3")}),
    "GroupFaces": (lambda s: s.setLocation("eastus"),
                   lambda: {"faceIds": col(["a", "b"], None, ["c"])}),
    "IdentifyFaces": (lambda s: s.setParams(
        personGroupId="pg", confidenceThreshold=0.5).setLocation("eastus"),
        lambda: {"faceIds": col(["a", "b"], None, ["c"])}),
    "VerifyFaces": (lambda s: s.setLocation("eastus"),
                    lambda: {"faceId1": col("a", None, "c"),
                             "faceId2": col("b", "x", "d")}),
    "DetectLastAnomaly": (lambda s: s.setParams(
        granularity="daily", sensitivity=90).setLocation("eastus"), series),
    "DetectAnomalies": (lambda s: s.setParams(
        maxAnomalyRatio=0.25, customInterval=2).setLocation("eastus"),
        series),
    "SimpleDetectAnomalies": (lambda s: s.setParams(
        groupbyCol="g").setLocation("eastus"),
        lambda: {"g": np.array(["x", "y", "x", "y"], dtype=object),
                 "timestamp": np.array(["t1", "t1", "t2", "t2"],
                                       dtype=object),
                 "value": np.array([1.0, 2.0, 3.5, 4.0])}),
    "DetectMultivariateAnomaly": (lambda s: s.setParams(
        modelId="m1", pollInterval=0.0).setLocation("eastus"),
        lambda: {"series": col([{"variable": "a", "value": [1.0]}], None)}),
    "DetectLastMultivariateAnomaly": (lambda s: s.setParams(
        modelId="m2", pollInterval=0.0).setLocation("eastus"),
        lambda: {"series": col([{"variable": "b", "value": [2.0]}])}),
    "SimpleDetectMultivariateAnomaly": (lambda s: s.setParams(
        modelId="m3", startTime="2026-01-01T00:00:00Z",
        endTime="2026-01-02T00:00:00Z", topContributorCount=3,
        pollInterval=0.0).setLocation("eastus"),
        lambda: {"series": col("https://blob/data.zip", None)}),
    "SimpleFitMultivariateAnomaly": (lambda s: s.setParams(
        dataSource="https://blob/train.zip",
        startTime="2026-01-01T00:00:00Z", endTime="2026-01-03T00:00:00Z",
        pollInterval=0.0).setLocation("eastus"),
        lambda: {"series": col("https://blob/infer.zip")}),
    "SpeechToText": (lambda s: s.setParams(
        language="de-DE", format="detailed").setLocation("eastus"),
        lambda: {"audio": col(b"RIFF\x00\x01", None)}),
    "SpeechToTextSDK": (lambda s: s.setParams(
        chunkSize=7, streamIntermediateResults=True).setLocation("eastus"),
        lambda: {"audio": col(bytes(range(20)), None)}),
    "ConversationTranscription": (lambda s: s.setLocation("westus"),
                                  lambda: {"audio": col(b"\x01" * 9)}),
    "SpeakerEmotionInference": (lambda s: s.setLocation("eastus"), texts),
    "TextToSpeech": (lambda s: s.setParams(
        voiceName="en-GB-Ryan").setLocation("eastus"),
        lambda: {"text": col("a < b & 'c'", None)}),
    "AnalyzeDocument": (lambda s: s.setParams(
        imageUrlCol="url", pollInterval=0.0).setLocation("eastus"), images),
    "AddDocuments": (lambda s: s.setParams(
        serviceName="srch", indexName="idx", batchSize=2),
        lambda: {"id": np.array(["1", "2", "3"], dtype=object),
                 "n": np.array([1, 2, 3]),
                 "blob": col(b"\x00\x01", b"", b"z")}),
    "BingImageSearch": (lambda s: s.setParams(count=3, offset=1,
                                              imageType="photo"),
                        lambda: {"q": col("cats & dogs", "ünï")}),
    "AddressGeocoder": (lambda s: s, lambda: {"address": col(
        "1 Main St, Redmond", None)}),
    "ReverseAddressGeocoder": (lambda s: s, lambda: {
        "lat": np.array([47.6, np.nan, 40.0]),
        "lon": np.array([-122.1, 1.0, -74.0])}),
    "CheckPointInPolygon": (lambda s: s.setParams(userDataIdentifier="u1"),
                            lambda: {"lat": np.array([47.6, 40.0]),
                                     "lon": np.array([-122.1, -74.0])}),
    "AnalyzeLayout": (lambda s: s.setParams(
        imageUrlCol="url", pollInterval=0.0).setLocation("eastus"), images),
    "AnalyzeReceipts": (lambda s: s.setParams(
        imageBytesCol="bytes", pollInterval=0.0).setLocation("eastus"),
        image_bytes),
    "AnalyzeBusinessCards": (lambda s: s.setParams(
        imageUrlCol="url", pollInterval=0.0).setLocation("eastus"), images),
    "AnalyzeInvoices": (lambda s: s.setParams(
        imageUrlCol="url", pollInterval=0.0).setLocation("eastus"), images),
    "AnalyzeIDDocuments": (lambda s: s.setParams(
        imageUrlCol="url", pollInterval=0.0).setLocation("eastus"), images),
    "AnalyzeDocumentRead": (lambda s: s.setParams(
        imageBytesCol="bytes", pollInterval=0.0).setLocation("eastus"),
        image_bytes),
    "AnalyzeCustomModel": (lambda s: s.setParams(
        imageUrlCol="url", modelId="custom-1",
        pollInterval=0.0).setLocation("eastus"), images),
    "GetCustomModel": (lambda s: s.setParams(
        modelId="custom-1", pollInterval=0.0).setLocation("eastus"),
        lambda: {"x": col(1, 2)}),
    "ListCustomModels": (lambda s: s.setParams(
        pollInterval=0.0).setLocation("eastus"), lambda: {"x": col(1)}),
}
OFFLINE = ("FormOntologyLearner", "FormOntologyTransformer",
           "AzureSearchWriter")
SDK = ("SpeechToTextSDK", "ConversationTranscription")


def test_every_exported_class_has_a_case():
    assert set(tservices.__all__) == set(jservices.__all__)
    assert set(CASES) | set(OFFLINE) == set(jservices.__all__)


def _same(a, b) -> bool:
    """Deep equality over the values a service column can hold."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return type(a) is type(b) and a == b


def _run(pkg, table_cls, name, service, ws_log):
    """One package's stage for ``name`` over the case's rows: (requests
    the opener saw, requests the stub got, output, error column)."""
    setup, columns = CASES[name]
    cls = (_subclass(pkg, name) if name in ("CognitiveServiceBase",
                                            "HasAsyncReply",
                                            "HasServiceParams",
                                            "HasSetLocation")
           else getattr(pkg, name))
    service.reset()
    opener = RecordingOpener(service.stub.url)
    stage = cls()
    if stage.hasParam("subscriptionKey"):
        stage.setParams(subscriptionKey=KEY, opener=opener, backoff=0.0,
                        outputCol="out", errorCol="err")
    stage = setup(stage)
    if name in SDK:
        speech = jspeech if pkg is jservices else tspeech

        def transport(url, headers):
            fake = FakeSpeechServer(speech)
            ws_log.append((url, fake))
            return fake.client_sock
        stage.set("wsTransport", transport)
    df = table_cls(columns())
    if name == "SimpleFitMultivariateAnomaly":
        model = stage.fit()
        model.setParams(opener=opener, outputCol="out", errorCol="err")
        out = model.transform(df)
    else:
        out = stage.transform(df)
    stub_seen = [(m, p, h.get("content-type"), b)
                 for m, p, h, b in service.stub.requests]
    return opener.calls, stub_seen, list(out["out"]), list(out["err"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_requests_and_parsed_replies_equal_the_references(name, service):
    jlog, tlog = [], []
    jcalls, jstub, jout, jerr = _run(jservices, JTable, name, service, jlog)
    tcalls, tstub, tout, terr = _run(tservices, TTable, name, service, tlog)
    if name in SDK:
        assert jcalls == tcalls == []
        assert len(jlog) == len(tlog) >= 1
        for (ju, jf), (tu, tf) in zip(jlog, tlog):
            jf.join()
            tf.join()
            assert jf.error is None and tf.error is None
            assert ju == tu
            jh = {k: v for k, v in jf.request_headers.items()
                  if k != "sec-websocket-key"}
            th = {k: v for k, v in tf.request_headers.items()
                  if k != "sec-websocket-key"}
            assert jh == th
            assert jf.messages == tf.messages and len(tf.messages) >= 3
    elif name == "HasServiceParams":
        assert jcalls == tcalls == []
    else:
        assert jcalls and tcalls == jcalls, (tcalls, jcalls)
        assert tstub == jstub
    assert len(tout) == len(jout)
    for i, (a, b) in enumerate(zip(tout, jout)):
        assert _same(a, b), (name, i, a, b)
    assert all(_same(a, b) for a, b in zip(terr, jerr)), (terr, jerr)
    if name not in ("HasServiceParams",):
        assert any(v is not None for v in tout), tout


@pytest.mark.parametrize("mode,opts", [
    ("", None), ("csv", {"delimiter": ";"}), ("json", None),
    ("regex", {"regex": r"(\w+), (\w+)", "regexGroup": 2})])
def test_openai_prompt_post_processing_equals_the_reference(mode, opts,
                                                            service):
    replies = {"": "  plain  ", "csv": "a; b ;c", "json": '{"k": [1, 2]}',
               "regex": "cat, dog"}
    outs = []
    for pkg, table_cls in ((jservices, JTable), (tservices, TTable)):
        service.reset()
        stage = pkg.OpenAIPrompt(
            url=URL, deploymentName="gpt", promptTemplate="{a} and {b}",
            postProcessing=mode, useChat=mode != "json",
            opener=RecordingOpener(service.stub.url), outputCol="out",
            errorCol="err")
        if opts:
            stage.set("postProcessingOptions", opts)
        saved = BODY["choices"]
        BODY["choices"] = [{"text": replies[mode],
                            "message": {"content": replies[mode]}}]
        try:
            out = stage.transform(table_cls({"a": col("x"), "b": col(3)}))
        finally:
            BODY["choices"] = saved
        outs.append((out["out"][0], stage.get("opener").calls))
    assert _same(outs[0][0], outs[1][0]) and outs[0][0] is not None
    assert outs[0][1] == outs[1][1]


@pytest.mark.parametrize("status", [400, 503])
def test_error_column_equals_the_reference(status):
    """A service that fails: the error column holds the status, reason and
    body, after the retries a 5xx earns, as the JAX package's does."""
    def reply(method, path, headers, body):
        return json_reply({"error": {"code": str(status)}}, status)

    with StubServer(reply) as stub:
        errs, seen = [], []
        for pkg, table_cls in ((jservices, JTable), (tservices, TTable)):
            stub.requests.clear()
            stage = pkg.TextSentiment(
                url=stub.url + "/language", subscriptionKey=KEY,
                maxRetries=2, backoff=0.0, outputCol="out", errorCol="err")
            out = stage.transform(table_cls(texts()))
            errs.append(list(out["err"]))
            seen.append([(m, p, b) for m, p, h, b in stub.requests])
    assert errs[0] == errs[1] and errs[0][0]["statusCode"] == status
    assert errs[0][1] is None
    assert seen[0] == seen[1]
    assert len(seen[0]) == (2 if status == 400 else 6)


def test_poll_exhaustion_is_a_504_as_in_the_reference():
    def reply(method, path, headers, body):
        if path.startswith("/op"):
            return json_reply({"status": "running"})
        return json_reply({}, 202, {"Operation-Location":
                                    f"{stub.url}/op/1"})

    with StubServer(reply) as stub:
        errs = []
        for pkg, table_cls in ((jservices, JTable), (tservices, TTable)):
            stage = pkg.AnalyzeLayout(
                url=stub.url, imageUrlCol="url", pollInterval=0.0,
                maxPollRetries=3, outputCol="out", errorCol="err")
            errs.append(stage.transform(table_cls(images()))["err"][0])
        polls = [p for m, p, h, b in stub.requests if p.startswith("/op")]
    assert errs[0] == errs[1] and errs[0]["statusCode"] == 504
    assert len(polls) == 2 * 2 * 3      # two packages, two rows, 3 polls


def test_multivariate_fit_lifecycle_equals_the_reference(service):
    """SimpleFitMultivariateAnomaly: the training submit, its Location, the
    status polls to READY, and the fitted detector's params."""
    got = []
    for pkg in (jservices, tservices):
        service.reset()
        opener = RecordingOpener(service.stub.url)
        est = pkg.SimpleFitMultivariateAnomaly(
            dataSource="https://blob/train.zip", startTime="s", endTime="e",
            pollInterval=0.0, subscriptionKey=KEY, opener=opener,
            seriesCol="vars")
        est.setLocation("eastus")
        model = est.fit()
        got.append((type(model).__name__, model.get("modelId"),
                    model.get("url"), model.get("seriesCol"), opener.calls))
    assert got[0] == got[1]
    assert got[1][1] == "1" and len(got[1][4]) == 3


def test_azure_search_writer_batches_as_the_reference():
    def reply(method, path, headers, body):
        return json_reply({"value": []})

    with StubServer(reply) as stub:
        seen = []
        for pkg, table_cls in ((jservices, JTable), (tservices, TTable)):
            stub.requests.clear()
            w = pkg.AzureSearchWriter("svc", "idx", KEY, batch_size=2,
                                      url=stub.url)
            n = w.write(table_cls({
                "id": np.array(["1", "2", "3", "4", "5"], dtype=object),
                "score": np.array([0.5, 1.5, 2.0, 3.0, 4.25],
                                  dtype=np.float32),
                "n": np.arange(5),
                "@search.action": col("upload", "delete", "merge",
                                      "upload", "upload")}))
            seen.append((n, [(m, p, h["content-type"], h["api-key"], b)
                             for m, p, h, b in stub.requests]))
    assert seen[0] == seen[1]
    assert seen[1][0] == 5 and len(seen[1][1]) == 3
    assert json.loads(seen[1][1][0][4])["value"][1]["@search.action"] \
        == "delete"


def test_bing_download_from_urls_equals_the_reference():
    def reply(method, path, headers, body):
        return (404, {}, b"") if "missing" in path else \
            (200, {}, path.encode())

    with StubServer(reply) as stub:
        urls = [f"{stub.url}/img/{i}" for i in range(4)] + \
            [f"{stub.url}/missing"]
        got = [pkg.BingImageSearch.downloadFromUrls(urls, concurrency=3)
               for pkg in (jservices, tservices)]
    assert got[0] == got[1] and got[1][0] == b"/img/0" and got[1][4] is None


def _analyze_column():
    return col({"analyzeResult": DONE["analyzeResult"]},
               {"documents": [{"fields": {"Tax": {"type": "number",
                                                  "valueNumber": 1.0},
                                          "Vendor": {"content": "x"}}}]},
               None)


def test_form_ontology_learner_equals_the_reference():
    outs = []
    for pkg, table_cls in ((jservices, JTable), (tservices, TTable)):
        df = table_cls({"doc": _analyze_column()})
        model = pkg.FormOntologyLearner(inputCol="doc").fit(df)
        out = model.transform(df)
        outs.append((model.get("ontology"),
                     {c: list(out[c]) for c in out.columns if c != "doc"}))
    assert outs[0] == outs[1]
    assert outs[1][0] == {"Total": "number", "Vendor": "string",
                          "Tax": "number"}


def test_form_ontology_transformer_equals_the_reference():
    onto = {"Vendor": "string", "Missing": "string", "Tax": "number"}
    outs = []
    for pkg, table_cls in ((jservices, JTable), (tservices, TTable)):
        t = pkg.FormOntologyTransformer(ontology=onto, inputCol="doc")
        out = t.transform(table_cls({"doc": _analyze_column()}))
        outs.append({c: list(out[c]) for c in ("Vendor", "Missing", "Tax")})
    assert outs[0] == outs[1] and outs[1]["Vendor"] == ["Contoso", "x", None]


@pytest.mark.parametrize("name", sorted(set(jservices.__all__)
                                        - {"AzureSearchWriter"}))
def test_params_and_defaults_are_the_references(name):
    jcls, tcls = getattr(jservices, name), getattr(tservices, name)
    jp, tp = jcls._params, tcls._params
    assert set(jp) == set(tp), name
    for p in jp:
        assert tp[p].default == jp[p].default, (name, p)
        assert tp[p].is_complex == jp[p].is_complex, (name, p)
