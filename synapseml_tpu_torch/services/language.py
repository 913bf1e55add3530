"""Azure AI Language transformers (sentiment, key phrases, entities, PII,
language detection).

Reference: cognitive/.../services/text/TextAnalytics.scala family (~989 LoC) —
all POST to the analyze-text endpoint with ``{kind, analysisInput{documents}}``
bodies and unwrap ``results.documents``.

The port's copy of the JAX package's ``services/language.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations


from ..core.params import Param
from .base import HasAsyncReply, HasSetLocation


class _TextAnalyticsBase(HasSetLocation):
    textCol = Param("textCol", "column of input texts", str, "text")
    language = Param("language", "language hint", str, "en")
    apiVersion = Param("apiVersion", "API version", str, "2023-04-01")
    kind = "SentimentAnalysis"  # subclass constant
    urlPath = "language/:analyze-text"

    def _prepare_url(self, df, i):
        return (super()._prepare_url(df, i)
                + f"?api-version={self.getApiVersion()}")

    def _prepare_body(self, df, i):
        text = df[self.getTextCol()][i]
        if text is None:
            return None
        lang = self._resolve("language", df, i, "en")
        return {"kind": self.kind,
                "analysisInput": {"documents": [
                    {"id": "0", "text": str(text), "language": lang}]},
                "parameters": self._parameters()}

    def _parameters(self) -> dict:
        return {}

    def _parse_response(self, parsed, df, i):
        try:
            return parsed["results"]["documents"][0]
        except (KeyError, IndexError, TypeError):
            return parsed


class TextSentiment(_TextAnalyticsBase):
    kind = "SentimentAnalysis"


class KeyPhraseExtractor(_TextAnalyticsBase):
    kind = "KeyPhraseExtraction"


class NER(_TextAnalyticsBase):
    kind = "EntityRecognition"


class PII(_TextAnalyticsBase):
    kind = "PiiEntityRecognition"
    domain = Param("domain", "PII domain filter", str)

    def _parameters(self):
        d = self.get("domain")
        return {"domain": d} if d else {}


class EntityLinking(_TextAnalyticsBase):
    kind = "EntityLinking"


class LanguageDetector(_TextAnalyticsBase):
    kind = "LanguageDetection"

    def _prepare_body(self, df, i):
        text = df[self.getTextCol()][i]
        if text is None:
            return None
        return {"kind": self.kind,
                "analysisInput": {"documents": [{"id": "0", "text": str(text)}]},
                "parameters": {}}


class AnalyzeHealthText(_TextAnalyticsBase):
    kind = "Healthcare"


class EntityDetector(_TextAnalyticsBase):
    """Linked-entity detection (reference text/TextAnalytics.scala
    EntityDetector — the v3 'entities/linking' task)."""

    kind = "EntityLinking"


class AnalyzeText(_TextAnalyticsBase):
    """Unified analyze-text transformer: the task kind is a parameter instead
    of a subclass (reference language/AnalyzeText.scala)."""

    kind = "SentimentAnalysis"
    kindParam = Param("kind", "EntityLinking|EntityRecognition|KeyPhrase"
                      "Extraction|LanguageDetection|PiiEntityRecognition|"
                      "SentimentAnalysis", str, "SentimentAnalysis")

    def _prepare_body(self, df, i):
        self.kind = self._resolve("kind", df, i, "SentimentAnalysis")
        if self.kind == "LanguageDetection":
            text = df[self.getTextCol()][i]
            if text is None:
                return None
            return {"kind": self.kind,
                    "analysisInput": {"documents": [{"id": "0",
                                                     "text": str(text)}]},
                    "parameters": {}}
        return super()._prepare_body(df, i)


class TextAnalyze(HasAsyncReply, _TextAnalyticsBase):
    """Multi-task batch analysis (reference text/TextAnalyze.scala — the
    /analyze-text/jobs endpoint running several task kinds over one batch;
    the 202 + operation-location reply is polled via HasAsyncReply)."""

    tasks = Param("tasks", "map task kind -> parameters", is_complex=True)
    urlPath = "language/analyze-text/jobs"

    def _prepare_url(self, df, i):
        return (HasSetLocation._prepare_url(self, df, i)
                + f"?api-version={self.getApiVersion()}")

    def _prepare_body(self, df, i):
        text = df[self.getTextCol()][i]
        if text is None:
            return None
        lang = self._resolve("language", df, i, "en")
        tasks = self.get("tasks") or {"SentimentAnalysis": {}}
        return {"analysisInput": {"documents": [
                    {"id": "0", "text": str(text), "language": lang}]},
                "tasks": [{"kind": k, "parameters": v or {}}
                          for k, v in tasks.items()]}

    def _parse_response(self, parsed, df, i):
        return parsed
