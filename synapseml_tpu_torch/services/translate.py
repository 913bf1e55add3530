"""Azure Translator transformers.

Reference: cognitive/.../services/translate/ (~885 LoC: Translate,
Transliterate, Detect, BreakSentence, DictionaryLookup). All POST arrays of
``{Text: ...}`` to api.cognitive.microsofttranslator.com endpoints.

The port's copy of the JAX package's ``services/translate.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations


from ..core.params import Param
from .base import CognitiveServiceBase

_BASE = "https://api.cognitive.microsofttranslator.com"


class _TranslatorBase(CognitiveServiceBase):
    textCol = Param("textCol", "column of input texts", str, "text")
    apiVersion = Param("apiVersion", "API version", str, "3.0")
    subscriptionRegion = Param("subscriptionRegion", "resource region", str)
    _path = "translate"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.isSet("url"):
            self.set("url", _BASE)

    def _query(self, df, i) -> str:
        return f"?api-version={self.getApiVersion()}"

    def _prepare_url(self, df, i):
        return f"{self.get('url').rstrip('/')}/{self._path}{self._query(df, i)}"

    def _prepare_headers(self, df, i):
        h = super()._prepare_headers(df, i)
        region = self._resolve("subscriptionRegion", df, i)
        if region:
            h["Ocp-Apim-Subscription-Region"] = str(region)
        return h

    def _prepare_body(self, df, i):
        text = df[self.getTextCol()][i]
        if text is None:
            return None
        texts = text if isinstance(text, (list, tuple)) else [text]
        return [{"Text": str(t)} for t in texts]


class Translate(_TranslatorBase):
    toLanguage = Param("toLanguage", "target language(s)", is_complex=True)
    fromLanguage = Param("fromLanguage", "source language", str)
    _path = "translate"

    def _query(self, df, i):
        to = self._resolve("toLanguage", df, i)
        if to is None:
            raise ValueError("Translate: toLanguage is not set")
        to_list = to if isinstance(to, (list, tuple)) else [to]
        q = f"?api-version={self.getApiVersion()}"
        for t in to_list:
            q += f"&to={t}"
        frm = self._resolve("fromLanguage", df, i)
        if frm:
            q += f"&from={frm}"
        return q


class Detect(_TranslatorBase):
    _path = "detect"


class BreakSentence(_TranslatorBase):
    _path = "breaksentence"


class Transliterate(_TranslatorBase):
    language = Param("language", "source language", str)
    fromScript = Param("fromScript", "source script", str)
    toScript = Param("toScript", "target script", str)
    _path = "transliterate"

    def _query(self, df, i):
        vals = {n: self._resolve(n, df, i)
                for n in ("language", "fromScript", "toScript")}
        missing = [n for n, v in vals.items() if v is None]
        if missing:
            raise ValueError(f"Transliterate: {', '.join(missing)} not set")
        return (f"?api-version={self.getApiVersion()}"
                f"&language={vals['language']}"
                f"&fromScript={vals['fromScript']}"
                f"&toScript={vals['toScript']}")


class DictionaryLookup(_TranslatorBase):
    fromLanguage = Param("fromLanguage", "source language", str)
    toLanguage = Param("toLanguage", "target language", is_complex=True)
    _path = "dictionary/lookup"

    def _query(self, df, i):
        frm = self._resolve("fromLanguage", df, i)
        to = self._resolve("toLanguage", df, i)
        if frm is None or to is None:
            raise ValueError(
                "DictionaryLookup: fromLanguage and toLanguage must be set")
        return f"?api-version={self.getApiVersion()}&from={frm}&to={to}"


class DictionaryExamples(_TranslatorBase):
    """Dictionary usage examples (reference translate/Translator.scala
    DictionaryExamples): POST [{Text, Translation}] pairs."""

    fromLanguage = Param("fromLanguage", "source language", str, "en")
    toLanguage = Param("toLanguage", "target language", str)
    translationCol = Param("translationCol", "column of normalized "
                           "translations (paired with textCol)", str)
    _path = "dictionary/examples"

    def _query(self, df, i):
        to = self._resolve("toLanguage", df, i)
        if to is None:
            raise ValueError("DictionaryExamples: toLanguage is not set")
        return (f"?api-version={self.getApiVersion()}"
                f"&from={self._resolve('fromLanguage', df, i, 'en')}&to={to}")

    def _prepare_body(self, df, i):
        text = df[self.getTextCol()][i]
        if text is None:
            return None
        trans = (df[self.get("translationCol")][i]
                 if self.isSet("translationCol") else text)
        texts = text if isinstance(text, (list, tuple)) else [text]
        transl = trans if isinstance(trans, (list, tuple)) else [trans]
        return [{"Text": str(t), "Translation": str(tr)}
                for t, tr in zip(texts, transl)]


class DocumentTranslator(CognitiveServiceBase):
    """Asynchronous blob-to-blob document translation (reference
    translate/DocumentTranslator.scala): POST /batches with
    source/target container urls; output = operation status url."""

    serviceName = Param("serviceName", "translator resource name", str)
    sourceUrl = Param("sourceUrl", "source container SAS url", str)
    targetUrl = Param("targetUrl", "target container SAS url", str)
    targetLanguage = Param("targetLanguage", "target language", str, "fr")
    filterPrefix = Param("filterPrefix", "blob name prefix filter", str)
    storageType = Param("storageType", "Folder|File", str, "Folder")

    def _prepare_url(self, df, i):
        if self.get("url"):
            return self.get("url")
        name = self.get("serviceName")
        if not name:
            raise ValueError("DocumentTranslator: set serviceName or url")
        return (f"https://{name}.cognitiveservices.azure.com/"
                "translator/text/batch/v1.0/batches")

    def _prepare_body(self, df, i):
        src = self._resolve("sourceUrl", df, i)
        tgt = self._resolve("targetUrl", df, i)
        if src is None or tgt is None:
            return None
        source = {"sourceUrl": str(src), "storageSource": "AzureBlob"}
        pre = self._resolve("filterPrefix", df, i)
        if pre:
            source["filter"] = {"prefix": str(pre)}
        return {"inputs": [{
            "source": source,
            "storageType": self._resolve("storageType", df, i, "Folder"),
            "targets": [{"targetUrl": str(tgt), "storageSource": "AzureBlob",
                         "language": self._resolve("targetLanguage", df, i,
                                                   "fr")}]}]}
