"""OpenAI / Azure OpenAI transformers.

Reference: cognitive/.../services/openai/ (OpenAICompletion.scala,
OpenAIChatCompletion.scala, OpenAIEmbedding.scala, OpenAIPrompt.scala:22+,
OpenAI.scala shared params). Request/response shapes follow the Azure OpenAI
REST API; ``deploymentName`` + base url compose the endpoint, and every
sampling param is a ServiceParam (scalar or column).

The port's copy of the JAX package's ``services/openai.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import json as _json
import re
from typing import Any, Dict, List

import numpy as np

from ..core.params import Param
from ..core.table import Table
from .base import CognitiveServiceBase


class _OpenAIBase(CognitiveServiceBase):
    deploymentName = Param("deploymentName", "the name of the deployment", str)
    apiVersion = Param("apiVersion", "the API version to use", str,
                       "2024-02-01")
    maxTokens = Param("maxTokens", "maximum tokens to generate", int)
    temperature = Param("temperature", "sampling temperature", float)
    topP = Param("topP", "nucleus sampling probability", float)
    stop = Param("stop", "stop sequence(s)", is_complex=True)
    user = Param("user", "end-user id for abuse monitoring", str)

    _endpoint = "completions"

    def _prepare_headers(self, df, i):
        h = super()._prepare_headers(df, i)
        key = self._resolve("subscriptionKey", df, i)
        if key:  # OpenAI-style auth in addition to the Azure header
            h["api-key"] = str(key)
        return h

    def _prepare_url(self, df: Table, i: int) -> str:
        base = self.get("url")
        if not base:
            raise ValueError(f"{type(self).__name__}: url not set (setUrl("
                             "'https://<resource>.openai.azure.com/'))")
        dep = self._resolve("deploymentName", df, i)
        if not dep:
            raise ValueError("deploymentName is not set")
        return (f"{base.rstrip('/')}/openai/deployments/{dep}/"
                f"{self._endpoint}?api-version={self.getApiVersion()}")

    def _common_body(self, df, i) -> Dict[str, Any]:
        body: Dict[str, Any] = {}
        for name, key in (("maxTokens", "max_tokens"),
                          ("temperature", "temperature"),
                          ("topP", "top_p"), ("stop", "stop"),
                          ("user", "user")):
            v = self._resolve(name, df, i)
            if v is not None:
                body[key] = v
        return body


class OpenAICompletion(_OpenAIBase):
    """Text completion (reference OpenAICompletion.scala)."""

    promptCol = Param("promptCol", "column of prompts", str, "prompt")
    batchPromptCol = Param("batchPromptCol", "column of prompt lists", str)

    _endpoint = "completions"

    def _prepare_body(self, df, i):
        body = self._common_body(df, i)
        if self.isSet("batchPromptCol"):
            body["prompt"] = list(df[self.getBatchPromptCol()][i])
        else:
            body["prompt"] = str(df[self.getPromptCol()][i])
        return body

    def _parse_response(self, parsed, df, i):
        return parsed  # full choices payload (text at choices[*].text)


class OpenAIChatCompletion(_OpenAIBase):
    """Chat completion (reference OpenAIChatCompletion.scala);
    ``messagesCol`` holds a list of {role, content} dicts per row."""

    messagesCol = Param("messagesCol", "column of message lists", str,
                        "messages")

    _endpoint = "chat/completions"

    def _prepare_body(self, df, i):
        body = self._common_body(df, i)
        msgs = df[self.getMessagesCol()][i]
        body["messages"] = list(msgs)
        return body


class OpenAIEmbedding(_OpenAIBase):
    """Embeddings (reference OpenAIEmbedding.scala); output column holds the
    embedding vector as a numpy array (device-ready)."""

    textCol = Param("textCol", "column of texts to embed", str, "text")

    _endpoint = "embeddings"

    def _prepare_body(self, df, i):
        return {"input": str(df[self.getTextCol()][i])}

    def _parse_response(self, parsed, df, i):
        try:
            return np.asarray(parsed["data"][0]["embedding"], dtype=np.float32)
        except (KeyError, IndexError, TypeError):
            return None


class OpenAIPrompt(_OpenAIBase):
    """Prompt templating over table columns (reference OpenAIPrompt.scala:22+):
    ``promptTemplate='classify: {text}'`` renders per row, runs completion (or
    chat), and post-processes the answer (csv/json/regex)."""

    promptTemplate = Param("promptTemplate", "template with {column} "
                           "placeholders", str)
    postProcessing = Param("postProcessing", "one of '', 'csv', 'json', "
                           "'regex'", str, "")
    postProcessingOptions = Param("postProcessingOptions",
                                  "options (e.g. {'regex': ..., 'regexGroup': "
                                  "0})", is_complex=True)
    systemPrompt = Param("systemPrompt", "system message for chat models", str)
    useChat = Param("useChat", "use the chat endpoint", bool, True)

    @property
    def _endpoint(self):  # type: ignore[override]
        return "chat/completions" if self.getUseChat() else "completions"

    def _render(self, df: Table, i: int) -> str:
        tpl = self.get("promptTemplate")
        if tpl is None:
            raise ValueError("OpenAIPrompt: promptTemplate is not set")

        def sub(m):
            col = m.group(1)
            return str(df[col][i])

        return re.sub(r"\{(\w+)\}", sub, tpl)

    def _prepare_body(self, df, i):
        body = self._common_body(df, i)
        prompt = self._render(df, i)
        if self.getUseChat():
            msgs: List[Dict[str, str]] = []
            sys = self.get("systemPrompt")
            if sys:
                msgs.append({"role": "system", "content": sys})
            msgs.append({"role": "user", "content": prompt})
            body["messages"] = msgs
        else:
            body["prompt"] = prompt
        return body

    def _parse_response(self, parsed, df, i):
        try:
            if self.getUseChat():
                text = parsed["choices"][0]["message"]["content"]
            else:
                text = parsed["choices"][0]["text"]
        except (KeyError, IndexError, TypeError):
            return None
        mode = self.getPostProcessing()
        opts = self.get("postProcessingOptions") or {}
        if mode == "csv":
            return [s.strip() for s in text.split(opts.get("delimiter", ","))]
        if mode == "json":
            try:
                return _json.loads(text)
            except Exception:
                return None
        if mode == "regex":
            m = re.search(opts.get("regex", "(.*)"), text)
            return m.group(int(opts.get("regexGroup", 0))) if m else None
        return text.strip()
