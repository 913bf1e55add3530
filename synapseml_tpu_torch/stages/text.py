"""Text preprocessing stages.

Reference: core/.../stages/TextPreprocessor.scala and UnicodeNormalize.scala
(SURVEY.md §2.7).

The port's copy of the JAX package's ``stages/text.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

import unicodedata
from typing import Dict

import numpy as np

from ..core.params import Param, HasInputCol, HasOutputCol
from ..core.pipeline import Transformer
from ..core.table import Table


class _Trie:
    """Longest-match replacement trie (reference: TextPreprocessor.scala Trie —
    normalization map applied by walking the text with longest-prefix match)."""

    __slots__ = ("children", "value")

    def __init__(self):
        self.children: Dict[str, "_Trie"] = {}
        self.value = None

    def insert(self, key: str, value: str):
        node = self
        for ch in key:
            node = node.children.setdefault(ch, _Trie())
        node.value = value

    def translate(self, text: str) -> str:
        out = []
        i, n = 0, len(text)
        while i < n:
            node, j, best, best_end = self, i, None, i
            while j < n and text[j] in node.children:
                node = node.children[text[j]]
                j += 1
                if node.value is not None:
                    best, best_end = node.value, j
            if best is not None:
                out.append(best)
                i = best_end
            else:
                out.append(text[i])
                i += 1
        return "".join(out)


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Apply a longest-match normalization map to a string column.

    Reference: stages/TextPreprocessor.scala (``map`` param, Trie-based
    longest-prefix replacement, optional lowercasing before matching).
    """

    map = Param("map", "Map of substring match to replacement", dict, None)
    normFunc = Param("normFunc", "Name of normalization function to apply before map "
                     "(identity|lowercase)", str, "identity")

    def setMap(self, m: dict) -> "TextPreprocessor":
        return self.set("map", dict(m))

    def _transform(self, df: Table) -> Table:
        trie = _Trie()
        for k, v in (self.get("map") or {}).items():
            trie.insert(k, v)
        lower = self.getNormFunc() == "lowercase"
        col = df[self.getInputCol()]
        out = np.asarray([trie.translate(str(s).lower() if lower else str(s)) for s in col],
                         dtype=object)
        return df.with_column(self.getOutputCol(), out)


class UnicodeNormalize(Transformer, HasInputCol, HasOutputCol):
    """Unicode NFC/NFD/NFKC/NFKD normalization + optional lowercase.

    Reference: stages/UnicodeNormalize.scala (``form`` param, java.text.Normalizer).
    """

    form = Param("form", "Unicode normalization form: NFC, NFD, NFKC, NFKD", str, "NFKD")
    lower = Param("lower", "Lowercase all characters", bool, True)

    def _transform(self, df: Table) -> Table:
        form, lower = self.getForm(), self.getLower()
        col = df[self.getInputCol()]

        def norm(s):
            t = unicodedata.normalize(form, str(s))
            return t.lower() if lower else t

        out = np.asarray([norm(s) for s in col], dtype=object)
        return df.with_column(self.getOutputCol(), out)
