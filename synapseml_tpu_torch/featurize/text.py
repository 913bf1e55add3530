"""Text featurization.

Reference: core/.../featurize/text/{TextFeaturizer,MultiNGram,PageSplitter}.scala.
TextFeaturizer = tokenize → (stopwords) → n-grams → hashing TF → IDF, one
estimator. The hashed term-frequency matrix is a dense (N, numFeatures) float
array — ready to feed the device estimators directly.

The port's copy of the JAX package's ``featurize/text.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ..core.params import Param, HasInputCol, HasOutputCol
from ..core.pipeline import Estimator, Model, Transformer
from ..core.table import Table
from ..vw.hashing import murmur3_32

_DEFAULT_STOPWORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the to was "
    "were will with".split())


def _tokenize(text: str, pattern: str, to_lower: bool, min_len: int) -> List[str]:
    if to_lower:
        text = text.lower()
    toks = re.split(pattern, text)
    return [t for t in toks if len(t) >= min_len]


def _ngrams(tokens: List[str], n: int) -> List[str]:
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


def _hash_tf(terms: List[str], num_features: int, binary: bool) -> np.ndarray:
    v = np.zeros(num_features, np.float32)
    if len(terms) >= 64:
        from ..native import murmur3_32_batch

        idx = murmur3_32_batch(terms, 0, vw_numeric_names=False, mask=0)
        if idx is not None:
            idx = idx % num_features
            if binary:
                v[np.unique(idx)] = 1.0
            else:
                np.add.at(v, idx, 1.0)
            return v
    for t in terms:
        j = murmur3_32(t.encode("utf-8")) % num_features
        v[j] = 1.0 if binary else v[j] + 1.0
    return v


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol):
    """One-stop text → feature-vector estimator (TextFeaturizer.scala)."""
    useTokenizer = Param("useTokenizer", "Tokenize the input", bool, True)
    tokenizerPattern = Param("tokenizerPattern", "Split regex", str, r"\W+")
    toLowercase = Param("toLowercase", "Lowercase before tokenizing", bool, True)
    minTokenLength = Param("minTokenLength", "Minimum token length", int, 1)
    useStopWordsRemover = Param("useStopWordsRemover", "Remove stop words", bool, False)
    useNGram = Param("useNGram", "Produce n-grams", bool, False)
    nGramLength = Param("nGramLength", "n-gram length", int, 2)
    numFeatures = Param("numFeatures", "Hashing-TF dimension (dense device-resident matrix; default 4096 — the reference uses 2^18 sparse)", int, 1 << 12)
    binary = Param("binary", "Binary term presence instead of counts", bool, False)
    useIDF = Param("useIDF", "Apply inverse document frequency weighting", bool, True)
    minDocFreq = Param("minDocFreq", "Minimum document frequency for IDF", int, 1)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)

    def _terms(self, text: str) -> List[str]:
        toks = (_tokenize(str(text), self.tokenizerPattern, self.toLowercase,
                          self.minTokenLength)
                if self.useTokenizer else str(text).split())
        if self.useStopWordsRemover:
            toks = [t for t in toks if t not in _DEFAULT_STOPWORDS]
        return _ngrams(toks, self.nGramLength) if self.useNGram else toks

    def _fit(self, df: Table) -> "TextFeaturizerModel":
        n = df.num_rows
        d = self.numFeatures
        idf = np.zeros(d, np.float64)
        for i in range(n):
            tf = _hash_tf(self._terms(df[self.inputCol][i]), d, binary=True)
            idf += tf
        df_counts = idf
        idf = np.where(df_counts >= self.minDocFreq,
                       np.log((n + 1.0) / (df_counts + 1.0)), 0.0)
        m = TextFeaturizerModel(
            inputCol=self.inputCol, outputCol=self.outputCol,
            useTokenizer=self.useTokenizer, tokenizerPattern=self.tokenizerPattern,
            toLowercase=self.toLowercase, minTokenLength=self.minTokenLength,
            useStopWordsRemover=self.useStopWordsRemover, useNGram=self.useNGram,
            nGramLength=self.nGramLength, numFeatures=d, binary=self.binary,
            useIDF=self.useIDF)
        m.idf_ = idf.astype(np.float32)
        return m


class TextFeaturizerModel(Model, HasInputCol, HasOutputCol):
    useTokenizer = Param("useTokenizer", "Tokenize the input", bool, True)
    tokenizerPattern = Param("tokenizerPattern", "Split regex", str, r"\W+")
    toLowercase = Param("toLowercase", "Lowercase before tokenizing", bool, True)
    minTokenLength = Param("minTokenLength", "Minimum token length", int, 1)
    useStopWordsRemover = Param("useStopWordsRemover", "Remove stop words", bool, False)
    useNGram = Param("useNGram", "Produce n-grams", bool, False)
    nGramLength = Param("nGramLength", "n-gram length", int, 2)
    numFeatures = Param("numFeatures", "Hashing-TF dimension (dense device-resident matrix; default 4096 — the reference uses 2^18 sparse)", int, 1 << 12)
    binary = Param("binary", "Binary term presence", bool, False)
    useIDF = Param("useIDF", "Apply IDF weighting", bool, True)

    idf_: np.ndarray = None

    _terms = TextFeaturizer._terms

    def _can_use_native_tf(self, docs) -> bool:
        """The C tokenizer (split on non-alnum bytes, ascii lowercase) matches
        the default Python pipeline only for plain-ASCII documents with the
        stock settings — guard exactly to keep feature vectors identical."""
        return (self.useTokenizer and self.tokenizerPattern == r"\W+"
                and self.toLowercase and not self.useStopWordsRemover
                and not self.useNGram
                and self.numFeatures & (self.numFeatures - 1) == 0
                and all(isinstance(t, str) and t.isascii() and "_" not in t
                        for t in docs))

    def _transform(self, df: Table) -> Table:
        n = df.num_rows
        docs = [str(t) for t in df[self.inputCol]]
        X = None
        if n >= 64 and self._can_use_native_tf(docs):
            from ..native import hash_tf as native_tf

            X = native_tf(docs, self.numFeatures,
                          min_len=self.minTokenLength, binary=self.binary)
        if X is None:
            X = np.zeros((n, self.numFeatures), np.float32)
            for i in range(n):
                X[i] = _hash_tf(self._terms(docs[i]), self.numFeatures,
                                self.binary)
        if self.useIDF and self.idf_ is not None:
            X = X * self.idf_[None, :]
        return df.with_column(self.outputCol, X)

    def _save_extra(self, path: str) -> None:
        import os
        if self.idf_ is not None:
            np.save(os.path.join(path, "idf.npy"), self.idf_)

    def _load_extra(self, path: str) -> None:
        import os
        f = os.path.join(path, "idf.npy")
        if os.path.exists(f):
            self.idf_ = np.load(f)


class MultiNGram(Transformer, HasInputCol, HasOutputCol):
    """Concatenate n-grams of several lengths (MultiNGram.scala)."""
    lengths = Param("lengths", "N-gram lengths to produce", list, [1, 2, 3])

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "ngrams")
        super().__init__(**kwargs)

    def _transform(self, df: Table) -> Table:
        out = np.empty(df.num_rows, object)
        for i in range(df.num_rows):
            toks = list(df[self.inputCol][i])
            grams: List[str] = []
            for n in (self.lengths or [1]):
                grams.extend(_ngrams(toks, int(n)))
            out[i] = grams
        return df.with_column(self.outputCol, out)


class PageSplitter(Transformer, HasInputCol, HasOutputCol):
    """Split text into pages within [minimum, maximum] character bounds on
    whitespace boundaries where possible (PageSplitter.scala)."""
    maximumPageLength = Param("maximumPageLength", "Max chars per page", int, 5000)
    minimumPageLength = Param("minimumPageLength", "Preferred min chars per page", int, 4500)
    boundaryRegex = Param("boundaryRegex", "Preferred split boundary", str, r"\s")

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "pages")
        super().__init__(**kwargs)

    def _transform(self, df: Table) -> Table:
        out = np.empty(df.num_rows, object)
        for i in range(df.num_rows):
            text = str(df[self.inputCol][i])
            pages = []
            start = 0
            while start < len(text):
                end = min(start + self.maximumPageLength, len(text))
                if end < len(text):
                    # prefer a boundary in [min, max)
                    window = text[start + self.minimumPageLength:end]
                    m = list(re.finditer(self.boundaryRegex, window))
                    if m:
                        end = start + self.minimumPageLength + m[-1].end()
                pages.append(text[start:end])
                start = end
            out[i] = pages
        return df.with_column(self.outputCol, out)
