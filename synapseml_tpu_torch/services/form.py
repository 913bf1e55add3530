"""Document Intelligence (Form Recognizer) prebuilt-model transformers.

Reference: cognitive/.../services/form/FormRecognizer.scala (~849 LoC:
AnalyzeLayout, AnalyzeReceipts, AnalyzeBusinessCards, AnalyzeInvoices,
AnalyzeIDDocuments, AnalyzeCustomModel, plus management ops). All share the
submit+poll LRO flow implemented in speech.AnalyzeDocument; these subclasses
pin the prebuilt model ids.

The port's copy of the JAX package's ``services/form.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

from ..core.params import Param
from ..core.pipeline import Estimator, Transformer
from .speech import AnalyzeDocument


class AnalyzeLayout(AnalyzeDocument):
    def __init__(self, **kwargs):
        kwargs.setdefault("modelId", "prebuilt-layout")
        super().__init__(**kwargs)


class AnalyzeReceipts(AnalyzeDocument):
    def __init__(self, **kwargs):
        kwargs.setdefault("modelId", "prebuilt-receipt")
        super().__init__(**kwargs)


class AnalyzeBusinessCards(AnalyzeDocument):
    def __init__(self, **kwargs):
        kwargs.setdefault("modelId", "prebuilt-businessCard")
        super().__init__(**kwargs)


class AnalyzeInvoices(AnalyzeDocument):
    def __init__(self, **kwargs):
        kwargs.setdefault("modelId", "prebuilt-invoice")
        super().__init__(**kwargs)


class AnalyzeIDDocuments(AnalyzeDocument):
    def __init__(self, **kwargs):
        kwargs.setdefault("modelId", "prebuilt-idDocument")
        super().__init__(**kwargs)


class AnalyzeDocumentRead(AnalyzeDocument):
    def __init__(self, **kwargs):
        kwargs.setdefault("modelId", "prebuilt-read")
        super().__init__(**kwargs)


class AnalyzeCustomModel(AnalyzeDocument):
    """Custom-trained model: set ``modelId`` to the trained model's id
    (reference AnalyzeCustomModel)."""


class GetCustomModel(AnalyzeDocument):
    """Fetch a custom model's metadata (reference form/FormRecognizer.scala
    GetCustomModel — GET documentModels/{modelId})."""

    includeKeys = Param("includeKeys", "include learned keys", bool, False)

    def _prepare_method(self):
        return "GET"

    def _prepare_body(self, df, i):
        return b""  # GET: non-None sentinel so the row is dispatched

    def _prepare_url(self, df, i):
        base = self.get("url")
        if not base:
            raise ValueError("set url/location first")
        root = base.split("/formrecognizer")[0].rstrip("/")
        mid = self._resolve("modelId", df, i)
        return (f"{root}/formrecognizer/documentModels/{mid}"
                f"?api-version={self.getApiVersion()}")


class ListCustomModels(GetCustomModel):
    """List custom models (reference ListCustomModels — GET documentModels)."""

    def _prepare_url(self, df, i):
        base = self.get("url")
        if not base:
            raise ValueError("set url/location first")
        root = base.split("/formrecognizer")[0].rstrip("/")
        return (f"{root}/formrecognizer/documentModels"
                f"?api-version={self.getApiVersion()}")


class FormOntologyLearner(Estimator):
    """Estimator over AnalyzeDocument outputs: learns the union schema
    ("ontology") of extracted document fields, producing a
    FormOntologyTransformer that projects each document's fields onto the
    learned columns (reference form/FormOntologyLearner.scala)."""

    inputCol = Param("inputCol", "column of analyzeResult outputs", str)

    def _fit(self, df):
        from collections import OrderedDict

        col = self.get("inputCol")
        fields: "OrderedDict[str, str]" = OrderedDict()
        for v in df[col]:
            for doc in ((v or {}).get("analyzeResult", v or {}) or
                        {}).get("documents", []):
                for name, fld in (doc.get("fields") or {}).items():
                    fields.setdefault(name, (fld or {}).get("type", "string"))
        t = FormOntologyTransformer(ontology=dict(fields))
        t.set("inputCol", col)
        return t


class FormOntologyTransformer(Transformer):
    """Projects analyzeResult documents onto the learned ontology columns
    (reference FormOntologyTransformer)."""

    ontology = Param("ontology", "field name -> type", is_complex=True)
    inputCol = Param("inputCol", "column of analyzeResult outputs", str)

    def _transform(self, df):
        import numpy as np

        col = self.get("inputCol")
        onto = self.get("ontology") or {}
        out = df.copy()
        cols = {name: np.empty(df.num_rows, dtype=object) for name in onto}
        for i, v in enumerate(df[col]):
            docs = ((v or {}).get("analyzeResult", v or {}) or
                    {}).get("documents", [])
            flds = (docs[0].get("fields") or {}) if docs else {}
            for name in onto:
                fld = flds.get(name) or {}
                out_v = fld.get("valueString", fld.get("valueNumber",
                                fld.get("content")))
                cols[name][i] = out_v
        for name, arr in cols.items():
            out = out.with_column(name, arr)
        return out
