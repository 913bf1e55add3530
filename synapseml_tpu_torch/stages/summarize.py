"""Dataset summarization stage.

Reference: core/.../stages/SummarizeData.scala (SURVEY.md §2.7) — emits one row
per input column with counts / quantiles / basic statistics / error rates,
toggled by boolean params.

The port's copy of the JAX package's ``stages/summarize.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table


class SummarizeData(Transformer):
    counts = Param("counts", "Compute count statistics (count, unique, missing)", bool, True)
    basic = Param("basic", "Compute basic statistics (mean, stddev, min, max)", bool, True)
    sample = Param("sample", "Compute sample statistics (variance, skew, kurtosis)", bool, True)
    percentiles = Param("percentiles", "Compute percentiles (0.5, 1, 5, 25, 50, 75, 95, 99, 99.5)", bool, True)
    errorThreshold = Param("errorThreshold", "Threshold for quantiles - 0 is exact", float, 0.0)

    _PCTS = [0.005, 0.01, 0.05, 0.25, 0.50, 0.75, 0.95, 0.99, 0.995]

    def _transform(self, df: Table) -> Table:
        rows = []
        for name in df.columns:
            col = df[name]
            if col.ndim != 1:
                continue
            row = {"Feature": name}
            numeric = np.issubdtype(col.dtype, np.number)
            vals = col.astype(np.float64) if numeric else None
            finite = vals[np.isfinite(vals)] if numeric else None
            if self.getCounts():
                row["Count"] = len(col)
                row["Unique Value Count"] = len(np.unique(col[~_is_missing(col)]))
                row["Missing Value Count"] = int(_is_missing(col).sum())
            if self.getBasic():
                row["Mean"] = float(finite.mean()) if numeric and len(finite) else np.nan
                row["Standard Deviation"] = float(finite.std(ddof=1)) if numeric and len(finite) > 1 else np.nan
                row["Min"] = float(finite.min()) if numeric and len(finite) else np.nan
                row["Max"] = float(finite.max()) if numeric and len(finite) else np.nan
            if self.getSample():
                if numeric and len(finite) > 2:
                    m = finite.mean()
                    s = finite.std(ddof=1)
                    z = (finite - m) / s if s > 0 else np.zeros_like(finite)
                    row["Sample Variance"] = float(s ** 2)
                    row["Sample Skewness"] = float((z ** 3).mean())
                    row["Sample Kurtosis"] = float((z ** 4).mean() - 3.0)
                else:
                    row["Sample Variance"] = row["Sample Skewness"] = row["Sample Kurtosis"] = np.nan
            if self.getPercentiles():
                for p in self._PCTS:
                    key = f"Quantile {p*100:g}%"
                    row[key] = float(np.quantile(finite, p)) if numeric and len(finite) else np.nan
            rows.append(row)
        return Table.from_rows(rows)


def _is_missing(col: np.ndarray) -> np.ndarray:
    if np.issubdtype(col.dtype, np.number):
        return ~np.isfinite(col.astype(np.float64))
    return np.asarray([v is None or (isinstance(v, str) and v == "") for v in col])
