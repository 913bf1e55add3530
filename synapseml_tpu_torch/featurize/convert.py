"""DataConversion: cast columns between types (reference:
core/.../featurize/DataConversion.scala — convertTo boolean/byte/short/integer/
long/float/double/string/toCategorical/clearCategorical/date).

The port's copy of the JAX package's ``featurize/convert.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table

_CASTS = {
    "boolean": np.bool_, "byte": np.int8, "short": np.int16, "integer": np.int32,
    "long": np.int64, "float": np.float32, "double": np.float64,
}

# Java SimpleDateFormat letter runs → strptime directives. Longest runs first;
# single-letter tokens (M/d/H/m/s) map to the same non-padded-tolerant
# directives, matching SimpleDateFormat's lenient parse of e.g. "M/d/yyyy".
_JAVA_TOKENS = [
    ("yyyy", "%Y"), ("yyy", "%Y"), ("yy", "%y"), ("y", "%Y"),
    ("MMMM", "%B"), ("MMM", "%b"), ("MM", "%m"), ("M", "%m"),
    ("dd", "%d"), ("d", "%d"), ("HH", "%H"), ("H", "%H"),
    ("hh", "%I"), ("h", "%I"), ("mm", "%M"), ("m", "%M"),
    ("ss", "%S"), ("s", "%S"), ("SSS", "%f"), ("SS", "%f"), ("S", "%f"),
    ("a", "%p"),
    ("EEEE", "%A"), ("EEE", "%a"), ("zzz", "%Z"), ("z", "%Z"),
    ("XXX", "%z"), ("XX", "%z"), ("X", "%z"), ("Z", "%z"),
]


def _java_to_strptime(fmt: str) -> str:
    """Translate a Java SimpleDateFormat pattern (incl. single-letter tokens
    and 'quoted literals') to a strptime format string."""
    out, i = [], 0
    while i < len(fmt):
        c = fmt[i]
        if c == "'":
            # quoted literal: '' is a literal quote (inside or outside a
            # quoted run), 'text' is verbatim
            if i + 1 < len(fmt) and fmt[i + 1] == "'":
                out.append("'")
                i += 2
                continue
            i += 1
            closed = False
            while i < len(fmt):
                if fmt[i] == "'":
                    if i + 1 < len(fmt) and fmt[i + 1] == "'":
                        out.append("'")
                        i += 2
                        continue
                    i += 1
                    closed = True
                    break
                out.append("%%" if fmt[i] == "%" else fmt[i])
                i += 1
            if not closed:
                raise ValueError(f"unterminated quote in dateTimeFormat {fmt!r}")
            continue
        for tok, rep in _JAVA_TOKENS:
            if fmt.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            if c.isalpha():
                raise ValueError(
                    f"unsupported pattern letter {c!r} in dateTimeFormat "
                    f"{fmt!r}")
            out.append("%%" if c == "%" else c)
            i += 1
    return "".join(out)


class DataConversion(Transformer):
    cols = Param("cols", "Columns to convert", list)
    convertTo = Param("convertTo", "Target type: boolean|byte|short|integer|long|"
                      "float|double|string|date", str, "double")
    dateTimeFormat = Param("dateTimeFormat", "Format for date conversion", str,
                           "yyyy-MM-dd HH:mm:ss")

    def _transform(self, df: Table) -> Table:
        out = df.copy()
        for c in (self.cols or []):
            a = df[c]
            t = self.convertTo
            if t == "string":
                out[c] = np.array([str(v) for v in a], dtype=object)
            elif t == "date":
                fmt = self.dateTimeFormat
                if (a.dtype == object or a.dtype.kind in "US") and fmt:
                    from datetime import datetime
                    try:
                        py_fmt = _java_to_strptime(fmt)
                    except ValueError:
                        # untranslatable pattern: ISO-8601 per-value fallback
                        py_fmt = None

                    def parse_one(v):
                        if py_fmt is not None:
                            try:
                                return np.datetime64(
                                    datetime.strptime(str(v), py_fmt), "s")
                            except ValueError:
                                pass
                        try:
                            # ISO-8601 strings parse regardless of the format
                            return np.datetime64(str(v), "s")
                        except ValueError:
                            raise ValueError(
                                f"cannot parse {v!r} with dateTimeFormat "
                                f"{fmt!r} and it is not ISO-8601") from None

                    out[c] = np.array([parse_one(v) for v in a],
                                      dtype="datetime64[s]")
                else:
                    out[c] = np.asarray(a, dtype="datetime64[s]")
            elif t in _CASTS:
                out[c] = np.asarray(a, dtype=object if a.dtype == object else a.dtype
                                    ).astype(_CASTS[t])
            else:
                raise ValueError(f"unknown convertTo {t!r}; options: "
                                 f"{sorted(_CASTS) + ['string', 'date']}")
        return out
