"""PowerBI streaming-dataset writer.

Reference: io/powerbi/PowerBIWriter.scala — POSTs row batches as JSON to a
Power BI push-dataset URL with retry/backoff. Host-side REST only; batches
rows to respect the API's row-per-request limits.

The port's copy of the JAX package's ``io/powerbi.py``. The JAX writer reads
its rows through pandas (``to_pandas().to_dict(orient="records")``); the port
builds the same dicts without pandas (:func:`json_records`), so the POSTed
bytes are the same.
"""

from __future__ import annotations

import json as _json

import numpy as np

from ..core.table import Table
from .http import HTTPRequestData, send_with_retries


def json_records(df: Table) -> list:
    """The table's rows as dicts of plain Python values, in column order: a
    numpy scalar becomes its Python scalar and a vector column's value stays
    its row's array, as pandas' ``to_dict(orient="records")`` gives them."""
    names = df.columns
    return [{n: (v.item() if isinstance(v, np.generic) else v)
             for n, v in zip(names, vals)}
            for vals in zip(*(df[n] for n in names))]


class PowerBIWriter:
    def __init__(self, url: str, batch_size: int = 1000, retries: int = 3,
                 timeout: float = 60.0):
        self.url = url
        self.batch_size = batch_size
        self.retries = retries
        self.timeout = timeout

    def write(self, df: Table) -> int:
        """POST the table in batches; returns number of rows written."""
        rows = json_records(df)
        written = 0
        for start in range(0, len(rows), self.batch_size):
            chunk = rows[start:start + self.batch_size]
            req = HTTPRequestData.from_json_body(self.url, {"rows": chunk})
            resp = send_with_retries(req, timeout=self.timeout,
                                     retries=self.retries)
            if not 200 <= resp.status_code < 300:
                raise RuntimeError(
                    f"PowerBI write failed at row {start}: "
                    f"{resp.status_code} {resp.reason}")
            written += len(chunk)
        return written
