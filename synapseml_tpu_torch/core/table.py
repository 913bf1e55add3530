"""Columnar ``Table`` — the framework's DataFrame.

A copy of the JAX package's ``core/table.py``. The reference fronts everything
with Spark DataFrames; here the front is a thin, Arrow-friendly columnar table
whose columns are numpy arrays (host) that the execution layer moves to the
device as tensors when compute starts. Spark's roles
(partitioned tables, task launch, collect) are played by the host-orchestration
layer + sharded ingest (SURVEY.md §7 "Design stance").

Columns may be:
  * 1-D numpy arrays (numeric, bool, or object/str) — scalar columns
  * 2-D numpy arrays — fixed-width vector columns (the SparkML `Vector` analog)
  * object arrays of variable-length sequences — list columns (minibatch outputs)

Interop: ``from_pandas`` / ``to_pandas`` / ``from_arrow`` / ``to_arrow`` /
``read_csv`` / ``read_parquet``; everything stays zero-copy where numpy allows.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np


class Table:
    """An ordered mapping of column name → numpy array, all with equal length."""

    __slots__ = ("_cols", "_nrows", "num_shards_hint", "concurrency_hint")

    def __init__(self, cols: Optional[Mapping[str, Any]] = None):
        self._cols: dict[str, np.ndarray] = {}
        self._nrows: Optional[int] = None
        # execution hints attached by Repartition / PartitionConsolidator stages
        self.num_shards_hint: Optional[int] = None
        self.concurrency_hint: Optional[int] = None
        if cols:
            for k, v in cols.items():
                self[k] = v

    # --- construction ---------------------------------------------------
    @staticmethod
    def from_pandas(df) -> "Table":
        t = Table()
        for name in df.columns:
            col = df[name]
            arr = col.to_numpy()
            t[str(name)] = arr
        return t

    @staticmethod
    def from_arrow(at) -> "Table":
        t = Table()
        for name in at.column_names:
            t[str(name)] = at.column(name).to_numpy(zero_copy_only=False)
        return t

    @staticmethod
    def read_csv(path: str, **kwargs) -> "Table":
        import pandas as pd

        return Table.from_pandas(pd.read_csv(path, **kwargs))

    @staticmethod
    def read_parquet(path: str, columns: Optional[list] = None) -> "Table":
        import pyarrow.parquet as pq

        return Table.from_arrow(pq.read_table(path, columns=columns))

    def to_pandas(self):
        import pandas as pd

        out = {}
        for k, v in self._cols.items():
            if v.ndim == 2:
                out[k] = list(v)  # vector column → column of arrays
            else:
                out[k] = v
        return pd.DataFrame(out)

    def to_arrow(self):
        import pyarrow as pa

        arrays, names = [], []
        for k, v in self._cols.items():
            if v.ndim == 2:
                arrays.append(pa.array(list(v)))
            else:
                arrays.append(pa.array(v))
            names.append(k)
        return pa.table(arrays, names=names)

    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq

        pq.write_table(self.to_arrow(), path)

    # --- mapping protocol -----------------------------------------------
    def __setitem__(self, name: str, value) -> None:
        arr = value if isinstance(value, np.ndarray) else np.asarray(value)
        if arr.ndim == 0:
            raise ValueError(f"column {name!r}: scalar is not a column")
        n = arr.shape[0]
        if self._nrows is not None and self._cols and n != self._nrows:
            raise ValueError(
                f"column {name!r} has {n} rows; table has {self._nrows}")
        self._cols[name] = arr
        self._nrows = n

    def __getitem__(self, name):
        if isinstance(name, (list, tuple)):
            return self.select(list(name))
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __delitem__(self, name: str) -> None:
        del self._cols[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._cols)

    def __len__(self) -> int:
        return self._nrows or 0

    @property
    def num_rows(self) -> int:
        return self._nrows or 0

    @property
    def columns(self) -> list:
        return list(self._cols)

    def schema(self) -> dict:
        return {k: (v.dtype, v.shape[1:]) for k, v in self._cols.items()}

    # --- relational ops --------------------------------------------------
    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self._cols[n] for n in names})

    def drop(self, *names: str) -> "Table":
        return Table({k: v for k, v in self._cols.items() if k not in names})

    def with_column(self, name: str, value) -> "Table":
        out = self.copy()
        out[name] = value
        return out

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self._cols.items()})

    def copy(self) -> "Table":
        t = Table()
        t._cols = dict(self._cols)
        t._nrows = self._nrows
        t.num_shards_hint = self.num_shards_hint
        t.concurrency_hint = self.concurrency_hint
        return t

    def take(self, indices) -> "Table":
        idx = np.asarray(indices)
        return Table({k: v[idx] for k, v in self._cols.items()})

    def slice(self, start: int, stop: Optional[int] = None) -> "Table":
        return Table({k: v[start:stop] for k, v in self._cols.items()})

    def head(self, n: int = 5) -> "Table":
        return self.slice(0, n)

    def filter(self, mask) -> "Table":
        m = np.asarray(mask, dtype=bool)
        return Table({k: v[m] for k, v in self._cols.items()})

    def concat(self, *others: "Table") -> "Table":
        tables = (self,) + others
        names = self.columns
        for o in others:
            if o.columns != names:
                raise ValueError("concat requires identical column sets/order")
        return Table({n: np.concatenate([t._cols[n] for t in tables]) for n in names})

    def sample(self, fraction: float, seed: int = 0, replace: bool = False) -> "Table":
        rng = np.random.default_rng(seed)
        n = self.num_rows
        k = int(round(n * fraction))
        idx = rng.choice(n, size=k, replace=replace)
        return self.take(idx)

    def random_split(self, weights: Sequence[float], seed: int = 0) -> list:
        """Row-wise random split, the analog of DataFrame.randomSplit (used for
        numBatches batching, reference: LightGBMBase.scala:45-60)."""
        rng = np.random.default_rng(seed)
        n = self.num_rows
        perm = rng.permutation(n)
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        bounds = np.floor(np.cumsum(w) * n).astype(int)
        parts, start = [], 0
        for b in bounds:
            parts.append(self.take(np.sort(perm[start:b])))
            start = b
        return parts

    def shard(self, num_shards: int, pad: bool = True) -> list:
        """Split rows into ``num_shards`` near-equal contiguous shards (the
        partition analog). With ``pad``, every shard gets the same length by
        repeating trailing rows, so shards stack into an SPMD leading axis."""
        n = self.num_rows
        per = -(-n // num_shards)
        shards = []
        for i in range(num_shards):
            s = self.slice(i * per, min((i + 1) * per, n))
            if pad and s.num_rows < per and s.num_rows > 0:
                reps = per - s.num_rows
                filler = s.take(np.arange(reps) % s.num_rows)
                s = s.concat(filler)
            shards.append(s)
        return shards

    def group_indices(self, col: str):
        """Return (unique_values, inverse_index) for a grouping column."""
        vals, inv = np.unique(self._cols[col], return_inverse=True)
        return vals, inv

    def sort_by(self, col: str, ascending: bool = True) -> "Table":
        order = np.argsort(self._cols[col], kind="stable")
        if not ascending:
            order = order[::-1]
        return self.take(order)

    def iter_batches(self, batch_size: int) -> Iterator["Table"]:
        for start in range(0, self.num_rows, batch_size):
            yield self.slice(start, start + batch_size)

    def to_rows(self) -> list:
        names = self.columns
        cols = [self._cols[n] for n in names]
        return [dict(zip(names, vals)) for vals in zip(*cols)]

    @staticmethod
    def from_rows(rows: Iterable[Mapping[str, Any]]) -> "Table":
        rows = list(rows)
        if not rows:
            return Table()
        names = list(rows[0])
        return Table({n: np.asarray([r[n] for r in rows]) for n in names})

    def __repr__(self):
        parts = ", ".join(f"{k}:{v.dtype}{list(v.shape[1:]) or ''}" for k, v in self._cols.items())
        return f"Table[{self.num_rows} rows]({parts})"


def feature_matrix(df: Table, featuresCol: str, dtype=np.float32) -> np.ndarray:
    """Resolve the features column to a dense 2-D float matrix.

    Accepts a 2-D vector column, or — if ``featuresCol`` is absent — treats every
    numeric column except obvious label/weight names as a feature (the lightweight
    analog of running Featurize/VectorAssembler first)."""
    if featuresCol in df:
        arr = df[featuresCol]
        if arr.ndim == 1 and arr.dtype == object:
            arr = np.stack([np.asarray(a, dtype=dtype) for a in arr])
        return np.ascontiguousarray(arr, dtype=dtype)
    raise KeyError(
        f"features column {featuresCol!r} not in table (columns: {df.columns}); "
        "use Featurize or assemble_features() to build it")


def assemble_features(df: Table, input_cols: Sequence[str], output_col: str = "features") -> Table:
    """VectorAssembler analog: stack scalar/vector columns into one 2-D column."""
    mats = []
    for c in input_cols:
        a = df[c]
        mats.append(a[:, None] if a.ndim == 1 else a)
    return df.with_column(output_col, np.concatenate([np.asarray(m, np.float32) for m in mats], axis=1))
