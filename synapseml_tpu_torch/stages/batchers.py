"""Mini-batching stages.

Reference: core/.../stages/MiniBatchTransformer.scala:55-253 and
stages/Batchers.scala:11-130 (Dynamic/Fixed/TimeInterval iterators), plus
FlattenBatch (the inverse). In the reference these convert row iterators into
rows-of-Seqs for batch-oriented transformers (ONNXModel, HTTP, cognitive). Here
a "batched" Table has object-dtype columns whose elements are per-batch numpy
arrays; FixedMiniBatchTransformer can also pad the trailing batch so every
batch has one static shape — what a captured CUDA graph wants.

The port's copy of the JAX package's ``stages/batchers.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import time

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table


def _to_batched(df: Table, sizes: list) -> Table:
    """Slice each column into len(sizes) batches (object arrays of arrays)."""
    out = Table()
    bounds = np.cumsum([0] + list(sizes))
    for name in df.columns:
        col = df[name]
        batched = np.empty(len(sizes), dtype=object)
        for i in range(len(sizes)):
            batched[i] = col[bounds[i]:bounds[i + 1]]
        out[name] = batched
    return out


class FixedMiniBatchTransformer(Transformer):
    """Group rows into fixed-size batches.

    Reference: FixedMiniBatchTransformer (stages/MiniBatchTransformer.scala:150-180,
    FixedBatchIterator stages/Batchers.scala:31-47). ``buffered`` there uses a
    background thread; irrelevant in columnar execution. Extension: ``padBatches``
    repeats trailing rows so every batch is exactly ``batchSize`` — static shapes
    keep a captured program from recapturing on the ragged final batch.
    """

    batchSize = Param("batchSize", "The max size of the buffer", int, 10)
    maxBufferSize = Param("maxBufferSize", "The max size of the buffer", int, 2147483647)
    buffered = Param("buffered", "Whether to buffer batches in advance", bool, False)
    padBatches = Param(
        "padBatches",
        "Pad the final batch to batchSize by repeating trailing rows (adds a "
        "'__pad__' boolean column marking synthetic rows)", bool, False)

    def _transform(self, df: Table) -> Table:
        n = df.num_rows
        bs = self.getBatchSize()
        if n == 0:
            return _to_batched(df, [])
        if self.getPadBatches() and n % bs != 0:
            reps = bs - (n % bs)
            filler = df.take(np.arange(reps) % n)
            pad_flag = np.concatenate([np.zeros(n, bool), np.ones(reps, bool)])
            df = df.concat(filler).with_column("__pad__", pad_flag)
            n += reps
        sizes = [bs] * (n // bs) + ([n % bs] if n % bs else [])
        return _to_batched(df, sizes)


class DynamicMiniBatchTransformer(Transformer):
    """Batch "whatever is available now" — one batch per poll.

    Reference: DynamicMiniBatchTransformer (stages/MiniBatchTransformer.scala:100-126,
    DynamicBufferedBatcher stages/Batchers.scala:49-99). On a materialized Table
    the whole input is available, so this yields a single batch capped at
    ``maxBatchSize`` (matching the reference's semantics when the upstream
    iterator is already drained).
    """

    maxBatchSize = Param("maxBatchSize", "The max size of the buffer", int, 2147483647)

    def _transform(self, df: Table) -> Table:
        n = df.num_rows
        cap = self.getMaxBatchSize()
        if n == 0:
            return _to_batched(df, [])
        sizes = [min(cap, n - s) for s in range(0, n, cap)]
        return _to_batched(df, sizes)


class TimeIntervalMiniBatchTransformer(Transformer):
    """Batch by wall-clock interval while consuming a row stream.

    Reference: TimeIntervalMiniBatchTransformer (stages/MiniBatchTransformer.scala:128-148,
    TimeIntervalBatcher stages/Batchers.scala:101-130). Meaningful for streaming
    serving queues; on a static Table all rows are already available within one
    interval, so this produces a single batch (capped by ``maxBatchSize``), and
    the interval applies when used inside the serving gateway's polling loop.
    """

    millisToWait = Param("millisToWait", "The time to wait before constructing a batch", int, 1000)
    maxBatchSize = Param("maxBatchSize", "The max size of the buffer", int, 2147483647)

    def _transform(self, df: Table) -> Table:
        n = df.num_rows
        cap = self.getMaxBatchSize()
        if n == 0:
            return _to_batched(df, [])
        sizes = [min(cap, n - s) for s in range(0, n, cap)]
        return _to_batched(df, sizes)

    def wait_interval(self) -> None:
        time.sleep(self.getMillisToWait() / 1000.0)


class FlattenBatch(Transformer):
    """Explode batched columns back into one row per element.

    Reference: FlattenBatch (stages/MiniBatchTransformer.scala:200-253). Drops
    rows marked synthetic by FixedMiniBatchTransformer(padBatches=True).
    """

    keepPadding = Param("keepPadding", "Keep rows marked as padding ('__pad__')", bool, False)

    def _transform(self, df: Table) -> Table:
        out = Table()
        for name in df.columns:
            col = df[name]
            if col.dtype == object and len(col) and isinstance(col[0], np.ndarray):
                flat = np.concatenate([np.atleast_1d(b) for b in col]) if len(col) else col
            else:
                flat = col
            out[name] = flat
        if "__pad__" in out and not self.getKeepPadding():
            out = out.filter(~out["__pad__"].astype(bool)).drop("__pad__")
        return out
