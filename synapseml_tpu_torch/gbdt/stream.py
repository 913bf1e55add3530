"""Out-of-core GBDT: train on tables whose binned rows do not fit the card,
by streaming host-cached quantized chunks through the chunk pump.

Counterpart of the JAX package's ``gbdt/stream.py``.

* :class:`StreamedDataset` ingests raw row chunks (dense or scipy sparse):
  a one-pass :class:`~synapseml_tpu_torch.ops.quantize.StreamingQuantileSketch`
  learns the boundaries (byte for byte the resident ones while the stream
  fits its sample buffer), then the rows are binned and cached on the host
  as uniform feature-major ``(FP, C)`` uint8 chunks (uint16 past 256 bins),
  a quarter of the raw floats. ``cache_dir`` spills the chunks to ``.npy``
  files, re-read per pass through ``io.ingest.read_chunk_file``.

* :func:`train_booster_streamed` grows the trees leaf-wise (one best-gain
  split per pass over the chunks) or depthwise (one pass per level). A pass
  moves each chunk's bins to the card through ``io.ingest.ChunkPump`` and
  ``PinnedStager`` (a threaded producer fills standing pinned buffers, a
  side stream copies, the compute stream waits on the copy's event), widens
  them to int32 there and runs the port's histogram kernels on them:
  ``child_histogram`` for the root (the row mask) and for a leaf-wise split's
  right child (grad, hess and mask times ``node == new_right``; the left
  child is parent minus right), and one ``level_histograms`` launch per
  chunk and level, after the chunk's rows are laid out by slot with the
  resident grower's ``_repartition``. The chunk partials are summed in chunk
  order and go through the resident growers' own split search and
  bookkeeping (``_best_for_leaf``, ``_TreeBook``, ``_level_candidates``,
  ``_apply_level_splits``, ``_route_level``). On the CPU the plain versions
  of the kernels run on the chunk's rows as they are, which sums every bin
  in row order, as the JAX package's scatter does.

  The per-row vectors (label, weight, mask, score, leaf, sample weight:
  24 bytes a row) stay on the device for the whole fit; only the F-wide
  bins stream. So the card holds ``24 n`` bytes plus ``depth + 2`` chunks
  of bins, where the resident path holds ``FP n`` bytes of int32 bins more.

  Bagging, GOSS and feature sampling draw from the same ``fold_in`` streams
  as the resident path (``core.prng``, bitwise ``jax.random``'s), over the
  global row order, so a killed fit resumes bit for bit from its tree
  boundary snapshots (``checkpoint_store``). Every chunk boundary is a
  preemption point (phase ``"gbdt.stream.chunk"``). ``valid_data`` is
  scored tree by tree and drives best-iteration tracking and early
  stopping. ``resident=True`` stages every chunk on the device once and
  runs the same per-chunk code without the pump: on the CPU bitwise the
  streamed fit.

* :func:`predict_streamed`: raw chunks in, one prediction array per chunk
  out, through the same pump.

* ``mesh=`` (single controller: every rank gets the same chunk source):
  the chunk rows round up to a multiple of the W ranks, and every rank
  sketches the whole stream (so the mapper is byte for byte the one
  process's) but bins, caches and streams only its block of every chunk
  (``prepare(row_block=...)``): its host cache, stager and per-row vectors
  hold about 1/W of the rows. It sums its chunks' partial histograms in
  chunk order and crosses the fabric once per growth step
  (``grower._maybe_psum`` on the f32, bf16 or int8 wire), so a leaf-wise
  tree makes the resident path's 31 gloo calls and the f32 wire is the
  JAX package's bit for bit on the CPU. Sampling draws over the global
  rows (GOSS gathers the gradients), and rank 0 commits the snapshots
  (scores gathered in stream order).

Limits (raised by name): gbdt and goss boosting only, objectives with one
model per iteration, no ranking validation metrics; on a mesh the data
learner only, and no streaming in a multi-process world (JAX's
single-controller rule).
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..core import prng
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..io.ingest import (ChunkPump, PinnedStager, read_chunk_file,
                         stream_chunk_rows, stream_depth)
from ..ops.hist_kernel import (CHUNK, child_histogram, features_padded,
                               level_histograms, pad_bins)
from ..ops.quantize import (BinMapper, CsrBinner, StreamingQuantileSketch,
                            apply_bins)
from .boosting import (Booster, BoosterConfig, _ckpt_load_gbdt,
                       _ckpt_save_gbdt, _eval_metric, _f32, _is_rank_metric,
                       _metric_name, _node_key_data, _objective,
                       _sample_features_impl)
from ..parallel import collectives as coll
from .grower import (TreeArrays, _best_for_leaf, _maybe_psum, _mesh_group,
                     _padded_categorical, _padded_features, _to_host,
                     _TreeBook, node_masks, tree_leaves_binned,
                     trees_to_host)
from .grower_depthwise import (_apply_level_splits, _level_candidates,
                               _repartition, _route_level)
from .objectives import HIGHER_IS_BETTER

STREAM_PHASE = "gbdt.stream.chunk"


def _is_sparse(x) -> bool:
    return hasattr(x, "tocoo")


class StreamedDataset:
    """Out-of-core training data: a re-iterable chunk source and the
    host-cached quantized form ``train_booster_streamed`` streams.

    ``batches`` is a callable returning an iterator of chunks, each a dense
    ``(c, F)`` array or a scipy sparse matrix, alone or as ``(X, y)`` or
    ``(X, y, w)``. It is called once per ingest pass (the sketch pass, then
    the bin-and-cache pass), so a generator must be wrapped in a function.
    A :class:`~synapseml_tpu_torch.io.ingest.DiskChunkSource` qualifies and
    adds its measured read rate to the chunk geometry.

    ``prepare(config)`` resolves the chunk geometry (``io.ingest``), learns
    the boundaries (the sketch, unless ``mapper`` is given) and re-chunks
    the stream into uniform ``(FP, C)`` feature-major quantized host
    chunks, the last padded with zero-mass rows. ``cache_dir`` spills the
    chunks to ``.npy`` files; labels and weights stay in host memory."""

    def __init__(self, batches: Callable[[], Iterable],
                 num_features: Optional[int] = None,
                 mapper: Optional[BinMapper] = None,
                 categorical_features: Optional[Sequence[int]] = None,
                 chunk_rows: Optional[int] = None,
                 depth: Optional[int] = None,
                 exact_second_pass: Optional[bool] = None,
                 cache_dir: Optional[str] = None):
        if not callable(batches):
            raise TypeError(
                "StreamedDataset needs a CALLABLE returning an iterator of "
                "chunks (a consumed iterator cannot serve the several "
                "ingest passes); wrap it: StreamedDataset(lambda: chunks)")
        self._batches = batches
        self.num_features = num_features
        self.mapper = mapper
        self._user_mapper = mapper is not None
        self.categorical_features = (list(categorical_features)
                                     if categorical_features else None)
        self._chunk_rows_arg = chunk_rows
        self._depth_arg = depth
        # an exact second sketch pass when the one-pass sketch overflowed
        # its sample: None lets core.perfmodel decide, True/False forces
        self._exact_second_pass = exact_second_pass
        self.second_pass_decision: Optional[dict] = None
        self._cache_dir = cache_dir
        self._rows_sketched = 0
        self.chunk_rows: Optional[int] = None     # C, after prepare()
        self.depth: Optional[int] = None
        self.chunk_decision = None
        # this process's block of every chunk's rows, [lo, hi) of C (the
        # whole chunk without a row block)
        self.row_block: Optional[tuple] = None
        self.block_rows: Optional[int] = None     # hi - lo
        self.chunks: List[dict] = []              # bT (FP, hi - lo), y/w/m
        self.chunk_real: List[int] = []           # real (unpadded) rows
        self.block_real: List[int] = []           # real rows of the block
        self._yw: Optional[tuple] = None          # every row's labels, weights
        self.n_rows = 0
        self.sketch_exact: Optional[bool] = None  # None: mapper was given
        self.ingest_seconds: dict = {}
        self._prepared_for = None
        self._block_of = None

    @classmethod
    def from_arrays(cls, X, y=None, w=None, source_chunk: int = 65536,
                    **kwargs) -> "StreamedDataset":
        """In-memory arrays (dense or scipy sparse rows) as a chunk
        source."""
        n = X.shape[0]
        f = X.shape[1]

        def batches():
            for i in range(0, n, source_chunk):
                sl = slice(i, min(i + source_chunk, n))
                yield (X[sl],
                       None if y is None else y[sl],
                       None if w is None else w[sl])

        return cls(batches, num_features=f, **kwargs)

    # -- ingest ------------------------------------------------------------
    def _norm_chunk(self, chunk):
        """(X, y, w) of any accepted chunk form."""
        if isinstance(chunk, tuple):
            X = chunk[0]
            y = chunk[1] if len(chunk) > 1 else None
            w = chunk[2] if len(chunk) > 2 else None
        else:
            X, y, w = chunk, None, None
        if self.num_features is None:
            self.num_features = int(X.shape[1])
        elif int(X.shape[1]) != self.num_features:
            raise ValueError(f"chunk has {X.shape[1]} features, dataset has "
                             f"{self.num_features}")
        return X, y, w

    def _sketch_pass(self, cfg: BoosterConfig) -> None:
        seed = (cfg.seed if cfg.data_random_seed is None
                else int(cfg.data_random_seed))
        sketch = None
        for chunk in self._batches():
            X, _, _ = self._norm_chunk(chunk)
            if sketch is None:
                sketch = StreamingQuantileSketch(
                    self.num_features, cfg.max_bin, cfg.bin_sample_count,
                    self.categorical_features, seed=seed,
                    min_data_in_bin=cfg.min_data_in_bin,
                    max_bin_by_feature=cfg.max_bin_by_feature)
            if _is_sparse(X):
                coo = X.tocoo()
                sketch.update_csr(coo.data, coo.row, coo.col, X.shape[0])
            else:
                sketch.update(np.asarray(X, np.float32))
        if sketch is None or sketch.rows_seen == 0:
            raise ValueError("StreamedDataset source yielded no rows")
        self.sketch_exact = sketch.exact
        self._rows_sketched = int(sketch.rows_seen)
        self.mapper = sketch.finalize()

    def _maybe_exact_second_pass(self, cfg: BoosterConfig,
                                 pass_s: float) -> None:
        """The one-pass sketch overflowed its sample, so the boundaries are
        a reservoir's. A second pass with the sample raised to the stream's
        length makes them exact; ``core.perfmodel`` prices it against the
        training estimate (num_iterations x tree levels re-streams), and
        ``exact_second_pass=True/False`` decides instead."""
        from ..core import perfmodel

        rows, nfeat = self._rows_sketched, self.num_features
        if self._exact_second_pass is not None:
            take = bool(self._exact_second_pass)
            self.second_pass_decision = {"kind": "gbdt_sketch_pass",
                                         "arm": "exact" if take else "skip",
                                         "source": "explicit"}
        else:
            levels = max(1, int(np.ceil(np.log2(max(cfg.num_leaves, 2)))))
            train_est = pass_s * max(cfg.num_iterations, 1) * levels
            rate = rows / pass_s if pass_s > 0 else None
            take, dec = perfmodel.suggest_sketch_second_pass(
                float(rows), float(nfeat), rate, train_est)
            # an exact sketch buffers the whole stream on the host: never
            # trade boundaries for running out of memory
            if take and rows * nfeat * 4 > (2 << 30):
                take = False
                dec.arm, dec.used_fallback = "skip", True
                dec.source = "host_budget"
            self.second_pass_decision = dec.provenance()
        if not take:
            return
        t0 = _time.perf_counter()
        self._sketch_pass(dataclasses.replace(
            cfg, bin_sample_count=max(rows, cfg.bin_sample_count)))
        if self.second_pass_decision.get("source") != "explicit":
            self.second_pass_decision["observed_s"] = round(
                _time.perf_counter() - t0, 6)

    def _bin_chunk(self, X, binner: Optional[CsrBinner], dev) -> np.ndarray:
        """(c, F) quantized host rows of one raw chunk, binned on ``dev``."""
        if _is_sparse(X):
            coo = X.tocoo()
            return binner(coo.data, coo.row, coo.col, X.shape[0]).cpu().numpy()
        return apply_bins(self.mapper, np.asarray(X, np.float32),
                          dev).cpu().numpy()

    def _count_rows(self) -> int:
        """Rows of the stream: the sketch's count, else one pass counting
        them."""
        if self._rows_sketched:
            return self._rows_sketched
        return sum(int(self._norm_chunk(c)[0].shape[0])
                   for c in self._batches())

    def prepare(self, config: BoosterConfig, row_multiple: int = 1,
                device=DEFAULT_DEVICE,
                row_block: Optional[tuple] = None) -> "StreamedDataset":
        """Sketch (unless a mapper was given), resolve the chunk geometry,
        bin (on ``device``) and cache the stream; idempotent for one binning
        config. ``row_multiple`` rounds the chunk rows up to a multiple; a
        dataset prepared under the same binning re-chunks without
        re-sketching when the multiple changes. ``row_block=(r, W)`` (W
        dividing ``row_multiple``) keeps only block ``r`` of W equal row
        blocks of every chunk, as the mesh's rank ``r`` holds it: only those
        rows are binned and cached (the labels and weights of every row stay
        in host memory)."""
        dev = resolve_device(device)
        mult = max(int(row_multiple), 1)
        r_blk, W = (0, 1) if row_block is None else (int(row_block[0]),
                                                     int(row_block[1]))
        if mult % W:
            raise ValueError(f"row_block of {W} blocks needs row_multiple "
                             f"a multiple of {W}, got {mult}")
        key = (config.max_bin, config.bin_sample_count,
               config.min_data_in_bin,
               tuple(config.max_bin_by_feature or ()),
               config.seed if config.data_random_seed is None
               else int(config.data_random_seed))
        if (self._prepared_for == key and self.chunk_rows
                and self.chunk_rows % mult == 0
                and self._block_of == (r_blk, W)):
            return self
        if (self._prepared_for is not None and self._prepared_for != key
                and self._user_mapper is False):
            # other binning would silently retrain on other boundaries
            raise ValueError(
                f"StreamedDataset already prepared for binning "
                f"{self._prepared_for}; got {key}: build a fresh "
                "StreamedDataset")
        if self.mapper is None:
            t0 = _time.perf_counter()
            self._sketch_pass(config)
            pass_s = _time.perf_counter() - t0
            self.ingest_seconds["sketch"] = pass_s
            if self.sketch_exact is False:
                t1 = _time.perf_counter()
                self._maybe_exact_second_pass(config, pass_s)
                self.ingest_seconds["second_pass"] = (_time.perf_counter()
                                                      - t1)
        if self.mapper.max_bin != config.max_bin:
            raise ValueError(
                f"mapper has max_bin={self.mapper.max_bin} but config asks "
                f"{config.max_bin}")

        t0 = _time.perf_counter()
        F = self.num_features
        FP = features_padded(F)
        # one streamed row's device footprint: its bins plus the per-row
        # vectors (label, weight, mask, score: float32; leaf: int32)
        unit = 1 if self.mapper.max_bin <= 256 else 2
        row_bytes = FP * unit + 20
        self.depth = stream_depth(self._depth_arg)
        read_bps = getattr(self._batches, "read_bytes_per_s", None)
        C = stream_chunk_rows(row_bytes, explicit=self._chunk_rows_arg,
                              depth=self.depth, read_bps=read_bps)
        if C % mult:
            C += mult - C % mult
        if W > 1:
            # the whole stream in one partial chunk shrinks the chunk to
            # its real rows (a multiple of row_multiple); the blocks need
            # the final C before the first row is placed
            total = self._count_rows()
            if total < C:
                C = max(-(-total // mult) * mult, mult)
        self.chunk_rows = C
        from ..io import ingest as _ingest

        self.chunk_decision = _ingest.last_chunk_decision()
        bin_dtype = np.uint8 if unit == 1 else np.uint16
        if self._cache_dir is not None:
            os.makedirs(self._cache_dir, exist_ok=True)

        self.chunks, self.chunk_real, self.block_real = [], [], []
        self.n_rows = 0
        binner = CsrBinner(self.mapper, dev)
        lo, hi = r_blk * C // W, (r_blk + 1) * C // W
        buf_b = np.zeros((C, F), bin_dtype)
        buf_y = np.zeros(C, np.float32)
        buf_w = np.zeros(C, np.float32)
        all_y, all_w = [], []
        fill = 0

        def flush():
            nonlocal fill, C, lo, hi
            if fill == 0:
                return
            if not self.chunks and fill < C and W == 1:
                # the whole stream fits one partial chunk: shrink the chunk
                # to the real rows (still a multiple of row_multiple)
                C = max(-(-fill // mult) * mult, mult)
                self.chunk_rows = C
                lo, hi = 0, C
            real = min(max(fill - lo, 0), hi - lo)
            bT = np.zeros((FP, hi - lo), bin_dtype)
            bT[:F, :real] = buf_b[lo:lo + real].T
            m = np.zeros(hi - lo, np.float32)
            m[:real] = 1.0
            entry = {"y": buf_y[lo:hi].copy(), "w": buf_w[lo:hi].copy(),
                     "m": m}
            if W > 1:
                all_y.append(buf_y[:fill].copy())
                all_w.append(buf_w[:fill].copy())
            if self._cache_dir is not None:
                path = os.path.join(self._cache_dir,
                                    f"chunk{len(self.chunks):05d}.npy")
                np.save(path, bT)
                entry["bT_path"] = path
            else:
                entry["bT"] = bT
            self.chunks.append(entry)
            self.chunk_real.append(fill)
            self.block_real.append(real)
            buf_y[:] = 0.0
            buf_w[:] = 0.0
            fill = 0

        seen = 0
        for chunk in self._batches():
            X, y, w = self._norm_chunk(chunk)
            c = int(X.shape[0])
            if c == 0:
                continue
            # bin only the rows that land in this block of their chunk
            q = (seen + np.arange(c)) % C
            keep = (q >= lo) & (q < hi)
            seen += c
            if keep.all():
                binned = self._bin_chunk(X, binner, dev)
            else:
                binned = np.zeros((c, F), bin_dtype)
                if keep.any():
                    binned[keep] = self._bin_chunk(X[np.nonzero(keep)[0]],
                                                   binner, dev)
            y = (np.zeros(c, np.float32) if y is None
                 else np.asarray(y, np.float32))
            w = (np.ones(c, np.float32) if w is None
                 else np.asarray(w, np.float32))
            off = 0
            while off < c:
                take = min(C - fill, c - off)
                buf_b[fill:fill + take] = binned[off:off + take]
                buf_y[fill:fill + take] = y[off:off + take]
                buf_w[fill:fill + take] = w[off:off + take]
                fill += take
                off += take
                if fill == C:
                    flush()
        flush()
        self.n_rows = int(sum(self.chunk_real))
        if self.n_rows == 0:
            raise ValueError("StreamedDataset source yielded no rows")
        self.row_block = (lo, hi)
        self.block_rows = hi - lo
        self._yw = ((np.concatenate(all_y), np.concatenate(all_w))
                    if W > 1 else None)
        self.ingest_seconds["bin_and_cache"] = _time.perf_counter() - t0
        self._prepared_for = key
        self._block_of = (r_blk, W)
        return self

    def cache_bytes(self) -> int:
        """Bytes of the quantized chunk cache (in host memory or spilled)."""
        FP = features_padded(self.num_features)
        unit = 1 if self.mapper.max_bin <= 256 else 2
        return len(self.chunks) * FP * int(self.block_rows) * unit

    def chunk_bT(self, i: int) -> np.ndarray:
        """Quantized (FP, C) bins of chunk ``i``: in host memory, or re-read
        from the ``cache_dir`` spill through the mmap reader (so the disk
        fault hook and a real dying disk both surface here)."""
        ch = self.chunks[i]
        bT = ch.get("bT")
        if bT is not None:
            return bT
        arr = read_chunk_file(ch["bT_path"], i)
        want = (features_padded(self.num_features), int(self.block_rows))
        if tuple(arr.shape) != want:
            raise OSError(
                f"torn read of spilled chunk {ch['bT_path']!r}: got shape "
                f"{tuple(arr.shape)}, want {want}")
        return arr

    def labels(self) -> np.ndarray:
        """Every row's label, in stream order (with a row block too)."""
        if self._yw is not None:
            return self._yw[0]
        return np.concatenate([ch["y"][:r] for ch, r in
                               zip(self.chunks, self.chunk_real)])

    def weights(self) -> np.ndarray:
        if self._yw is not None:
            return self._yw[1]
        return np.concatenate([ch["w"][:r] for ch, r in
                               zip(self.chunks, self.chunk_real)])


# ---------------------------------------------------------------------------
# Streamed training
# ---------------------------------------------------------------------------

def _check_supported(cfg: BoosterConfig, has_valid: bool = False) -> None:
    bad = []
    if cfg.boosting_type not in ("gbdt", "goss"):
        bad.append(f"boosting_type={cfg.boosting_type!r}")
    if cfg.objective in ("multiclass", "softmax", "multiclassova",
                         "lambdarank") or cfg.num_class > 1:
        bad.append(f"objective={cfg.objective!r}/num_class={cfg.num_class}")
    if cfg.early_stopping_round > 0 and not has_valid:
        bad.append("early stopping without a held-out stream "
                   "(pass valid_data=)")
    if has_valid and _is_rank_metric(_metric_name(cfg)):
        bad.append("ranking validation metrics")
    if bad:
        raise NotImplementedError(
            "out-of-core streamed training does not support: "
            + ", ".join(bad) + " (use the resident train_booster path)")


def _stream_sample_weights(cfg: BoosterConfig, n: int, key0, it: int,
                           gnorm, in_bag_cur, yj):
    """Iteration ``it``'s (n,) sample weights, from the same ``fold_in``
    streams as the resident path's sampling: ``(sw, in_bag)``, ``sw`` None
    when sampling is off, else float32 ({0, 1} bagging; {0, amp, 1} GOSS);
    ``in_bag`` is the bag carried between bagging rounds (checkpointed, so
    a resumed fit replays it)."""
    dev = in_bag_cur.device
    stratified = (cfg.pos_bagging_fraction < 1.0
                  or cfg.neg_bagging_fraction < 1.0)
    do_bag = (cfg.bagging_freq > 0
              and (cfg.bagging_fraction < 1.0 or stratified))
    if cfg.boosting_type == "goss":
        top_n = int(cfg.top_rate * n)
        rand_n = int(cfg.other_rate * n)
        amp = (1.0 - cfg.top_rate) / max(cfg.other_rate, 1e-12)
        order = torch.argsort(-gnorm, stable=True)
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(n, device=dev)
        kg = prng.fold_in(key0, cfg.extra_seed) if cfg.extra_seed else key0
        u = prng.uniform(prng.fold_in(kg, it), n, dev)
        pick = (ranks >= top_n) & (u < _f32(rand_n / max(n - top_n, 1), dev))
        sw = torch.where(ranks < top_n, _f32(1.0, dev),
                         torch.where(pick, _f32(amp, dev), _f32(0.0, dev)))
        return sw, in_bag_cur
    if do_bag:
        kb = (prng.fold_in(key0, cfg.bagging_seed) if cfg.bagging_seed != 3
              else key0)
        u = prng.uniform(prng.fold_in(kb, 20_000_000 + it), n, dev)
        if stratified and yj is not None:
            frac = torch.where(yj > 0, _f32(cfg.pos_bagging_fraction, dev),
                               _f32(cfg.neg_bagging_fraction, dev))
        else:
            frac = _f32(cfg.bagging_fraction, dev)
        fresh = (u < frac).to(torch.float32)
        bag = fresh if it % max(cfg.bagging_freq, 1) == 0 else in_bag_cur
        return bag, bag
    return None, in_bag_cur


def _stream_fingerprint(cfg: BoosterConfig, data: StreamedDataset,
                        mesh=None) -> str:
    """Resume identity: config, chunk geometry and a label digest. The
    geometry is part of it because per-chunk partial sums make the
    accumulation order, and so the trees, a function of C."""
    import hashlib
    import zlib

    mesh_axes = (None if mesh is None
                 else tuple(sorted(dict(mesh.shape).items())))
    h = hashlib.sha256()
    h.update(repr(sorted(dataclasses.asdict(cfg).items())).encode())
    h.update(repr((int(data.n_rows), int(data.num_features),
                   int(data.chunk_rows), mesh_axes,
                   zlib.crc32(np.ascontiguousarray(
                       data.labels()).tobytes()))).encode())
    return h.hexdigest()


class _Passes:
    """Streams the chunks' bins to the device, pass after pass: yields
    ``(i, bT)`` with ``bT`` chunk ``i``'s (FP, C) int32 bins on ``dev``.
    Streamed: a fresh ``ChunkPump`` per pass with globally monotonic
    boundary steps (through a ``PinnedStager`` on the card); resident: the
    chunks staged on the device once, no pump. On the card each pass's
    copy, exposed-wait and producer-wait times are recorded in ``log``
    (``producer_wait_ms``: the host waiting for the producer thread to
    fill and send the next chunk)."""

    def __init__(self, data: StreamedDataset, dev, resident: bool):
        self.data, self.dev, self.resident = data, dev, resident
        self.n = len(data.chunks)
        self.step_base = 0
        self.log: List[dict] = []
        self.cuda = dev.type == "cuda"
        self.stager = None
        self.staged = None
        if resident:
            self.staged = [torch.from_numpy(self._host(i)).to(dev)
                           for i in range(self.n)]
        elif self.cuda:
            FP = features_padded(data.num_features)
            unit = 1 if data.mapper.max_bin <= 256 else 2
            self.stager = PinnedStager(FP * int(data.block_rows) * unit,
                                       data.depth + 1, dev)

    def _host(self, i: int) -> np.ndarray:
        bT = self.data.chunk_bT(i)
        # uint16 bins travel as int16 (torch widens uint16 on few devices)
        return bT.view(np.int16) if bT.dtype == np.uint16 else bT

    @staticmethod
    def _widen(bT: torch.Tensor) -> torch.Tensor:
        if bT.dtype == torch.int16:
            return bT.to(torch.int32) & 0xFFFF
        return bT.to(torch.int32)

    def __call__(self, kind: str):
        if self.resident:
            for i in range(self.n):
                yield i, self._widen(self.staged[i])
            return
        t0 = _time.perf_counter()
        stager = self.stager

        def src():
            for i in range(self.n):
                yield i, self._host(i)

        if stager is not None:
            def place(item):
                return item[0], stager.stage([item[1]])
        else:
            def place(item):
                return item[0], torch.from_numpy(item[1])

        # a producer thread buys overlap only with a spare core to run on
        pump = ChunkPump(src(), place=place, depth=self.data.depth,
                         threaded=(os.cpu_count() or 2) > 1,
                         phase=STREAM_PHASE, step_base=self.step_base,
                         name="gbdt",
                         on_thread_start=(stager.make_side_current
                                          if stager is not None else None))
        done = []
        try:
            for i, item in pump:
                if stager is not None:
                    (bT,) = item.wait()
                    item.arrays = None      # the pass keeps only its events
                    done.append(item)
                else:
                    bT = item
                yield i, self._widen(bT)
        finally:
            self.step_base += max(pump.chunks_consumed, pump.chunks_produced)
        if stager is not None:
            torch.cuda.current_stream(self.dev).synchronize()
            self.log.append({
                "kind": kind, "chunks": len(done),
                "wall_ms": (_time.perf_counter() - t0) * 1e3,
                "h2d_ms": sum(c.copy_ms() for c in done),
                "exposed_ms": sum(c.exposed_ms() for c in done),
                "producer_wait_ms": pump.wait_s * 1e3})


def _level_chunk_hist(bT, g, h, m, node, n_leaves: int, B: int, L: int,
                      slot_layout: bool):
    """(L, FP, B, 3) histograms of one chunk's rows by leaf ``node``. With
    ``slot_layout`` (the card) the rows are first laid out by slot in
    chunks of ``CHUNK`` rows (``_repartition``; every existing leaf gets at
    least one chunk) for one ``level_histograms`` launch; without it (the
    CPU) the plain version reads each row's slot as it is."""
    if not slot_layout:
        return level_histograms(bT, g, h, m, None, node, B, L)
    C = bT.shape[1]
    dev = bT.device
    exists = torch.arange(L, device=dev) < n_leaves
    cap = (-(-C // CHUNK) + n_leaves) * CHUNK
    src, valid, slot, start_chunks = _repartition(
        node, torch.zeros(C, dtype=torch.bool, device=dev), exists, CHUNK,
        cap)
    bTr = bT.index_select(1, src).masked_fill_(~valid[None, :], 0)
    gr = torch.where(valid, g[src], 0.0)
    hr = torch.where(valid, h[src], 0.0)
    mr = torch.where(valid, m[src], 0.0)
    return level_histograms(bTr, gr, hr, mr, start_chunks, slot, B, L)


def train_booster_streamed(
    data: StreamedDataset,
    config: BoosterConfig,
    *,
    resident: bool = False,
    mesh=None,
    valid_data=None,
    measures=None,
    checkpoint_store=None,
    checkpoint_every: int = 0,
    resume: bool = True,
    feature_names: Optional[List[str]] = None,
    device=DEFAULT_DEVICE,
) -> Booster:
    """Grow ``config.num_iterations`` trees over an out-of-core dataset on
    ``device`` (module docstring).

    A leaf-wise tree makes ``1 + num_splits`` passes over the chunks' bins
    (the root, then one right-child histogram per split) and a depthwise
    tree ``1 + levels``; the score update after each tree runs on the
    device-resident per-row vectors, with no bins. ``valid_data`` (a
    ``(Xv, yv[, wv])`` tuple or a :class:`StreamedDataset`, binned with this
    dataset's mapper) is scored tree by tree for best-iteration tracking and
    early stopping. ``checkpoint_store`` snapshots at tree boundaries
    (every ``checkpoint_every`` trees, default 1); with ``resume`` a rerun
    continues from the newest snapshot of the same run, bit for bit.
    ``resident=True`` stages every chunk on the device once and runs the
    same per-chunk code.

    ``mesh`` (single controller: every rank of the mesh calls with the same
    ``data`` source and arguments) shards every chunk's rows over the
    ``data`` axis: the chunk rows are rounded to a multiple of the W ranks,
    each rank bins, caches and streams only its block of every chunk
    (``prepare(row_block=...)``), sums its chunks' partial histograms in
    chunk order and crosses the fabric once per growth step
    (``grower._maybe_psum`` on ``hist_allreduce_dtype``'s wire)."""
    from ..core.logging import InstrumentationMeasures
    from ..parallel.mesh import process_count

    if measures is None:
        measures = InstrumentationMeasures()
    cfg = config
    has_valid = valid_data is not None
    _check_supported(cfg, has_valid)
    W, group, rank = 1, None, 0
    if mesh is not None:
        if process_count() > 1:
            raise NotImplementedError(
                "mesh-streamed GBDT is single-controller: "
                "process_count() must be 1 (multi-process stage groups "
                "route through the resident train_booster path)")
        from ..parallel.mesh import DATA_AXIS

        if cfg.tree_learner in ("voting", "feature"):
            raise NotImplementedError(
                f"mesh-streamed GBDT shards over the data axis only "
                f"(tree_learner='data'); got {cfg.tree_learner!r}")
        W = int(dict(mesh.shape).get(DATA_AXIS, 1))
        group, rank = _mesh_group(mesh)
    dev = resolve_device(device)
    if mesh is not None:
        if mesh.device.type != dev.type:
            raise ValueError(f"train_booster_streamed(device={device!r}) on "
                             f"a mesh of {mesh.device}")
        dev = mesh.device
    cuda = dev.type == "cuda"

    fit_t0 = _time.perf_counter()
    with measures.span("streamIngest"):
        data.prepare(cfg, row_multiple=W, device=dev,
                     row_block=(rank, W) if W > 1 else None)
    mapper = data.mapper
    F = data.num_features
    C = int(data.block_rows)              # this rank's rows of a chunk
    FP = features_padded(F)
    B = pad_bins(cfg.max_bin)
    L = cfg.num_leaves
    n = int(data.n_rows)
    nchunks = len(data.chunks)
    npad = nchunks * C
    if group is not None:
        from ..parallel.mesh import check_same_inputs

        # every rank must bin on the same boundaries and stream the same
        # geometry before the first collective
        check_same_inputs(
            mesh, "stream (bin boundaries, rows, chunk rows, config)",
            np.asarray(mapper.boundaries), np.asarray(mapper.num_bins),
            np.asarray(mapper.is_categorical), np.asarray(mapper.nan_mask),
            (n, F, int(data.chunk_rows), nchunks),
            sorted(dataclasses.asdict(cfg).items()))

    autoconfig_info = {}
    if cfg.hist_allreduce_dtype == "auto":
        from .grower import resolve_wire_dtype

        wd, wdec = resolve_wire_dtype(cfg, mesh if W > 1 else None, n, F)
        cfg.hist_allreduce_dtype = wd
        autoconfig_info["wire_dtype"] = wdec.provenance()
    routing_info = None
    if cfg.tree_learner == "auto":
        choice = "data" if W > 1 else "serial"
        cfg.tree_learner = choice
        routing_info = {"tree_learner": choice,
                        "router": "streamed_data_plane", "workers": W}
    wire = cfg.hist_allreduce_dtype

    def reduce(h):
        """One growth step's histogram over the ranks (identity alone)."""
        return _maybe_psum(h, group, wire)

    # this rank's padded rows in the stream's padded order: chunk i's
    # block holds rows i * C_all + lo .. of the whole chunk-padded layout
    C_all = int(data.chunk_rows)
    lo = data.row_block[0]
    gidx = None
    if W > 1:
        gidx = (torch.arange(nchunks, device=dev)[:, None] * C_all + lo
                + torch.arange(C, device=dev)[None, :]).reshape(-1)

    def global_rows(v: torch.Tensor) -> torch.Tensor:
        """Every rank's (npad,) ``v`` assembled in stream order, the real
        rows (n,): an all-gather of the blocks."""
        if group is None:
            return v[:n]
        parts = coll.allgather(v, group).reshape(W, nchunks, C)
        return parts.permute(1, 0, 2).reshape(-1)[:n]

    def local_rows(v: torch.Tensor, fill: float) -> torch.Tensor:
        """This rank's (npad,) rows of a stream-order (n,) vector, ``fill``
        for the padding."""
        if group is None:
            return torch.cat([v, torch.full((npad - n,), fill,
                                            dtype=v.dtype, device=dev)])
        whole = torch.full((nchunks * C_all,), fill, dtype=v.dtype,
                           device=dev)
        whole[:n] = v
        return whole[gidx]

    is_cat = np.asarray(mapper.is_categorical, bool)
    gcfg = cfg.grower(has_categorical=bool(is_cat.any()))
    leafwise = cfg.growth_policy == "leafwise"
    if cfg.growth_policy not in ("leafwise", "depthwise"):
        raise ValueError("growth_policy must be 'leafwise' or 'depthwise', "
                         f"got {cfg.growth_policy!r}")
    max_levels = gcfg.max_depth if gcfg.max_depth > 0 else L - 1
    cc = (np.asarray(mapper.cat_counts, np.int32)
          if mapper.cat_counts is not None
          else np.asarray(mapper.num_bins, np.int32) - 1)
    cat_nbins = np.where(is_cat, cc, np.int32(0x7FFF))
    nan_bins = np.asarray(mapper.nan_bins, np.int32)
    mono = np.zeros(F, np.int32)
    if cfg.monotone_constraints is not None:
        mc = np.asarray(cfg.monotone_constraints, np.int32)
        mono[:len(mc)] = mc
    catp, catb, catp_host = _padded_categorical(gcfg, is_cat, cat_nbins, FP,
                                                B, dev)
    has_cat = catp is not None

    obj = _objective(cfg, 1)
    ys_host, ws_host = data.labels(), data.weights()
    yj = torch.as_tensor(ys_host).to(dev)
    wj = torch.as_tensor(ws_host).to(dev)
    base = (np.atleast_1d(np.asarray(obj.init_score(yj, wj).cpu(),
                                     np.float64))
            if cfg.boost_from_average else np.zeros(1))

    # the per-row vectors, chunk-padded (real rows first, the last chunk's
    # padding at the end), on the device for the whole fit
    def _cat(field):
        return torch.as_tensor(np.concatenate(
            [ch[field] for ch in data.chunks])).to(dev)

    y_all, w_all, m_all = _cat("y"), _cat("w"), _cat("m")
    score = torch.full((npad,), float(np.float32(base[0])),
                       dtype=torch.float32, device=dev)
    node = torch.zeros(npad, dtype=torch.int64, device=dev)

    goss_mode = cfg.boosting_type == "goss"
    stratified = (cfg.pos_bagging_fraction < 1.0
                  or cfg.neg_bagging_fraction < 1.0)
    do_bag = (cfg.bagging_freq > 0
              and (cfg.bagging_fraction < 1.0 or stratified))
    sampling = goss_mode or do_bag
    key0 = prng.prng_key(cfg.seed)
    bynode = cfg.feature_fraction_bynode < 1.0
    in_bag = torch.ones(n, dtype=torch.float32, device=dev)

    # ---- held-out stream --------------------------------------------------
    if has_valid:
        if isinstance(valid_data, StreamedDataset):
            vd = valid_data
        else:
            vd = StreamedDataset.from_arrays(
                valid_data[0], valid_data[1],
                valid_data[2] if len(valid_data) > 2 else None)
        if vd.mapper is None:
            # the held-out rows bin with the training boundaries
            vd.mapper = mapper
            vd._user_mapper = True
        vd.prepare(cfg, device=dev)
        if vd.num_features != F:
            raise ValueError(
                f"valid_data has {vd.num_features} features, train has {F}")
        yv_j = torch.as_tensor(vd.labels()).to(dev)
        wv_all = vd.weights()
        wv_j = (None if np.all(wv_all == 1.0)
                else torch.as_tensor(wv_all).to(dev))
        binned_v = [torch.as_tensor(np.ascontiguousarray(
            vd.chunk_bT(i)[:F, :r].T)).to(dev)
            for i, r in enumerate(vd.chunk_real)]
        nan_bins_v = torch.as_tensor(nan_bins.astype(np.int64), device=dev)
        score_v = np.full(int(vd.n_rows), np.float32(base[0]), np.float32)
        metric_name = _metric_name(cfg)
        higher_better = metric_name.split("@")[0] in HIGHER_IS_BETTER
        best_metric, best_iter = None, -1
        stopped_early = False

    # ---- tree-boundary snapshots -----------------------------------------
    ckpt_store = checkpoint_store
    if isinstance(ckpt_store, str):
        from ..core.checkpoint import CheckpointStore

        ckpt_store = CheckpointStore(ckpt_store)
    if ckpt_store is not None and checkpoint_every <= 0:
        checkpoint_every = 1
    fingerprint = (None if ckpt_store is None
                   else _stream_fingerprint(cfg, data, mesh))

    trees: List[TreeArrays] = []
    start_iter = 0
    if ckpt_store is not None and resume:
        saved = _ckpt_load_gbdt(ckpt_store, fingerprint)
        if saved is not None:
            start_iter = int(saved["iteration"])
            trees = [TreeArrays(*[np.asarray(a) for a in t])
                     for t in saved["trees"]]
            score = local_rows(torch.as_tensor(
                np.asarray(saved["score"], np.float32)).to(dev),
                float(np.float32(base[0])))
            in_bag = torch.as_tensor(
                np.asarray(saved["in_bag"], np.float32)).to(dev)
            if has_valid and saved.get("score_v") is not None:
                score_v = np.asarray(saved["score_v"], np.float32).copy()
                bm = saved.get("best_metric")
                best_metric = (None if bm is None
                               or not np.isfinite(np.float64(bm))
                               else float(bm))
                best_iter = int(saved.get("best_iter", -1))

    passes = _Passes(data, dev, resident)
    stats = {"host_syncs": 0, "passes": 0}

    def chunk(t: torch.Tensor, i: int) -> torch.Tensor:
        return t[i * C:(i + 1) * C]

    with measures.span("trainingIteration"):
        for t in range(start_iter, cfg.num_iterations):
            # every row's gradients once per tree (the score only moves
            # between trees), masked as the JAX package's chunk programs
            # mask them: g * m, then times the sample weight
            g, h = obj.grad_hess(score, y_all, w_all)
            g, h = g * m_all, h * m_all
            m2 = m_all
            if sampling:
                gnorm = global_rows(g).abs() if goss_mode else None
                sw, in_bag = _stream_sample_weights(
                    cfg, n, key0, t, gnorm, in_bag,
                    yj if (do_bag and stratified) else None)
                sw = local_rows(sw, 0.0)
                g, h = g * sw, h * sw
                m2 = m_all * (sw > 0)
            feature_active = _sample_features_impl(cfg, F, key0, t, dev)
            featp, nanp, _, monop = _padded_features(
                feature_active, nan_bins, FP, dev, mono)
            masks = node_masks(gcfg, featp, _node_key_data(key0, t, 0)
                               if bynode else None, L)

            def mask_of(ids):
                return featp if masks is None else masks[ids]

            # ---- root: child_histogram over every chunk --------------------
            hist = torch.zeros((L, FP, B, 3), dtype=torch.float32,
                               device=dev)
            root = None
            for i, bT in passes("root"):
                hc = child_histogram(bT, chunk(g, i), chunk(h, i),
                                     chunk(m2, i), B)
                root = hc if root is None else root + hc
            stats["passes"] += 1
            node.zero_()
            hist[0] = reduce(root)
            book = _TreeBook(L, B, catp_host)
            book.set_best([0], _to_host(_best_for_leaf(
                hist[:1], mask_of(2 * (L - 1)), nanp, gcfg, monop, catp,
                catb), stats))

            if leafwise:
                min_gain = np.float32(gcfg.min_gain_to_split)
                while book.num_splits < L - 1:
                    active = np.arange(L) <= book.num_splits
                    if gcfg.max_depth > 0:
                        active &= book.depth < gcfg.max_depth
                    masked = np.where(active, book.bgain, np.float32(-np.inf))
                    l = int(np.argmax(masked))
                    if not masked[l] > min_gain:
                        break
                    do = np.arange(L) == l
                    plan = _apply_level_splits(book, do, np.arange(L), gcfg,
                                               dev)
                    nr = book.num_splits            # the new right leaf
                    child = None
                    for i, bT in passes("split"):
                        nd = chunk(node, i)
                        nd2 = _route_level(bT, nd, plan, nanp, has_cat)
                        nd.copy_(nd2)
                        rsel = (nd2 == nr).to(torch.float32)
                        hc = child_histogram(
                            bT, chunk(g, i) * rsel, chunk(h, i) * rsel,
                            chunk(m2, i) * rsel, B)
                        child = hc if child is None else child + hc
                    stats["passes"] += 1
                    child = reduce(child)
                    hist_l = hist[l] - child         # parent minus right
                    hist[l] = hist_l
                    hist[nr] = child
                    rows = _to_host(_best_for_leaf(
                        hist[[l, nr]], mask_of([int(book.mask_id[l]),
                                                int(book.mask_id[nr])]),
                        nanp, gcfg, monop, catp, catb), stats)
                    book.set_best([l, nr], rows)
            else:
                level = 0

                def growing() -> bool:
                    return book.num_splits < L - 1 and level < max_levels

                while growing():
                    do, order = _level_candidates(book, level, gcfg)
                    if not do.any():
                        break
                    plan = _apply_level_splits(book, do, order, gcfg, dev)
                    n_leaves = book.num_splits + 1
                    hist = None
                    for i, bT in passes("level"):
                        nd = chunk(node, i)
                        nd2 = _route_level(bT, nd, plan, nanp, has_cat)
                        nd.copy_(nd2)
                        hc = _level_chunk_hist(
                            bT, chunk(g, i), chunk(h, i), chunk(m2, i), nd2,
                            n_leaves, B, L, cuda)
                        hist = hc if hist is None else hist + hc
                    stats["passes"] += 1
                    hist = reduce(hist)
                    level += 1
                    if growing():
                        rows = _to_host(_best_for_leaf(
                            hist, mask_of(torch.as_tensor(book.mask_id,
                                                          device=dev)),
                            nanp, gcfg, monop, catp, catb), stats)
                        book.set_best(np.arange(L), rows)
                        book.bgain[book.num_splits + 1:] = -np.inf

            tree = trees_to_host([book.tree(hist, gcfg)])[0]
            trees.append(tree)
            lv = torch.as_tensor(tree.leaf_value).to(dev)
            score = score + lv[node] * m_all
            stats["passes"] += 1

            # ---- held-out stream: this tree's leaves, then the metric ------
            if has_valid:
                lv_np = np.asarray(tree.leaf_value)
                off = 0
                for bv in binned_v:
                    leaf = tree_leaves_binned(tree, bv, nan_bins_v).cpu()
                    score_v[off:off + bv.shape[0]] += lv_np[leaf.numpy()]
                    off += bv.shape[0]
                raw_v = torch.as_tensor(score_v).to(dev)[:, None]
                pred_v = obj.transform(raw_v[:, 0])
                mval = float(_eval_metric(metric_name, yv_j, pred_v, raw_v,
                                          None, cfg, wv_j))
                stats["host_syncs"] += 1
                tol = cfg.improvement_tolerance
                if (best_metric is None
                        or (mval > best_metric + tol if higher_better
                            else mval < best_metric - tol)):
                    best_metric, best_iter = mval, t
                if (cfg.early_stopping_round > 0
                        and t - best_iter >= cfg.early_stopping_round):
                    trees = trees[:best_iter + 1]
                    stopped_early = True
                    break

            if (ckpt_store is not None
                    and (t + 1) % max(checkpoint_every, 1) == 0):
                # every rank gathers the scores; rank 0 commits and every
                # rank waits until it has
                flat = global_rows(score).cpu().numpy()
                if rank == 0:
                    payload = {
                        "iteration": t + 1,
                        "trees": [tuple(np.asarray(a) for a in tr)
                                  for tr in trees],
                        "score": flat,
                        "in_bag": in_bag.cpu().numpy()}
                    if has_valid:
                        payload["score_v"] = score_v.copy()
                        payload["best_metric"] = np.float64(
                            np.nan if best_metric is None else best_metric)
                        payload["best_iter"] = int(best_iter)
                    _ckpt_save_gbdt(ckpt_store, t + 1, payload, fingerprint,
                                    measures)
                if group is not None:
                    torch.distributed.barrier(group=mesh.world_group)

    meta = {"host_syncs": stats["host_syncs"], "device": str(dev),
            "observed_fit_s": round(_time.perf_counter() - fit_t0, 6),
            "measures": measures.report()}
    if routing_info:
        meta["routing"] = routing_info
    if autoconfig_info:
        meta["autoconfig"] = autoconfig_info
    meta["streamed"] = {
        "chunk_rows": C_all, "num_chunks": nchunks,
        "rows": n, "resident": bool(resident),
        "sketch_exact": data.sketch_exact,
        "chunk_boundaries_visited": int(passes.step_base),
        "growth_policy": cfg.growth_policy,
        "workers": W,
        "block_rows": C,
        "cache_bytes": int(data.cache_bytes()),
        "passes": stats["passes"],
        **({"transfer": passes.log} if passes.log else {}),
        **({"sketch_second_pass": data.second_pass_decision}
           if data.second_pass_decision else {}),
        **({"chunk_decision": data.chunk_decision}
           if data.chunk_decision else {}),
    }
    if has_valid:
        meta["streamed"]["stopped_early"] = bool(stopped_early)
    return Booster(
        mapper, cfg, trees, [1.0] * len(trees), base,
        feature_names=feature_names,
        best_iteration=(best_iter if has_valid else -1),
        best_score=(best_metric if has_valid else None),
        metadata=meta, device=dev)


def predict_streamed(booster: Booster, batches: Iterable,
                     chunk_rows: Optional[int] = None,
                     depth: Optional[int] = None, **predict_kwargs):
    """Out-of-core scoring: raw ``X`` chunks (dense or scipy sparse) through
    the pump, one prediction array per chunk. ``chunk_rows`` is accepted for
    the JAX package's signature; the chunks score as they come."""
    def src():
        for chunk in batches:
            X = chunk[0] if isinstance(chunk, tuple) else chunk
            yield np.asarray(X.todense() if _is_sparse(X) else X, np.float32)

    pump = ChunkPump(src(), place=None, depth=stream_depth(depth),
                     threaded=False, name="gbdt-predict")
    for X in pump:
        yield np.asarray(booster.predict(X, **predict_kwargs))
