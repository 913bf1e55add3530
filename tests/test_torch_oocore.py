"""The port's out-of-core GBDT and ingestion layer (``io/ingest.py``,
``ops/quantize.StreamingQuantileSketch``, ``gbdt/stream.py``), scenario for
scenario the JAX package's ``tests/test_oocore.py``, on the same seeded
inputs and, where a scenario compares two runs, against the JAX package's
own run of it:

* chunk geometry: explicit > environment resolution, the memory budget's
  cap, the depth;
* the pump: order and count in both drive modes, the producer joined on
  every exit, a source's error as ``ChunkStreamError``, ``pump_polling``;
* sketch parity in both regimes, against the JAX package's sketch;
* streamed against resident mode bitwise; CSR against dense bitwise;
  routing through ``train_booster``; the refused configs; both growth
  policies; explicit chunk rows; ``predict_streamed``;
* chaos: delays, a killed producer, truncated chunks, a spilled chunk's
  EIO and torn read, all through the port's own hooks
  (``io.ingest._CHAOS_CHUNK_HOOK`` / ``_CHAOS_DISK_HOOK``, driven by the
  JAX package's ``chaos_chunk_stream`` fault plan); kill and resume bit
  for bit (``core.checkpoint._PREEMPT_HOOK``);
* sampling (bagging, GOSS, feature fractions), early stopping on a
  held-out stream, the disk source and the ``cache_dir`` spill.

Left out, each for its reason: ``TestMeshStreamed`` (its ranks need a
spawn: ``tests/test_torch_oocore_mesh.py``); ``TestDlSharedLayer`` (the DL trainer's prefetch stays refused, PR
13's scope: the port's trainer does not run on the pump); the steady-state
recompile test (the port compiles no programs: it runs eagerly).

Every fit runs with ``device="cpu"``: the histogram wrappers take their
plain versions there, and the card's path is held in ``chip_smoke.py``
phase 19 (``test_level_chunk_layout_matches_the_plain_path`` runs the
card's slot layout on the CPU).
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core import checkpoint as tckpt
from synapseml_tpu_torch.core.checkpoint import CheckpointStore, PreemptionError
from synapseml_tpu_torch.gbdt import (BoosterConfig, StreamedDataset,
                                      predict_streamed, train_booster,
                                      train_booster_streamed)
from synapseml_tpu_torch.gbdt import stream as tstream
from synapseml_tpu_torch.io import ingest as tingest
from synapseml_tpu_torch.io.ingest import (ChunkPump, ChunkStreamError,
                                           DiskChunkSource, pump_polling,
                                           stream_chunk_rows, stream_depth)
from synapseml_tpu_torch.ops.quantize import (StreamingQuantileSketch,
                                              apply_bins, compute_bin_mapper)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"


def _auc(y, s):
    from sklearn.metrics import roc_auc_score

    return roc_auc_score(y, s)


def _no_pump_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("chunk-pump.")] == []


def _mk_cfg(**kw):
    kw.setdefault("objective", "binary")
    kw.setdefault("num_iterations", 5)
    kw.setdefault("num_leaves", 8)
    return BoosterConfig(**kw)


def _fit(ds, cfg, **kw):
    return train_booster_streamed(ds, cfg, device=CPU, **kw)


def _same_trees(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        for x, y in zip(ta, tb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class _port_chunk_chaos:
    """The JAX package's ``chaos_chunk_stream`` fault plan installed on the
    port's hooks (``io.ingest``), not on the JAX package's."""

    def __init__(self, **plan):
        from synapseml_tpu.testing import chaos_chunk_stream

        self.plan = chaos_chunk_stream(**plan)

    def __enter__(self):
        if (tingest._CHAOS_CHUNK_HOOK is not None
                or tingest._CHAOS_DISK_HOOK is not None):
            raise RuntimeError("chaos hooks do not nest")
        tingest._CHAOS_CHUNK_HOOK = self.plan._hook
        tingest._CHAOS_DISK_HOOK = self.plan._disk
        return self.plan

    def __exit__(self, *exc):
        tingest._CHAOS_CHUNK_HOOK = None
        tingest._CHAOS_DISK_HOOK = None


@contextlib.contextmanager
def _preempt_at(phase: str, step: int):
    """Raise the port's ``PreemptionError`` once, at ``(phase, step)``."""
    kills = []

    def hook(ph, st):
        if ph == phase and st == step and not kills:
            kills.append((ph, st))
            raise PreemptionError(f"chaos: killed at {ph}:{st}")

    tckpt._PREEMPT_HOOK = hook
    try:
        yield kills
    finally:
        tckpt._PREEMPT_HOOK = None


# ---------------------------------------------------------------------------
# chunk geometry resolution
# ---------------------------------------------------------------------------

class TestChunkGeometry:
    def test_explicit_override_wins_as_given(self):
        assert stream_chunk_rows(50, explicit=128) == 128
        assert stream_chunk_rows(50, explicit=1 << 22) == 1 << 22

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("SYNAPSEML_TPU_STREAM_CHUNK_ROWS", "777")
        assert stream_chunk_rows(50) == 777

    def test_mem_budget_caps_chunk_rows(self, monkeypatch):
        row_bytes, depth = 100, 2
        monkeypatch.setenv("SYNAPSEML_TPU_STREAM_MEM_BUDGET",
                           str(row_bytes * (depth + 1) * 50))
        assert stream_chunk_rows(row_bytes, explicit=4096, depth=depth) == 50
        monkeypatch.setenv("SYNAPSEML_TPU_STREAM_MEM_BUDGET", "1")
        assert stream_chunk_rows(row_bytes, explicit=4096, depth=depth) == 1

    def test_depth_resolution(self, monkeypatch):
        assert stream_depth(5) == 5
        monkeypatch.setenv("SYNAPSEML_TPU_STREAM_DEPTH", "7")
        assert stream_depth() == 7
        monkeypatch.delenv("SYNAPSEML_TPU_STREAM_DEPTH")
        assert stream_depth() == 2

    def test_no_card_falls_back_with_provenance(self, monkeypatch):
        """Without a card there is no link to probe: the fallback rows,
        recorded as the perfmodel's fallback decision; an explicit value
        records none."""
        monkeypatch.delenv("SYNAPSEML_TPU_STREAM_CHUNK_ROWS", raising=False)
        monkeypatch.setattr(tingest, "_platform", lambda: None)
        assert stream_chunk_rows(52) == tingest._FALLBACK_CHUNK_ROWS
        dec = tingest.last_chunk_decision()
        assert dec["arm"] == f"c{tingest._FALLBACK_CHUNK_ROWS}"
        assert dec["source"] == "fallback" and dec["used_fallback"]
        stream_chunk_rows(52, explicit=100)
        assert tingest.last_chunk_decision() is None

    def test_probe_prices_the_link(self, monkeypatch):
        """With a card, a chunk is about 8 ms of the probed link, clamped,
        and a disk source's rate combines in series."""
        from synapseml_tpu_torch.core import tuned

        monkeypatch.delenv("SYNAPSEML_TPU_STREAM_CHUNK_ROWS", raising=False)
        monkeypatch.setattr(tingest, "_platform", lambda: "cuda")
        tuned.clear_measurements()
        monkeypatch.setattr(tingest, "_probe_h2d_bandwidth", lambda: 1e9)
        try:
            assert stream_chunk_rows(100) == int(1e9 * 8e-3 / 100)
            series = 1.0 / (1.0 / 1e9 + 1.0 / 1e9)
            assert stream_chunk_rows(100, read_bps=1e9) == int(
                series * 8e-3 / 100)
            assert stream_chunk_rows(1) == tingest._MAX_CHUNK_ROWS
        finally:
            tuned.clear_measurements()


# ---------------------------------------------------------------------------
# the pump
# ---------------------------------------------------------------------------

class TestChunkPump:
    @pytest.mark.parametrize("threaded", [False, True])
    def test_order_count_and_join(self, threaded):
        chunks = [np.full(4, i) for i in range(13)]
        out = list(ChunkPump(iter(chunks), depth=3, threaded=threaded,
                             name="t"))
        assert [int(c[0]) for c in out] == list(range(13))
        assert _no_pump_threads()

    def test_place_applied_ahead(self):
        placed = []
        pump = ChunkPump(iter(range(6)), place=lambda c: placed.append(c) or c,
                         depth=2, threaded=False, name="t")
        it = iter(pump)
        next(it)
        assert len(placed) >= 2
        assert list(it) == [1, 2, 3, 4, 5]

    def test_early_break_joins_producer(self):
        pump = ChunkPump(iter(range(100)), depth=2, threaded=True, name="t")
        for _ in pump:
            break
        assert _no_pump_threads()
        pump.close()

    @pytest.mark.parametrize("threaded", [False, True])
    def test_source_error_surfaces_and_joins(self, threaded):
        def bad():
            yield 0
            yield 1
            raise ValueError("source died")

        with pytest.raises(ChunkStreamError, match="died"):
            list(ChunkPump(bad(), depth=2, threaded=threaded, name="t"))
        assert _no_pump_threads()

    def test_thread_start_hook_runs_in_the_producer(self):
        names = []
        pump = ChunkPump(iter(range(3)), depth=1, threaded=True, name="t",
                         on_thread_start=lambda: names.append(
                             threading.current_thread().name))
        assert list(pump) == [0, 1, 2]
        assert names == ["chunk-pump.t"]

    def test_boundaries_are_preemption_points(self):
        seen = []
        tckpt._PREEMPT_HOOK = lambda ph, st: seen.append((ph, st))
        try:
            list(ChunkPump(iter(range(3)), depth=1, phase="p", step_base=10,
                           name="t"))
        finally:
            tckpt._PREEMPT_HOOK = None
        assert seen == [("p", 10), ("p", 11), ("p", 12)]

    def test_pump_polling_error_and_stop_semantics(self):
        stop = threading.Event()
        calls, errs = [], []

        def step():
            calls.append(1)
            if len(calls) == 2:
                raise ValueError("poisoned batch")
            if len(calls) >= 4:
                stop.set()
            return True

        pump_polling(step, stop, 0.001, on_error=errs.append)
        assert len(calls) == 4 and len(errs) == 1
        assert isinstance(errs[0], ValueError)

        def dying_step():
            raise PreemptionError("chaos")

        with pytest.raises(PreemptionError):
            pump_polling(dying_step, threading.Event(), 0.001,
                         on_error=errs.append)
        assert len(errs) == 1


# ---------------------------------------------------------------------------
# the sketch in both regimes, against the JAX package's
# ---------------------------------------------------------------------------

def _sketch_table():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:, 4] = rng.integers(0, 7, size=500)
    X[:, 5] = rng.integers(0, 3, size=500)
    return X


class TestSketchParity:
    def test_exact_regime_bit_equal_boundaries(self):
        X = _sketch_table()
        ref = compute_bin_mapper(X, max_bin=63, sample_count=10_000,
                                 categorical_features=[4, 5], seed=0)
        sk = StreamingQuantileSketch(6, 63, 10_000, [4, 5], seed=0)
        for i in range(0, 500, 111):
            sk.update(X[i:i + 111])
        assert sk.exact
        got = sk.finalize()
        for field in ("boundaries", "num_bins", "nan_bins", "is_categorical",
                      "cat_counts"):
            np.testing.assert_array_equal(getattr(ref, field),
                                          getattr(got, field))
        assert got.boundaries.tobytes() == ref.boundaries.tobytes()

    @pytest.mark.parametrize("regime", ["exact", "reservoir"])
    def test_sketch_matches_the_jax_sketch(self, regime):
        """The same chunks through both packages' sketches: the same
        reservoir draws (numpy's generator of the seed) and the same
        boundaries, byte for byte."""
        from synapseml_tpu.ops.quantize import \
            StreamingQuantileSketch as JSketch

        rng = np.random.default_rng(1)
        X = rng.normal(size=(2000, 3)).astype(np.float32)
        X[rng.random(X.shape) < 0.02] = np.nan
        cap = 10_000 if regime == "exact" else 256
        sk, jk = (cls(3, 31, cap, None, seed=4)
                  for cls in (StreamingQuantileSketch, JSketch))
        for i in range(0, 2000, 333):
            sk.update(X[i:i + 333])
            jk.update(X[i:i + 333])
        assert sk.exact == jk.exact == (regime == "exact")
        got, want = sk.finalize(), jk.finalize()
        assert got.boundaries.tobytes() == np.asarray(
            want.boundaries).tobytes()
        np.testing.assert_array_equal(got.num_bins, want.num_bins)
        np.testing.assert_array_equal(got.nan_bins, want.nan_bins)

    def test_reservoir_regime_still_valid(self):
        rng = np.random.default_rng(1)
        X = rng.normal(size=(2000, 3)).astype(np.float32)
        sk = StreamingQuantileSketch(3, 31, 256, None, seed=0)
        for i in range(0, 2000, 333):
            sk.update(X[i:i + 333])
        assert not sk.exact
        m = sk.finalize()
        assert (np.asarray(m.num_bins) >= 2).all()
        b = np.asarray(m.boundaries)
        for j in range(3):
            fin = b[j][np.isfinite(b[j])]
            assert (np.diff(fin) >= 0).all()
        binned = apply_bins(m, X, CPU).numpy()
        assert binned.min() >= 0 and binned.max() < 31

    def test_csr_update_is_the_dense_update(self):
        sp = pytest.importorskip("scipy.sparse")
        X = _sketch_table()[:, :4]
        X[np.random.default_rng(3).random(X.shape) < 0.6] = 0.0
        dense = StreamingQuantileSketch(4, 31, 10_000, seed=0)
        csr = StreamingQuantileSketch(4, 31, 10_000, seed=0)
        for i in range(0, 500, 200):
            dense.update(X[i:i + 200])
            coo = sp.csr_matrix(X[i:i + 200]).tocoo()
            csr.update_csr(coo.data, coo.row, coo.col, coo.shape[0])
        assert (dense.finalize().boundaries.tobytes()
                == csr.finalize().boundaries.tobytes())


# ---------------------------------------------------------------------------
# streamed training
# ---------------------------------------------------------------------------

class TestStreamedParity:
    def test_streamed_equals_resident_mode_bitwise(self, binary_data):
        Xtr, Xte, ytr, _ = binary_data
        cfg = _mk_cfg()
        ds = StreamedDataset.from_arrays(Xtr, ytr, source_chunk=150,
                                         chunk_rows=128)
        b_stream = _fit(ds, cfg)
        b_res = _fit(ds, cfg, resident=True)
        assert b_stream.metadata["streamed"]["resident"] is False
        assert b_res.metadata["streamed"]["resident"] is True
        _same_trees(b_stream, b_res)
        np.testing.assert_array_equal(b_stream.raw_score(Xte),
                                      b_res.raw_score(Xte))
        assert _no_pump_threads()

    def test_auc_parity_vs_classic_resident(self, binary_data):
        Xtr, Xte, ytr, yte = binary_data
        cfg = _mk_cfg(num_iterations=10)
        classic = train_booster(Xtr, ytr, cfg, device=CPU)
        ds = StreamedDataset.from_arrays(Xtr, ytr, source_chunk=200,
                                         chunk_rows=128)
        streamed = _fit(ds, cfg)
        assert streamed.metadata["streamed"]["sketch_exact"] is True
        assert abs(_auc(yte, classic.predict(Xte))
                   - _auc(yte, streamed.predict(Xte))) <= 1e-3

    def test_sparse_csr_equals_dense_bitwise(self):
        sp = pytest.importorskip("scipy.sparse")
        rng = np.random.default_rng(2)
        Xd = rng.normal(size=(300, 8)).astype(np.float32)
        Xd[rng.random(Xd.shape) < 0.7] = 0.0
        y = (Xd[:, 0] + 0.1 * rng.normal(size=300) > 0).astype(np.float32)
        Xs = sp.csr_matrix(Xd)
        cfg = _mk_cfg(num_iterations=4)

        def sparse_batches():
            for i in range(0, 300, 90):
                yield Xs[i:i + 90], y[i:i + 90]

        b_d = _fit(StreamedDataset.from_arrays(Xd, y, source_chunk=90,
                                               chunk_rows=64), cfg)
        b_s = _fit(StreamedDataset(sparse_batches, chunk_rows=64), cfg)
        np.testing.assert_array_equal(b_d.raw_score(Xd), b_s.raw_score(Xd))
        chunks = [Xs[i:i + 90] for i in range(0, 300, 90)]
        got = np.concatenate(list(predict_streamed(b_s, chunks)))
        np.testing.assert_allclose(got, b_s.predict(Xd), rtol=1e-6)

    def test_train_booster_routes_streamed_dataset(self, binary_data):
        Xtr, _, ytr, _ = binary_data
        cfg = _mk_cfg(num_iterations=3)
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        b = train_booster(ds, None, cfg, device=CPU)
        assert "streamed" in b.metadata
        _same_trees(b, _fit(StreamedDataset.from_arrays(
            Xtr, ytr, chunk_rows=128), cfg))
        with pytest.raises(NotImplementedError, match="does not take"):
            train_booster(StreamedDataset.from_arrays(Xtr, ytr,
                                                      chunk_rows=128),
                          ytr, cfg, device=CPU)

    def test_unsupported_configs_raise(self, binary_data):
        Xtr, _, ytr, _ = binary_data
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        for bad in (dict(boosting_type="dart"),
                    dict(boosting_type="rf", bagging_fraction=0.5,
                         bagging_freq=1),
                    dict(objective="multiclass", num_class=3),
                    dict(early_stopping_round=2)):
            with pytest.raises(NotImplementedError):
                _fit(ds, _mk_cfg(**bad))
        with pytest.raises(NotImplementedError, match="ranking validation"):
            _fit(ds, _mk_cfg(metric="ndcg"), valid_data=(Xtr, ytr))

    def test_refusal_messages_are_the_jax_packages(self, binary_data):
        from synapseml_tpu.gbdt import BoosterConfig as JConfig
        from synapseml_tpu.gbdt import stream as jstream

        for bad in (dict(boosting_type="dart"),
                    dict(objective="multiclass", num_class=3),
                    dict(early_stopping_round=2)):
            msgs = []
            for check, cfg in ((tstream._check_supported, _mk_cfg(**bad)),
                               (jstream._check_supported, JConfig(
                                   **{"objective": "binary", **bad}))):
                with pytest.raises(NotImplementedError) as e:
                    check(cfg)
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1]

    def test_mesh_is_refused_by_name(self, binary_data, monkeypatch):
        """What a streamed mesh still refuses, before any work, with the
        JAX package's messages: streaming in a multi-controller world
        (``initialize_distributed``: every process its own rows) and the
        voting and feature learners (``tests/test_torch_oocore_mesh.py``
        holds the data-parallel mesh to the JAX package)."""
        from synapseml_tpu.gbdt import BoosterConfig as JConfig
        from synapseml_tpu.gbdt import StreamedDataset as JStreamed
        from synapseml_tpu.gbdt import train_booster_streamed as jstreamed
        from synapseml_tpu.parallel import make_mesh as jmesh
        from synapseml_tpu_torch.parallel import mesh as tmesh

        Xtr, _, ytr, _ = binary_data
        mesh = tmesh.Mesh({"data": 1}, 0, {"data": 0}, {},
                          torch.device("cpu"))
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        for learner in ("voting", "feature"):
            msgs = []
            with pytest.raises(NotImplementedError) as e:
                train_booster_streamed(ds, _mk_cfg(tree_learner=learner),
                                       mesh=mesh, device=CPU)
            msgs.append(str(e.value))
            with pytest.raises(NotImplementedError) as e:
                jstreamed(JStreamed.from_arrays(Xtr, ytr, chunk_rows=128),
                          JConfig(objective="binary", num_iterations=1,
                                  tree_learner=learner), mesh=jmesh(
                                      {"data": 1}))
            msgs.append(str(e.value))
            assert msgs[0] == msgs[1]
        monkeypatch.setattr(tmesh, "process_count", lambda: 2)
        with pytest.raises(NotImplementedError,
                           match="mesh-streamed GBDT is single-controller"):
            train_booster_streamed(ds, _mk_cfg(), mesh=mesh, device=CPU)
        assert ds.chunk_rows is None               # nothing was prepared

    def test_no_card_is_refused(self, binary_data):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        Xtr, _, ytr, _ = binary_data
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        with pytest.raises(RuntimeError, match="cuda"):
            train_booster_streamed(ds, _mk_cfg())

    def test_both_growth_policies_stream(self, binary_data):
        Xtr, Xte, ytr, _ = binary_data
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        for policy, passes in (("leafwise", lambda s, l: 2 + s),
                               ("depthwise", lambda s, l: 2 + l)):
            cfg = _mk_cfg(num_iterations=3, growth_policy=policy)
            b_s = _fit(ds, cfg)
            b_r = _fit(ds, cfg, resident=True)
            np.testing.assert_array_equal(b_s.raw_score(Xte),
                                          b_r.raw_score(Xte))
            md = b_s.metadata["streamed"]
            assert md["growth_policy"] == policy
            from synapseml_tpu_torch.gbdt.grower import forest_max_depth

            assert md["passes"] == sum(
                passes(int(t.num_splits), forest_max_depth([t]))
                for t in b_s.trees)
            assert md["chunk_boundaries_visited"] == (
                md["passes"] - len(b_s.trees)) * md["num_chunks"]
        assert _no_pump_threads()

    def test_level_chunk_layout_matches_the_plain_path(self):
        """The card's depthwise layout (rows laid out by slot in
        ``CHUNK``-row runs for one ``level_histograms`` launch) run on the
        CPU gives the plain path's histograms."""
        rng = np.random.default_rng(5)
        C, FP, B, L = 3000, 8, 256, 7
        bT = torch.as_tensor(rng.integers(0, B, (FP, C)), dtype=torch.int32)
        m = torch.as_tensor((rng.random(C) > 0.1).astype(np.float32))
        g = torch.as_tensor(rng.normal(size=C).astype(np.float32)) * m
        h = torch.as_tensor(rng.random(C).astype(np.float32)) * m
        node = torch.as_tensor(rng.integers(0, 5, C), dtype=torch.int64)
        plain = tstream._level_chunk_hist(bT, g, h, m, node, 5, B, L, False)
        laid = tstream._level_chunk_hist(bT, g, h, m, node, 5, B, L, True)
        torch.testing.assert_close(laid, plain, rtol=1e-6, atol=1e-5)
        assert float(laid[5:].abs().sum()) == 0.0

    def test_dataset_api_contracts(self):
        with pytest.raises(TypeError, match="CALLABLE"):
            StreamedDataset(iter([np.zeros((2, 2))]))
        with pytest.raises(ValueError, match="no rows"):
            StreamedDataset(lambda: iter([])).prepare(_mk_cfg(), device=CPU)
        X = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
        ds = StreamedDataset.from_arrays(X, np.zeros(64, np.float32),
                                         chunk_rows=32)
        ds.prepare(_mk_cfg(max_bin=63), device=CPU)
        ds.prepare(_mk_cfg(max_bin=63), device=CPU)
        with pytest.raises(ValueError, match="already prepared"):
            ds.prepare(_mk_cfg(max_bin=31), device=CPU)

    def test_explicit_chunk_rows_honored_in_metadata(self, binary_data):
        Xtr, _, ytr, _ = binary_data
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=96)
        md = _fit(ds, _mk_cfg(num_iterations=1)).metadata["streamed"]
        assert md["chunk_rows"] == 96
        assert md["num_chunks"] == -(-len(Xtr) // 96)
        assert md["rows"] == len(Xtr)

    def test_predict_streamed_matches_resident_predict(self, binary_data):
        Xtr, Xte, ytr, _ = binary_data
        b = _fit(StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128),
                 _mk_cfg(num_iterations=3))
        chunks = [Xte[i:i + 50] for i in range(0, len(Xte), 50)]
        got = np.concatenate(list(predict_streamed(b, chunks)))
        np.testing.assert_allclose(got, b.predict(Xte), rtol=1e-6)


# ---------------------------------------------------------------------------
# chaos: the chunk stream as a failure surface
# ---------------------------------------------------------------------------

class TestChunkStreamChaos:
    def test_delay_is_absorbed_bitwise(self, binary_data):
        Xtr, Xte, ytr, _ = binary_data
        cfg = _mk_cfg(num_iterations=2)
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        ref = _fit(ds, cfg)
        with _port_chunk_chaos(delay={0: 0.05, 2: 0.05}) as cc:
            slow = _fit(ds, cfg)
        assert ("delay", 0) in cc.faults
        np.testing.assert_array_equal(ref.raw_score(Xte),
                                      slow.raw_score(Xte))
        assert _no_pump_threads()

    def test_killed_producer_surfaces_and_joins(self, binary_data):
        Xtr, _, ytr, _ = binary_data
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        with _port_chunk_chaos(kill_at=1) as cc:
            with pytest.raises(ChunkStreamError):
                _fit(ds, _mk_cfg(num_iterations=2))
        assert ("kill", 1) in cc.faults
        assert _no_pump_threads()

    def test_truncated_chunks_observed_at_pump_level(self):
        chunks = [np.full((8, 2), i, np.float32) for i in range(5)]
        with _port_chunk_chaos(truncate_at=3, truncate_rows=0) as cc:
            out = list(ChunkPump(iter(chunks), depth=2, threaded=True,
                                 name="t"))
        assert [c.shape[0] for c in out] == [8, 8, 8, 0, 0]
        assert [f for f, _ in cc.faults] == ["truncate", "truncate"]
        assert cc.seen[0] == (0, 8)
        assert _no_pump_threads()

    def test_chaos_hooks_do_not_nest(self):
        with _port_chunk_chaos():
            with pytest.raises(RuntimeError, match="nest"):
                with _port_chunk_chaos():
                    pass


class TestKillResume:
    def _roundtrip(self, tmp_path, ds, cfg, steps_per_tree):
        ref = _fit(ds, cfg)
        d = str(tmp_path / "ck")
        kill = sum(len(ds.chunks) * (s - 1) for s in steps_per_tree(ref))
        with pytest.raises(PreemptionError):
            with _preempt_at(tstream.STREAM_PHASE, kill) as kills:
                _fit(ds, cfg, checkpoint_store=d, checkpoint_every=1)
        assert kills, "the kill step was never visited"
        assert _no_pump_threads()
        assert CheckpointStore(d).steps(), "no snapshot before the kill"
        resumed = _fit(ds, cfg, checkpoint_store=d, checkpoint_every=1)
        return ref, resumed

    @staticmethod
    def _first_trees(k):
        """Per-tree pumped passes of a fit's first ``k`` trees (plus one
        boundary into tree k's root pass)."""
        def steps(booster):
            out = [1 + int(t.num_splits) + 1 for t in booster.trees[:k]]
            out.append(2)
            return out
        return steps

    def test_kill_resume_bit_for_bit(self, tmp_path, binary_data):
        Xtr, Xte, ytr, _ = binary_data
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        ref, resumed = self._roundtrip(tmp_path, ds,
                                       _mk_cfg(num_iterations=6),
                                       self._first_trees(3))
        _same_trees(ref, resumed)
        np.testing.assert_array_equal(ref.raw_score(Xte),
                                      resumed.raw_score(Xte))

    def test_resume_ignores_mismatched_geometry(self, tmp_path,
                                                binary_data):
        Xtr, _, ytr, _ = binary_data
        cfg = _mk_cfg(num_iterations=2)
        d = str(tmp_path / "ck")
        _fit(StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128), cfg,
             checkpoint_store=d, checkpoint_every=1)
        ds2 = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=96)
        ref = _fit(ds2, cfg)
        resumed = _fit(ds2, cfg, checkpoint_store=d, checkpoint_every=1)
        np.testing.assert_array_equal(ref.raw_score(Xtr),
                                      resumed.raw_score(Xtr))

    @pytest.mark.parametrize("over", [
        dict(bagging_fraction=0.6, bagging_freq=2),
        dict(boosting_type="goss"),
        dict(growth_policy="depthwise", bagging_fraction=0.7,
             bagging_freq=1)])
    def test_sampled_fits_resume_bit_for_bit(self, tmp_path, binary_data,
                                             over):
        Xtr, Xte, ytr, yte = binary_data
        cfg = _mk_cfg(num_iterations=6, **over)
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        depthwise = over.get("growth_policy") == "depthwise"

        def steps(booster):
            from synapseml_tpu_torch.gbdt.grower import forest_max_depth

            out = [(1 + (forest_max_depth([t]) if depthwise
                         else int(t.num_splits)) + 1)
                   for t in booster.trees[:3]]
            return out + [2]

        ref, resumed = self._roundtrip(tmp_path, ds, cfg, steps)
        _same_trees(ref, resumed)
        assert _auc(yte, ref.predict(Xte)) > 0.9


# ---------------------------------------------------------------------------
# streamed sampling, held-out early stopping
# ---------------------------------------------------------------------------

class TestStreamedSampling:
    def test_bagging_deterministic(self, binary_data):
        Xtr, Xte, ytr, _ = binary_data
        cfg = _mk_cfg(num_iterations=6, bagging_fraction=0.6, bagging_freq=2)
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        np.testing.assert_array_equal(_fit(ds, cfg).raw_score(Xte),
                                      _fit(ds, cfg).raw_score(Xte))

    @pytest.mark.parametrize("over", [
        dict(bagging_fraction=0.5, bagging_freq=1),
        dict(feature_fraction=0.6, feature_fraction_bynode=0.8),
        dict(boosting_type="goss")])
    def test_sampling_matches_resident_mode_bitwise(self, binary_data,
                                                    over):
        Xtr, Xte, ytr, yte = binary_data
        cfg = _mk_cfg(num_iterations=4, **over)
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        b_s = _fit(ds, cfg)
        b_r = _fit(ds, cfg, resident=True)
        _same_trees(b_s, b_r)
        assert _auc(yte, b_s.predict(Xte)) > 0.9

    def test_goss_matches_classic_auc(self, binary_data):
        Xtr, Xte, ytr, yte = binary_data
        cfg = _mk_cfg(num_iterations=8, boosting_type="goss")
        classic = train_booster(Xtr, ytr, cfg, device=CPU)
        streamed = _fit(StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128),
                        cfg)
        assert abs(_auc(yte, classic.predict(Xte))
                   - _auc(yte, streamed.predict(Xte))) <= 5e-3


class TestStreamedEarlyStop:
    def test_heldout_stream_early_stop(self, binary_data):
        Xtr, Xte, ytr, yte = binary_data
        mk = lambda: _mk_cfg(num_iterations=40, early_stopping_round=3)
        streamed = _fit(StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128),
                        mk(), valid_data=(Xte, yte))
        res = _fit(StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128),
                   mk(), valid_data=(Xte, yte), resident=True)
        assert streamed.best_iteration == res.best_iteration
        assert len(streamed.trees) == len(res.trees)
        np.testing.assert_array_equal(streamed.raw_score(Xte),
                                      res.raw_score(Xte))
        classic = train_booster(Xtr, ytr, mk(), valid=(Xte, yte), device=CPU)
        assert len(classic.trees) < 40 and len(streamed.trees) < 40
        assert len(streamed.trees) == streamed.best_iteration + 1
        assert abs(streamed.best_score - classic.best_score) <= 1e-3
        assert streamed.metadata["streamed"]["stopped_early"] is True
        assert _no_pump_threads()

    def test_valid_stream_without_early_stop_records_best(self, binary_data):
        Xtr, Xte, ytr, yte = binary_data
        b = _fit(StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128),
                 _mk_cfg(num_iterations=5), valid_data=(Xte, yte))
        assert len(b.trees) == 5
        assert b.best_score is not None and 0.5 < b.best_score <= 1.0
        assert 0 <= b.best_iteration < 5

    def test_early_stop_resumes_bit_for_bit(self, tmp_path, binary_data):
        """The held-out score and best metric ride the snapshot: a resumed
        fit stops where the uninterrupted one stops."""
        Xtr, Xte, ytr, yte = binary_data
        cfg = lambda: _mk_cfg(num_iterations=30, early_stopping_round=3)
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128)
        ref = _fit(ds, cfg(), valid_data=(Xte, yte))
        d = str(tmp_path / "ck")
        kill = sum(len(ds.chunks) * (1 + int(t.num_splits))
                   for t in ref.trees[:2])
        with pytest.raises(PreemptionError):
            with _preempt_at(tstream.STREAM_PHASE, kill):
                _fit(ds, cfg(), valid_data=(Xte, yte), checkpoint_store=d)
        got = _fit(ds, cfg(), valid_data=(Xte, yte), checkpoint_store=d)
        assert got.best_iteration == ref.best_iteration
        _same_trees(got, ref)


# ---------------------------------------------------------------------------
# the disk source and the cache_dir spill
# ---------------------------------------------------------------------------

class TestDiskChunkSource:
    def test_npy_source_roundtrip_and_training_parity(self, tmp_path,
                                                      binary_data):
        Xtr, Xte, ytr, _ = binary_data
        p = str(tmp_path / "X.npy")
        np.save(p, Xtr)
        src = DiskChunkSource(p, rows_per_chunk=100, labels=ytr)
        assert src.n_rows == len(Xtr)
        assert src.num_features == Xtr.shape[1]
        assert src.read_bytes_per_s > 0
        np.testing.assert_array_equal(np.concatenate([c[0] for c in src()]),
                                      Xtr)
        cfg = _mk_cfg(num_iterations=3)
        b_disk = _fit(StreamedDataset(src, chunk_rows=128), cfg)
        b_ram = _fit(StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128),
                     cfg)
        np.testing.assert_array_equal(b_disk.raw_score(Xte),
                                      b_ram.raw_score(Xte))
        assert _no_pump_threads()

    def test_raw_uint8_source(self, tmp_path):
        rng = np.random.default_rng(0)
        arr = rng.integers(0, 255, size=(64, 5), dtype=np.uint8)
        p = str(tmp_path / "X.u8")
        arr.tofile(p)
        src = DiskChunkSource(p, rows_per_chunk=20, raw=True, num_features=5)
        assert src.n_rows == 64
        chunks = [c[0] for c in src()]
        assert [c.shape[0] for c in chunks] == [20, 20, 20, 4]
        np.testing.assert_array_equal(np.concatenate(chunks), arr)
        with pytest.raises(ValueError, match="num_features"):
            DiskChunkSource(p, raw=True)

    def test_cache_dir_spills_and_stays_bitwise(self, tmp_path, binary_data):
        Xtr, Xte, ytr, _ = binary_data
        cfg = _mk_cfg(num_iterations=3)
        spill = tmp_path / "spill"
        b_ram = _fit(StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128),
                     cfg)
        ds_spill = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128,
                                               cache_dir=str(spill))
        b_spill = _fit(ds_spill, cfg)
        np.testing.assert_array_equal(b_ram.raw_score(Xte),
                                      b_spill.raw_score(Xte))
        assert all("bT" not in ch and "bT_path" in ch
                   for ch in ds_spill.chunks)
        assert len(list(spill.glob("chunk*.npy"))) == len(ds_spill.chunks)

    def test_disk_eio_mid_stream_surfaces(self, tmp_path, binary_data):
        Xtr, _, ytr, _ = binary_data
        cfg = _mk_cfg(num_iterations=2)
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128,
                                         cache_dir=str(tmp_path / "s"))
        _fit(ds, cfg)
        with _port_chunk_chaos(disk_eio_at=1) as cc:
            with pytest.raises(ChunkStreamError, match="EIO"):
                _fit(ds, cfg)
        assert ("disk_eio", 1) in cc.faults
        assert _no_pump_threads()

    def test_disk_torn_read_detected(self, tmp_path, binary_data):
        Xtr, _, ytr, _ = binary_data
        cfg = _mk_cfg(num_iterations=2)
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=128,
                                         cache_dir=str(tmp_path / "s"))
        _fit(ds, cfg)
        with _port_chunk_chaos(disk_truncate_at=1, disk_truncate_rows=7) \
                as cc:
            with pytest.raises(ChunkStreamError, match="torn read"):
                _fit(ds, cfg)
        assert ("disk_torn", 1) in cc.faults
        assert _no_pump_threads()


# ---------------------------------------------------------------------------
# the perf-model decisions the ingest path records
# ---------------------------------------------------------------------------

def test_second_pass_decision_is_the_fallback_unless_forced():
    """The JAX package's rule: the exact pass is taken when its analytic
    cost (the sketch pass's own seconds) is within SECOND_PASS_BUDGET of
    the training estimate (a pass per tree level per iteration), skipped
    (the fallback) when it is not, and forced either way by
    ``exact_second_pass``."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(600, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    cfg = _mk_cfg(bin_sample_count=200)          # 5 iterations x 3 levels
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=256).prepare(
        cfg, device=CPU)
    dec = ds.second_pass_decision
    assert dec["arm"] == "exact" and dec["source"] == "analytic"
    assert dec["used_fallback"] is False and dec["observed_s"] >= 0
    assert dec["candidates"][0]["arm"] == "exact"
    assert ds.sketch_exact is True
    exact = compute_bin_mapper(X, cfg.max_bin, 600, seed=cfg.seed)
    assert ds.mapper.boundaries.tobytes() == exact.boundaries.tobytes()
    # one iteration of a stump: the pass would cost 10x the budget
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=256).prepare(
        _mk_cfg(bin_sample_count=200, num_iterations=1, num_leaves=2),
        device=CPU)
    assert ds.sketch_exact is False
    dec = ds.second_pass_decision
    assert dec["arm"] == "skip" and dec["used_fallback"] is True
    forced = StreamedDataset.from_arrays(X, y, chunk_rows=256,
                                         exact_second_pass=True).prepare(
        cfg, device=CPU)
    assert forced.second_pass_decision == {"kind": "gbdt_sketch_pass",
                                           "arm": "exact",
                                           "source": "explicit"}
    assert forced.sketch_exact is True
    want = compute_bin_mapper(X, cfg.max_bin, 600, seed=cfg.seed)
    assert forced.mapper.boundaries.tobytes() == want.boundaries.tobytes()
