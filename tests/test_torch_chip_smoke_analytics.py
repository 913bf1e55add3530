"""``chip_smoke.py`` phase 23 — anomaly detection, recommendation and
nearest neighbours — on the CPU: its four seeded tables at a tiny size
(shapes, planted outliers, determinism), and the whole phase rehearsed at
small sizes with the CPU process beside it. Phase 23 launches none of the
port's kernels, so the rehearsal passes whole.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)  # noqa: E402

SMALL = dict(
    CREDIT_ROWS=3000, CREDIT_FRAUDS=12,
    IFOREST=dict(numEstimators=20, maxSamples=64.0, contamination=0.004,
                 randomSeed=1),
    ANOMALY_EVENTS=640, ACCESS_TENANTS=2, ACCESS_USERS=200, ACCESS_RES=100,
    ACCESS_DEPTS=5, ACCESS_ROWS=6000, ACCESS=dict(rankParam=4, maxIter=6),
    ACCESS_TOP=100, ML_USERS=300, ML_ITEMS=200, ML_RATINGS=12000,
    SAR_SUBSET=50, SAR_CHECK_COLS=16, SAR_PAIRS=5000, SIFT_BASE=3000,
    SIFT_QUERIES=300, KNN_CHECK=64, KNN_LABELS=20, ANALYTICS_CPU_THREADS=1)


def test_phase_23_helpers_import_without_a_card():
    for name in ("analytics_path", "iforest_part", "access_part", "sar_part",
                 "knn_part", "credit_like", "access_log", "movielens_like",
                 "sift_like", "start_analytics_cpu", "_analytics_cpu"):
        assert callable(getattr(cs, name)), name
    assert set(cs._ANALYTICS_SETTINGS) <= set(vars(cs))


def test_credit_like_is_seeded_with_planted_frauds():
    X, planted = cs.credit_like(2000, 8)
    X2, planted2 = cs.credit_like(2000, 8)
    assert X.shape == (2000, cs.CREDIT_FEATURES) and X.dtype == np.float32
    np.testing.assert_array_equal(X, X2)
    np.testing.assert_array_equal(planted, planted2)
    assert planted.sum() == 8
    assert (np.diff(X[:, 0]) >= 0).all() and (X[:, 29] >= 0).all()
    # the frauds sit off the bulk in V1-V14
    z = np.abs(X[:, 1:15] / X[~planted, 1:15].std(axis=0)).mean(axis=1)
    assert z[planted].min() > np.quantile(z[~planted], 0.99)
    assert not np.array_equal(cs.credit_like(2000, 8, seed=1)[0], X)


def test_access_log_plants_cross_department_accesses():
    cols = cs.access_log(2, 50, 40, 5, 3000, 0.05)
    again = cs.access_log(2, 50, 40, 5, 3000, 0.05)
    for k in cols:
        np.testing.assert_array_equal(cols[k], again[k])
    assert all(len(v) == 6000 for v in cols.values())
    assert set(np.unique(cols["tenant"])) == {0, 1}
    assert cols["user"].max() < 50 and cols["res"].max() < 40
    dept_of_res = cols["res"] // (40 // 5)
    cross = dept_of_res != cols["user"] % 5
    np.testing.assert_array_equal(cross, cols["planted"])
    assert 0.02 < cols["planted"].mean() < 0.08
    assert (1 <= cols["likelihood"]).all() and (cols["likelihood"] <= 9).all()


def test_movielens_like_is_shaped_like_ml_10m():
    cols = cs.movielens_like(100, 80, 5000)
    again = cs.movielens_like(100, 80, 5000)
    for k in cols:
        np.testing.assert_array_equal(cols[k], again[k])
    assert all(len(v) == 5000 for v in cols.values())
    assert np.bincount(cols["user"], minlength=100).min() >= 20
    assert set(np.unique(cols["item"])) == set(range(80))
    assert set(np.unique(cols["rating"])) <= {i / 2 for i in range(1, 11)}
    assert cols["time"].min() >= cs.ML_T0 and cols["time"].max() <= cs.ML_T1
    # a power law: the most popular item holds far more than its share
    assert np.bincount(cols["item"]).max() > 5 * 5000 / 80


def test_sift_like_is_integer_valued_and_seeded():
    keys, q = cs.sift_like(500, 16, 20)
    keys2, q2 = cs.sift_like(500, 16, 20)
    assert keys.shape == (500, 16) and q.shape == (20, 16)
    np.testing.assert_array_equal(keys, keys2)
    np.testing.assert_array_equal(q, q2)
    assert keys.dtype == np.float32 and (keys == np.round(keys)).all()
    assert keys.min() >= 0 and keys.max() <= 255
    assert (keys == 0).mean() > 0.05          # sparse, as SIFT's are


def test_phase_23_rehearses_on_the_cpu(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(cs, k, v)
    out = cs.analytics_path("cpu")
    assert set(out) == {"a", "b", "c", "d"}
    assert out["a"]["cpu_gap"] <= cs.IFOREST_TOL
    assert out["a"]["stream"]["scored"] == SMALL["ANOMALY_EVENTS"]
    assert out["c"]["similarity_mismatches"] == 0
    assert out["c"]["subset_equal_to_all_users"]
    assert out["d"]["brute force"]["recall"] == 1.0
