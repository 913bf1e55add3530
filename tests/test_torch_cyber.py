"""The port's CyberML (``synapseml_tpu_torch/cyber``) against the JAX
package's, on the CPU:

* every scenario of ``tests/test_cyber.py`` on the port;
* the indexers, the scalers and the complement sampler give equal outputs
  (the same host code and draws);
* ``AccessAnomaly`` in both modes on the same seeded log: the ALS factors
  within ``FACTOR_TOL`` of the largest factor, the affinities ``U Vᵀ``
  within ``AFFINITY_TOL`` of the largest and the normalized scores within
  ``SCORE_TOL`` (the per-row normal equations sum in another order and
  LAPACK's LU solves where XLA's own does; both sides start from the same
  host-drawn factors, the explicit mode's complement draw included);
* a model directory saved by the JAX package loads in the port with the
  same scores, and ``convert.access_anomaly_model_from_reference`` carries
  the factorizations across exactly.
"""

import numpy as np
import pytest

from synapseml_tpu import cyber as jcyber
from synapseml_tpu.core.table import Table as JTable

from synapseml_tpu_torch import cyber as tcyber
from synapseml_tpu_torch.convert import access_anomaly_model_from_reference
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.core.table import Table
from synapseml_tpu_torch.cyber import (AccessAnomaly, AccessAnomalyModel,
                                       ComplementAccessTransformer, IdIndexer,
                                       LinearScalarScaler, MultiIndexer,
                                       StandardScalarScaler)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
# float32 normal equations summed in another order and solved by another
# LU. Rank 6 on a tenant of 4 + 4 resources leaves the factors ill-determined
# (any invertible mix of U's columns against V's fits as well): they agreed
# to 7.6e-4 of their largest magnitude, the affinities U V^T to 2e-6 of the
# largest. Implicit mode's affinities all lie near 1 with a spread of 0.002,
# so normalizing (dividing by that std) magnifies their gaps 500-fold: the
# scores agreed to 4.2e-4 (explicit mode: 6.5e-6)
FACTOR_TOL = 2e-3
AFFINITY_TOL = 1e-5
SCORE_TOL = 1e-3


def _access_columns(seed=0, tenants=("t0",)):
    """Two user groups with disjoint resource habits inside each tenant."""
    rng = np.random.default_rng(seed)
    rows = {"tenant": [], "user": [], "res": [], "likelihood": []}
    for t in tenants:
        for u in range(8):
            group = "a" if u < 4 else "b"
            for _ in range(12):
                r = rng.integers(0, 4) if group == "a" else rng.integers(4, 8)
                rows["tenant"].append(t)
                rows["user"].append(f"u{u}")
                rows["res"].append(f"r{r}")
                rows["likelihood"].append(float(rng.integers(1, 5)))
    return {k: np.asarray(v) for k, v in rows.items()}


def _access_log(seed=0):
    return Table(_access_columns(seed))


class TestIndexers:
    def test_per_partition_indices(self):
        df = Table({"tenant": np.array(["a", "a", "b"]),
                    "user": np.array(["x", "y", "x"])})
        model = IdIndexer(inputCol="user", partitionKey="tenant",
                          outputCol="user_ix").fit(df)
        out = model.transform(df)
        assert out["user_ix"].tolist() == [1, 2, 1]  # b restarts at 1
        back = model.undo_transform(out)
        assert back["user"].tolist() == ["x", "y", "x"]

    def test_multi_indexer(self):
        df = Table({"tenant": np.array(["a", "a"]),
                    "user": np.array(["x", "y"]),
                    "res": np.array(["p", "q"])})
        mi = MultiIndexer(indexers=[
            IdIndexer(inputCol="user", partitionKey="tenant", outputCol="u"),
            IdIndexer(inputCol="res", partitionKey="tenant", outputCol="r")])
        model = mi.fit(df)
        out = model.transform(df)
        assert "u" in out and "r" in out
        assert model.get_model_by_input_col("res").getOutputCol() == "r"


class TestScalers:
    def test_standard_scaler_per_tenant(self):
        df = Table({"tenant": np.array(["a"] * 3 + ["b"] * 3),
                    "v": np.array([1.0, 2.0, 3.0, 10.0, 20.0, 30.0])})
        model = StandardScalarScaler(inputCol="v", partitionKey="tenant",
                                     outputCol="z").fit(df)
        out = model.transform(df)
        za, zb = out["z"][:3], out["z"][3:]
        assert abs(za.mean()) < 1e-9 and abs(zb.mean()) < 1e-9

    def test_linear_scaler_range(self):
        df = Table({"tenant": np.array(["a"] * 4),
                    "v": np.array([0.0, 1.0, 2.0, 4.0])})
        model = LinearScalarScaler(inputCol="v", partitionKey="tenant",
                                   outputCol="s", minRequiredValue=5.0,
                                   maxRequiredValue=10.0).fit(df)
        s = model.transform(df)["s"]
        assert s.min() == 5.0 and s.max() == 10.0


class TestAccessAnomaly:
    def test_cross_group_access_is_anomalous(self):
        model = AccessAnomaly(maxIter=12, rankParam=6, device=CPU).fit(
            _access_log())
        probe = Table({"tenant": np.array(["t0", "t0"]),
                       "user": np.array(["u0", "u0"]),
                       "res": np.array(["r0", "r7"])})
        scores = model.transform(probe)[model.getOutputCol()]
        assert scores[1] > scores[0]  # unfamiliar resource scores higher

    def test_unseen_user_scores_zero(self):
        model = AccessAnomaly(maxIter=4, rankParam=4, device=CPU).fit(
            _access_log())
        probe = Table({"tenant": np.array(["t0"]),
                       "user": np.array(["stranger"]),
                       "res": np.array(["r0"])})
        assert model.transform(probe)[model.getOutputCol()][0] == 0.0

    def test_training_scores_standardized(self):
        df = _access_log()
        model = AccessAnomaly(maxIter=12, rankParam=6, device=CPU).fit(df)
        scores = model.transform(df)[model.getOutputCol()]
        assert abs(scores.mean()) < 0.15 and 0.5 < scores.std() < 2.0

    def test_explicit_mode(self):
        df = _access_log()
        model = AccessAnomaly(maxIter=8, rankParam=4, applyImplicitCf=False,
                              device=CPU).fit(df)
        scores = model.transform(df)[model.getOutputCol()]
        assert np.isfinite(scores).all()


class TestComplementAccess:
    def test_complement_pairs_unseen(self):
        df = Table({"tenant": np.array(["t"] * 4),
                    "user": np.array(["a", "a", "b", "b"]),
                    "res": np.array(["x", "y", "x", "y"])})
        out = ComplementAccessTransformer(
            indexedColNamesArr=["user", "res"]).transform(df)
        assert out.num_rows == 0

        df2 = Table({"tenant": np.array(["t"] * 2),
                     "user": np.array(["a", "b"]),
                     "res": np.array(["x", "y"])})
        out2 = ComplementAccessTransformer(
            indexedColNamesArr=["user", "res"]).transform(df2)
        seen = set(zip(df2["user"], df2["res"]))
        for u, r in zip(out2["user"], out2["res"]):
            assert (u, r) not in seen


def test_the_card_is_the_default_device():
    assert AccessAnomaly().getDevice() == "cuda"


def _tables(cols):
    return JTable(dict(cols)), Table(dict(cols))


def _assert_tables_equal(j, t):
    assert list(j.columns) == list(t.columns)
    for c in j.columns:
        assert j[c].tolist() == t[c].tolist(), c


def test_indexers_and_scalers_are_the_references():
    cols = _access_columns(3, tenants=("t0", "t1"))
    jt, tt = _tables(cols)
    for name, kw in [("IdIndexer", dict(inputCol="user",
                                        partitionKey="tenant",
                                        outputCol="ix")),
                     ("IdIndexer", dict(inputCol="res",
                                        partitionKey="tenant",
                                        outputCol="ix",
                                        resetPerPartition=False)),
                     ("StandardScalarScaler", dict(
                         inputCol="likelihood", partitionKey="tenant",
                         outputCol="z", coefficientFactor=2.0,
                         targetMean=1.0, targetStd=3.0)),
                     ("LinearScalarScaler", dict(
                         inputCol="likelihood", partitionKey="tenant",
                         outputCol="s", minRequiredValue=5.0,
                         maxRequiredValue=10.0))]:
        jm = getattr(jcyber, name)(**kw).fit(jt)
        tm = getattr(tcyber, name)(**kw).fit(tt)
        jout, tout = jm.transform(jt), tm.transform(tt)
        _assert_tables_equal(jout, tout)
        if name == "IdIndexer":
            _assert_tables_equal(jm.undo_transform(jout),
                                 tm.undo_transform(tout))


@pytest.mark.parametrize("seed,factor", [(0, 2), (5, 1)])
def test_complement_pairs_are_the_references(seed, factor):
    cols = _access_columns(seed, tenants=("t0", "t1"))
    jt, tt = _tables({k: cols[k] for k in ("tenant", "user", "res")})
    kw = dict(indexedColNamesArr=["user", "res"], complementsetFactor=factor,
              seed=seed)
    j = jcyber.ComplementAccessTransformer(**kw).transform(jt)
    t = ComplementAccessTransformer(**kw).transform(tt)
    # emitted pairs come out of a set: compare them as sets per tenant
    as_set = (lambda tab: set(zip(tab["tenant"].tolist(), tab["user"].tolist(),
                                  tab["res"].tolist())))
    assert as_set(j) == as_set(t) and j.num_rows == t.num_rows > 0


ALS_CASES = [dict(maxIter=12, rankParam=6),
             dict(maxIter=8, rankParam=4, applyImplicitCf=False,
                  complementsetFactor=2, negScore=1.0, seed=3)]


def _check_models(jm, tm, jt, tt):
    jmods, tmods = jm.get("tenantModels"), tm.get("tenantModels")
    assert set(jmods) == set(tmods)
    for key in jmods:
        a, b = jmods[key], tmods[key]
        assert a["users"] == b["users"] and a["resources"] == b["resources"]
        for f in ("U", "V"):
            assert a[f].dtype == b[f].dtype == np.float32
            np.testing.assert_allclose(
                b[f], a[f], rtol=0, atol=FACTOR_TOL * np.abs(a[f]).max())
        pa, pb = a["U"] @ a["V"].T, b["U"] @ b["V"].T
        np.testing.assert_allclose(pb, pa, rtol=0,
                                   atol=AFFINITY_TOL * np.abs(pa).max())
    js = jm.transform(jt)[jm.getOutputCol()]
    ts = tm.transform(tt)[tm.getOutputCol()]
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("params", ALS_CASES)
def test_factors_and_scores_are_the_references(params):
    jt, tt = _tables(_access_columns(1, tenants=("t0", "t1")))
    jm = jcyber.AccessAnomaly(**params).fit(jt)
    tm = AccessAnomaly(device=CPU, **params).fit(tt)
    _check_models(jm, tm, jt, tt)


def test_a_model_the_jax_package_saved_loads_and_converts(tmp_path):
    jt, tt = _tables(_access_columns(2))
    jm = jcyber.AccessAnomaly(maxIter=6, rankParam=4,
                              outputCol="score").fit(jt)
    p = str(tmp_path / "jax_access")
    jm.save(p)
    loaded = PipelineStage.load(p, device=CPU)
    assert isinstance(loaded, AccessAnomalyModel)
    assert loaded.getOutputCol() == "score"
    js = jm.transform(jt)["score"]
    np.testing.assert_array_equal(loaded.transform(tt)["score"], js)
    carried = access_anomaly_model_from_reference(
        jm.get("tenantModels"), {"outputCol": "score"}, device=CPU)
    np.testing.assert_array_equal(carried.transform(tt)["score"], js)
