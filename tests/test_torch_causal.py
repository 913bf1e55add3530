"""The port's causal estimators (``synapseml_tpu_torch/causal``) against
the JAX package's, on the CPU:

* every scenario of ``tests/test_causal.py`` on the port;
* the same seeded inputs through both packages: ``linear_regression_with_se``
  and ``_weighted_did`` bitwise (float64 numpy on both sides); the simplex
  solve's weights within ``SIMPLEX_TOL`` (the same float32 steps, its
  matrix-vector sums in another order); DoubleML's raw effects and
  OrthoForest's per-row effects within ``EFFECT_TOL`` (the port's
  LightGBM trees are the JAX package's on the CPU, and its leaf sums
  differ in the last float32 bits); the synthetic estimators' unit and time
  weights within ``SIMPLEX_TOL`` and effects within ``DID_TOL``.
"""

import numpy as np
import pytest

from synapseml_tpu_torch.causal import (DiffInDiffEstimator,
                                        DoubleMLEstimator,
                                        OrthoForestDMLEstimator,
                                        ResidualTransformer,
                                        SyntheticControlEstimator,
                                        SyntheticDiffInDiffEstimator,
                                        constrained_least_squares,
                                        linear_regression_with_se)
from synapseml_tpu_torch.core.table import Table
from synapseml_tpu_torch.models import LightGBMRegressor
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
SIMPLEX_TOL = 1e-4
EFFECT_TOL = 1e-6
DID_TOL = 1e-4


def _dml_cols(n=600, true_ate=2.0, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    propensity = 1 / (1 + np.exp(-X[:, 0]))
    T = (rng.uniform(size=n) < propensity).astype(np.float64)
    Y = true_ate * T + X[:, 1] + 0.5 * X[:, 0] + rng.normal(scale=0.5, size=n)
    return {"features": X.astype(np.float32), "treatment": T, "outcome": Y}


def _dml_data(n=600, true_ate=2.0, seed=0):
    return Table(_dml_cols(n, true_ate, seed))


def _panel_cols(effect=1.5, n_units=30, n_times=10, seed=0):
    rng = np.random.default_rng(seed)
    unit_fe = rng.normal(size=n_units)
    time_fe = np.linspace(0, 1, n_times)
    treated = np.arange(n_units) < 6
    post = np.arange(n_times) >= 6
    rows = {"unit": [], "time": [], "outcome": [], "treatment": [],
            "postTreatment": []}
    for u in range(n_units):
        for t in range(n_times):
            y = unit_fe[u] + time_fe[t] + rng.normal(scale=0.05)
            if treated[u] and post[t]:
                y += effect
            rows["unit"].append(u)
            rows["time"].append(t)
            rows["outcome"].append(y)
            rows["treatment"].append(float(treated[u]))
            rows["postTreatment"].append(float(post[t]))
    return {k: np.asarray(v) for k, v in rows.items()}


def _ortho_cols(n=800, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    H = rng.uniform(-1, 1, size=(n, 1)).astype(np.float32)
    T = (rng.uniform(size=n) < 0.5).astype(np.float64)
    effect = np.where(H[:, 0] > 0, 3.0, -1.0)
    Y = effect * T + X[:, 0] + rng.normal(scale=0.3, size=n)
    return {"features": X, "heterogeneityFeatures": H, "treatment": T,
            "outcome": Y}


# --- the JAX package's scenarios on the port --------------------------------

class TestSolvers:
    def test_ols_recovers_coefficients(self):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(500, 2))
        y = 3.0 * X[:, 0] - 1.0 * X[:, 1] + 0.5 + rng.normal(scale=0.1,
                                                               size=500)
        beta, se = linear_regression_with_se(X, y)
        np.testing.assert_allclose(beta, [3.0, -1.0, 0.5], atol=0.05)
        assert (se > 0).all()

    def test_constrained_ls_on_simplex(self):
        rng = np.random.default_rng(1)
        A = rng.normal(size=(50, 5)).astype(np.float32)
        b = A @ np.array([0.6, 0.4, 0, 0, 0])
        w, _ = constrained_least_squares(A, b, max_iter=500, device=CPU)
        assert w.min() >= 0 and abs(w.sum() - 1) < 1e-5
        np.testing.assert_allclose(w[:2], [0.6, 0.4], atol=0.05)


class TestDoubleML:
    def test_recovers_ate(self):
        dml = DoubleMLEstimator(
            treatmentModel=LightGBMRegressor(numIterations=20, device=CPU),
            outcomeModel=LightGBMRegressor(numIterations=20, device=CPU),
            maxIter=6, seed=3)
        model = dml.fit(_dml_data())
        ate = model.get_avg_treatment_effect()
        assert ate == pytest.approx(2.0, abs=0.5)
        lo, hi = model.get_confidence_interval()
        assert lo < ate < hi
        assert 0 <= model.get_pvalue() <= 1

    def test_missing_models_rejected(self):
        with pytest.raises(ValueError, match="treatmentModel"):
            DoubleMLEstimator().fit(_dml_data(50))


class TestDiffInDiff:
    def test_did_interaction(self):
        s = DiffInDiffEstimator().fit(Table(_panel_cols())).getSummary()
        assert s.treatmentEffect == pytest.approx(1.5, abs=0.1)
        assert s.standardError > 0

    def test_synthetic_control(self):
        s = SyntheticControlEstimator(maxIter=300, device=CPU).fit(
            Table(_panel_cols())).getSummary()
        assert s.treatmentEffect == pytest.approx(1.5, abs=0.2)
        assert s.unitWeights is not None and s.unitWeights.min() >= 0

    def test_synthetic_did(self):
        s = SyntheticDiffInDiffEstimator(maxIter=300, device=CPU).fit(
            Table(_panel_cols())).getSummary()
        assert s.treatmentEffect == pytest.approx(1.5, abs=0.2)
        assert s.timeWeights is not None

    def test_no_controls_rejected(self):
        df = Table(_panel_cols())
        df["treatment"] = np.ones(df.num_rows)
        with pytest.raises(ValueError, match="treated and control"):
            SyntheticControlEstimator(device=CPU).fit(df)


class TestOrthoForest:
    def test_heterogeneous_effect_sign(self):
        cols = _ortho_cols()
        df = Table(cols)
        est = OrthoForestDMLEstimator(
            treatmentModel=LightGBMRegressor(numIterations=10, device=CPU),
            outcomeModel=LightGBMRegressor(numIterations=10, device=CPU),
            numTrees=30, device=CPU)
        eff = est.fit(df).transform(df)["EffectAverage"]
        H = cols["heterogeneityFeatures"][:, 0]
        assert eff[H > 0.3].mean() > eff[H < -0.3].mean() + 1.0


class TestResidual:
    def test_residual(self):
        df = Table({"label": np.array([1.0, 0.0]),
                    "prediction": np.array([0.8, 0.3])})
        out = ResidualTransformer().transform(df)
        np.testing.assert_allclose(out["residual"], [0.2, -0.3])

    def test_probability_vector(self):
        df = Table({"label": np.array([1.0]),
                    "prediction": np.array([[0.3, 0.7]])})
        out = ResidualTransformer().transform(df)
        np.testing.assert_allclose(out["residual"], [0.3])


# --- the port against the JAX package on the same inputs ---------------------

def test_the_card_is_the_default_device():
    assert SyntheticDiffInDiffEstimator().getDevice() == "cuda"
    assert OrthoForestDMLEstimator().getDevice() == "cuda"


def test_float64_regressions_are_bitwise_the_jax_packages():
    from synapseml_tpu.causal import did as jdid
    from synapseml_tpu.causal import solvers as jsol
    from synapseml_tpu_torch.causal import did as tdid

    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, 3))
    y = X @ [1.0, -2.0, 0.5] + rng.normal(size=300)
    w = rng.uniform(0.1, 3.0, size=300)
    for kw in ({}, {"weights": w}, {"fit_intercept": False}):
        for a, b in zip(linear_regression_with_se(X, y, **kw),
                        jsol.linear_regression_with_se(X, y, **kw)):
            np.testing.assert_array_equal(a, b)
    Y = rng.normal(size=(12, 9))
    treated = np.arange(12) < 3
    post = np.arange(9) >= 6
    uw, tw = rng.uniform(size=12), rng.uniform(size=9)
    assert (tdid._weighted_did(Y, treated, post, uw, tw)
            == jdid._weighted_did(Y, treated, post, uw, tw))


@pytest.mark.parametrize("kw", [
    dict(max_iter=500),
    dict(max_iter=300, num_iter_no_change=25, fit_intercept=True,
         lambda_=0.3),
    dict(max_iter=200, num_iter_no_change=10, tol=1e-4)])
def test_simplex_solver_matches_the_jax_package(kw):
    from synapseml_tpu.causal import solvers as jsol

    rng = np.random.default_rng(3)
    A = rng.normal(size=(40, 12)).astype(np.float32)
    b = A @ rng.dirichlet(np.ones(12)) + 0.05 * rng.normal(size=40)
    w, c = constrained_least_squares(A, b, device=CPU, **kw)
    jw, jc = jsol.constrained_least_squares(A, b, **kw)
    assert w.dtype == jw.dtype == np.float64
    np.testing.assert_allclose(w, jw, rtol=0, atol=SIMPLEX_TOL)
    assert abs(c - jc) <= SIMPLEX_TOL * max(1.0, abs(jc))


def test_synthetic_estimators_match_the_jax_package():
    from synapseml_tpu.causal import (SyntheticControlEstimator as JSC,
                                      SyntheticDiffInDiffEstimator as JSDID)
    from synapseml_tpu.core.table import Table as JTable

    cols = _panel_cols(seed=4)
    for port, ref in ((SyntheticControlEstimator, JSC),
                      (SyntheticDiffInDiffEstimator, JSDID)):
        got = port(maxIter=300, device=CPU).fit(Table(cols)).getSummary()
        want = ref(maxIter=300).fit(JTable(cols)).getSummary()
        for name in ("unitWeights", "timeWeights"):
            a, b = getattr(got, name), getattr(want, name)
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a, b, rtol=0, atol=SIMPLEX_TOL)
        assert got.zeta == want.zeta
        assert abs(got.treatmentEffect - want.treatmentEffect) <= DID_TOL
        assert abs(got.standardError - want.standardError) <= DID_TOL


def test_doubleml_and_orthoforest_match_the_jax_package():
    from synapseml_tpu.causal import (DoubleMLEstimator as JDML,
                                      OrthoForestDMLEstimator as JOrtho)
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu.models import LightGBMRegressor as JRegressor

    cols = _dml_cols(n=400, seed=5)
    got = DoubleMLEstimator(
        treatmentModel=LightGBMRegressor(numIterations=5, device=CPU),
        outcomeModel=LightGBMRegressor(numIterations=5, device=CPU),
        maxIter=1, seed=1).fit(Table(cols))
    want = JDML(treatmentModel=JRegressor(numIterations=5),
                outcomeModel=JRegressor(numIterations=5),
                maxIter=1, seed=1).fit(JTable(cols))
    np.testing.assert_allclose(got.get("rawTreatmentEffects"),
                               want.get("rawTreatmentEffects"), rtol=0,
                               atol=EFFECT_TOL)
    cols = _ortho_cols(n=400, seed=6)
    got = OrthoForestDMLEstimator(
        treatmentModel=LightGBMRegressor(numIterations=3, device=CPU),
        outcomeModel=LightGBMRegressor(numIterations=3, device=CPU),
        numTrees=6, device=CPU).fit(Table(cols))
    want = JOrtho(treatmentModel=JRegressor(numIterations=3),
                  outcomeModel=JRegressor(numIterations=3),
                  numTrees=6).fit(JTable(cols))
    np.testing.assert_allclose(
        got.transform(Table(cols))["EffectAverage"],
        want.transform(JTable(cols))["EffectAverage"], rtol=0,
        atol=EFFECT_TOL)
