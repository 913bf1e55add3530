"""The port's explainers (``synapseml_tpu_torch/explainers``, with
``image/``) against the JAX package's, on the CPU:

* every scenario of ``tests/test_explainers.py`` on the port;
* the same seeded inputs through both packages: the solvers within
  ``SOLVE_TOL`` of the largest coefficient (float32 elimination against
  XLA's LU, and FISTA's sums in another order), every explainer's output
  within ``EXPLAIN_TOL`` of the largest magnitude (the host draws are the
  same calls of ``np.random.default_rng(0)``, so both packages score the
  same samples through the same stand-in model and differ only in the
  float32 solve), SLIC labels and the image stages equal;
* KernelSHAP on the port's ``LightGBMClassifier`` against the JAX
  package's on the JAX classifier (the same trees on the CPU), local
  accuracy Σφ = f(x) − base within ``ADDITIVITY_TOL``;
* an explainer saved by the JAX package, with its ``explained_model``,
  loads in the port and explains the same.
"""

import numpy as np
import pytest

from synapseml_tpu_torch.core.pipeline import PipelineStage, Transformer
from synapseml_tpu_torch.core.table import Table
from synapseml_tpu_torch.explainers import (ICETransformer, ImageLIME,
                                            ImageSHAP, LocalExplainer,
                                            TabularLIME, TabularSHAP,
                                            TextLIME, TextSHAP, VectorLIME,
                                            VectorSHAP)
from synapseml_tpu_torch.explainers.solvers import (batched_lasso,
                                                    batched_lstsq,
                                                    solver_stats)
from synapseml_tpu_torch.image import (ImageSetAugmenter, UnrollImage,
                                       slic_segments)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
SOLVE_TOL = 1e-5
EXPLAIN_TOL = 1e-4
ADDITIVITY_TOL = 1e-4


def _linear_model(base):
    class LinearModel(base):
        """Deterministic stand-in model: probability = sigmoid(w·x)."""

        def __init__(self, w, featuresCol="features", **kw):
            super().__init__(**kw)
            self.w = np.asarray(w, np.float32)
            self.featuresCol = featuresCol

        def _transform(self, df):
            X = np.asarray(df[self.featuresCol], np.float32)
            z = X @ self.w
            p = 1 / (1 + np.exp(-z))
            return df.with_column("probability", np.stack([1 - p, p], 1))
    return LinearModel


LinearModel = _linear_model(Transformer)


def _col_model(base):
    class ColModel(base):
        def _transform(self, df):
            z = 3.0 * np.asarray(df["a"], np.float32) - 1.0 * np.asarray(
                df["b"], np.float32)
            p = 1 / (1 + np.exp(-z))
            return df.with_column("probability", np.stack([1 - p, p], 1))
    return ColModel


def _text_model(base):
    class TextModel(base):
        def _transform(self, df):
            p = np.array([1.0 if "good" in t else 0.0 for t in df["text"]],
                         np.float32)
            return df.with_column("probability", np.stack([1 - p, p], 1))
    return TextModel


def _bright_model(base):
    class BrightModel(base):
        def _transform(self, df):
            # scores mean brightness of the top-left quadrant
            p = np.array([np.asarray(im)[:8, :8].mean() / 255.0
                          for im in df["image"]], np.float32)
            return df.with_column("probability", np.stack([1 - p, p], 1))
    return BrightModel


# --- the JAX package's scenarios on the port --------------------------------

def test_batched_lstsq_recovers_coefficients():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 200, 4)).astype(np.float32)
    true = rng.normal(size=(3, 4, 1)).astype(np.float32)
    y = np.einsum("rsd,rdk->rsk", X, true) + 2.0
    w = np.ones((3, 200), np.float32)
    fit = batched_lstsq(X, y, w, device=CPU)
    np.testing.assert_allclose(fit.coefs, true, atol=1e-3)
    np.testing.assert_allclose(fit.intercept, 2.0, atol=1e-3)
    assert (fit.r2 > 0.99).all()


def test_batched_lasso_sparsifies():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1, 300, 6)).astype(np.float32)
    true = np.array([[3.0], [0.0], [0.0], [-2.0], [0.0], [0.0]], np.float32)
    y = X[0] @ true + 0.01 * rng.normal(size=(300, 1)).astype(np.float32)
    fit = batched_lasso(X, y[None], np.ones((1, 300), np.float32), 0.5,
                        device=CPU)
    c = fit.coefs[0, :, 0]
    assert abs(c[0]) > 1.0 and abs(c[3]) > 0.5
    assert np.abs(c[[1, 2, 4, 5]]).max() < 0.2


def test_vector_lime_ranks_features():
    w = np.array([2.0, 0.0, -1.0, 0.0], np.float32)
    rng = np.random.default_rng(2)
    df = Table({"features": rng.normal(size=(5, 4)).astype(np.float32)})
    out = VectorLIME(model=LinearModel(w), targetCol="probability",
                     targetClasses=[1], numSamples=400,
                     device=CPU).transform(df)
    for i in range(5):
        ex = out["explanation"][i][0]          # class-1 weights, (4,)
        assert abs(ex[0]) > abs(ex[1])
        assert abs(ex[2]) > abs(ex[3])
        assert ex[0] > 0 and ex[2] < 0
    assert (out["r2"] > 0.5).all()


def test_vector_shap_additivity_and_ranking():
    w = np.array([1.5, 0.0, -1.0], np.float32)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(4, 3)).astype(np.float32)
    out = VectorSHAP(model=LinearModel(w), targetCol="probability",
                     targetClasses=[1], numSamples=600,
                     device=CPU).transform(Table({"features": X}))
    p = 1 / (1 + np.exp(-(X @ w)))
    for i in range(4):
        vals = out["explanation"][i][0]        # (M+1,): [base, shap...]
        np.testing.assert_allclose(vals.sum(), p[i], atol=0.05)
        assert abs(vals[2]) < max(abs(vals[1]), abs(vals[3])) + 1e-3


def _abc(n=6, seed=4):
    rng = np.random.default_rng(seed)
    return {c: rng.normal(size=n).astype(np.float32) for c in "abc"}


def test_tabular_lime_and_shap_named_columns():
    df = Table(_abc())
    model = _col_model(Transformer)()
    lime = TabularLIME(model=model, inputCols=["a", "b", "c"],
                       targetClasses=[1], numSamples=400,
                       device=CPU).transform(df)
    ex = lime["explanation"][0][0]
    assert abs(ex[0]) > abs(ex[2]) and abs(ex[1]) > abs(ex[2])
    shap = TabularSHAP(model=model, inputCols=["a", "b", "c"],
                       targetClasses=[1], numSamples=400,
                       device=CPU).transform(df)
    sv = shap["explanation"][0][0]
    assert abs(sv[1]) > abs(sv[3]) and abs(sv[2]) > abs(sv[3])


TEXTS = ["this is a good movie", "bad film overall"]


def test_text_lime_finds_signal_token():
    df = Table({"text": np.array(TEXTS, object)})
    out = TextLIME(model=_text_model(Transformer)(), targetClasses=[1],
                   numSamples=200, device=CPU).transform(df)
    toks = out["tokens"][0]
    weights = out["explanation"][0][0]
    assert weights[toks.index("good")] == weights.max()


def _bright_image():
    img = np.zeros((16, 16, 3), np.float32)
    img[:8, :8] = 255.0                       # bright top-left quadrant
    return img


def test_image_lime_and_superpixels():
    df = Table({"image": np.array([_bright_image()], object)})
    out = ImageLIME(model=_bright_model(Transformer)(), targetClasses=[1],
                    cellSize=8.0, numSamples=64, device=CPU).transform(df)
    segs = out["superpixels"][0]
    weights = out["explanation"][0][0]
    assert segs.shape == (16, 16)
    assert weights[segs[2, 2]] == weights.max()


def _ice_model(base):
    class ColModel(base):
        def _transform(self, df):
            z = 2.0 * np.asarray(df["x1"], np.float32) - np.asarray(
                df["x2"], np.float32)
            return df.with_column("prediction", z)
    return ColModel


def _ice_data():
    rng = np.random.default_rng(5)
    return {"x1": rng.normal(size=8).astype(np.float32),
            "x2": rng.normal(size=8).astype(np.float32)}


def test_ice_individual_and_pdp():
    df = Table(_ice_data())
    model = _ice_model(Transformer)()
    ice = ICETransformer(model=model, targetCol="prediction",
                         numericFeatures=[{"name": "x1", "numSplits": 4}],
                         device=CPU).transform(df)
    curves = ice["explanation_x1"]
    assert curves[0].shape == (5, 1)
    assert (np.diff(curves[0][:, 0]) > 0).all()
    pdp = ICETransformer(model=model, targetCol="prediction", kind="average",
                         numericFeatures=[{"name": "x1", "numSplits": 4}],
                         categoricalFeatures=[], device=CPU).transform(df)
    assert pdp.num_rows == 1
    assert pdp["featureNames"][0] == "x1"


def test_explainer_requires_model():
    df = Table({"features": np.zeros((2, 3), np.float32)})
    with pytest.raises((ValueError, TypeError)):
        VectorLIME(numSamples=10, device=CPU).transform(df)


def test_slic_segments_cover_image():
    img = np.random.default_rng(6).uniform(0, 255, size=(32, 32, 3)).astype(
        np.float32)
    segs = slic_segments(img, cell_size=8)
    assert segs.shape == (32, 32)
    k = segs.max() + 1
    assert 4 <= k <= 32
    assert set(np.unique(segs)) == set(range(k))


def _two_images():
    imgs = np.empty(2, object)
    imgs[0] = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    imgs[1] = np.ones((2, 2, 3), np.float32)
    return imgs


def test_unroll_and_augment():
    imgs = _two_images()
    df = Table({"image": imgs})
    un = UnrollImage(inputCol="image").transform(df)
    assert un["features"].shape == (2, 12)
    aug = ImageSetAugmenter(inputCol="image", outputCol="image").transform(df)
    assert aug.num_rows == 4
    np.testing.assert_allclose(aug["image"][2], np.flip(imgs[0], axis=1))


def test_augmenter_preserves_extra_columns():
    df = Table({"image": _two_images(), "label": np.array([0, 1])})
    aug = ImageSetAugmenter(inputCol="image", outputCol="image").transform(df)
    assert aug.num_rows == 4
    np.testing.assert_array_equal(aug["label"], [0, 1, 0, 1])


def test_slic_tiny_image_single_segment():
    segs = slic_segments(np.zeros((3, 3, 3), np.float32), 16)
    assert segs.shape == (3, 3)
    assert segs.max() == 0


# --- the port against the JAX package on the same inputs ---------------------

def test_the_card_is_the_default_device():
    assert TabularSHAP().getDevice() == "cuda"
    assert LocalExplainer.KernelSHAP.tabular is TabularSHAP
    assert LocalExplainer.LIME.image is ImageLIME


def _solver_inputs(seed=0, r=5, s=300, d=6, k=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(r, s, d)).astype(np.float32)
    y = (np.einsum("rsd,rdk->rsk", X, rng.normal(size=(r, d, k)))
         + 0.3 * rng.normal(size=(r, s, k))).astype(np.float32)
    w = rng.uniform(0.1, 2.0, size=(r, s)).astype(np.float32)
    return X, y, w


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


@pytest.mark.parametrize("kind", ["lstsq", "lasso"])
def test_solvers_match_the_jax_package(kind):
    from synapseml_tpu.explainers import solvers as J

    for seed, r in ((0, 5), (1, 130)):          # one bucket; two chunks
        X, y, w = _solver_inputs(seed, r)
        if kind == "lstsq":
            want = J.batched_lstsq(X, y, w)
            got = batched_lstsq(X, y, w, device=CPU)
        else:
            lam = np.linspace(0.01, 0.2, r).astype(np.float32)
            want = J.batched_lasso(X, y, w, lam)
            got = batched_lasso(X, y, w, lam, device=CPU)
        for name in ("coefs", "intercept", "r2"):
            _close(getattr(got, name), getattr(want, name), SOLVE_TOL,
                   f"{kind} {name}")
    stats = solver_stats()
    key = f"{kind}:{1e-06 if kind == 'lstsq' else 200}@cpu"
    assert stats[key]["total_compiles"] >= 1


def _same_explanations(got: Table, want, cols, tol=EXPLAIN_TOL):
    for c in cols:
        g, w = got[c], want[c]
        if g.dtype == object:
            for i in range(len(w)):
                if isinstance(w[i], list):
                    assert g[i] == w[i], c
                    continue
                _close(g[i], w[i], tol, f"{c}[{i}]")
        else:
            _close(g, w, tol, c)


def _both(port_cls, jax_cls, port_model, jax_model, port_df, jax_df, **kw):
    got = port_cls(model=port_model, device=CPU, **kw).transform(port_df)
    want = jax_cls(model=jax_model, **kw).transform(jax_df)
    return got, want


def test_vector_and_tabular_explainers_match_the_jax_package():
    from synapseml_tpu.core.pipeline import Transformer as JTransformer
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu.explainers import (TabularLIME as JTabularLIME,
                                          TabularSHAP as JTabularSHAP,
                                          VectorLIME as JVectorLIME,
                                          VectorSHAP as JVectorSHAP)

    w = np.array([1.5, 0.0, -1.0, 0.5], np.float32)
    X = np.random.default_rng(7).normal(size=(6, 4)).astype(np.float32)
    for pc, jc, kw in (
            (VectorLIME, JVectorLIME, dict(numSamples=300)),
            (VectorLIME, JVectorLIME, dict(numSamples=300,
                                           regularization=0.01)),
            (VectorSHAP, JVectorSHAP, dict(numSamples=300))):
        got, want = _both(pc, jc, LinearModel(w),
                          _linear_model(JTransformer)(w),
                          Table({"features": X}), JTable({"features": X}),
                          targetClasses=[1], **kw)
        _same_explanations(got, want, ("explanation", "r2"))
    cols = _abc(8, seed=8)
    for pc, jc in ((TabularLIME, JTabularLIME), (TabularSHAP, JTabularSHAP)):
        got, want = _both(pc, jc, _col_model(Transformer)(),
                          _col_model(JTransformer)(), Table(cols),
                          JTable(cols), inputCols=["a", "b", "c"],
                          targetClasses=[0, 1], numSamples=250)
        _same_explanations(got, want, ("explanation", "r2"))


def test_text_image_and_ice_match_the_jax_package():
    from synapseml_tpu.core.pipeline import Transformer as JTransformer
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu.explainers import (ICETransformer as JICE,
                                          ImageLIME as JImageLIME,
                                          ImageSHAP as JImageSHAP,
                                          TextLIME as JTextLIME,
                                          TextSHAP as JTextSHAP)

    texts = {"text": np.array(TEXTS, object)}
    for pc, jc in ((TextLIME, JTextLIME), (TextSHAP, JTextSHAP)):
        got, want = _both(pc, jc, _text_model(Transformer)(),
                          _text_model(JTransformer)(), Table(texts),
                          JTable(texts), targetClasses=[1], numSamples=120)
        _same_explanations(got, want, ("tokens", "explanation", "r2"))
    img = _bright_image()
    img[8:, 8:] = np.random.default_rng(9).uniform(0, 255, (8, 8, 3))
    images = {"image": np.array([img, img[::-1].copy()], object)}
    for pc, jc in ((ImageLIME, JImageLIME), (ImageSHAP, JImageSHAP)):
        got, want = _both(pc, jc, _bright_model(Transformer)(),
                          _bright_model(JTransformer)(), Table(images),
                          JTable(images), targetClasses=[1], cellSize=8.0,
                          numSamples=64)
        for i in range(2):
            np.testing.assert_array_equal(got["superpixels"][i],
                                          want["superpixels"][i])
        _same_explanations(got, want, ("explanation", "r2"))
    data = _ice_data()
    spec = dict(targetCol="prediction",
                numericFeatures=[{"name": "x1", "numSplits": 4}],
                categoricalFeatures=["x2"])
    for kind in ("individual", "average"):
        got, want = _both(ICETransformer, JICE, _ice_model(Transformer)(),
                          _ice_model(JTransformer)(), Table(data),
                          JTable(data), kind=kind, **spec)
        assert got.columns == want.columns
        for c in got.columns:
            if got[c].dtype == object and kind == "average" and c == \
                    "featureNames":
                assert list(got[c]) == list(want[c])
            else:
                _same_explanations(got, want, (c,), tol=0.0)


def test_slic_and_the_image_stages_are_the_jax_packages():
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu.image import (ImageSetAugmenter as JAug,
                                     SuperpixelTransformer as JSuper,
                                     UnrollImage as JUnroll,
                                     slic_segments as jslic)
    from synapseml_tpu_torch.image import SuperpixelTransformer

    rng = np.random.default_rng(10)
    for shape, cell, mod in (((32, 32, 3), 8, 10.0), ((40, 28, 3), 12, 130.0),
                             ((20, 20), 6, 30.0)):
        img = rng.uniform(0, 255, size=shape).astype(np.float32)
        np.testing.assert_array_equal(slic_segments(img, cell, mod),
                                      jslic(img, cell, mod))
    imgs = np.empty(3, object)
    for i in range(3):
        imgs[i] = rng.uniform(0, 255, size=(12, 10, 3)).astype(np.float32)
    got = SuperpixelTransformer(inputCol="image", cellSize=4.0).transform(
        Table({"image": imgs}))
    want = JSuper(inputCol="image", cellSize=4.0).transform(
        JTable({"image": imgs}))
    for i in range(3):
        np.testing.assert_array_equal(got["superpixels"][i],
                                      want["superpixels"][i])
    np.testing.assert_array_equal(
        UnrollImage(inputCol="image").transform(
            Table({"image": imgs}))["features"],
        JUnroll(inputCol="image").transform(
            JTable({"image": imgs}))["features"])
    a = ImageSetAugmenter(inputCol="image", outputCol="out",
                          flipUpDown=True).transform(Table({"image": imgs}))
    b = JAug(inputCol="image", outputCol="out", flipUpDown=True).transform(
        JTable({"image": imgs}))
    assert a.columns == b.columns and a.num_rows == b.num_rows == 9
    for i in range(9):
        np.testing.assert_array_equal(a["out"][i], b["out"][i])


def _gbdt_table(n=300, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (X[:, 0] * 1.5 - X[:, 2] + 0.5 * X[:, 3] * X[:, 1]
         + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def test_shap_on_the_ports_classifier_matches_the_jax_package():
    """TabularSHAP and TabularLIME on the port's LightGBMClassifier against
    the JAX package's on its classifier: the same trees on the CPU, so the
    same scores up to float32 sums of the leaves, and φ within
    EXPLAIN_TOL; Σφ = f(x) − base within ADDITIVITY_TOL."""
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu.explainers import (TabularLIME as JTabularLIME,
                                          TabularSHAP as JTabularSHAP)
    from synapseml_tpu.models import LightGBMClassifier as JClassifier
    from synapseml_tpu_torch.models import LightGBMClassifier

    X, y = _gbdt_table()
    names = [f"f{i}" for i in range(X.shape[1])]
    cols = {c: X[:, i] for i, c in enumerate(names)}
    cols["label"] = y
    port = LightGBMClassifier(numIterations=8, numLeaves=7, device=CPU,
                              featuresCol="features").fit(
        Table(cols).with_column("features", X))
    jax_model = JClassifier(numIterations=8, numLeaves=7,
                            featuresCol="features").fit(
        JTable(cols).with_column("features", X))

    class Assemble:
        """Scores named columns through a features-column model."""

        def __init__(self, model, table_cls):
            self.model, self.table_cls = model, table_cls

        def transform(self, df):
            feats = np.stack([np.asarray(df[c], np.float32) for c in names],
                             1)
            return self.model.transform(self.table_cls(
                {"features": feats}))

    rows = {c: X[:6, i] for i, c in enumerate(names)}
    kw = dict(inputCols=names, targetClasses=[1], numSamples=200,
              backgroundData=None)
    got = TabularSHAP(model=Assemble(port, Table), device=CPU, **{
        **kw, "backgroundData": Table(cols)}).transform(Table(rows))
    want = JTabularSHAP(model=Assemble(jax_model, JTable), **{
        **kw, "backgroundData": JTable(cols)}).transform(JTable(rows))
    _same_explanations(got, want, ("explanation", "r2"))
    fx = port.transform(Table({"features": X[:6]}))["probability"][:, 1]
    for i in range(6):
        vals = got["explanation"][i][0]
        assert abs(vals.sum() - fx[i]) <= ADDITIVITY_TOL
    got = TabularLIME(model=Assemble(port, Table), device=CPU, **{
        **kw, "backgroundData": Table(cols)}).transform(Table(rows))
    want = JTabularLIME(model=Assemble(jax_model, JTable), **{
        **kw, "backgroundData": JTable(cols)}).transform(JTable(rows))
    _same_explanations(got, want, ("explanation", "r2"))


def test_an_explainer_the_jax_package_saved_loads(tmp_path):
    """A JAX-saved VectorSHAP with its explained LightGBM model loads in
    the port (its classes and the model's through ``_stage_class``) and
    explains what the JAX explainer explains."""
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu.explainers import VectorSHAP as JVectorSHAP
    from synapseml_tpu.models import LightGBMRegressor as JRegressor
    from synapseml_tpu_torch.models import LightGBMRegressionModel

    X, y = _gbdt_table(seed=12)
    model = JRegressor(numIterations=5, numLeaves=5,
                       featuresCol="features").fit(
        JTable({"features": X, "label": y}))
    jexp = JVectorSHAP(model=model, targetCol="prediction", numSamples=40,
                       backgroundData=JTable({"features": X}))
    p = str(tmp_path / "jax_shap")
    jexp.save(p)
    loaded = PipelineStage.load(p, device=CPU)
    assert isinstance(loaded, VectorSHAP)
    assert loaded.getDevice() == CPU and loaded.getNumSamples() == 40
    assert isinstance(loaded.get("model"), LightGBMRegressionModel)
    assert loaded.get("model").getDevice() == CPU
    loaded.set("backgroundData", Table({"features": X}))
    got = loaded.transform(Table({"features": X[:4]}))
    want = jexp.transform(JTable({"features": X[:4]}))
    _same_explanations(got, want, ("explanation", "r2"))
