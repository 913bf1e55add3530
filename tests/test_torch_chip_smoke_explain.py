"""``chip_smoke.py`` phase 24 — explainers, causal inference, the image
ops and leaf histograms — on the CPU: its seeded tables and panels at a
tiny size, and the whole phase rehearsed at small sizes (a [1, 1, 1, 1]
width-8 ResNet registered as the backbone, the CPU process beside it).
On the CPU the card-against-CPU checks compare the CPU port with itself,
so the rehearsal passes whole."""

import functools
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)  # noqa: E402

SMALL = dict(
    EXPLAIN_ROWS=6, IMAGE_LIME_IMAGES=2, IMAGE_LIME_SAMPLES=8,
    IMAGE_LIME_CELL=4, DML_ROWS=3000, DML_PREFIX=1500, DML_ITERS=5,
    # 5-iteration nuisance fits on 1,500 rows a fold recover the planted
    # effect only within a few tenths (the card's run: 20 iterations on
    # 250,000 rows a fold, within DML_ATE_TOL)
    DML_ATE_TOL=0.3,
    PANELS=(("small", 12, 10, 1, 6), ("wide", 40, 20, 4, 15)),
    IMAGE_OPS_N=2, HIST_ROWS=4000, EXPLAIN_CPU_THREADS=1,
    VISION_BACKBONE="resnet_w8", VISION_SIDE=8, VISION_SIZE=8)


def test_phase_24_helpers_import_without_a_card():
    for name in ("explain_path", "tabular_part", "image_part", "dml_part",
                 "panel_part", "image_ops_part", "hist_part",
                 "start_explain_cpu", "_explain_cpu", "_hist_rank"):
        assert callable(getattr(cs, name)), name
    assert set(cs._EXPLAIN_SETTINGS) <= set(vars(cs))


def test_tables_are_seeded_and_shaped():
    rows = cs.explain_rows(5)
    X, _ = cs.higgs_like(50)
    np.testing.assert_array_equal(np.stack([rows[c] for c in
                                            cs.FEATURE_NAMES], 1), X[:5])
    d, d2 = cs.dml_table(1000), cs.dml_table(1000)
    for k in d:
        np.testing.assert_array_equal(d[k], d2[k])
    assert d["features"].shape == (1000, cs.FEATURES)
    assert set(np.unique(d["treatment"])) == {0.0, 1.0}
    p = cs.panel_table(39, 31, 1, 19)
    assert len(p["outcome"]) == 39 * 31
    assert p["treatment"].sum() == 31 and p["postTreatment"].sum() == 39 * 12
    binned, node, g, h = cs.hist_inputs(1000)
    assert binned.dtype == np.uint8 and binned.shape == (1000, cs.FEATURES)
    assert node.min() == -1 and node.max() == cs.HIST_LEAVES - 1


def test_phase_24_rehearses_on_the_cpu(monkeypatch):
    from synapseml_tpu_torch.dl import backbones as tb

    monkeypatch.setitem(tb.BACKBONES, "resnet_w8", functools.partial(
        tb.ResNet, [1, 1, 1, 1], tb.ResNetBlock, width=8))
    for k, v in SMALL.items():
        monkeypatch.setattr(cs, k, v)
    out = cs.explain_path("cpu", rows=3000)
    assert set(out) == {"a", "b", "c", "d", "e"}
    assert out["a"]["shap"]["steady_captures"] == 0
    assert out["a"]["additivity_gap"] <= cs.ADDITIVITY_TOL
    assert out["b"]["coefs"].shape[0] == SMALL["IMAGE_LIME_IMAGES"]
    assert abs(out["c"]["ate"] - cs.DML_ATE) < 1.0
    assert set(out["d"]) == {"small", "wide"}
    assert out["e"]["hist"]["rel"] <= cs.HIST_REL
