"""``chip_smoke.py`` phase 25 — featurization, TrainClassifier and AutoML's
halving search — on the CPU: its Adult-shaped table at its real shape
checked for Adult's cardinalities, and the whole phase rehearsed at about
2,000 rows (the CPU process and the two gang workers beside it). On the
CPU the card-against-CPU checks compare the CPU port with itself, so the
rehearsal passes whole."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)  # noqa: E402

# the CPU port's split search is slow at Adult's 108 features (about a
# second a 5-iteration fit of 31 leaves), and the rehearsal fits some 40
# models: 3 iterations for (a), 2 for the search's fits
SMALL = dict(ADULT_ROWS=2000, ADULT_TRAIN=1334, ADULT_ITERS=3,
             HELDOUT_ROWS=2000, TUNE_ITERS=2, TUNE_LEAVES=(3, 7, 15),
             AUTOML_CPU_THREADS=1, TUNE_THREADS=2)


def test_phase_25_helpers_import_without_a_card():
    for name in ("automl_path", "adult_part", "higgs_train_part",
                 "tune_part", "gang_part", "start_automl_cpu",
                 "_automl_cpu", "gang_fit_task", "adult_check",
                 "tune_check"):
        assert callable(getattr(cs, name)), name
    assert set(cs._AUTOML_SETTINGS) <= set(vars(cs))


def test_adult_table_has_adults_shape():
    cols = cs.adult_like(cs.ADULT_ROWS)
    assert len(cols["income"]) == 48_842 and cs.ADULT_TRAIN == 32_561
    assert set(cols) == set(cs.ADULT_NUMERIC) | set(cs.ADULT_STRINGS) \
        | {"income"}
    for name, k in cs.ADULT_STRINGS.items():
        levels = set(cols[name])
        assert len(levels) == k, name
        assert ("?" in levels) == (name in cs.ADULT_MISSING), name
    assert all(np.issubdtype(cols[c].dtype, np.integer)
               for c in cs.ADULT_NUMERIC)
    share = np.mean(cols["income"] == ">50K")
    assert abs(share - cs.ADULT_POSITIVE) < 1e-3
    again = cs.adult_like(cs.ADULT_ROWS)
    assert all(np.array_equal(cols[c], again[c]) for c in cols)


def test_tune_plan_and_folds_are_the_searchs():
    from synapseml_tpu_torch.automl import TuneHyperparameters

    cands = cs.tune_candidates()
    assert len(cands) == cs.TUNE_CANDIDATES
    assert all(c["numLeaves"] in cs.TUNE_LEAVES
               and cs.TUNE_LR[0] <= c["learningRate"] <= cs.TUNE_LR[1]
               for c in cands)
    assert len({TuneHyperparameters._candidate_key(c) for c in cands}) \
        == len(cands)
    folds = cs.tune_folds(100)
    assert sorted(np.concatenate(folds).tolist()) == list(range(100))


def test_phase_25_rehearses_on_the_cpu(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(cs, k, v)
    out = cs.automl_path("cpu", rows=3000)
    assert set(out) == {"a", "b", "c", "d"}
    assert out["a"]["auc"] > 0.75
    assert out["b"]["auc"] > 0.75
    # 8 candidates, 3 folds, eta 2: rungs (1, 8), (2, 4), (3, 2)
    assert out["c"]["fold_fits"] == 8 + 4 + 2
    assert set(out["c"]["rung_s"]) == {0, 1, 2}
    assert out["d"]["respawn_s"] is not None
