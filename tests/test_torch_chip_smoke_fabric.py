"""``chip_smoke.py`` phase 22 — the serving fabric, VW and the online loop
— on the CPU: its helpers import without a card, the Criteo-shaped table
is seeded and prefix-stable, and the whole phase rehearses at small sizes
(two ranks serving a 5-iteration classifier, a ResNet-18 at 32x32 as the
DL tenant, a 20,000-row table). Phase 22 launches none of the port's
kernels, so the rehearsal passes whole. A file of its own, so that its
spawns run beside ``tests/test_torch_chip_smoke.py``'s long phases.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)  # noqa: E402

SMALL = dict(
    FABRIC_ALONE_ROWS=8000, FABRIC_ITERS=3, FABRIC_REQUESTS=200,
    FABRIC_KILL_REQUESTS=400, SERVE_CLIENTS=8, FED_REQUESTS=200,
    FLEET_REQUESTS=10, FLEET_FLOOD=60,
    FLEET_RESNET=dict(depth=18, num_classes=10, image_size=32),
    CRITEO_ROWS=20000, CRITEO_CHUNK=10000, CRITEO_MESH_ROWS=20000,
    CRITEO_MAX_CARD=500, ONLINE_EVENTS=1024)


def test_phase_22_helpers_import_without_a_card():
    for name in ("fabric_online_path", "fabric_path", "federation_path",
                 "fleet_path", "online_path", "criteo_path", "criteo_table",
                 "criteo_mask", "start_criteo_cpu", "start_fabric_ranks",
                 "_fabric_rank", "_criteo_cpu", "stop_fleet",
                 "vw_step_launches"):
        assert callable(getattr(cs, name)), name
    assert set(cs._FABRIC_SETTINGS) <= set(vars(cs))
    assert set(cs._CRITEO_SETTINGS) <= set(vars(cs))


def test_criteo_table_is_seeded_and_prefix_stable(monkeypatch):
    monkeypatch.setattr(cs, "CRITEO_CHUNK", 1000)
    monkeypatch.setattr(cs, "CRITEO_MAX_CARD", 300)
    vocab = cs._criteo_vocab_hashes()
    h, val, y = cs.criteo_table(2500, vocab=vocab)
    assert h.shape == val.shape == (2500, cs.CRITEO_INTS + cs.CRITEO_CATS)
    assert h.dtype == np.uint32 and val.dtype == np.float32
    h2, val2, y2 = cs.criteo_table(1700, vocab=vocab)
    np.testing.assert_array_equal(h2, h[:1700])
    np.testing.assert_array_equal(val2, val[:1700])
    np.testing.assert_array_equal(y2, y[:1700])
    assert set(np.unique(y)) == {-1.0, 1.0} and 0.1 < (y > 0).mean() < 0.6
    # every integer column is one feature, every categorical value a
    # feature of its column's hashed vocabulary
    assert (h[:, :cs.CRITEO_INTS] == h[0, :cs.CRITEO_INTS]).all()
    for j in range(cs.CRITEO_CATS):
        assert np.isin(h[:, cs.CRITEO_INTS + j], vocab[j]).all()
    idx = cs.criteo_mask(h2, 18)
    assert idx.dtype == np.int32 and idx.max() < (1 << 18)
    np.testing.assert_array_equal(idx, (h2 & ((1 << 18) - 1)).astype(
        np.int32))


def test_fabric_phase_rehearses_on_the_cpu(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(cs, name, value)
    out = cs.fabric_online_path("cpu", card="cpu rehearsal")
    assert out["fabric"]["steady"]["n"] == SMALL["FABRIC_REQUESTS"]
    assert out["fabric"]["evict_s"] > 0 and out["fabric"]["rejoin_s"] >= 0
    assert out["federation"]["statuses"] == {200: SMALL["FED_REQUESTS"]}
    assert out["online"]["updates_per_s"] > 0
    for bits in cs.CRITEO_BITS:
        assert out["vw"][bits]["gap"] == 0.0        # the CPU against itself
        assert 0.5 < out["vw"][bits]["auc"] <= 1.0
    assert abs(out["vw"]["mesh"]["auc"] - out["vw"]["mesh"]["one_auc"]) \
        <= cs.CRITEO_MESH_AUC_GAP
