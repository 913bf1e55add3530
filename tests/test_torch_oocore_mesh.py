"""The port's streamed GBDT over a mesh of ranks against the JAX package's
mesh-streamed training (``tests/test_oocore.py``'s ``TestMeshStreamed``).

ONE ``torch.multiprocessing`` spawn of k = 4 CPU ranks over gloo (a
``FileStore`` under a temporary directory) for the module; every rank gets
the same chunk source (the port's single-controller contract), bins and
streams only its block of every chunk, and writes what it got. Meanwhile
the parent runs the JAX package's ``train_booster_streamed(mesh=make_mesh(
{"data": 4}))`` on four of the suite's virtual CPU devices. The ranks
never import ``jax``.

Tolerances. The mapper: byte for byte the JAX sketch's. Trees against the
JAX package's on every wire and both growth policies: split features,
bins and structure identical, leaf values within 1e-5 (each rank sums its
chunks' partials in chunk order and the wire folds the ranks in rank order,
as the JAX programs and XLA's CPU all-reduce do). Streamed against
``resident=True`` on the same ranks, and a killed fit against the
uninterrupted one: bitwise. Model strings: equal across the ranks.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_waits import join_spawn

K = 4
LEAF_ATOL = 1e-5

# (name, config overrides) fitted by both packages on the mesh
CASES = [(f"{wire}_{policy}", dict(hist_allreduce_dtype=wire,
                                   growth_policy=policy, num_iterations=3))
         for wire in ("f32", "bf16", "int8")
         for policy in ("leafwise", "depthwise")]
CASES += [("bagging_valid", dict(num_iterations=6, bagging_fraction=0.6,
                                 bagging_freq=1, early_stopping_round=3)),
          # GOSS ranks every row's gradient: the ranks gather theirs
          ("goss", dict(boosting_type="goss", num_iterations=3,
                        top_rate=0.3, other_rate=0.2, learning_rate=0.5)),
          ("feature_fraction", dict(feature_fraction=0.6, num_iterations=3))]
CHUNK = 128


def _data():
    """``tests/conftest.py``'s ``binary_data``."""
    from sklearn.datasets import load_breast_cancer
    from sklearn.model_selection import train_test_split

    X, y = load_breast_cancer(return_X_y=True)
    return train_test_split(X.astype(np.float32), y.astype(np.float32),
                            test_size=0.3, random_state=42)


def _cfg_kwargs(over):
    kw = dict(objective="binary", num_iterations=5, num_leaves=8)
    kw.update(over)
    return kw


def _auc(y, s):
    from sklearn.metrics import roc_auc_score

    return float(roc_auc_score(y, s))


def _tree_record(booster):
    return [{a: np.asarray(getattr(t, a)) for a in t._fields}
            for t in booster.trees]


def _mapper_bytes(m):
    return (np.asarray(m.boundaries).tobytes(),
            np.asarray(m.num_bins).tobytes(),
            np.asarray(m.nan_mask).tobytes())


def _rank_main(rank, world, workdir):
    """One rank: every case, streamed against resident, the auto config,
    a killed and resumed fit, the chunk rounding."""
    torch.set_num_threads(1)
    from synapseml_tpu_torch.core import checkpoint as ckpt
    from synapseml_tpu_torch.gbdt import (BoosterConfig, StreamedDataset,
                                          train_booster_streamed)
    from synapseml_tpu_torch.gbdt.stream import STREAM_PHASE
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed("gloo", os.path.join(workdir, "store"), rank, world,
                     timeout_s=240)
    mesh = make_mesh({"data": world}, device="cpu")
    Xtr, Xte, ytr, yte = _data()

    def fit(over, ds=None, **kw):
        ds = ds or StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=CHUNK)
        return ds, train_booster_streamed(
            ds, BoosterConfig(**_cfg_kwargs(over)), mesh=mesh, device="cpu",
            **kw)

    report = {}
    for name, over in CASES:
        kw = ({"valid_data": (Xte, yte)} if name == "bagging_valid" else {})
        ds, b = fit(over, **kw)
        report[name] = dict(model=b.model_string(), trees=_tree_record(b),
                            raw=b.raw_score(Xte), auc=_auc(yte,
                                                           b.predict(Xte)),
                            streamed=b.metadata["streamed"],
                            best=(b.best_iteration, b.best_score),
                            mapper=_mapper_bytes(ds.mapper),
                            block=(ds.row_block, ds.block_real,
                                   ds.chunk_real))
    _, res = fit(dict(num_iterations=3), resident=True)
    report["resident"] = dict(trees=_tree_record(res),
                              raw=res.raw_score(Xte))

    cfg_auto = BoosterConfig(**_cfg_kwargs(dict(
        num_iterations=1, tree_learner="auto",
        hist_allreduce_dtype="auto")))
    ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=CHUNK)
    b = train_booster_streamed(ds, cfg_auto, mesh=mesh, device="cpu")
    report["auto"] = dict(wire=cfg_auto.hist_allreduce_dtype,
                          learner=cfg_auto.tree_learner,
                          routing=b.metadata.get("routing"),
                          autoconfig=b.metadata.get("autoconfig"))

    # kill inside tree 3's root pass, resume from the tree-2 snapshot
    ds, ref = fit(dict(num_iterations=5))
    nchunks = len(ds.chunks)
    kill = sum(nchunks * (1 + int(t.num_splits)) for t in ref.trees[:3]) + 1
    store = os.path.join(workdir, "ck")

    def hook(ph, st):
        if ph == STREAM_PHASE and st == kill:
            raise ckpt.PreemptionError("kill")

    ckpt._PREEMPT_HOOK = hook
    try:
        fit(dict(num_iterations=5), ds, checkpoint_store=store,
            checkpoint_every=1)
        killed = False
    except ckpt.PreemptionError:
        killed = True
    finally:
        ckpt._PREEMPT_HOOK = None
    torch.distributed.barrier()
    _, resumed = fit(dict(num_iterations=5), ds, checkpoint_store=store,
                     checkpoint_every=1)
    report["resume"] = dict(killed=killed, ref=_tree_record(ref),
                            resumed=_tree_record(resumed),
                            ref_raw=ref.raw_score(Xte),
                            resumed_raw=resumed.raw_score(Xte))

    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=50)
    train_booster_streamed(ds, BoosterConfig(**_cfg_kwargs(dict(
        num_iterations=1))), mesh=mesh, device="cpu")
    report["rounding"] = (ds.chunk_rows, ds.block_rows)
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(report, f)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

def _jax_fits():
    import jax

    from synapseml_tpu.gbdt import BoosterConfig, StreamedDataset
    from synapseml_tpu.gbdt import train_booster_streamed
    from synapseml_tpu.parallel import make_mesh as jmesh

    mesh = jmesh({"data": K}, devices=jax.devices()[:K])
    Xtr, Xte, ytr, yte = _data()
    out = {}
    for name, over in CASES:
        kw = ({"valid_data": (Xte, yte)} if name == "bagging_valid" else {})
        ds = StreamedDataset.from_arrays(Xtr, ytr, chunk_rows=CHUNK)
        b = train_booster_streamed(ds, BoosterConfig(**_cfg_kwargs(over)),
                                   mesh=mesh, **kw)
        out[name] = dict(trees=_tree_record(b), mapper=_mapper_bytes(
            ds.mapper), best=(b.best_iteration, b.best_score))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """([each rank's report], the JAX fits)."""
    workdir = str(tmp_path_factory.mktemp("oocore_ranks"))
    ctx = mp.start_processes(_rank_main, args=(K, workdir), nprocs=K,
                             join=False, start_method="spawn")
    try:
        want = _jax_fits()
    finally:
        join_spawn(ctx, what=f"the {K}-rank spawn")
    ranks = []
    for r in range(K):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, want


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_equal_trees(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_trees_are_the_jax_mesh_streamed_trees(spawned, name):
    ranks, want = spawned
    assert len({rep[name]["model"] for rep in ranks}) == 1
    got, exp = ranks[0][name]["trees"], want[name]["trees"]
    assert len(got) == len(exp)
    for t, (a, b) in enumerate(zip(got, exp)):
        ns = int(a["num_splits"])
        assert ns == int(b["num_splits"])
        for key in ("split_feature", "split_bin", "default_left",
                    "left_child", "right_child"):
            np.testing.assert_array_equal(a[key][:ns], b[key][:ns],
                                          err_msg=f"tree {t} {key}")
        np.testing.assert_allclose(a["leaf_value"], b["leaf_value"], rtol=0,
                                   atol=LEAF_ATOL, err_msg=f"tree {t}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mapper_is_the_jax_sketchs(spawned, name):
    ranks, want = spawned
    for rep in ranks:
        assert rep[name]["mapper"] == want[name]["mapper"]


def test_streamed_equals_resident_bitwise(spawned):
    ranks, _ = spawned
    for rep in ranks:
        _assert_equal_trees(rep["f32_leafwise"]["trees"],
                            rep["resident"]["trees"])
        np.testing.assert_array_equal(rep["f32_leafwise"]["raw"],
                                      rep["resident"]["raw"])
        md = rep["f32_leafwise"]["streamed"]
        assert md["workers"] == K and md["block_rows"] == CHUNK // K
        assert rep["f32_leafwise"]["auc"] > 0.95


def test_each_rank_caches_its_block(spawned):
    ranks, _ = spawned
    real = ranks[0]["f32_leafwise"]["block"][2]
    assert sum(real) == 398 and len(real) == 4
    for r, rep in enumerate(ranks):
        (lo, hi), block_real, chunk_real = rep["f32_leafwise"]["block"]
        assert (lo, hi) == (r * CHUNK // K, (r + 1) * CHUNK // K)
        assert chunk_real == real
        assert block_real == [min(max(c - lo, 0), hi - lo) for c in real]
        assert rep["f32_leafwise"]["streamed"]["cache_bytes"] \
            == len(real) * 32 * (CHUNK // K)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_lossy_wire_auc(spawned, wire):
    ranks, _ = spawned
    assert ranks[0][f"{wire}_leafwise"]["auc"] > 0.95


def test_auto_config_routes_to_the_data_plane(spawned):
    ranks, _ = spawned
    auto = ranks[0]["auto"]
    assert auto["wire"] in ("f32", "bf16", "int8")
    assert auto["learner"] == "data"
    assert auto["routing"] == {"tree_learner": "data",
                               "router": "streamed_data_plane",
                               "workers": K}
    assert "wire_dtype" in auto["autoconfig"]


def test_kill_resume_bit_for_bit(spawned):
    ranks, _ = spawned
    for rep in ranks:
        res = rep["resume"]
        assert res["killed"]
        _assert_equal_trees(res["ref"], res["resumed"])
        np.testing.assert_array_equal(res["ref_raw"], res["resumed_raw"])


def test_bagging_with_a_held_out_stream(spawned):
    ranks, want = spawned
    rep = ranks[0]["bagging_valid"]
    assert rep["best"][1] is not None and rep["auc"] > 0.9
    assert rep["best"][0] == want["bagging_valid"]["best"][0]
    assert abs(rep["best"][1] - want["bagging_valid"]["best"][1]) <= 1e-6


def test_chunk_rows_rounded_to_worker_multiple(spawned):
    ranks, _ = spawned
    for rep in ranks:
        assert rep["rounding"] == (52, 13)          # 50 -> 52 at 4 ranks
