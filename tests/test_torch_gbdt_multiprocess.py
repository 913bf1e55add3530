"""The port's multi-process GBDT contract against the JAX package.

Two CPU ranks join a gloo world through ``parallel.initialize_distributed``
(a ``TCPStore`` on a free localhost port) in ONE ``torch.multiprocessing``
spawn for the module; each passes only its own half of
``tests/test_multiprocess.py``'s 512 x 6 table (NaNs in one column of the
second half only, so the NaN bin is elected across the processes) to
``train_booster(mesh=make_mesh({"data": 2}))``. Meanwhile the parent trains
the JAX package's single-process mesh on the whole table with the mapper
the ranks must have built: ``compute_bin_mapper`` of the sample gathered in
rank order (each rank's ``default_rng(seed).choice`` rows, sorted).

Tolerances. The mapper: byte for byte. Trees: split features, bins and
structure identical; leaf values within 1e-5 and predictions within 1e-5
(the JAX multi-process test's bound; the float32 wire folds the ranks in
rank order, as XLA's CPU all-reduce does). Model strings: equal across the
ranks. An explicit mapper is rank 0's (broadcast), and refused when another
process holds NaNs it has no bin for. Resume: a two-rank fit killed at
iteration 4 resumes in ONE process from rank 0's snapshot (original rows
in global row order) within 1e-5 of an uninterrupted one-process fit
(``tests/test_elastic.py``'s case).
"""

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_waits import join_spawn

ROWS, FEATURES = 512, 6
ATOL = 1e-5
KILL_AT = 4

# (name, config overrides)
CASES = [
    ("leafwise", dict(growth_policy="leafwise")),
    ("depthwise", dict(growth_policy="depthwise")),
    # a sampled mapper: 60 rows drawn by each rank
    ("sampled", dict(bin_sample_count=120)),
    ("gather", dict(row_layout="gather", bin_sample_count=120)),
]
REFUSED = ("fobj", "callbacks", "init_model", "valid", "init_score",
           "group_sizes", "dart", "voting", "feature")


def _table():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(ROWS, FEATURES)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    X[300::5, 2] = np.nan
    return X, y


def _half(rank):
    return slice(0, ROWS // 2) if rank == 0 else slice(ROWS // 2, ROWS)


def _cfg_kwargs(over):
    kw = dict(objective="binary", num_iterations=4, num_leaves=7, max_bin=31,
              min_data_in_leaf=2)
    kw.update(over)
    return kw


def _gathered_sample(X, bin_sample_count, seed=0, nproc=2):
    """The rows each rank draws for the boundaries, in rank order."""
    parts = []
    for r in range(nproc):
        Xl = X[_half(r)]
        per = max(1, min(Xl.shape[0], -(-bin_sample_count // nproc)))
        sub = np.random.default_rng(seed).choice(Xl.shape[0], size=per,
                                                 replace=False)
        parts.append(Xl[np.sort(sub)])
    return np.concatenate(parts)


def _tree_record(booster):
    return [dict(sf=np.asarray(t.split_feature)[:int(t.num_splits)],
                 sb=np.asarray(t.split_bin)[:int(t.num_splits)],
                 lc=np.asarray(t.left_child)[:int(t.num_splits)],
                 rc=np.asarray(t.right_child)[:int(t.num_splits)],
                 lv=np.asarray(t.leaf_value, np.float64))
            for t in booster.trees]


def _refusal(name, X, y, mesh, cfg_cls, train_booster):
    """The message train_booster raises for one refused argument."""
    cfg = cfg_cls(**_cfg_kwargs({}))
    kw = {}
    if name == "fobj":
        kw["fobj"] = lambda s, y_, w_: (s, s)
    elif name == "callbacks":
        kw["callbacks"] = [lambda it, trees: None]
    elif name == "init_model":
        kw["init_model"] = object()
    elif name == "valid":
        kw["valid"] = (X[:8], y[:8])
    elif name == "init_score":
        kw["init_score"] = np.zeros(len(y), np.float32)
    elif name == "group_sizes":
        kw["group_sizes"] = np.asarray([len(y)])
    elif name == "dart":
        cfg.boosting_type = "dart"
    else:
        cfg.tree_learner = name
    try:
        train_booster(X, y, cfg, mesh=mesh, device="cpu", **kw)
    except NotImplementedError as e:
        return str(e)
    return None


def _rank_main(rank, world, workdir, port):
    """One process: its half of the table through every case, the
    refusals and a killed fit that commits snapshots."""
    torch.set_num_threads(1)
    from synapseml_tpu_torch.core import checkpoint as ckpt
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.gbdt import boosting as tboost
    from synapseml_tpu_torch.parallel import (initialize_distributed,
                                              make_mesh, process_count,
                                              process_index,
                                              process_topology)

    initialize_distributed(f"127.0.0.1:{port}", world, rank, timeout_s=240)
    mesh = make_mesh({"data": world}, device="cpu")
    X, y = _table()
    Xl, yl = X[_half(rank)], y[_half(rank)]
    report = {"topology": process_topology(),
              "count": process_count(), "index": process_index()}
    for name, over in CASES:
        cfg = BoosterConfig(**_cfg_kwargs(over))
        mapper = tboost._multiprocess_mapper(Xl, cfg, None, None, mesh)
        b = train_booster(Xl, yl, cfg, mesh=mesh, device="cpu")
        report[name] = dict(model=b.model_string(), trees=_tree_record(b),
                            pred=b.predict(X[:16]),
                            mapper=(mapper.boundaries.tobytes(),
                                    np.asarray(mapper.num_bins).tobytes(),
                                    np.asarray(mapper.nan_mask).tobytes()),
                            routing=b.metadata.get("routing"))
    report["refusals"] = {name: _refusal(name, Xl, yl, mesh, BoosterConfig,
                                         train_booster)
                          for name in REFUSED}
    # an explicit mapper is rank 0's: the whole table's fits; rank 0's own
    # rows hold no NaN in feature 2, so its mapper is refused
    from synapseml_tpu_torch.ops.quantize import compute_bin_mapper

    cfg = BoosterConfig(**_cfg_kwargs({}))
    whole = compute_bin_mapper(X, cfg.max_bin, cfg.bin_sample_count,
                               seed=cfg.seed)
    b = train_booster(Xl, yl, cfg, mesh=mesh, device="cpu",
                      mapper=whole if rank == 0 else compute_bin_mapper(
                          Xl, cfg.max_bin, cfg.bin_sample_count,
                          seed=cfg.seed))
    report["explicit"] = dict(model=b.model_string(), trees=_tree_record(b))
    try:
        train_booster(Xl, yl, cfg, mesh=mesh, device="cpu",
                      mapper=compute_bin_mapper(Xl, cfg.max_bin,
                                                cfg.bin_sample_count,
                                                seed=cfg.seed))
        report["lacks_nan"] = None
    except ValueError as e:
        report["lacks_nan"] = str(e)

    def kill(phase, step):
        if phase == "gbdt.iteration" and step == KILL_AT:
            raise ckpt.PreemptionError("kill")

    ckpt._PREEMPT_HOOK = kill
    try:
        train_booster(Xl, yl, BoosterConfig(**_cfg_kwargs(
            dict(num_iterations=6))), mesh=mesh, device="cpu",
            checkpoint_store=os.path.join(workdir, "shared_ck"),
            checkpoint_every=2)
        report["killed"] = False
    except ckpt.PreemptionError:
        report["killed"] = True
    finally:
        ckpt._PREEMPT_HOOK = None
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(report, f)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_side():
    """Per case: the JAX mapper of the gathered sample and the JAX mesh
    fit of the whole table on it; the JAX refusal messages."""
    import jax

    from synapseml_tpu.gbdt import BoosterConfig, train_booster
    from synapseml_tpu.ops.quantize import compute_bin_mapper
    from synapseml_tpu.parallel import make_mesh as jmesh

    X, y = _table()
    mesh = jmesh({"data": 2}, devices=jax.devices()[:2])
    out = {}
    for name, over in CASES:
        cfg = BoosterConfig(**_cfg_kwargs(over))
        mapper = compute_bin_mapper(
            _gathered_sample(X, cfg.bin_sample_count), cfg.max_bin,
            cfg.bin_sample_count, None, cfg.seed,
            has_nan=np.isnan(X).any(axis=0),
            min_data_in_bin=cfg.min_data_in_bin)
        b = train_booster(X, y, cfg, mesh=mesh, mapper=mapper)
        out[name] = dict(trees=_tree_record(b), pred=b.predict(X[:16]),
                         mapper=(mapper.boundaries.tobytes(),
                                 np.asarray(mapper.num_bins).tobytes(),
                                 np.asarray(mapper.nan_mask).tobytes()))
    cfg = BoosterConfig(**_cfg_kwargs({}))
    out["explicit"] = dict(trees=_tree_record(train_booster(
        X, y, cfg, mesh=mesh, mapper=compute_bin_mapper(
            X, cfg.max_bin, cfg.bin_sample_count, seed=cfg.seed))))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """([each rank's report], the JAX side, the snapshot directory)."""
    workdir = str(tmp_path_factory.mktemp("gbdt_procs"))
    ctx = mp.start_processes(_rank_main, args=(2, workdir, _free_port()),
                             nprocs=2, join=False, start_method="spawn")
    try:
        want = _jax_side()
    finally:
        join_spawn(ctx, what="the 2-rank spawn")
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, want, os.path.join(workdir, "shared_ck")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_topology_is_the_multi_controller_world(spawned):
    ranks, _, _ = spawned
    for r, rep in enumerate(ranks):
        assert rep["count"] == 2 and rep["index"] == r
        assert rep["topology"] == {"process_index": r, "process_count": 2,
                                   "local_devices": 1, "global_devices": 2,
                                   "platform": rep["topology"]["platform"]}
        assert rep["topology"]["platform"] in ("gpu", "cpu")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mapper_is_the_gathered_sample_mappers(spawned, name):
    ranks, want, _ = spawned
    for rep in ranks:
        assert rep[name]["mapper"] == want[name]["mapper"]


@pytest.mark.parametrize("name", [c[0] for c in CASES] + ["explicit"])
def test_trees_are_the_jax_mesh_fits(spawned, name):
    ranks, want, _ = spawned
    assert ranks[0][name]["model"] == ranks[1][name]["model"]
    got, exp = ranks[0][name]["trees"], want[name]["trees"]
    assert len(got) == len(exp)
    for t, (a, b) in enumerate(zip(got, exp)):
        for key in ("sf", "sb", "lc", "rc"):
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"tree {t} {key}")
        np.testing.assert_allclose(a["lv"], b["lv"], rtol=0, atol=ATOL)
    if name != "explicit":
        np.testing.assert_allclose(ranks[0][name]["pred"],
                                   want[name]["pred"], rtol=0, atol=ATOL)


def test_explicit_mapper_without_every_nan_bin_is_refused(spawned):
    ranks, _, _ = spawned
    for rep in ranks:
        assert rep["lacks_nan"].startswith(
            "explicit mapper lacks NaN bins for features with missing "
            "values on some process")


def test_auto_routes_by_the_static_model(spawned):
    ranks, _, _ = spawned
    routing = ranks[0]["leafwise"]["routing"]
    assert routing["router"] == "static"
    assert routing["reason"] == "multi-process: static model (no probes)"
    assert routing["tree_learner"] == "data"


@pytest.mark.parametrize("name", REFUSED)
def test_refusals_are_the_jax_packages(spawned, name):
    ranks, _, _ = spawned
    msg = ranks[0]["refusals"][name]
    assert msg is not None and msg.startswith(
        "multi-process training currently supports the fused path only "
        "(gbdt/goss/rf, serial learner); got ")
    if name in ("dart", "voting", "feature"):
        assert name in msg
    else:
        assert msg.endswith(f"['{name}']")


def test_killed_two_process_fit_resumes_in_one_process(spawned):
    from synapseml_tpu_torch.core.checkpoint import CheckpointStore
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    ranks, _, store = spawned
    assert all(rep["killed"] for rep in ranks)
    assert CheckpointStore(store).steps() == [2, 4]
    X, y = _table()
    cfg = _cfg_kwargs(dict(num_iterations=6))
    ref = train_booster(X, y, BoosterConfig(**cfg), device="cpu")
    resumed = train_booster(X, y, BoosterConfig(**cfg), device="cpu",
                            checkpoint_store=store, checkpoint_every=2)
    assert resumed.metadata["measures"]["count:iterations"] == 2
    np.testing.assert_allclose(ref.predict(X[:32]), resumed.predict(X[:32]),
                               rtol=0, atol=ATOL)


def test_one_process_is_not_multi_controller():
    from synapseml_tpu_torch.parallel import (process_count, process_index,
                                              process_topology)

    assert process_count() == 1 and process_index() == 0
    top = process_topology()
    assert top["process_count"] == 1 and top["local_devices"] == 1
