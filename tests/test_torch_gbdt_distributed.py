"""The port's distributed GBDT against the JAX package's mesh training.

Two ``torch.multiprocessing`` spawns of CPU ranks over gloo (a ``FileStore``
under a temporary directory), one of k = 2 and one of k = 4 ranks on the
mesh ``{"data": k}``, start once for the module and run beside the parent,
which meanwhile trains the JAX package on ``jax.devices()[:k]`` of the
suite's virtual CPU devices (``tests/conftest.py``). Every rank passes the
same whole table (the port's mesh contract), trains every case of
``CASES`` and writes what it got; the ranks never import ``jax`` (this
module imports it only inside parent-side functions, so a rank can import
the module to find its entry point).

Tolerances. Trees: split features, bins and the tree structure identical,
at every growth policy and wire with no floor on the split gain, leaf
values within 1e-5 (``LEAF_ATOL``: the reductions over the ranks fold in
rank order, as XLA's CPU collectives do, so the float32 wire is bitwise the
JAX package's; on the CPU the grower sums and scans over the bins in XLA's
orders, ``grower._bin_sum`` / ``_bin_cumsum``, held bitwise to ``jnp`` by
``test_bin_sums_are_xla_order``, so a lossy wire's pinned totals and the
split gains at float32 noise agree too). The fixture
is the JAX package's decisive one (``tests/test_distributed_gbdt_
collectives.py``): margins far above the int8 grid's noise, at 2001 rows,
so every k pads its rows. Collectives on the same per-rank inputs: the
quantized pair bitwise; ``_maybe_psum`` and ``_hist_reduce_scatter`` within
1e-6 of the largest magnitude (``WIRE_RTOL``), their int8 grid sums exact.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from synapseml_tpu_torch.gbdt import voting as tvoting
from torch_waits import join_spawn

ROWS, FEATURES = 2001, 16
LEAF_ATOL = 1e-5
WIRE_RTOL = 1e-6
ITERS, LEAVES, BINS = 3, 8, 63
HIST_SHAPE = (16, 256, 3)          # (FP, B, 3) per-rank partial histograms

# (name, k, data, config overrides, fit extras)
CASES = [
    (f"{learner}_{wire}_{policy}", 2, "decisive",
     dict(tree_learner=learner, hist_allreduce_dtype=wire,
          growth_policy=policy, **({"top_k": 3} if learner == "voting"
                                   else {})), {})
    for learner, wires, policies in (
        ("data", ("f32", "bf16", "int8"), ("leafwise", "depthwise")),
        ("feature", ("f32", "bf16", "int8"), ("leafwise",)),
        ("voting", ("f32", "int8"), ("leafwise", "depthwise")))
    for wire in wires for policy in policies]
CASES += [
    ("bagging", 2, "decisive", dict(bagging_fraction=0.7, bagging_freq=1,
                                    tree_learner="data"), {}),
    ("goss", 2, "decisive", dict(boosting_type="goss", tree_learner="data"),
     {}),
    ("dart", 2, "decisive", dict(boosting_type="dart", drop_rate=0.5,
                                 skip_drop=0.0, tree_learner="data"), {}),
    ("regression", 2, "regression", dict(objective="regression",
                                         tree_learner="data"), {}),
    ("multiclass", 2, "multiclass", dict(objective="multiclass",
                                         num_class=3, tree_learner="feature"),
     {}),
    ("lambdarank", 2, "lambdarank", dict(objective="lambdarank",
                                         tree_learner="data"), {}),
    ("validation", 2, "decisive", dict(tree_learner="data", num_iterations=12,
                                       learning_rate=0.5,
                                       early_stopping_round=2), {"valid": 1}),
    ("auto", 2, "decisive", dict(tree_learner="auto"), {}),
    ("data_f32_k4", 4, "decisive", dict(tree_learner="data"), {}),
    ("feature_int8_k4", 4, "decisive", dict(tree_learner="feature",
                                            hist_allreduce_dtype="int8"), {}),
    ("voting_bf16_k4", 4, "decisive", dict(tree_learner="voting", top_k=3,
                                           hist_allreduce_dtype="bf16"), {}),
    ("data_depthwise_k4", 4, "decisive",
     dict(tree_learner="data", growth_policy="depthwise"), {}),
    # the leaf-wise row layouts over the mesh
    ("gather_f32", 2, "decisive", dict(tree_learner="data",
                                       row_layout="gather"), {}),
    ("masked_bf16", 2, "decisive", dict(tree_learner="data",
                                        row_layout="masked",
                                        hist_allreduce_dtype="bf16"), {}),
    ("masked_int8_k4", 4, "decisive", dict(tree_learner="data",
                                           row_layout="masked",
                                           hist_allreduce_dtype="int8"), {}),
]
RESUME_AT = 2                      # the resume case stops in iteration 2


def _decisive(n=ROWS, f=FEATURES, seed=0):
    """The JAX package's decisive fixture: signal on thresholds of features
    0-3 far above the int8 grid's noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    margin = (1.5 * (X[:, 0] > 0.3) + 1.2 * (X[:, 1] < -0.2)
              + 1.0 * (X[:, 2] > 0.0) + 0.8 * (X[:, 3] > 0.7)
              + rng.normal(scale=0.25, size=n))
    return X, margin


def _data(kind):
    """(X, y, extras for train_booster) of one data kind."""
    X, margin = _decisive()
    if kind == "decisive":
        return X, (margin > 1.4).astype(np.float32), {}
    if kind == "regression":
        return X, margin.astype(np.float32), {}
    if kind == "multiclass":
        return X, np.digitize(margin, np.quantile(margin, [1 / 3, 2 / 3])
                              ).astype(np.float32), {}
    rel = np.digitize(margin, np.quantile(margin, [0.4, 0.7, 0.9]))
    return X, rel.astype(np.float32), {"group_sizes": np.full(87, 23)}


def _cfg_kwargs(over):
    kw = dict(objective="binary", num_iterations=ITERS, num_leaves=LEAVES,
              max_bin=BINS, seed=7)
    kw.update(over)
    return kw


def _fit_extras(extras, kind):
    X, y, kw = _data(kind)
    if extras.get("valid"):
        Xv, mv = _decisive(n=600, seed=extras["valid"])
        kw = dict(kw, valid=(Xv, (mv > 1.4).astype(np.float32)))
    return X, y, kw


def _rank_inputs(rank, shape, seed):
    rng = np.random.default_rng(seed + rank)
    return (rng.normal(size=shape) * 10.0 ** rng.integers(
        -2, 3, size=shape)).astype(np.float32)


def _rank_hist(rank):
    """One rank's (FP, B, 3) partial histogram: gradients, positive
    hessians, integer counts (zero where the bin is empty)."""
    rng = np.random.default_rng(50 + rank)
    cnt = rng.integers(0, 30, size=HIST_SHAPE[:2]).astype(np.float32)
    g = (rng.normal(size=HIST_SHAPE[:2]) * cnt).astype(np.float32)
    h = (rng.random(HIST_SHAPE[:2]) * cnt * 0.25).astype(np.float32)
    return np.stack([g, h, cnt], -1)


def _tree_record(booster):
    return [dict(sf=np.asarray(t.split_feature)[:int(t.num_splits)],
                 sb=np.asarray(t.split_bin)[:int(t.num_splits)],
                 lc=np.asarray(t.left_child)[:int(t.num_splits)],
                 rc=np.asarray(t.right_child)[:int(t.num_splits)],
                 lv=np.asarray(t.leaf_value, np.float64))
            for t in booster.trees]


def _collectives(rank, world, group):
    """Each collective of the wires on this rank's inputs."""
    from synapseml_tpu_torch.gbdt import grower as tgrower
    from synapseml_tpu_torch.parallel import collectives as C

    x = torch.from_numpy(_rank_inputs(rank, (32, 256), 10))
    rs = torch.from_numpy(_rank_inputs(rank, (world * 2, 256), 20))
    hist = torch.from_numpy(_rank_hist(rank))
    out = {"allreduce_sum_quantized": C.allreduce_sum_quantized(x, group),
           "reduce_scatter_sum_quantized":
               C.reduce_scatter_sum_quantized(rs, group),
           "allreduce_sum": C.allreduce_sum(x, group),
           "reduce_scatter_sum": C.reduce_scatter_sum(rs, group)}
    for wire in ("f32", "bf16", "int8"):
        out[f"psum_{wire}"] = tgrower._maybe_psum(hist, group, wire)
        out[f"scatter_{wire}"] = tgrower._hist_reduce_scatter(hist, group,
                                                             wire)
    return {k: v.numpy() for k, v in out.items()}


def _rank_main(rank, world, workdir):
    """One rank: every case of its k, the collectives, the resume case."""
    torch.set_num_threads(1)
    from synapseml_tpu_torch.core.checkpoint import PreemptionError
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed("gloo", os.path.join(workdir, f"store{world}"), rank,
                     world, timeout_s=240)
    mesh = make_mesh({"data": world}, device="cpu")
    report = {"collectives": _collectives(rank, world,
                                          mesh.group("data"))}
    for name, k, kind, over, extras in CASES:
        if k != world:
            continue
        X, y, kw = _fit_extras(extras, kind)
        b = train_booster(X, y, BoosterConfig(**_cfg_kwargs(over)),
                          mesh=mesh, device="cpu", **kw)
        report[name] = dict(model=b.model_string(), trees=_tree_record(b),
                            best_iteration=b.best_iteration,
                            routing=b.metadata.get("routing"),
                            learner=b.config.tree_learner)
    if world == 2:
        X, y, _ = _data("decisive")
        over = dict(tree_learner="data", num_iterations=4)
        whole = train_booster(X, y, BoosterConfig(**_cfg_kwargs(over)),
                              mesh=mesh, device="cpu").model_string()
        store = os.path.join(workdir, "ckpt")

        def stop(it, trees):
            if it == RESUME_AT:
                raise PreemptionError("stop")

        try:
            train_booster(X, y, BoosterConfig(**_cfg_kwargs(over)),
                          mesh=mesh, device="cpu", callbacks=[stop],
                          checkpoint_store=store, checkpoint_every=1)
            stopped = False
        except PreemptionError:
            stopped = True
        resumed = train_booster(X, y, BoosterConfig(**_cfg_kwargs(over)),
                                mesh=mesh, device="cpu",
                                checkpoint_store=store, checkpoint_every=1)
        report["resume"] = dict(stopped=stopped, whole=whole,
                                resumed=resumed.model_string())
    with open(os.path.join(workdir, f"k{world}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(report, f)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# parent side: the JAX package on its virtual devices
# ---------------------------------------------------------------------------

def _jax_collectives(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from synapseml_tpu.gbdt import grower as jgrower
    from synapseml_tpu.parallel import collectives as JC
    from synapseml_tpu.parallel import make_mesh as jmesh

    mesh = jmesh({"data": world}, devices=jax.devices()[:world])

    def run(fn, stacked):
        f = jax.jit(JC.shard_apply(mesh, fn, in_specs=P("data"),
                                   out_specs=P("data")))
        out = np.asarray(f(jnp.asarray(stacked)))
        return np.split(out, world)

    x = np.concatenate([_rank_inputs(r, (32, 256), 10) for r in range(world)])
    rs = np.concatenate([_rank_inputs(r, (world * 2, 256), 20)
                         for r in range(world)])
    hist = np.concatenate([_rank_hist(r) for r in range(world)])
    out = {"allreduce_sum_quantized":
               run(lambda v: JC.allreduce_sum_quantized(v, "data"), x),
           "reduce_scatter_sum_quantized":
               run(lambda v: JC.reduce_scatter_sum_quantized(v, "data"), rs),
           "allreduce_sum": run(lambda v: JC.allreduce_sum(v, "data"), x),
           "reduce_scatter_sum":
               run(lambda v: JC.reduce_scatter_sum(v, "data"), rs)}
    for wire in ("f32", "bf16", "int8"):
        out[f"psum_{wire}"] = run(
            lambda v, w=wire: jgrower._maybe_psum(v, "data", w), hist)
        out[f"scatter_{wire}"] = run(
            lambda v, w=wire: jgrower._hist_reduce_scatter(v, "data", w),
            hist)
    return out


def _jax_fits(world):
    import jax

    from synapseml_tpu.gbdt import BoosterConfig, train_booster
    from synapseml_tpu.parallel import make_mesh as jmesh

    mesh = jmesh({"data": world}, devices=jax.devices()[:world])
    out = {}
    for name, k, kind, over, extras in CASES:
        if k != world:
            continue
        X, y, kw = _fit_extras(extras, kind)
        b = train_booster(X, y, BoosterConfig(**_cfg_kwargs(over)),
                          mesh=mesh, **kw)
        out[name] = dict(trees=_tree_record(b),
                         best_iteration=b.best_iteration,
                         routing=b.metadata.get("routing"),
                         learner=b.config.tree_learner)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{k: ([each rank's report], JAX fits, JAX collectives)}: the two
    spawns run while the parent trains the JAX package."""
    workdir = str(tmp_path_factory.mktemp("gbdt_ranks"))
    ctxs = {k: mp.start_processes(_rank_main, args=(k, workdir), nprocs=k,
                                  join=False, start_method="spawn")
            for k in (2, 4)}
    want = {}
    try:
        for k in (2, 4):
            want[k] = (_jax_fits(k), _jax_collectives(k))
    finally:
        for k, ctx in ctxs.items():
            join_spawn(ctx, what=f"the {k}-rank spawn")
    out = {}
    for k in (2, 4):
        ranks = []
        for r in range(k):
            with open(os.path.join(workdir, f"k{k}_rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        out[k] = (ranks, *want[k])
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_trees(got, want):
    assert len(got) == len(want)
    for t, (a, b) in enumerate(zip(got, want)):
        for key in ("sf", "sb", "lc", "rc"):
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"tree {t} {key}")
        np.testing.assert_allclose(a["lv"], b["lv"], rtol=0, atol=LEAF_ATOL,
                                   err_msg=f"tree {t} leaf values")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("op", ["allreduce_sum_quantized",
                                "reduce_scatter_sum_quantized",
                                "allreduce_sum", "reduce_scatter_sum"])
def test_collectives_bitwise_jax(spawned, k, op):
    """The quantized pair (exact integer grid sums, shared scales) and the
    float32 sums (folded in rank order) are bitwise the JAX package's on
    the same per-rank inputs."""
    ranks, _, want = spawned[k]
    for r in range(k):
        np.testing.assert_array_equal(ranks[r]["collectives"][op],
                                      want[op][r], err_msg=f"rank {r}")


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("fn", ["psum", "scatter"])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_histogram_wires_match_jax(spawned, k, fn, wire):
    """``_maybe_psum`` / ``_hist_reduce_scatter`` on each wire within
    ``WIRE_RTOL`` of the largest magnitude of each channel; the count
    channel exact; the int8 wire's grid sums exact."""
    ranks, _, want = spawned[k]
    key = f"{fn}_{wire}"
    for r in range(k):
        got, ref = ranks[r]["collectives"][key], want[key][r]
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
        for c in (0, 1):
            scale = np.abs(ref[..., c]).max()
            assert np.abs(got[..., c] - ref[..., c]).max() \
                <= WIRE_RTOL * scale, (r, c)
    # the dequantized grid sums before pinning are exact: every rank holds
    # them bitwise (allreduce_sum_quantized is bitwise above), and the
    # pinned histograms agree across ranks bitwise
    if fn == "psum":
        for r in range(1, k):
            np.testing.assert_array_equal(ranks[r]["collectives"][key],
                                          ranks[0]["collectives"][key])


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c[0] for c in CASES if c[0] != "auto"])
def test_mesh_trees_match_jax(spawned, name):
    """Each learner, wire, policy, sampling mode and objective on a mesh
    grows the JAX package's mesh trees; the rows (2001) pad on every k."""
    k = next(c[1] for c in CASES if c[0] == name)
    assert ROWS % k
    ranks, fits, _ = spawned[k]
    _assert_same_trees(ranks[0][name]["trees"], fits[name]["trees"])
    assert ranks[0][name]["learner"] == fits[name]["learner"]


@pytest.mark.parametrize("k", [2, 4])
def test_every_rank_returns_the_same_model_string(spawned, k):
    ranks, _, _ = spawned[k]
    names = [c[0] for c in CASES if c[1] == k]
    for name in names:
        for r in range(1, k):
            assert ranks[r][name]["model"] == ranks[0][name]["model"], \
                (name, r)


def test_validation_stops_at_jax_best_iteration(spawned):
    ranks, fits, _ = spawned[2]
    got, want = ranks[0]["validation"], fits["validation"]
    assert got["best_iteration"] == want["best_iteration"]
    assert len(got["trees"]) == want["best_iteration"] + 1 < 12


def test_resume_on_a_mesh_is_bitwise(spawned):
    ranks, _, _ = spawned[2]
    for r in range(2):
        rep = ranks[r]["resume"]
        assert rep["stopped"]
        assert rep["resumed"] == rep["whole"]
        assert rep["resumed"] == ranks[0]["resume"]["resumed"]


def test_auto_routing_metadata_has_jax_keys(spawned):
    """``auto`` resolves through the measured router on every rank alike
    and records JAX's keys; an explicit learner records no routing."""
    ranks, fits, _ = spawned[2]
    got, want = ranks[0]["auto"]["routing"], fits["auto"]["routing"]
    assert set(got) == set(want)
    assert set(got["inputs"]) == set(want["inputs"])
    assert set(got["cost_model"]) == set(want["cost_model"])
    assert set(got["perfmodel"]) == set(want["perfmodel"])
    assert got["router"] == want["router"] == "measured"
    assert got["tree_learner"] in ("data", "voting", "feature")
    assert ranks[1]["auto"]["routing"] == got
    assert ranks[0]["auto"]["learner"] == got["tree_learner"]
    assert ranks[0]["data_f32_leafwise"]["routing"] is None
    assert fits["data_f32_leafwise"]["routing"] is None


# ---------------------------------------------------------------------------
# the cost model (no spawn)
# ---------------------------------------------------------------------------

GRID = [(f, b, k, L) for f in (8, 28, 40, 128) for b in (63, 255)
        for k in (4, 14, 20) for L in (8, 31)]


@pytest.mark.parametrize("shape", [(16, 256, 2), (16, 256, 3),
                                   (8, 16, 256, 2), (4, 16, 512, 3),
                                   (2, 8, 2048, 3), (8, 4096, 3)])
def test_bin_sums_are_xla_order(shape):
    """The grower's CPU sums over the bins (lossy-wire totals, leaf totals)
    and its prefix scans (split gains) against ``jnp.sum`` /
    ``jnp.cumsum`` on the same float32 arrays, bitwise, at the wires'
    and the grower's shapes."""
    import jax
    import jax.numpy as jnp

    from synapseml_tpu_torch.gbdt import grower as tgrower

    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * np.exp(2 * rng.normal(size=shape))
         ).astype(np.float32)
    t = torch.from_numpy(x)
    want_sum = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-2))(x))
    want_cum = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-2))(x))
    np.testing.assert_array_equal(tgrower._bin_sum(t).numpy(), want_sum)
    np.testing.assert_array_equal(tgrower._bin_cumsum(t).numpy(), want_cum)
    # and the pinning the lossy wires run, on totals a wire would bring
    tot = (want_sum[..., :2] * (1 + 1e-3 * rng.normal(
        size=want_sum[..., :2].shape))).astype(np.float32)
    from synapseml_tpu.gbdt import grower as jgrower

    np.testing.assert_array_equal(
        tgrower._pin_totals(t[..., :2], torch.from_numpy(tot)).numpy(),
        np.asarray(jax.jit(jgrower._pin_totals)(x[..., :2], tot)))


def test_cost_model_matches_jax(monkeypatch):
    """Every cost-model function equals the JAX package's over a grid of
    inputs (its engine anchor pinned to the constant both carry: the JAX
    package reads a recorded TPU measurement, the port reads none)."""
    from synapseml_tpu.gbdt import voting as jvoting

    monkeypatch.setattr(jvoting, "default_engine_row_iters_per_s",
                        lambda: jvoting.DEFAULT_ENGINE_ROW_ITERS_PER_S)
    assert tvoting.DEFAULT_ENGINE_ROW_ITERS_PER_S \
        == jvoting.DEFAULT_ENGINE_ROW_ITERS_PER_S
    assert tvoting.WIRE_DTYPE_BYTES == jvoting.WIRE_DTYPE_BYTES
    for f, b, k, L in GRID:
        for db in (4, 8 / 3, 2):
            assert tvoting.collective_bytes_per_split(f, b, k, db) \
                == jvoting.collective_bytes_per_split(f, b, k, db)
            assert tvoting.voting_cost_model(f, b, k, L, 2e-3, db) \
                == jvoting.voting_cost_model(f, b, k, L, 2e-3, db)
        assert tvoting.selection_bytes_per_tree(f) \
            == jvoting.selection_bytes_per_tree(f)
        for hosts in (1, 4):
            for link in (None, 1e8, 1e11):
                kw = dict(n_hosts=hosts, rows_per_host=100_000,
                          link_bytes_per_s=link)
                assert tvoting.recommend_tree_learner(f, b, k, L, **kw) \
                    == jvoting.recommend_tree_learner(f, b, k, L, **kw)
        for wire in ("f32", "bf16", "int8"):
            for sel in (None, 1e-3, 0.05):
                kw = dict(n_workers=4, rows_per_worker=50_000,
                          link_bytes_per_s=2e9, selection_s_per_tree=sel,
                          selection_fraction_of_rows=0.5, wire_dtype=wire,
                          feature_parallel_ok=f % 4 == 0)
                assert tvoting.route_parallelism(f, b, k, L, **kw) \
                    == jvoting.route_parallelism(f, b, k, L, **kw)
