"""The port's pipeline-parallel DL against the JAX package's.

ONE ``torch.multiprocessing`` start of 4 gloo CPU ranks for the file (as in
``test_torch_trainer.py``); while they run, the parent fits the JAX
package's ``fit_pipeline`` on its virtual CPU devices from the same
initial weights (flax's ``init``, carried by
``convert.staged_from_reference``). The scenarios of
``tests/test_dl_sharded.py`` ``TestPipeline``, ``TestStaging`` and
``test_pipeline_seq_parity`` on the port's ranks:

* a 2-stage ``tiny`` backbone on ``{"stage": 2, "data": 2}`` under
  ``fill_drain`` (replicated stages) and ``overlap`` (ZeRO stages), 2
  microbatches: every step's loss within 1e-5 of the port's replicated
  trainer on ``{"data": 4}`` and of the JAX package's pipeline on the same
  mesh shape;
* circular placement, 3 stages on 2 groups, against the replicated
  trainer;
* the staged text encoder on the same mesh against the JAX pipeline
  (plain SGD: see ``TEXT_FIT``);
* the text encoder on ``{"stage": 2, "seq": 2}`` (ring attention inside
  each stage group) under both schedules against the replicated trainer;
* a kill at epoch 2 and a resume under both schedules, bitwise equal to
  the uninterrupted fit; the ``"skip"`` and ``"rollback"`` non-finite
  policies on a poisoned batch, and validation during the fit;
* ``stage_submeshes`` and the refusals.

In this process: the staged forward against the JAX ``StageSequential``
(1e-6), the weight carry both ways, and ``suggest_stage_cuts`` /
``suggest_pipeline_schedule`` against the JAX package's.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from synapseml_tpu_torch import dl as tdl
from synapseml_tpu_torch.convert import (staged_from_reference,
                                         staged_to_reference)
from synapseml_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)
from torch_waits import join_spawn

WORLD = 4
LOSS_TOL = 1e-5
FORWARD_TOL = 1e-6
TINY = dict(batch_size=16, max_epochs=4, learning_rate=1e-2, seed=7)
TEXT = dict(vocab_size=256, num_classes=2, num_stages=2, num_layers=2,
            hidden=32, heads=4, max_len=32)
# plain SGD for the text fits held to the JAX package: Adam's first update
# is about lr * sign(g), so a gradient near zero whose sign differs in
# float32 noise moves its parameter by 2 lr in one package against the
# other (tests/test_torch_trainer.py holds Adam to 1e-4 for that reason)
TEXT_FIT = dict(batch_size=16, max_epochs=2, learning_rate=0.05,
                optimizer="sgd", seed=7)
PIPE = dict(param_sharding="pipeline", pipeline_microbatches=2)
OVERLAP = dict(PIPE, pipeline_param_sharding="zero",
               pipeline_schedule="overlap")


def _images(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=n)
    return X, y


def _tokens(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, TEXT["vocab_size"],
                     size=(n, TEXT["max_len"])).astype(np.int32)
    y = rng.integers(0, 2, size=n)
    return X, y


# --- the JAX side ----------------------------------------------------------

def _jax_models():
    from synapseml_tpu import dl as jdl

    return {"tiny2": jdl.make_staged_backbone("tiny", 4, 2),
            "tiny3": jdl.make_staged_backbone("tiny", 4, 3),
            "text": jdl.staged_text_encoder(**TEXT)}


def _jax_init(model, x):
    import jax

    return jax.jit(lambda r, v: model.init(r, v, train=False))(
        jax.random.PRNGKey(0), x)


def _jax_pipeline_losses(model, variables, cfg, X, y):
    """Step losses of the JAX package's ``fit_pipeline`` on
    ``{"stage": 2, "data": 2}`` of its virtual devices (recorded by a
    patched ``NonFiniteGuard``)."""
    import jax

    from synapseml_tpu import dl as jdl
    from synapseml_tpu import parallel as jparallel
    from synapseml_tpu.dl import pipeline as jpipeline

    losses = []

    class _Recorder(jpipeline.NonFiniteGuard):
        def check(self, loss, step):
            losses.append(float(loss))
            return super().check(loss, step)

    mesh = jparallel.make_mesh({"stage": 2, "data": 2},
                               devices=jax.devices()[:4])
    with mock.patch.object(jpipeline, "NonFiniteGuard", _Recorder):
        tr = jdl.FlaxTrainer(model, jdl.TrainConfig(**cfg), mesh=mesh)
        tr.load_params(variables["params"], variables.get("batch_stats"))
        tr.fit(X, y)
    return np.asarray(losses)


def _jax_reference(path):
    """Initial weights (as port state_dicts) and the JAX pipelines' step
    losses, in one npz."""
    models = _jax_models()
    X, y = _images()
    T, ty = _tokens()
    out = {}
    inits = {}
    for name, model in models.items():
        x = T[:2] if name == "text" else X[:2]
        inits[name] = _jax_init(model, x)
        for k, v in staged_from_reference(inits[name]).items():
            out[f"init/{name}/{k}"] = v.numpy()
    out["jax/fd"] = _jax_pipeline_losses(models["tiny2"], inits["tiny2"],
                                         dict(TINY, **PIPE), X, y)
    out["jax/ov"] = _jax_pipeline_losses(models["tiny2"], inits["tiny2"],
                                         dict(TINY, **OVERLAP), X, y)
    out["jax/text"] = _jax_pipeline_losses(models["text"], inits["text"],
                                           dict(TEXT_FIT, **PIPE), T, ty)
    np.savez(path, **out)


# --- the ranks ---------------------------------------------------------------

def _init(data, name):
    pre = f"init/{name}/"
    return {k[len(pre):]: torch.from_numpy(data[k]) for k in data.files
            if k.startswith(pre)}


def _model(data, name):
    if name == "text":
        model = tdl.staged_text_encoder(**TEXT)
    else:
        model = tdl.make_staged_backbone("tiny", 4, int(name[-1]))
    model.load_state_dict(_init(data, name))
    return model


def _fit(data, name, mesh, cfg, X, y, **kw):
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    tr = Trainer(_model(data, name), TrainConfig(**cfg, **kw), mesh=mesh,
                 device="cpu")
    return tr.fit(X, y)


def _losses(tr):
    return np.asarray([s["loss"] for s in tr.step_stats])


def _kill_at_epoch_2():
    from synapseml_tpu_torch.core import checkpoint as tck

    def hook(phase, step):
        if phase == "dl.epoch" and step == 2:
            raise tck.PreemptionError("killed at dl.epoch 2")
    return mock.patch.object(tck, "_PREEMPT_HOOK", hook)


def _kill_resume(data, mesh, cfg, X, y, ckdir):
    """(the resumed fit's logits, epochs it ran)."""
    from synapseml_tpu_torch.core.checkpoint import PreemptionError

    try:
        with _kill_at_epoch_2():
            _fit(data, "tiny2", mesh, cfg, X, y, checkpoint_dir=ckdir)
        raise AssertionError("the kill did not stop the fit")
    except PreemptionError:
        pass
    tr = _fit(data, "tiny2", mesh, cfg, X, y, checkpoint_dir=ckdir)
    return tr.predict_logits(X), [h["epoch"] for h in tr.history]


def _policy_fit(data, mesh, X, y, policy, at, ckdir):
    """A fit whose batch at step ``at`` has a NaN row, under
    ``nonfinite_policy``: its step losses, epochs and counters."""
    from synapseml_tpu_torch.core.logging import (failure_counts,
                                                  reset_failure_counts)
    from synapseml_tpu_torch.dl import trainer as tt

    def hook(step, xb, yb):
        if step == at and not hook.fired:
            hook.fired = True
            xb = np.array(xb, np.float32)
            xb[0] = np.nan
        return xb, yb
    hook.fired = False
    reset_failure_counts()
    with mock.patch.object(tt, "_CHAOS_BATCH_HOOK", hook):
        tr = _fit(data, "tiny2", mesh, dict(TINY, **PIPE), X, y,
                  nonfinite_policy=policy, checkpoint_dir=ckdir)
    fc = failure_counts()
    return {f"{policy}/losses": _losses(tr),
            f"{policy}/epochs": np.asarray([h["epoch"] for h in tr.history]),
            f"{policy}/counts": np.asarray([
                fc.get("train.nonfinite_loss", 0),
                fc.get(f"train.nonfinite_{'skipped' if policy == 'skip' else policy}", 0)])}


def _rank_main(rank, workdir):
    """One rank: every scenario; imports nothing of JAX."""
    from synapseml_tpu_torch.parallel import (init_distributed, make_mesh,
                                              stage_submeshes)

    torch.set_num_threads(1)
    init_distributed("gloo", os.path.join(workdir, "store"), rank, WORLD,
                     timeout_s=120)
    data = np.load(os.path.join(workdir, "inputs.npz"))
    X, y = _images()
    T, ty = _tokens()
    rep = make_mesh({"data": 4}, device="cpu")
    pipe = make_mesh({"stage": 2, "data": 2}, device="cpu")
    seq = make_mesh({"stage": 2, "seq": 2}, device="cpu")
    out = {}
    for key, name, mesh, cfg in (("rep", "tiny2", rep, {}),
                                 ("fd", "tiny2", pipe, PIPE),
                                 ("ov", "tiny2", pipe, OVERLAP)):
        tr = _fit(data, name, mesh, dict(TINY, **cfg), X, y)
        out[f"{key}/losses"] = _losses(tr)
        out[f"{key}/logits"] = tr.predict_logits(X)
        out[f"{key}/stats"] = np.asarray(repr(sorted(
            (k, v) for k, v in tr.stats.items() if k != "autoconfig")))
        if key != "rep":
            st = tr.step_stats[-1]
            out[f"{key}/hops"] = np.asarray([st["hops"], st["hop_bytes"]])
    circ = dict(TINY, max_epochs=2, pipeline_param_sharding="zero", **PIPE)
    out["rep3/losses"] = _losses(_fit(data, "tiny3", rep,
                                      dict(TINY, max_epochs=2), X, y))
    tr = _fit(data, "tiny3", pipe, circ, X, y)
    out["circ/losses"] = _losses(tr)
    out["circ/groups"] = np.asarray([tr.stats["stages"],
                                     tr.stats["groups"]])
    tr = _fit(data, "text", pipe, dict(TEXT_FIT, **PIPE), T, ty)
    out["text/losses"] = _losses(tr)
    out["text/acc"] = np.asarray(tr.evaluate(T, ty))
    out["textrep/losses"] = _losses(_fit(data, "text", rep, TEXT_FIT, T, ty))
    for sched in ("fill_drain", "overlap"):
        tr = _fit(data, "text", seq, dict(TEXT_FIT, **PIPE), T, ty,
                  pipeline_schedule=sched, seq_attention="ring")
        out[f"seq_{sched}/losses"] = _losses(tr)
        out[f"seq_{sched}/variant"] = np.asarray(tr.stats["seq_attention"])
    for key, cfg in (("fd", PIPE), ("ov", OVERLAP)):
        logits, epochs = _kill_resume(data, pipe, dict(TINY, **cfg), X, y,
                                      os.path.join(workdir, f"ck_{key}"))
        out[f"{key}/resumed_logits"] = logits
        out[f"{key}/resumed_epochs"] = np.asarray(epochs)
    for policy, at in (("skip", 1), ("rollback", 5)):
        out.update(_policy_fit(data, pipe, X, y, policy, at,
                               os.path.join(workdir, f"ck_{policy}")))
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    tr = Trainer(_model(data, "tiny2"), TrainConfig(
        **dict(TINY, max_epochs=1, **PIPE)), mesh=pipe, device="cpu")
    tr.fit(X, y, valid=(X[:16], y[:16]))
    out["valid/acc"] = np.asarray([tr.history[-1]["val_acc"],
                                   tr.evaluate(X[:16], y[:16])])
    groups, assign = stage_submeshes(pipe, 3)
    out["submesh/assign"] = np.asarray(assign)
    out["submesh/ranks"] = np.asarray([g.ranks for g in groups])
    out["submesh/shapes"] = np.asarray(repr([g.shape for g in groups]))
    out["submesh/mine"] = np.asarray([g.rank is not None for g in groups])
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(the JAX side's npz, [each rank's npz])."""
    workdir = tmp_path_factory.mktemp("pipeline_ranks")
    _jax_reference(workdir / "inputs.npz")
    join_spawn(mp.start_processes(_rank_main, args=(str(workdir),),
                                  nprocs=WORLD, join=False,
                                  start_method="spawn"),
               what=f"the {WORLD}-rank spawn")
    want = np.load(workdir / "inputs.npz")
    return want, [np.load(workdir / f"rank{r}.npz") for r in range(WORLD)]


# --- TestPipeline ------------------------------------------------------------

@pytest.mark.parametrize("key", ["fd", "ov"])
def test_parity_with_replicated(spawned, key):
    _, ranks = spawned
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/losses"], r["rep/losses"],
                                   atol=LOSS_TOL)


@pytest.mark.parametrize("key", ["fd", "ov"])
def test_losses_match_the_jax_pipeline(spawned, key):
    want, ranks = spawned
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/losses"], want[f"jax/{key}"],
                                   atol=LOSS_TOL)


def test_stats_name_stages_groups_and_schedule(spawned):
    _, ranks = spawned
    for r in ranks:
        fd, ov = str(r["fd/stats"]), str(r["ov/stats"])
        assert "('groups', 2)" in fd and "('stages', 2)" in fd
        assert "('microbatches', 2)" in fd
        assert "('schedule', 'fill_drain')" in fd
        assert "('schedule', 'overlap')" in ov
        # each rank takes part in 2 hops a microbatch (an activation and
        # its cotangent), each its 4 of the microbatch's 8 rows of stage
        # 0's (2, 2, 32) float32 output
        assert r["fd/hops"][0] == 4 and r["fd/hops"][1] == 4 * 4 * 2 * 2 \
            * 32 * 4


def test_zero_stages_hold_less_state(spawned):
    _, ranks = spawned
    for r in ranks:
        fd = dict(eval(str(r["fd/stats"])))
        ov = dict(eval(str(r["ov/stats"])))
        assert ov["state_bytes_per_rank"] < fd["state_bytes_per_rank"]


def test_circular_placement_more_stages_than_groups(spawned):
    _, ranks = spawned
    for r in ranks:
        assert list(r["circ/groups"]) == [3, 2]
        np.testing.assert_allclose(r["circ/losses"], r["rep3/losses"],
                                   atol=LOSS_TOL)


def test_text_pipeline_matches_jax_and_replicated(spawned):
    want, ranks = spawned
    for r in ranks:
        assert np.isfinite(r["text/losses"]).all()
        assert 0.0 <= float(r["text/acc"]) <= 1.0
        np.testing.assert_allclose(r["text/losses"], want["jax/text"],
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["text/losses"], r["textrep/losses"],
                                   atol=LOSS_TOL)


@pytest.mark.parametrize("schedule", ["fill_drain", "overlap"])
def test_pipeline_seq_parity(spawned, schedule):
    """Ring attention over each stage group's ``seq`` axis: the replicated
    trainer's trajectory."""
    _, ranks = spawned
    for r in ranks:
        assert str(r[f"seq_{schedule}/variant"]) == "ring"
        np.testing.assert_allclose(r[f"seq_{schedule}/losses"],
                                   r["textrep/losses"], atol=LOSS_TOL)


@pytest.mark.parametrize("key", ["fd", "ov"])
def test_kill_resume_bit_equal(spawned, key):
    """A kill at epoch 2 and a resume from the sharded per-stage
    checkpoint give the uninterrupted fit's logits bit for bit (overlap:
    the prefetched gather of the killed fit is not reused)."""
    _, ranks = spawned
    for r in ranks:
        assert list(r[f"{key}/resumed_epochs"]) == [2, 3]
        np.testing.assert_array_equal(r[f"{key}/resumed_logits"],
                                      r[f"{key}/logits"])


def test_nonfinite_skip_drops_the_step(spawned):
    """A NaN batch under ``"skip"``: counted once, the step dropped, every
    applied loss finite (4 epochs of 4 steps less one)."""
    _, ranks = spawned
    for r in ranks:
        assert list(r["skip/counts"]) == [1, 1]
        assert len(r["skip/losses"]) == 15
        assert np.isfinite(r["skip/losses"]).all()
        assert list(r["skip/epochs"]) == [0, 1, 2, 3]


def test_nonfinite_rollback_restores_the_last_checkpoint(spawned):
    """A NaN batch in epoch 1 under ``"rollback"``: the epoch-1
    checkpoint is restored and the epoch replayed."""
    _, ranks = spawned
    for r in ranks:
        assert list(r["rollback/counts"]) == [1, 1]
        assert list(r["rollback/epochs"]) == [0, 1, 2, 3]
        assert np.isfinite(r["rollback/losses"]).all()


def test_validation_scores_the_published_model(spawned):
    _, ranks = spawned
    for r in ranks:
        acc, again = r["valid/acc"]
        assert 0.0 <= acc <= 1.0 and acc == again


def test_every_rank_holds_the_whole_model_after_the_fit(spawned):
    _, ranks = spawned
    for key in ("fd", "ov"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{key}/logits"],
                                          ranks[0][f"{key}/logits"])


class _FakeMesh(tmesh.Mesh):
    """A mesh view for the refusals, which are checked before any
    collective."""

    def __init__(self, shape):
        super().__init__(shape, 0, {k: 0 for k in shape}, {},
                         torch.device("cpu"))


def _refused(model, mesh, **kw):
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    X, y = _images(32)
    cfg = TrainConfig(batch_size=16, max_epochs=1, **dict(
        dict(param_sharding="pipeline"), **kw))
    return Trainer(model, cfg, mesh=mesh, device="cpu").fit(X, y)


def test_unknown_schedule_rejected():
    from synapseml_tpu_torch.dl.pipeline import SUPPORTED_MATRIX
    from synapseml_tpu_torch.parallel import ElasticUnsupportedError

    with pytest.raises(ElasticUnsupportedError, match="zigzag") as ei:
        _refused(tdl.make_staged_backbone("tiny", 4, 2),
                 _FakeMesh({"stage": 2, "data": 2}),
                 pipeline_schedule="zigzag")
    assert isinstance(ei.value, NotImplementedError)
    assert ei.value.matrix == SUPPORTED_MATRIX and all(
        SUPPORTED_MATRIX.values())


def test_requires_staged_model_and_stage_axis():
    with pytest.raises(ValueError, match="StageSequential"):
        _refused(tdl.make_backbone("tiny", 4),
                 _FakeMesh({"stage": 2, "data": 2}))
    with pytest.raises(ValueError, match="stage"):
        _refused(tdl.make_staged_backbone("tiny", 4, 2),
                 _FakeMesh({"data": 4}))


def test_microbatches_must_split_the_batch():
    with pytest.raises(ValueError, match="pipeline_microbatches=3"):
        _refused(tdl.make_staged_backbone("tiny", 4, 2),
                 _FakeMesh({"stage": 2, "data": 2}),
                 pipeline_microbatches=3)


def test_unknown_seq_variant_carries_the_matrix():
    from synapseml_tpu_torch.dl.pipeline import SUPPORTED_MATRIX
    from synapseml_tpu_torch.parallel import ElasticUnsupportedError

    with pytest.raises(ElasticUnsupportedError) as ei:
        _refused(tdl.staged_text_encoder(**TEXT),
                 _FakeMesh({"stage": 2, "seq": 2}),
                 seq_attention="megatron")
    assert ei.value.matrix == SUPPORTED_MATRIX
    assert any("seq" in k for k in ei.value.matrix)


# --- TestStaging -------------------------------------------------------------

def test_stage_submeshes(spawned):
    _, ranks = spawned
    for i, r in enumerate(ranks):
        assert list(r["submesh/assign"]) == [0, 1, 0]
        assert r["submesh/ranks"].tolist() == [[0, 1], [2, 3]]
        assert str(r["submesh/shapes"]) == "[{'data': 2}, {'data': 2}]"
        assert list(r["submesh/mine"]) == [i < 2, i >= 2]


def test_stage_submeshes_needs_a_stage_axis():
    with pytest.raises(ValueError, match="stage"):
        tmesh.stage_submeshes(_FakeMesh({"data": 4}), 2)


def test_partition_stages_balanced_contiguous():
    units = tdl.stage_units("resnet18", num_classes=10, width=8)
    seq = tdl.partition_stages(units, 3)
    sizes = [len(s.units) for s in seq.stages]
    assert sum(sizes) == len(units) and max(sizes) - min(sizes) <= 1
    flat = [u for s in seq.stages for u in s.units]
    assert [type(u) for u in flat] == [type(u) for u in units]


@pytest.mark.parametrize("name,stages", [("tiny", 2), ("resnet18", 3),
                                         ("text", 2)])
def test_staged_forward_matches_the_jax_stage_sequential(name, stages):
    """The staged model applied whole and stage by stage against the JAX
    ``StageSequential`` on carried weights (BatchNorm's running statistics
    included), within 1e-6 of the largest logit."""
    import jax.numpy as jnp

    from synapseml_tpu import dl as jdl

    if name == "text":
        x = _tokens(4)[0]
        jm = jdl.staged_text_encoder(**TEXT)
        tm = tdl.staged_text_encoder(**TEXT)
    else:
        x = _images(4)[0]
        width = {} if name == "tiny" else {"width": 8}
        jm = jdl.make_staged_backbone(name, 4, stages, **width)
        tm = tdl.make_staged_backbone(name, 4, stages, **width)
    variables = _jax_init(jm, jnp.asarray(x))
    if "batch_stats" in variables:
        rng = np.random.default_rng(1)
        import jax
        variables = dict(variables, batch_stats=jax.tree_util.tree_map(
            lambda a: np.abs(rng.normal(size=a.shape)).astype(np.float32),
            variables["batch_stats"]))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm.load_state_dict(staged_from_reference(variables))
    tm.eval()
    with torch.no_grad():
        whole = tm(torch.as_tensor(x)).numpy()
        h = torch.as_tensor(x)
        for st in tm.stages:
            h = st(h)
    scale = np.abs(want).max()
    np.testing.assert_allclose(whole, want, atol=FORWARD_TOL * scale, rtol=0)
    np.testing.assert_array_equal(h.numpy(), whole)


@pytest.mark.parametrize("name", ["tiny", "resnet18", "text"])
def test_staged_weight_carry_round_trip(name):
    import jax.numpy as jnp

    from synapseml_tpu import dl as jdl

    if name == "text":
        jm, x = jdl.staged_text_encoder(**TEXT), _tokens(2)[0]
    else:
        width = {} if name == "tiny" else {"width": 8}
        jm = jdl.make_staged_backbone(name, 4, 2, **width)
        x = _images(2)[0]
    variables = _jax_init(jm, jnp.asarray(x))
    back = staged_to_reference(staged_from_reference(variables))
    import jax
    got = jax.tree_util.tree_leaves_with_path(back)
    ref = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, dict(variables)))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("costs,stages", [
    ([1, 1, 1, 1, 1, 1], 3), ([5, 1, 1, 1, 1, 5], 3), ([0, 0, 0], 2),
    ([9, 1, 1, 1], 2), ([1, 2, 3, 4, 5, 6, 7, 8], 4), ([3, 1], 3)])
def test_suggest_stage_cuts_equals_the_jax_cuts(costs, stages):
    from synapseml_tpu.core import perfmodel as jperf
    from synapseml_tpu_torch.core import perfmodel as tperf

    got, gdec = tperf.suggest_stage_cuts(costs, stages)
    want, wdec = jperf.suggest_stage_cuts(costs, stages)
    assert got == want
    assert (gdec.arm, gdec.used_fallback, gdec.predicted_s) == \
        (wdec.arm, wdec.used_fallback, wdec.predicted_s)


@pytest.mark.parametrize("stages,micro", [(2, 1), (2, 4), (4, 8), (8, 2)])
def test_suggest_pipeline_schedule_equals_the_jax_choice(stages, micro):
    from synapseml_tpu.core import perfmodel as jperf
    from synapseml_tpu_torch.core import perfmodel as tperf

    got, gdec = tperf.suggest_pipeline_schedule(stages, micro)
    want, wdec = jperf.suggest_pipeline_schedule(stages, micro)
    assert got == want == "fill_drain"
    assert gdec.used_fallback and gdec.source == "analytic"
    priors = {c["arm"]: c["predicted_s"] for c in gdec.candidates}
    assert priors["fill_drain"] == pytest.approx((micro + stages - 1)
                                                 / micro)


def test_cost_balanced_partition():
    units = tdl.stage_units("tiny", 4)
    seq = tdl.partition_stages(units, 2, unit_costs=[10, 1, 1])
    assert [len(s.units) for s in seq.stages] == [1, 2]
    with pytest.raises(ValueError, match="unit_costs"):
        tdl.partition_stages(units, 2, unit_costs=[1, 1])
