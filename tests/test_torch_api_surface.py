"""The port's API against the JAX package's, name by name: the fields and
defaults of ``TrainConfig`` and ``BoosterConfig``, the arguments of
``train_booster``, ``Dataset`` and every public ``Booster`` method, the
public names of ``Booster`` and ``Dataset``, and the params of the GBDT and
DL estimators, the serving layer's classes (``BucketedRunner``,
``ServingServer``, ``ModelRegistry``, ``QoSController``), the ONNX
package (``OnnxFunction``, ``ONNXModel``, ``ImageFeaturizer``, ``ONNXHub``
and the op registry's 135 names), the fabric, VW and online-loop
modules with the VW estimators' params, and the anomaly, recommendation and
nearest-neighbour packages (``isolationforest``, ``cyber``,
``recommendation``, ``nn``) with every estimator's params. A name of the JAX
package is either ported or declared here as unported, and every unported
name raises ``NotImplementedError`` naming itself (never ``TypeError`` or
``AttributeError``), so the gap cannot reopen unseen. Then the scoring arguments ported by name: ``binned``,
``batch_size`` and ``Booster.unweighted``, against the JAX package on a
booster carried across by ``convert`` (the same trees: exact, or 1e-6 for
probabilities from another library's sigmoid).
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.core import inference as jinference
from synapseml_tpu.core import qos as jqos
from synapseml_tpu.dl import text as jtext
from synapseml_tpu.dl import trainer as jtrainer
from synapseml_tpu.dl import vision as jvision
from synapseml_tpu.gbdt import boosting as jboost
from synapseml_tpu.gbdt import dataset as jdataset
from synapseml_tpu.gbdt import stream as jstream
from synapseml_tpu.io import ingest as jingest
from synapseml_tpu.ops import quantize as jquantize
from synapseml_tpu.io import serving as jserving
from synapseml_tpu.io import serving_main as jserving_main
from synapseml_tpu.models import gbdt as jmodels
from synapseml_tpu import vw as jvw

from synapseml_tpu_torch import io as tio
from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.core import inference as tinference
from synapseml_tpu_torch.core import qos as tqos
from synapseml_tpu_torch.dl import text as ttext
from synapseml_tpu_torch.dl import trainer as ttrainer
from synapseml_tpu_torch.dl import vision as tvision
from synapseml_tpu_torch.gbdt import boosting as tboost
from synapseml_tpu_torch.gbdt import dataset as tdataset
from synapseml_tpu_torch.gbdt import stream as tstream
from synapseml_tpu_torch.io import ingest as tingest
from synapseml_tpu_torch.io import serving as tserving
from synapseml_tpu_torch.io import serving_main as tserving_main
from synapseml_tpu_torch.models import gbdt as tmodels
from synapseml_tpu_torch import vw as tvw
from synapseml_tpu_torch.ops import quantize as tq
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)
from torch_waits import join_spawn

CPU = "cpu"

# names of the JAX package the port declares unported (each refused below)
UNPORTED_BOOSTER = set()
UNPORTED_DATASET = set()
UNPORTED_ESTIMATOR_PARAMS = set()
# TrainConfig fields that take only their default (machinery not ported)
DEFAULT_ONLY = {"prefetch_batches": 4, "donate_buffers": False}
# the pipeline fields, once refused at their defaults: (value, what the
# fit's stats show against the default's)
PIPELINE_FIELDS = {"pipeline_microbatches": 4,
                   "pipeline_param_sharding": "zero",
                   "pipeline_schedule": "overlap"}


def _fields(cls) -> dict:
    return {f.name: f.default for f in dataclasses.fields(cls)}


def _args(fn) -> set:
    return set(inspect.signature(fn).parameters) - {"self", "cls"}


def _public(cls) -> set:
    return {n for n in dir(cls) if not n.startswith("_")}


@pytest.mark.parametrize("jcls,tcls", [
    (jtrainer.TrainConfig, ttrainer.TrainConfig),
    (jboost.BoosterConfig, tboost.BoosterConfig)])
def test_config_fields_and_defaults_are_the_references(jcls, tcls):
    jf, tf = _fields(jcls), _fields(tcls)
    assert tf.keys() == jf.keys()
    # the JAX package draws a few engine knobs from its tuned defaults
    # (a default_factory): those keep only their names here
    assert {k: v for k, v in tf.items() if jf[k] is not dataclasses.MISSING} \
        == {k: v for k, v in jf.items() if v is not dataclasses.MISSING}


@pytest.mark.parametrize("field", list(DEFAULT_ONLY))
def test_default_only_train_config_fields_are_refused_by_name(field):
    from synapseml_tpu_torch.dl.text import TransformerEncoder

    assert ttrainer.Trainer.unported(ttrainer.TrainConfig(resume=False)) \
        == []
    model = TransformerEncoder(vocab_size=16, num_layers=1, num_heads=2,
                               hidden=8, max_len=8)
    cfg = ttrainer.TrainConfig(**{field: DEFAULT_ONLY[field]})
    trainer = ttrainer.Trainer(model, cfg, device=CPU)
    with pytest.raises(NotImplementedError, match=field):
        trainer.fit(np.zeros((4, 8), np.int64), np.zeros(4, np.int64))


def _pipeline_rank(rank, workdir, port):
    """One of 2 processes of a multi-controller world
    (``initialize_distributed``, the pipeline's cross-process checks on): a
    2-stage ``tiny`` pipeline on ``{"stage": 1, "data": 2}`` (both stages
    on the one group) with each pipeline field at its default and at
    ``PIPELINE_FIELDS``'s value, and ``pipeline_schedule="auto"``."""
    import json
    import os

    from synapseml_tpu_torch.dl import make_staged_backbone
    from synapseml_tpu_torch.parallel import (initialize_distributed,
                                              make_mesh, process_count)

    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, timeout_s=60)
    assert process_count() == 2
    mesh = make_mesh({"stage": 1, "data": 2}, device=CPU)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    y = np.arange(16) % 2
    stats = {}
    for field, value in [(None, None)] + list(PIPELINE_FIELDS.items()) \
            + [("auto", "auto")]:
        kw = ({} if field is None else {"pipeline_schedule": "auto"}
              if field == "auto" else {field: value})
        cfg = ttrainer.TrainConfig(batch_size=16, max_epochs=1,
                                   param_sharding="pipeline", **kw)
        tr = ttrainer.Trainer(make_staged_backbone("tiny", 2, 2), cfg,
                              mesh=mesh, device=CPU).fit(X, y)
        stats[str(field)] = {k: tr.stats.get(k) for k in (
            "microbatches", "schedule", "state_bytes_per_rank",
            "autoconfig")}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(stats, f)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def pipeline_stats(tmp_path_factory):
    import json

    import torch.multiprocessing as mp

    import socket

    workdir = tmp_path_factory.mktemp("pipeline_fields")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    join_spawn(mp.start_processes(_pipeline_rank, args=(str(workdir), port),
                                  nprocs=2, join=False,
                                  start_method="spawn"),
               what="the 2-rank pipeline spawn")
    return [json.loads((workdir / f"rank{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("field", list(PIPELINE_FIELDS))
def test_pipeline_train_config_fields_take_effect(pipeline_stats, field):
    """The three pipeline fields, once refused at their defaults: none is
    unported now, and each changes the fit (``Trainer.stats``) against the
    default (1 microbatch per stage group, replicated stages,
    fill-drain)."""
    assert ttrainer.Trainer.unported(ttrainer.TrainConfig(
        param_sharding="pipeline", **{field: PIPELINE_FIELDS[field]})) == []
    for stats in pipeline_stats:
        base, got = stats["None"], stats[field]
        assert (base["microbatches"], base["schedule"]) == (1, "fill_drain")
        if field == "pipeline_microbatches":
            assert got["microbatches"] == 4
        elif field == "pipeline_param_sharding":
            # ZeRO over the group's 2 data ranks: about half the state
            assert got["state_bytes_per_rank"] < \
                0.6 * base["state_bytes_per_rank"]
        else:
            assert got["schedule"] == "overlap"
            # "auto" asks the analytic model, which keeps fill-drain
            auto = stats["auto"]
            assert auto["schedule"] == "fill_drain"
            prov = auto["autoconfig"]["pipeline_schedule"]
            assert prov["arm"] == "fill_drain" and prov["used_fallback"]


@pytest.mark.parametrize("field,value,want", [
    ("keep_checkpoints", 2, [3, 4]),
    ("save_every_epochs", 2, [2, 4])])
def test_checkpoint_train_config_fields_take_effect(tmp_path, field, value,
                                                    want):
    """The two checkpoint fields once refused at their defaults: retention
    keeps the newest ``keep_checkpoints`` epochs, and a save lands every
    ``save_every_epochs`` epochs (at epoch e + 1)."""
    from synapseml_tpu_torch.core.checkpoint import CheckpointStore
    from synapseml_tpu_torch.dl import make_backbone

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(32, 8, 8, 3)).astype(np.float32)
    y = np.arange(32) % 2
    cfg = ttrainer.TrainConfig(batch_size=16, max_epochs=4,
                               checkpoint_dir=str(tmp_path / "ck"),
                               **{field: value})
    ttrainer.Trainer(make_backbone("tiny", 2), cfg, device=CPU).fit(X, y)
    assert CheckpointStore(str(tmp_path / "ck")).steps() == want


@pytest.mark.parametrize("jfn,tfn", [
    (jboost.train_booster, tboost.train_booster),
    (jdataset.Dataset.__init__, tdataset.Dataset.__init__),
    (jdataset.bin_sparse, tdataset.bin_sparse),
    (jdataset.Dataset.from_batches, tdataset.Dataset.from_batches),
    (jstream.train_booster_streamed, tstream.train_booster_streamed),
    (jstream.predict_streamed, tstream.predict_streamed),
    (jingest.stream_chunk_rows, tingest.stream_chunk_rows),
    (jingest.stream_depth, tingest.stream_depth),
    (jingest.read_chunk_file, tingest.read_chunk_file),
    (jingest.pump_polling, tingest.pump_polling)])
def test_functions_take_every_reference_argument(jfn, tfn):
    assert _args(jfn) - _args(tfn) == set()


@pytest.mark.parametrize("jmod,tmod", [(jstream, tstream),
                                       (jingest, tingest)])
def test_streaming_modules_hold_every_reference_name(jmod, tmod):
    """Every public function and class the JAX package's streamed GBDT and
    ingestion modules define is in the port's, with the same parameters
    (the port's entry points add ``device``)."""
    public = {n for n in dir(jmod) if not n.startswith("_")
              and callable(getattr(jmod, n))
              and getattr(getattr(jmod, n), "__module__", "") == jmod.__name__}
    assert public - set(dir(tmod)) == set()
    for name in sorted(public):
        jobj, tobj = getattr(jmod, name), getattr(tmod, name)
        if inspect.isclass(jobj):
            if issubclass(jobj, BaseException):
                continue
            assert _args(jobj.__init__) - _args(tobj.__init__) == set(), name
        else:
            assert _args(jobj) - _args(tobj) == set(), name
    assert "device" in _args(tstream.train_booster_streamed)


def test_distributed_surface_is_ported():
    """The mesh argument, once refused by name, and the distributed GBDT's
    surface: the JAX package's histogram collectives, its voting module's
    functions and the grower config's reduction fields exist in the port
    (``tests/test_torch_gbdt_distributed.py`` holds them to JAX)."""
    import synapseml_tpu.gbdt.voting as jvoting
    import synapseml_tpu.parallel as jparallel
    import synapseml_tpu_torch.gbdt.voting as tvoting
    import synapseml_tpu_torch.parallel as tparallel
    from synapseml_tpu.gbdt.grower import GrowerConfig as JGrowerConfig
    from synapseml_tpu_torch.gbdt.grower import GrowerConfig

    assert "mesh" in _args(jboost.train_booster) & _args(tboost.train_booster)
    for name in ("allreduce_sum", "allreduce_mean", "reduce_scatter_sum",
                 "allgather", "axis_rank", "allreduce_sum_quantized",
                 "reduce_scatter_sum_quantized", "probe_link_bandwidth"):
        assert hasattr(jparallel, name) and hasattr(tparallel, name), name
    public = {n for n in dir(jvoting) if not n.startswith("_")
              and callable(getattr(jvoting, n))
              and getattr(getattr(jvoting, n), "__module__", "")
              == jvoting.__name__}
    assert public <= set(dir(tvoting))
    for name in ("hist_allreduce_dtype", "hist_reduce", "feature_shards",
                 "partition_impl", "row_layout", "use_segmented"):
        assert JGrowerConfig._field_defaults[name] \
            == GrowerConfig._field_defaults[name]
    # the multi-process contract: every mesh helper of the JAX package
    # that the port maps onto its ranks
    import synapseml_tpu.parallel.mesh as jmesh
    import synapseml_tpu_torch.parallel.mesh as tmesh
    for name in ("initialize_distributed", "process_topology",
                 "assert_equal_across_processes", "local_mesh_devices",
                 "mesh_process_indices", "shard_rows", "to_global_rows",
                 "host_copy"):
        assert hasattr(jmesh, name) and hasattr(tmesh, name), name
        assert hasattr(tparallel, name), name
    for name in ("initialize_distributed", "shard_rows", "process_topology",
                 "host_copy"):
        assert hasattr(jparallel, name), name
    assert "mesh" in _args(jstream.train_booster_streamed) \
        & _args(tstream.train_booster_streamed)
    # pipeline parallelism and elastic training: the JAX package's names
    for name in ("STAGE_AXIS", "stage_submeshes", "CollectiveWatchdog",
                 "ElasticUnsupportedError", "HeartbeatMonitor",
                 "HeartbeatWriter", "PeerLostError", "TrainingSupervisor",
                 "consensus_restart_step", "current_watchdog",
                 "elastic_train", "elastic_watchdog", "run_with_budget",
                 "verified_steps"):
        assert hasattr(jparallel, name) and hasattr(tparallel, name), name
    import synapseml_tpu.dl as jdl
    import synapseml_tpu.dl.backbones as jbackbones
    import synapseml_tpu.dl.pipeline as jpipeline
    import synapseml_tpu.parallel.elastic as jelastic
    import synapseml_tpu.parallel.transfer as jtransfer
    import synapseml_tpu_torch.dl as tdl
    import synapseml_tpu_torch.dl.backbones as tbackbones
    import synapseml_tpu_torch.dl.pipeline as tpipeline
    import synapseml_tpu_torch.parallel.elastic as telastic
    import synapseml_tpu_torch.parallel.transfer as ttransfer
    for name in ("StageGroup", "StageSequential", "ResNetStem",
                 "ConvReluUnit", "PoolDenseHead", "stage_units",
                 "partition_stages", "make_staged_backbone",
                 "staged_text_encoder"):
        assert hasattr(jbackbones, name) and hasattr(tbackbones, name), name
    for name in ("make_staged_backbone", "staged_text_encoder"):
        assert hasattr(jdl, name) and hasattr(tdl, name), name
    assert tpipeline.SUPPORTED_MATRIX == jpipeline.SUPPORTED_MATRIX
    assert tpipeline._SCHEDULES == jpipeline._SCHEDULES
    for name in ("device_transfer", "host_fetch", "share_scalars"):
        assert hasattr(jtransfer, name) and hasattr(ttransfer, name), name
    public = {n for n in dir(jelastic) if not n.startswith("_")
              and getattr(getattr(jelastic, n), "__module__", "")
              == jelastic.__name__}
    assert public <= set(dir(telastic))


@pytest.mark.parametrize("jcls,tcls,unported", [
    (jboost.Booster, tboost.Booster, UNPORTED_BOOSTER),
    (jdataset.Dataset, tdataset.Dataset, UNPORTED_DATASET),
    (jstream.StreamedDataset, tstream.StreamedDataset, set()),
    (jingest.ChunkPump, tingest.ChunkPump, set()),
    (jingest.DiskChunkSource, tingest.DiskChunkSource, set()),
    (jquantize.StreamingQuantileSketch, tq.StreamingQuantileSketch, set()),
    (jinference.BucketedRunner, tinference.BucketedRunner, set()),
    (jinference.PendingBatch, tinference.PendingBatch, set()),
    (jinference.RunnerFleet, tinference.RunnerFleet, set()),
    (jserving.ServingServer, tserving.ServingServer, set()),
    (jserving.ModelRegistry, tserving.ModelRegistry, set()),
    (jqos.QoSController, tqos.QoSController, set()),
    (jqos.WeightedFairQueue, tqos.WeightedFairQueue, set())])
def test_public_methods_take_every_reference_argument(jcls, tcls, unported):
    assert _public(jcls) - _public(tcls) == set()
    for name in sorted(_public(jcls)):
        jattr = inspect.getattr_static(jcls, name)
        if isinstance(jattr, property) or not callable(getattr(jcls, name)):
            continue
        assert _args(getattr(jcls, name)) - _args(getattr(tcls, name)) \
            == set(), name
    # the declared unported names exist, so they refuse rather than vanish
    assert unported <= _public(tcls)


@pytest.fixture(scope="module")
def boosters():
    """(X, JAX booster, the port's copy of it by ``convert``)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 4)).astype(np.float32)
    X[rng.random(600) < 0.1, 2] = np.nan
    y = (X[:, 0] + X[:, 1] * X[:, 3] > 0).astype(np.float32)
    jb = jboost.train_booster(X, y, jboost.BoosterConfig(
        objective="binary", num_iterations=3, num_leaves=7))
    arrays, config = booster_arrays(jb)
    return X, jb, booster_from_reference(arrays, config, device=CPU)


def test_unported_names_raise_naming_themselves(boosters):
    X, _, tb = boosters
    for name, call in (
            ("hfModel", lambda: ttext.DeepTextModel(hfModel=object())),
            ("hfTokenizer", lambda: ttext.DeepTextModel(
                hfTokenizer=object()))):
        with pytest.raises(NotImplementedError, match=name):
            call()


@pytest.mark.parametrize("jcls,tcls,unported", [
    (jmodels.LightGBMClassifier, tmodels.LightGBMClassifier,
     UNPORTED_ESTIMATOR_PARAMS),
    (jmodels.LightGBMRegressor, tmodels.LightGBMRegressor,
     UNPORTED_ESTIMATOR_PARAMS),
    (jmodels.LightGBMRanker, tmodels.LightGBMRanker,
     UNPORTED_ESTIMATOR_PARAMS),
    (jtext.DeepTextClassifier, ttext.DeepTextClassifier, set()),
    (jtext.DeepTextModel, ttext.DeepTextModel, set()),
    (jvision.DeepVisionClassifier, tvision.DeepVisionClassifier, set()),
    (jvision.DeepVisionModel, tvision.DeepVisionModel, set())] + [
    (getattr(jvw, n), getattr(tvw, n), set()) for n in (
        "VowpalWabbitClassifier", "VowpalWabbitClassificationModel",
        "VowpalWabbitRegressor", "VowpalWabbitRegressionModel",
        "VowpalWabbitGeneric", "VowpalWabbitGenericModel",
        "VowpalWabbitGenericProgressive", "VowpalWabbitContextualBandit",
        "VowpalWabbitContextualBanditModel", "VowpalWabbitFeaturizer",
        "VowpalWabbitInteractions", "VowpalWabbitDSJsonTransformer",
        "VowpalWabbitCSETransformer")])
def test_estimator_params_are_ported_or_refused_by_name(jcls, tcls,
                                                        unported):
    assert set(jcls()._params) - set(tcls()._params) == unported
    assert _args(jcls.__init__) - _args(tcls.__init__) == set()
    if jcls.__module__.endswith("gbdt"):
        assert tmodels.UNPORTED_PARAMS == unported
        for name in unported:
            with pytest.raises(NotImplementedError, match=name):
                tcls(**{name: jcls().get(name)})


# ---------------------------------------------------------------------------
# scoring arguments ported by name
# ---------------------------------------------------------------------------

def test_predict_binned_matches_the_reference(boosters):
    X, jb, tb = boosters
    binned = tq.apply_bins(tb.mapper, X, CPU).numpy()
    np.testing.assert_array_equal(
        tb.raw_score(binned, binned=True),
        np.asarray(jb.raw_score(jnp.asarray(binned), binned=True)))
    np.testing.assert_allclose(
        tb.predict(binned, binned=True),
        np.asarray(jb.predict(jnp.asarray(binned), binned=True)), rtol=0,
        atol=1e-6)
    # the same leaves as the raw rows' (NaN bins take the learned side)
    np.testing.assert_array_equal(tb.raw_score(binned, binned=True),
                                  tb.raw_score(X))


@pytest.mark.parametrize("batch_size", [1, 7, 600, 1000])
def test_predict_batch_size_gives_the_unbatched_values(boosters, batch_size):
    X, jb, tb = boosters
    got = tb.predict(X, batch_size=batch_size)
    np.testing.assert_array_equal(got, tb.predict(X))
    np.testing.assert_allclose(
        got, np.asarray(jb.predict(X, batch_size=batch_size)), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("kw", [dict(binned=True), dict(num_iteration=2),
                                dict(batch_size=0), dict(empty=True)])
def test_predict_batch_size_refuses_what_the_reference_refuses(boosters,
                                                               kw):
    X, jb, tb = boosters
    kw = dict(kw)
    rows = X[:0] if kw.pop("empty", False) else X
    kw.setdefault("batch_size", 8)
    for b in (jb, tb):
        with pytest.raises(ValueError):
            b.predict(rows, **kw)


def test_unweighted_matches_the_reference(boosters):
    X, jb, tb = boosters
    tu, ju = tb.unweighted(), jb.unweighted()
    assert tu.tree_weights == [1.0] * tb.num_trees
    assert not tu.base_score.any()
    np.testing.assert_array_equal(tu.raw_score(X),
                                  np.asarray(ju.raw_score(X)))
    assert tu.device == tb.device


# ---------------------------------------------------------------------------
# the serving layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jmod,tmod", [
    (jinference, tinference), (jserving, tserving), (jqos, tqos),
    (jserving_main, tserving_main)])
def test_serving_modules_hold_every_reference_name(jmod, tmod):
    """Every public function and class of the JAX serving modules is in the
    port's, taking every reference argument."""
    names = {n for n, v in vars(jmod).items() if not n.startswith("_")
             and callable(v) and getattr(v, "__module__", "") ==
             jmod.__name__}
    assert names - set(vars(tmod)) == set()
    for name in sorted(names):
        jobj, tobj = getattr(jmod, name), getattr(tmod, name)
        target = "__init__" if inspect.isclass(jobj) else None
        jfn = getattr(jobj, target) if target else jobj
        tfn = getattr(tobj, target) if target else tobj
        if jfn is object.__init__ or name == "PendingBatch":
            continue   # the runner builds a PendingBatch (JAX: a treedef)
        assert _args(jfn) - _args(tfn) == set(), name


def test_serving_main_takes_every_reference_flag():
    def flags(mod):
        import argparse

        seen = {}

        class Stop(Exception):
            pass

        def parse(self, argv=None, namespace=None):
            seen.update({a.dest: a for a in self._actions})
            raise Stop

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = parse
        try:
            with pytest.raises(Stop):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return set(seen) - {"help"}

    assert flags(jserving_main) - flags(tserving_main) == set()


# the JAX names of the fabric, VW and the online loop that the port refuses
# by name (each raises NotImplementedError naming itself): none since the
# anomaly detectors were ported
UNPORTED_ONLINE = set()


def _module_names(mod) -> set:
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and callable(v) and getattr(v, "__module__", "") == mod.__name__}


@pytest.mark.parametrize("name", [
    "core.gossip", "io.distributed_serving", "vw.hashing", "vw.featurizer",
    "vw.learner", "vw.estimators", "vw.textparse", "vw.policyeval",
    "online.feedback", "online.loop", "online.policy", "online.promotion",
    "online.anomaly"])
def test_fabric_vw_and_online_names_take_every_reference_argument(name):
    """Every public function and class of the JAX package's fabric
    (once refused by name), VW and online-loop modules is in the port's
    module, taking every reference argument (the port's entry points add
    ``device``), its classes with every public method; names in
    ``UNPORTED_ONLINE`` would refuse by name."""
    import importlib

    jmod = importlib.import_module(f"synapseml_tpu.{name}")
    tmod = importlib.import_module(f"synapseml_tpu_torch.{name}")
    names = _module_names(jmod)
    assert names - set(vars(tmod)) == set()
    for n in sorted(names):
        jobj, tobj = getattr(jmod, n), getattr(tmod, n)
        if n in UNPORTED_ONLINE:
            with pytest.raises(NotImplementedError, match=n):
                tobj(object())
        if inspect.isclass(jobj):
            assert inspect.isclass(tobj), n
            if issubclass(jobj, BaseException):
                assert issubclass(tobj, BaseException), n
                continue
            if jobj.__init__ is not object.__init__:
                assert _args(jobj.__init__) - _args(tobj.__init__) == set(), n
            assert _public(jobj) - _public(tobj) == set(), n
            for meth in sorted(_public(jobj)):
                jattr = inspect.getattr_static(jobj, meth)
                if isinstance(jattr, property) or not callable(
                        getattr(jobj, meth)):
                    continue
                assert _args(getattr(jobj, meth)) \
                    - _args(getattr(tobj, meth)) == set(), (n, meth)
        else:
            assert _args(jobj) - _args(tobj) == set(), n


ANALYTICS_MODULES = [
    "isolationforest.iforest", "cyber.access_anomaly", "cyber.indexers",
    "cyber.scalers", "recommendation.indexer", "recommendation.sar",
    "recommendation.ranking", "nn.balltree", "nn.knn",
    "explainers.base", "explainers.solvers", "explainers.lime",
    "explainers.shap", "explainers.ice", "image.superpixel", "image.unroll",
    "causal.solvers", "causal.residual", "causal.doubleml",
    "causal.orthoforest", "causal.did", "ops.histogram", "ops.image"]
# the stages that compute on a device, by name without "Model"
ON_DEVICE = ("IsolationForest", "AccessAnomaly", "SAR", "KNN",
             "ConditionalKNN", "LocalExplainerBase", "VectorLIME",
             "TabularLIME", "TextLIME", "ImageLIME", "VectorSHAP",
             "TabularSHAP", "TextSHAP", "ImageSHAP", "ICETransformer",
             "SyntheticControlEstimator", "SyntheticDiffInDiffEstimator",
             "OrthoForestDMLEstimator", "OrthoForestDML")


def _stage_classes(mod) -> list:
    from synapseml_tpu.core.params import Params

    return sorted(n for n, v in vars(mod).items() if inspect.isclass(v)
                  and issubclass(v, Params) and v.__module__ == mod.__name__
                  and not n.startswith("_"))


@pytest.mark.parametrize("name", ANALYTICS_MODULES)
def test_analytics_modules_hold_every_reference_name_and_param(name):
    """Every public function and class of the JAX package's anomaly,
    recommendation, nearest-neighbour, explainer, image, causal, histogram
    and image-op modules is in the port's module,
    taking every reference argument, its classes with every public method;
    every estimator, model and transformer has every reference param with
    the reference's default, and the estimators and models that compute on
    a device add ``device`` (default ``"cuda"``)."""
    import importlib

    jmod = importlib.import_module(f"synapseml_tpu.{name}")
    tmod = importlib.import_module(f"synapseml_tpu_torch.{name}")
    names = _module_names(jmod)
    assert names and names - set(vars(tmod)) == set()
    for n in sorted(names):
        jobj, tobj = getattr(jmod, n), getattr(tmod, n)
        if not inspect.isclass(jobj):
            assert _args(jobj) - _args(tobj) == set(), n
            continue
        assert _args(jobj.__init__) - _args(tobj.__init__) == set(), n
        assert _public(jobj) - _public(tobj) == set(), n
        for meth in sorted(_public(jobj)):
            jattr = inspect.getattr_static(jobj, meth)
            if isinstance(jattr, property) or not callable(
                    getattr(jobj, meth)):
                continue
            assert _args(getattr(jobj, meth)) \
                - _args(getattr(tobj, meth)) == set(), (n, meth)
    for n in _stage_classes(jmod):
        jp = getattr(jmod, n)._params
        tp = getattr(tmod, n)._params
        assert set(jp) - set(tp) == set(), n
        for p in jp:
            assert tp[p].default == jp[p].default, (n, p)
        if n.replace("Model", "") in ON_DEVICE:
            assert tp["device"].default == "cuda", n
            assert set(tp) - set(jp) == {"device"}, n
        else:
            assert set(tp) == set(jp), n


@pytest.mark.parametrize("pkg", ["io", "vw", "online", "core",
                                 "isolationforest", "cyber",
                                 "recommendation", "nn", "explainers",
                                 "causal", "image"])
def test_package_exports_hold_the_references(pkg):
    """The port's ``io`` exports the working fabric names (``UNPORTED`` is
    gone), and ``vw`` / ``online`` / ``core`` export every name the JAX
    packages' ``__init__`` exports from those modules."""
    import importlib

    jpkg = importlib.import_module(f"synapseml_tpu.{pkg}")
    tpkg = importlib.import_module(f"synapseml_tpu_torch.{pkg}")
    if pkg == "io":
        want = {"ServingGateway", "WorkerAgent", "FabricSupervisor",
                "PromotionBroadcast", "DistributedServingServer", "federate",
                "BroadcastError", "CoordinatorDied"}
        assert not hasattr(tpkg, "UNPORTED")
        for n in want:
            assert getattr(tpkg, n) is getattr(
                importlib.import_module(
                    "synapseml_tpu_torch.io.distributed_serving"), n)
    elif pkg == "core":
        want = {"ConsistentHashRing", "GossipEntry", "GossipState",
                "CheckpointStore", "reset_failure_counts", "failure_counts"}
    else:
        want = set(jpkg.__all__)
    assert want <= set(dir(tpkg))
    if pkg not in ("io", "core"):
        assert set(tpkg.__all__) == set(jpkg.__all__)


# ---------------------------------------------------------------------------
# featurization, train helpers, stages, balance measures, AutoML and the
# native helpers
# ---------------------------------------------------------------------------

ESTIMATOR_LAYER_MODULES = [
    "featurize.clean", "featurize.convert", "featurize.featurize",
    "featurize.indexer", "featurize.select", "featurize.text",
    "stages.basic", "stages.adapter", "stages.balance", "stages.batchers",
    "stages.ensemble", "stages.summarize", "stages.text",
    "train.metrics", "train.stats", "train.train", "exploratory.balance",
    "automl.hyperparams", "automl.scheduler", "automl.tune",
    "automl.worker", "native"]


@pytest.mark.parametrize("name", ESTIMATOR_LAYER_MODULES)
def test_estimator_layer_modules_hold_every_reference_name_and_param(name):
    """Every public function and class of the JAX package's featurize,
    train, stages, exploratory, automl and native modules is in the port's
    module, taking every reference argument, its classes with every public
    method; every stage has exactly the reference's params with the
    reference's defaults (none of them computes on a device itself: the
    LightGBM estimators they wrap take ``device``)."""
    import importlib

    jmod = importlib.import_module(f"synapseml_tpu.{name}")
    tmod = importlib.import_module(f"synapseml_tpu_torch.{name}")
    names = _module_names(jmod)
    assert names and names - set(vars(tmod)) == set()
    for n in sorted(names):
        jobj, tobj = getattr(jmod, n), getattr(tmod, n)
        if not inspect.isclass(jobj):
            assert _args(jobj) - _args(tobj) == set(), n
            continue
        if jobj.__init__ is not object.__init__:
            assert _args(jobj.__init__) - _args(tobj.__init__) == set(), n
        assert _public(jobj) - _public(tobj) == set(), n
        for meth in sorted(_public(jobj)):
            jattr = inspect.getattr_static(jobj, meth)
            if isinstance(jattr, property) or not callable(
                    getattr(jobj, meth)):
                continue
            assert _args(getattr(jobj, meth)) \
                - _args(getattr(tobj, meth)) == set(), (n, meth)
    for n in _stage_classes(jmod):
        jp = getattr(jmod, n)._params
        tp = getattr(tmod, n)._params
        assert set(tp) == set(jp), n
        for p in jp:
            assert tp[p].default == jp[p].default, (n, p)


@pytest.mark.parametrize("pkg", ["featurize", "stages", "train",
                                 "exploratory", "automl"])
def test_estimator_layer_packages_export_the_references(pkg):
    import importlib

    jpkg = importlib.import_module(f"synapseml_tpu.{pkg}")
    tpkg = importlib.import_module(f"synapseml_tpu_torch.{pkg}")
    want = set(getattr(jpkg, "__all__", None) or
               {n for n in vars(jpkg) if not n.startswith("_")
                and inspect.isclass(getattr(jpkg, n))})
    assert want <= set(dir(tpkg))
    if hasattr(jpkg, "__all__"):
        assert set(tpkg.__all__) == set(jpkg.__all__)


@pytest.mark.parametrize("name", ["Prediction", "predict", "predict_runtime",
                                  "append_training_row", "training_rows",
                                  "current_platform", "mesh_tag"])
def test_perfmodel_learned_names_take_every_reference_argument(name):
    from synapseml_tpu.core import perfmodel as jperf
    from synapseml_tpu_torch.core import perfmodel as tperf

    jobj, tobj = getattr(jperf, name), getattr(tperf, name)
    if inspect.isclass(jobj):
        assert _fields(jobj) == _fields(tobj)
    else:
        assert _args(jobj) == _args(tobj)
    for const in ("SCHEMA_VERSION", "MATCH_DISTANCE", "MIN_CONFIDENCE",
                  "ANALYTIC_CONFIDENCE", "_FIT_MIN_R2"):
        assert getattr(tperf, const) == getattr(jperf, const), const


@pytest.mark.parametrize("name", ["chaos_candidate", "kill_rank"])
def test_automl_chaos_takes_every_reference_argument(name):
    from synapseml_tpu import testing as jtesting
    from synapseml_tpu_torch import testing as ttesting

    jobj, tobj = getattr(jtesting, name), getattr(ttesting, name)
    if inspect.isclass(jobj):
        assert _args(jobj.__init__) == _args(tobj.__init__)
        assert _public(jobj) == _public(tobj)
        defaults = {k: v.default for k, v in
                    inspect.signature(jobj.__init__).parameters.items()}
        assert defaults == {k: v.default for k, v in inspect.signature(
            tobj.__init__).parameters.items()}
    else:
        assert _args(jobj) == _args(tobj)


def test_distributed_serving_server_takes_the_reference_arguments():
    """``DistributedServingServer`` and ``federate``, once refused by name,
    take the JAX package's arguments and run in one process (the fallback:
    one worker, its gateway and agent)."""
    import urllib.request

    from synapseml_tpu.io import distributed_serving as jdist
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.io import distributed_serving as tdist

    assert _args(jdist.DistributedServingServer.__init__) \
        == _args(tdist.DistributedServingServer.__init__)
    assert _args(jdist.federate) == _args(tdist.federate)

    def handler(df):
        return Table({"id": df["id"], "reply": df["value"]})

    with tdist.DistributedServingServer(handler) as dss:
        assert dss.gateway is not None and dss.agent is not None
        req = urllib.request.Request(dss.url, data=b"5", method="POST",
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200 and r.read() == b"5"


# ---------------------------------------------------------------------------
# the ONNX package
# ---------------------------------------------------------------------------

# ONNX ops of the JAX registry the port refuses by name (each raises
# NotImplementedError naming itself): none
UNPORTED_ONNX_OPS = set()
# JAX method name -> the port's name for the same contract
ONNX_RENAMED = {"as_jax": "as_torch"}


def test_onnx_registry_holds_every_reference_op():
    from synapseml_tpu.onnx.ops import REGISTRY as JREG
    from synapseml_tpu_torch.onnx.ops import REGISTRY as TREG

    assert len(JREG) == 135
    assert set(TREG) == set(JREG)
    for name in UNPORTED_ONNX_OPS:
        with pytest.raises(NotImplementedError, match=name):
            TREG[name](None)


@pytest.mark.parametrize("name", ["OnnxFunction", "ONNXModel",
                                  "ImageFeaturizer", "ONNXHub",
                                  "ONNXModelInfo", "import_model",
                                  "fold_constants", "booster_to_onnx"])
def test_onnx_names_take_every_reference_argument(name):
    import synapseml_tpu.onnx as jonnx
    import synapseml_tpu_torch.onnx as tonnx

    assert set(jonnx.__all__) <= set(tonnx.__all__)
    jobj, tobj = getattr(jonnx, name), getattr(tonnx, name)
    if not inspect.isclass(jobj):
        assert _args(jobj) - _args(tobj) == set()
        return
    if jobj.__init__ is not object.__init__:
        assert _args(jobj.__init__) - _args(tobj.__init__) == set()
    for meth in sorted(_public(jobj)):
        port_name = ONNX_RENAMED.get(meth, meth)
        assert hasattr(tobj, port_name), meth
        jattr = inspect.getattr_static(jobj, meth)
        if isinstance(jattr, property) or not callable(getattr(jobj, meth)):
            continue
        assert _args(getattr(jobj, meth)) \
            - _args(getattr(tobj, port_name)) == set(), meth
    if hasattr(jobj, "_params"):
        assert set(jobj()._params) - set(tobj()._params) == set()
        for p, param in jobj()._params.items():
            assert tobj()._params[p].default == param.default, p


def test_booster_to_onnx_matches_the_reference(boosters):
    """``to_onnx``, once refused by name: the same bytes as the JAX
    package's export of the same trees, and the port's graph scores as
    ``predict`` does (``tests/test_torch_onnx.py`` covers the rest)."""
    from synapseml_tpu_torch.onnx import OnnxFunction

    X, jb, tb = boosters
    model = tb.to_onnx(input_name="rows", num_iteration=2)
    assert model.encode() == jb.to_onnx(input_name="rows",
                                        num_iteration=2).encode()
    fn = OnnxFunction(tb.to_onnx(), device=CPU)
    np.testing.assert_allclose(
        fn({"input": X})["probabilities"].numpy()[:, 1], tb.predict(X),
        rtol=2e-4, atol=2e-5)
