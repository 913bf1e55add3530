"""The port's DL training state against the JAX package's, on the CPU.

* ``core/serialization.py``: ``to_bytes`` byte for byte
  ``flax.serialization.to_bytes`` and ``from_bytes`` equal on trees of
  float32, bfloat16, int32, int64 and bool arrays, 0-d scalars, nested
  dicts and lists, empty dicts and namedtuple states, and on chunked
  arrays (both packages' ``MAX_CHUNK_SIZE`` patched small).
* saved models: the TinyCNN and text encoder ``params.msgpack`` of the
  port equal the JAX estimators' for the same weights; a directory the
  JAX package saved loads through the port's ``PipelineStage.load``; the
  committed JAX fixture (``tests/resources/torch_port/tiny_cnn_jax``, the
  card's phase 16 loads it) is what the JAX package writes from its seed.
* the trainer (TinyCNN, ``device="cpu"``): ``TestDLRecovery``'s cases of
  ``tests/test_checkpoint_recovery.py`` on the port's ``Trainer``, kill
  and resume bitwise the uninterrupted fit; ``FlaxTrainer`` checkpoint
  directories for adam, adamw, sgd and momentum with clip and freeze
  resume in the port and the port's in ``FlaxTrainer`` (the next epoch's
  losses within 1e-5 relative of the uninterrupted JAX run's), the port's
  ``state.msgpack`` flax's bytes of the same state; optax's state of
  every optimizer, clip and freeze combination carried in by
  ``convert.trainer_state_from_reference`` (the next update within 1e-6).
  The trainer's ZeRO, global-batch BatchNorm and sharded checkpoints
  across ranks are in ``tests/test_torch_trainer.py``'s spawn; the card's
  phase 16 is rehearsed here at a small size.
"""

import collections
import json
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core import PipelineStage, Table
from synapseml_tpu_torch.core import checkpoint as tck
from synapseml_tpu_torch.core import serialization as ts
from synapseml_tpu_torch.core.logging import (failure_counts,
                                              reset_failure_counts)
from synapseml_tpu_torch.dl import make_backbone
from synapseml_tpu_torch.dl import trainer as tt
from synapseml_tpu_torch.dl import vision as tv

FIXTURE = Path(__file__).resolve().parent / "resources" / "torch_port" / \
    "tiny_cnn_jax"
FIXTURE_TOL = 1e-5
RESUME_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_failure_counts()
    yield
    reset_failure_counts()
    torch.set_num_threads(threads)


# --- the JAX fixture ----------------------------------------------------------

def _fixture_images():
    rng = np.random.default_rng(0)
    y = np.arange(24) % 3
    imgs = (rng.integers(0, 120, (24, 10, 10, 3))
            + 60 * y[:, None, None, None]).astype(np.uint8)
    return imgs, y


def make_jax_fixture(out: Path) -> None:
    """The JAX package's TinyCNN ``DeepVisionClassifier`` (seed 0, two
    adam epochs on 24 uint8 10x10 images) saved to ``out/model``, and
    ``out/inputs.npz``: 8 of the images and the JAX model's logits."""
    from synapseml_tpu.core import Table as JTable
    from synapseml_tpu.dl import vision as jv

    imgs, y = _fixture_images()
    model = jv.DeepVisionClassifier(
        backbone="tiny", batchSize=8, maxEpochs=2, learningRate=1e-2,
        optimizer="adam", seed=0).fit(JTable({"image": imgs, "label": y}))
    model.save(str(out / "model"))
    X = jv._normalize(jv._resolve_images(imgs[:8], None))
    np.savez(out / "inputs.npz", images=imgs[:8],
             logits=np.asarray(model.trainer.predict_logits(X)))


def test_committed_jax_fixture_is_what_the_jax_package_writes(tmp_path):
    """The card's phase 16 loads the committed fixture; regenerated from
    its seed it is the same model (the saved files, ``uid`` aside) and the
    same logits."""
    make_jax_fixture(tmp_path)
    for name in ("params.msgpack", "classes.npy", "arch.json"):
        assert (tmp_path / "model" / name).read_bytes() == \
            (FIXTURE / "model" / name).read_bytes(), name
    meta = [json.loads((d / "model" / "metadata.json").read_text())
            for d in (tmp_path, FIXTURE)]
    assert [(m["class"], m["params"]) for m in meta[0:1]] == \
        [(m["class"], m["params"]) for m in meta[1:]]
    got, want = np.load(tmp_path / "inputs.npz"), np.load(FIXTURE /
                                                          "inputs.npz")
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["logits"], want["logits"])


def test_jax_saved_model_loads_in_the_port():
    """``PipelineStage.load`` maps ``synapseml_tpu.dl.vision.
    DeepVisionModel`` to the port's class without importing the JAX
    package, and the loaded model gives the JAX logits."""
    model = PipelineStage.load(str(FIXTURE / "model"), device="cpu")
    assert type(model) is tv.DeepVisionModel
    fx = np.load(FIXTURE / "inputs.npz")
    X = tv._normalize(tv._resolve_images(fx["images"],
                                         model.getImageSize() or None))
    np.testing.assert_allclose(model.trainer.predict_logits(X), fx["logits"],
                               rtol=0, atol=FIXTURE_TOL)
    out = model.transform(Table({"image": fx["images"]}))
    assert out["probability"].shape == (8, 3)


def test_unknown_jax_class_is_refused_by_name(tmp_path):
    (tmp_path / "metadata.json").write_text(json.dumps({
        "class": "synapseml_tpu.nowhere.Thing", "uid": "x", "params": {}}))
    with pytest.raises(NotImplementedError, match="synapseml_tpu.nowhere"):
        PipelineStage.load(str(tmp_path))


# --- the codec -----------------------------------------------------------------

_NT = collections.namedtuple("_NT", "count mu")
_EMPTY = collections.namedtuple("_EMPTY", "")


def _bf16_pair(rng, shape):
    """The same bfloat16 values for both packages: ml_dtypes' array (JAX)
    and a torch tensor."""
    import jax.numpy as jnp

    j = np.asarray(rng.normal(size=shape)).astype(jnp.bfloat16)
    return j, torch.from_numpy(j.view(np.int16).copy()).view(torch.bfloat16)


def _trees(rng):
    """(JAX-side tree, port-side tree) pairs of the same values."""
    jb, pb = _bf16_pair(rng, (3, 5))
    base = {
        "params": {"b": rng.normal(size=(3, 4)).astype(np.float32),
                   "a": {"k": np.arange(6, dtype=np.int64).reshape(2, 3)}},
        "ints": np.arange(7, dtype=np.int32), "flags": np.array([True,
                                                                  False]),
        "zero_d": np.array(2.5, np.float32), "scalar": np.float32(-1.25),
        "count": np.int32(3), "empty": {}, "none": None,
        "seq": [np.zeros((0, 2), np.float32), {"x": 1}, (2, 3.5)],
        "nt": _NT(np.array(4, np.int32), {"m": np.ones(3, np.float32)}),
        "e": _EMPTY(), "epoch": 12, "neg": -70000, "big": 2 ** 40,
        "f": 0.1, "s": "a" * 40, "blob": b"\x00\x01",
        "wide": {str(i): i for i in range(20)}}
    return dict(base, bf=jb), dict(base, bf=pb)


def test_to_bytes_is_flax_bytes():
    from flax import serialization as fs

    jt, pt = _trees(np.random.default_rng(0))
    assert ts.to_bytes(pt) == fs.to_bytes(jt)


def test_from_bytes_restores_flax_bytes():
    from flax import serialization as fs

    jt, pt = _trees(np.random.default_rng(1))
    data = fs.to_bytes(jt)
    back = ts.from_bytes(pt, data)
    assert ts.to_bytes(back) == data
    assert isinstance(back["nt"], _NT) and isinstance(back["seq"], list)
    assert back["bf"].dtype == torch.bfloat16
    assert torch.equal(back["bf"].view(torch.int16), pt["bf"].view(
        torch.int16))
    np.testing.assert_array_equal(back["params"]["b"], pt["params"]["b"])
    assert back["epoch"] == 12 and back["scalar"] == np.float32(-1.25)
    # flax reads the port's bytes to the same values
    again = fs.from_bytes(jt, ts.to_bytes(pt))
    assert fs.to_bytes(again) == data


def test_chunked_arrays_match_flax():
    from flax import serialization as fs

    rng = np.random.default_rng(2)
    jb, pb = _bf16_pair(rng, (7, 3))
    big = {"w": rng.normal(size=(5, 9)).astype(np.float32),
           "n": {"i": np.arange(40, dtype=np.int64)}}
    with mock.patch.object(fs, "MAX_CHUNK_SIZE", 24), \
            mock.patch.object(ts, "MAX_CHUNK_SIZE", 24):
        data = fs.to_bytes(dict(big, bf=jb))
        assert b"__msgpack_chunked_array__" in data
        assert ts.to_bytes(dict(big, bf=pb)) == data
        back = ts.from_bytes(dict(big, bf=pb), data)
    np.testing.assert_array_equal(back["w"], big["w"])
    np.testing.assert_array_equal(back["n"]["i"], big["n"]["i"])
    assert torch.equal(back["bf"].view(torch.int16), pb.view(torch.int16))


@pytest.mark.parametrize("target,match", [
    ({"params": {"b": np.zeros((3, 4), np.float32), "c": np.zeros(2)}},
     "lacks key 'c'"),
    ({"params": {"b": np.zeros((4, 3), np.float32)}}, "shape|\\(4, 3\\)"),
    ({"params": {"b": np.zeros((3, 4), np.float64)}}, "float64"),
    ({"params": {"b": torch.zeros(3, 4, dtype=torch.int32)}}, "int32")])
def test_from_bytes_checks_names_shapes_and_dtypes(target, match):
    data = ts.to_bytes({"params": {"b": np.ones((3, 4), np.float32)}})
    with pytest.raises(ValueError, match=match):
        ts.from_bytes(target, data)


def test_msgpack_decoder_refuses_trailing_and_truncated_bytes():
    data = ts.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError):
        ts.msgpack_restore(data[:-2])
    with pytest.raises(ValueError):
        ts.msgpack_restore(data + b"\xc0")


# --- saved models ----------------------------------------------------------------

def _vision_data(n=24, side=10):
    rng = np.random.default_rng(5)
    y = np.arange(n) % 3
    return (rng.integers(0, 200, size=(n, side, side, 3))
            .astype(np.uint8), y)


def test_vision_params_msgpack_is_the_jax_estimators(tmp_path):
    """The JAX estimator's fitted TinyCNN carried into the port: the port's
    ``params.msgpack`` equals the JAX model's, byte for byte."""
    from synapseml_tpu.core import Table as JTable
    from synapseml_tpu.dl import vision as jv
    from synapseml_tpu_torch.convert import resnet_from_reference

    imgs, y = _vision_data()
    jmodel = jv.DeepVisionClassifier(backbone="tiny", batchSize=8,
                                     maxEpochs=1, imageSize=12).fit(
        JTable({"image": imgs, "label": y}))
    jmodel.save(str(tmp_path / "jax"))
    import jax

    sd = resnet_from_reference(jax.tree_util.tree_map(np.asarray, {
        "params": jmodel.trainer.params,
        "batch_stats": jmodel.trainer.batch_stats}))
    net = make_backbone("tiny", 3)
    trainer = tt.Trainer(net, tt.TrainConfig(), device="cpu").load_params(sd)
    port = tv.DeepVisionModel(trainer=trainer, classes=jmodel.classes,
                              backbone="tiny", imageSize=12, device="cpu")
    port._input_shape = [12, 12, 3]
    port.save(str(tmp_path / "port"))
    assert (tmp_path / "port" / "params.msgpack").read_bytes() == \
        (tmp_path / "jax" / "params.msgpack").read_bytes()
    loaded = PipelineStage.load(str(tmp_path / "jax"), device="cpu")
    got = loaded.transform(Table({"image": imgs}))["probability"]
    want = jmodel.transform(JTable({"image": imgs}))["probability"]
    np.testing.assert_allclose(got, want, rtol=0, atol=FIXTURE_TOL)


def test_text_params_msgpack_is_the_jax_estimators(tmp_path):
    import jax

    from synapseml_tpu.core import Table as JTable
    from synapseml_tpu.dl import text as jtext
    from synapseml_tpu_torch.convert import text_encoder_from_reference
    from synapseml_tpu_torch.dl.text import DeepTextModel, TransformerEncoder

    texts = [f"good fun {i}" if i % 2 else f"bad slow {i}" for i in range(8)]
    y = np.arange(8) % 2
    kw = dict(vocabSize=64, numLayers=1, numHeads=2, hiddenSize=8,
              maxTokenLen=16, batchSize=4, maxEpochs=1)
    jmodel = jtext.DeepTextClassifier(**kw).fit(
        JTable({"text": texts, "label": y}))
    jmodel.save(str(tmp_path / "jax"))
    enc = TransformerEncoder(vocab_size=64, num_layers=1, num_heads=2,
                             hidden=8, max_len=16, num_classes=2)
    enc.load_state_dict(text_encoder_from_reference(
        jax.tree_util.tree_map(np.asarray, jmodel.trainer.params)))
    port = DeepTextModel(trainer=tt.Trainer(enc, tt.TrainConfig(),
                                            device="cpu"),
                         classes=jmodel.classes, device="cpu",
                         **{k: v for k, v in kw.items() if k != "maxEpochs"})
    port.save(str(tmp_path / "port"))
    assert (tmp_path / "port" / "params.msgpack").read_bytes() == \
        (tmp_path / "jax" / "params.msgpack").read_bytes()
    loaded = PipelineStage.load(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(
        loaded.transform(Table({"text": texts}))["probability"],
        jmodel.transform(JTable({"text": texts}))["probability"],
        rtol=0, atol=FIXTURE_TOL)


# --- the trainer: TestDLRecovery's cases ---------------------------------------

def _dl_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    return X, y


def _trainer(classes=2, **kw):
    torch.manual_seed(11)
    net = make_backbone("tiny", classes)
    return tt.Trainer(net, tt.TrainConfig(batch_size=16, seed=1, **kw),
                      device="cpu")


class _NanBatches:
    """Poison the host batch of each given step once (its first row NaN),
    through the trainer's batch hook, as the JAX package's
    ``testing.chaos_nan_batches`` does."""

    def __init__(self, at_steps):
        self.at_steps, self.poisoned = set(at_steps), []

    def __call__(self, step, xb, yb):
        if step not in self.at_steps:
            return xb, yb
        self.at_steps.discard(step)
        self.poisoned.append(step)
        xb = np.asarray(xb, np.float32).copy()
        xb[0] = np.nan
        return xb, yb

    def __enter__(self):
        tt._CHAOS_BATCH_HOOK = self
        return self

    def __exit__(self, *exc):
        tt._CHAOS_BATCH_HOOK = None


def _preempt_at(phase, step):
    def hook(p, s):
        if p == phase and s == step:
            raise tck.PreemptionError(f"preempted at {p}[{s}]")
    return mock.patch.object(tck, "_PREEMPT_HOOK", hook)


class TestDLRecovery:
    def test_kill_resume_bit_equal(self, tmp_path):
        X, y = _dl_data()
        ref = _trainer(max_epochs=4).fit(X, y)
        d = str(tmp_path / "ck")
        with pytest.raises(tck.PreemptionError), _preempt_at("dl.epoch", 2):
            _trainer(max_epochs=4, checkpoint_dir=d).fit(X, y)
        t = _trainer(max_epochs=4, checkpoint_dir=d).fit(X, y)
        np.testing.assert_array_equal(ref.predict_logits(X),
                                      t.predict_logits(X))
        assert ts.to_bytes(t.state_tree()) == ts.to_bytes(ref.state_tree())
        assert [h["epoch"] for h in t.history] == [2, 3]

    def test_corrupted_latest_falls_back(self, tmp_path):
        from synapseml_tpu.testing import torn_write

        X, y = _dl_data(seed=1)
        d = str(tmp_path / "ck")
        _trainer(max_epochs=3, checkpoint_dir=d).fit(X, y)
        torn_write(d)
        t = _trainer(max_epochs=4, checkpoint_dir=d).fit(X, y)
        assert [h["epoch"] for h in t.history] == [2, 3]
        assert failure_counts().get("checkpoint.fallback", 0) >= 1
        assert np.isfinite(t.predict_logits(X)).all()

    def test_latest_pointing_at_missing_file_falls_back(self, tmp_path):
        X, y = _dl_data(seed=2)
        d = str(tmp_path / "ck")
        _trainer(max_epochs=2, checkpoint_dir=d).fit(X, y)
        with open(os.path.join(d, "latest"), "w") as f:
            f.write("ckpt_00000042")
        t = _trainer(max_epochs=3, checkpoint_dir=d).fit(X, y)
        assert [h["epoch"] for h in t.history] == [2]

    def test_zero_byte_checkpoint_trains_from_scratch(self, tmp_path):
        from synapseml_tpu.testing import torn_write

        X, y = _dl_data(seed=3)
        d = str(tmp_path / "ck")
        _trainer(max_epochs=1, checkpoint_dir=d, keep_checkpoints=1).fit(X,
                                                                         y)
        torn_write(d, keep_bytes=0)
        t = _trainer(max_epochs=2, checkpoint_dir=d).fit(X, y)
        assert [h["epoch"] for h in t.history] == [0, 1]
        assert np.isfinite(t.predict_logits(X)).all()

    def test_pytree_mismatch_actionable_error(self, tmp_path):
        X, y = _dl_data(seed=4)
        d = str(tmp_path / "ck")
        _trainer(max_epochs=1, checkpoint_dir=d).fit(X, y)
        y4 = (np.arange(len(X)) % 4).astype(np.float32)
        with pytest.raises(ValueError, match="resume=False"):
            _trainer(classes=4, max_epochs=1, checkpoint_dir=d).fit(X, y4)
        assert failure_counts().get("checkpoint.pytree_mismatch", 0) >= 1

    def test_retention_bounds_disk(self, tmp_path):
        X, y = _dl_data(seed=5)
        d = str(tmp_path / "ck")
        _trainer(max_epochs=5, checkpoint_dir=d, keep_checkpoints=2).fit(X, y)
        blobs = sorted(f for f in os.listdir(d) if f.endswith(".msgpack"))
        assert blobs == ["ckpt_00000004.state.msgpack",
                         "ckpt_00000005.state.msgpack"]

    def test_nan_raise_policy(self):
        X, y = _dl_data(seed=6)
        with _NanBatches([1]):
            with pytest.raises(tt.NonFiniteLossError, match="non-finite"):
                _trainer(max_epochs=1).fit(X, y)
        assert failure_counts().get("train.nonfinite_loss", 0) == 1

    def test_nan_skip_policy_counts_and_recovers(self):
        X, y = _dl_data(seed=7)
        with _NanBatches([1]) as cb:
            t = _trainer(max_epochs=2, nonfinite_policy="skip").fit(X, y)
        assert cb.poisoned == [1]
        fc = failure_counts()
        assert fc.get("train.nonfinite_loss", 0) == 1
        assert fc.get("train.nonfinite_skipped", 0) == 1
        assert np.isfinite(t.predict_logits(X)).all()
        assert all(np.isfinite(h["loss"]) for h in t.history)
        assert [h["steps"] for h in t.history] == [3, 4]

    def test_nan_skip_leaves_the_state_as_before_the_step(self):
        """A skipped step changes nothing: a fit poisoned at its last step
        ends in the state of the same fit stopped one step earlier."""
        X, y = _dl_data(seed=7)
        with _NanBatches([3]):
            skipped = _trainer(max_epochs=1, nonfinite_policy="skip").fit(
                X, y)
        three = _trainer(max_epochs=1, steps_per_epoch=3).fit(X, y)
        # the constant schedule does not depend on the total step count
        assert ts.to_bytes(skipped.state_tree()) == \
            ts.to_bytes(three.state_tree())

    def test_nan_rollback_policy_restores_checkpoint(self, tmp_path):
        X, y = _dl_data(seed=8)
        d = str(tmp_path / "ck")
        with _NanBatches([5]) as cb:
            t = _trainer(max_epochs=3, nonfinite_policy="rollback",
                         checkpoint_dir=d).fit(X, y)
        assert cb.poisoned == [5]
        assert failure_counts().get("train.nonfinite_rollback", 0) == 1
        assert np.isfinite(t.predict_logits(X)).all()
        assert [h["epoch"] for h in t.history] == [0, 1, 2]
        ref = _trainer(max_epochs=3).fit(X, y)
        np.testing.assert_array_equal(ref.predict_logits(X),
                                      t.predict_logits(X))

    def test_nan_rollback_without_checkpoint_raises_actionable(self):
        X, y = _dl_data(seed=9)
        with _NanBatches([1]):
            with pytest.raises(tt.NonFiniteLossError, match="checkpoint_dir"):
                _trainer(max_epochs=1, nonfinite_policy="rollback").fit(X, y)


def test_resume_false_ignores_the_store(tmp_path):
    X, y = _dl_data(seed=11)
    d = str(tmp_path / "ck")
    _trainer(max_epochs=2, checkpoint_dir=d).fit(X, y)
    t = _trainer(max_epochs=2, checkpoint_dir=d, resume=False).fit(X, y)
    assert [h["epoch"] for h in t.history] == [0, 1]


def test_chip_smoke_dl_state_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 16 on the CPU at a small size (a [1, 1, 1, 1]
    width-8 ResNet registered as a backbone, 8x8 images, its two ranks
    spawned): every check passes, the JAX fixture's included."""
    import functools

    from synapseml_tpu_torch.dl import backbones as tb

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    monkeypatch.setitem(tb.BACKBONES, "resnet_w8", functools.partial(
        tb.ResNet, [1, 1, 1, 1], tb.ResNetBlock, width=8))
    monkeypatch.setattr(cs, "VISION_BACKBONE", "resnet_w8")
    monkeypatch.setattr(cs, "VISION_SIDE", 8)
    monkeypatch.setattr(cs, "VISION_SIZE", 8)
    cs.state_path("cpu")


# --- optax's state layout, carried by convert ----------------------------------

OPT_CASES = [(opt, clip, freeze) for opt in ("adam", "adamw", "sgd",
                                             "momentum")
             for clip in (0.0, 0.5) for freeze in (None, "^Conv_0/")]


@pytest.mark.parametrize("opt,clip,freeze", OPT_CASES)
def test_optimizer_state_is_optax_layout_through_convert(opt, clip, freeze):
    """optax's state after two updates of ``_make_tx``'s chain, carried
    into the port by ``convert.trainer_state_from_reference``: the port's
    ``Optimizer.state_dict()`` is flax's bytes of it, and the next update
    is optax's within 1e-6."""
    import jax
    import optax
    from flax import serialization as fs

    from synapseml_tpu.dl import trainer as jtrainer
    from synapseml_tpu_torch.convert import (resnet_to_reference,
                                             trainer_state_from_reference)

    torch.manual_seed(0)
    net = make_backbone("tiny", 3)
    params = tt.nest_sorted({k: v for k, v in resnet_to_reference(
        net.state_dict(), nested=False).items()})["params"]
    kw = dict(optimizer=opt, learning_rate=1e-2, grad_clip_norm=clip,
              freeze_regex=freeze,
              weight_decay=0.1 if opt == "adamw" else 0.0)
    jcfg = jtrainer.TrainConfig(**kw)
    tx = jtrainer._make_tx(jcfg, 10, jtrainer.freeze_mask(params, freeze))
    state = tx.init(params)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(3)]
    tree = params
    for g in grads[:2]:
        upd, state = tx.update(g, state, tree)
        tree = optax.apply_updates(tree, upd)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    sd, opt_state = trainer_state_from_reference(tree, None, state)
    named = [(n, sd[n].clone()) for n, _ in net.named_parameters()]
    port = tt.Optimizer(tt.TrainConfig(**kw), 10, named)
    port.load_state_dict(opt_state)
    assert port.count == 2
    assert ts.to_bytes(port.state_dict()) == fs.to_bytes(
        jax.tree_util.tree_map(np.asarray, state))
    got = port.updates([torch.from_numpy(
        _leaf(grads[2], n)) for n, _ in named])
    jupd, _ = tx.update(grads[2], state, tree)
    for (n, _), u in zip(named, got):
        w = _leaf(jax.tree_util.tree_map(np.asarray, jupd), n)
        np.testing.assert_allclose(u.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=n)


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


def test_load_params_carries_the_optimizer_state_into_a_fit(tmp_path):
    """``Trainer.load_params(..., opt_state=...)`` hands the state to the
    optimizer the next ``fit`` builds (a fit of no epochs keeps it)."""
    X, y = _dl_data(seed=12)
    src = _trainer(max_epochs=1).fit(X, y)
    state = src.state_tree()
    sd = {n: p.detach().clone() for n, p in src.model.named_parameters()}
    dst = _trainer(max_epochs=0)
    dst.load_params(sd, opt_state=state["opt_state"]).fit(X, y)
    assert ts.to_bytes(dst.state_tree()) == ts.to_bytes(state)


# --- checkpoints across packages ------------------------------------------------

ACROSS = [("adam", {}), ("adamw", dict(weight_decay=0.1)),
          ("sgd", dict(grad_clip_norm=0.5)),
          ("momentum", dict(grad_clip_norm=1.0, freeze_regex="^Conv_0/"))]


def _jax_fit(d, epochs, opt, kw, X, y):
    """``FlaxTrainer`` on TinyCNN with ``checkpoint_dir=d``: its step
    losses (captured by patching ``NonFiniteGuard``)."""
    from synapseml_tpu.dl import FlaxTrainer
    from synapseml_tpu.dl import TrainConfig as JConfig
    from synapseml_tpu.dl import make_backbone as jbackbone
    from synapseml_tpu.dl import trainer as jtrainer

    losses = []

    class _Recorder(jtrainer.NonFiniteGuard):
        def check(self, loss, step):
            losses.append(float(loss))
            return super().check(loss, step)

    with mock.patch.object(jtrainer, "NonFiniteGuard", _Recorder):
        FlaxTrainer(jbackbone("tiny", 2), JConfig(
            batch_size=16, seed=1, max_epochs=epochs, optimizer=opt,
            learning_rate=1e-2, checkpoint_dir=d, **kw)).fit(X, y)
    return losses


def _keep_epoch_1(d):
    for f in os.listdir(d):
        if not f.startswith("ckpt_00000001"):
            os.remove(os.path.join(d, f))


@pytest.mark.parametrize("opt,kw", ACROSS)
def test_flax_trainer_checkpoints_resume_in_the_port_and_back(tmp_path, opt,
                                                             kw):
    """A ``FlaxTrainer`` checkpoint directory (epoch 1 of 3) resumes in the
    port: the restored state's ``state.msgpack`` is flax's bytes of it and
    epoch 1's losses are the uninterrupted JAX run's within 1e-5. The
    epoch-2 checkpoint the port then writes resumes in ``FlaxTrainer``:
    epoch 2's losses within 1e-5 of the same JAX run's."""
    X, y = _dl_data(32, seed=13)
    d = str(tmp_path / "ck")
    want = _jax_fit(d, 3, opt, kw, X, y)
    assert len(want) == 6
    _keep_epoch_1(d)
    with open(os.path.join(d, "ckpt_00000001.state.msgpack"), "rb") as f:
        blob = f.read()

    def port(epochs):
        return tt.Trainer(make_backbone("tiny", 2), tt.TrainConfig(
            batch_size=16, seed=1, max_epochs=epochs, optimizer=opt,
            learning_rate=1e-2, checkpoint_dir=d, **kw), device="cpu")

    restored = port(1).fit(X, y)                  # restore only
    assert ts.to_bytes({**restored.state_tree(), "epoch": 1}) == blob
    resumed = port(2).fit(X, y)
    got = [st["loss"] for st in resumed.step_stats]
    np.testing.assert_allclose(got, want[2:4], rtol=RESUME_RTOL, atol=0)
    assert tck.CheckpointStore(d).latest_step() == 2
    back = _jax_fit(d, 3, opt, kw, X, y)
    np.testing.assert_allclose(back, want[4:], rtol=RESUME_RTOL, atol=0)
