"""The port's vision path against the JAX package's, on the CPU.

Layers, ResNets, host resize, trainer steps with batch statistics, the
freeze regex and the ``tiny`` estimator fit, each on the same seeded numpy
inputs through both packages (the port with ``device="cpu"``). Parameters
cross as flax variables through ``convert.resnet_to_reference`` (the port
draws them; flax's ``init`` is never compiled). Tolerances:

* convolutions, max-pool, eval forwards: 1e-5 of the output's largest
  magnitude (float32 sums in other orders).
* BatchNorm in bf16: one bf16 ulp (2^-7 relative): both sides normalise in
  float32 from statistics that differ in the last float32 bits, then round.
* ResNet train forwards and batch statistics: held to the JAX package's
  module in float64 (``jax.enable_x64``), within 1e-5 of the largest
  magnitude. The JAX package's own float32 train forward is up to 2e-5 of
  max |logit| from its float64 value at these sizes (XLA's CPU reductions
  in BatchNorm, amplified where a channel's spread is small), the port's
  about 2e-6, so a float32-to-float32 check could not resolve 1e-5.
* trainer steps: losses within 1e-5 relative, batch statistics within 1e-5
  of each tensor's largest magnitude; sgd and momentum parameters within
  1e-4 of it. Adam's normalised update magnifies roundoff in small
  gradients: its first update is ``lr · g / (|g| + 1e-8)``, so an entry
  whose gradient is of order 1e-8 moves by a share of lr that follows the
  gradient's last bits (1.2e-4 and 1.5e-4 of a kernel's largest magnitude
  at lr 1e-3 and 3e-4 here, one entry each). Adam's step (the parameter's
  change) is held per tensor within 1e-3 of its norm instead (at most
  2.5e-4 here; a wrong rule, such as a lost bias correction, a sign or
  eps, is of order 1). The optimizer alone is held to optax in
  ``test_torch_trainer.py``.
* the estimator fit: epoch losses within 1e-5 relative, probabilities
  within 1e-4.
"""

import functools
import os
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.dl import backbones as jb
from synapseml_tpu_torch.convert import (resnet_from_reference,
                                         resnet_to_reference)
from synapseml_tpu_torch.core import PipelineStage, Table
from synapseml_tpu_torch.dl import backbones as tb
from synapseml_tpu_torch.dl import layers as tl
from synapseml_tpu_torch.dl import vision as tv
from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

WIDTH, CLASSES = 8, 5
BLOCKS = {"basic": (jb.ResNetBlock, tb.ResNetBlock),
          "bottleneck": (jb.BottleneckBlock, tb.BottleneckBlock)}
# image side per stem: every BatchNorm sees at least 16 values per channel
STEMS = {"small": (True, 16), "imagenet": (False, 64)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread keeps its CPU
    time (and the suite's, where workers share the cores) to what it
    computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_gap(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _port_resnet(block, small, seed=0, dtype=torch.float32):
    """A [1, 1, 1, 1] ResNet of the port with BatchNorm scales drawn
    around 1 (a zero scale would make a block the identity)."""
    torch.manual_seed(seed)
    m = tb.ResNet([1, 1, 1, 1], block, CLASSES, width=WIDTH, dtype=dtype,
                  small_images=small)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, tl.BatchNorm):
                mod.scale.copy_(1 + 0.5 * torch.randn(
                    mod.scale.shape, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape,
                                                 generator=gen))
    return m


def _jax_resnet(block, small, dtype=jnp.float32):
    return jb.ResNet([1, 1, 1, 1], block, CLASSES, width=WIDTH, dtype=dtype,
                     small_images=small)


def _images(n, side, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, side, side, 3)).astype(np.float32)


# --- layers -----------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n", [6, 7])
def test_conv_same_padding_matches_flax(k, stride, n):
    import flax.linen as nn

    x = _images(2, n, seed=k * 10 + n)[..., :3]
    conv = tl.Conv(3, 5, (k, k), stride)
    conv.bias.data.normal_()
    want = nn.Conv(5, (k, k), (stride, stride), "SAME").apply(
        {"params": {"kernel": conv.kernel.detach().numpy(),
                    "bias": conv.bias.detach().numpy()}}, x)
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert _rel_gap(got, want) <= 1e-5


@pytest.mark.parametrize("n", [8, 9])
def test_max_pool_matches_flax(n):
    import flax.linen as nn

    x = _images(2, n)
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding="SAME")
    got = tl.max_pool(torch.from_numpy(x), (3, 3), (2, 2)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dtype):
    import flax.linen as nn

    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(4, 5, 5, 6)) + 1).astype(np.float32)
    params = {"scale": rng.normal(size=6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, size=6).astype(np.float32)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x, jdt)
    train, mutated = nn.BatchNorm(use_running_average=False, momentum=0.9,
                                  dtype=jdt).apply(
        {"params": params, "batch_stats": stats}, xj,
        mutable=["batch_stats"])
    evaluated = nn.BatchNorm(use_running_average=True, momentum=0.9,
                             dtype=jdt).apply(
        {"params": params, "batch_stats": mutated["batch_stats"]}, xj)
    bn = tl.BatchNorm(6, tdt)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**params, **stats}.items()})
    xt = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        got_train = bn(xt, train=True)
        got_eval = bn(xt, train=False)
    assert got_train.dtype == got_eval.dtype == tdt
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   mutated["batch_stats"][name], rtol=1e-6,
                                   atol=1e-7)
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    for got, want in ((got_train, train), (got_eval, evaluated)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=1e-5)


# --- backbones --------------------------------------------------------------

@pytest.mark.parametrize("stem", list(STEMS))
@pytest.mark.parametrize("block", list(BLOCKS))
def test_resnet_forward_and_batch_stats_match_flax(block, stem):
    jblock, tblock = BLOCKS[block]
    small, side = STEMS[stem]
    x = _images(4, side, seed=2)
    port = _port_resnet(tblock, small)
    variables = resnet_to_reference(port.state_dict())
    with torch.no_grad():
        got_eval = port(torch.from_numpy(x), train=False).numpy()
        got_train = port(torch.from_numpy(x), train=True).numpy()
    got_stats = resnet_to_reference(port.state_dict())["batch_stats"]

    jm = _jax_resnet(jblock, small)
    want_eval = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, x)
    assert _rel_gap(got_eval, want_eval) <= 1e-5
    with jax.enable_x64(True):
        jm64 = _jax_resnet(jblock, small, jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        want_train, mutated = jax.jit(lambda v, x: jm64.apply(
            v, x, train=True, mutable=["batch_stats"]))(
            v64, x.astype(np.float64))
        want_train = np.asarray(want_train, np.float64)
        want_stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), mutated["batch_stats"])
    assert _rel_gap(got_train, want_train) <= 1e-5
    flat_got = jax.tree_util.tree_leaves_with_path(got_stats)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_stats))
    assert len(flat_got) == len(flat_want) > 0
    for path, value in flat_got:
        assert _rel_gap(value, flat_want[path]) <= 1e-5, path


@functools.lru_cache(maxsize=None)
def _flax_shapes(name):
    """(JAX module, ``jax.eval_shape`` of its ``init``: the variables' tree
    of shapes, nothing compiled) of the JAX package's backbone."""
    from synapseml_tpu.dl.backbones import make_backbone as j_make

    jm = j_make(name, 10)
    return jm, jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "tiny"])
def test_state_dict_is_the_flattened_flax_tree(name):
    _, shapes = _flax_shapes(name)
    want = {"/".join([coll] + [p.key for p in path]): tuple(leaf.shape)
            for coll in shapes
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                shapes[coll])}
    port = tb.make_backbone(name, 10)
    flat = resnet_to_reference(port.state_dict(), nested=False)
    assert {k: v.shape for k, v in flat.items()} == want
    assert {n for n, _ in port.named_buffers()} == {
        k.split("/", 1)[1].replace("/", ".") for k in want
        if k.startswith("batch_stats/")}


def test_convert_round_trip_is_bitwise():
    port = _port_resnet(tb.BottleneckBlock, small=False, seed=3)
    sd = port.state_dict()
    for nested in (True, False):
        back = resnet_from_reference(resnet_to_reference(sd, nested=nested))
        assert list(back) == list(sd) or set(back) == set(sd)
        for name, t in sd.items():
            assert torch.equal(back[name], t), name
    fresh = tb.ResNet([1, 1, 1, 1], tb.BottleneckBlock, CLASSES, width=WIDTH)
    fresh.load_state_dict(resnet_from_reference(resnet_to_reference(sd)))
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match="collections"):
        resnet_from_reference({"params": {}, "cache": {"a": np.zeros(1)}})


# --- host preprocessing -----------------------------------------------------

@pytest.mark.parametrize("src,dst", [(32, 224), (64, 24)])
def test_resize_host_matches_jax_image_resize(src, dst):
    img = np.random.default_rng(src).uniform(size=(src, src, 3)).astype(
        np.float32)
    want = jax.image.resize(img, (dst, dst, 3), method="bilinear")
    got = tv._resize_host(img, dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel_gap(got, want) <= 1e-5


def test_resolve_images_matches_jax(tmp_path):
    from PIL import Image

    from synapseml_tpu.dl import vision as jv

    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, size=(3, 12, 12, 3), dtype=np.uint8)
    paths = []
    for i, im in enumerate(u8):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(im).save(paths[-1])
    obj = np.empty(3, dtype=object)
    obj[:] = [u8[0], u8[1, :10, :10], u8[2]]
    cases = [(u8, None), (u8, 20), (u8[..., 0], 16), (obj, 12),
             (np.asarray(paths, dtype=object), 8)]
    for col, size in cases:
        want = jv._normalize(jv._resolve_images(col, size))
        got = tv._normalize(tv._resolve_images(col, size))
        assert got.shape == want.shape and got.dtype == np.float32
        assert _rel_gap(got, want) <= 1e-5, (np.asarray(col).shape, size)


# --- trainer ----------------------------------------------------------------

# (optimizer, learning rate, accum_steps, steps)
TRAINER_CASES = [("sgd", 0.05, 1, 2), ("momentum", 0.03, 2, 2),
                 ("adam", 1e-3, 1, 1), ("adam", 1e-3, 2, 1)]


def _trainer_data(n, seed=5):
    return _images(n, 16, seed), (np.arange(n) % CLASSES).astype(np.int32)


def _jax_trainer_fit(variables, cfg, X, y):
    """(step losses, params, batch_stats) of ``FlaxTrainer``."""
    from synapseml_tpu.dl import trainer as jtrainer

    losses = []

    class _Recorder(jtrainer.NonFiniteGuard):
        def check(self, loss, step):
            losses.append(float(loss))
            return super().check(loss, step)

    jcfg = jtrainer.TrainConfig(**{k: getattr(cfg, k) for k in (
        "batch_size", "max_epochs", "steps_per_epoch", "learning_rate",
        "optimizer", "seed", "accum_steps", "freeze_regex")})
    with mock.patch.object(jtrainer, "NonFiniteGuard", _Recorder):
        tr = jtrainer.FlaxTrainer(_jax_resnet(jb.BottleneckBlock, True),
                                  jcfg)
        tr.load_params(variables["params"], variables["batch_stats"])
        tr.fit(X, y)
    logits = tr.predict_logits(X[:6])
    return losses, resnet_to_reference(resnet_from_reference(
        {"params": tr.params, "batch_stats": tr.batch_stats})), logits


@pytest.mark.parametrize("opt,lr,accum,steps", TRAINER_CASES)
def test_trainer_steps_match_flax_trainer(opt, lr, accum, steps):
    X, y = _trainer_data(8 * steps)
    port = _port_resnet(tb.BottleneckBlock, small=True, seed=6)
    variables = resnet_to_reference(port.state_dict())
    cfg = TrainConfig(batch_size=8, max_epochs=1, steps_per_epoch=steps,
                      learning_rate=lr, optimizer=opt, seed=0,
                      accum_steps=accum,
                      freeze_regex="^(stem_bn|BottleneckBlock_0)/")
    tr = Trainer(port, cfg, device="cpu").fit(X, y)
    want_losses, want, want_logits = _jax_trainer_fit(variables, cfg, X, y)
    got = resnet_to_reference(tr.model.state_dict())
    got_losses = [s["loss"] for s in tr.step_stats]
    assert len(got_losses) == len(want_losses) == steps
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=0)
    before = resnet_to_reference(_port_resnet(
        tb.BottleneckBlock, small=True, seed=6).state_dict())
    for coll in ("batch_stats", "params"):
        start = dict(jax.tree_util.tree_leaves_with_path(before[coll]))
        ref = dict(jax.tree_util.tree_leaves_with_path(want[coll]))
        for path, value in jax.tree_util.tree_leaves_with_path(got[coll]):
            if coll == "batch_stats":
                assert _rel_gap(value, ref[path]) <= 1e-5, path
            elif opt != "adam":
                assert _rel_gap(value, ref[path]) <= 1e-4, path
            else:
                step, want_step = value - start[path], ref[path] - start[path]
                gap = np.linalg.norm(step - want_step)
                assert gap <= 1e-3 * np.linalg.norm(want_step), path
    # frozen leaves keep their parameters; their statistics still move
    for name in ("stem_bn", "BottleneckBlock_0"):
        for leaf, v in jax.tree_util.tree_leaves_with_path(
                got["params"][name]):
            ref = dict(jax.tree_util.tree_leaves_with_path(
                before["params"][name]))[leaf]
            np.testing.assert_array_equal(v, ref)
    assert not np.array_equal(got["batch_stats"]["stem_bn"]["mean"],
                              before["batch_stats"]["stem_bn"]["mean"])
    assert not np.array_equal(got["params"]["head"]["kernel"],
                              before["params"]["head"]["kernel"])
    assert _rel_gap(tr.predict_logits(X[:6]), want_logits) <= 1e-4


def test_load_params_keeps_buffers_not_given():
    port = _port_resnet(tb.ResNetBlock, small=True)
    tr = Trainer(port, TrainConfig(), device="cpu")
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    params = {n: torch.zeros_like(p) for n, p in port.named_parameters()}
    tr.load_params(params)
    assert torch.equal(port.stem_bn.mean, sd["stem_bn.mean"])
    assert torch.count_nonzero(port.stem_conv.kernel) == 0
    stats = {n: torch.full_like(b, 2.0) for n, b in port.named_buffers()}
    tr.load_params(params, stats)
    assert torch.all(port.stem_bn.var == 2.0)
    with pytest.raises(RuntimeError, match="Missing key"):
        tr.load_params({"head.kernel": sd["head.kernel"]})


# --- estimator --------------------------------------------------------------

@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50",
                                  "resnet101"])
def test_freeze_regex_matches_jax(name):
    """The JAX method traces its model once per call; it gets the tree of
    one trace (``jax.eval_shape`` patched) and the port a model on the meta
    device (names only, nothing drawn)."""
    from synapseml_tpu.dl import vision as jv

    jm, variables = _flax_shapes(name)
    with torch.device("meta"):
        port = tb.make_backbone(name, 10)
    with mock.patch.object(jax, "eval_shape", lambda fn: variables):
        for k in (-1, 0, 1, 2, 99):
            want = jv.DeepVisionClassifier(
                additionalLayersToTrain=k)._freeze_regex(
                jm, np.zeros((1, 8, 8, 3), np.float32))
            got = tv.DeepVisionClassifier(
                additionalLayersToTrain=k)._freeze_regex(port)
            assert got == want, (name, k)


def _vision_table(n=24, side=10, seed=7):
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 3
    base = rng.integers(0, 120, size=(n, side, side, 3))
    imgs = (base + 60 * y[:, None, None, None]).astype(np.uint8)
    return imgs, y


def test_tiny_estimator_fit_matches_jax(tmp_path):
    from flax.serialization import to_bytes

    from synapseml_tpu.core import Table as JTable
    from synapseml_tpu.dl import vision as jv

    imgs, y = _vision_table()
    torch.manual_seed(8)
    variables = resnet_to_reference(tb.TinyCNN(3).state_dict())
    variables["batch_stats"] = {}
    msgpack = tmp_path / "init.msgpack"
    msgpack.write_bytes(to_bytes(variables))
    npz = tmp_path / "init.npz"
    np.savez(npz, **resnet_to_reference(resnet_from_reference(variables),
                                        nested=False))
    kw = dict(backbone="tiny", batchSize=8, maxEpochs=2, learningRate=1e-2,
              optimizer="sgd", imageSize=12, validationFraction=0.25)
    jmodel = jv.DeepVisionClassifier(pretrainedPath=str(msgpack), **kw).fit(
        JTable({"image": imgs, "label": y}))
    model = tv.DeepVisionClassifier(pretrainedPath=str(npz), device="cpu",
                                    **kw).fit(Table({"image": imgs,
                                                     "label": y}))
    got = [ep["loss"] for ep in model.trainer.history]
    want = [ep["loss"] for ep in jmodel.trainer.history]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert model.trainer.history[-1]["val_acc"] == \
        jmodel.trainer.history[-1]["val_acc"]
    out = model.transform(Table({"image": imgs}))
    jout = jmodel.transform(JTable({"image": imgs}))
    np.testing.assert_allclose(out["probability"], jout["probability"],
                               rtol=0, atol=1e-4)
    assert out["prediction"].dtype == np.float64
    np.testing.assert_array_equal(out["prediction"], jout["prediction"])


def test_vision_model_save_load_round_trip(tmp_path):
    imgs, y = _vision_table(16, side=8)
    labels = np.asarray(["cat", "dog", "emu"])[y]
    est = tv.DeepVisionClassifier(backbone="resnet18", smallImages=True,
                                  batchSize=8, additionalLayersToTrain=1,
                                  device="cpu")
    model = est.fit(Table({"image": imgs, "label": labels}))
    table = Table({"image": imgs})
    want = model.transform(table)
    model.save(str(tmp_path / "m"))
    from synapseml_tpu_torch.core.serialization import msgpack_restore

    saved = msgpack_restore((tmp_path / "m" / "params.msgpack").read_bytes())
    assert list(saved) == ["params", "batch_stats"]
    assert "kernel" in saved["params"]["stem_conv"]
    assert "var" in saved["batch_stats"]["ResNetBlock_7"]["BatchNorm_1"]
    loaded = PipelineStage.load(str(tmp_path / "m"))
    got = loaded.transform(table)
    assert loaded.getDevice() == "cpu"
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-6)
    assert set(want["prediction"]) <= {"cat", "dog", "emu"}
    # the saved model warm-starts a fit through pretrainedPath
    again = tv.DeepVisionClassifier(
        backbone="resnet18", smallImages=True, batchSize=8, maxEpochs=0,
        device="cpu",
        pretrainedPath=str(tmp_path / "m" / "params.msgpack")).fit(
        Table({"image": imgs, "label": labels}))
    np.testing.assert_allclose(again.transform(table)["probability"],
                               want["probability"], rtol=0, atol=1e-6)


def test_unported_checkpoints_and_mesh_are_refused(tmp_path):
    """What this test once saw refused now loads or fits: a flax msgpack
    ``pretrainedPath``, a model directory the JAX package saved
    (``params.msgpack``, its class named under ``synapseml_tpu.``), the
    ``params.npz`` of the port's earlier versions, and a ResNet with
    BatchNorm fit on a data mesh (here one gloo rank; two ranks against
    the JAX package's global batch are in ``tests/test_torch_trainer.py``'s
    spawn)."""
    import torch.distributed as dist
    from flax.serialization import to_bytes

    from synapseml_tpu.core import Table as JTable
    from synapseml_tpu.dl import vision as jv
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    imgs, y = _vision_table(8)
    table = Table({"image": imgs, "label": y})
    torch.manual_seed(4)
    variables = resnet_to_reference(tb.TinyCNN(3).state_dict())
    variables["batch_stats"] = {}
    blob = tmp_path / "w.msgpack"
    blob.write_bytes(to_bytes(variables))
    est = tv.DeepVisionClassifier(backbone="tiny", device="cpu", maxEpochs=0,
                                  pretrainedPath=str(blob)).fit(table)
    for k, v in resnet_from_reference(variables).items():
        assert torch.equal(est.trainer.model.state_dict()[k], v), k
    jax_dir = tmp_path / "jax_model"
    jmodel = jv.DeepVisionClassifier(backbone="tiny", batchSize=4).fit(
        JTable({"image": imgs, "label": y}))
    jmodel.save(str(jax_dir))
    loaded = PipelineStage.load(str(jax_dir), device="cpu")
    np.testing.assert_allclose(
        loaded.transform(Table({"image": imgs}))["probability"],
        jmodel.transform(JTable({"image": imgs}))["probability"],
        rtol=0, atol=1e-5)
    old = tmp_path / "npz_model"
    est.save(str(old))
    np.savez(old / "params.npz", **resnet_to_reference(
        est.trainer.model.state_dict(), nested=False))
    os.remove(old / "params.msgpack")
    np.testing.assert_array_equal(
        PipelineStage.load(str(old)).transform(table)["probability"],
        est.transform(table)["probability"])
    init_distributed("gloo", str(tmp_path / "store"), 0, 1)
    try:
        X = _images(4, 8)
        fits = []
        for mesh in (make_mesh({"data": 1}, device="cpu"), None):
            tr = Trainer(_port_resnet(tb.ResNetBlock, small=True),
                         TrainConfig(batch_size=4), mesh=mesh, device="cpu")
            fits.append(tr.fit(X, np.zeros(4, np.int32)).step_stats[0]
                        ["loss"])
        assert np.isfinite(fits[0]) and fits[0] == fits[1]
    finally:
        dist.destroy_process_group()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs, y = _vision_table(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.DeepVisionClassifier(backbone="tiny").fit(
            Table({"image": imgs, "label": y}))
    assert tv.DeepVisionModel().getDevice() == "cuda"


def test_chip_smoke_vision_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 11 on the CPU at a small size (a [1, 1, 1, 1]
    width-8 ResNet registered as a backbone, 8x8 images, two fits of 16):
    every check passes, CPU against CPU."""
    monkeypatch.setitem(tb.BACKBONES, "resnet_w8", lambda num_classes, **kw:
                        tb.ResNet([1, 1, 1, 1], tb.ResNetBlock, num_classes,
                                  width=WIDTH, **kw))
    monkeypatch.setattr(cs, "VISION_BACKBONE", "resnet_w8")
    monkeypatch.setattr(cs, "VISION_SIDE", 8)
    monkeypatch.setattr(cs, "VISION_SIZE", 8)
    monkeypatch.setattr(cs, "VISION_OVERFIT_STEPS", 3)
    monkeypatch.setattr(cs, "VISION_FITS", [
        ("fit A", dict(batchSize=8, additionalLayersToTrain=2,
                       precision="float32"), 16),
        ("fit B", dict(batchSize=8, additionalLayersToTrain=-1,
                       precision="bfloat16"), 16)])
    cs.vision_path("cpu")
