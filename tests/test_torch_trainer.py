"""The port's text trainer and estimators against the JAX package's.

Two ``fit`` steps of a small mask-free encoder (2 layers, hidden 32, 4
heads, S 64, batch 4, dropout 0) with each optimizer, on 4 gloo CPU ranks
(mesh ``{"data": 2, "seq": 2}``, ONE ``torch.multiprocessing.spawn`` for the
file, as in ``test_torch_seq_attention.py``) and in this process, against
``FlaxTrainer`` on the same parameters (carried by
``convert.text_encoder_from_reference``) and batches. Tolerances:

* sgd and momentum: step losses within 1e-5 relative and parameters within
  rtol 1e-4 / atol 1e-6 of the JAX package's. Both sides compute the same
  float32 function in different orders (a few ulps per value), and one
  step of plain or momentum SGD moves a parameter by lr times its
  gradient, so the parameters inherit only those ulps.
* adam and adamw: step losses within 1e-4 relative; parameters are NOT
  compared. Adam's first update is about ``lr * sign(g)``: a gradient near
  zero whose sign differs in float32 noise between the two packages moves
  that parameter by 2 lr in one package against the other, so a tight
  parameter check would chase noise. The optimizer itself is held to optax
  on identical gradient trees instead (updates within 1e-6 relative over 5
  steps, every schedule, ``grad_clip_norm`` and ``freeze_regex``).

On the mesh the parameters must also be bitwise equal across the 4 ranks.

The same spawn holds the training state on meshes (the JAX side on its
virtual mesh of CPU devices): ZeRO (``param_sharding="zero"``) on
``{"data": 2, "seq": 2}`` (the text encoder, momentum, Ulysses attention
through the flash kernels' plain versions) and on ``{"data": 2}`` (ranks
0 and 1, TinyCNN, adam) against ``FlaxTrainer(param_sharding="zero")``,
losses within 1e-5 relative, each rank holding only its blocks at rest;
the ZeRO checkpoint those ranks write loads in the JAX package's
``load_sharded_tree`` (flax's bytes of the same tree), and a ZeRO
checkpoint the JAX package wrote resumes on them (the next epoch's losses
within 1e-5); and a ``[1, 1, 1, 1]`` width-8 ResNet's BatchNorm on
``{"data": 2}`` (ranks 2 and 3, 8 rows each) against the JAX fit of the
global batch of 16, losses within 1e-5 relative and running statistics
within 1e-5 of each tensor's largest magnitude.
"""

import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_waits import join_spawn
from synapseml_tpu_torch.convert import (text_encoder_from_reference,
                                         text_encoder_to_reference)
from synapseml_tpu_torch.dl import TransformerEncoder, hash_tokenize
from synapseml_tpu_torch.dl.trainer import (NonFiniteLossError, Optimizer,
                                            TrainConfig, Trainer)
from synapseml_tpu_torch.parallel import (data_seq_mesh, init_distributed,
                                          make_mesh)

WORLD = 4
SEQ = 2
ENC = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_len=64,
           mask_free=True, dropout=0.0)
BATCH, STEPS, N = 4, 2, 10
# optimizer -> (learning rate, weight decay, seq variant on the mesh)
FITS = {"sgd": (0.05, 0.0, "ring"), "momentum": (0.03, 0.0, "ulysses"),
        "adam": (1e-2, 0.0, "ring"), "adamw": (1e-2, 0.1, "ulysses")}
LOSS_RTOL = {"sgd": 1e-5, "momentum": 1e-5, "adam": 1e-4, "adamw": 1e-4}
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
WORDS = (["good", "great", "fun"], ["bad", "awful", "slow"],
         ["movie", "film", "plot", "acting", "long", "short"])


# the training state on meshes
STATE_RTOL = 1e-5
ZERO_SEQ_OPT = "momentum"
TINY = dict(batch_size=16, max_epochs=2, learning_rate=1e-2, seed=7)
BN_FIT = dict(batch_size=16, max_epochs=1, learning_rate=1e-2,
              optimizer="sgd", seed=7)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 8, 8, 3)).astype(np.float32),
            np.arange(n) % 4)


def _bn_resnet():
    from synapseml_tpu_torch.dl import backbones as tb

    torch.manual_seed(3)
    return tb.ResNet([1, 1, 1, 1], tb.ResNetBlock, 3, width=8,
                     small_images=True)


def _data(n=N, seed=0, max_len=ENC["max_len"]):
    """Balanced labels (alternating), each text drawn from its label's
    words and the neutral ones."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n) % 2
    texts = [" ".join(rng.choice(WORDS[1 - y] + WORDS[2],
                                 int(rng.integers(3, 40)))) for y in labels]
    return texts, hash_tokenize(texts, ENC["vocab_size"], max_len), labels


def _cfg(opt, **kw):
    lr, wd, variant = FITS[opt]
    return TrainConfig(batch_size=BATCH, max_epochs=1, steps_per_epoch=STEPS,
                       learning_rate=lr, weight_decay=wd, optimizer=opt,
                       seed=0, seq_attention=variant, **kw)


def _jax_fit(enc, params, cfg, ids, y, mesh=None, batch_stats=None):
    """(step losses, final flax params) of ``FlaxTrainer``; the trainer is
    ``_jax_fit.last``."""
    import jax

    from synapseml_tpu.dl import trainer as jtrainer

    losses = []

    class _Recorder(jtrainer.NonFiniteGuard):
        def check(self, loss, step):
            losses.append(float(loss))
            return super().check(loss, step)

    jcfg = jtrainer.TrainConfig(**{k: getattr(cfg, k) for k in (
        "batch_size", "max_epochs", "steps_per_epoch", "learning_rate",
        "weight_decay", "optimizer", "seed", "param_sharding",
        "checkpoint_dir", "seq_attention")})
    with mock.patch.object(jtrainer, "NonFiniteGuard", _Recorder):
        tr = jtrainer.FlaxTrainer(enc, jcfg, mesh=mesh).load_params(
            params, batch_stats)
        tr.fit(ids, y)
    _jax_fit.last = tr
    return losses, jax.tree_util.tree_map(np.asarray, tr.params)


def _jax_state_reference(workdir, enc, params, ids, y):
    """The JAX side of the training-state cases: ZeRO fits on the virtual
    meshes (the {"data": 2} one with checkpoints, its epoch-1 checkpoint
    copied for the ranks to resume from) and the ResNet's fit of the
    global batch."""
    import jax

    from synapseml_tpu.dl import backbones as jb
    from synapseml_tpu.parallel import make_mesh as jmesh
    from synapseml_tpu_torch.convert import (resnet_from_reference,
                                             resnet_to_reference)

    losses, _ = _jax_fit(enc, params, _cfg(ZERO_SEQ_OPT,
                                           param_sharding="zero"),
                         ids, y, mesh=jmesh({"data": 2, "seq": 2},
                                            devices=jax.devices()[:4]))
    out = {"zero_seq/losses": np.asarray(losses)}
    X, yt = _images(32, 1)
    tiny = jb.TinyCNN(num_classes=4)
    tparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, x: tiny.init(r, x, train=False))(
        jax.random.PRNGKey(1), X[:1])["params"])
    out.update({f"tiny.{k}": v.numpy() for k, v in
                resnet_from_reference({"params": tparams}).items()})
    jdir = os.path.join(workdir, "jax_zero")
    losses, _ = _jax_fit(tiny, tparams, TrainConfig(
        param_sharding="zero", checkpoint_dir=jdir, **TINY), X, yt,
        mesh=jmesh({"data": 2}, devices=jax.devices()[:2]))
    out["tiny_zero/losses"] = np.asarray(losses)
    resume = os.path.join(workdir, "jax_zero_resume")
    shutil.copytree(jdir, resume)
    for f in os.listdir(resume):
        if f.startswith("ckpt_00000002") or f == "latest":
            os.remove(os.path.join(resume, f))
    variables = resnet_to_reference(_bn_resnet().state_dict())
    Xb, yb = _images(32, 2)
    jres = jb.ResNet([1, 1, 1, 1], jb.ResNetBlock, 3, width=8,
                     small_images=True)
    losses, _ = _jax_fit(jres, variables["params"], TrainConfig(**BN_FIT),
                         Xb, yb % 3, batch_stats=variables["batch_stats"])
    out["bn/losses"] = np.asarray(losses)
    stats = jax.tree_util.tree_map(np.asarray, _jax_fit.last.batch_stats)
    out.update({f"bn.{k}": v.numpy() for k, v in resnet_from_reference(
        {"batch_stats": stats}).items()})
    return out


def _jax_reference(path):
    """Inputs, initial parameters and FlaxTrainer's results, in one npz."""
    import jax

    from synapseml_tpu.dl import text as jtext

    _, ids, y = _data()
    enc = jtext.TransformerEncoder(**ENC)
    params = jax.jit(lambda r, i: enc.init(r, i, train=False))(
        jax.random.PRNGKey(0), ids)["params"]
    data = {"ids": ids, "y": y}
    data.update({f"init.{k}": v.numpy() for k, v in
                 text_encoder_from_reference(params).items()})
    for opt in FITS:
        losses, final = _jax_fit(enc, params, _cfg(opt), ids, y)
        data[f"{opt}/losses"] = np.asarray(losses)
        data.update({f"{opt}.{k}": v.numpy() for k, v in
                     text_encoder_from_reference(final).items()})
    data.update(_jax_state_reference(os.path.dirname(path), enc, params,
                                     ids, y))
    np.savez(path, **data)


def _state(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files
            if k.startswith(prefix)}


def _port_fit(data, opt, mesh=None, **kw):
    enc = TransformerEncoder(**ENC)
    enc.load_state_dict(_state(data, "init."))
    tr = Trainer(enc, _cfg(opt, **kw), mesh=mesh, device="cpu")
    tr.fit(data["ids"], data["y"])
    return tr


def _rank_state(rank, workdir, data, mesh4):
    """The training-state cases of one rank: ZeRO with the seq axis on the
    4-rank mesh; then ranks 0 and 1 run TinyCNN ZeRO on their {"data": 2}
    mesh (a fresh fit with checkpoints, and a resume from the JAX
    package's checkpoint), ranks 2 and 3 the ResNet on theirs."""
    from synapseml_tpu_torch.core.serialization import to_bytes
    from synapseml_tpu_torch.dl import make_backbone

    tr = _port_fit(data, ZERO_SEQ_OPT, mesh4, param_sharding="zero")
    out = {"zero_seq/losses": np.asarray([s["loss"]
                                          for s in tr.step_stats]),
           "zero_seq/blocks": np.asarray([p.numel()
                                          for p in tr.optimizer.params])}
    meshes = [make_mesh({"data": 2}, device="cpu", ranks=r)
              for r in ([0, 1], [2, 3])]
    mesh = meshes[rank // 2]
    if rank < 2:
        X, y = _images(32, 1)
        for tag, ckdir in (("tiny_zero", "port_zero"),
                           ("tiny_resume", "jax_zero_resume")):
            net = make_backbone("tiny", 4)
            net.load_state_dict(_state(data, "tiny."))
            rest = []
            tr = Trainer(net, TrainConfig(
                param_sharding="zero",
                checkpoint_dir=os.path.join(workdir, ckdir), **TINY),
                mesh=mesh, device="cpu")
            tr.fit(X, y, log_fn=lambda ep: rest.append(
                [p.numel() for p in net.parameters()]))
            out[f"{tag}/losses"] = np.asarray([s["loss"]
                                               for s in tr.step_stats])
            if tag == "tiny_zero":
                out["tiny_zero/rest"] = np.asarray(rest[-1])
                out["tiny_zero/dims"] = np.asarray(
                    [-1 if s.dim is None else s.dim for s in tr.specs])
                out["tiny_zero/blocks"] = np.asarray(
                    [p.numel() for p in tr.optimizer.params])
                state = to_bytes(tr.state_tree())
                if rank == 0:
                    with open(os.path.join(workdir, "port_zero.msgpack"),
                              "wb") as f:
                        f.write(state)
    else:
        X, y = _images(32, 2)
        net = _bn_resnet()
        tr = Trainer(net, TrainConfig(**BN_FIT), mesh=mesh, device="cpu")
        tr.fit(X, y % 3)
        out["bn/losses"] = np.asarray([s["loss"] for s in tr.step_stats])
        out.update({f"bn.{k}": v.numpy() for k, v in net.named_buffers()})
    return out


def _grad_norms(tr):
    """(steps, parameters) gradient norms of a fit, parameters in
    ``named_parameters`` order."""
    names = [n for n, _ in tr.model.named_parameters()]
    return np.asarray([[st["grad_norms"][n] for n in names]
                       for st in tr.step_stats])


def _rank_main(rank, workdir):
    """One rank: every optimizer's two steps on the {"data": 2, "seq": 2}
    mesh, then the estimator with ``seqParallel=True``. Imports nothing of
    JAX."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.dl.text import DeepTextClassifier

    init_distributed("gloo", os.path.join(workdir, "store"), rank, WORLD,
                     timeout_s=120)
    mesh = data_seq_mesh(SEQ, device="cpu")
    data = np.load(os.path.join(workdir, "inputs.npz"))
    out = {"mesh": np.asarray(str(mesh.shape))}
    for opt in FITS:
        tr = _port_fit(data, opt, mesh)
        out[f"{opt}/losses"] = np.asarray([s["loss"] for s in tr.step_stats])
        out[f"{opt}/variant"] = np.asarray(tr.stats["seq_attention"])
        out.update({f"{opt}.{k}": v.detach().numpy()
                    for k, v in tr.model.state_dict().items()})
        out[f"{opt}/logits"] = tr.predict_logits(data["ids"][:7])
        out[f"{opt}/grad_norms"] = _grad_norms(tr)
    texts, _, labels = _data(12, seed=1, max_len=32)
    est = DeepTextClassifier(vocabSize=64, numLayers=2, numHeads=4,
                             hiddenSize=32, maxTokenLen=32, batchSize=4,
                             maxEpochs=1, learningRate=1e-2, device="cpu",
                             seqParallel=True, seqAxisSize=SEQ,
                             seqAttention="auto")
    table = Table({"text": texts, "label": labels})
    model = est.fit(table)
    out["est/probability"] = np.asarray(model.transform(table)["probability"])
    out["est/variant"] = np.asarray(model.trainer.stats["seq_attention"])
    out.update(_rank_state(rank, workdir, data, mesh))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("trainer_ranks")


@pytest.fixture(scope="module")
def spawned(workdir):
    """(JAX results and inputs, [each rank's results])."""
    _jax_reference(workdir / "inputs.npz")
    join_spawn(mp.start_processes(_rank_main, args=(str(workdir),),
                                  nprocs=WORLD, join=False,
                                  start_method="spawn"),
               what=f"the {WORLD}-rank spawn")
    want = np.load(workdir / "inputs.npz")
    ranks = [np.load(workdir / f"rank{r}.npz") for r in range(WORLD)]
    return want, ranks


@pytest.fixture(scope="module")
def single(spawned):
    """Each optimizer's fit in this process (no mesh)."""
    want, _ = spawned
    return {opt: _port_fit(want, opt) for opt in FITS}


def _param_names(want, opt):
    return [k[len(opt) + 1:] for k in want.files if k.startswith(opt + ".")]


@pytest.mark.parametrize("opt", list(FITS))
def test_mesh_fit_losses_match_flax_trainer(spawned, opt):
    want, ranks = spawned
    assert len(want[f"{opt}/losses"]) == STEPS
    for got in ranks:
        assert str(got[f"{opt}/variant"]) == FITS[opt][2]
        np.testing.assert_allclose(got[f"{opt}/losses"],
                                   want[f"{opt}/losses"],
                                   rtol=LOSS_RTOL[opt], atol=0)


@pytest.mark.parametrize("opt", list(FITS))
def test_single_process_fit_losses_match_flax_trainer(spawned, single, opt):
    want, _ = spawned
    got = [s["loss"] for s in single[opt].step_stats]
    np.testing.assert_allclose(got, want[f"{opt}/losses"],
                               rtol=LOSS_RTOL[opt], atol=0)


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_fit_parameters_match_flax_trainer(spawned, single, opt):
    want, ranks = spawned
    names = _param_names(want, opt)
    assert len(names) == len(dict(single[opt].model.named_parameters()))
    sd = single[opt].model.state_dict()
    for name in names:
        ref = want[f"{opt}.{name}"]
        assert not np.array_equal(ref, want[f"init.{name}"]) or \
            name.startswith("tok_embed")            # every layer moved
        np.testing.assert_allclose(sd[name].numpy(), ref, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        for got in ranks:
            np.testing.assert_allclose(got[f"{opt}.{name}"], ref,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("opt", list(FITS))
def test_mesh_parameters_bitwise_equal_across_ranks(spawned, opt):
    want, ranks = spawned
    for name in _param_names(want, opt):
        for got in ranks[1:]:
            np.testing.assert_array_equal(got[f"{opt}.{name}"],
                                          ranks[0][f"{opt}.{name}"],
                                          err_msg=name)
    for got in ranks[1:]:
        np.testing.assert_array_equal(got[f"{opt}/logits"],
                                      ranks[0][f"{opt}/logits"])


@pytest.mark.parametrize("opt", list(FITS))
def test_mesh_gradient_norms_match_single_process(spawned, single, opt):
    """The gradient each step applies (``step_stats``' ``grad_norms``, after
    the all-reduce) on the mesh against the same step in one process, leaf
    by leaf, at the first step (the same parameters on both sides) within
    the sharded attention's tolerance (rtol 2e-4), plus an absolute 1e-6
    of the whole gradient's norm for the key biases, whose gradient is 0
    in exact arithmetic (a shift of every key shifts a query's scores
    alike, which softmax ignores) and float32 noise here. A missing
    1/world scale (4x), a head summed without it (4x) or shard gradients
    left unsummed (partial norms) are all far outside it."""
    _, ranks = spawned
    ref = _grad_norms(single[opt])
    assert ref.shape[0] == STEPS and (ref > 0).all()
    atol = 1e-6 * float(np.sqrt((ref[0] ** 2).sum()))
    for got in ranks:
        np.testing.assert_array_equal(got[f"{opt}/grad_norms"],
                                      ranks[0][f"{opt}/grad_norms"])
        np.testing.assert_allclose(got[f"{opt}/grad_norms"][0], ref[0],
                                   rtol=2e-4, atol=atol)


def test_mesh_scoring_matches_single_process(spawned, single):
    """``predict_logits`` on the mesh (in the seq scope, 7 rows: a padded
    tail batch) against the single-process model of the same fit."""
    _, ranks = spawned
    got = ranks[0]["sgd/logits"]
    ref = single["sgd"].predict_logits(spawned[0]["ids"][:7])
    assert got.shape == (7, 2)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_estimator_on_the_mesh(spawned):
    _, ranks = spawned
    assert all(str(r["mesh"]) == "{'data': 2, 'seq': 2}" for r in ranks)
    for got in ranks:
        assert str(got["est/variant"]) == "ring"     # the analytic prior
        np.testing.assert_array_equal(got["est/probability"],
                                      ranks[0]["est/probability"])
    p = ranks[0]["est/probability"]
    assert p.shape == (12, 2) and np.all(np.isfinite(p))
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-6)


def _rel(got, want):
    return np.abs(np.asarray(got) - want) / np.abs(want)


def test_zero_with_the_seq_axis_matches_flax_trainer(spawned):
    want, ranks = spawned
    ref = want["zero_seq/losses"]
    assert len(ref) == STEPS
    for got in ranks:
        assert _rel(got["zero_seq/losses"], ref).max() <= STATE_RTOL
        np.testing.assert_array_equal(got["zero_seq/losses"],
                                      ranks[0]["zero_seq/losses"])
    # each rank holds the blocks of its data index
    from synapseml_tpu_torch.parallel import zero_shard_dim

    shapes = [want[f"init.{n}"].shape
              for n, _ in TransformerEncoder(**ENC).named_parameters()]
    blocks = [int(np.prod(s)) // (2 if zero_shard_dim(s, 2) is not None
                                  else 1) for s in shapes]
    for got in ranks:
        assert got["zero_seq/blocks"].tolist() == blocks


def test_zero_on_a_data_mesh_matches_flax_trainer(spawned):
    want, ranks = spawned
    ref = want["tiny_zero/losses"]
    assert len(ref) == 4
    for got in ranks[:2]:
        assert _rel(got["tiny_zero/losses"], ref).max() <= STATE_RTOL


def test_zero_ranks_hold_only_their_blocks(spawned):
    """At rest (after each epoch) the model holds no sharded parameter and
    the optimizer one block per tensor, cut where the JAX package's
    ``zero_sharding`` cuts."""
    import jax

    from synapseml_tpu.parallel import make_mesh as jmesh
    from synapseml_tpu.parallel.mesh import zero_sharding
    from synapseml_tpu_torch.dl import make_backbone

    want, ranks = spawned
    names = [n for n, _ in make_backbone("tiny", 4).named_parameters()]
    mesh = jmesh({"data": 2}, devices=jax.devices()[:2])
    for got in ranks[:2]:
        dims = got["tiny_zero/dims"]
        assert (dims >= 0).any()
        for name, dim, rest, block in zip(
                names, dims, got["tiny_zero/rest"], got["tiny_zero/blocks"]):
            x = want[f"tiny.{name}"]
            spec = zero_sharding(mesh, x).spec
            jdim = next((i for i, a in enumerate(spec) if a), -1)
            assert dim == jdim, name
            assert rest == (0 if dim >= 0 else x.size), name
            assert block == (x.size // 2 if dim >= 0 else x.size), name


def test_port_zero_checkpoint_loads_in_the_jax_package(spawned, workdir):
    import jax
    from flax.serialization import to_bytes

    from synapseml_tpu.core.checkpoint import (CheckpointStore,
                                               load_sharded_tree)
    from synapseml_tpu.dl import trainer as jtrainer

    want, _ = spawned
    names = [k[len("tiny."):] for k in want.files if k.startswith("tiny.")]
    from flax import traverse_util

    params = jax.tree_util.tree_map(np.asarray, traverse_util.unflatten_dict(
        {n.replace(".", "/"): want[f"tiny.{n}"] for n in names}, sep="/"))
    tx = jtrainer._make_tx(jtrainer.TrainConfig(**TINY), 4)
    template = {"params": params, "batch_stats": {},
                "opt_state": tx.init(params)}
    out = load_sharded_tree(CheckpointStore(str(workdir / "port_zero")),
                            template)
    assert out is not None
    tree, step, meta = out
    assert step == 2 and meta["format"] == "sharded"
    # the rank's gathered state_tree() keys its top level in this order
    tree = {k: tree[k] for k in ("params", "batch_stats", "opt_state")}
    assert to_bytes(tree) == (workdir / "port_zero.msgpack").read_bytes()


def test_jax_zero_checkpoint_resumes_on_the_ranks(spawned):
    want, ranks = spawned
    ref = want["tiny_zero/losses"][2:]
    for got in ranks[:2]:
        assert len(got["tiny_resume/losses"]) == 2
        assert _rel(got["tiny_resume/losses"], ref).max() <= STATE_RTOL


def test_batchnorm_on_a_data_mesh_matches_the_global_batch(spawned):
    want, ranks = spawned
    ref = want["bn/losses"]
    assert len(ref) == 2
    stats = [k[3:] for k in want.files if k.startswith("bn.")]
    assert stats
    for got in ranks[2:]:
        assert _rel(got["bn/losses"], ref).max() <= STATE_RTOL
        for k in stats:
            w = want[f"bn.{k}"]
            gap = np.abs(got[f"bn.{k}"] - w).max() / np.abs(w).max()
            assert gap <= STATE_RTOL, k
            np.testing.assert_array_equal(got[f"bn.{k}"],
                                          ranks[2][f"bn.{k}"])


# ---------------------------------------------------------------------------
# The optimizer alone against optax
# ---------------------------------------------------------------------------

OPT_NAMES = ["tok_embed.embedding", "attn_0.query.kernel", "attn_0.query.bias",
             "Dense_0.kernel", "head.bias"]
OPT_SHAPES = [(16, 8), (8, 2, 4), (2, 4), (8, 32), (3,)]
SCHEDULES = [dict(lr_schedule="constant"),
             dict(lr_schedule="constant", warmup_steps=2),
             dict(lr_schedule="cosine"),
             dict(lr_schedule="cosine", warmup_steps=3)]


def _optax_updates(cfg, params, grads_per_step, total):
    """Each step's updates from the JAX package's ``_make_tx``."""
    import jax
    import optax
    from flax import traverse_util

    from synapseml_tpu.dl.trainer import _make_tx, freeze_mask as jfreeze

    tree = traverse_util.unflatten_dict(
        {n.replace(".", "/"): p for n, p in params.items()}, sep="/")
    tx = _make_tx(cfg, total, jfreeze(tree, cfg.freeze_regex))
    state = tx.init(tree)
    out = []
    for grads in grads_per_step:
        g = traverse_util.unflatten_dict(
            {n.replace(".", "/"): v for n, v in grads.items()}, sep="/")
        upd, state = tx.update(g, state, tree)
        tree = optax.apply_updates(tree, upd)
        flat = traverse_util.flatten_dict(jax.tree_util.tree_map(
            np.asarray, upd), sep="/")
        out.append({n: flat[n.replace(".", "/")] for n in params})
    return out


def _port_updates(cfg, params, grads_per_step, total):
    named = [(n, torch.from_numpy(p.copy())) for n, p in params.items()]
    opt = Optimizer(cfg, total, named)
    out = []
    for grads in grads_per_step:
        ups = opt.updates([torch.from_numpy(grads[n]) for n, _ in named])
        out.append({n: u.numpy().copy() for (n, _), u in zip(named, ups)})
        with torch.no_grad():
            for (_, p), u in zip(named, ups):
                p.add_(u)
    return out


def _opt_case(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in zip(OPT_NAMES, OPT_SHAPES)}
    grads = [{n: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 1))
              .astype(np.float32) for n, s in zip(OPT_NAMES, OPT_SHAPES)}
             for _ in range(steps)]
    return params, grads


def _assert_updates_close(got, want):
    for step, (g, w) in enumerate(zip(got, want)):
        for n in w:
            scale = float(np.abs(w[n]).max())
            np.testing.assert_allclose(g[n], w[n], rtol=1e-6,
                                       atol=1e-6 * scale,
                                       err_msg=f"step {step} {n}")


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("sched", range(len(SCHEDULES)))
@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd", "momentum"])
def test_optimizer_updates_match_optax(opt, sched, clip):
    from synapseml_tpu.dl.trainer import TrainConfig as JConfig

    kw = dict(optimizer=opt, learning_rate=3e-2, grad_clip_norm=clip,
              weight_decay=0.05 if opt == "adamw" else 0.0, **SCHEDULES[sched])
    params, grads = _opt_case(sched)
    total = 5
    want = _optax_updates(JConfig(**kw), params, grads, total)
    got = _port_updates(TrainConfig(**kw), params, grads, total)
    if SCHEDULES[sched]["lr_schedule"] == "cosine":
        # optax's step counting: learning rate 0 at the first update
        assert all(not w.any() for w in want[0].values())
        assert all(not g.any() for g in got[0].values())
    _assert_updates_close(got, want)


def test_freeze_regex_keeps_frozen_leaves_under_adamw_decay():
    """Frozen leaves (matched on the '/'-joined flax path) stay put under
    adamw's decay, and the clip norm still counts their gradients."""
    from synapseml_tpu.dl.trainer import TrainConfig as JConfig

    kw = dict(optimizer="adamw", learning_rate=5e-2, weight_decay=0.2,
              grad_clip_norm=0.3, freeze_regex=r"^(tok_embed|attn_0/query)/")
    params, grads = _opt_case(7)
    want = _optax_updates(JConfig(**kw), params, grads, 5)
    got = _port_updates(TrainConfig(**kw), params, grads, 5)
    _assert_updates_close(got, want)
    frozen = ["tok_embed.embedding", "attn_0.query.kernel",
              "attn_0.query.bias"]
    for step in got:
        for n in frozen:
            assert not step[n].any()
        assert step["Dense_0.kernel"].any()


# ---------------------------------------------------------------------------
# bf16, dropout, the estimator in one process, what is refused
# ---------------------------------------------------------------------------

# bfloat16 keeps 8 significand bits: each rounding is within 2^-9 relative
# (3.9e-3 for values near 1 is 2^-8 times the value, one bf16 ulp). Both
# packages round the same values at the same points (inputs and kernels
# cast per layer, LayerNorm in float32, the float32 head), but their
# float32 accumulations and softmax/gelu internals differ, so a value can
# land one ulp apart after any of the 2 layers' ~10 roundings. Logits are
# about 1 in size; 2 layers x 10 roundings x 2^-8 gives 0.08, and the
# LayerNorm before the head renormalises, so the tolerance is atol 0.08 on
# logits, about 20x the float32 path's own error. The float32 encoder on the
# same weights must be within 5e-6 of JAX; the bf16 one must differ from the
# float32 one (it really ran in bf16).
BF16_ATOL = 0.08


def test_bfloat16_encoder_logits_match_jax():
    import jax
    import jax.numpy as jnp

    from synapseml_tpu.dl import text as jtext

    _, ids, _ = _data(8, seed=3)
    cfg = dict(ENC, mask_free=False, dropout=0.1)
    jf = jtext.TransformerEncoder(**cfg)
    jb = jtext.TransformerEncoder(**cfg, dtype=jnp.bfloat16)
    params = jax.jit(lambda r, i: jf.init(r, i, train=False))(
        jax.random.PRNGKey(5), ids)
    want_f = np.asarray(jax.jit(lambda p, i: jf.apply(p, i, train=False))(
        params, ids))
    want_b = np.asarray(jax.jit(lambda p, i: jb.apply(p, i, train=False))(
        params, ids)).astype(np.float32)
    sd = text_encoder_from_reference(jax.tree_util.tree_map(np.asarray,
                                                            params))
    got = {}
    for name, dt in (("f", torch.float32), ("b", torch.bfloat16)):
        m = TransformerEncoder(**cfg, dtype=dt)
        m.load_state_dict(sd)
        with torch.no_grad():
            got[name] = m(torch.from_numpy(ids)).numpy()
    assert got["b"].dtype == np.float32            # the head is float32
    np.testing.assert_allclose(got["f"], want_f, rtol=5e-6, atol=5e-6)
    np.testing.assert_allclose(got["b"], want_b, rtol=0, atol=BF16_ATOL)
    assert np.abs(got["b"] - got["f"]).max() > 1e-4


def test_attention_dropout_keep_rate_and_broadcast_mask():
    """One (1, 1, Sq, Sk) mask shared by batch and heads, keep rate within
    3 sigma of 1 - rate, survivors scaled by 1 / (1 - rate), the same mask
    for the same generator seed."""
    from synapseml_tpu_torch.dl.layers import dot_product_attention

    rate, B, S, H, D = 0.3, 3, 64, 4, 8
    torch.manual_seed(0)
    q, k = torch.randn(B, S, H, D), torch.randn(B, S, H, D)
    # v holds one-hot keys: the output is the attention weights themselves
    v = torch.eye(S).reshape(1, S, 1, S).expand(B, S, H, S).contiguous()
    got = dot_product_attention(q, k, v, dropout_rate=rate,
                                generator=torch.Generator().manual_seed(11))
    full = dot_product_attention(q, k, v)
    kept = got != 0                                  # (B, Sq, H, Sk)
    assert torch.equal(kept, kept[:1, :, :1].expand_as(kept))
    frac = kept[0, :, 0].float().mean().item()
    sigma = (rate * (1 - rate) / (S * S)) ** 0.5
    assert abs(frac - (1 - rate)) < 3 * sigma
    torch.testing.assert_close(got[kept], full[kept] / (1 - rate))
    again = dot_product_attention(q, k, v, dropout_rate=rate,
                                  generator=torch.Generator().manual_seed(11))
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="Generator"):
        dot_product_attention(q, k, v, dropout_rate=rate)


def test_dropout_trains_and_is_seeded_by_step():
    """A dropout encoder trains (masks from (seed, step)) and two fits give
    the same parameters."""
    _, ids, y = _data(12, seed=2)
    sds = []
    for _ in range(2):
        torch.manual_seed(1)
        m = TransformerEncoder(**dict(ENC, mask_free=False, dropout=0.2))
        tr = Trainer(m, TrainConfig(batch_size=4, learning_rate=1e-2),
                     device="cpu").fit(ids, y)
        assert len(tr.step_stats) == 3
        sds.append(m.state_dict())
    for k in sds[0]:
        torch.testing.assert_close(sds[0][k], sds[1][k], rtol=0, atol=0)


def test_accum_steps_sums_microbatch_gradients():
    """``accum_steps=2`` without dropout: the same step as one batch (the
    loss is a mean over rows, the gradients averaged over microbatches)."""
    _, ids, y = _data(8, seed=4)
    sds = []
    for accum in (1, 2):
        torch.manual_seed(2)
        m = TransformerEncoder(**ENC)
        Trainer(m, TrainConfig(batch_size=4, learning_rate=0.5,
                               optimizer="sgd", accum_steps=accum),
                device="cpu").fit(ids, y)
        sds.append(m.state_dict())
    for k in sds[0]:
        torch.testing.assert_close(sds[0][k], sds[1][k], rtol=1e-5,
                                   atol=1e-6)


def test_text_classifier_fit_transform_save_load(tmp_path):
    from synapseml_tpu_torch.core import PipelineStage, Table
    from synapseml_tpu_torch.dl.text import DeepTextClassifier

    texts, _, labels = _data(24, seed=5, max_len=32)
    table = Table({"text": texts, "label": np.where(labels, "pos", "neg")})
    est = DeepTextClassifier(vocabSize=64, numLayers=2, numHeads=4,
                             hiddenSize=32, maxTokenLen=32, batchSize=8,
                             maxEpochs=3, learningRate=1e-2, device="cpu")
    model = est.fit(table)
    hist = model.trainer.history
    assert len(hist) == 3 and hist[-1]["loss"] < hist[0]["loss"]
    out = model.transform(table)
    p = np.asarray(out["probability"])
    assert p.shape == (24, 2)
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-6)
    assert set(np.asarray(out["prediction"])) <= {"pos", "neg"}
    model.save(str(tmp_path / "m"))
    loaded = PipelineStage.load(str(tmp_path / "m"))
    out2 = loaded.transform(table)
    np.testing.assert_array_equal(np.asarray(out2["probability"]), p)
    np.testing.assert_array_equal(np.asarray(out2["prediction"]),
                                  np.asarray(out["prediction"]))
    # the saved parameters are flax's {"params": tree} in msgpack
    from synapseml_tpu_torch.core.serialization import msgpack_restore

    tree = msgpack_restore((tmp_path / "m" / "params.msgpack").read_bytes())
    assert list(tree) == ["params"]
    assert tree["params"]["attn_0"]["query"]["kernel"].shape == (32, 4, 8)
    assert tree["params"]["tok_embed"]["embedding"].shape == (64, 32)


def test_text_model_parameters_round_trip_to_the_flax_tree():
    m = TransformerEncoder(**ENC)
    tree = text_encoder_to_reference(m.state_dict())
    assert tree["attn_1"]["out"]["kernel"].shape == (4, 8, 32)
    back = text_encoder_from_reference(tree)
    for k, v in m.state_dict().items():
        assert torch.equal(back[k], v)


def test_unported_settings_are_refused():
    from synapseml_tpu_torch.dl.text import DeepTextClassifier

    with pytest.raises(NotImplementedError, match="checkpoint"):
        DeepTextClassifier(checkpoint="/some/hf/dir")
    est = DeepTextClassifier(device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        est.set("checkpoint", "/some/hf/dir")
    _, ids, y = _data(8)
    # pipeline parallelism is ported (tests/test_torch_pipeline.py): a
    # model that is not a StageSequential gets the JAX package's ValueError
    assert Trainer.unported(TrainConfig(param_sharding="pipeline")) == []
    tr = Trainer(TransformerEncoder(**ENC),
                 TrainConfig(param_sharding="pipeline"), device="cpu")
    with pytest.raises(ValueError, match="StageSequential"):
        tr.fit(ids, y)


def test_nonfinite_loss_raises():
    """The raise policy counts ``train.nonfinite_loss`` and raises with the
    JAX package's message."""
    from synapseml_tpu_torch.core.logging import (failure_counts,
                                                  reset_failure_counts)

    _, ids, y = _data(8)
    m = TransformerEncoder(**ENC)
    with torch.no_grad():
        m.head.bias.fill_(float("nan"))
    reset_failure_counts()
    with pytest.raises(NonFiniteLossError, match="non-finite training loss"):
        Trainer(m, TrainConfig(batch_size=4), device="cpu").fit(ids, y)
    assert failure_counts().get("train.nonfinite_loss", 0) == 1
    reset_failure_counts()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(TransformerEncoder(**ENC), TrainConfig())


def test_seq_attention_prior_matches_jax_analytic_arm():
    """The port's prior picks the arm of the JAX package's analytic costs
    (ring: its rotations are half hidden; Ulysses only when heads divide),
    and its costs stand in the JAX package's ratio for every shape."""
    from synapseml_tpu.core import perfmodel as jperf
    from synapseml_tpu_torch.core.perfmodel import suggest_seq_attention

    for S, H, p in ((8192, 8, 2), (64, 3, 2), (4096, 4, 4)):
        arm, info = suggest_seq_attention(H, p)
        assert arm == "ring"
        assert ("ulysses" in info["analytic_E"]) == (H % p == 0)
        _, dec = jperf.suggest_seq_attention(S, H, p, head_dim=32, batch=4)
        want = {c["arm"]: c["predicted_s"] for c in dec.candidates
                if c["source"] == "analytic"}
        assert set(want) == set(info["analytic_E"])
        for a, cost in info["analytic_E"].items():
            assert cost / info["analytic_E"]["ring"] == pytest.approx(
                want[a] / want["ring"], rel=1e-12)


def test_init_draws_the_same_parameters_from_the_seed():
    """``Trainer.init`` redraws every parameter from ``cfg.seed``: the same
    values for the same seed (what every rank gets), others for another,
    LayerNorm at (1, 0) and biases at 0 as flax initialises them."""
    def drawn(seed):
        m = TransformerEncoder(**ENC)
        Trainer(m, TrainConfig(seed=seed), device="cpu").init()
        return m.state_dict()

    a, b, c = drawn(3), drawn(3), drawn(4)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["attn_0.query.kernel"], c["attn_0.query.kernel"])
    assert torch.equal(a["LayerNorm_0.scale"], torch.ones(32))
    assert not a["Dense_1.bias"].any()
    assert float(a["pos_embed"].std()) == pytest.approx(0.02, rel=0.1)


def test_validation_set_is_scored_each_epoch():
    """``fit(valid=...)`` adds each epoch's accuracy on the validation rows
    (``evaluate``), as ``FlaxTrainer`` does."""
    _, ids, y = _data(12, seed=6)
    tr = Trainer(TransformerEncoder(**ENC), TrainConfig(batch_size=4,
                                                        max_epochs=2),
                 device="cpu").fit(ids[:8], y[:8], valid=(ids[8:], y[8:]))
    assert [ep["epoch"] for ep in tr.history] == [0, 1]
    for ep in tr.history:
        assert 0.0 <= ep["val_acc"] <= 1.0 and ep["steps"] == 2
    assert tr.evaluate(ids[8:], y[8:]) == tr.history[-1]["val_acc"]
