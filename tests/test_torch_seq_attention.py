"""The port's sequence-parallel attention path against the JAX package's.

The multi-rank cases run in ONE ``torch.multiprocessing.spawn`` of 4 CPU
ranks over gloo (a ``FileStore`` under a temporary directory) on the mesh
``{"data": 2, "seq": 2}``. The parent computes the JAX package's outputs on
its virtual CPU mesh of the same shape and writes them, with the inputs and
the parameters carried by ``convert.text_encoder_from_reference``, to an
``.npz``; the ranks never import ``jax`` (this
module imports it only inside parent-side functions, so a rank can import
the module to find its entry point). Each rank writes what it computed; the
tests compare. Tolerance rtol 2e-4 / atol 2e-5 (the JAX suite's own for the
sharded attention): both sides sum in float32 in different orders, and
flax's default attention scales the query before the product where the
sharded path scales the scores after it.

Gradients: each collective's gradient on its rank's block against
``jax.grad`` through the same ``lax`` collective in ``shard_map`` on the
same mesh (to 1e-6: the backward only moves and sums two float32 values),
and the ring and Ulysses self-attention gradients of q, k and v against
``jax.grad`` of the JAX package's ``sharded_self_attention`` (the
tolerance above). The ranks differentiate as the trainer does: each
scales its (global) loss by 1/world, and the gradients are summed over the
world. bfloat16 inputs: both variants against the JAX package's on the
same bf16 q/k/v, within a bound derived from the roundings each side makes
(``test_bf16_sharded_attention_matches_jax``).
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_waits import join_spawn
from synapseml_tpu_torch.convert import text_encoder_from_reference
from synapseml_tpu_torch.dl import (TextClsHead, TextEmbedUnit,
                                    TransformerEncoder, TransformerLayerUnit,
                                    active_seq_mesh, hash_tokenize,
                                    seq_attention_fn, seq_attention_scope,
                                    sharded_self_attention)
from synapseml_tpu_torch.parallel import (init_distributed, make_mesh,
                                          ring_self_attention,
                                          ulysses_self_attention)

RTOL, ATOL = 2e-4, 2e-5
WORLD = 4
MESH = {"data": 2, "seq": 2}
ENC = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_len=32,
           mask_free=True, dropout=0.0)
UNIT = dict(hidden=32, heads=4, mlp_dim=64)
TEXTS = ["the quick brown fox jumps over the lazy dog",
         "sequence parallel attention on two ranks", "",
         "a b c d e f g h i j k l m n o p q r s t u v w x y z 0 1 2 3 4 5 6"]
# (name, function, kwargs, heads, sequence): the attention cases of the spawn
ATTN_CASES = [
    ("ring", "ring", {}, 2, 16), ("ring_causal", "ring", {"causal": True}, 2, 16),
    ("ring_scaled", "ring", {"scale": 0.3}, 2, 16),
    ("ulysses", "ulysses", {}, 4, 16),
    ("ulysses_causal", "ulysses", {"causal": True}, 4, 16),
    ("ulysses_scaled_causal", "ulysses", {"causal": True, "scale": 0.3}, 4,
     16),
]
PADDED_CASES = [(variant, causal) for variant in ("ring", "ulysses")
                for causal in (False, True)]
COLL_TOL = 1e-6
# (name, local output shape): each collective on a (1, 1, 4, 6) block
COLL_CASES = [("all_to_all", (1, 1, 2, 12)), ("ppermute", (1, 1, 4, 6)),
              ("all_gather_seq", (1, 1, 8, 6)),
              ("all_gather_data", (1, 1, 4, 12))]
# (variant, causal, sequence): 15 does not divide the seq axis (padded)
GRAD_CASES = [("ring", False, 16), ("ring", True, 15),
              ("ulysses", True, 16), ("ulysses", False, 15)]
# bfloat16 q/k/v (variant, causal, sequence): the port's kernels take them
# in bf16; see test_bf16_sharded_attention_matches_jax for the tolerance
BF16_CASES = GRAD_CASES


def _qkv(seed, h, s, b=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_collective(name, x):
    """The JAX side of a ``COLL_CASES`` collective on one block."""
    from jax import lax

    if name == "all_to_all":
        return lax.all_to_all(x, "seq", split_axis=2, concat_axis=3,
                              tiled=True)
    if name == "ppermute":
        return lax.ppermute(x, "seq", perm=[(0, 1), (1, 0)])
    if name == "all_gather_seq":
        return lax.all_gather(x, "seq", axis=2, tiled=True)
    return lax.all_gather(x, "data", axis=3, tiled=True)


def _jax_gradients(mesh, data):
    """``jax.grad`` of the collectives and of the sharded attention."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from synapseml_tpu.core.compat import shard_map
    from synapseml_tpu.dl import backbones as jbb

    rng = np.random.default_rng(30)
    spec = P("data", "seq")
    for name, shape in COLL_CASES:
        x = rng.normal(size=(2, 2, 4, 6)).astype(np.float32)
        w = rng.normal(size=(2, 2) + shape[2:]).astype(np.float32)

        def local(xb, wb, name=name):
            return jnp.sum(_jax_collective(name, xb) * wb)[None, None]

        f = shard_map(local, mesh=mesh, in_specs=(spec, spec),
                      out_specs=spec, check_vma=False)
        data.update({f"coll_{name}/x": x, f"coll_{name}/w": w})
        data[f"coll_{name}/grad"] = np.asarray(jax.jit(jax.grad(
            lambda x, w: jnp.sum(f(x, w))))(x, w))
    for i, (variant, causal, n) in enumerate(GRAD_CASES):
        q, k, v = _qkv(40 + i, 4, n)
        w = rng.normal(size=q.shape).astype(np.float32)
        key = f"grad_{variant}_{n}"
        data.update({f"{key}/q": q, f"{key}/k": k, f"{key}/v": v,
                     f"{key}/w": w})
        grads = jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(w * jbb.sharded_self_attention(
                q, k, v, mesh, variant=variant, causal=causal)),
            argnums=(0, 1, 2)))(q, k, v)
        for t, g in zip("qkv", grads):
            data[f"{key}/d{t}"] = np.asarray(g)


def _jax_reference(path):
    """Inputs, flax parameters and the JAX package's outputs, in one npz."""
    import jax
    import jax.numpy as jnp

    from synapseml_tpu.dl import backbones as jbb
    from synapseml_tpu.dl import text as jtext
    from synapseml_tpu.parallel import make_mesh as jmake_mesh
    from synapseml_tpu.parallel.ring_attention import (
        attention_reference, ring_self_attention as jring)
    from synapseml_tpu.parallel.ulysses import ulysses_self_attention as jul

    mesh = jmake_mesh(MESH, devices=jax.devices()[:WORLD])
    data = {}
    for i, (name, fn, kw, h, s) in enumerate(ATTN_CASES):
        q, k, v = _qkv(i, h, s)
        data.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v})
        jfn = jring if fn == "ring" else jul
        data[f"{name}/want"] = np.asarray(jax.jit(
            lambda q, k, v: jfn(q, k, v, mesh, use_flash=False, **kw))(
                q, k, v))
    for i, (variant, causal) in enumerate(PADDED_CASES):
        q, k, v = _qkv(20 + i, 4, 31)           # 31 % 2 != 0 -> pad to 32
        key = f"pad_{variant}_{int(causal)}"
        data.update({f"{key}/q": q, f"{key}/k": k, f"{key}/v": v})
        data[f"{key}/want"] = np.asarray(jax.jit(
            lambda q, k, v: jbb.sharded_self_attention(
                q, k, v, mesh, variant=variant, causal=causal))(q, k, v))
        data[f"{key}/ref"] = np.asarray(attention_reference(q, k, v,
                                                            causal=causal))
    ids = hash_tokenize(TEXTS, ENC["vocab_size"], ENC["max_len"])
    enc = jtext.TransformerEncoder(**ENC)
    enc_params = jax.jit(lambda r, i: enc.init(r, i, train=False))(
        jax.random.PRNGKey(0), ids)
    data["ids"] = ids
    data["ids31"] = ids31 = ids[:, :31]
    data.update({f"enc.{k}": v.numpy() for k, v in
                 text_encoder_from_reference(enc_params).items()})
    unit = jbb.TransformerLayerUnit(**UNIT)
    x = np.random.default_rng(9).normal(size=(4, 32, 32)).astype(np.float32)
    unit_params = jax.jit(lambda r, i: unit.init(r, i, train=False))(
        jax.random.PRNGKey(1), x)
    data["x"] = x
    data.update({f"unit.{k}": v.numpy() for k, v in
                 text_encoder_from_reference(unit_params).items()})
    for variant in ("ring", "ulysses"):
        with jbb.seq_attention_scope(mesh, variant):
            # jit: one compile per model instead of one per eager op
            data[f"enc_{variant}/want"] = np.asarray(jax.jit(
                lambda p, i: enc.apply(p, i, train=False))(enc_params, ids))
            data[f"unit_{variant}/want"] = np.asarray(jax.jit(
                lambda p, i: unit.apply(p, i, train=False))(unit_params, x))
    # 31 tokens: the in-scope encoder pads them to the shard grid; held
    # against the JAX encoder out of scope (one compile fewer)
    data["enc31_ring/want"] = data["enc31_ulysses/want"] = np.asarray(
        jax.jit(lambda p, i: enc.apply(p, i, train=False))(enc_params, ids31))
    for i, (variant, causal, n) in enumerate(BF16_CASES):
        key = f"bf16_{variant}_{n}"
        qkv = [jnp.asarray(x, jnp.bfloat16) for x in _qkv(60 + i, 4, n)]
        data.update({f"{key}/{t}": np.asarray(x.astype(jnp.float32))
                     for t, x in zip("qkv", qkv)})
        data[f"{key}/want"] = np.asarray(jax.jit(
            lambda q, k, v: jbb.sharded_self_attention(
                q, k, v, mesh, variant=variant, causal=causal))(
                    *qkv).astype(jnp.float32))
    _jax_gradients(mesh, data)
    np.savez(path, **data)


def _state_dict(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files
            if k.startswith(prefix)}


def _rank_gradients(mesh, data, out):
    """This rank's side of ``_jax_gradients``."""
    from synapseml_tpu_torch.parallel import (all_gather, all_reduce_sum,
                                              all_to_all, ppermute_next)

    d, s = mesh.axis_index("data"), mesh.axis_index("seq")
    seq, dat = mesh.group("seq"), mesh.group("data")
    fns = {"all_to_all": lambda x: all_to_all(x, seq, 2, 3),
           "ppermute": lambda x: ppermute_next(x, seq),
           "all_gather_seq": lambda x: all_gather(x, seq, axis=2),
           "all_gather_data": lambda x: all_gather(x, dat, axis=3)}
    for name, _ in COLL_CASES:
        blk = (slice(d, d + 1), slice(s, s + 1))
        x = torch.from_numpy(data[f"coll_{name}/x"][blk]).requires_grad_()
        w = torch.from_numpy(data[f"coll_{name}/w"][blk])
        (fns[name](x) * w).sum().backward()
        out[f"coll_{name}"] = x.grad.numpy()
    for variant, causal, n in GRAD_CASES:
        key = f"grad_{variant}_{n}"
        q, k, v = (torch.from_numpy(data[f"{key}/{t}"]).requires_grad_()
                   for t in "qkv")
        o = sharded_self_attention(q, k, v, mesh, variant=variant,
                                   causal=causal)
        ((torch.from_numpy(data[f"{key}/w"]) * o).sum() / WORLD).backward()
        for t, x in zip("qkv", (q, k, v)):
            out[f"{key}/d{t}"] = all_reduce_sum(x.grad).numpy()


def _rank_main(rank, workdir):
    """One rank of the spawn: every case on the {"data": 2, "seq": 2} mesh,
    results written to rank<r>.npz. Imports nothing of JAX."""
    init_distributed("gloo", os.path.join(workdir, "store"), rank, WORLD,
                     timeout_s=120)
    mesh = make_mesh(MESH, device="cpu")
    data = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    d, s = mesh.axis_index("data"), mesh.axis_index("seq")
    for name, fn, kw, h, n in ATTN_CASES:
        rows, cols = slice(2 * d, 2 * d + 2), slice(s * n // 2,
                                                    (s + 1) * n // 2)
        q, k, v = (torch.from_numpy(data[f"{name}/{t}"][rows, cols])
                   for t in "qkv")
        f = ring_self_attention if fn == "ring" else ulysses_self_attention
        out[name] = f(q, k, v, mesh, **kw).numpy()
    for variant, causal in PADDED_CASES:
        key = f"pad_{variant}_{int(causal)}"
        q, k, v = (torch.from_numpy(data[f"{key}/{t}"]) for t in "qkv")
        out[key] = sharded_self_attention(q, k, v, mesh, variant=variant,
                                          causal=causal).numpy()
    for variant, causal, n in BF16_CASES:
        key = f"bf16_{variant}_{n}"
        q, k, v = (torch.from_numpy(data[f"{key}/{t}"]).bfloat16()
                   for t in "qkv")
        out[key] = sharded_self_attention(q, k, v, mesh, variant=variant,
                                          causal=causal).float().numpy()
    three = torch.zeros((2, 8, 3, 4))
    try:
        ulysses_self_attention(three, three, three, mesh)
        out["heads_error"] = np.asarray("")
    except ValueError as e:
        out["heads_error"] = np.asarray(str(e))

    ids = torch.from_numpy(data["ids"])
    enc = TransformerEncoder(**ENC)
    enc.load_state_dict(_state_dict(data, "enc."))
    unit = TransformerLayerUnit(**UNIT)
    unit.load_state_dict(_state_dict(data, "unit."))
    x = torch.from_numpy(data["x"])
    ids31 = torch.from_numpy(data["ids31"])
    with torch.no_grad():
        out["enc_plain"] = enc(ids).numpy()
        out["enc31_plain"] = enc(ids31).numpy()
        out["unit_plain"] = unit(x).numpy()
        for variant in ("ring", "ulysses"):
            with seq_attention_scope(mesh, variant):
                out[f"enc_{variant}"] = enc(ids).numpy()
                out[f"enc31_{variant}"] = enc(ids31).numpy()
                out[f"unit_{variant}"] = unit(x).numpy()
    _rank_gradients(mesh, data, out)
    flat = make_mesh({"data": 4, "seq": 1}, device="cpu")
    with seq_attention_scope(flat, "ring"):
        out["seq1_inactive"] = np.asarray(active_seq_mesh() is None)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(JAX outputs and inputs, [each rank's outputs]) of the one spawn."""
    workdir = tmp_path_factory.mktemp("seq_ranks")
    _jax_reference(workdir / "inputs.npz")
    join_spawn(mp.start_processes(_rank_main, args=(str(workdir),),
                                  nprocs=WORLD, join=False,
                                  start_method="spawn"),
               what=f"the {WORLD}-rank spawn")
    want = np.load(workdir / "inputs.npz")
    ranks = [np.load(workdir / f"rank{r}.npz") for r in range(WORLD)]
    return want, ranks


def _coords(rank):
    return rank // MESH["seq"], rank % MESH["seq"]


@pytest.mark.parametrize("name", [c[0] for c in ATTN_CASES])
def test_seq_attention_shards_match_jax(spawned, name):
    want, ranks = spawned
    n = [c[4] for c in ATTN_CASES if c[0] == name][0]
    full = want[f"{name}/want"]
    for r, got in enumerate(ranks):
        d, s = _coords(r)
        np.testing.assert_allclose(
            got[name], full[2 * d:2 * d + 2, s * n // 2:(s + 1) * n // 2],
            rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant,causal", PADDED_CASES)
def test_non_divisible_sharded_attention_matches_jax(spawned, variant,
                                                     causal):
    want, ranks = spawned
    key = f"pad_{variant}_{int(causal)}"
    for got in ranks:
        assert got[key].shape == want[f"{key}/want"].shape == (4, 31, 4, 8)
        np.testing.assert_allclose(got[key], want[f"{key}/want"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got[key], want[f"{key}/ref"], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("variant,causal,n", BF16_CASES)
def test_bf16_sharded_attention_matches_jax(spawned, variant, causal, n):
    """bfloat16 q/k/v through the port's sharded attention (each kernel's
    plain version: scores in float32, every p rounded to bf16 before the
    PV product, the output in bf16) against the JAX package's
    ``sharded_self_attention`` on the same bf16 inputs. Derived bound on
    |got - want| before the outputs' bf16 rounding: the JAX ring casts to
    float32 first, so only the port's p rounding (2^-9 of each p) differs,
    at most 2^-9 · max |v| as o sums p · v over sum p; the JAX Ulysses
    attends in bf16 throughout, rounding each score (2^-9 · |s|, which
    moves a softmax weight by at most 2 · 2^-9 · max |s| of itself) and
    each p as well, so 2^-8 · max |v| · (max |s| + 1) covers both sides.
    The outputs' own bf16 rounding adds half an ulp each, within 2^-7 of
    |want|."""
    want, ranks = spawned
    key = f"bf16_{variant}_{n}"
    q, k, v = (want[f"{key}/{t}"] for t in "qkv")
    vmax = float(np.abs(v).max())
    if variant == "ring":
        atol = 2.0 ** -9 * vmax
    else:
        smax = float(np.abs(np.einsum("bqhd,bkhd->bhqk", q, k)).max()
                     * q.shape[-1] ** -0.5)
        atol = 2.0 ** -8 * vmax * (smax + 1.0)
    for got in ranks:
        np.testing.assert_allclose(got[key], want[f"{key}/want"],
                                   rtol=2.0 ** -7, atol=atol)


def test_ulysses_refuses_heads_that_do_not_divide(spawned):
    _, ranks = spawned
    for got in ranks:
        assert "heads (3) must divide" in str(got["heads_error"])


@pytest.mark.parametrize("module", ["enc", "enc31", "unit"])
@pytest.mark.parametrize("variant", ["ring", "ulysses"])
def test_in_scope_modules_match_jax_and_out_of_scope(spawned, module,
                                                     variant):
    want, ranks = spawned
    for got in ranks:
        np.testing.assert_allclose(got[f"{module}_{variant}"],
                                   want[f"{module}_{variant}/want"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[f"{module}_{variant}"],
                                   got[f"{module}_plain"], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", [c[0] for c in COLL_CASES])
def test_collective_gradients_match_jax(spawned, name):
    want, ranks = spawned
    for r, got in enumerate(ranks):
        d, s = _coords(r)
        np.testing.assert_allclose(
            got[f"coll_{name}"],
            want[f"coll_{name}/grad"][d:d + 1, s:s + 1], rtol=COLL_TOL,
            atol=COLL_TOL)


@pytest.mark.parametrize("variant,causal,n", GRAD_CASES)
def test_sharded_attention_gradients_match_jax(spawned, variant, causal, n):
    want, ranks = spawned
    key = f"grad_{variant}_{n}"
    for got in ranks:
        for t in "qkv":
            np.testing.assert_allclose(got[f"{key}/d{t}"],
                                       want[f"{key}/d{t}"], rtol=RTOL,
                                       atol=ATOL)


def test_scope_is_inactive_on_a_seq_axis_of_one(spawned):
    _, ranks = spawned
    assert all(bool(got["seq1_inactive"]) for got in ranks)


# ---------------------------------------------------------------------------
# One process: the encoder and units out of scope, the tokenizer
# ---------------------------------------------------------------------------

def test_hash_tokenize_matches_jax():
    from synapseml_tpu.dl.text import hash_tokenize as jtok

    for vocab, max_len in ((64, 8), (32768, 128)):
        np.testing.assert_array_equal(hash_tokenize(TEXTS, vocab, max_len),
                                      jtok(TEXTS, vocab, max_len))


@pytest.mark.parametrize("mask_free", [False, True])
def test_encoder_out_of_scope_matches_jax(mask_free):
    """Masked (the PAD mask) and mask-free, weights carried by the
    converter; logits within 1e-5."""
    import jax

    from synapseml_tpu.dl import text as jtext

    cfg = dict(ENC, mask_free=mask_free, dropout=0.1)
    ids = hash_tokenize(TEXTS, cfg["vocab_size"], cfg["max_len"])
    jm = jtext.TransformerEncoder(**cfg)
    params = jax.jit(lambda r, i: jm.init(r, i, train=False))(
        jax.random.PRNGKey(3), ids)
    want = np.asarray(jax.jit(lambda p, i: jm.apply(p, i, train=False))(
        params, ids))
    tm = TransformerEncoder(**cfg)
    tm.load_state_dict(text_encoder_from_reference(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_units_out_of_scope_match_jax():
    import jax

    from synapseml_tpu.dl import backbones as jbb

    rng = np.random.default_rng(4)
    ids = hash_tokenize(TEXTS, 64, 16)
    x = rng.normal(size=(4, 16, 32)).astype(np.float32)
    cases = [(jbb.TextEmbedUnit(64, 32, 16), TextEmbedUnit(64, 32, 16), ids),
             (jbb.TransformerLayerUnit(**UNIT), TransformerLayerUnit(**UNIT),
              x),
             (jbb.TextClsHead(3), TextClsHead(32, 3), x)]
    for jm, tm, inp in cases:
        params = jax.jit(lambda r, i: jm.init(r, i, train=False))(
            jax.random.PRNGKey(5), inp)
        want = np.asarray(jax.jit(lambda p, i: jm.apply(p, i, train=False))(
            params, inp))
        tm.load_state_dict(text_encoder_from_reference(params))
        with torch.no_grad():
            got = tm(torch.from_numpy(inp)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scoped_attention_refuses_masks_and_dropout():
    assert seq_attention_fn() is None
    with seq_attention_scope(None, "ring"):
        assert active_seq_mesh() is None and seq_attention_fn() is None

    class _Mesh:                     # a seq axis of 2 needs no process group
        shape = {"seq": 2}           # until an attention actually runs

    with seq_attention_scope(_Mesh(), "ring"):
        fn = seq_attention_fn()
        q = torch.zeros((1, 8, 2, 4))
        with pytest.raises(ValueError, match="mask"):
            fn(q, q, q, mask=torch.ones((1, 1, 8, 8), dtype=torch.bool))
        with pytest.raises(ValueError, match="dropout"):
            fn(q, q, q, dropout_rate=0.1, deterministic=False)
    with pytest.raises(ValueError, match="variant"):
        sharded_self_attention(q, q, q, _Mesh(), variant="megatron")
