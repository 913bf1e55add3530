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
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

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


def _qkv(seed, h, s, b=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_reference(path):
    """Inputs, flax parameters and the JAX package's outputs, in one npz."""
    import jax

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
    np.savez(path, **data)


def _state_dict(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files
            if k.startswith(prefix)}


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
    mp.spawn(_rank_main, args=(str(workdir),), nprocs=WORLD, join=True)
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
