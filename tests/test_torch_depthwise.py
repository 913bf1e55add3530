"""The port's depthwise growth path against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``, where ``level_histograms`` is its plain
PyTorch version. Tolerances, each with its reason:

* ``level_histograms`` against ``_hist_level_xla``: rtol/atol 1e-6 and exact
  counts (both round g/h/m to bf16 and add in row order in float32);
  against the Pallas kernel run by its interpreter: rtol 1e-5 / atol 1e-4
  (it adds in another order), on the slots that own rows (the Pallas kernel
  leaves a slot that owns no chunk undefined);
* trees: identical structure, ``node_of_row`` and leaf counts; leaf values
  rtol 1e-5 / atol 1e-7, internal values rtol 1e-5, gains rtol 1e-4 (float32
  sums of two libraries);
* predictions of a fit: rtol/atol 1e-5; a booster carried across: a
  byte-identical model string.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.gbdt import boosting as jboost
from synapseml_tpu.gbdt import grower as jgrower
from synapseml_tpu.ops import hist_kernel as jhk
from synapseml_tpu.ops import quantize as jq

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.gbdt import boosting as tboost
from synapseml_tpu_torch.gbdt import grower as tgrower
from synapseml_tpu_torch.gbdt import objectives as tobj
from synapseml_tpu_torch.ops import hist_kernel as thk
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

from test_torch_gbdt import _higgs_like, _tree_struct

CPU = "cpu"
N, F = 4096, 28
B = 256


def _level_case(caps, f=5, chunk=256, seed=0, tail=37, nb=B):
    """Slot-partitioned rows: slot i owns ``caps[i]`` chunks of ``chunk``
    rows (0: none, its start is the next slot's), the last ``tail`` rows of
    each slot are padding with g = h = m = 0; bins are drawn from [0, nb).
    Returns numpy (bT, g, h, m, start_chunks, slot_of_row)."""
    rng = np.random.default_rng(seed)
    FP = thk.features_padded(f)
    n = sum(caps) * chunk
    bT = np.zeros((FP, n), np.int32)
    g = np.zeros(n, np.float32)
    h = np.zeros(n, np.float32)
    m = np.zeros(n, np.float32)
    slot = np.zeros(n, np.int32)
    starts, off = [], 0
    for i, cap in enumerate(caps):
        starts.append(off // chunk)
        ln = max(cap * chunk - tail, 0)
        bT[:f, off:off + ln] = rng.integers(0, nb, size=(f, ln))
        g[off:off + ln] = rng.normal(size=ln)
        h[off:off + ln] = rng.uniform(0.5, 2.0, size=ln)
        m[off:off + ln] = (rng.random(ln) > 0.2)
        slot[off:off + cap * chunk] = i
        off += cap * chunk
    return bT, g * m, h * m, m, np.asarray(starts, np.int32), slot


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# level_histograms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("caps,f,nb", [
    ([4], 3, 256), ([2, 1, 3, 1], 11, 256), ([1, 0, 2, 0, 3, 1, 0], 28, 256),
    ([4], 3, 512), ([1, 0, 2, 0, 3, 1, 0], 28, 512),
], ids=["caps0-3", "caps1-11", "caps2-28", "caps0-3-512", "caps2-28-512"])
def test_level_plain_matches_xla_on_every_slot(caps, f, nb):
    bT, g, h, m, starts, slot = _level_case(caps, f, nb=nb)
    bT[0, ::7] = nb + bT[0, ::7]                  # above B: dropped by both
    slot[5::97] = len(caps) + 2                   # no such slot: dropped
    got = thk._level_hist_plain(*_torch(bT, g, h, m, slot), nb, len(caps))
    want = np.asarray(jhk._hist_level_xla(*_jax(bT, g, h, m, slot), nb,
                                          len(caps)))
    got = got.numpy()
    assert got.shape == (len(caps), thk.features_padded(f), nb, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    # and through the wrapper, on CPU tensors
    via = thk.level_histograms(*_torch(bT, g, h, m, starts, slot), nb,
                               len(caps))
    np.testing.assert_array_equal(via.numpy(), got)


def _non_finite_case(chunk=256, nb=B):
    """``_level_case`` with a NaN, two infinities and a g that rounds to
    bf16 infinity; also the (slot, feature, bin, quantity) entries that
    those rows reach, the only ones that may be non-finite."""
    bT, g, h, m, starts, slot = _level_case([2, 1, 3], 5, chunk=chunk,
                                            seed=4, nb=nb)
    r = [3, chunk + 44, 2 * chunk + 100, 3 * chunk + 101]  # slots 0, 0, 1, 2
    bad = dict(zip(r, [0, 0, 1, 0]))              # row: quantity
    g[r[0]], g[r[1]], h[r[2]], g[r[3]] = np.nan, np.inf, -np.inf, 3.4e38
    mask = np.zeros((3, bT.shape[0], nb, 3), bool)
    for r, q in bad.items():
        for f in range(bT.shape[0]):
            if 0 <= bT[f, r] < nb:
                mask[slot[r], f, bT[f, r], q] = True
    return (bT, g, h, m, starts, slot), mask


@pytest.mark.parametrize("nb", [256, 512])
def test_level_plain_keeps_a_non_finite_value_in_its_bin(nb):
    (bT, g, h, m, starts, slot), mask = _non_finite_case(nb=nb)
    got = thk._level_hist_plain(*_torch(bT, g, h, m, slot), nb, 3).numpy()
    want = np.asarray(jhk._hist_level_xla(*_jax(bT, g, h, m, slot), nb, 3))
    np.testing.assert_array_equal(~np.isfinite(got), mask)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_level_plain_matches_pallas_interpret_on_live_slots():
    caps = [2, 1, 3, 1]                           # 4 slots, 7 chunks of 256
    bT, g, h, m, starts, slot = _level_case(caps, f=11, seed=1)
    want = np.asarray(jhk._hist_pallas_level(
        *_jax(bT, g, h, m, starts), B, len(caps), chunk=256, interpret=True))
    got = thk._level_hist_plain(*_torch(bT, g, h, m, slot), B,
                                len(caps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


def test_slot_without_rows_is_zero_and_negative_bins_drop():
    caps = [2, 0, 1, 0]
    bT, g, h, m, starts, slot = _level_case(caps, f=3, seed=2)
    assert list(starts) == [0, 2, 2, 3]           # slots 1 and 3 own nothing
    bT[1, ::2] = -1
    got = thk.level_histograms(*_torch(bT, g, h, m, starts, slot), B, 4)
    assert not got[1].any() and not got[3].any()
    assert got[0, 1, :, 2].sum() == m[:512][1::2].sum()
    assert got[2, 0, :, 2].sum() == m[512:].sum()


def test_level_wrapper_checks_inputs():
    bT, g, h, m, starts, slot = _torch(*_level_case([1, 1], f=3))
    with pytest.raises(ValueError, match="slot_of_row"):
        thk.level_histograms(bT, g, h, m, starts, slot[:-1], B, 2)
    with pytest.raises(TypeError):
        thk.level_histograms(bT.to(torch.int64), g, h, m, starts, slot, B, 2)
    before = dict(thk.LAUNCHES)
    thk.level_histograms(bT, g, h, m, starts, slot, B, 2)
    assert thk.LAUNCHES == before          # the plain version is no launch


# ---------------------------------------------------------------------------
# one depthwise tree
# ---------------------------------------------------------------------------

def _grad_inputs(nan_cols, seed=0):
    X, y = _higgs_like(N, seed=seed, nan_cols=nan_cols)
    mapper = jq.compute_bin_mapper(X, 255)
    binned = np.array(jq.apply_bins(mapper, X))     # writable for torch
    p = 1 / (1 + np.exp(-np.float32(0.1)))
    g = (p - y).astype(np.float32)
    h = np.full(N, p * (1 - p), np.float32)
    return binned, g, h, np.asarray(mapper.nan_bins, np.int32)


def _host_syncs(tree, L: int, max_depth: int) -> int:
    """A depthwise tree's host reads, as grower_depthwise.py states them:
    one per pass (the root, then each level that applied a split), less the
    last when the leaf budget or the depth limit ended the tree."""
    ns = int(tree.num_splits)
    levels = tgrower.forest_max_depth([tree]) if ns else 0
    max_levels = max_depth if max_depth > 0 else L - 1
    ended = ns == L - 1 or levels == max_levels
    return 1 + levels - int(ended)


@pytest.mark.parametrize("L,max_depth,nan_cols", [
    (4, -1, ()), (15, -1, ()), (31, -1, ()), (31, 2, ()), (31, -1, (3, 7)),
])
def test_depthwise_tree_matches_reference(L, max_depth, nan_cols):
    binned, g, h, nan_bins = _grad_inputs(nan_cols)
    in_bag = np.ones(N, np.float32)
    jcfg = jgrower.GrowerConfig(num_leaves=L, max_depth=max_depth,
                                growth_policy="depthwise")
    jt, jnode = jgrower.grow_tree(
        jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(in_bag), jnp.ones(F, bool), jnp.zeros(F, bool),
        jnp.zeros(F, jnp.int32), jcfg, nan_bins=jnp.asarray(nan_bins))
    tcfg = tgrower.GrowerConfig(num_leaves=L, max_depth=max_depth,
                                growth_policy="depthwise")
    stats = {"host_syncs": 0}
    tt, tnode = tgrower.grow_tree(
        torch.from_numpy(binned), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(in_bag), torch.ones(F, dtype=torch.bool), tcfg,
        nan_bins=nan_bins, stats=stats)
    tt = tgrower.tree_to_host(tt)
    assert _tree_struct(tt) == _tree_struct(jt)
    assert int(tt.num_splits) == (3 if max_depth == 2 else L - 1)
    if nan_cols:                                  # a learned NaN direction
        assert set(tt.split_feature[:30]) & set(nan_cols)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))
    np.testing.assert_array_equal(tt.leaf_count, np.asarray(jt.leaf_count))
    np.testing.assert_allclose(tt.leaf_value, np.asarray(jt.leaf_value),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tt.internal_value,
                               np.asarray(jt.internal_value), rtol=1e-5)
    np.testing.assert_allclose(tt.split_gain, np.asarray(jt.split_gain),
                               rtol=1e-4)
    assert tgrower.forest_max_depth([tt]) <= (2 if max_depth == 2 else L)
    assert stats["host_syncs"] == _host_syncs(tt, L, max_depth)


def test_single_leaf_tree_is_the_root():
    binned, g, h, nan_bins = _grad_inputs(())
    stats = {"host_syncs": 0}
    tt, tnode = tgrower.grow_tree(
        torch.from_numpy(binned), torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(N), torch.ones(F, dtype=torch.bool),
        tgrower.GrowerConfig(num_leaves=1, growth_policy="depthwise"),
        nan_bins=nan_bins, stats=stats)
    tt = tgrower.tree_to_host(tt)
    assert int(tt.num_splits) == 0 and stats["host_syncs"] == 0
    assert not tnode.any() and tt.leaf_count[0] == N
    # the histograms sum bf16-rounded values (float64 sums here)
    G, H = (torch.from_numpy(a).to(torch.bfloat16).double().sum().item()
            for a in (g, h))
    np.testing.assert_allclose(tt.leaf_value[0], -G / H * 0.1, rtol=1e-5)


# ---------------------------------------------------------------------------
# train_booster, depthwise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return _higgs_like(N, nan_cols=(3, 7))


def _cfg(pkg, **kw):
    kw.setdefault("growth_policy", "depthwise")
    return pkg.BoosterConfig(objective="binary", num_iterations=5, **kw)


@pytest.fixture(scope="module")
def jax_booster(data):
    X, y = data
    return jboost.train_booster(X, y, _cfg(jboost))


def test_train_booster_depthwise_matches_reference(data, jax_booster):
    X, y = data
    tb = tboost.train_booster(X, y, _cfg(tboost), device=CPU)
    assert len(tb.trees) == len(jax_booster.trees) == 5
    for tt, jt in zip(tb.trees, jax_booster.trees):
        assert _tree_struct(tt) == _tree_struct(jt)
        np.testing.assert_allclose(tt.leaf_value, np.asarray(jt.leaf_value),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb.predict(X), jax_booster.predict(X),
                               rtol=1e-5, atol=1e-5)
    assert tb.metadata["host_syncs"] == sum(_host_syncs(t, 31, -1)
                                            for t in tb.trees)
    # depthwise trees differ from leaf-wise ones, with comparable quality
    lw = tboost.train_booster(X, y, _cfg(tboost, growth_policy="leafwise"),
                              device=CPU)
    assert any(_tree_struct(a) != _tree_struct(b)
               for a, b in zip(lw.trees, tb.trees))
    yt = torch.from_numpy(y)
    assert (float(tobj.auc(yt, torch.from_numpy(tb.predict(X))))
            >= float(tobj.auc(yt, torch.from_numpy(lw.predict(X)))) - 0.02)


def test_depthwise_booster_from_reference_is_byte_identical(data,
                                                            jax_booster):
    X, _ = data
    arrays, config = booster_arrays(jax_booster)
    assert config["growth_policy"] == "depthwise"
    tb = booster_from_reference(arrays, config, device=CPU)
    assert tb.config.growth_policy == "depthwise"
    assert tb.model_string() == jax_booster.model_string()
    np.testing.assert_allclose(tb.predict(X), jax_booster.predict(X),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# On the card. Tolerance rtol 1e-5 / atol 1e-3 against the plain version:
# atomics add in an order that changes from run to run; counts are exact.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [256, 512])
@pytest.mark.parametrize("caps,f,cut,zero", [
    ([2, 1, 3, 1], 11, 0, ()), ([1, 0, 2, 0, 3, 1, 0], 28, 0, ()),
    ([40, 0, 1, 0, 25] + [1] * 26, 28, 0, ()), ([1], 1, 0, ()),
    ([2, 1, 3], 11, 37, ()),              # the last chunk ragged: n odd
    ([2, 1], 5, 0, ((32, 48),)),          # one 16-row group all zero
    # whole chunks of zeros: the first of the input, all of slot 1 and the
    # first of slot 2 (the kernel skips them without reading their slot)
    ([2, 1, 3, 2], 11, 0, ((0, thk.CHUNK), (2 * thk.CHUNK, 4 * thk.CHUNK))),
])
def test_cuda_level_kernel_matches_plain(cuda, caps, f, cut, zero, nb):
    bT, g, h, m, starts, slot = _level_case(caps, f, chunk=thk.CHUNK, seed=3,
                                            nb=nb)
    bT[0, ::7] = -1                                # dropped by both
    bT[f - 1, ::5] = nb + 3
    for lo, hi in zero:                            # rows [lo, hi)
        g[lo:hi] = h[lo:hi] = m[lo:hi] = 0
    if cut:
        bT, g, h, m, slot = (bT[:, :-cut], g[:-cut], h[:-cut], m[:-cut],
                             slot[:-cut])
    bT, g, h, m, starts, slot = [t.to(cuda) for t in _torch(
        bT, g, h, m, starts, slot)]
    before = thk.LAUNCHES["level_histograms"]
    got = thk.level_histograms(bT, g, h, m, starts, slot, nb, len(caps))
    want = thk._level_hist_plain(bT, g, h, m, slot, nb, len(caps))
    torch.cuda.synchronize()
    assert thk.LAUNCHES["level_histograms"] == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    for i, cap in enumerate(caps):
        if cap == 0:
            assert not got[i].any()


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [256, 512])
def test_cuda_level_kernel_keeps_a_non_finite_value_in_its_bin(cuda, nb):
    arrays, mask = _non_finite_case(chunk=thk.CHUNK, nb=nb)
    bT, g, h, m, starts, slot = [t.to(cuda) for t in _torch(*arrays)]
    got = thk.level_histograms(bT, g, h, m, starts, slot, nb, 3)
    want = thk._level_hist_plain(bT, g, h, m, slot, nb, 3)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(~np.isfinite(got), mask)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.cuda
def test_cuda_level_wrapper_raises_instead_of_falling_back(cuda):
    bT, g, h, m, starts, slot = [t.to(cuda) for t in _torch(
        *_level_case([1, 1], f=3))]
    before = dict(thk.LAUNCHES)
    with pytest.raises(ValueError, match="start_chunks"):
        thk.level_histograms(bT, g, h, m, starts.cpu(), slot, B, 2)
    with pytest.raises(ValueError, match="start_chunks"):
        thk.level_histograms(bT, g, h, m, starts[:1], slot, B, 2)
    with pytest.raises(ValueError, match="contiguous"):
        thk.level_histograms(bT.T.contiguous().T, g, h, m, starts, slot, B, 2)
    assert thk.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_depthwise_fit_matches_reference(data, jax_booster, cuda):
    """The depthwise fit on the card against the JAX package's: AUC and
    mean absolute probability within 1e-3 (atomics can flip a near-tie
    split). Only the level kernel runs: once per level pass."""
    X, y = data
    before = dict(thk.LAUNCHES)
    tb = tboost.train_booster(X, y, _cfg(tboost), device=cuda)
    launched = {k: thk.LAUNCHES[k] - before[k] for k in before}
    passes = sum(1 + tgrower.forest_max_depth([t]) for t in tb.trees)
    assert launched == {"child_histogram": 0, "range_histogram": 0,
                        "level_histograms": passes}
    p, q = tb.predict(X), jax_booster.predict(X)
    assert np.abs(p - q).mean() <= 1e-3
    yt = torch.from_numpy(y)
    auc_t = float(tobj.auc(yt, torch.from_numpy(p)))
    auc_j = float(tobj.auc(yt, torch.from_numpy(q)))
    assert abs(auc_t - auc_j) <= 1e-3
