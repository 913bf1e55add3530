"""The port's histogram functions against the JAX package's.

``_hist_plain`` / ``_range_hist_plain`` (what the port runs for CPU tensors,
and what ``chip_smoke.py`` holds the CUDA kernels against on the card) are
compared with the JAX reference ``_hist_xla`` and with the Pallas kernels run
by the Pallas interpreter. Inputs are made with numpy from a seed and handed
to both. Tolerance rtol 1e-5 / atol 1e-4: both sides round g/h/m to bf16
identically and sum in float32, so they differ only by summation order.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds them
against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.ops import hist_kernel as jhk
from synapseml_tpu_torch.ops import hist_kernel as thk
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

RTOL, ATOL = 1e-5, 1e-4


def _case(n=4096, f=11, b=256, seed=0, masked=0.3):
    """The inputs of tests/test_hist_kernel.py::_case."""
    rng = np.random.default_rng(seed)
    FP = thk.features_padded(f)
    bT = np.zeros((FP, n), np.int32)
    bT[:f] = rng.integers(0, b, size=(f, n))
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(size=n).astype(np.float32)
    m = (rng.random(n) > masked).astype(np.float32)
    return bT, g * m, h * m, m


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_pad_helpers_match_reference():
    for mb in (2, 63, 255, 256, 257, 1000):
        assert thk.pad_bins(mb) == jhk.pad_bins(mb)
    for f in (1, 8, 9, 28, 33):
        assert thk.features_padded(f) == jhk.features_padded(f)


@pytest.mark.parametrize("n,f", [(2048, 3), (4096, 11), (8192, 28)])
def test_hist_plain_matches_xla(n, f):
    bT, g, h, m = _case(n, f)
    got = thk._hist_plain(*_torch(bT, g, h, m), 256).numpy()
    want = np.asarray(jhk._hist_xla(*_jax(bT, g, h, m), 256))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


def test_hist_plain_matches_pallas_interpret():
    bT, g, h, m = _case(4096, 11)
    got = thk._hist_plain(*_torch(bT, g, h, m), 256).numpy()
    want = np.asarray(jhk._hist_pallas(*_jax(bT, g, h, m), 256,
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("start,length,size", [
    (0, 16384, 16384), (0, 100, 4096), (5000, 3000, 8192),
    (13000, 3384, 8192), (16383, 1, 4096), (2048, 2048, 4096),
    (777, 9000, 16384),
])
def test_range_hist_plain_matches_pallas_range(start, length, size):
    """The seven geometries of tests/test_hist_kernel.py's segmented test."""
    rng = np.random.default_rng(0)
    FP, Np, B = 16, 16384, 256
    bT = rng.integers(0, B, size=(FP, Np)).astype(np.int32)
    g = rng.normal(size=Np).astype(np.float32)
    h = rng.uniform(0.1, 1, size=Np).astype(np.float32)
    m = (rng.uniform(size=Np) > 0.2).astype(np.float32)
    g, h = g * m, h * m
    want = np.asarray(jhk._hist_pallas_range(
        *_jax(bT, g, h, m), start, length, B, size, chunk=2048,
        interpret=True))
    got = thk._range_hist_plain(*_torch(bT, g, h, m), start, length, B)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the wrapper on CPU tensors, with start/length as 0-d tensors
    via = thk.range_histogram(*_torch(bT, g, h, m), torch.tensor(start),
                              torch.tensor(length), B)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_bf16_rounding_changes_the_sums():
    """Values that bf16 rounds: the port sums the rounded values, as the
    reference does, not the float32 inputs."""
    n, FP, B = 64, 8, 256
    bT = np.zeros((FP, n), np.int32)
    g = np.full(n, 1.0 + 2.0 ** -10, np.float32)    # rounds to 1.0 in bf16
    h = np.full(n, 0.1, np.float32)
    m = np.ones(n, np.float32)
    got = thk._hist_plain(*_torch(bT, g, h, m), B).numpy()
    want = np.asarray(jhk._hist_xla(*_jax(bT, g, h, m), B))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[0, 0, 0] == pytest.approx(n * 1.0)
    assert got[0, 0, 0] != pytest.approx(float(g.astype(np.float64).sum()),
                                         abs=1e-4)


def test_out_of_range_bins_are_dropped():
    bT, g, h, m = _case(2048, 5)
    bT[1, ::3] = 256 + bT[1, ::3]                    # above B: dropped by both
    got = thk._hist_plain(*_torch(bT, g, h, m), 256).numpy()
    want = np.asarray(jhk._hist_xla(*_jax(bT, g, h, m), 256))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[1, :, 2].sum() == m[np.arange(2048) % 3 != 0].sum()
    # negative bins are dropped too (the kernel's unsigned bounds test)
    neg = bT.copy()
    neg[2, ::2] = -1
    out = thk._hist_plain(*_torch(neg, g, h, m), 256).numpy()
    assert out[2, :, 2].sum() == m[np.arange(2048) % 2 == 1].sum()
    np.testing.assert_array_equal(out[0], got[0])


def test_wrapper_checks_inputs():
    bT, g, h, m = _torch(*_case(512, 3))
    with pytest.raises(TypeError):
        thk.child_histogram(bT.to(torch.int64), g, h, m, 256)
    with pytest.raises(ValueError):
        thk.child_histogram(bT, g[:-1], h, m, 256)
    with pytest.raises(ValueError):
        thk.child_histogram(bT[:5], g, h, m, 256)
    with pytest.raises(ValueError):
        thk.child_histogram(bT, g, h, m, 300)
    before = dict(thk.LAUNCHES)
    thk.child_histogram(bT, g, h, m, 256)
    assert thk.LAUNCHES == before          # the plain version is no launch


# ---------------------------------------------------------------------------
# The CUDA kernels on the card, against the plain versions on the same
# tensors. Tolerance rtol 1e-5 / atol 1e-4: atomics add in an order that
# changes from run to run; counts are exact.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_hist_close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,max_bin", [
    (100_000, 28, 255), (50_000, 5, 300), (3000, 8, 63), (1, 1, 255),
])
def test_cuda_kernels_match_plain(cuda, n, f, max_bin):
    B = thk.pad_bins(max_bin)
    bT, g, h, m = _case(n, f, b=max_bin, seed=n)
    bT[0, ::7] = -1                                 # dropped by both
    bT[f - 1, ::5] = B + 3
    bT, g, h, m = [t.to(cuda) for t in _torch(bT, g, h, m)]
    before = dict(thk.LAUNCHES)
    _assert_hist_close(thk.child_histogram(bT, g, h, m, B),
                       thk._hist_plain(bT, g, h, m, B))
    ranges = [(0, n), (n // 3, n // 2), (n - 1, 1), (n, 0), (0, 0),
              (n // 2, 2 * n)]                      # the last is clamped at n
    for s, ln in ranges:
        got = thk.range_histogram(bT, g, h, m, torch.tensor(s, device=cuda),
                                  torch.tensor(ln, device=cuda), B)
        _assert_hist_close(got, thk._range_hist_plain(bT, g, h, m, s, ln, B))
    # Python ints are accepted as well
    _assert_hist_close(thk.range_histogram(bT, g, h, m, 0, n, B),
                       thk._hist_plain(bT, g, h, m, B))
    assert thk.LAUNCHES["child_histogram"] == before["child_histogram"] + 1
    assert (thk.LAUNCHES["range_histogram"]
            == before["range_histogram"] + len(ranges) + 1)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    bT, g, h, m = [t.to(cuda) for t in _torch(*_case(512, 3))]
    before = dict(thk.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        thk.child_histogram(bT.T.contiguous().T, g, h, m, 256)
    with pytest.raises(ValueError):
        thk.child_histogram(bT, g.cpu(), h, m, 256)
    with pytest.raises(ValueError):
        thk.range_histogram(bT, g, h, m, torch.tensor(0), torch.tensor(5), 256)
    assert thk.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,fp,max_bin", [
    (8192, 32, 255),        # four feature blocks, whole 32-row groups
    (8195, 32, 255),        # a last 32-row group of 3 rows
    (40_000, 40, 255),      # five feature blocks, several range blocks
    (20_000, 8, 511),       # one feature block, B = 512
])
def test_cuda_contention_cases_match_plain(cuda, n, fp, max_bin):
    """What the kernel's accumulate routine special-cases: a feature whose
    rows all sit in one bin (a padded feature, a constant column), runs of
    one bin, all-zero rows (skipped) in whole 32-row groups and scattered,
    and ranges whose ends do not divide the 32-row groups or the blocks."""
    B = thk.pad_bins(max_bin)
    rng = np.random.default_rng(n + fp)
    bT = rng.integers(0, max_bin, size=(fp, n)).astype(np.int32)
    bT[fp - 4:] = 0                                 # warp-uniform bin
    bT[1] = 7                                       # constant column
    bT[2] = np.repeat(rng.integers(0, max_bin, size=-(-n // 50)), 50)[:n]
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(size=n).astype(np.float32)
    m = np.ones(n, np.float32)
    zero = rng.random(n) < 0.3
    zero[64:160] = True                             # whole 32-row groups
    g[zero], h[zero], m[zero] = 0.0, 0.0, 0.0
    bT, g, h, m = [t.to(cuda) for t in _torch(bT, g, h, m)]
    _assert_hist_close(thk.child_histogram(bT, g, h, m, B),
                       thk._hist_plain(bT, g, h, m, B))
    for s, ln in [(0, n), (1, n - 1), (33, 31), (100, 5000), (n - 37, 37),
                  (3, 2048 * 3 + 5)]:
        got = thk.range_histogram(bT, g, h, m, torch.tensor(s, device=cuda),
                                  torch.tensor(ln, device=cuda), B)
        _assert_hist_close(got, thk._range_hist_plain(bT, g, h, m, s, ln, B))


@pytest.mark.cuda
def test_cuda_all_zero_rows_give_an_empty_histogram(cuda):
    n = 10_000
    bT = torch.randint(0, 256, (16, n), dtype=torch.int32, device=cuda)
    z = torch.zeros(n, device=cuda)
    assert not thk.child_histogram(bT, z, z, z, 256).any()
    assert not thk.range_histogram(bT, z, z, z, 5, n - 10, 256).any()


# ---------------------------------------------------------------------------
# Large bin spaces: above 16384 bins the leaf-wise kernels run bin windows of
# 16384 (the level kernel windows of 2048) on a grid axis
# ---------------------------------------------------------------------------

def _level_inputs(n_chunks, f, nb, seed):
    """Rows in 3 slots of whole CHUNKs (slot 1 owns none), random bins in
    [0, nb) with some outside it; numpy (bT, g, h, m, starts, slot)."""
    n = n_chunks * thk.CHUNK
    bT, g, h, m = _case(n, f, b=nb, seed=seed)
    bT[0, ::11] = nb + 5                            # dropped by both
    starts = np.asarray([0, n_chunks // 3, n_chunks // 3], np.int32)
    slot = np.minimum(np.arange(n) // thk.CHUNK >= n_chunks // 3, 1) * 2
    return bT, g, h, m, starts, slot.astype(np.int32)


@pytest.mark.parametrize("nb", [4096, 8192, 32768])
def test_large_bin_spaces_plain_match_xla(nb):
    bT, g, h, m = _case(6000, 5, b=nb, seed=nb)
    got = thk._hist_plain(*_torch(bT, g, h, m), nb).numpy()
    want = np.asarray(jhk._hist_xla(*_jax(bT, g, h, m), nb))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    bT, g, h, m, _, slot = _level_inputs(3, 5, nb, nb + 1)
    got = thk._level_hist_plain(*_torch(bT, g, h, m, slot), nb, 3).numpy()
    want = np.asarray(jhk._hist_level_xla(*_jax(bT, g, h, m, slot), nb, 3))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert not got[1].any()                         # the slot without rows


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_bin_space_above_16384_gives_the_reference_trees(policy):
    """``max_bin=20000`` pads to B = 32768, two windows of the leaf-wise
    kernels and sixteen of the level kernel on the card; the fit takes it
    under both growth policies and grows the JAX package's trees."""
    from synapseml_tpu.gbdt import boosting as jboost
    from synapseml_tpu_torch.gbdt import boosting

    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 3)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=600) > 0).astype(np.float32)
    kw = dict(objective="binary", max_bin=20000, num_iterations=2,
              num_leaves=6, min_data_in_leaf=5, growth_policy=policy)
    tb = boosting.train_booster(X, y, boosting.BoosterConfig(**kw),
                                device="cpu")
    jb = jboost.train_booster(X, y, jboost.BoosterConfig(**kw))
    assert tb.num_trees == jb.num_trees == 2
    for tt, jt in zip(tb.trees, jb.trees):
        ns = int(tt.num_splits)
        assert ns == int(jt.num_splits) > 0
        for f in ("split_feature", "split_bin", "left_child", "right_child"):
            np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:ns],
                                          np.asarray(getattr(jt, f))[:ns])
        np.testing.assert_allclose(tt.leaf_value[:ns + 1],
                                   np.asarray(jt.leaf_value)[:ns + 1],
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_cpu_fit_takes_a_bin_space_above_the_kernels_cap():
    from synapseml_tpu_torch.gbdt import boosting

    rng = np.random.default_rng(1)
    X = rng.normal(size=(400, 3)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=400) > 0).astype(np.float32)
    b = boosting.train_booster(X, y, boosting.BoosterConfig(
        objective="binary", max_bin=20000, num_iterations=2, num_leaves=4,
        min_data_in_leaf=5), device="cpu")
    assert b.num_trees == 2
    assert np.all(np.isfinite(b.predict(X)))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [4096, 8192, 16384, 32768])
def test_cuda_large_bin_spaces_match_plain(cuda, nb):
    """All three kernels at B = 4096 (the leaf-wise kernels' last size in
    48 KB), 8192, 16384 (one feature per block, opted in above 48 KB) and
    32768 (two windows of 16384 bins); the level kernel in 2, 4, 8 and 16
    windows of 2048 bins. Some bins fall outside [0, B)."""
    bT, g, h, m = [t.to(cuda) for t in _torch(*_case(60_000, 11, b=nb,
                                                     seed=nb))]
    _assert_hist_close(thk.child_histogram(bT, g, h, m, nb),
                       thk._hist_plain(bT, g, h, m, nb))
    got = thk.range_histogram(bT, g, h, m, torch.tensor(777, device=cuda),
                              torch.tensor(40_000, device=cuda), nb)
    _assert_hist_close(got, thk._range_hist_plain(bT, g, h, m, 777, 40_000,
                                                  nb))
    bT, g, h, m, starts, slot = [t.to(cuda) for t in _torch(
        *_level_inputs(30, 11, nb, nb + 1))]
    _assert_hist_close(thk.level_histograms(bT, g, h, m, starts, slot, nb, 3),
                       thk._level_hist_plain(bT, g, h, m, slot, nb, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_cuda_fit_at_bin_space_32768_matches_cpu(cuda, policy):
    """``max_bin=32767`` (B = 32768) on the card, through the windowed
    kernels, against the same fit on the CPU: atomics can flip a near-tie
    split, so predictions are held to the cross-check tolerance of
    chip_smoke.py (mean absolute difference within 1e-3)."""
    from synapseml_tpu_torch.gbdt import boosting

    rng = np.random.default_rng(4)
    X = rng.normal(size=(50_000, 6)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2] > 0).astype(np.float32)
    cfg = dict(objective="binary", max_bin=32767, num_iterations=3,
               growth_policy=policy)
    kernel = "child_histogram" if policy == "leafwise" else "level_histograms"
    before = thk.LAUNCHES[kernel]
    pc = boosting.train_booster(X, y, boosting.BoosterConfig(**cfg),
                                device=cuda).predict(X)
    assert thk.LAUNCHES[kernel] > before
    pp = boosting.train_booster(X, y, boosting.BoosterConfig(**cfg),
                                device="cpu").predict(X)
    assert np.abs(pc - pp).mean() <= 1e-3
