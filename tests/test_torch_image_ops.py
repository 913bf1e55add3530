"""The port's image ops (``synapseml_tpu_torch/ops/image.py``) and leaf
histograms (``ops/histogram.py``) against the JAX package's, on the CPU:

* every device op on the same seeded NHWC float32 images in [0, 1]:
  ``crop``, ``center_crop``, ``flip`` and ``threshold`` exactly, ``resize``
  (every method name, down, up and mixed) within ``RESIZE_TOL`` (float32
  sums of the same weights in another order), ``gaussian_kernel``,
  ``blur`` and ``color_to_gray`` within ``OP_TOL``;
* ``tests/test_sklearn_parity.py``'s resize-against-PIL and blur-against-
  scipy checks on the port, and a Lanczos resize against PIL's;
* ``leaf_histograms``: counts exactly, gradient and hessian sums within
  ``HIST_REL`` of each bin's sum of magnitudes (XLA's scatter adds in
  another order), dropped rows and bins; ``sharded_histogram_fn`` on two
  gloo CPU ranks: the same histogram on both ranks, and the JAX package's
  on two virtual devices.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from synapseml_tpu_torch.ops import image as T
from synapseml_tpu_torch.ops.histogram import leaf_histograms
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)
from torch_waits import join_spawn

RESIZE_TOL = 2e-6
OP_TOL = 1e-6
HIST_REL = 1e-6
METHODS = ("nearest", "linear", "bilinear", "cubic", "bicubic", "lanczos3",
           "lanczos5")
SIZES = ((16, 13), (64, 50), (37, 40))


def _images(n=2, h=37, w=29, c=3, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(n, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_the_jax_package(method):
    from synapseml_tpu.ops import image as J

    x = _images()
    for h, w in SIZES:
        want = np.asarray(J.resize(x, h, w, method))
        got = T.resize(torch.from_numpy(x), h, w, method).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


def test_resize_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="unknown resize method"):
        T.resize(torch.zeros(1, 4, 4, 1), 2, 2, "area")


def test_crop_flip_threshold_are_the_jax_packages():
    from synapseml_tpu.ops import image as J

    x = _images()
    t = torch.from_numpy(x)
    for args in ((3, 5, 10, 7), (25, 30, 10, 7), (0, 0, 37, 29)):
        np.testing.assert_array_equal(T.crop(t, *args).numpy(),
                                      np.asarray(J.crop(x, *args)))
    for hw in ((20, 50), (10, 11), (37, 29)):
        np.testing.assert_array_equal(T.center_crop(t, *hw).numpy(),
                                      np.asarray(J.center_crop(x, *hw)))
    for code in (0, 1, 3, -1):
        np.testing.assert_array_equal(T.flip(t, code).numpy(),
                                      np.asarray(J.flip(x, code)))
    for thr, mx in ((0.5, 1.0), (0.25, 0.8)):
        np.testing.assert_array_equal(T.threshold(t, thr, mx).numpy(),
                                      np.asarray(J.threshold(x, thr, mx)))


@pytest.mark.parametrize("ksize,sigma", [(3, 1.0), (9, 1.5), (4, 0.8)])
def test_blur_and_kernel_match_the_jax_package(ksize, sigma):
    from synapseml_tpu.ops import image as J

    x = _images()
    np.testing.assert_allclose(
        T.gaussian_kernel(ksize, sigma, device="cpu").numpy(),
        np.asarray(J.gaussian_kernel(ksize, sigma)), rtol=0, atol=OP_TOL)
    np.testing.assert_allclose(
        T.blur(torch.from_numpy(x), ksize, sigma).numpy(),
        np.asarray(J.blur(x, ksize, sigma)), rtol=0, atol=OP_TOL)


def test_color_to_gray_matches_the_jax_package():
    from synapseml_tpu.ops import image as J

    x = _images()
    got = T.color_to_gray(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape[:3] + (1,)
    np.testing.assert_allclose(got, np.asarray(J.color_to_gray(x)), rtol=0,
                               atol=OP_TOL)


def _smooth(h=64, w=64):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([np.sin(yy / 9) * np.cos(xx / 7), (yy + xx) / (h + w),
                     np.cos(yy / 5)], axis=-1) * 0.5 + 0.5


def _pil_resize(img, size, resample):
    from PIL import Image

    return np.stack([
        np.asarray(Image.fromarray((img[..., c] * 255).astype(np.uint8))
                   .resize(size, resample), dtype=np.float32) / 255
        for c in range(img.shape[-1])], axis=-1)


@pytest.mark.parametrize("method,pil", [("bilinear", "BILINEAR"),
                                        ("lanczos3", "LANCZOS")])
def test_resize_matches_pil(method, pil):
    """``tests/test_sklearn_parity.py``'s PIL oracle on the port (sub-1%
    interpolation-convention differences), and the same for Lanczos."""
    from PIL import Image

    img = _smooth()
    ours = T.resize(torch.from_numpy(img[None]), 32, 32, method).numpy()[0]
    want = _pil_resize(img, (32, 32), getattr(Image, pil))
    assert np.abs(ours - want).mean() < 0.01


def test_gaussian_blur_matches_scipy():
    from scipy.ndimage import gaussian_filter

    img = np.random.default_rng(6).uniform(size=(40, 40, 1)).astype(
        np.float32)
    ours = T.blur(torch.from_numpy(img[None]), ksize=9, sigma=1.5).numpy()
    want = gaussian_filter(img[..., 0], sigma=1.5, mode="nearest",
                           truncate=3.0)
    # interior only: border conventions differ (reflect/nearest vs same-pad)
    np.testing.assert_allclose(ours[0, 6:-6, 6:-6, 0], want[6:-6, 6:-6],
                               atol=5e-3)


def test_device_ops_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.gaussian_kernel(3, 1.0)


# --- leaf histograms --------------------------------------------------------

def _hist_inputs(n=5000, f=7, bins=32, leaves=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, bins, size=(n, f)).astype(np.uint8),
            rng.integers(0, leaves, size=n).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(size=n).astype(np.float32))


def _check_hist(got, want, binned, node, g, h, leaves, bins):
    """Counts equal; sums within HIST_REL of each bin's Σ|x| (float64)."""
    assert got.shape == want.shape == (leaves, binned.shape[1], bins, 3)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    mag = np.zeros(want.shape[:3] + (2,))
    ok = (node >= 0) & (node < leaves)
    for j in range(binned.shape[1]):
        keep = ok & (binned[:, j] < bins)
        np.add.at(mag, (node[keep], j, binned[keep, j].astype(np.int64)),
                  np.abs(np.stack([g, h], 1)[keep]).astype(np.float64))
    gap = np.abs(got[..., :2].astype(np.float64) - want[..., :2])
    assert (gap <= HIST_REL * mag + 1e-30).all(), float(gap.max())


@pytest.mark.parametrize("seed,bins,leaves", [(0, 32, 5), (1, 255, 31),
                                              (2, 7, 1)])
def test_leaf_histograms_match_the_jax_package(seed, bins, leaves):
    from synapseml_tpu.ops.histogram import leaf_histograms as jhist

    args = _hist_inputs(bins=bins, leaves=leaves, seed=seed)
    want = np.asarray(jhist(*args, leaves, bins))
    got = leaf_histograms(*(torch.from_numpy(a) for a in args), leaves,
                          bins).numpy()
    _check_hist(got, want, *args, leaves, bins)


def test_leaf_histograms_drop_rows_and_bins_out_of_range():
    """A leaf at or past ``num_leaves`` and a bin past ``num_bins`` drop in
    both packages; a negative leaf or bin drops in the port (the JAX
    package's documented contract), where the JAX scatter wraps it."""
    from synapseml_tpu.ops.histogram import leaf_histograms as jhist

    binned, node, g, h = _hist_inputs(n=400, f=3, bins=8, leaves=4, seed=3)
    binned = binned.astype(np.int32)
    node[::7] = 4                    # past the last leaf
    binned[::5, 1] = 9               # past the last bin
    want = np.asarray(jhist(binned, node, g, h, 4, 8))
    got = leaf_histograms(*(torch.from_numpy(a) for a in
                            (binned, node, g, h)), 4, 8).numpy()
    _check_hist(got, want, binned, node, g, h, 4, 8)
    kept = (node < 4)
    assert got[..., 2].sum() == kept.sum() * 3 - (
        (binned[:, 1] == 9) & kept).sum()
    node2, bins2 = node.copy(), binned.copy()
    node2[::3] = -1
    bins2[::4, 0] = -1
    got2 = leaf_histograms(*(torch.from_numpy(a) for a in
                             (bins2, node2, g, h)), 4, 8).numpy()
    keep = (node2 >= 0) & (node2 < 4)
    inside = (bins2 >= 0) & (bins2 < 8)
    assert got2[..., 2].sum() == (keep[:, None] & inside).sum()


SHARD_ROWS, SHARD_F, SHARD_BINS, SHARD_LEAVES = 3000, 5, 16, 6


def _shard_rank(rank: int, workdir: str) -> None:
    from synapseml_tpu_torch.ops.histogram import sharded_histogram_fn
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(1)
    init_distributed("gloo", os.path.join(workdir, "store"), rank, 2,
                     timeout_s=120)
    mesh = make_mesh({"data": 2}, device="cpu")
    args = _hist_inputs(SHARD_ROWS, SHARD_F, SHARD_BINS, SHARD_LEAVES, 9)
    fn = sharded_histogram_fn(mesh, SHARD_LEAVES, SHARD_BINS)
    out = fn(*args).numpy()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def test_sharded_histogram_is_replicated_and_the_jax_packages(tmp_path):
    import jax

    from synapseml_tpu.ops.histogram import sharded_histogram_fn as jfn
    from synapseml_tpu.parallel import make_mesh as jmesh

    ctx = mp.start_processes(_shard_rank, args=(str(tmp_path),), nprocs=2,
                             join=False, start_method="spawn")
    try:
        args = _hist_inputs(SHARD_ROWS, SHARD_F, SHARD_BINS, SHARD_LEAVES, 9)
        mesh = jmesh({"data": 2}, devices=jax.devices()[:2])
        want = np.asarray(jfn(mesh, SHARD_LEAVES, SHARD_BINS)(*args))
    finally:
        join_spawn(ctx, timeout=300, what="the 2-rank histogram spawn")
    outs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    np.testing.assert_array_equal(outs[0], outs[1])
    _check_hist(outs[0], want, *args, SHARD_LEAVES, SHARD_BINS)
    whole = leaf_histograms(*(torch.from_numpy(a) for a in args),
                            SHARD_LEAVES, SHARD_BINS).numpy()
    np.testing.assert_array_equal(outs[0][..., 2], whole[..., 2])
