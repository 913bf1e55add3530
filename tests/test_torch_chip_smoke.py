"""The host-side arithmetic of ``chip_smoke.py``'s kernel checks.

The card runs the checks; what they compute from shapes alone (the bounds
written beside each kernel's time) and the fit-shaped histogram check's
limit on the padded features' float32 sums are held here, on the CPU, where
the histogram wrappers take their plain versions.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from synapseml_tpu_torch.ops import hist_kernel as hk  # noqa: E402
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)  # noqa: E402


def test_attention_bound_float32_is_3xtf32_on_the_tensor_cores():
    # Ulysses shape: 4*B*H*S*S*D flops, three TF32 products each
    ms, by = cs.attention_bound_ms(4, 4, 8192, 8192, 32, 4)
    flops = 4 * 4 * 4 * 8192 * 8192 * 32
    assert by == "operations"
    assert ms == pytest.approx(3 * flops / 495e12 * 1e3)
    assert ms == pytest.approx(0.833, abs=5e-4)
    # the ring step with a carried state
    ms, by = cs.attention_bound_ms(4, 8, 4096, 4096, 32, 4, state=True)
    assert (round(ms, 3), by) == (0.416, "operations")


def test_attention_bound_bf16_and_causal():
    full, _ = cs.attention_bound_ms(4, 4, 8192, 8192, 32, 2)
    assert full == pytest.approx(4 * 4 * 4 * 8192 * 8192 * 32 / 989e12 * 1e3)
    causal, _ = cs.attention_bound_ms(4, 4, 8192, 8192, 32, 2, causal=True)
    assert causal == pytest.approx(full * (8192 + 1) / (2 * 8192))
    # the causal pairs follow the offsets: a step wholly in the future has
    # none, the diagonal step half
    none, by = cs.attention_bound_ms(1, 1, 64, 64, 32, 4, causal=True,
                                     q_offset=0, k_offset=64)
    assert by == "bytes" and none > 0
    ring = (4, 8, 4096, 4096, 32, 4)
    diag, _ = cs.attention_bound_ms(*ring, causal=True, q_offset=4096,
                                    k_offset=4096)
    past, _ = cs.attention_bound_ms(*ring, causal=True, q_offset=8192,
                                    k_offset=0)
    assert past == cs.attention_bound_ms(*ring)[0]
    assert diag == pytest.approx(past * (4096 + 1) / (2 * 4096))


def test_attention_bound_tiny_shapes_are_bound_by_bytes():
    ms, by = cs.attention_bound_ms(1, 1, 4, 4, 8, 4)
    assert by == "bytes"
    assert ms == pytest.approx((4 * 8 * (4 + 8) + 4 * 4 * 8) / 3.35e12 * 1e3)


def _fit_inputs(rows=6000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    FP, B = hk.features_padded(cs.FEATURES), hk.pad_bins(255)
    bT = torch.randint(0, B, (FP, rows), generator=gen, dtype=torch.int32)
    m = (torch.rand(rows, generator=gen) > 0.2).float()
    g = torch.randn(rows, generator=gen) * m
    h = torch.rand(rows, generator=gen) * m
    return bT, g, h, m, B


def _compare(label, got, want):
    assert torch.allclose(got[..., :2], want[..., :2], rtol=cs.KERNEL_RTOL,
                          atol=cs.KERNEL_ATOL), label
    assert torch.equal(got[..., 2], want[..., 2]), label
    return float((got - want).abs().max())


@pytest.fixture
def no_timing(monkeypatch):
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters: (fn(), 0.0)[1])


def test_fit_shaped_phase_holds_padded_features_to_float64(no_timing):
    bT, g, h, m, B = _fit_inputs()
    results = {"child_histogram": {"ms": 1.0, "bound_ms": 0.1, "shape": ""},
               "range_histogram": {"ms": 1.0, "bound_ms": 0.1, "shape": ""}}
    cs.fit_shaped_phase(bT, g, h, m, B, _compare, results, 1)
    assert not bT[cs.FEATURES:].any()        # the padded features in bin 0
    for r in results.values():
        assert r["fit_ms"] == 0.0 and r["fit_err"] == 0.0


def test_fit_shaped_phase_rejects_a_padded_sum_off_its_bound(no_timing,
                                                             monkeypatch):
    bT, g, h, m, B = _fit_inputs()
    plain = hk._hist_plain

    bound = cs.PAD_SUM_ULPS * 2.0 ** -24 * float(
        hk._rounded_values(g, h, m)[:, 0].double().abs().sum())
    for where, by in (((0, 0), 2 * bound),   # g off by twice its bound
                      ((0, 2), 1.0),         # one count more: not exact
                      ((3, 1), 1e-3)):       # a padded feature off bin 0
        def off(*args, where=where, by=by):
            out = plain(*args).clone()
            out[cs.FEATURES, where[0], where[1]] += by
            return out

        monkeypatch.setattr(hk, "child_histogram", off)
        results = {name: {"ms": 1.0, "bound_ms": 0.1, "shape": ""}
                   for name in ("child_histogram", "range_histogram")}
        with pytest.raises(AssertionError, match="PAD_SUM_ULPS"):
            cs.fit_shaped_phase(bT.clone(), g, h, m, B, _compare, results, 1)


def test_fit_shaped_phase_rejects_one_lane_of_g_lost(no_timing, monkeypatch):
    # a kernel that drops one row's g from a padded feature's bin 0 (one
    # lane of one warp-uniform add), counts and h intact: a shift of about 1
    bT, g, h, m, B = _fit_inputs()
    vals = hk._rounded_values(g, h, m)
    row = int((vals[:, 0].abs() - 1.0).abs().argmin())
    assert abs(float(vals[row, 0])) > 0.9
    plain = hk._hist_plain

    def lost(*args):
        out = plain(*args).clone()
        out[cs.FEATURES + 1, 0, 0] -= vals[row, 0]
        return out

    monkeypatch.setattr(hk, "child_histogram", lost)
    results = {name: {"ms": 1.0, "bound_ms": 0.1, "shape": ""}
               for name in ("child_histogram", "range_histogram")}
    with pytest.raises(AssertionError, match="PAD_SUM_ULPS"):
        cs.fit_shaped_phase(bT, g, h, m, B, _compare, results, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fit_shaped_check_rejects_a_lane_lost_at_full_size(
        cuda, tmp_path, monkeypatch, no_timing):
    # a planted fault at chip_smoke's 2M rows: hist_kernel.cu with lane 31's
    # g left out of every warp-uniform add (h and counts intact), built from
    # a copy and put in place of the port's library
    from synapseml_tpu_torch.ops import _build

    src = (_build.CSRC / "hist_kernel.cu").read_text()
    old = "const float sg = warp_sum(ok ? gv : 0.f);"
    assert src.count(old) == 1
    cu = tmp_path / "hist_kernel.cu"
    cu.write_text(src.replace(
        old, "const float sg = warp_sum(ok && lane != 31 ? gv : 0.f);"))
    so = tmp_path / "libhist_kernel_fault.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in hk._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    monkeypatch.setitem(_build._LIBS, "hist_kernel", lib)
    bT, g, h, m, B = _fit_inputs(rows=2_000_000)
    bT, g, h, m = (t.to(cuda) for t in (bT, g, h, m))
    results = {name: {"ms": 1.0, "bound_ms": 0.1, "shape": ""}
               for name in ("child_histogram", "range_histogram")}
    with pytest.raises(AssertionError, match="PAD_SUM_ULPS"):
        cs.fit_shaped_phase(bT, g, h, m, B, _compare, results, 1)


def _level_fit_inputs(rows=12_000, L=5):
    """chip_smoke's level inputs at a CPU size, fit-shaped: the padded
    features FEATURES..FP-1 with every row in bin 0."""
    bT, g, h, m, starts, slot = cs.level_inputs(rows, "cpu", L)
    bT[cs.FEATURES:] = 0
    return bT, g, h, m, starts, slot, hk.pad_bins(255), L


def test_level_kernel_phase_runs_on_the_plain_versions(no_timing,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    r = cs.level_kernel_phase(20_000, "cpu", _compare)
    assert r["max_abs_err"] == 0.0
    assert r["bound_by"] == "bytes"
    CAP = -(-20_000 // hk.CHUNK) * hk.CHUNK + 31 * hk.CHUNK
    assert r["tensor_ms"] == pytest.approx(CAP * 32 * 256 * 6 / 989e12 * 1e3)


def test_level_fit_shaped_check_rejects_one_row_of_g_lost():
    # a level kernel that drops one row's g from a padded feature's bin 0 in
    # one slot, counts and h intact: a shift of about 1 against a limit of
    # PAD_SUM_ULPS roundoffs of that slot's sum of |g|
    bT, g, h, m, starts, slot, B, L = _level_fit_inputs()
    vals = hk._rounded_values(g, h, m).double()
    want = hk._level_hist_plain(bT, g, h, m, slot, B, L)
    cs.level_fit_shaped_check("plain", want.clone(), want, vals, slot, L,
                              _compare)
    s = int(slot[int(vals[:, 0].abs().argmax())])
    rows = (slot == s).nonzero().flatten()
    row = int(rows[(vals[rows, 0].abs() - 1.0).abs().argmin()])
    bound = cs.PAD_SUM_ULPS * 2.0 ** -24 * float(vals[rows, 0].abs().sum())
    assert abs(float(vals[row, 0])) > 10 * bound
    lost = want.clone()
    lost[s, cs.FEATURES + 1, 0, 0] -= vals[row, 0].float()
    with pytest.raises(AssertionError, match="PAD_SUM_ULPS"):
        cs.level_fit_shaped_check("lost", lost, want, vals, slot, L,
                                  _compare)


def test_level_fit_shaped_check_rejects_a_count_or_a_stray_bin():
    bT, g, h, m, starts, slot, B, L = _level_fit_inputs()
    vals = hk._rounded_values(g, h, m).double()
    want = hk._level_hist_plain(bT, g, h, m, slot, B, L)
    for where in ((0, 2), (5, 1)):          # one count more; off bin 0
        off = want.clone()
        off[1, cs.FEATURES, where[0], where[1]] += 1.0
        with pytest.raises(AssertionError, match="PAD_SUM_ULPS"):
            cs.level_fit_shaped_check("off", off, want, vals, slot, L,
                                      _compare)


def test_train_path_trains_both_ranks_and_checks_launches(no_timing):
    """Phase 9 on the CPU at a small width: both ranks train every run
    through ``DeepTextClassifier`` on the plain versions, which launch no
    kernel, so the launch check refuses the run (the card's run must show
    the flash kernels in every training forward)."""
    est = dict(cs.TRAIN_EST, vocabSize=64, numLayers=2, numHeads=4,
               hiddenSize=32, maxTokenLen=64)
    with pytest.raises(AssertionError, match="forward launches"):
        cs.train_path("cpu", est)


SMALL_TRAIN = dict(cs.TRAIN_EST, vocabSize=64, numLayers=2, numHeads=4,
                   hiddenSize=32, maxTokenLen=64)


def test_first_step_reference_is_the_trainers_first_step():
    """The out-of-scope fit phase 9 holds the ranks' steps to
    (``reference_fit``: one process, microbatches of one row) reports the
    losses and gradient norms of ``Trainer`` on one process with whole
    batches (no ``torch.distributed`` world: the mask-free encoder,
    attention unsharded)."""
    from synapseml_tpu_torch.dl.text import DeepTextClassifier

    est = SMALL_TRAIN
    model = DeepTextClassifier(**est, device="cpu").fit(cs.train_table(est))
    want = model.trainer.step_stats
    got = cs.reference_fit("cpu", est)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
        gap, total = cs.grad_norm_gap(a["grad_norms"], b["grad_norms"])
        assert gap <= 1e-5 * total


def _reports(ref, ref16):
    return {"ring": {"steps": ref}, "ulysses": {"steps": ref},
            "bf16": {"steps": ref16}}


def test_reference_check_rejects_a_wrong_gradient_scale_or_loss():
    """Phase 9's hold on the ranks' steps: the reference passes against
    itself; a gradient scaled by 2 (a missing 1/world), one parameter's
    gradient off, a second-step loss off by 1e-3 and a bf16 loss off by
    0.1 are each refused."""
    import copy

    ref = cs.reference_fit("cpu", SMALL_TRAIN)
    ref16 = cs.reference_fit("cpu", SMALL_TRAIN, precision="bfloat16",
                             stepsPerEpoch=1)
    assert ref16[0]["loss"] != ref[0]["loss"]
    cs.check_against_reference(_reports(ref, ref16), ref, ref16)
    for break_it in (
            lambda r: r[0]["grad_norms"].update(
                {k: 2 * v for k, v in r[0]["grad_norms"].items()}),
            lambda r: r[0]["grad_norms"].update(
                {"head.kernel": 1.5 * r[0]["grad_norms"]["head.kernel"]}),
            lambda r: r[1].update(loss=r[1]["loss"] * (1 + 1e-3))):
        bad = copy.deepcopy(ref)
        break_it(bad)
        with pytest.raises(AssertionError):
            cs.check_against_reference(_reports(bad, ref16), ref, ref16)
    bad16 = copy.deepcopy(ref16)
    bad16[0]["loss"] += 0.1
    with pytest.raises(AssertionError, match="bf16"):
        cs.check_against_reference(_reports(ref, bad16), ref, ref16)


def test_large_bins_phase_runs_on_the_plain_versions(monkeypatch):
    """Phase 2's large bin spaces on the CPU, where every wrapper takes its
    plain version: each kernel's call, its plain version and the
    ``index_put_`` yardstick (out-of-range bins to a spare row) run."""
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(cs, "LARGE_BIN_ROWS", 3 * hk.CHUNK)
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters: (fn(), 1.0)[1])
    seen = []
    cs.large_bins_phase("cpu", lambda label, got, want: seen.append(
        _compare(label, got, want)))
    assert len(seen) == 3 * len(cs.LARGE_BINS) and max(seen) == 0.0


# ---------------------------------------------------------------------------
# phase 10's tables
# ---------------------------------------------------------------------------

def test_mslr_table_is_group_contiguous_and_bounded():
    """MSLR-WEB10K's shape: the group sizes sum to the row count, stay
    within 908 with a mean near 120 and a tail near the cap, and each
    query's rows are contiguous; labels 0-4, 136 features."""
    import numpy as np

    sizes = cs.mslr_group_sizes(cs.MSLR_QUERIES)
    assert len(sizes) == cs.MSLR_QUERIES
    assert sizes.min() >= 1 and sizes.max() <= cs.MSLR_MAX_GROUP == 908
    assert 110 <= sizes.mean() <= 130 and sizes.max() >= 800
    assert 1_100_000 <= sizes.sum() <= 1_300_000
    X, y, query, sz = cs.mslr_like(200, seed=1)
    assert X.shape == (int(sz.sum()), cs.MSLR_FEATURES) == (len(y), 136)
    assert set(np.unique(y)) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    assert (y == 0).mean() > 0.4 and (y == 4).any()
    starts = np.concatenate([[0], np.cumsum(sz)[:-1]])
    assert np.array_equal(query[starts], np.arange(200))
    assert np.all(np.diff(query) >= 0)               # group-contiguous
    _, counts = np.unique(query, return_counts=True)
    assert np.array_equal(counts, sz)


def test_covertype_table_takes_all_seven_classes():
    import numpy as np

    X, y = cs.covertype_like(20_000)
    assert X.shape == (20_000, 54) and X.dtype == np.float32
    assert set(np.unique(y)) == set(range(cs.COVTYPE_CLASSES))
    onehot = X[:, cs.COVTYPE_NUMERIC:]
    assert np.all(onehot[:, :4].sum(1) == 1)         # one wilderness area
    assert np.all(onehot[:, 4:].sum(1) == 1)         # one soil type


def test_lambdarank_pair_budget_bounds_every_chunk_at_mslr_shape():
    """At MSLR-WEB10K's group sizes the pair matrices of all queries at
    once would take (Q, 908, 908) floats; each chunk of the port's layout
    stays within the pair budget, and every document is in one chunk."""
    import numpy as np

    from synapseml_tpu_torch.gbdt import objectives as tobj

    sizes = cs.mslr_group_sizes(cs.MSLR_QUERIES)
    gi = tobj.make_grouped(np.zeros(int(sizes.sum()), np.float32), sizes)
    assert gi.size * gi.shape[1] * 4 > 30e9          # the one-shot layout
    chunks = tobj.query_chunks(gi, tobj.PAIR_BUDGET)
    assert all(c.size * c.shape[1] <= tobj.PAIR_BUDGET for c in chunks)
    assert sum(int((c >= 0).sum()) for c in chunks) == int(sizes.sum())
    assert sum(len(c) for c in chunks) == cs.MSLR_QUERIES


def test_regression_labels_stay_in_each_objectives_domain():
    import numpy as np

    _, margin = cs.higgs_margin(5000)
    for objective in cs.REGRESSION_OBJECTIVES:
        y = cs.regression_label(objective, margin)
        assert y.dtype == np.float32 and np.isfinite(y).all()
        if objective == "gamma":
            assert (y > 0).all()
        elif objective in ("poisson", "tweedie"):
            assert (y >= 0).all() and (y == np.floor(y)).all()
        elif objective == "cross_entropy":
            assert ((y >= 0) & (y <= 1)).all()


def test_family_phases_run_on_the_plain_versions(no_timing, monkeypatch):
    """Phase 10 on the CPU at small sizes. The plain versions launch no
    kernel, so the full-width fits' launch check refuses the run; with the
    grower's kernel names wrapped by counting stand-ins every fit, check
    and cross-check (CPU against CPU) passes."""
    from synapseml_tpu_torch.gbdt import grower, grower_depthwise

    monkeypatch.setattr(cs, "COVTYPE_ROWS", 3000)
    monkeypatch.setattr(cs, "MSLR_QUERIES", 25)
    monkeypatch.setattr(cs, "FAMILY_ITERS", 3)
    monkeypatch.setattr(cs, "FAMILY_CROSS_ROWS", 1200)
    monkeypatch.setattr(cs, "FAMILY_CROSS_ITERS", 1)
    with pytest.raises(AssertionError, match="never launched"):
        cs.family_full_width(3000, "cpu")
    for mod, names in ((grower, ("child_histogram", "range_histogram")),
                       (grower_depthwise, ("level_histograms",))):
        for name in names:
            def counted(*a, _f=getattr(mod, name), _n=name, **k):
                hk.LAUNCHES[_n] += 1
                return _f(*a, **k)
            monkeypatch.setattr(mod, name, counted)
    cs.family_full_width(3000, "cpu")
    cs.family_cross_check("cpu")


def _count_grower_launches(monkeypatch):
    """Wrap the grower modules' kernel names with counting stand-ins (the
    plain versions launch nothing)."""
    from synapseml_tpu_torch.gbdt import grower, grower_depthwise

    for mod, names in ((grower, ("child_histogram", "range_histogram")),
                       (grower_depthwise, ("level_histograms",))):
        for name in names:
            def counted(*a, _f=getattr(mod, name), _n=name, **k):
                hk.LAUNCHES[_n] += 1
                return _f(*a, **k)
            monkeypatch.setattr(mod, name, counted)


def test_surface_phase_runs_on_the_plain_versions(monkeypatch):
    """Phase 12 on the CPU at small sizes: without launches the first fit's
    check refuses the run; with counting stand-ins every step passes (the
    card-against-CPU curve is CPU against CPU here), and a best score moved
    off the AUC of the forest it names is refused."""
    monkeypatch.setattr(cs, "SURFACE_ITERS", 30)
    monkeypatch.setattr(cs, "SURFACE_ESR", 3)
    monkeypatch.setattr(cs, "SURFACE_SHAP_ROWS", 8)
    monkeypatch.setattr(cs, "SURFACE_WARM_ITERS", 2)
    monkeypatch.setattr(cs, "SURFACE_SMALL_ROWS", 1500)
    monkeypatch.setattr(cs, "SURFACE_SMALL_ITERS", 8)
    with pytest.raises(AssertionError, match="never launched"):
        cs.surface_path(3000, "cpu")
    _count_grower_launches(monkeypatch)
    fits = cs.surface_path(3000, "cpu")
    booster = fits["depthwise"]["booster"]
    assert fits["leafwise"]["launches"]["range_histogram"] > 0
    assert booster.num_trees <= cs.SURFACE_ITERS
    X, y = cs.higgs_like(3000)
    Xv, yv = X[-cs.surface_split(3000):], y[-cs.surface_split(3000):]
    booster.best_score += 1e-4
    with pytest.raises(AssertionError, match="best_score"):
        cs.check_early_stop("moved", booster, Xv, yv, "cpu",
                            cs.SURFACE_ITERS)


def test_vision_flops_match_a_hand_count():
    """Phase 11's FLOP counter against the multiply-adds of each layer,
    counted by hand: a one-block bottleneck ResNet with the CIFAR stem at
    8x8, and a two-block basic ResNet with the ImageNet stem at 16x16
    (7x7 stride 2 -> 8x8, max-pool -> 4x4, then a stride-2 block -> 2x2)."""
    from synapseml_tpu_torch.dl.backbones import (BottleneckBlock, ResNet,
                                                  ResNetBlock)

    small = ResNet([1], BottleneckBlock, 10, width=8, small_images=True)
    got = cs.vision_layer_flops(small, (8, 8, 3), "cpu")
    want = [("stem_conv", 2 * 64 * 3 * 3 * 3 * 8),
            ("BottleneckBlock_0.Conv_0", 2 * 64 * 8 * 8),
            ("BottleneckBlock_0.Conv_1", 2 * 64 * 3 * 3 * 8 * 8),
            ("BottleneckBlock_0.Conv_2", 2 * 64 * 8 * 32),
            ("BottleneckBlock_0.Conv_3", 2 * 64 * 8 * 32),
            ("head", 2 * 32 * 10)]
    assert got == want
    total = sum(f for _, f in want)
    assert cs.vision_step_flops(got, 4) == 4 * (3 * total - want[0][1])

    stem = ResNet([1, 1], ResNetBlock, 10, width=8)
    got = cs.vision_layer_flops(stem, (16, 16, 3), "cpu")
    assert got == [("stem_conv", 2 * 64 * 7 * 7 * 3 * 8),
                   ("ResNetBlock_0.Conv_0", 2 * 16 * 9 * 8 * 8),
                   ("ResNetBlock_0.Conv_1", 2 * 16 * 9 * 8 * 8),
                   ("ResNetBlock_1.Conv_0", 2 * 4 * 9 * 8 * 16),
                   ("ResNetBlock_1.Conv_1", 2 * 4 * 9 * 16 * 16),
                   ("ResNetBlock_1.Conv_2", 2 * 4 * 8 * 16),
                   ("head", 2 * 16 * 10)]


def test_vision_bound_is_float32_off_the_tensor_cores_or_bf16():
    assert cs.vision_bound_ms(67e12, "float32") == pytest.approx(1e3)
    assert cs.vision_bound_ms(989e12, "bfloat16") == pytest.approx(1e3)
    # ResNet-50: the stem, 16 blocks of 3 convolutions, 4 projections and
    # the head (on the meta device: shapes only, nothing drawn or computed)
    from synapseml_tpu_torch.dl import make_backbone

    with torch.device("meta"):
        resnet50 = make_backbone("resnet50", 10)
    flops = cs.vision_layer_flops(resnet50, (224, 224, 3), "meta")
    assert len(flops) == 1 + 16 * 3 + 4 + 1
    assert sum(f for _, f in flops) == 8_174_313_472    # PERF.md's count
    step = cs.vision_step_flops(flops, 16)
    assert cs.vision_bound_ms(step, "float32") == pytest.approx(
        step / 67e12 * 1e3)


def test_check_frozen_rejects_a_moved_frozen_parameter():
    from synapseml_tpu_torch.dl import make_backbone

    net = make_backbone("resnet18", 10)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith(("ResNetBlock_6", "ResNetBlock_7", "head")):
                p.add_(1.0)
        for name, b in net.named_buffers():
            b.add_(1.0)
    cs.check_frozen("ok", net, init, 2)
    with torch.no_grad():
        net.ResNetBlock_0.Conv_0.kernel[0, 0, 0, 0] += 1e-3
    with pytest.raises(AssertionError, match="frozen"):
        cs.check_frozen("moved", net, init, 2)
    with pytest.raises(AssertionError, match="frozen"):
        cs.check_frozen("all trained", net, init, -1)


# ---------------------------------------------------------------------------
# phase 13: sampling and monotone constraints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(boosting_type="dart"),
    dict(boosting_type="dart", uniform_drop=True, xgboost_dart_mode=True,
         skip_drop=0.2, drop_rate=0.4, max_drop=2),
    dict(boosting_type="dart", drop_seed=7, skip_drop=0.1),
])
def test_dart_weight_replay_is_a_dart_fits_weights(cfg):
    """The host replay that phase 13 holds the card's DART weights to
    gives a CPU fit's weights exactly, drops included."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    X, y = cs.higgs_like(600)
    full = dict(objective="binary", num_iterations=12, num_leaves=7,
                min_data_in_leaf=5, **cfg)
    booster = train_booster(X, y, BoosterConfig(**full), device="cpu")
    want = cs.dart_weight_replay(full, 12)
    assert booster.tree_weights == want
    assert min(want) < 1.0


def test_monotone_check_rejects_a_split_out_of_order():
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    X, y = cs.higgs_like(1500)
    booster = train_booster(X, y, BoosterConfig(
        objective="binary", num_iterations=3, num_leaves=15,
        monotone_constraints=[0, 0, 1]), device="cpu")
    cs.monotone_check(booster, "cpu")
    tree = booster.trees[0]
    i = int(np.nonzero(np.asarray(tree.split_feature)[:int(tree.num_splits)]
                       == cs.MONOTONE_FEATURE)[0][0])
    # swap the two children of one split on X2: the order breaks
    lc, rc = tree.left_child.copy(), tree.right_child.copy()
    lc[i], rc[i] = rc[i], lc[i]
    booster.trees[0] = tree._replace(left_child=lc, right_child=rc)
    with pytest.raises(AssertionError, match="monotone"):
        cs.monotone_check(booster, "cpu")


def test_captured_call_clones_one_calls_arguments_and_restores():
    def real(x, n):
        return n

    module = SimpleNamespace(kernel=real)
    x = torch.zeros(3)
    with cs.captured_call(module, "kernel", 1) as got:
        for v in (1.0, 2.0, 3.0):
            x.fill_(v)
            assert module.kernel(x, int(v)) == int(v)
    assert module.kernel is real
    # the second call's tensor as it was then, not as the caller left it
    assert torch.equal(got["args"][0], torch.full((3,), 2.0))
    assert got["args"][1] == 2


def test_sampling_phase_runs_on_the_plain_versions(monkeypatch):
    """Phase 13 on the CPU at small sizes: without launches the first fit's
    check refuses the run; with counting stand-ins every step passes (the
    bitwise and card-against-CPU checks are CPU against CPU here)."""
    monkeypatch.setattr(cs, "SAMPLING_ITERS", 8)
    monkeypatch.setattr(cs, "MONOTONE_ROWS", 50)
    monkeypatch.setattr(cs, "SAMPLING_CROSS_ROWS", 1000)
    monkeypatch.setattr(cs, "SAMPLING_CROSS_ITERS", 1)
    plain = {"child_histogram": 10, "range_histogram": 300,
             "level_histograms": 60}
    with pytest.raises(AssertionError, match="never launched"):
        cs.sampling_path(2500, "cpu", plain)
    _count_grower_launches(monkeypatch)
    fits = cs.sampling_path(2500, "cpu", plain)
    assert fits["goss leafwise"]["launches"]["range_histogram"] > 0
    assert fits["dart depthwise"]["launches"]["level_histograms"] > 0
    assert fits["rf leafwise"]["booster"].average_output


def test_kernel_timer_brackets_each_launch_and_restores_the_library(
        monkeypatch):
    """Phase 13's kernel timer on a stand-in library: each launch of a
    histogram function gets a start and an end event, other functions pass
    through, and the built library is back in place after the block."""
    from synapseml_tpu_torch.ops import _build

    class Event:
        def __init__(self, enable_timing):
            self.recorded = 0

        def record(self):
            self.recorded += 1

        def elapsed_time(self, end):
            return 0.5

    lib = SimpleNamespace(child_histogram=lambda *a: 0,
                          other=lambda: "passed")
    monkeypatch.setattr(cs, "_on_card", lambda dev: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(hk, "_lib", lambda: lib)
    monkeypatch.setitem(_build._LIBS, "hist_kernel", lib)
    with cs.kernel_timer("cuda") as events:
        timed = _build._LIBS["hist_kernel"]
        assert timed.child_histogram(1, 2) == 0
        assert timed.child_histogram(3) == 0
        assert timed.other() == "passed"
    assert _build._LIBS["hist_kernel"] is lib
    assert len(events["child_histogram"]) == 2
    assert all(s.recorded == e.recorded == 1
               for s, e in events["child_histogram"])
    assert cs.timed_ms(events)["child_histogram"] == 1.0


def test_covertype_folds_to_its_raw_ids_and_its_one_hot_csr():
    """Phase 14's tables: the one-hot blocks fold to the wilderness and soil
    ids (``covtype.data``'s 12 columns), and the one-hot table as CSR holds
    12 entries per row (LIBSVM's ``covtype``) and densifies back."""
    X, _ = cs.covertype_like(500, seed=2)
    Xc = cs.fold_one_hot(X)
    num = cs.COVTYPE_NUMERIC
    assert Xc.shape == (500, num + 2)
    np.testing.assert_array_equal(Xc[:, :num], X[:, :num])
    for col, lo, width in ((num, num, cs.COVTYPE_WILD),
                           (num + 1, num + cs.COVTYPE_WILD, cs.COVTYPE_SOIL)):
        ids = Xc[:, col].astype(int)
        assert ids.min() >= 0 and ids.max() < width
        assert (X[np.arange(500), lo + ids] == 1.0).all()
    csr = cs.covtype_csr(X)
    assert csr.nnz == 12 * 500
    np.testing.assert_array_equal(csr.toarray(), X)


def _tree(features, words, B=256):
    """A stand-in tree of categorical splits on ``features`` whose bitsets
    hold ``words`` (one int per split, the first word)."""
    n = len(features)
    bits = np.zeros((n, B // 32), np.uint32)
    bits[:, 0] = words
    return SimpleNamespace(num_splits=n, split_type=np.ones(n, np.int32),
                           split_feature=np.asarray(features),
                           cat_bitset=bits)


def test_split_mode_check_wants_one_vs_rest_and_category_sets():
    wild, soil = cs.CAT_FEATURES
    good = SimpleNamespace(trees=[_tree([wild, soil, soil],
                                        [0b100, 0b1, 0b1011])])
    assert cs.category_sets(good, soil) == [1, 3]
    cs.check_split_modes("good", good)
    for trees in ([_tree([wild, soil], [0b11, 0b111])],   # wild set of 2
                  [_tree([wild, soil], [0b1, 0b1])],      # soil sets of 1
                  [_tree([soil], [0b111])]):              # no wild split
        with pytest.raises(AssertionError, match="one-vs-rest"):
            cs.check_split_modes("bad", SimpleNamespace(trees=trees))


def test_sync_check_holds_categorical_trees_to_the_numeric_count():
    """Leaf-wise: exactly one read for the root and one per split;
    depthwise: at most one per level and the root's."""
    tree = SimpleNamespace(num_splits=3, left_child=np.array([1, ~0, ~1]),
                           right_child=np.array([2, ~2, ~3]))
    booster = SimpleNamespace(trees=[tree, tree], num_trees=2,
                              metadata={"host_syncs": 8})
    assert cs.check_syncs("leafwise", booster, "leafwise") == 4.0
    booster.metadata["host_syncs"] = 6
    assert cs.check_syncs("depthwise", booster, "depthwise") == 3.0
    for policy, syncs in (("leafwise", 9), ("depthwise", 7)):
        booster.metadata["host_syncs"] = syncs
        with pytest.raises(AssertionError, match="host syncs"):
            cs.check_syncs(policy, booster, policy)


@pytest.fixture(scope="module")
def serving_models():
    """Phase 15's inputs at a small size on the CPU: a HIGGS-shaped binary
    classifier with validation rows, a 7-class model with two categorical
    columns on the folded Covertype table, and a second binary model for
    the hot swap."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.models import LightGBMClassifier

    X, y = cs.higgs_like(3000)
    first = LightGBMClassifier(numIterations=6, numLeaves=15,
                               device="cpu").fit(cs.table_of(X[:2000],
                                                             y[:2000]))
    second = LightGBMClassifier(numIterations=3, numLeaves=7,
                                device="cpu").fit(cs.table_of(X[:2000],
                                                              y[:2000]))
    Xc, yc = cs.covertype_like(2000)
    Xc = cs.fold_one_hot(Xc)
    cat = LightGBMClassifier(numIterations=2, numLeaves=7,
                             categoricalSlotIndexes=cs.CAT_FEATURES,
                             device="cpu").fit(Table({"features": Xc,
                                                      "label": yc}))
    return first.booster, X[2000:], cat, Xc, second.booster


def _small_serving(monkeypatch):
    for name, value in (("SERVE_SIZES", (1, 8, 64)), ("SERVE_CALLS", 3),
                        ("SERVE_PREDICT_BATCH", 256), ("SERVE_CLIENTS", 6),
                        ("SERVE_HIGGS_REQUESTS", 160),
                        ("SERVE_COVTYPE_REQUESTS", 40), ("SERVE_BURST", 40)):
        monkeypatch.setattr(cs, name, value)


def test_serving_phase_runs_on_the_cpu(serving_models, monkeypatch):
    """Phase 15 on the CPU at small sizes: every step and check passes (the
    runner calls the model eagerly on each padded rung here)."""
    _small_serving(monkeypatch)
    out = cs.serving_path("cpu", *serving_models)
    assert out["load"]["p99_ms"] >= out["load"]["p50_ms"] > 0
    assert out["overload"]["shed"] > 0
    assert out["predict"]["gap"] == 0.0
    assert out["per_rung"] == {}      # nothing is captured on the CPU


def test_serving_phase_refuses_a_wrong_reply(serving_models, monkeypatch):
    """A handler whose replies are 1e-5 off ``predict`` fails the load
    check."""
    _small_serving(monkeypatch)
    booster, Xv, cat, Xc, swap = serving_models
    serve, _ = cs.serving_warmup(booster, "cpu")
    real = cs._serve_handler

    def off(serve):
        inner = real(serve)

        def handler(df):
            out = inner(df)
            return out.with_column("reply", out["reply"] + 1e-5)

        handler.warmup, handler.runner = inner.warmup, inner.runner
        return handler

    monkeypatch.setattr(cs, "_serve_handler", off)
    from synapseml_tpu_torch.core import PipelineStage

    with tempfile.TemporaryDirectory() as tmp:
        cat.save(tmp)
        stage = PipelineStage.load(tmp, device="cpu")
    with pytest.raises(AssertionError, match="none of"):
        cs.serving_load(serve, booster, swap, stage, Xv, Xc, "cpu")


# --- phase 16's helpers ---------------------------------------------------------

def test_spec_state_bytes_counts_blocks_moments_and_counts():
    """A (4, 6) tensor cut in two, a (3,) one whole, two moments and two
    int32 counts: (12 + 3) floats x 3 + 8 bytes."""
    got = cs.spec_state_bytes([(4, 6), (3,)], [0, None], 2, moments=2,
                              counts=2)
    assert got == (12 + 3) * 4 * 3 + 8
    assert cs.spec_state_bytes([(4, 6)], [None], 2, 0, 1) == 24 * 4 + 4


def test_spec_state_bytes_is_the_trainers_count_under_zero():
    """The helper from the shard specs and ``Trainer.state_bytes_per_rank``
    agree for a ZeRO trainer's blocks (its optimizer set up without a
    world: the specs of a two-rank data axis)."""
    from synapseml_tpu_torch.dl import make_backbone
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer
    from synapseml_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"data": 2}, 0, {"data": 0}, {}, torch.device("cpu"))
    tr = Trainer(make_backbone("tiny", 3), TrainConfig(
        param_sharding="zero"), mesh=mesh, device="cpu")
    tr._setup_state(4, zero=True)
    opt = tr.optimizer
    want = cs.spec_state_bytes(opt.whole_shapes, [s.dim for s in tr.specs],
                               2, moments=2, counts=2)
    assert tr.state_bytes_per_rank() == want
    whole = cs.spec_state_bytes(opt.whole_shapes, [None] * len(tr.specs), 2,
                                moments=2, counts=2)
    assert want < 0.6 * whole


def test_state_mismatches_sees_one_flipped_bit_and_structure():
    a = {"params": {"w": torch.arange(6, dtype=torch.float32)},
         "opt_state": (torch.tensor(3, dtype=torch.int32),)}
    b = {"params": {"w": a["params"]["w"].clone()},
         "opt_state": (a["opt_state"][0].clone(),)}
    assert cs.state_mismatches(a, b) == []
    b["params"]["w"].view(torch.int32)[2] ^= 1
    assert cs.state_mismatches(a, b) == ["['params']['w']"]
    assert cs.state_mismatches(a, {"params": a["params"]}) == ["<structure>"]
    c = {"params": {"w": a["params"]["w"].double()},
         "opt_state": a["opt_state"]}
    assert cs.state_mismatches(a, c) == ["['params']['w']"]


# --- phase 17: distributed GBDT -------------------------------------------------

def test_dist_phase_is_listed_and_runs_after_phase_16():
    import inspect

    assert "17. distributed GBDT" in cs.__doc__
    src = inspect.getsource(cs.main)
    assert src.index("state_path(dev)") \
        < src.rindex("dist_path(args.rows, dev)")
    assert "tmp.spawn(_dist_rank" in inspect.getsource(cs.dist_path)
    assert [n for n, _ in cs.DIST_RUNS] == [
        "data_f32", "data_bf16", "data_int8", "feature", "voting", "auto",
        "depthwise"]


def _passing_reports(world=2, rows=8):
    """Two ranks' reports and evaluation probabilities that pass every
    phase-17 check."""
    parts = [cs.quantized_inputs(r, world) for r in range(world)]
    total = np.sum([p[0].astype(np.float64) for p in parts], axis=0)
    rs = np.sum([p[1].astype(np.float64) for p in parts], axis=0)
    chunk = rs.shape[0] // world
    prob = np.linspace(0.1, 0.9, rows)
    reports = [dict(runs={name: dict(model_sha="abc", launches={
        "child_histogram": 1, "range_histogram": 3, "level_histograms": 2})
        for name, _ in cs.DIST_RUNS}, identity={
        "f32": {"shape": [[[0], [3]]], "prob": prob.tolist()},
        "int8": {"shape": [[[0], [3]]], "prob": prob.tolist()},
        "feature": {"shape": [[[0], [3]]], "prob": prob.tolist()}},
        quantized={"allreduce": total.tolist(),
                   "reduce_scatter": rs[r * chunk:(r + 1) * chunk].tolist()})
        for r in range(world)]
    ye = (np.arange(rows) >= rows // 2).astype(np.float32)
    probs = {name: prob.astype(np.float32) for name, _ in cs.DIST_RUNS}
    return reports, probs, prob.astype(np.float32), ye


@pytest.mark.parametrize("fault,message", [
    ("sha", "model strings differ"), ("launch", "never launched"),
    ("auc", "against the JAX package"), ("quantized", "differs on rank 1"),
    ("identity", "int8 trees differ")])
def test_dist_checks_refuse_each_failure(fault, message):
    """A passing set of reports passes; each planted fault raises naming
    itself (an uncaught AssertionError makes the script exit non-zero)."""
    reports, probs, p_one, ye = _passing_reports()
    ref = {"f32": 1.0, "bf16": 1.0, "int8": 1.0}
    assert cs.dist_checks(reports, probs, p_one, ye, ref)["prob_gap"] == 0
    import copy

    reports = copy.deepcopy(reports)
    if fault == "sha":
        reports[1]["runs"]["feature"] = dict(reports[1]["runs"]["feature"],
                                             model_sha="abd")
    elif fault == "launch":
        reports[0]["runs"]["depthwise"] = dict(
            reports[0]["runs"]["depthwise"],
            launches={"child_histogram": 1, "range_histogram": 1,
                      "level_histograms": 0})
    elif fault == "auc":
        ref = dict(ref, bf16=0.99)
    elif fault == "quantized":
        reports[1]["quantized"]["allreduce"][0][0] += 1e-3
    else:
        reports[0]["identity"]["int8"]["shape"] = [[[1], [3]]]
    with pytest.raises(AssertionError, match=message):
        cs.dist_checks(reports, probs, p_one, ye, ref)


def test_quantized_bound_is_n_half_shared_scales():
    a = np.zeros((1, 256), np.float32)
    b = np.zeros((1, 256), np.float32)
    a[0, 3], b[0, 7] = 127.0, -254.0
    np.testing.assert_allclose(cs.quantized_bound([a, b]),
                               np.full((1, 256), 2 * 2.0 / 2))


def test_dist_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 17 end to end on the CPU at a small size: the spawn, every
    run and every check; the plain versions count no launches, so the
    launch check, and only it and the size-bound AUC checks, refuses."""
    monkeypatch.setattr(cs, "DIST_ITERS", 1)
    monkeypatch.setattr(cs, "DIST_EVAL_ROWS", 300)
    monkeypatch.setattr(cs, "DIST_DECISIVE_ROWS", 600)
    with pytest.raises(AssertionError, match="never launched") as err:
        cs.dist_path(2001, "cpu")
    msg = str(err.value)
    for ok in ("differ across ranks", "quantized", "one process",
               "feature against data"):
        assert ok not in msg, msg


# --- phase 18: ONNX inference ----------------------------------------------------

def test_onnx_phase_is_listed_and_runs_after_phase_17():
    import inspect

    assert "18. ONNX inference" in cs.__doc__
    src = inspect.getsource(cs.main)
    assert src.rindex("dist_path(args.rows, dev)") \
        < src.rindex('onnx_path(dev, main["booster"], card)')
    assert [(n, b, p) for n, _, _, b, p in cs.ONNX_MODELS] == [
        ("resnet50", 64, ("float32", "bfloat16")),
        ("bert_base", 32, ("float32",))]


def test_onnx_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 18 end to end on the CPU at tiny widths: generation, the
    transforms on the runner's rungs, the CPU cross-check, every committed
    fixture and a small booster through ``to_onnx``; and the relative-gap
    check refuses an output off its bound, the bf16 check a bf16 output
    that is the float32 one."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    monkeypatch.setattr(cs, "ONNX_MODELS", (
        ("resnet18", "make_resnet", dict(depth=18, num_classes=10,
                                         image_size=16), 4,
         ("float32", "bfloat16")),
        ("encoder", "make_transformer_encoder",
         dict(num_layers=1, d_model=16, num_heads=2, seq_len=4, d_ff=32,
              num_classes=2), 4, ("float32",))))
    monkeypatch.setattr(cs, "ONNX_TIMED", 1)
    monkeypatch.setattr(cs, "ONNX_FULL_BATCHES", 3)
    monkeypatch.setattr(cs, "ONNX_TREE_ROWS", 1000)
    monkeypatch.setattr(cs, "ONNX_TREE_BATCH", 256)
    X, y = cs.higgs_like(2000, seed=4)
    booster = train_booster(X, y, BoosterConfig(
        objective="binary", num_iterations=3, num_leaves=7), device="cpu")
    out = cs.onnx_path("cpu", booster)
    assert [m["label"] for m in out["models"]] == [
        "resnet18 float32", "resnet18 bfloat16", "encoder float32"]
    assert all(m["rows"] == 3 * 4 + 5 for m in out["models"])
    assert out["models"][0]["cpu_gap"] == 0.0     # the same CPU run twice
    assert out["models"][1]["f32_gap"] > out["models"][1]["cpu_gap"]
    head = np.ones((2, 3))
    with pytest.raises(AssertionError, match="from the card's float32"):
        cs.onnx_bf16_against_f32("planted", dict(head=head),
                                 dict(head=head, cpu_gap=0.004), "")
    assert len(out["fixtures"]) == 12
    assert out["tree"]["gap"] <= 1e-5
    with pytest.raises(AssertionError, match="above 0.001"):
        cs.onnx_rel_gap("planted", np.ones(3) * 1.01, np.ones(3), 1e-3)


def test_stream_phase_runs_on_the_plain_versions(monkeypatch):
    """Phase 19 on the CPU at small sizes: the plain versions launch no
    kernel, so the first streamed fit's launch check refuses the run; with
    counting stand-ins for the streamed grower's kernel names every check
    passes (the card-against-CPU check is CPU against CPU here), and a
    sketch that left its exact regime is refused."""
    from synapseml_tpu_torch.gbdt import stream

    monkeypatch.setattr(cs, "STREAM_VALID_ROWS", 4000)
    monkeypatch.setattr(cs, "STREAM_SOURCE_ROWS", 6000)
    monkeypatch.setattr(cs, "STREAM_PREFIX_ROWS", 5000)
    monkeypatch.setattr(cs, "STREAM_CROSS_ROWS", 4000)
    monkeypatch.setattr(cs, "STREAM_ITERS", 3)
    monkeypatch.setattr(cs, "STREAM_CROSS_ITERS", 1)
    with pytest.raises(AssertionError, match="never launched"):
        cs.stream_path("cpu", rows=20_000)
    for name in ("child_histogram", "level_histograms"):
        def counted(*a, _f=getattr(stream, name), _n=name, **k):
            hk.LAUNCHES[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(stream, name, counted)
    out = cs.stream_path("cpu", rows=20_000)
    assert out["leafwise"]["child_histogram"] > 0
    assert out["depthwise"]["level_histograms"] > 0
    cfg = SimpleNamespace(max_bin=255, bin_sample_count=1000, seed=0)
    with pytest.raises(AssertionError, match="exact regime"):
        cs.sketch_prefix_check(cfg)


# --- phase 20: GBDT across ranks and layouts -------------------------------------

def test_ranks_layouts_phase_is_listed_and_runs_after_phase_19():
    import inspect

    assert "20. GBDT across ranks and layouts" in cs.__doc__
    src = inspect.getsource(cs.main)
    assert src.index("streamed = stream_path(dev)") \
        < src.rindex('ranks_layouts_path(args.rows, dev, streamed["auc"])')
    assert "tmp.spawn(_mp_rank" in inspect.getsource(cs.mp_path)
    assert "tmp.spawn(_mesh_stream_rank" in inspect.getsource(
        cs.mesh_stream_path)
    assert [n for n, _ in cs.LAYOUT_RUNS] == [
        "partition", "gather", "masked", "sort32", "scan", "scatter",
        "unsegmented"]
    # phase 13 was cut from 50 iterations a sampling mode to make room for
    # phase 20, and to 10 for phase 21
    assert cs.SAMPLING_ITERS == 10
    assert "numIterations=10" in cs.__doc__


def _layout_fits():
    launch = {"child_histogram": 10, "range_histogram": 300,
              "level_histograms": 0}
    return {name: dict(launches=dict(launch), auc=0.9, shape=[[[0], [3]]])
            for name, _ in cs.LAYOUT_RUNS}


def _mesh_reports(world=2):
    runs = {name: dict(model_sha="abc", auc=0.9, launches={
        "child_histogram": 1, "range_histogram": 0, "level_histograms": 1})
        for name in ("leafwise", "depthwise", "resident", "f32_prefix",
                     "bf16_prefix", "int8_prefix")}
    import copy

    shape = [[[0], [3], [-1], [-2]]]
    return [dict(runs=copy.deepcopy(runs), identity={
        "f32": shape, "bf16": shape, "int8": shape}) for _ in range(world)]


def _mp_reports(world=2):
    runs = {policy: dict(model_sha="abc", mapper_sha="m", launches={
        "child_histogram": 1, "range_histogram": 1, "level_histograms": 1})
        for policy in ("leafwise", "depthwise")}
    import copy

    return [dict(runs=copy.deepcopy(runs)) for _ in range(world)]


@pytest.mark.parametrize("fault,message", [
    ("layout_auc", "against partition's"),
    ("layout_launch", "never launched"),
    ("mp_sha", "model strings differ"),
    ("mp_mapper", "not the gathered sample's"),
    ("mp_prob", "from one process"),
    ("mesh_sha", "model strings differ"),
    ("mesh_auc", "the one-process streamed fit's"),
    ("mesh_lossy", "f32's on the same rows"),
    ("mesh_identity", "int8 trees differ from f32's by more than a bin")])
def test_phase_20_checks_refuse_each_failure(fault, message):
    """Passing readings pass; each planted fault is reported naming itself
    (phase 20 raises them all at its end: the script exits non-zero)."""
    fits, mesh, mpr = _layout_fits(), _mesh_reports(), _mp_reports()
    probs = {p: np.linspace(0.1, 0.9, 8) for p in ("leafwise", "depthwise")}
    p_one = {p: v.copy() for p, v in probs.items()}
    ref = 0.9
    assert cs.layout_checks(fits) == []
    assert cs.mp_checks(mpr, probs, p_one, "m") == []
    assert cs.mesh_stream_checks(mesh, ref) == []
    fits["gather"]["shape"] = [[[1], [3]]]        # a tie: logged, not failed
    assert cs.layout_checks(fits) == []
    if fault == "layout_auc":
        fits["masked"]["auc"] = 0.9 + 2e-3
    elif fault == "layout_launch":
        fits["partition"]["launches"]["range_histogram"] = 0
    elif fault == "mp_sha":
        mpr[1]["runs"]["depthwise"]["model_sha"] = "abd"
    elif fault == "mp_mapper":
        mpr[0]["runs"]["leafwise"]["mapper_sha"] = "n"
    elif fault == "mp_prob":
        probs["leafwise"] = probs["leafwise"] + 6e-3
    elif fault == "mesh_sha":
        mesh[1]["runs"]["resident"]["model_sha"] = "abd"
    elif fault == "mesh_auc":
        ref = 0.9 - 2e-3
    elif fault == "mesh_lossy":
        # a lossy wire may land on the other side of the table's near tie
        mesh[0]["runs"]["int8_prefix"]["auc"] = 0.9 - 0.009
        assert cs.mesh_stream_checks(mesh, ref) == []
        mesh[0]["runs"]["int8_prefix"]["auc"] = 0.9 - 0.011
    else:
        # one bin off is the reference's own int8 noise; two is not
        mesh[0]["identity"]["int8"] = [[[0], [4], [-1], [-2]]]
        assert cs.mesh_stream_checks(mesh, ref) == []
        mesh[0]["identity"]["int8"] = [[[0], [5], [-1], [-2]]]
    bad = (cs.layout_checks(fits) + cs.mp_checks(mpr, probs, p_one, "m")
           + cs.mesh_stream_checks(mesh, ref))
    assert len(bad) == 1 and message in bad[0], bad


def test_ranks_layouts_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 20 end to end on the CPU at small sizes: the primitives, every
    layout fit, both spawns and every check; the plain versions count no
    launches, so the launch checks, and only they, refuse the run."""
    import dataclasses

    from synapseml_tpu_torch.gbdt import (BoosterConfig, StreamedDataset,
                                          train_booster_streamed)

    for name, value in dict(
            LAYOUT_ITERS=2, DIST_EVAL_ROWS=2000, PARTITION_KEYS=10_000,
            STREAM_ROWS=40_000, STREAM_SOURCE_ROWS=10_000,
            STREAM_VALID_ROWS=4000, STREAM_ITERS=2, MESH_LOSSY_ROWS=20_000,
            MP_ITERS=2).items():
        monkeypatch.setattr(cs, name, value)
    # the one-process streamed fit phase 19 would have made of the stream
    cfg = BoosterConfig(objective="binary", num_iterations=cs.STREAM_ITERS,
                        num_leaves=31, max_bin=255)
    one = train_booster_streamed(
        StreamedDataset(cs.stream_source(cs.STREAM_ROWS, cs.STREAM_SEED),
                        num_features=cs.FEATURES), dataclasses.replace(cfg),
        device="cpu")
    Xv, yv = cs._whole(cs.stream_source(cs.STREAM_VALID_ROWS,
                                        cs.STREAM_VALID_SEED))
    with pytest.raises(AssertionError, match="never launched") as err:
        cs.ranks_layouts_path(20_000, "cpu",
                              cs._heldout_auc(one, Xv, yv, "cpu"))
    msg = str(err.value)
    for ok in ("differ across ranks", "AUC", "from one process",
               "gathered sample", "decisive fixture"):
        assert ok not in msg, msg


def test_pipeline_phase_hang_and_step_log():
    """Phase 21's pieces that need no ranks (its rehearsal is
    ``tests/test_torch_chip_smoke_pipeline.py``): the planted hang blocks
    the first matching op only, raises once released and leaves the hook
    slot empty; the step log turns a pipeline step's seconds into its ms,
    idle share and images per second."""
    import threading
    import time as _time

    from synapseml_tpu_torch.parallel import collectives as C

    hang = cs._Hang("transfer.hop", at_call=2, hang_s=30.0)
    with hang:
        assert C._CHAOS_HOOK is not None
        C._chaos("all_gather")              # another op: not counted
        C._chaos("transfer.hop")            # the first hop passes
        box = {}

        def second():
            try:
                C._chaos("transfer.hop")
            except RuntimeError as e:
                box["err"] = e
        t = threading.Thread(target=second, daemon=True)
        t.start()
        _time.sleep(0.05)
        assert t.is_alive() and hang.hung == ["transfer.hop"]
    t.join(timeout=5)
    assert not t.is_alive() and "released" in str(box["err"])
    assert C._CHAOS_HOOK is None
    step = dict(step=3, loss=0.5, forward_s=0.010, backward_s=0.020,
                hop_s=0.004, hop_wait_s=0.006, update_s=0.002, wall_s=0.050,
                idle_share=0.28, collective_s=0.003, hops=8,
                hop_bytes=8 << 20)
    row, = cs._step_log("(a) test", 0, [step], 32)
    assert row["forward_ms"] == pytest.approx(10.0)
    assert row["wall_ms"] == pytest.approx(50.0)
    assert row["per_s"] == pytest.approx(640.0)
    assert row["idle"] == 0.28 and row["hop_bytes"] == 8 << 20
    assert row["collective_ms"] == pytest.approx(3.0)
