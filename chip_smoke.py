#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``synapseml_tpu_torch``) on one card.

    python3 chip_smoke.py [--rows N]

Needs one NVIDIA Hopper card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``)
and the repository beside this file; without a card, or run from a directory
that does not hold the package, it prints no result and exits non-zero.
Phases, each of which fails the run if it fails:

1. the card's name and power limit; build every CUDA kernel from
   ``synapseml_tpu_torch/csrc`` (one ``nvcc`` per source, all at once);
2. kernels: ``child_histogram`` and ``range_histogram`` against their plain
   PyTorch versions on the card at the main path's shapes (FP = 32 padded
   features, B = 256 bins, ``--rows`` rows), rtol 1e-5 / atol 1e-3 on the
   gradient and hessian sums (atomics add in an order that changes from run
   to run) and exact counts; each timed with CUDA events beside its plain
   version, one ``index_put_(accumulate=True)`` call (a yardstick the port
   never calls) and its bound on the H100 (bytes over 3.35 TB/s, float32
   adds over 67 TFLOP/s, the larger);
3. main path: ``LightGBMClassifier(numIterations=10, numLeaves=31,
   maxBin=255).fit`` on a HIGGS-shaped ``Table`` (28 dense float32
   features, ``--rows`` rows), then ``.transform`` and ``saveNativeModel``;
   the kernels' launch counts are zeroed just before and read just after,
   and both must be above 0;
4. cross-check: the same estimator on 100,000 rows for 3 iterations on the
   card and on the CPU (plain versions); AUCs within 1e-3 and mean absolute
   probability difference at most 1e-3 (atomics can flip near-tie splits);
5. one torch.profiler pass over the boosting loop: device time by kernel.

The last lines are the card line, ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FEATURES = 28
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-3
CROSS_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def higgs_like(rows: int, seed: int = 0):
    """HIGGS-shaped synthetic table: 28 standard-normal float32 features and
    the label of margin X0*X1 + 0.5*X2 + 0.2*noise > 0."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] + 0.2 * rng.normal(size=rows)
    return X, (margin > 0).astype(np.float32)


def table_of(X, y):
    from synapseml_tpu_torch.core import Table, assemble_features

    cols = {f"f{i}": X[:, i] for i in range(X.shape[1])}
    return assemble_features(Table({**cols, "label": y}), list(cols))


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(FP: int, rows: int, B: int) -> tuple:
    """(least milliseconds on an H100, what bounds it) for one histogram of
    ``rows`` rows: read bT (int32) and g/h/m once, write (FP, B, 3) float32
    once; 3 float32 adds per (feature, row)."""
    bytes_ = FP * rows * 4 + 12 * rows + FP * B * 3 * 4
    ops = 3 * FP * rows
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(rows: int, dev: str) -> dict:
    from synapseml_tpu_torch.ops import hist_kernel as hk

    FP, B = hk.features_padded(FEATURES), hk.pad_bins(255)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bT = torch.randint(0, B, (FP, rows), generator=gen, device=dev,
                       dtype=torch.int32)
    m = (torch.rand(rows, generator=gen, device=dev) > 0.2).float()
    g = torch.randn(rows, generator=gen, device=dev) * m
    h = torch.rand(rows, generator=gen, device=dev) * m

    def compare(label, got, want):
        torch.cuda.synchronize()
        err = (got - want).abs().amax(dim=(0, 1)).tolist()
        ok = (torch.allclose(got[..., :2], want[..., :2], rtol=KERNEL_RTOL,
                             atol=KERNEL_ATOL)
              and torch.equal(got[..., 2], want[..., 2]))
        log(f"  {label}: max |kernel - plain| g={err[0]:.3g} h={err[1]:.3g} "
            f"count={err[2]:.3g} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its plain version")
        return max(err)

    results = {}
    err = compare("child_histogram n=%d" % rows,
                  hk.child_histogram(bT, g, h, m, B),
                  hk._hist_plain(bT, g, h, m, B))
    ranges = [(0, rows), (rows // 3, 1500), (rows - rows // 3, rows // 3),
              (5, 1)]
    rerr = 0.0
    for s, ln in ranges:
        st = torch.tensor(s, dtype=torch.int32, device=dev)
        le = torch.tensor(ln, dtype=torch.int32, device=dev)
        rerr = max(rerr, compare(
            f"range_histogram [{s}, {s + ln})",
            hk.range_histogram(bT, g, h, m, st, le, B),
            hk._range_hist_plain(bT, g, h, m, s, ln, B)))

    def library(start, length):
        """One index_put_(accumulate=True) over flattened (feature, bin)
        indices of the same rows: the yardstick call, inputs prepared
        outside the timed call."""
        b = bT[:, start:start + length].to(torch.int64)
        flat = (b + torch.arange(FP, device=dev)[:, None] * B).reshape(-1)
        vals = torch.stack([g, h, m], -1)[start:start + length]
        vals = vals.to(torch.bfloat16).float().expand(FP, length, 3)
        vals = vals.reshape(-1, 3)
        out = torch.zeros((FP * B, 3), device=dev)
        return lambda: out.index_put_((flat,), vals, accumulate=True)

    iters = 20
    t_child = time_ms(lambda: hk.child_histogram(bT, g, h, m, B), iters)
    t_child_plain = time_ms(lambda: hk._hist_plain(bT, g, h, m, B), 5)
    t_child_lib = time_ms(library(0, rows), 5)
    bnd, by = bound_ms(FP, rows, B)
    results["child_histogram"] = dict(
        replaces="synapseml_tpu/ops/hist_kernel.py:94", max_abs_err=err,
        ms=t_child, plain_ms=t_child_plain, bound_ms=bnd, bound_by=by,
        library_ms=t_child_lib, shape=f"FP={FP} n={rows} B={B}")
    # the range kernel timed on half the rows: the largest smaller child
    s, ln = rows // 4, rows // 2
    st = torch.tensor(s, dtype=torch.int32, device=dev)
    le = torch.tensor(ln, dtype=torch.int32, device=dev)
    t_range = time_ms(lambda: hk.range_histogram(bT, g, h, m, st, le, B),
                      iters)
    t_range_plain = time_ms(
        lambda: hk._range_hist_plain(bT, g, h, m, s, ln, B), 5)
    t_range_lib = time_ms(library(s, ln), 5)
    bnd, by = bound_ms(FP, ln, B)
    results["range_histogram"] = dict(
        replaces="synapseml_tpu/ops/hist_kernel.py:219", max_abs_err=rerr,
        ms=t_range, plain_ms=t_range_plain, bound_ms=bnd, bound_by=by,
        library_ms=t_range_lib, shape=f"FP={FP} n={rows} B={B} length={ln}")
    for name, r in results.items():
        log(f"  {name} [{r['shape']}]: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"-> {r['bound_ms'] / r['ms']:.1%} of bound")
    del bT, g, h, m
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def main_path(rows: int, dev: str) -> dict:
    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.gbdt.objectives import auc
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk

    t0 = time.perf_counter()
    X, y = higgs_like(rows)
    t = table_of(X, y)
    log(f"  table: {rows} rows x {FEATURES} features, made in "
        f"{time.perf_counter() - t0:.3f}s")
    est = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit(t)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(t)
    transform_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.txt"
        model.saveNativeModel(str(path))
        text = path.read_text()
    launches = dict(hk.LAUNCHES)

    booster = model.booster
    prob = out["probability"]
    if prob.shape != (rows, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"probability column bad: shape {prob.shape}, "
                             f"finite {np.isfinite(prob).all()}")
    a = float(auc(torch.as_tensor(y, device=dev),
                  torch.as_tensor(prob[:, 1], device=dev)))
    reloaded = Booster.from_model_string(text, device=dev)
    sub = X[:10_000]
    reload_diff = float(np.abs(reloaded.predict(sub) - prob[:10_000, 1]).max())
    ntrees = booster.num_trees
    syncs = booster.metadata["host_syncs"]
    spans = {k: round(v, 4) for k, v in booster.metadata["measures"].items()}
    log(f"  fit_s={fit_s:.3f} rows/s={rows / fit_s:.0f} "
        f"row_iterations/s={rows * ntrees / fit_s:.0f} "
        f"transform_s={transform_s:.3f}")
    log(f"  fit spans: {json.dumps(spans)}")
    log(f"  train AUC={a:.6f} trees={ntrees} splits/tree="
        f"{np.mean([int(tr.num_splits) for tr in booster.trees]):.1f} "
        f"host_syncs={syncs} host_syncs/tree={syncs / ntrees:.1f}")
    log(f"  peak device memory={torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB; model string {len(text)} bytes, reload max |diff|="
        f"{reload_diff:.3g}")
    log(f"  launches on the main path: {json.dumps(launches)}")
    if ntrees != 10 or not text.startswith("tree") or reload_diff > 1e-5:
        raise AssertionError("fitted model or its native string is wrong")
    if a < 0.75:
        raise AssertionError(f"train AUC {a} is too low for this table")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return dict(launches=launches, fit_s=fit_s, auc=a)


# ---------------------------------------------------------------------------
# phase 4: card against CPU; phase 5: where the time goes
# ---------------------------------------------------------------------------

def cross_check(dev: str) -> None:
    from synapseml_tpu_torch.gbdt.objectives import auc
    from synapseml_tpu_torch.models import LightGBMClassifier

    X, y = higgs_like(100_000, seed=1)
    t = table_of(X, y)
    probs, aucs, trees = {}, {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        model = LightGBMClassifier(numIterations=3, numLeaves=31, maxBin=255,
                                   device=d).fit(t)
        probs[d] = model.transform(t)["probability"][:, 1]
        aucs[d] = float(auc(torch.as_tensor(y), torch.as_tensor(probs[d])))
        trees[d] = [(tr.split_feature.tolist(), tr.split_bin.tolist())
                    for tr in model.booster.trees]
        log(f"  {d}: AUC={aucs[d]:.6f} fit+transform "
            f"{time.perf_counter() - t0:.3f}s")
    dauc = abs(aucs[dev] - aucs["cpu"])
    dprob = float(np.abs(probs[dev] - probs["cpu"]).mean())
    same = sum(a == b for a, b in zip(trees[dev], trees["cpu"]))
    log(f"  |AUC diff|={dauc:.3g} mean |prob diff|={dprob:.3g} "
        f"identical trees {same}/{len(trees['cpu'])}")
    if dauc > CROSS_TOL or dprob > CROSS_TOL:
        raise AssertionError("card and CPU fits disagree")


def profile_phase(rows: int, dev: str) -> None:
    """Device time by kernel over the boosting loop alone (2 iterations on
    a pre-binned ``Dataset`` of the main path's table), from torch.profiler
    (CUPTI). Busy time sums device-side events (kernels and copies); it
    overstates busy time only where two of them overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.gbdt import BoosterConfig, Dataset, train_booster

    X, y = higgs_like(rows)
    ds = Dataset(X, y, device=dev)
    cfg = BoosterConfig(objective="binary", num_iterations=2)
    train_booster(ds, None, cfg, device=dev)     # warm caches and allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_booster(ds, None, cfg, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.self_device_time_total / 1e3, e.count, e.key)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(ms for ms, _, _ in events)
    if not busy:
        log("  profiler recorded no device time: not measured")
        return
    log(f"  2-iteration training loop: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle {1 - busy / wall_ms:.1%} of wall")
    for ms, count, key in sorted(events, reverse=True)[:10]:
        log(f"    {ms:9.3f} ms {ms / busy:6.1%} {count:6d}x  {key[:80]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="rows of the HIGGS-shaped table (HIGGS: 11,000,000)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (REPO / "synapseml_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} does not hold the synapseml_tpu_torch "
              "package; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from synapseml_tpu_torch.ops import _build

    dev = "cuda"
    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"    built {sorted(libs)} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc seconds: {json.dumps(_build.BUILD_SECONDS)})")

    log(f"[2] kernels against their plain versions, n={args.rows}")
    kernels = kernel_phase(args.rows, dev)
    log(f"[3] main path: LightGBMClassifier fit/transform/save, "
        f"{args.rows} rows")
    main = main_path(args.rows, dev)
    log("[4] cross-check: card against CPU, 100000 rows, 3 iterations")
    cross_check(dev)
    log("[5] profile: 2-iteration training loop")
    profile_phase(args.rows, dev)

    source = "synapseml_tpu_torch/csrc/hist_kernel.cu"
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": r["replaces"], "launches": main["launches"][name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in kernels.items()]}
    log(f"    total {time.perf_counter() - t_start:.1f}s")
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
