"""Paired comparison, on one card, of two ways to fill the bucketed runner's
pinned staging buffer.

    python tools/runner_staging_ab.py [--rounds 3] [--out PATH]

``core/inference.py`` ``_pad_to`` pads a batch to its rung with a
contiguous copy of the real rows and the last row repeated ("copy"). The
form it replaced gathered row ``min(i, n - 1)`` through an index array
into the buffer ("gather", ``gather_pad_to`` below). Both give the same
values; this script swaps them in one process, on one card, in the order
gather, copy, copy, gather for each round, over:

* phase 18's models through ``ONNXModel.transform`` (ResNet-50 float32
  and bf16 at batch 64, 224x224; the BERT-base-wide encoder at batch 32),
  each over ``AB_BATCHES`` full batches plus a tail of ``ONNX_TAIL`` rows:
  wall rows/s, the median of ``AB_CALLS`` transforms a slot;
* phase 15's serving shapes (a HIGGS-shaped booster, 28 features): the
  host staging alone and ``runner.dispatch(x).result()`` at 1 and
  ``SERVE_MAX_BATCH`` rows (median ms of ``SERVE_CALLS`` calls a slot),
  and ``predict(batch_size=SERVE_PREDICT_BATCH)`` over ``AB_PREDICT_ROWS``
  rows (rows/s, the median of ``AB_CALLS`` calls a slot).

Prints the card's name and power limit, one line a cell, and one JSON
object as its last line; writes the object to ``--out``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from synapseml_tpu_torch.core import Table  # noqa: E402
from synapseml_tpu_torch.core import inference  # noqa: E402

AB_BATCHES = 20          # full mini-batches in each ONNX table
AB_CALLS = 3             # transforms (predicts) timed in each slot
AB_PREDICT_ROWS = 500_000
ORDER = ("gather", "copy", "copy", "gather")


def gather_pad_to(arr, bucket, out=None):
    """The staging ``_pad_to`` replaced: one gather through an index
    array."""
    n = arr.shape[0]
    if out is None and n == bucket:
        return np.ascontiguousarray(arr)
    idx = np.minimum(np.arange(bucket), n - 1)
    if out is None:
        return arr[idx]
    np.take(arr, idx, axis=0, out=out)
    return out


VARIANTS = {"gather": gather_pad_to, "copy": inference._pad_to}


def median_s(fn, calls):
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def onnx_cells(dev):
    """(name, rows, timed callable) for phase 18's three models, each
    imported and captured before the rounds."""
    from synapseml_tpu_torch.onnx import Model, modelgen

    cells = []
    for name, maker, kw, batch, precisions in cs.ONNX_MODELS:
        kw = dict(kw)
        if maker == "make_resnet":
            model = modelgen.make_resnet(kw.pop("depth"), **kw)
        else:
            model = getattr(modelgen, maker)(**kw)
        raw = model.encode()
        in_vi, out_vi = model.graph.inputs[0], model.graph.outputs[0]
        del model
        Model.parse(raw)
        rows = AB_BATCHES * batch + cs.ONNX_TAIL
        x = np.random.default_rng(0).normal(
            size=(rows,) + tuple(in_vi.shape[1:])).astype(np.float32)
        table = Table({"x": x})
        for precision in precisions:
            stage = cs.onnx_stage(raw, in_vi.name, out_vi.name, batch,
                                  precision, dev)
            stage.transform(table)
            cells.append((f"{name} {precision}", rows,
                          lambda s=stage, t=table: s.transform(t)["y"]))
    return cells


def serving_cells(dev):
    """(name, unit, timed callable) for phase 15's dispatch shapes."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    X, y = cs.higgs_like(200_000, seed=2)
    booster = train_booster(X, y, BoosterConfig(
        objective="binary", num_iterations=10, num_leaves=31), device=dev)
    serve = booster.serving_fn(max_batch_size=cs.SERVE_MAX_BATCH)
    serve.warmup()
    runner = serve.runner
    Xv = np.ascontiguousarray(cs.higgs_like(AB_PREDICT_ROWS, seed=5)[0],
                              dtype=np.float32)
    booster.predict(Xv, batch_size=cs.SERVE_PREDICT_BATCH)
    cells = []
    for rows in (1, cs.SERVE_MAX_BATCH):
        xr = np.ascontiguousarray(Xv[:rows])
        bucket = runner.bucket_for(rows)

        def stage_only(xr=xr, bucket=bucket):
            host = torch.empty((bucket,) + xr.shape[1:], dtype=torch.float32,
                               pin_memory=dev == "cuda")
            inference._pad_to(xr, bucket, out=host.numpy())

        cells.append((f"staging at {rows} rows", "ms", stage_only))
        cells.append((f"dispatch at {rows} rows", "ms",
                      lambda xr=xr: runner.dispatch(xr).result()))
    cells.append((f"predict(batch_size={cs.SERVE_PREDICT_BATCH}) of "
                  f"{AB_PREDICT_ROWS} rows", "rows/s",
                  lambda: booster.predict(
                      Xv, batch_size=cs.SERVE_PREDICT_BATCH)))
    return cells


def run(dev: str, rounds: int, card: str) -> dict:
    """Every cell's slots and medians, ``rounds`` rounds of ``ORDER``."""
    timed = []
    for name, rows, fn in onnx_cells(dev):
        timed.append((name, "rows/s",
                      lambda fn=fn, rows=rows: rows / median_s(fn, AB_CALLS)))
    for name, unit, fn in serving_cells(dev):
        if unit == "ms":
            timed.append((name, unit, lambda fn=fn: median_s(
                fn, cs.SERVE_CALLS) * 1e3))
        else:
            timed.append((name, unit, lambda fn=fn: AB_PREDICT_ROWS
                          / median_s(fn, AB_CALLS)))
    for _, _, measure in timed:        # one warm slot of each variant
        for v in ("gather", "copy"):
            inference._pad_to = VARIANTS[v]
            measure()
    slots = {name: {v: [] for v in VARIANTS} for name, _, _ in timed}
    for _ in range(rounds):
        for v in ORDER:
            inference._pad_to = VARIANTS[v]
            for name, _, measure in timed:
                slots[name][v].append(measure())
    inference._pad_to = VARIANTS["copy"]
    result = {"card": card, "rounds": rounds, "order": ORDER, "cells": {}}
    for name, unit, _ in timed:
        s = slots[name]
        med = {v: float(np.median(s[v])) for v in VARIANTS}
        result["cells"][name] = dict(unit=unit, slots=s, median=med)
        print(f"{name}: gather {med['gather']!r} {unit}, copy "
              f"{med['copy']!r} {unit} (slots gather {s['gather']}, copy "
              f"{s['copy']}); {card}", flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "runner_staging_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("runner_staging_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    result = run("cuda", args.rounds, card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v["median"] for k, v in result["cells"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
