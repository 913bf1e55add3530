#!/usr/bin/env python3
"""What one fold fit of ``chip_smoke.py`` phase 25's search costs on the
card, and what threads do to it.

    python3 tools/automl_fit_costs.py [--iters 50] [--fits 4]

On the Adult-shaped train split (featurized as phase 25 (a) featurizes
it), fold 0's training rows: one ``LightGBMClassifier`` fit of ``--iters``
iterations at each of phase 25's ``numLeaves`` (15, 31, 63), then
``--fits`` fits at 31 leaves one after another and the same fits in as
many threads (the default switch interval, then 1e-4 s, then a CUDA
stream a thread). Prints the card's name and power limit and each time.
Needs one NVIDIA card.
"""

import argparse
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--fits", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("automl_fit_costs: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.train import TrainClassifier

    dev = "cuda"
    print(cs.card_line(), flush=True)
    train, _ = cs.adult_split(cs.adult_like(cs.ADULT_ROWS))
    model = TrainClassifier(model=LightGBMClassifier(numIterations=2,
                                                     device=dev),
                            labelCol="income").fit(train)
    table = cs.featurized(model, train)
    folds = cs.tune_folds(table.num_rows)
    rows = table.take(np.concatenate(folds[1:]))

    def fit(leaves=31, stream=False):
        est = LightGBMClassifier(numIterations=args.iters, numLeaves=leaves,
                                 device=dev)
        if not stream:
            est.fit(rows)
            return
        with torch.cuda.stream(torch.cuda.Stream()):
            est.fit(rows)
            torch.cuda.current_stream().synchronize()

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def threads(stream: bool) -> None:
        ts = [threading.Thread(target=fit, kwargs=dict(stream=stream))
              for _ in range(args.fits)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    fit()                                   # build and warm the kernels
    print(f"{rows.num_rows} rows x {table['features'].shape[1]} features, "
          f"{args.iters} iterations", flush=True)
    for leaves in cs.TUNE_LEAVES:
        print(f"one fit, {leaves} leaves: {timed(lambda: fit(leaves)):.3f}s",
              flush=True)
    serial = timed(lambda: [fit() for _ in range(args.fits)])
    print(f"{args.fits} fits one after another: {serial:.3f}s", flush=True)
    print(f"{args.fits} threads, switch interval {sys.getswitchinterval()}: "
          f"{timed(lambda: threads(False)):.3f}s", flush=True)
    sys.setswitchinterval(1e-4)
    print(f"{args.fits} threads, switch interval 1e-4: "
          f"{timed(lambda: threads(False)):.3f}s", flush=True)
    print(f"{args.fits} threads, switch interval 1e-4, a stream each: "
          f"{timed(lambda: threads(True)):.3f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
