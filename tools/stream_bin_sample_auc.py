"""How much of the held-out AUC gap between a streamed fit and a classic
resident fit of the port comes from their bin samples alone.

    python tools/stream_bin_sample_auc.py [--rows 300000] [--sample 50000]
        [--device cpu]

On ``chip_smoke.py`` phase 19's HIGGS-shaped stream (``stream_source``,
seed 19; held-out rows from seed 20) with ``bin_sample_count=--sample``
below ``--rows``, so the streaming sketch keeps a reservoir while the
classic path draws its own row sample: four fits of 10 iterations, 31
leaves, 255 bins, each crossing the boundaries of the two paths. Prints
one JSON object: each fit's held-out AUC and whether the classic fit on
the sketch's boundaries grows the streamed trees. About 2 minutes on the
CPU at the default sizes.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import _whole, higgs_like, stream_source  # noqa: E402


def main() -> None:
    from sklearn.metrics import roc_auc_score

    from synapseml_tpu_torch.gbdt import (BoosterConfig, StreamedDataset,
                                          train_booster,
                                          train_booster_streamed)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=300_000)
    ap.add_argument("--sample", type=int, default=50_000)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    source = stream_source(args.rows, 19, 100_000)
    X, y = _whole(source)
    Xv, yv = higgs_like(100_000, seed=(20, 0))

    def cfg():
        return BoosterConfig(objective="binary", num_iterations=10,
                             num_leaves=31, max_bin=255,
                             bin_sample_count=args.sample)

    def auc(b):
        return float(roc_auc_score(yv, b.predict(Xv)))

    dev = args.device
    classic = train_booster(X, y, cfg(), device=dev)
    ds = StreamedDataset(source, num_features=X.shape[1])
    streamed = train_booster_streamed(ds, cfg(), device=dev)
    classic_on_sketch = train_booster(X, y, cfg(), mapper=ds.mapper,
                                      device=dev)
    streamed_on_sample = train_booster_streamed(
        StreamedDataset(source, num_features=X.shape[1],
                        mapper=classic.mapper), cfg(), device=dev)

    def same(a, b):
        return all((ta.split_feature == tb.split_feature).all()
                   and (ta.split_bin == tb.split_bin).all()
                   for ta, tb in zip(a.trees, b.trees))

    print(json.dumps({
        "rows": args.rows, "bin_sample_count": args.sample,
        "sketch_exact": ds.sketch_exact,
        "classic_own_sample": auc(classic),
        "streamed_sketch": auc(streamed),
        "classic_on_sketch_bins": auc(classic_on_sketch),
        "streamed_on_classic_bins": auc(streamed_on_sample),
        "same_splits_on_sketch_bins": same(classic_on_sketch, streamed),
        "same_splits_on_classic_bins": same(classic, streamed_on_sample)}))


if __name__ == "__main__":
    main()
