"""Held-out AUC of the JAX package's mesh GBDT on ``chip_smoke.py`` phase
17's table, for each histogram wire.

    python tools/dist_gbdt_reference_auc.py [--rows 2000000]

Runs the JAX package (the reference) on the CPU with two virtual devices
on the mesh ``{"data": 2}``: phase 17's HIGGS-shaped table
(``chip_smoke.higgs_like``), 10 iterations, 31 leaves, max_bin 255,
``tree_learner="data"``, AUC on 200,000 held-out rows (seed 1). Prints one
JSON object ``{wire: auc}``; ``chip_smoke.DIST_REFERENCE_AUC`` records
its output for the default rows. About 3 minutes at 2M rows.
"""

import argparse
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import DIST_EVAL_ROWS, DIST_ITERS, higgs_like  # noqa: E402
from synapseml_tpu.gbdt import BoosterConfig, train_booster  # noqa: E402
from synapseml_tpu.parallel import make_mesh  # noqa: E402


def main() -> None:
    from sklearn.metrics import roc_auc_score

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    args = ap.parse_args()
    X, y = higgs_like(args.rows)
    Xe, ye = higgs_like(DIST_EVAL_ROWS, seed=1)
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    out = {}
    for wire in ("f32", "bf16", "int8"):
        b = train_booster(X, y, BoosterConfig(
            objective="binary", num_iterations=DIST_ITERS, num_leaves=31,
            max_bin=255, tree_learner="data", hist_allreduce_dtype=wire),
            mesh=mesh)
        out[wire] = round(float(roc_auc_score(ye, np.asarray(
            b.predict(Xe)))), 6)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
