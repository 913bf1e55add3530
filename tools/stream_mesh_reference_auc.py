"""Held-out AUC of the JAX package's mesh-streamed GBDT on ``chip_smoke.py``
phase 20 (c)'s prefix of the stream, for each histogram wire.

    python tools/stream_mesh_reference_auc.py [--rows 2000000]

Runs the JAX package (the reference) on the CPU with two virtual devices on
the mesh ``{"data": 2}``: ``train_booster_streamed`` over the first
``--rows`` rows of phase 19's stream (``chip_smoke.stream_source``, 1M-row
HIGGS-shaped chunks) re-chunked at ``chip_smoke.MESH_CHUNK_ROWS`` rows as
phase 20 chunks it (the chunk rows set the order of the float32 sums, and
this table's first split is a near tie of two features), 10 iterations, 31
leaves, max_bin 255, leaf-wise, AUC on phase 19's 500,000 held-out rows.
Prints one JSON object ``{wire: auc}``; ``chip_smoke.MESH_REFERENCE_AUC``
records its output for the default rows.
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

from chip_smoke import (MESH_CHUNK_ROWS, STREAM_ITERS, STREAM_SEED,  # noqa: E402
                        STREAM_VALID_ROWS, STREAM_VALID_SEED, _whole,
                        stream_source)
from synapseml_tpu.gbdt import (BoosterConfig, StreamedDataset,  # noqa: E402
                                train_booster_streamed)
from synapseml_tpu.parallel import make_mesh  # noqa: E402


def main() -> None:
    from sklearn.metrics import roc_auc_score

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    args = ap.parse_args()
    Xv, yv = _whole(stream_source(STREAM_VALID_ROWS, STREAM_VALID_SEED))
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    ds = StreamedDataset(stream_source(args.rows, STREAM_SEED),
                         num_features=Xv.shape[1],
                         chunk_rows=MESH_CHUNK_ROWS)
    out = {}
    for wire in ("f32", "bf16", "int8"):
        b = train_booster_streamed(ds, BoosterConfig(
            objective="binary", num_iterations=STREAM_ITERS, num_leaves=31,
            max_bin=255, hist_allreduce_dtype=wire), mesh=mesh)
        out[wire] = round(float(roc_auc_score(yv, np.asarray(
            b.predict(Xv)))), 6)
        print(wire, out[wire], file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
