"""Serving CLI: load a saved port stage and serve it over HTTP.

``python -m synapseml_tpu_torch.io.serving_main --model /path/to/saved_stage
[--host 0.0.0.0] [--port 8898] [--output-col prediction] [--device cpu]``

The port's counterpart of the JAX package's ``io/serving_main.py``: requests
POST a JSON object of column values, micro-batched into one ``transform``
per batch, and each request receives its row's output column back. The
stage loads on the card (``--device cuda``, the default) or, when asked, on
the CPU (``--device cpu``), whatever device it was saved from.

``--gateway-workers`` and ``--lb-mode`` (the forwarding gateway of the JAX
package's ``io/distributed_serving.py``) are not ported and raise
``NotImplementedError`` naming themselves.
"""

from __future__ import annotations

import argparse
import signal
import sys

import numpy as np


def build_handler(stage, output_col: str):
    """Serving handler over a fitted stage: each request's JSON object of
    column values becomes one row of a ``Table``, the batch goes through
    ``stage.transform`` once, and each reply is the row's ``output_col``
    (the last column when the output has no such column)."""
    from ..core.table import Table

    def handler(df: Table) -> Table:
        n = df.num_rows
        cols: dict = {}
        for i, v in enumerate(df["value"]):
            if not isinstance(v, dict):
                raise ValueError("request body must be a JSON object of "
                                 "column values")
            for k, val in v.items():
                cols.setdefault(k, [None] * n)[i] = val
        batch = Table({k: np.asarray(v, dtype=object)
                       for k, v in cols.items()})
        out = stage.transform(batch)
        col = output_col if output_col in out.columns else out.columns[-1]
        return Table({"id": df["id"], "reply": out[col]})

    return handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", help="path of a saved PipelineStage "
                                    "(stage.save dir)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8898)
    ap.add_argument("--output-col", default="prediction")
    ap.add_argument("--max-batch-size", type=int, default=64)
    ap.add_argument("--max-batch-latency", type=float, default=0.005)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the stage scores (default: the card)")
    ap.add_argument("--gateway-workers", default=None,
                    help="not ported: the forwarding gateway")
    ap.add_argument("--lb-mode", default=None,
                    choices=["least_loaded", "round_robin"],
                    help="not ported: the gateway's balancing mode")
    args = ap.parse_args(argv)

    for flag in ("gateway_workers", "lb_mode"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to the PyTorch "
                "package yet (it needs io/distributed_serving.py)")
    if not args.model:
        ap.error("--model is required")
    from ..core.device import resolve_device
    from ..core.pipeline import PipelineStage
    from .serving import ServingServer

    resolve_device(args.device)
    stage = PipelineStage.load(args.model, device=args.device)
    server = ServingServer(build_handler(stage, args.output_col),
                           host=args.host, port=args.port,
                           max_batch_size=args.max_batch_size,
                           max_batch_latency=args.max_batch_latency)
    server.start()
    print(f"serving {type(stage).__name__} on {args.device} at {server.url}",
          flush=True)
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
