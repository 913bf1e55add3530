"""Where the port's mesh-streamed trees on ``chip_smoke.py`` phase 20 (c)'s
prefix first differ from the JAX package's.

    python tools/stream_mesh_tree_diff.py [--rows 2000000] [--out DIR]
        [--device cpu|cuda] [--against MODEL_TXT]

Both sides fit the f32 wire's model of ``tools/stream_mesh_reference_auc.py``
on the same rows: ``train_booster_streamed`` over the first ``--rows`` rows
of phase 19's stream (``chip_smoke.stream_source``) re-chunked at
``chip_smoke.MESH_CHUNK_ROWS`` rows, 10 iterations, 31 leaves, max_bin 255,
leaf-wise, on the mesh ``{"data": 2}``:

* the port (``synapseml_tpu_torch``) on ``--device`` (the CPU by default;
  ``cuda`` puts both ranks on the card), in two spawned gloo ranks that
  each stream their block of every chunk, as phase 20's ranks do;
* the JAX package on the CPU with two virtual devices, in this process
  while the ranks run; or, with ``--against``, a model string it wrote
  before (``--out``'s ``jax_model.txt``), so that the JAX package is not
  imported at all (on the machine with the card).

It compares the bin mappers, then the two model strings tree by tree and
split by split (splits in growth order), and prints the first split that
differs with both sides' feature, threshold and gain, the largest leaf
value gap of the trees that agree, and each side's held-out AUC on phase
19's 500,000 held-out rows (both model strings scored by the port on the
CPU). The last line is one JSON object of the same.
``--out DIR`` also writes both model strings there. The JAX package is
imported in this process only; the ranks import the port alone.
"""

import argparse
import json
import os
import sys
import tempfile
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RANKS = 2
# the lines of a tree block that fix its structure, and the float lines
# that carry its gains and leaf values
STRUCTURE = ("split_feature", "threshold", "decision_type", "left_child",
             "right_child")
_SPEC = dict(objective="binary", num_leaves=31, max_bin=255)


def _config(booster_config):
    from chip_smoke import STREAM_ITERS

    return booster_config(num_iterations=STREAM_ITERS, **_SPEC)


def _rank(rank: int, workdir: str, rows: int, threads: int,
          device: str) -> None:
    """One rank of the port's fit; rank 0 writes the model string and the
    bin mapper's arrays."""
    import torch

    from chip_smoke import (FEATURES, MESH_CHUNK_ROWS, STREAM_SEED,
                            stream_source)
    from synapseml_tpu_torch.gbdt import (BoosterConfig, StreamedDataset,
                                          train_booster_streamed)
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(threads)
    init_distributed("gloo", os.path.join(workdir, "store"), rank, RANKS,
                     timeout_s=3600)
    mesh = make_mesh({"data": RANKS}, device=device)
    ds = StreamedDataset(stream_source(rows, STREAM_SEED),
                         num_features=FEATURES, chunk_rows=MESH_CHUNK_ROWS)
    t0 = time.perf_counter()
    b = train_booster_streamed(ds, _config(BoosterConfig), mesh=mesh,
                               device=device)
    fit_s = time.perf_counter() - t0
    if rank == 0:
        np.savez(os.path.join(workdir, "port_mapper.npz"),
                 boundaries=np.asarray(ds.mapper.boundaries),
                 num_bins=np.asarray(ds.mapper.num_bins))
        with open(os.path.join(workdir, "port_model.txt"), "w") as f:
            f.write(b.model_string())
        with open(os.path.join(workdir, "port_fit.json"), "w") as f:
            json.dump({"fit_s": fit_s}, f)
    torch.distributed.destroy_process_group()


def _jax_fit(rows: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import (FEATURES, MESH_CHUNK_ROWS, STREAM_SEED,
                            stream_source)
    from synapseml_tpu.gbdt import (BoosterConfig, StreamedDataset,
                                    train_booster_streamed)
    from synapseml_tpu.parallel import make_mesh

    mesh = make_mesh({"data": RANKS}, devices=jax.devices()[:RANKS])
    ds = StreamedDataset(stream_source(rows, STREAM_SEED),
                         num_features=FEATURES, chunk_rows=MESH_CHUNK_ROWS)
    b = train_booster_streamed(ds, _config(BoosterConfig), mesh=mesh)
    return b, ds.mapper


def parse_trees(model: str) -> list:
    """The model string's tree blocks, each ``{key: [values as strings]}``
    for its ``key=v v v`` lines."""
    trees, cur = [], None
    for line in model.splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif line.startswith("end of trees"):
            break
        elif cur is not None and "=" in line:
            k, _, v = line.partition("=")
            cur[k] = v.split()
    return trees


def first_difference(port: list, ref: list) -> dict:
    """The first (tree, split) in growth order whose structure lines
    differ, with both sides' split; None when every tree agrees. Also the
    largest leaf value gap over the trees before it."""
    leaf_gap = 0.0
    for t, (a, b) in enumerate(zip(port, ref)):
        nsplit = max(len(a.get("split_feature", [])),
                     len(b.get("split_feature", [])))
        for s in range(nsplit):
            if any(a.get(k, [None] * nsplit)[s:s + 1]
                   != b.get(k, [None] * nsplit)[s:s + 1] for k in STRUCTURE):
                def side(tree):
                    if s >= len(tree.get("split_feature", [])):
                        return None
                    return {k: tree[k][s] for k in
                            ("split_feature", "threshold", "split_gain",
                             "left_child", "right_child")}
                return {"tree": t, "split": s, "port": side(a),
                        "jax": side(b), "leaf_gap_before": leaf_gap}
        la = np.asarray(a.get("leaf_value", []), np.float64)
        lb = np.asarray(b.get("leaf_value", []), np.float64)
        if la.shape == lb.shape and la.size:
            leaf_gap = max(leaf_gap, float(np.abs(la - lb).max()))
    if len(port) != len(ref):
        return {"tree": min(len(port), len(ref)), "split": None,
                "port": None, "jax": None, "leaf_gap_before": leaf_gap}
    return None


def main() -> None:
    import torch.multiprocessing as tmp

    from chip_smoke import (MESH_LOSSY_ROWS, STREAM_VALID_ROWS,
                            STREAM_VALID_SEED, _heldout_auc, _whole,
                            stream_source)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=MESH_LOSSY_ROWS)
    ap.add_argument("--out", default=None,
                    help="directory for both model strings")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="where the port's ranks fit")
    ap.add_argument("--against", default=None,
                    help="the JAX package's model string, written before")
    args = ap.parse_args()
    threads = max(1, (os.cpu_count() or 2) // (2 * RANKS))
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        ctx = tmp.start_processes(
            _rank, args=(workdir, args.rows, threads, args.device),
            nprocs=RANKS, join=False, start_method="spawn")
        mapper_equal = None
        if args.against:
            with open(args.against) as f:
                jax_model = f.read()
        else:
            jb, jmapper = _jax_fit(args.rows)
            jax_model = jb.model_string()
        jax_s = time.perf_counter() - t0
        while not ctx.join(timeout=30):
            pass
        port_s = time.perf_counter() - t0
        with open(os.path.join(workdir, "port_model.txt")) as f:
            port_model = f.read()
        if not args.against:
            pm = np.load(os.path.join(workdir, "port_mapper.npz"))
            mapper_equal = bool(
                np.array_equal(pm["boundaries"],
                               np.asarray(jmapper.boundaries))
                and np.array_equal(pm["num_bins"],
                                   np.asarray(jmapper.num_bins)))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for name, text in (("port", port_model), ("jax", jax_model)):
            with open(os.path.join(args.out, f"{name}_model.txt"), "w") as f:
                f.write(text)

    from synapseml_tpu_torch.gbdt import Booster

    Xv, yv = _whole(stream_source(STREAM_VALID_ROWS, STREAM_VALID_SEED))
    port_auc, jax_auc = (
        _heldout_auc(Booster.from_model_string(m, device="cpu"), Xv, yv,
                     "cpu") for m in (port_model, jax_model))
    diff = first_difference(parse_trees(port_model), parse_trees(jax_model))
    out = {"rows": args.rows, "mapper_equal": mapper_equal,
           "trees_equal": diff is None, "first_difference": diff,
           "device": args.device,
           "auc": {"port": round(float(port_auc), 6),
                   "jax": round(float(jax_auc), 6)},
           "seconds": {"jax": round(jax_s, 1), "port": round(port_s, 1)}}
    if diff is None:
        print("the port's trees equal the JAX package's on every split",
              file=sys.stderr)
    else:
        print(f"first difference: tree {diff['tree']} split "
              f"{diff['split']}: port {diff['port']} against JAX "
              f"{diff['jax']}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
