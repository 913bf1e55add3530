"""The analytic priors behind ``seq_attention="auto"``, the distributed
GBDT's ``hist_allreduce_dtype="auto"`` and ``tree_learner="auto"``, the
streamed GBDT's chunk geometry and exact second sketch pass, and the
pipeline's ``pipeline_schedule="auto"`` and cost-balanced stage cuts.

The port's copy of the part of the JAX package's ``core/perfmodel.py`` that
the text trainer and the GBDT router read: ``suggest_seq_attention``'s
wire-byte model of ring against Ulysses attention, the link probe
(``link_bandwidth``), ``suggest_wire_dtype`` and ``choose_analytic``. The
JAX package lets recorded rows of its measurement journal displace these
priors; those rows were taken on TPUs or CPUs and say nothing of this card,
so the port reads none of them and decides on the priors alone. Without a
recorded row the JAX package trusts an analytic prior at
``ANALYTIC_CONFIDENCE``, below the ``MIN_CONFIDENCE`` that may displace a
hand-tuned default, so its decisions fall back exactly as the port's do:
``hist_allreduce_dtype="auto"`` resolves to ``"f32"`` and the tree-learner
router keeps its cost model's choice, each with fallback provenance. The
port reads nothing from the environment either (the JAX package's
``SYNAPSEML_TPU_SEQ_ATTENTION`` override and ``SYNAPSEML_TPU_PERFMODEL``
switch are not carried over): an explicit value is how a caller overrides.

The learned part is the JAX package's too, over the port's own journal:
``append_training_row`` and ``training_rows`` keep rows keyed by the
port's platform (``"gpu"`` or ``"cpu"``) in ``JOURNAL_PATH`` (under the
checkout's ``build/``), and ``predict`` / ``predict_runtime`` price a
candidate from a matched row, then a fitted one, then its analytic prior,
else ``(inf, 0.0, "none")``. AutoML's halving scheduler reads and writes
them (its "automl_rung" rows). ``choose``, the drift audits and the rest of
the JAX package's ``suggest_*`` functions are not ported yet.
"""

from __future__ import annotations

import json
import math
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import tuned

MIN_CONFIDENCE = 0.5       # below this a candidate cannot displace the fallback
ANALYTIC_CONFIDENCE = 0.4  # trust in a pure analytic prior (< MIN_CONFIDENCE)


def suggest_seq_attention(heads: int, seq_shards: int) -> Tuple[str, dict]:
    """(variant, provenance) for seq-sharded self-attention over ``p =
    seq_shards`` ranks: the variant that moves fewer activation bytes over
    the ``seq`` axis per layer, in units of the layer's activation ``E =
    B·S·H·D``. Ring rotates the local K/V blocks ``p - 1`` times
    (``2·E/p`` a turn), half of it hidden behind the block compute:
    ``(p - 1)/p · E``. Ulysses re-shards with four all-to-alls (q, k, v in,
    the output back), each moving ``(p - 1)/p`` of E: ``4·(p - 1)/p · E``,
    and is a candidate only when the heads divide by p.

    The prior therefore prefers ring for every shape and link rate (the
    sequence length, batch, head dim and link rate scale both costs alike,
    so they are not arguments); the steps measured on an H100 agree (ring
    1.16-1.29 s against Ulysses 1.78-1.87 s a step at the estimator's
    default widths and 8192 tokens on two ranks, ``chip_smoke.py`` phase
    9)."""
    p = max(1, int(seq_shards))
    cost = {"ring": (p - 1) / p}
    if heads % p == 0:
        cost["ulysses"] = 4 * (p - 1) / p
    arm = min(cost, key=cost.get)
    return arm, {"arm": arm, "source": "analytic", "analytic_E": cost,
                 "fallback_used": False}


# ---------------------------------------------------------------------------
# Decisions with provenance (the JAX package's Candidate / Decision)
# ---------------------------------------------------------------------------

@dataclass
class Candidate:
    """One alternative of a decision: its family ``kind``, its ``arm``,
    the workload ``features``, an analytic prior in seconds and the
    ``config`` handed back when it wins."""

    kind: str
    arm: str
    features: Dict[str, float] = field(default_factory=dict)
    analytic_s: Optional[float] = None
    config: Any = None


@dataclass
class Decision:
    """The outcome of a decision, with the JAX package's provenance."""

    kind: str
    arm: str
    config: Any
    predicted_s: Optional[float]
    confidence: float
    used_fallback: bool
    fallback_arm: str
    source: str
    candidates: List[Dict[str, Any]] = field(default_factory=list)
    features: Dict[str, float] = field(default_factory=dict)

    def provenance(self) -> Dict[str, Any]:
        """JSON-safe audit record (the JAX package's keys)."""
        return {
            "kind": self.kind,
            "arm": self.arm,
            "predicted_s": self.predicted_s,
            "confidence": round(float(self.confidence), 4),
            "used_fallback": self.used_fallback,
            "fallback_arm": self.fallback_arm,
            "source": self.source,
            "features": {k: float(v) for k, v in self.features.items()},
            "candidates": self.candidates,
        }


def featurize(wire_dtype: Optional[str] = None, **extra: float
              ) -> Dict[str, float]:
    """The JAX package's flat numeric feature dict (the keys the GBDT
    decisions use): the wire dtype as its effective bytes per histogram
    element, every other value as a non-negative float."""
    f: Dict[str, float] = {}
    if wire_dtype is not None:
        f["wire_bytes"] = {"f32": 4.0, "bf16": 8.0 / 3.0,
                           "int8": 2.0}.get(str(wire_dtype), 4.0)
    for k, v in extra.items():
        if v is not None:
            f[k] = float(v)
    return {k: max(0.0, float(v)) for k, v in f.items()}


def choose_analytic(candidates: Sequence[Candidate], fallback_arm: str
                    ) -> Decision:
    """The JAX package's ``choose`` with no recorded rows: every
    candidate's prediction is its analytic prior (confidence
    ``ANALYTIC_CONFIDENCE``) or none, none is confident enough to displace
    the fallback, so the fallback arm wins, with every prior in the
    provenance."""
    if not candidates:
        raise ValueError("choose_analytic() needs at least one candidate")
    kind = candidates[0].kind
    by_arm = {c.arm: c for c in candidates}
    fb = by_arm.get(fallback_arm, candidates[0])
    preds = {c.arm: ((float(c.analytic_s), ANALYTIC_CONFIDENCE, "analytic")
                     if c.analytic_s is not None else (math.inf, 0.0, "none"))
             for c in candidates}
    prov = [{"arm": a, "predicted_s": (None if math.isinf(sec)
                                       else round(sec, 9)),
             "confidence": round(conf, 4), "source": src}
            for a, (sec, conf, src) in preds.items()]
    sec, conf, src = preds[fb.arm]
    return Decision(kind, fb.arm, fb.config,
                    None if math.isinf(sec) else float(sec), float(conf),
                    True, fallback_arm,
                    src if not math.isinf(sec) else "fallback", prov,
                    dict(fb.features))


def link_bandwidth(mesh) -> float:
    """The mesh's all-reduce bandwidth (bytes/s), measured once per mesh
    layout and process (``parallel.collectives.probe_link_bandwidth``,
    every rank of the mesh gets the same value). Every rank must call it:
    the probe runs collectives, and a failure raises on the rank it hit."""
    from ..parallel.collectives import probe_link_bandwidth

    fp = tuned.mesh_fingerprint(mesh)
    return float(tuned.measured_or(("link_bytes_per_s", fp),
                                   lambda: probe_link_bandwidth(mesh)))


def suggest_wire_dtype(n_rows: float, nfeat: float, workers: float,
                       max_bin: float, num_leaves: float,
                       link_bps: Optional[float],
                       fallback: str = "f32") -> Tuple[str, Decision]:
    """``hist_allreduce_dtype`` for the histogram merges: each rung's
    analytic per-tree seconds (splits x wire bytes of a full histogram /
    link bandwidth) go into the provenance, and, with no recorded rows to
    trust, the ``fallback`` (exact f32) is chosen, as in the JAX package
    without a measured match (the lossy rungs trade accuracy, not only
    time)."""
    cands = []
    for wd in ("f32", "bf16", "int8"):
        feats = featurize(wire_dtype=wd, rows=n_rows, nfeat=nfeat,
                          workers=workers, max_bin=max_bin,
                          num_leaves=num_leaves)
        analytic = None
        if link_bps:
            per_split = nfeat * max_bin * 3.0 * feats["wire_bytes"]
            analytic = max(1, num_leaves - 1) * per_split / float(link_bps)
        cands.append(Candidate("gbdt_wire_dtype", wd, feats,
                               analytic_s=analytic, config=wd))
    dec = choose_analytic(cands, fallback)
    return dec.arm, dec


def suggest_chunk_rows(row_bytes: float, depth: int, fallback_rows: int,
                       h2d_bps: Optional[float] = None
                       ) -> Tuple[int, Decision]:
    """Rows per streamed chunk (``io.ingest.stream_chunk_rows``): a
    power-of-two ladder around the probe-derived ``fallback_rows``, each
    rung priced per row at ``row_bytes / h2d_bps + dispatch / rows``. Only
    a measured row may displace the probe formula, which is itself the
    prior's optimum; the port records none, so the fallback holds."""
    ladder = sorted({int(fallback_rows)} |
                    {1 << p for p in range(13, 21)
                     if (1 << p) <= 4 * fallback_rows
                     and (1 << p) >= max(1024, fallback_rows // 4)})
    dispatch_s = 2e-4   # per-chunk dispatch and pump hand-off
    cands = []
    for cr in ladder:
        analytic = None
        if h2d_bps:
            analytic = row_bytes / float(h2d_bps) + dispatch_s / float(cr)
        cands.append(Candidate(
            "io_chunk_rows", f"c{cr}",
            featurize(row_bytes=row_bytes, depth=depth, chunk_rows=cr),
            analytic_s=analytic, config=int(cr)))
    dec = choose_analytic(cands, f"c{int(fallback_rows)}")
    dec.source = "fallback"
    return int(dec.config), dec


SECOND_PASS_BUDGET = 0.10  # an exact re-sketch may cost this share of training


def suggest_sketch_second_pass(n_rows: float, nfeat: float,
                               rows_per_s: Optional[float],
                               train_s_estimate: Optional[float]
                               ) -> Tuple[bool, Decision]:
    """Whether a streamed dataset whose sketch overflowed its reservoir
    takes an exact second sketch pass: the JAX package's rule with no
    recorded row. The pass's analytic cost (``rows / rows_per_s``, this
    stream's measured sketch rate) is trusted at ``ANALYTIC_CONFIDENCE``
    and the pass is taken when that cost is at most ``SECOND_PASS_BUDGET``
    of ``train_s_estimate``; without a rate or an estimate it is skipped.
    This decision sets the bin boundaries, so the port must take it as the
    JAX package does for the two to grow the same trees on one stream
    (``StreamedDataset(exact_second_pass=...)`` decides instead)."""
    analytic = n_rows / float(rows_per_s) if rows_per_s else None
    feats = featurize(rows=n_rows, nfeat=nfeat)
    budget = (SECOND_PASS_BUDGET * float(train_s_estimate)
              if train_s_estimate else None)
    take = bool(analytic is not None and budget is not None
                and analytic <= budget)
    source = "analytic" if analytic is not None else "none"
    dec = Decision(
        "gbdt_sketch_pass", "exact" if take else "skip", take, analytic,
        ANALYTIC_CONFIDENCE if analytic is not None else 0.0, not take,
        "skip", source,
        [{"arm": "exact", "predicted_s": analytic,
          "confidence": ANALYTIC_CONFIDENCE if analytic is not None else 0.0,
          "source": source, "budget_s": budget}], feats)
    return take, dec


def suggest_pipeline_schedule(stages: float, microbatches: float,
                              fallback: str = "fill_drain"
                              ) -> Tuple[str, Decision]:
    """``pipeline_schedule="auto"``: fill_drain against overlap. The
    analytic prior prices the bubble: fill_drain idles ``(S - 1) / (M + S
    - 1)`` of the schedule, overlap hides about half of it at some dispatch
    overhead. Only a recorded row may displace the fallback; the port
    records none, so ``fallback`` wins with both priors in the provenance
    (the JAX package decides the same without a recorded row)."""
    S, M = max(1.0, stages), max(1.0, microbatches)
    feats = featurize(stages=S, microbatches=M)
    cands = [
        Candidate("dl_pipeline_schedule", "fill_drain", feats,
                  analytic_s=(M + S - 1.0) / M, config="fill_drain"),
        Candidate("dl_pipeline_schedule", "overlap", feats,
                  analytic_s=(M + 0.5 * (S - 1.0)) / M * 1.02,
                  config="overlap"),
    ]
    dec = choose_analytic(cands, fallback)
    return dec.arm, dec


def suggest_stage_cuts(unit_costs: Sequence[float], num_stages: int
                       ) -> Tuple[List[int], Decision]:
    """Cost-balanced contiguous pipeline cuts: the stage sizes (summing to
    ``len(unit_costs)``) that minimise the largest stage's summed cost, by
    dynamic programming over the prefix sums; the count-balanced sizes when
    the costs are degenerate (no positive cost, fewer units than
    stages)."""
    n, S = len(unit_costs), int(num_stages)
    base, rem = divmod(n, S) if S >= 1 else (0, 0)
    fallback_sizes = [base + (1 if s < rem else 0) for s in range(S)]
    costs = [max(0.0, float(c)) for c in unit_costs]
    if n < S or S < 1 or sum(costs) <= 0:
        dec = Decision("dl_stage_cuts", "count_balanced", fallback_sizes,
                       None, 0.0, True, "count_balanced", "fallback",
                       [], {"units": float(n), "stages": float(S)})
        return fallback_sizes, dec
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = math.inf
    # dp[s][i]: the least largest stage cost of units[:i] in s stages
    dp = [[inf] * (n + 1) for _ in range(S + 1)]
    cut = [[0] * (n + 1) for _ in range(S + 1)]
    dp[0][0] = 0.0
    for s in range(1, S + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                cost = max(dp[s - 1][j], prefix[i] - prefix[j])
                if cost < dp[s][i]:
                    dp[s][i], cut[s][i] = cost, j
    sizes: List[int] = []
    i = n
    for s in range(S, 0, -1):
        j = cut[s][i]
        sizes.append(i - j)
        i = j
    sizes.reverse()
    if min(sizes) < 1:
        sizes = fallback_sizes
    dec = Decision("dl_stage_cuts", "cost_balanced", sizes,
                   float(dp[S][n]), 0.9, sizes == fallback_sizes,
                   "count_balanced", "analytic",
                   [{"arm": "cost_balanced",
                     "max_stage_cost": float(dp[S][n])}],
                   {"units": float(n), "stages": float(S)})
    return sizes, dec


# ---------------------------------------------------------------------------
# The learned part: a journal of training rows and the three-step predictor
# (the JAX package's ``Prediction``, ``predict``, ``predict_runtime``,
# ``append_training_row`` and ``training_rows``)
# ---------------------------------------------------------------------------

SCHEMA_VERSION = 1
MATCH_DISTANCE = 0.15      # max per-feature log-space distance for a "match"
_FIT_MIN_R2 = 0.5          # reject fits that do not explain the data

#: the port's own journal of training rows, one JSON object a line. The JAX
#: package's ``docs/measurements.jsonl`` holds rows taken on TPUs and CPUs,
#: which say nothing of this card, so the port never reads it. No
#: environment variable moves the journal: pass ``path=`` or set this
#: attribute (tests point it at a temporary file).
JOURNAL_PATH = str(Path(__file__).resolve().parent.parent.parent / "build"
                   / "synapseml_tpu_torch" / "perf_rows.jsonl")


@dataclass
class Prediction:
    seconds: float
    confidence: float
    source: str               # "matched" | "fitted" | "analytic" | "none"
    detail: Dict[str, Any] = field(default_factory=dict)


def current_platform() -> str:
    """The platform rows are keyed by: ``"gpu"`` where a CUDA card is
    visible, else ``"cpu"``; a row of one never prices the other."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def mesh_tag(mesh: Any) -> Optional[str]:
    """A short tag of a port mesh's axes (``"data2xseq2"``), or None."""
    if mesh is None:
        return None
    try:
        return "x".join(f"{k}{v}" for k, v in dict(mesh.shape).items())
    except Exception:  # the tag is best-effort
        return None


_rows_lock = threading.Lock()
_rows_cache: Dict[str, Any] = {"stat": None, "rows": None}


def append_training_row(kind: str, arm: str, features: Dict[str, float],
                        observed_s: float,
                        platform: Optional[str] = None,
                        mesh: Any = None,
                        captured_at: Optional[str] = None,
                        path: Optional[str] = None,
                        **extra: Any) -> Dict[str, Any]:
    """Append one training row to the journal (``path``, default
    ``JOURNAL_PATH``) as a single ``O_APPEND`` line, safe under concurrent
    writers. Rows are keyed by platform, so a CPU row never prices the
    card."""
    if captured_at is None:
        import datetime
        captured_at = datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds")
    row = {
        "perf_row": SCHEMA_VERSION,
        "kind": str(kind),
        "arm": str(arm),
        "features": {k: float(v) for k, v in features.items()},
        "observed_s": float(observed_s),
        "platform": platform or current_platform(),
        "captured_at": captured_at,
    }
    tag = mesh_tag(mesh)
    if tag:
        row["mesh"] = tag
    row.update(extra)
    path = path or JOURNAL_PATH
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    line = json.dumps(row, sort_keys=True) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode("utf-8"))
    finally:
        os.close(fd)
    return row


def _parse_journal(path: str) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or not rec.get("perf_row"):
                continue
            if not isinstance(rec.get("features"), dict):
                continue
            try:
                rec["observed_s"] = float(rec["observed_s"])
            except (KeyError, TypeError, ValueError):
                continue
            if rec["observed_s"] <= 0:
                continue
            rows.append(rec)
    return rows


def training_rows(kind: Optional[str] = None,
                  platform: Optional[str] = None,
                  path: Optional[str] = None) -> List[Dict[str, Any]]:
    """The journal's rows (cached by the file's mtime and size), of one
    ``kind`` and ``platform`` when given."""
    path = path or JOURNAL_PATH
    try:
        st = os.stat(path)
        stat_key = (path, st.st_mtime_ns, st.st_size)
    except OSError:
        return []
    with _rows_lock:
        cached = _rows_cache["stat"] == stat_key
        rows = list(_rows_cache["rows"]) if cached else None
    if rows is None:
        # parse outside the lock: two racing fills parse the same snapshot
        parsed = _parse_journal(path)
        with _rows_lock:
            _rows_cache["stat"] = stat_key
            _rows_cache["rows"] = parsed
        rows = list(parsed)
    if kind is not None:
        rows = [r for r in rows if r.get("kind") == kind]
    if platform is not None:
        rows = [r for r in rows if r.get("platform") == platform]
    return rows


def _feature_distance(a: Dict[str, float], b: Dict[str, float]) -> float:
    """Max per-key distance in log1p space; missing keys count as far."""
    keys = set(a) | set(b)
    if not keys:
        return 0.0
    worst = 0.0
    for k in keys:
        if k not in a or k not in b:
            return math.inf
        worst = max(worst, abs(math.log1p(a[k]) - math.log1p(b[k])))
    return worst


def predict_runtime(candidate: Candidate,
                    rows: Optional[List[Dict[str, Any]]] = None,
                    platform: Optional[str] = None) -> Tuple[float, float]:
    """``(seconds, confidence)`` of :func:`predict`."""
    p = predict(candidate, rows=rows, platform=platform)
    return p.seconds, p.confidence


def predict(candidate: Candidate,
            rows: Optional[List[Dict[str, Any]]] = None,
            platform: Optional[str] = None) -> Prediction:
    """Predicted runtime of one candidate, from (1) near-matched rows of its
    (kind, arm, platform), (2) a least-squares fit of ``ln(observed_s)`` on
    ``[1, log1p(features)...]`` over its arm's rows, (3) its analytic prior,
    else ``(inf, 0.0, "none")`` — the JAX package's order and arithmetic."""
    platform = platform or current_platform()
    if rows is None:
        rows = training_rows(kind=candidate.kind, platform=platform)
    arm_rows = [r for r in rows if r.get("arm") == candidate.arm]

    # 1. near-matched replay of this (kind, arm, platform)
    scored = []
    for r in arm_rows:
        d = _feature_distance(candidate.features, r["features"])
        if d <= MATCH_DISTANCE:
            scored.append((d, r["observed_s"]))
    if scored:
        weights = [math.exp(-(d / MATCH_DISTANCE) ** 2) for d, _ in scored]
        sec = sum(w * s for w, (_, s) in zip(weights, scored)) / sum(weights)
        d_best = min(d for d, _ in scored)
        conf = max(0.6, min(0.95, 0.92 - d_best))
        return Prediction(sec, conf, "matched",
                          {"rows_matched": len(scored),
                           "distance": round(d_best, 4)})

    # 2. the fitted model across this arm's rows
    keys = sorted({k for r in arm_rows for k in r["features"]})
    usable = [r for r in arm_rows
              if all(k in r["features"] for k in keys)]
    if keys and len(usable) >= len(keys) + 2 and \
            all(k in candidate.features for k in keys):
        X = np.array([[1.0] + [math.log1p(r["features"][k]) for k in keys]
                      for r in usable])
        y = np.array([math.log(r["observed_s"]) for r in usable])
        if np.linalg.matrix_rank(X) == X.shape[1]:
            beta, *_ = np.linalg.lstsq(X, y, rcond=None)
            resid = y - X @ beta
            ss_tot = float(((y - y.mean()) ** 2).sum())
            r2 = 1.0 - float((resid ** 2).sum()) / ss_tot if ss_tot > 0 else 0.0
            if r2 >= _FIT_MIN_R2:
                xc = np.array([1.0] + [math.log1p(candidate.features[k])
                                       for k in keys])
                sec = float(math.exp(float(xc @ beta)))
                conf = min(0.75, 0.5 + 0.25 * r2)
                # extrapolating past the training envelope is a guess
                for j, k in enumerate(keys, start=1):
                    lo, hi = X[:, j].min(), X[:, j].max()
                    if not (lo - 1.0 <= xc[j] <= hi + 1.0):
                        conf = min(conf, ANALYTIC_CONFIDENCE)
                return Prediction(sec, conf, "fitted",
                                  {"rows_fit": len(usable),
                                   "r2": round(r2, 4), "keys": keys})

    # 3. the caller's analytic prior
    if candidate.analytic_s is not None:
        return Prediction(float(candidate.analytic_s), ANALYTIC_CONFIDENCE,
                          "analytic", {})

    return Prediction(math.inf, 0.0, "none", {})
