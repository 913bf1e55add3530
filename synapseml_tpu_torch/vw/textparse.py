"""VW text-line format parser for the Generic learners.

The reference's VowpalWabbitGeneric feeds raw VW-format strings straight to the
native parser (vw/.../VowpalWabbitGeneric.scala). Here we parse the same format
host-side into padded sparse batches.

Supported grammar (the common core):
    [label] [importance [initial]] ['tag] |ns[:ns_scale] feat[:value] ... |ns2 ...
Contextual-bandit data enters through VowpalWabbitContextualBandit's columnar
API (sparse action-feature columns), not through this text parser.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .hashing import hash_feature, interaction_hash, namespace_hash
from .learner import make_sparse_batch


def parse_example(line: str, num_bits: int,
                  interactions: Tuple[str, ...] = (), hash_seed: int = 0,
                  ignore_namespaces: str = "") -> Tuple[Optional[float], float, list, list]:
    """Parse one VW text line → (label | None, importance, indices, values).

    ``ignore_namespaces``: first letters of namespaces to drop (VW --ignore)."""
    mask = (1 << num_bits) - 1
    head, sep, feats = line.partition("|")
    label: Optional[float] = None
    importance = 1.0
    head_toks = head.split()
    if head_toks:
        plain = [t for t in head_toks if not t.startswith("'")]
        if plain:
            label = float(plain[0])
            if len(plain) > 1:
                importance = float(plain[1])

    idx: List[int] = []
    val: List[float] = []
    ns_first_hash: dict = {}
    if sep:
        for block in ("|" + feats).split("|")[1:]:
            toks = block.split()
            if not toks:
                continue
            if block[0] not in (" ", "\t"):
                ns_tok = toks[0]
                toks = toks[1:]
                ns_name, _, scale_s = ns_tok.partition(":")
                ns_scale = float(scale_s) if scale_s else 1.0
            else:
                ns_name, ns_scale = "", 1.0
            if ignore_namespaces and (ns_name[:1] or " ") in ignore_namespaces:
                continue
            seed = namespace_hash(ns_name, hash_seed)
            for tok in toks:
                name, _, v = tok.partition(":")
                h = hash_feature(name, seed)
                idx.append(h & mask)
                val.append((float(v) if v else 1.0) * ns_scale)
                ns_first_hash.setdefault(ns_name[:1] or " ", []).append((h, val[-1]))
    # quadratic interactions between namespaces by first letter (VW -q ab)
    for pair in interactions:
        if len(pair) != 2:
            continue
        for h1, v1 in ns_first_hash.get(pair[0], []):
            for h2, v2 in ns_first_hash.get(pair[1], []):
                idx.append(interaction_hash(h1, h2) & mask)
                val.append(v1 * v2)
    return label, importance, idx, val


def parse_lines(lines, num_bits: int, interactions: Tuple[str, ...] = (),
                hash_seed: int = 0, ignore_namespaces: str = ""):
    """Parse many lines → (sparse structured array, labels, importances).

    Unlabeled examples get label = nan."""
    labels, weights, idxs, vals = [], [], [], []
    for line in lines:
        lab, imp, ix, vv = parse_example(str(line), num_bits, interactions,
                                         hash_seed, ignore_namespaces)
        labels.append(np.nan if lab is None else lab)
        weights.append(imp)
        idxs.append(ix)
        vals.append(vv)
    sp = make_sparse_batch(idxs, vals)
    return sp, np.asarray(labels, np.float32), np.asarray(weights, np.float32)
