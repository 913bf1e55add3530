"""``chip_smoke.py`` phase 26 — HTTP on the card — rehearsed on the CPU at
a small size: the classifier behind the port's server with the plain,
chaos and budget passes, the embeddings stub into KNN, and the images
through the datasources, CNTKModel and PowerBIWriter, with the CPU process
beside. On the CPU the card-against-CPU checks compare the CPU port with
itself, so the rehearsal passes whole."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)  # noqa: E402

SMALL = dict(HTTP_FIT_ROWS=3000, HTTP_ITERS=3, HTTP_REQUESTS=96,
             HTTP_CONCURRENCY=4, HTTP_EXHAUST_ROWS=64, HTTP_EXHAUST_BURST=2,
             EMBED_TEXTS=120, EMBED_WIDTH=48, EMBED_QUERIES=24,
             EMBED_CONCURRENCY=4, IMAGE_COUNT=8, IMAGE_SIDE=32,
             CNTK_CROSS=2, POWERBI_BATCH=2, HTTP_CPU_THREADS=1)


def test_phase_26_helpers_import_without_a_card():
    for name in ("http_path", "serve_start", "serve_part", "embed_part",
                 "cntk_part", "start_http_cpu", "_http_cpu", "_http_pass"):
        assert callable(getattr(cs, name)), name
    assert set(cs._HTTP_SETTINGS) <= set(vars(cs))
    assert cs.EMBED_WIDTH == 1536 and cs.HTTP_CONCURRENCY == 16


def test_the_stubs_vectors_are_seeded_and_read_back_bitwise():
    import json

    from tools.embedding_stub import embed_texts, embedding_of, reply_body

    texts = embed_texts(50)
    assert len(set(texts)) == 50 and texts == embed_texts(50)
    a, b = embedding_of(texts[0], 16), embedding_of(texts[1], 16)
    assert a.dtype == np.float32 and not np.array_equal(a, b)
    assert np.array_equal(a, embedding_of(texts[0], 16))
    for t in texts:
        got = json.loads(reply_body(t, 1536))["data"][0]["embedding"]
        assert np.array_equal(np.asarray(got, np.float32),
                              embedding_of(t, 1536))


def test_phase_26_rehearses_on_the_cpu(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(cs, k, v)
    out = cs.http_path("cpu")
    assert set(out) == {"a", "b", "c"}
    assert out["a"]["launches"]["child_histogram"] == 0     # CPU: no kernel
    assert out["a"]["chaos"]["attempts"] > cs.HTTP_REQUESTS
    assert out["a"]["exhausted_rows"] > 0
    assert out["b"]["embeddings_per_s"] > 0
    assert out["c"]["cpu_gap"] == 0.0


def test_chip_smoke_defines_each_top_level_function_once():
    """A second top-level ``def`` of a name silently replaces the first
    (phase 26's first image part once replaced phase 24's)."""
    import ast

    tree = ast.parse(Path(cs.__file__).read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert sorted({n for n in names if names.count(n) > 1}) == []
