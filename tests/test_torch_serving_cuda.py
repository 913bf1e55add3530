"""The bucketed runner's CUDA graphs on the card (skipped without one).

Captured graphs replay the eager call's values bit for bit for a
row-independent ``fn``, stay right under concurrent dispatch from many
threads (one capture per rung; rungs that share a memory pool never
interleave their replays), and a ``fn`` that waits on the host inside
the capture makes the capture fail with an error, never an eager fallback.
Then ``Booster.serving_fn`` on the card against ``predict``, and the
serving server in front of it. These tests import no JAX: on the card they
compare with the plain PyTorch call.
"""

from __future__ import annotations

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.core.inference import BucketedRunner


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return "cuda"


def _rowwise(x):
    return torch.tanh(x) * 2.0 + x.sum(dim=1, keepdim=True)


@pytest.mark.cuda
def test_graphs_replay_the_eager_values(cuda):
    r = BucketedRunner(_rowwise, max_batch_size=32, device=cuda)
    stats = r.warmup(np.zeros((1, 5), np.float32))
    assert stats["total_compiles"] == len(r.buckets) == 6
    rng = np.random.default_rng(0)
    for n in (1, 3, 17, 32, 77):
        x = rng.normal(size=(n, 5)).astype(np.float32)
        want = _rowwise(torch.from_numpy(x).to(cuda)).cpu().numpy()
        np.testing.assert_array_equal(r(x), want)
    stats = r.stats()
    assert stats["total_compiles"] == stats["warmup_compiles"]
    assert stats["total_hits"] == 1 + 1 + 1 + 1 + 3


@pytest.mark.cuda
def test_replay_is_right_under_concurrent_dispatch(cuda):
    r = BucketedRunner(_rowwise, max_batch_size=16, device=cuda)
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(n % 40 + 1, 3)).astype(np.float32)
          for n in range(96)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        outs = list(pool.map(r, xs))
    for x, got in zip(xs, outs):
        want = _rowwise(torch.from_numpy(x).to(cuda)).cpu().numpy()
        np.testing.assert_array_equal(got, want)
    assert all(v == 1 for v in r.stats()["compiles"].values())


def _temporaries(x):
    # elementwise, so row-independent and bitwise at any batch size, with
    # temporaries 64x the input: from 4 KiB at the 1-row rung to 1 MiB at
    # the 256-row one, so later rungs' outputs can land in memory that
    # earlier rungs of the shared pool use for temporaries
    t = x.repeat(1, 64)
    u = torch.sin(t) * 3.0 + torch.cos(t * 0.5)
    v = u * u - t
    return v[:, :16] + v[:, -16:] + u[:, 16:32]


@pytest.mark.cuda
def test_rungs_sharing_a_pool_stay_right_under_mixed_concurrent_dispatch(
        cuda):
    r = BucketedRunner(_temporaries, max_batch_size=256, device=cuda)
    r.warmup(np.zeros((1, 16), np.float32))
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 300, 4000)
    xs = [rng.normal(size=(int(n), 16)).astype(np.float32) for n in sizes]
    with ThreadPoolExecutor(max_workers=8) as pool:
        outs = list(pool.map(r, xs))
    want = _temporaries(torch.from_numpy(np.concatenate(xs)).to(cuda))
    want = np.split(want.cpu().numpy(), np.cumsum(sizes)[:-1])
    bad = [i for i, (got, w) in enumerate(zip(outs, want))
           if not np.array_equal(got, w)]
    assert not bad, f"{len(bad)} of {len(xs)} replies differ, first {bad[:5]}"
    stats = r.stats()
    assert stats["total_compiles"] == stats["warmup_compiles"] == 9
    assert stats["total_hits"] == int(sum((n + 255) // 256 for n in sizes))


@pytest.mark.cuda
def test_a_host_sync_inside_the_capture_fails_it(cuda):
    def syncs(x):
        return x * float(x.sum().item())

    r = BucketedRunner(syncs, max_batch_size=4, device=cuda)
    with pytest.raises(RuntimeError):
        r.warmup(np.zeros((1, 2), np.float32))
    assert r.stats()["total_compiles"] == 0
    # the failed capture leaves the card usable for the next runner
    ok = BucketedRunner(_rowwise, max_batch_size=4, device=cuda)
    x = np.ones((3, 2), np.float32)
    np.testing.assert_array_equal(
        ok(x), _rowwise(torch.from_numpy(x).to(cuda)).cpu().numpy())


@pytest.fixture
def card_booster(cuda):
    """A binary booster fitted on the CPU, carried to the card by its model
    string (scoring needs no kernel of ours)."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.gbdt.boosting import Booster

    rng = np.random.default_rng(2)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2] > 0).astype(np.float32)
    cpu = train_booster(X, y, BoosterConfig(objective="binary",
                                            num_iterations=5, num_leaves=15),
                        device="cpu")
    return X, Booster.from_model_string(cpu.model_string(), device=cuda)


@pytest.mark.cuda
def test_serving_fn_on_the_card_is_predict(card_booster):
    X, booster = card_booster
    serve = booster.serving_fn(max_batch_size=16)
    serve.warmup()
    for n in (1, 9, 16, 45):
        np.testing.assert_array_equal(serve(X[:n]), booster.predict(X[:n]))
    np.testing.assert_array_equal(booster.predict(X, batch_size=64),
                                  booster.predict(X))
    stats = serve.runner.stats()
    assert stats["total_compiles"] == stats["warmup_compiles"]


@pytest.mark.cuda
def test_server_replies_through_the_graphs(card_booster):
    from synapseml_tpu_torch.io.serving import ServingServer

    X, booster = card_booster
    serve = booster.serving_fn(max_batch_size=8)

    def handler(df):
        x = np.asarray([v["features"] for v in df["value"]], np.float32)
        return Table({"id": df["id"], "reply": serve(x)})

    handler.warmup, handler.runner = serve.warmup, serve.runner

    def post(row):
        req = urllib.request.Request(
            srv.url, data=json.dumps({"features": row.tolist()}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    srv = ServingServer(handler, port=0, max_batch_size=8).start()
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            got = np.asarray(list(pool.map(post, X[:20])))
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            snap = json.loads(resp.read())
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, booster.predict(X[:20]))
    assert snap["runner"]["total_compiles"] == \
        snap["runner"]["warmup_compiles"]
