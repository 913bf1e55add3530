"""The VW step and the fabric on the card (skipped without one).

The learner's pass on the card against the same pass on the CPU (the
card's ``index_add_`` adds repeated indices by atomics in no fixed order:
``CARD_TOL`` of the largest weight), the same pass bitwise twice under
``torch.use_deterministic_algorithms`` (the online loop's kill and resume
relies on it), and a gateway forwarding to a worker that replays the
classifier's captured graphs, its replies held to ``predict``. These tests
import no JAX.
"""

from __future__ import annotations

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core import Table

CARD_TOL = 1e-4        # of max |w|: chip_smoke.py phase 22's bound
LOSS_TOL = 1e-5        # relative: the progressive loss


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the card's pass has no CPU mode")
    return "cuda"


def _table(n=20000, p=24, bits=12, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, (n, p)).astype(np.int32)
    idx[:, 0] = 3                     # a feature in every row
    val = rng.normal(size=(n, p)).astype(np.float32)
    y = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    return idx, val, y


@pytest.mark.cuda
@pytest.mark.parametrize("loss,extra", [
    ("logistic", {}), ("squared", dict(adaptive=False)),
    ("hinge", dict(l1=1e-5, l2=1e-4))])
def test_vw_pass_on_the_card_matches_the_cpu(cuda, loss, extra):
    from synapseml_tpu_torch.vw.learner import VWConfig, train_vw

    idx, val, y = _table()
    cfg = VWConfig(num_bits=12, loss_function=loss, learning_rate=0.05,
                   **extra)
    card, cp = train_vw(idx, val, y, cfg, collect_progressive=True,
                        device=cuda)
    cpu, pp = train_vw(idx, val, y, cfg, collect_progressive=True,
                       device="cpu")
    assert card.device.type == "cuda"
    w, wc = card.weights.cpu().numpy(), cpu.weights.numpy()
    assert np.abs(w - wc).max() <= CARD_TOL * np.abs(wc).max()
    assert abs(card.progressive_loss - cpu.progressive_loss) <= \
        LOSS_TOL * abs(cpu.progressive_loss)
    assert np.abs(cp - pp).max() <= CARD_TOL * np.abs(pp).max()


@pytest.mark.cuda
def test_vw_pass_is_bitwise_under_deterministic_algorithms(cuda):
    from synapseml_tpu_torch.vw.learner import VWConfig, train_vw

    idx, val, y = _table(seed=1, bits=10)
    cfg = VWConfig(num_bits=10, loss_function="logistic", batch_size=64)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a, _ = train_vw(idx, val, y, cfg, device=cuda)
        b, _ = train_vw(idx, val, y, cfg, device=cuda)
    finally:
        torch.use_deterministic_algorithms(was)
    for k, v in a.arrays().items():
        assert v.tobytes() == b.arrays()[k].tobytes(), k


@pytest.mark.cuda
def test_gateway_forwards_to_a_worker_replaying_graphs(cuda):
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.io.distributed_serving import (ServingGateway,
                                                            WorkerAgent)
    from synapseml_tpu_torch.io.serving import ServingServer

    rng = np.random.default_rng(2)
    X = rng.normal(size=(4000, 8)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] > 0).astype(np.float32)
    booster = train_booster(X, y, BoosterConfig(
        objective="binary", num_iterations=10, num_leaves=15), device=cuda)
    serve = booster.serving_fn(max_batch_size=16)

    def handler(df):
        x = np.asarray([v["x"] for v in df["value"]], np.float32)
        return Table({"id": df["id"], "reply": serve(x)})

    handler.warmup = serve.warmup
    handler.runner = serve.runner
    with ServingServer(handler, port=0, max_batch_latency=0.002) as w:
        gw = ServingGateway([w.url], port=0, local_worker=None).start()
        agent = WorkerAgent(w, gw.url, interval=0.1).start()
        try:
            def post(i):
                req = urllib.request.Request(
                    gw.url, data=json.dumps({"x": X[i].tolist()}).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=10) as r:
                    return r.status, json.loads(r.read())

            with ThreadPoolExecutor(8) as pool:
                got = list(pool.map(post, range(200)))
            assert {s for s, _ in got} == {200}
            np.testing.assert_allclose([r for _, r in got],
                                       booster.predict(X[:200]), rtol=0,
                                       atol=1e-6)
            stats = serve.runner.stats()
            assert stats["total_compiles"] == stats["warmup_compiles"]
        finally:
            agent.stop()
            gw.stop()
