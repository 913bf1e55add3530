"""The port's bucketed runner and GBDT serving against the JAX package's.

The same call sequences go through the JAX ``BucketedRunner`` and the
port's (``device="cpu"``: ``fn`` runs eagerly on each padded rung, a compile
is counted the first time a (bucket, specs) key is seen), and the two must
give the same ladders, the same ``stats()`` counters and the same
``ValueError``s. Outputs agree within 1e-6 (a matrix product rounds
differently at different batch sizes, in the reference as here), and are
bitwise the eager call's for a row-independent ``fn``. Then GBDT serving on
boosters trained by the JAX package and carried across by ``convert``:
``serving_fn``, ``serving_fn(bucketed=False)`` and ``predict(batch_size=)``
within 1e-6 of the JAX ones, bitwise across padding, with the runner's
compile counts moving as the reference's do.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.core import inference as jinf
from synapseml_tpu.gbdt import boosting as jboost

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.core import inference as tinf
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
TOL = 1e-6

_W = np.random.default_rng(7).normal(size=(3, 4)).astype(np.float32)

# (JAX fn, port fn) pairs over the same inputs
FNS = {
    "affine": (lambda x: jnp.tanh(x) * 2.0 + 1.0,
               lambda x: torch.tanh(x) * 2.0 + 1.0),
    "matmul": (lambda x: jnp.tanh(x @ _W),
               lambda x: torch.tanh(x @ torch.from_numpy(_W))),
    "two_in_two_out": (lambda x, y: (x + y, x * y),
                       lambda x, y: (x + y, x * y)),
    "masked": (lambda x, m: jnp.where(m, x, -1.0),
               lambda x, m: torch.where(m, x, -1.0)),
}


def _runners(fn_name, **kw):
    jfn, tfn = FNS[fn_name]
    pass_mask = fn_name == "masked"
    return (jinf.BucketedRunner(jfn, pass_mask=pass_mask, **kw),
            tinf.BucketedRunner(tfn, pass_mask=pass_mask, device=CPU, **kw))


def _stats(runner) -> dict:
    out = runner.stats()
    out.pop("autoconfig", None)
    return out


# --------------------------------------------------------------------------
# ladder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch_size,growth,min_bucket", [
    (64, 2.0, 1), (4096, 2.0, 1), (100, 1.5, 1), (100, 1.3, 3), (1, 2.0, 1),
    (17, 4.0, 2), (64, 2.0, 64), (10, 1.01, 1),
    # refused by both
    (0, 2.0, 1), (8, 1.0, 1), (8, 0.5, 1), (8, 2.0, 0), (8, 2.0, 9)])
def test_bucket_ladder_matches_the_reference(max_batch_size, growth,
                                             min_bucket):
    try:
        want = jinf.bucket_ladder(max_batch_size, growth, min_bucket)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tinf.bucket_ladder(max_batch_size, growth, min_bucket)
        assert str(got.value) == str(e)
        return
    assert tinf.bucket_ladder(max_batch_size, growth, min_bucket) == want


def test_default_growth_is_the_references_fallback():
    j, t = _runners("affine", max_batch_size=64)
    assert t.buckets == j.buckets
    ja, ta = j.stats()["autoconfig"], t.stats()["autoconfig"]
    for key in ("kind", "arm", "used_fallback", "fallback_arm", "source",
                "features"):
        assert ta[key] == ja[key], key
    assert tinf.BucketedRunner(FNS["affine"][1], max_batch_size=8,
                               growth=4.0, device=CPU).buckets == (1, 4, 8)


def test_bucket_for_boundaries():
    j, t = _runners("affine", max_batch_size=64)
    for n in (1, 2, 3, 4, 5, 33, 64, 65, 1000):
        assert t.bucket_for(n) == j.bucket_for(n)
    for r in (j, t):
        with pytest.raises(ValueError):
            r.bucket_for(0)


# --------------------------------------------------------------------------
# counters: one script through both runners
# --------------------------------------------------------------------------

def _x(rng, n, *trail):
    return rng.normal(size=(n,) + trail).astype(np.float32)


def _script(name):
    """Steps (callable on a runner -> outputs or None); the same seeds give
    the same arrays to both runners."""
    rng = np.random.default_rng(3)
    if name == "two_in_two_out":
        a, b = _x(rng, 11, 2), _x(rng, 11, 2)
        return [lambda r: r.warmup(a[:1], b[:1]) and None,
                lambda r: r(a, b), lambda r: r(a[:3], b[:3]),
                lambda r: r.reset_stats(), lambda r: r(a[:8], b[:8])]
    if name == "masked":
        x = _x(rng, 13)
        return [lambda r: r(x[:3]), lambda r: r(x), lambda r: r(x[:3]),
                lambda r: r.warmup(x[:1]) and None, lambda r: r(x[:6])]
    x, y = _x(rng, 21, 3), _x(rng, 5, 3, 2)
    return [lambda r: r(x[:5]),                  # lazy compile, bucket 8
            lambda r: r(x[:6]),                  # hit
            lambda r: r(x),                      # chunked: 8 + 8 + tail 5
            lambda r: r.reset_stats(),
            lambda r: r(x[:1]),
            lambda r: r.warmup(x[:1]) and None,  # the rest of the ladder
            lambda r: r(x[:2]), lambda r: r(x[:8]),
            lambda r: r(y) if name == "affine" else None]  # new specs


@pytest.mark.parametrize("name", list(FNS))
def test_runner_counters_and_outputs_match_the_reference(name):
    j, t = _runners(name, max_batch_size=8)
    for step in _script(name):
        want, got = step(j), step(t)
        assert _stats(t) == _stats(j)
        assert t.warm_buckets() == j.warm_buckets()
        if want is None:
            continue
        if isinstance(want, (tuple, list)):
            assert type(got) is type(want) and len(got) == len(want)
            pairs = list(zip(got, want))
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    assert repr(t).startswith(f"BucketedRunner({t.name!r}")


@pytest.mark.parametrize("name", ["affine", "two_in_two_out", "masked"])
def test_padded_rows_never_leak_bitwise(name):
    """A row-independent fn gives, through the padded rungs and chunks, the
    eager call's values bit for bit."""
    _, t = _runners(name, max_batch_size=8)
    tfn = FNS[name][1]
    rng = np.random.default_rng(5)
    for n in (1, 3, 5, 8, 19):
        args = [_x(rng, n, 2)] if name != "masked" else [_x(rng, n)]
        if name == "two_in_two_out":
            args.append(_x(rng, n, 2))
        eager_args = [torch.from_numpy(a) for a in args]
        if name == "masked":
            eager_args.append(torch.ones(n, dtype=torch.bool))
        want = tfn(*eager_args)
        got = t(*args)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.numpy())
        else:
            np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n,bucket", [(1, 1), (3, 8), (8, 8), (5, 64)])
def test_staging_into_a_buffer_is_the_gather(n, bucket):
    """``_pad_to``, into a staging buffer or into a new array, gives row
    ``min(i, n - 1)`` at every padded index i."""
    arr = np.random.default_rng(n).normal(size=(n, 3, 4)).astype(np.float32)
    out = np.full((bucket, 3, 4), np.nan, np.float32)
    got = tinf._pad_to(arr, bucket, out=out)
    assert got is out
    np.testing.assert_array_equal(
        got, arr[np.minimum(np.arange(bucket), n - 1)])
    np.testing.assert_array_equal(tinf._pad_to(arr, bucket), got)


def test_pass_mask_marks_the_padded_rows():
    seen = []

    def fn(x, m):
        seen.append(m.clone())
        return x

    r = tinf.BucketedRunner(fn, max_batch_size=8, pass_mask=True, device=CPU)
    r(np.ones((3, 2), np.float32))
    assert seen[-1].tolist() == [True] * 3 + [False]
    assert seen[-1].dtype == torch.bool


@pytest.mark.parametrize("call", ["no_args", "ragged", "empty",
                                  "no_template", "scalar_chunked"])
def test_dispatch_errors_match_the_reference(call):
    j, t = _runners("affine", max_batch_size=4)
    js, ts = (jinf.BucketedRunner(lambda x: x.sum(), max_batch_size=4),
              tinf.BucketedRunner(lambda x: x.sum(), max_batch_size=4,
                                  device=CPU))
    a = np.ones((3, 2), np.float32)
    calls = {"no_args": lambda r, s: r.dispatch(),
             "ragged": lambda r, s: r.dispatch(a, a[:2]),
             "empty": lambda r, s: r.dispatch(a[:0]),
             "no_template": lambda r, s: r.warmup(),
             "scalar_chunked": lambda r, s: s(np.ones(9, np.float32))}
    for r, s in ((j, js), (t, ts)):
        with pytest.raises(ValueError):
            calls[call](r, s)
    # one chunk: a batch-dim reduction sees the repeated pad row, as in JAX
    assert float(ts(np.ones(3, np.float32))) == float(js(np.ones(3, np.float32)))


def test_pending_batch_and_fleet():
    _, t = _runners("affine", max_batch_size=8)
    x = np.ones((20, 2), np.float32)
    pending = t.dispatch(x)
    assert isinstance(pending, tinf.PendingBatch) and pending.num_rows == 20
    assert pending.block_until_ready() is pending
    np.testing.assert_array_equal(pending.result(),
                                  FNS["affine"][1](torch.from_numpy(x)))
    jfleet, tfleet = jinf.RunnerFleet(), tinf.RunnerFleet()
    for tenant in ("b", "a"):
        j, t = _runners("affine", max_batch_size=4, name=tenant)
        jfleet.register(tenant, j)
        tfleet.register(tenant, t)
    for fleet in (jfleet, tfleet):
        fleet.warm_all({"a": (x[:1],)})
        fleet.runner("b")(x[:3])
    assert tfleet.tenants() == jfleet.tenants() == ["a", "b"]
    js, ts = jfleet.stats(), tfleet.stats()
    assert (ts["total_compiles"], ts["total_hits"]) == \
        (js["total_compiles"], js["total_hits"])
    for tenant in ("a", "b"):
        assert _stats(tfleet.runner(tenant)) == _stats(jfleet.runner(tenant))


def test_concurrent_dispatch_is_thread_safe():
    r = tinf.BucketedRunner(FNS["affine"][1], max_batch_size=16, device=CPU)
    rng = np.random.default_rng(4)
    xs = [_x(rng, n % 16 + 1, 3) for n in range(48)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        outs = list(pool.map(r, xs))
    for x, got in zip(xs, outs):
        np.testing.assert_array_equal(
            got, FNS["affine"][1](torch.from_numpy(x)).numpy())
    stats = r.stats()
    # every bucket captured at most once despite the racing threads
    assert all(v == 1 for v in stats["compiles"].values())
    assert stats["total_hits"] + stats["total_compiles"] == len(xs)


# --------------------------------------------------------------------------
# GBDT serving on boosters carried across from the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def boosters():
    """name -> (X, JAX booster, the port's copy by ``convert``)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 5)).astype(np.float32)
    X[rng.random(500) < 0.1, 3] = np.nan
    y2 = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    y3 = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(np.float32)
    cfgs = {
        "binary": (y2, jboost.BoosterConfig(objective="binary",
                                            num_iterations=4, num_leaves=7)),
        "multiclass": (y3, jboost.BoosterConfig(
            objective="multiclass", num_class=3, num_iterations=3,
            num_leaves=7)),
        "rf": (y2, jboost.BoosterConfig(
            objective="binary", boosting_type="rf", bagging_fraction=0.8,
            bagging_freq=1, num_iterations=4, num_leaves=7)),
    }
    out = {}
    for name, (y, cfg) in cfgs.items():
        jb = jboost.train_booster(X, y, cfg)
        arrays, config = booster_arrays(jb)
        out[name] = (X, jb, booster_from_reference(arrays, config,
                                                   device=CPU))
    return out


def _windowed(name, boosters, start):
    """The boosters of ``name`` with the config's prediction window set (a
    fresh port copy, so the fixture's cached serving runners stay valid)."""
    X, jb, _ = boosters[name]
    arrays, config = booster_arrays(jb)
    config["start_iteration"] = start
    jw = jboost.Booster(jb.mapper, dataclasses.replace(
        jb.config, start_iteration=start), jb.trees, jb.tree_weights,
        jb.base_score, thresholds=jb.thresholds,
        missing_types=jb.missing_types)
    return X, jw, booster_from_reference(arrays, config, device=CPU)


@pytest.mark.parametrize("name,start", [("binary", 0), ("multiclass", 0),
                                        ("rf", 0), ("binary", 2),
                                        ("multiclass", 1), ("rf", 1)])
def test_serving_fn_matches_the_reference(boosters, name, start):
    X, jb, tb = _windowed(name, boosters, start) if start \
        else boosters[name]
    jserve, tserve = jb.serving_fn(max_batch_size=8), \
        tb.serving_fn(max_batch_size=8)
    plain = tb.serving_fn(bucketed=False)
    assert not hasattr(plain, "runner")
    for n in (1, 5, 19):
        got = tserve(X[:n])
        want = np.asarray(jserve(X[:n]))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        eager = plain(X[:n])
        assert isinstance(eager, torch.Tensor)
        # padded and unpadded bitwise; predict's values too
        np.testing.assert_array_equal(got, eager.numpy())
        np.testing.assert_array_equal(got, tb.predict(X[:n]))
    np.testing.assert_allclose(
        plain(X[:5]).numpy(), np.asarray(jb.serving_fn(bucketed=False)(X[:5])),
        rtol=0, atol=TOL)
    # predict's window and RF rescale agree with the reference's too
    np.testing.assert_allclose(tb.raw_score(X), np.asarray(jb.raw_score(X)),
                               rtol=0, atol=TOL)


def test_serving_fn_warmup_and_counters(boosters):
    X, jb, tb = boosters["binary"]
    tserve = tb.serving_fn(max_batch_size=16)
    jserve = jb.serving_fn(max_batch_size=16)
    tstats, jstats = tserve.warmup(), jserve.warmup()
    assert tstats["total_compiles"] == len(tstats["buckets"])
    assert {k: tstats[k] for k in ("buckets", "compiles", "warmup_compiles")} \
        == {k: jstats[k] for k in ("buckets", "compiles", "warmup_compiles")}
    assert tstats["name"] == jstats["name"] == "gbdt.serving_fn"
    tserve(X[:5])
    jserve(X[:5])
    assert _stats(tserve.runner) == _stats(jserve.runner)
    assert tserve.runner.stats()["total_compiles"] == len(tstats["buckets"])


def test_batched_predict_reuses_one_cached_ladder(boosters):
    """tests/test_inference_runtime.py's batched-predict counters: a new
    rung compiles once, a cached one never again."""
    X, jb, tb = boosters["multiclass"]
    got = tb.predict(X, batch_size=64)
    np.testing.assert_allclose(got, np.asarray(jb.predict(X, batch_size=64)),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(got, tb.predict(X))
    serve = tb._serving_cache[64]
    assert serve.runner.max_batch_size == 64
    before = serve.runner.stats()["total_compiles"]
    jbefore = jb._serving_cache[64].runner.stats()["total_compiles"]
    assert before == jbefore
    for rows, grown in ((7, 1), (8, 1), (3, 2)):
        tb.predict(X[:rows], batch_size=64)
        jb.predict(X[:rows], batch_size=64)
        assert serve.runner.stats()["total_compiles"] == before + grown
        assert _stats(serve.runner) == _stats(jb._serving_cache[64].runner)


@pytest.mark.parametrize("kw", [dict(max_batch_size=0), dict(binned=True),
                                dict(num_iteration=2)])
def test_serving_guards_match_the_reference(boosters, kw):
    X, jb, tb = boosters["binary"]
    for b in (jb, tb):
        with pytest.raises(ValueError):
            if "max_batch_size" in kw:
                b.serving_fn(**kw)
            else:
                b.predict(X, batch_size=8, **kw)
