"""The port's native host helpers (``synapseml_tpu_torch/native``) on the
CPU: every scenario of ``tests/test_native.py`` on the port, the batch
hashes equal to the port's numpy batch path (``vw/hashing.py``) and to the
JAX package's native library on the same names, the hashing TF and the CSV
reader equal to the JAX package's, and the library built under the
checkout's ``build/`` (never beside its source)."""

import os
import time

import numpy as np
import pytest

from synapseml_tpu import native as jnative
from synapseml_tpu.io.binary import load_numeric_csv as jload_numeric_csv

from synapseml_tpu_torch import native
from synapseml_tpu_torch.vw.hashing import (hash_feature, hash_strings,
                                            murmur3_32, murmur3_32_batch)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library unavailable")


def _names(n=300, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"feature_{i}" for i in range(n)] + ["17", "-3", "0", "", "é🙂"]
    return words + ["".join(rng.choice(list("abcdef?"), size=int(k)))
                    for k in rng.integers(1, 40, size=n)]


class TestNativeHashing:
    @needs_native
    def test_single_hash_parity(self):
        for s, seed in [(b"", 0), (b"a", 0), (b"abc", 7), (b"hello world", 42),
                        ("émoji🙂".encode(), 3), (b"x" * 133, 99)]:
            assert native.murmur3_32(s, seed) == murmur3_32(s, seed), (s, seed)

    @needs_native
    def test_batch_parity_with_python(self):
        names = [f"feature_{i}" for i in range(200)] + ["17", "-3", "0"]
        got = native.murmur3_32_batch(names, 123, vw_numeric_names=True)
        want = np.array([hash_feature(n, 123) for n in names], np.uint32)
        np.testing.assert_array_equal(got, want)

    @needs_native
    def test_seeded_batch(self):
        names = ["a", "b", "c"]
        seeds = np.array([1, 2, 3], np.uint32)
        got = native.murmur3_32_batch(names, seeds, vw_numeric_names=False)
        want = np.array([murmur3_32(n.encode(), s)
                         for n, s in zip(names, seeds)], np.uint32)
        np.testing.assert_array_equal(got, want)

    @needs_native
    def test_mask(self):
        names = [f"n{i}" for i in range(100)]
        got = native.murmur3_32_batch(names, 0, mask=(1 << 10) - 1)
        assert got.max() < 1 << 10

    def test_hash_strings_same_result_any_path(self):
        # the public API must agree whether or not the batch path engaged
        names = [f"tok{i}" for i in range(100)]
        big = hash_strings(names, 5, num_bits=18)        # numpy batch path
        small = np.concatenate([hash_strings(names[i:i + 1], 5, num_bits=18)
                                for i in range(100)])    # forced python path
        np.testing.assert_array_equal(big, small)

    @needs_native
    def test_hash_tf_tokenizer(self):
        docs = ["Hello, hello WORLD!", "the quick brown fox"]
        out = native.hash_tf(docs, 256, min_len=1)
        assert out.shape == (2, 256)
        # 'hello' twice in doc 0
        idx = murmur3_32(b"hello") & 255
        assert out[0, idx] == 2.0
        assert out.sum() == 3 + 4  # 3 tokens doc0, 4 tokens doc1

    @needs_native
    def test_hash_tf_rejects_non_pow2(self):
        assert native.hash_tf(["x"], 100) is None

    @needs_native
    @pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
    def test_batch_equals_the_numpy_batch_path(self, seed):
        names = _names()
        got = native.murmur3_32_batch(names, seed, vw_numeric_names=False)
        want = murmur3_32_batch([n.encode("utf-8") for n in names], seed)
        np.testing.assert_array_equal(got, want)

    @needs_native
    def test_equals_the_jax_packages_native_library(self):
        if not jnative.available():
            pytest.skip("the JAX package's native library is unavailable")
        names = _names(seed=1)
        for kw in (dict(vw_numeric_names=True), dict(vw_numeric_names=False,
                                                      mask=(1 << 18) - 1)):
            np.testing.assert_array_equal(
                native.murmur3_32_batch(names, 5, **kw),
                jnative.murmur3_32_batch(names, 5, **kw))
        docs = ["The cat sat on the mat", "a b  c,,d", "", "X" * 70] * 20
        for kw in (dict(min_len=1), dict(min_len=2, binary=True)):
            np.testing.assert_array_equal(native.hash_tf(docs, 512, **kw),
                                          jnative.hash_tf(docs, 512, **kw))

    def test_library_builds_under_the_checkouts_build_dir(self):
        path = native.library_path()
        assert os.path.dirname(path) == native.BUILD_DIR
        assert native.BUILD_DIR.endswith(os.path.join("build",
                                                      "synapseml_tpu_torch"))
        src_dir = os.path.dirname(native.SRC)
        assert not any(f.endswith(".so") for f in os.listdir(src_dir))
        assert not any(f.endswith(".so") for f in
                       os.listdir(os.path.dirname(src_dir)))
        if native.available():
            assert os.path.exists(path)


class TestNativeSpeed:
    @needs_native
    def test_batch_faster_than_python(self):
        names = [f"some_feature_name_{i}" for i in range(50000)]
        t0 = time.perf_counter()
        native.murmur3_32_batch(names, 0)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.fromiter((hash_feature(n, 0) for n in names), np.int64,
                    count=len(names))
        t_py = time.perf_counter() - t0
        assert t_native < t_py, (t_native, t_py)


class TestNativeCSV:
    """The JAX package's ``io/binary.load_numeric_csv`` is not ported yet
    (ROADMAP Queue 1 item 8 (b)); its C++ reader is, and is held to it."""

    def _write_csv(self, tmp_path, text):
        p = tmp_path / "data.csv"
        p.write_text(text)
        return str(p)

    @needs_native
    def test_numeric_csv_parity_with_numpy(self, tmp_path):
        rng = np.random.default_rng(0)
        M = rng.normal(size=(200, 6)).astype(np.float32)
        lines = ["c0,c1,c2,c3,c4,c5"]
        for row in M:
            lines.append(",".join(f"{v:.6g}" for v in row))
        p = self._write_csv(tmp_path, "\n".join(lines) + "\n")
        got = native.read_numeric_csv(p)
        assert got.shape == M.shape
        np.testing.assert_allclose(got, M, rtol=1e-5)
        np.testing.assert_array_equal(got, jload_numeric_csv(p))

    @needs_native
    def test_missing_and_bad_fields_become_nan(self, tmp_path):
        p = self._write_csv(tmp_path, "a,b,c\n1,,3\n,abc,6\n7,8,9\n")
        got = native.read_numeric_csv(p)
        assert got.shape == (3, 3)
        assert np.isnan(got[0, 1]) and np.isnan(got[1, 0])
        assert np.isnan(got[1, 1])
        np.testing.assert_allclose(got[2], [7, 8, 9])
        np.testing.assert_array_equal(got, jload_numeric_csv(p))

    @needs_native
    def test_no_header_and_trailing_newline_variants(self, tmp_path):
        p = self._write_csv(tmp_path, "1,2\n3,4")      # no trailing newline
        got = native.read_numeric_csv(p, has_header=False)
        np.testing.assert_allclose(got, [[1, 2], [3, 4]])

    @needs_native
    def test_feeds_training_end_to_end(self, tmp_path):
        from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

        rng = np.random.default_rng(1)
        X = rng.normal(size=(400, 4)).astype(np.float32)
        y = (X[:, 0] > 0).astype(np.float32)
        lines = ["f0,f1,f2,f3,label"]
        for row, lab in zip(X, y):
            lines.append(",".join(f"{v:.6g}" for v in row) + f",{lab:g}")
        p = self._write_csv(tmp_path, "\n".join(lines) + "\n")
        M = native.read_numeric_csv(p)
        bst = train_booster(M[:, :4], M[:, 4],
                            BoosterConfig(objective="binary",
                                          num_iterations=5), device=CPU)
        acc = ((bst.predict(M[:, :4]) > 0.5) == (M[:, 4] > 0.5)).mean()
        assert acc > 0.9
