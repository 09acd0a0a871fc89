"""The port's native npy loader against the JAX package's and ``np.load``:
the cases of ``tests/test_native_loader.py``, every supported dtype at
every ndim from 1 to 4, and the build of the library at first use.

The port's pool builds ``pcseqlearning_tpu_torch/csrc/npy_loader.cpp`` with
g++ and has no fallback, so ``native`` is always true here.
"""

import numpy as np
import pytest

from pcseqlearning_tpu.datasets.native_loader import AsyncNpyPool as JPool
from pcseqlearning_tpu_torch.datasets import native_loader
from pcseqlearning_tpu_torch.datasets.native_loader import AsyncNpyPool, PrefetchIterator

DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint8)


def test_native_npy_roundtrip(tmp_path, rng):
    pool = AsyncNpyPool(workers=2)
    jpool = JPool(workers=2)
    arrays = {
        "f32": rng.rand(100, 8).astype(np.float32),
        "f64": rng.rand(7).astype(np.float64),
        "i64": rng.randint(0, 100, (5, 3)).astype(np.int64),
        "i32": rng.randint(0, 100, (4,)).astype(np.int32),
        "u8": (rng.rand(6, 2) * 255).astype(np.uint8),
    }
    paths = {}
    for name, arr in arrays.items():
        paths[name] = tmp_path / f"{name}.npy"
        np.save(paths[name], arr)
    tickets = {n: pool.submit(p) for n, p in paths.items()}  # all in flight at once
    for name, t in tickets.items():
        out = pool.get(t)
        assert out.dtype == arrays[name].dtype and out.shape == arrays[name].shape
        np.testing.assert_array_equal(out, arrays[name])
        want = jpool.load(paths[name])
        assert out.dtype == want.dtype
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_every_dtype_and_ndim_equals_np_load(tmp_path, dtype):
    """One array of each ndim 1-4 (one with a zero-length axis) through
    ``load_many`` on four workers: bytes, dtype and shape equal np.load's."""
    rng = np.random.RandomState(np.dtype(dtype).num)
    paths = []
    for ndim, shape in enumerate([(1000,), (300, 8), (7, 5, 3), (2, 3, 4, 5), (0, 4)], 1):
        a = (rng.rand(*shape) * 200 - (0 if dtype == np.uint8 else 100)).astype(dtype)
        paths.append(tmp_path / f"a{ndim}.npy")
        np.save(paths[-1], a)
    for got, p in zip(AsyncNpyPool(workers=4).load_many(paths * 3), paths * 3):
        want = np.load(p)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_native_loader_is_native():
    pool = AsyncNpyPool()
    assert pool.native
    assert native_loader.library_path().exists()
    assert native_loader.library_path().parent.name == "_build"


def test_native_loader_error(tmp_path):
    pool = AsyncNpyPool(workers=1)
    with pytest.raises(IOError, match="open failed"):
        pool.load(tmp_path / "missing.npy")
    np.save(tmp_path / "c64.npy", np.zeros(3, np.complex64))
    with pytest.raises(IOError, match="unsupported dtype"):
        pool.load(tmp_path / "c64.npy")
    np.save(tmp_path / "ok.npy", np.arange(3))
    np.testing.assert_array_equal(pool.load(tmp_path / "ok.npy"), np.arange(3))  # pool still works


def test_build_failure_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "npy_loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native_loader.build_library()
    assert not list((tmp_path / "_build").glob("*"))  # no partial library left


def test_prefetch_iterator():
    src = list(range(20))
    it = PrefetchIterator(src, depth=4)
    assert len(it) == 20 and list(it) == src
    assert list(PrefetchIterator(iter(src), depth=4)) == src
