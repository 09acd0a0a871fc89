"""The native async npy loader (counterpart of
pcseqlearning_tpu.datasets.native_loader) and a background-prefetch
iterator.

``AsyncNpyPool`` drives ``csrc/npy_loader.cpp`` through ctypes: submit a
batch of paths, C++ threads read and decode them off the Python thread,
collect each as a NumPy array. The library is built at first use with
``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into
``pcseqlearning_tpu_torch/_build/`` (git-ignored), named by a hash of its
source and written under a temporary name that ``os.replace`` moves into
place, so processes that build at once do not see each other's partial
files. There is no fallback: the pool builds the library or raises with the
compiler's message, and ``native`` is always true. A file that cannot be
read raises ``IOError``.

As in the JAX package, neither ``WaymoDataset`` nor the train loop uses the
pool or ``PrefetchIterator``: they read with ``np.load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "npy_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64, 4: np.uint8}
_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"npy_loader-{digest}.so"


def build_library() -> Path:
    """The library's path, compiled first if it is missing."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native npy loader builds with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.npy_pool_create.restype = ctypes.c_void_p
            lib.npy_pool_create.argtypes = [ctypes.c_int]
            lib.npy_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.npy_submit.restype = ctypes.c_int64
            lib.npy_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.npy_wait.restype = ctypes.c_int32
            lib.npy_wait.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.npy_error.restype = ctypes.c_char_p
            lib.npy_error.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.npy_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            _LIB = lib
        return _LIB


class AsyncNpyPool:
    """Submit npy paths, collect decoded arrays; ``workers`` C++ threads
    decode concurrently with Python and the card."""

    def __init__(self, workers=4):
        self._lib = load_library()
        self._pool = self._lib.npy_pool_create(workers)

    @property
    def native(self):
        return self._pool is not None

    def submit(self, path):
        return self._lib.npy_submit(self._pool, str(path).encode())

    def get(self, ticket):
        data = ctypes.c_void_p()
        shape = (ctypes.c_int64 * 4)()
        ndim = ctypes.c_int32()
        dtype = ctypes.c_int32()
        status = self._lib.npy_wait(self._pool, ticket, ctypes.byref(data), shape,
                                    ctypes.byref(ndim), ctypes.byref(dtype))
        if status != 1:
            msg = self._lib.npy_error(self._pool, ticket).decode()
            self._lib.npy_release(self._pool, ticket)
            raise IOError(msg)
        shp = tuple(shape[i] for i in range(ndim.value))
        dt = np.dtype(_DTYPES[dtype.value])
        n = int(np.prod(shp))
        if n == 0:
            arr = np.zeros(shp, dt)
        else:
            buf = ctypes.cast(data, ctypes.POINTER(ctypes.c_char * (n * dt.itemsize)))
            arr = np.frombuffer(buf.contents, dtype=dt).reshape(shp).copy()
        self._lib.npy_release(self._pool, ticket)
        return arr

    def load(self, path):
        return self.get(self.submit(path))

    def load_many(self, paths):
        tickets = [self.submit(p) for p in paths]
        return [self.get(t) for t in tickets]

    def __del__(self):
        if getattr(self, "_pool", None):
            self._lib.npy_pool_destroy(self._pool)
            self._pool = None


class PrefetchIterator:
    """Any iterable behind a background thread and a queue of ``depth``
    items."""

    def __init__(self, iterable, depth=2):
        self.iterable = iterable
        self.depth = depth

    def __len__(self):
        return len(self.iterable)

    def __iter__(self):
        q = queue.Queue(maxsize=self.depth)
        sentinel = object()

        def worker():
            try:
                for item in self.iterable:
                    q.put(item)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
