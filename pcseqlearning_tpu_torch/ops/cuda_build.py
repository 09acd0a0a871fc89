"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
build at first use into ``pcseqlearning_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of their source, so an edited kernel
rebuilds and an unchanged one loads at once. ``build_kernels()`` starts one
``nvcc`` per missing library, all at once, and waits for all of them.

Nothing here runs at import: the CPU tests import every module on machines
that have neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNEL_SOURCES = ("pair_min.cu", "cc_round.cu", "radius_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the CUDA "
                       "kernels of pcseqlearning_tpu_torch build with nvcc")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_kernels(sources=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every library that is missing, one nvcc process per source,
    all started together. Returns {source: compiler output} for the sources
    built by this call; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for source, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs[source] = text
        if proc.returncode != 0:
            failed.append(f"{source} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if missing)."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build_kernels((source,))
            lib = ctypes.CDLL(str(library_path(source)))
            _LIBS[source] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Validate a kernel argument: device, dtype, exact shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
