"""Stage timers that wait for the card, torch.profiler traces and named
regions (counterpart of pcseqlearning_tpu.utils.profiler, which does the
same over jax.profiler)."""

from __future__ import annotations

import contextlib
import time

import torch


def _cuda_devices(tree, out):
    """The CUDA devices of the tensors in a nest of dicts, lists and tuples."""
    if torch.is_tensor(tree):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


@contextlib.contextmanager
def stage_timer(name, sync_tree=None, verbose=True, stats=None):
    """Wall-clock timer of the block; before it stops, it waits for the work
    queued on the devices of the tensors in ``sync_tree``
    (``torch.cuda.synchronize``). The seconds go to ``stats[name]`` (a list)
    when ``stats`` is given."""
    t0 = time.time()
    yield
    for dev in _cuda_devices(sync_tree, set()):
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    if stats is not None:
        stats.setdefault(name, []).append(dt)
    if verbose:
        print(f"[stage] {name}: {dt:.4f}s")


@contextlib.contextmanager
def device_trace(log_dir, enabled=True):
    """A torch.profiler trace of the block (the host, and the card when one
    is present), written as Chrome JSON to ``<log_dir>/trace.json`` (open it
    in Perfetto or chrome://tracing). Yields the profiler (None when not
    ``enabled``)."""
    if not enabled:
        yield None
        return
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name):
    """A named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
