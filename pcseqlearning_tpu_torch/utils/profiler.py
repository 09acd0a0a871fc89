"""The port's own spans, and torch.profiler traces (counterpart of
pcseqlearning_tpu.utils.profiler, which does the same over jax.profiler).

Tracing is off by default. ``span(name)`` then returns one shared no-op
context after a single flag test: no ``record_function``, no CUDA event, no
clock read. With ``enable(True)`` each span records

- a ``torch.profiler.record_function(name)`` range, so that it sits in any
  torch.profiler (CUPTI) trace on the kernels' clock;
- a pair of ``torch.cuda.Event(enable_timing=True)`` on the current stream
  when a card is present (no synchronize: the events are read in
  ``read()``);
- the host's ``perf_counter`` at entry and exit;
- its parent: the innermost span open in the process, on any thread. The
  main thread waits inside ``train_step.backward`` while autograd's device
  thread runs the backward's spans, so those take it as their parent.

Spans are kept in memory until ``read(reset=True)`` or ``reset()``; nothing
is written. ``SPANS`` names every span the port opens.
"""

from __future__ import annotations

import contextlib
import time

import torch

SPANS = (
    # parallel/train_step.py
    "train_step", "train_step.forward", "train_step.backward", "train_step.optimizer",
    # models/detectors.py
    "vfe", "backbone_3d", "map_to_bev", "pfe", "backbone_2d", "dense_head", "dense_head.loss",
    "roi_stage", "roi_stage.proposal",
    # ops/sparse_conv.py, ops/sampling.py
    "sparse_conv.rulebook", "sparse_conv.gemm", "sparse_conv.gemm_bwd", "fps",
    # tools/create_waymo_infos.py
    "create_waymo_infos.decode", "create_waymo_infos.projection", "create_waymo_infos.write",
)

_ON = False
_CUDA = False
_OFF = contextlib.nullcontext()
_OPEN: list = []  # spans entered and not yet left, innermost last
_DONE: list = []  # spans left since the last reset


def enable(on=True):
    """Turn the spans on or off for the whole process; returns the previous
    state. CUDA events are recorded when a card is present."""
    global _ON, _CUDA
    was = _ON
    _ON = bool(on)
    _CUDA = _ON and torch.cuda.is_available()
    return was


def enabled():
    return _ON


def reset():
    """Forget every span left so far."""
    _DONE.clear()


class _Span:
    __slots__ = ("name", "parent", "range", "events", "t0", "t1")

    def __init__(self, name):
        self.name = name
        self.events = None

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.parent = _OPEN[-1] if _OPEN else None
        _OPEN.append(self)
        if _CUDA:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.t1 = time.perf_counter()
        if _OPEN and _OPEN[-1] is self:
            _OPEN.pop()
        else:  # left out of order, by another thread
            _OPEN.remove(self)
        _DONE.append(self)
        self.range.__exit__(*exc)
        return False


def span(name):
    """A named region of the program: a no-op while tracing is off."""
    if not _ON:
        return _OFF
    return _Span(name)


def read(reset=False):
    """Per span name: ``calls``, ``device_ms`` (summed over the calls' CUDA
    event pairs; None without a card), ``self_ms`` (the calls' duration
    minus what their child spans cover, on the device's clock where there
    are events, else the host's), ``host_ms`` (summed ``perf_counter``
    durations) and ``parent`` (the parent span's name, None at the top,
    names '|'-joined where the calls differ). Synchronizes once."""
    done = list(_DONE)
    if reset:
        _DONE.clear()
    if any(s.events is not None for s in done):
        torch.cuda.synchronize()
    dur = {}
    for s in done:
        host = (s.t1 - s.t0) * 1e3
        dev = s.events[0].elapsed_time(s.events[1]) if s.events is not None else None
        dur[id(s)] = (host, dev, dev if dev is not None else host)
    child = {}
    for s in done:
        if s.parent is not None:
            child[id(s.parent)] = child.get(id(s.parent), 0.0) + dur[id(s)][2]
    out = {}
    for s in done:
        host, dev, own = dur[id(s)]
        row = out.setdefault(s.name, {"calls": 0, "device_ms": None, "self_ms": 0.0,
                                      "host_ms": 0.0, "parents": set()})
        row["calls"] += 1
        if dev is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + dev
        row["self_ms"] += own - child.get(id(s), 0.0)
        row["host_ms"] += host
        row["parents"].add(s.parent.name if s.parent is not None else None)
    for row in out.values():
        parents = row.pop("parents")
        names = sorted(p for p in parents if p is not None)
        row["parent"] = "|".join(names) if names else None
    return out


@contextlib.contextmanager
def device_trace(log_dir, enabled=True):
    """A torch.profiler trace of the block (the host, and the card when one
    is present), with the program's spans on, written as Chrome JSON to
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    was = enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        enable(was)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
