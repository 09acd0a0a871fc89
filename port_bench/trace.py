"""The device's busy time over a few profiled steps, from torch.profiler's
trace (CUPTI): the union of every kernel, copy and set on the card, and the
kernels that took most time, from steps profiled with CUDA activity alone,
so that the host runs as it does unprofiled; the longest idle gaps by the
host operation that ran across them, from steps profiled with host
activity too. The traces stay in memory; nothing is written."""

from __future__ import annotations

import bisect
import time

import torch
from torch.autograd import DeviceType

TOP = 10
NAME_CHARS = 160
SCAN = 64  # host operations looked back over for a gap


def profile(step, steps, host):
    """``step()`` run ``steps`` times under torch.profiler, with CUDA
    activity alone or (``host``) with the host's operations too: the
    profiler and the seconds the steps took."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step()
        seconds = time.perf_counter() - t
    return prof, seconds


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _split(prof):
    dev, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            dev.append((rng, e.name))
        elif e.cpu_parent is None:
            host.append((rng, e.name))
    if not dev:
        raise RuntimeError("the profiler's trace holds no device operation")
    return dev, host


def _top(d):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(dev, host):
    """The idle gaps between the union of ``dev``'s intervals, summed by the
    latest-starting top-level host operation that spans each gap's middle."""
    merged = _union([r for r, _ in dev])
    host = sorted(host)
    starts = [r[0] for r, _ in host]
    gaps = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        name = "(no host operation)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - SCAN, -1), -1):
            (s, t), n = host[j]
            if s <= mid <= t:
                name = n[:NAME_CHARS]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return gaps


def read(prof_dev, prof_host):
    """(busy_s, breakdown): the busy seconds and the top device operations of
    ``prof_dev`` (CUDA activity alone), the idle gaps of ``prof_host``.
    Raises if either trace holds no device operation."""
    dev, _ = _split(prof_dev)
    busy_us = sum(b - a for a, b in _union([r for r, _ in dev]))
    by_op = {}
    for (a, b), name in dev:
        by_op[name[:NAME_CHARS]] = by_op.get(name[:NAME_CHARS], 0.0) + (b - a) * 1e-6
    gaps = idle_gaps(*_split(prof_host))
    return busy_us * 1e-6, {"device_ops": _top(by_op), "idle_gaps": _top(gaps)}
