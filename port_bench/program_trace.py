"""The program's own spans and counters over a traced window's steps
(``pcseqlearning_tpu_torch.utils.profiler`` and ``utils.telemetry``),
and the device's idle gaps put down to the program's spans.

- ``phase(one_step, steps)``: the steps with the program's tracing on and
  nothing else, giving the record keys ``program_spans`` (``profiler.read()``
  a step: calls, device ms from the spans' CUDA events with idle time inside
  them included, self ms, host ms, parent), ``program_counters`` (the
  telemetry counters the steps added) and ``program_spans_step_s`` (the
  mean step, against ``plain_step_s`` the tracing's cost).
- ``idle_profile(one_step, steps)``: torch.profiler over the steps with host
  and CUDA activity and the program's tracing on; each idle gap between the
  device's operations goes to the innermost span of ``profiler.SPANS`` that
  covers its middle, or to ``OUTSIDE``: the record key ``idle_by_span``
  (seconds over the steps), whose largest entries (``trace._top``) are the
  breakdown's ``idle_gaps_by_span``.
- ``span_ms`` and ``counter_pct``: what the per-layer readers take from
  those keys.

Each returns nothing for a program without spans of its own. Where the
program traces, its spans' ranges sit in the profiler's trace on the
kernels' clock.
"""

from __future__ import annotations

import bisect
import time

from torch.autograd import DeviceType

from port_bench import trace

OUTSIDE = "(outside the program's spans)"


def _program():
    """The program's profiler and telemetry modules, or None where the
    program has no spans of its own."""
    from pcseqlearning_tpu_torch.utils import profiler, telemetry

    if not hasattr(profiler, "enable") or not hasattr(profiler, "SPANS"):
        return None
    return profiler, telemetry


def phase(one_step, steps):
    """``one_step()`` ``steps`` times with the program's tracing on: the
    record keys ``program_spans``, ``program_counters`` and
    ``program_spans_step_s``; {} where the program has no spans."""
    prog = _program()
    if prog is None:
        return {}
    profiler, telemetry = prog
    profiler.reset()
    telemetry.reset()
    profiler.enable(True)
    try:
        t = time.perf_counter()
        for _ in range(steps):
            one_step()
        step_s = (time.perf_counter() - t) / steps
    finally:
        profiler.enable(False)
    table = profiler.read(reset=True)
    names = list(telemetry.COUNTERS)
    counts = telemetry.snapshot(reset=True)
    per_step = {name: {k: v / steps if k != "parent" and v is not None else v
                       for k, v in row.items()}
                for name, row in table.items()}
    return dict(program_spans=per_step, program_counters={k: counts[k] for k in names},
                program_spans_step_s=step_s)


def idle_by_span(prof, names):
    """The idle gaps between the union of ``prof``'s device operations,
    summed by the latest-starting host range named in ``names`` that covers
    each gap's middle (the innermost span: a backward span on autograd's
    thread starts inside the main thread's ``train_step.backward``), or
    ``OUTSIDE``. Seconds by span name."""
    names = set(names)
    dev, ranges = [], []
    for e in prof.events():
        if e.name in names:  # the span's host range (and its annotation on the device)
            if e.device_type != DeviceType.CUDA:
                ranges.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.time_range.start, e.time_range.end))
    if not dev:
        raise RuntimeError("the profiler's trace holds no device operation")
    ranges.sort(key=lambda r: (r[0], -r[1]))  # of two that start together, the outer first
    starts = [r[0] for r in ranges]
    merged = trace._union(dev)
    gaps = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        name = OUTSIDE
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, t, n = ranges[j]
            if s <= mid <= t:
                name = n
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return gaps


def idle_profile(one_step, steps):
    """``idle_by_span`` of ``steps`` steps profiled with host and CUDA
    activity and the program's tracing on; None where the program has no
    spans."""
    prog = _program()
    if prog is None:
        return None
    profiler, telemetry = prog
    profiler.enable(True)
    try:
        prof, _ = trace.profile(one_step, steps, host=True)
    finally:
        profiler.enable(False)
        profiler.reset()
        telemetry.reset()
    return idle_by_span(prof, profiler.SPANS)


def span_ms(rec, names):
    """Device ms a step summed over the spans ``names`` of
    ``rec["program_spans"]``; None where none of them was seen."""
    rows = [rec.get("program_spans", {}).get(n) for n in names]
    ms = [r["device_ms"] for r in rows if r is not None and r["device_ms"] is not None]
    return sum(ms) if ms else None


def counter_pct(rec, part, whole):
    """100 x counter ``part`` / counter ``whole`` of
    ``rec["program_counters"]``; None where ``whole`` was not counted."""
    c = rec.get("program_counters", {})
    if not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]
