"""Mode ``closed_loop_train``: training as ``train_one_epoch`` runs it, one
step after another on the pool's batches, kept on the device.

Set-up counts each batch's work (``flops``), builds the program's train
state and step (``training.Program``) and drives it through its first
steps, whose readings are kept for the check. The window goes on with the
same state and step, cycling the pool; each step's losses are read to the
host. End-to-end: ``train_samples_per_s``, the samples trained in the
window over the window's whole time. The traced window's record, which the
per-layer readers read: ``steps``, ``window_s``, ``batch``,
``flops_per_s`` and ``plain_step_s`` (of the steps run with nothing on),
``bev_flops_per_step``, ``bev_bytes_per_step``, ``spans_ms`` (ms a step by
layer) and ``spans_step_s``, ``busy_s`` and ``profiled_s`` (of the steps
profiled with CUDA activity only), ``plain_profiled_s`` (what the same pool
batches took with nothing on), ``breakdown``, ``peak_flops`` and
``peak_bytes_per_s``. The check runs the reference over the same first
steps once the program's state is freed.
"""

from __future__ import annotations

import time

from port_bench import flops, harness, peaks, training
from port_bench import trace as trace_mod
from port_bench.spans import LayerSpans

PROFILED_STEPS = 2


class Session:
    def __init__(self, cell, pool, seed, device, fault, log):
        self.cell, self.pool, self.device, self.log = cell, pool, device, log
        self.works = [flops.step_work(cell.config, pool["points"][i], pool["valid"][i])
                      for i in range(pool["points"].shape[0])]
        self.prog = training.Program(cell, seed, device, fault=fault)
        self.weights = self.prog.weights
        self.readings = self.prog.first_steps(pool)
        self.step_i = training.CHECK_STEPS
        self.batch = int(cell.traffic["batch"])

    def one_step(self):
        self.prog.run_step(training.batch_of(self.pool, self.step_i))
        self.step_i += 1


def setup(cell, pool, seed, device, fault=None, log=None):
    """The session; ``fault``: one of ``training.FAULTS``, planted in the
    program's step."""
    s = Session(cell, pool, seed, device, fault, log)
    cap = int(cell.config["MODEL"]["VOXEL_CAP"])
    harness.note(log, "pool", returns_per_frame=pool["returns"],
                 voxels_per_sample=[w["voxels_per_sample"] for w in s.works],
                 cap=cap, cap_fill=[w["voxels_kept"] / cap for w in s.works],
                 flops_per_step=[w["flops"] for w in s.works])
    return s


def _timed_steps(s, seconds, until=None):
    """Steps for ``seconds`` (at least ``until`` of them): their count, the
    time they took, and each one's seconds."""
    each, start = [], time.perf_counter()
    t = start
    while time.perf_counter() - start < seconds or len(each) < (until or 0):
        s.one_step()
        now = time.perf_counter()
        each.append(now - t)
        t = now
    return len(each), t - start, each


def window(s, seconds):
    with harness.GcClock() as gc_clock:
        n, window_s, each = _timed_steps(s, seconds)
    harness.note(s.log, "window", steps=n, window_s=window_s, **harness.spread_of(each),
                 **gc_clock.summary())
    return {"train_samples_per_s": n * s.batch / window_s}


def traced_window(s, seconds):
    """Steps with nothing on for the window's first third, at least one pass
    over the pool (their rate is ``flops_per_s``; each pool batch's mean
    seconds is ``plain_s_by_batch``), then the layer spans until two thirds,
    then torch.profiler over a few steps with CUDA activity only (the
    device's busy time and its kernels), then over a few with host activity
    too (the idle gaps by what the host was doing). The profiler comes last,
    so that nothing it leaves behind slows the other steps; the traces are
    read once the window has closed."""
    start = time.perf_counter()
    pool_n = len(s.works)
    i0 = s.step_i
    n, plain_s, each = _timed_steps(s, seconds / 3, until=pool_n)
    plain_flops = sum(s.works[i % pool_n]["flops"] for i in range(i0, i0 + n))
    by_batch = {}
    for i, t in zip(range(i0, i0 + n), each):
        by_batch.setdefault(i % pool_n, []).append(t)
    plain_by_batch = {j: sum(v) / len(v) for j, v in by_batch.items()}

    layers = {}
    for _, _, reader in s.cell.per_layer:
        for attr in getattr(reader, "MODULES", ()):
            layers[attr] = reader.LAYER
    spans = LayerSpans(s.prog.state.model, layers, s.prog.state.optimizer)
    try:
        n_spans, t = 0, time.perf_counter()
        while n_spans < 2 or time.perf_counter() - start < 2 * seconds / 3:
            spans.begin_step()
            s.one_step()
            spans.end_step()
            n_spans += 1
        spans_step_s = (time.perf_counter() - t) / n_spans
        spans_ms = spans.read()
    finally:
        spans.close()

    j0 = s.step_i
    prof_dev, profiled_s = trace_mod.profile(s.one_step, PROFILED_STEPS, host=False)
    prof_host, _ = trace_mod.profile(s.one_step, PROFILED_STEPS, host=True)
    window_s = time.perf_counter() - start
    busy, breakdown = trace_mod.read(prof_dev, prof_host)
    rec = dict(steps=s.step_i - i0, window_s=window_s, batch=s.batch,
               flops_per_s=plain_flops / plain_s, plain_step_s=plain_s / n,
               plain_profiled_s=sum(plain_by_batch[i % pool_n]
                                    for i in range(j0, j0 + PROFILED_STEPS)),
               bev_flops_per_step=sum(w["bev_flops"] for w in s.works) / pool_n,
               bev_bytes_per_step=sum(w["bev_bytes"] for w in s.works) / pool_n,
               spans_ms=spans_ms, spans_step_s=spans_step_s, busy_s=busy,
               profiled_s=profiled_s, breakdown=breakdown,
               peak_flops=peaks.FLOAT32_FLOPS, peak_bytes_per_s=peaks.HBM_BYTES_PER_S)
    harness.note(s.log, "traced", **{k: v for k, v in rec.items() if k != "breakdown"})
    return rec


def check(s, names):
    """Frees the program's state, runs the reference over the first steps
    and compares."""
    attempted, failed = s.step_i, s.prog.nonfinite
    s.prog = None
    harness.free()
    ref = training.reference_readings(s.cell, s.weights, s.pool, s.device)
    numbers = training.compare(s.readings.summary(), ref, names=names)
    return dict(numbers=numbers, attempted=attempted, failed=failed)

