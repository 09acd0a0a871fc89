"""One run of a cell: set-up, the measured window or the traced window,
and the comparison that decides ``correct``, with the result line's
object.

What runs in the window is the cell's mode: ``modes/<mode>.py``, named by
the traffic file's ``mode`` and found by name (``spec.load_mode``). The
harness makes the pool from the seed with the traffic's generator, hands it
to the mode's ``setup`` (which builds the program and warms up every shape
the window uses), times set-up, runs the mode's ``window`` (the end-to-end
metrics by name) or ``traced_window`` (the record the per-layer readers
read), reads the memory peak, and holds the numbers the mode's ``check``
returns (once the program's state is freed) to the cell's limits.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time

import torch

from . import spec


def set_precision(tf32=False):
    """float32 as the configuration states it: TF32 off; cuDNN's deterministic
    algorithms, as ``train.main`` sets them."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- inputs

def seed_of(seed, stream):
    """A 63-bit seed for ``stream`` (0: the inputs, 1: the weights) of the
    run's ``--seed`` (splitmix64), so that every bit of a large seed counts
    on every generator."""
    mask = (1 << 64) - 1
    z = (int(seed) * 2 + stream + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 1


def make_pool(cell, seed, device):
    gen = spec.load_generator(cell.traffic["generator"], cell.root)
    return gen.make_pool(cell.traffic, cell.config, seed_of(seed, 0), device)


def _fan_in(module, p):
    if isinstance(module, torch.nn.ConvTranspose2d):
        return p.shape[0] * p[0, 0].numel()
    if isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
        return p[0].numel()
    return p.numel() // p.shape[-1]  # the sparse convs' [k, cin, cout]


def make_weights(net, seed, device):
    """The benchmark's initial weights for ``net``'s parameters, by name,
    float32 on ``device``: every weight of two or more dimensions drawn in
    one call from the seed, flax's lecun_normal (a normal truncated at two
    standard deviations, scaled by 1 / sqrt(fan-in)); every one-dimensional
    parameter (batch-norm scales and shifts, biases) at the constant its
    layer starts from."""
    mods = dict(net.named_modules())
    leaves = [(n, p) for n, p in net.named_parameters() if p.dim() >= 2]
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 1))
    z = torch.randn(sum(p.numel() for _, p in leaves), generator=g, device=device)
    z = torch.fmod(z, 2.0) / 0.87962566103423978  # the std of N(0, 1) cut at +-2
    out, off = {}, 0
    for n, p in leaves:
        std = 1.0 / math.sqrt(_fan_in(mods[n.rpartition(".")[0]], p))
        out[n] = (z[off:off + p.numel()] * std).view(p.shape)
        off += p.numel()
    for n, p in net.named_parameters():
        if p.dim() < 2:
            v = p.detach().reshape(-1)
            if not bool((v == v[0]).all()):
                raise ValueError(f"{n} does not start from a constant")
            out[n] = torch.full(p.shape, float(v[0]), device=device)
    return out


def load_weights(net, weights):
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(weights[n])


# ---------------------------------------------------------------- logging

def note(log, kind, **values):
    """A line ``# <kind> {json}`` on ``log`` (standard error), before the
    result."""
    if log is not None:
        print(f"# {kind} " + json.dumps(values), file=log, flush=True)


def spread_of(seconds):
    """Quartiles and extremes of the steps' seconds, and the steps that took
    more than 1.5 times the median, with the seconds they took beyond it."""
    if len(seconds) < 2:
        return {}
    q1, med, q3 = statistics.quantiles(seconds, n=4)
    slow = [t - med for t in seconds if t > 1.5 * med]
    return dict(step_min_s=min(seconds), step_q1_s=q1, step_median_s=med, step_q3_s=q3,
                step_max_s=max(seconds), slow_steps=len(slow), slow_excess_s=sum(slow))


class GcClock:
    """The garbage collector's collections and seconds while it is entered."""

    def __enter__(self):
        self.count, self.seconds, self._t = [0, 0, 0], 0.0, None
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count[info["generation"]] += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self):
        return dict(gc_collections=self.count, gc_s=self.seconds)


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- one run

def run(root, workload, seed, seconds, trace, device="cuda", t0=None, fault=None,
        log=sys.stderr):
    """One run of ``workload``; returns the result line's object. ``fault``
    names a fault for the mode to plant in the timed path."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.load_cell(root, workload)
    mode = spec.load_mode(cell.traffic["mode"], cell.root)
    set_precision(False)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    pool = make_pool(cell, seed, device)
    session = mode.setup(cell, pool, seed, device, fault=fault, log=log)
    sync(device)
    setup_s = time.perf_counter() - t0

    record = {}
    if not trace:
        values = dict(mode.window(session, seconds), setup_s=setup_s)
        metrics = {name: (values[name], unit) for name, unit in cell.end_to_end}
    else:
        record = mode.traced_window(session, seconds)
        metrics = {}
        for name, unit, reader in cell.per_layer:
            v = reader.read(record)
            if v is not None:
                metrics[name] = (v, unit)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    limits = {k: float(v["limit"]) for k, v in cell.limits["numbers"].items()}
    out = mode.check(session, list(limits))
    numbers = out["numbers"]
    correct = out["failed"] == 0 and all(numbers[k] <= limits[k] for k in limits)
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
              "device": _device(cuda, cell.chips, peak, record)}
    if trace:
        result["breakdown"] = record["breakdown"]
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def _device(cuda, chips, peak, record):
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if record:
        dev["busy_s"] = record["busy_s"]
        dev["window_s"] = record["profiled_s"]
    return dev
