"""The readings that a training cell's limits are set from, on the chip, at
the cell's own size, in one process:

    python3 -m port_bench.controls --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--frozen-seeds 1,2,3]

For every seed the program's first steps (as a run's set-up drives them)
against the float64 reference: the lower readings. For each control seed
the control in the program's place (the reference in float32 with TF32
on), and for each fault seed the program with half of each batch left out:
the upper readings; for each frozen seed the program with a step that
returns its state unchanged. Prints one JSON line a seed (with the worst
leaves and each top-level module's numbers of the sound run and of the
control), then the largest sound reading and the smallest control and fault
readings of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import harness, spec, training


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _first_steps(cell, seed, device, pool, fault=None):
    prog = training.Program(cell, seed, device, fault=fault)
    r = prog.first_steps(pool)
    weights = prog.weights
    del prog
    harness.free()
    return r.summary(), weights


def _faulty(cell, seed, device, pool, fault, ref, names):
    return training.compare(_first_steps(cell, seed, device, pool, fault)[0], ref, names=names)


def readings(cell, seed, device, control=False, fault=False, frozen=False):
    """{kind: numbers} for one seed: every number ``compare`` gives, and the
    ``loss1.<loss>`` numbers the cell's limits name."""
    names = list(cell.limits["numbers"])
    harness.set_precision(False)
    pool = harness.make_pool(cell, seed, device)
    out, times = {}, {}
    t = time.perf_counter()
    sound, weights = _first_steps(cell, seed, device, pool)
    times["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ref = training.reference_readings(cell, weights, pool, device)
    harness.sync(device)
    times["reference_s"] = time.perf_counter() - t
    out["sound"] = training.compare(sound, ref, detail=True, names=names)
    if control:
        ctl = training.control_readings(cell, weights, pool, device)
        out["control"] = training.compare(ctl, ref, detail=True, names=names)
    if fault:
        out["half_batch"] = _faulty(cell, seed, device, pool, "half_batch", ref, names)
    if frozen:
        out["frozen_state"] = _faulty(cell, seed, device, pool, "frozen_state", ref, names)
    return out, times, ref["losses"]


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--frozen-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(Path.cwd(), args.workload)
    ctl, flt = set(_seeds(args.control_seeds)), set(_seeds(args.fault_seeds))
    frz = set(_seeds(args.frozen_seeds))
    seen = {}
    for seed in _seeds(args.seeds):
        res, times, losses = readings(cell, seed, args.device, seed in ctl, seed in flt,
                                      seed in frz)
        print(json.dumps(dict(seed=seed, **res, **times, ref_losses=losses)), flush=True)
        for kind, nums in res.items():
            for k, v in nums.items():
                if k in ("worst", "modules"):
                    continue
                seen.setdefault(kind, {}).setdefault(k, []).append(v)
    summary = {"lower": {k: max(v) for k, v in seen["sound"].items()}}
    for kind in ("control", "half_batch", "frozen_state"):
        if kind in seen:
            summary[kind] = {k: min(v) for k, v in seen[kind].items()}
    print(json.dumps(dict(summary=summary,
                          device=torch.cuda.get_device_name(0) if torch.cuda.is_available()
                          else "cpu")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
