"""Where the port's time goes on the card.

1. The bench scene (100 frames x 90k points, bench.py's stage configs)
   through the PyTorch/CUDA port twice; the second pass is timed with
   synchronizing wall-clock timers around the pipeline's phases (stages,
   the tracking walk, its ICP levels and velocity smoothing, the trace
   re-extraction) and each CUDA kernel's launch count.
2. torch.profiler over one pass of the golden scene (12 frames x 20k
   points): device time by kernel, and the device's busy share of the
   pass's wall time.
3. The three kernels over a whole bench pass: the first (untimed) pass
   keeps a device copy of the inputs of every ``pair_min`` call, every CC
   chunk and every ``scan_prep`` call (its arguments and its result);
   these are then replayed back to back, under torch.profiler for the
   kernels' summed device time (the pass's real shapes and mask densities,
   free of the walk's host gaps), and, for ``pair_min``, between two CUDA
   events for the wrapper calls' time. ``radius_scan`` is replayed at the
   claims' k = 1; its prep is replayed too: ``scan_prep`` over the pass,
   and ``scan_prep`` alone and followed by ``radius_scan`` at the pass's
   largest window, each with the device time of everything it runs and
   its wall time between synchronizes. The replay goes through the same
   entry points on any tree of the port (a tree whose ``radius_scan``
   takes no block plan is called without one), so two trees compare in one
   chip call.

Usage (needs one NVIDIA GPU):
    python tools/profile_port_bench.py [--frames 100] [--points 90000]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _timed(table, key, fn, sync):
    def wrapper(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        table[key] += time.perf_counter() - t0
        return out

    return wrapper


def _copy(x):
    if hasattr(x, "clone"):
        return x.contiguous().clone()
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return x


def _record(obj, name, store, of="args"):
    """Make ``obj.name`` append a copy of each call's arguments, its result
    (``of="result"``) or both (``of="call"``: (args, kwargs, result)) to
    ``store``; returns the original."""
    orig = getattr(obj, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        if of == "result":
            store.append(_copy(out))
        else:
            a = tuple(_copy(x) for x in args)
            store.append(a if of == "args" else (a, _copy(kwargs), _copy(out)))
        return out

    setattr(obj, name, wrapper)
    return orig


def _device_ms(fn, symbol, launches):
    """torch.profiler's summed self device time (ms) of the kernels whose
    name holds ``symbol`` over one call of ``fn``, which launches them
    ``launches`` times (a session now and then records none: retried)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and symbol in e.key]
        if sum(e.count for e in evs) == launches:
            return sum(e.self_device_time_total for e in evs) / 1e3
    raise RuntimeError(f"profiler did not see the {launches} launches of {symbol}")


def _whole_ms(fns):
    """(device ms, wall ms, top) summed over the calls ``fns``:
    torch.profiler's self device time of everything they run on the card
    (kernels, copies, fills), the host wall time with a synchronize on each
    side of each call, and the six largest device entries as [name,
    launches, ms]. A profiling session that records nothing is retried."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for f in fns:  # warm
        f()
    wall = 0.0
    for f in fns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for f in fns:
                f()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"),
                     key=lambda e: -e.self_device_time_total)
        dev = sum(e.self_device_time_total for e in evs)
        if dev > 0:
            return dev / 1e3, wall * 1e3, [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                                           for e in evs[:6]]
    raise RuntimeError("profiler recorded no device time")


def main():
    import torch

    from pcseqlearning_tpu_torch import pipeline
    from pcseqlearning_tpu_torch.ops import pair_min as pm
    from pcseqlearning_tpu_torch.ops import sorted_grid as sg
    from pcseqlearning_tpu_torch.preprocessing import cluster_tracking as ct
    from pcseqlearning_tpu_torch.preprocessing import tracking_batched as tb
    from pcseqlearning_tpu_torch.scene import scene_dict

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--points", type=int, default=90_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip()
    print(f"# gpu: {gpu}", flush=True)
    sync = torch.cuda.synchronize
    stages = pipeline.build_stages(pipeline.BENCH, device="cuda")
    # warm-up, recording the kernels' inputs for section 3
    pm_calls, cc_chunks, scans = [], [], []
    saved = [(tb, "_pair_min", _record(tb, "_pair_min", pm_calls)),
             (sg, "cc_prep", _record(sg, "cc_prep", cc_chunks, of="result")),
             (sg, "scan_prep", _record(sg, "scan_prep", scans, of="call"))]
    pipeline.run(scene_dict(args.frames, args.points), stages, sync=sync)
    for obj, name, fn in saved:
        setattr(obj, name, fn)

    # ---- 3. the three kernels over the recorded pass, back to back
    def replay_pair_min():
        for c in pm_calls:
            pm.pair_min(*c)

    def replay_cc():
        for st in cc_chunks:
            sg.cc_rounds(st)

    def scan(st):
        plan = (st["plan"],) if "plan" in st else ()  # a tree without the block plan
        sg.radius_scan(st["table"], st["q_xyz"], st["bounds"], st["r2"], 1, *plan)

    def replay_scan():
        for _, _, st in scans:
            scan(st)

    replay = {}
    for name, fn, wrapper, symbol in (("pair_min", replay_pair_min, pm.pair_min,
                                       "pair_min_kernel"),
                                      ("cc_round", replay_cc, sg.cc_round, "cc_round_kernel"),
                                      ("radius_scan", replay_scan, sg.radius_scan,
                                       "radius_scan_kernel")):
        n0 = wrapper.launches
        fn()  # warm, and counts the launches
        n = wrapper.launches - n0
        replay[name] = {"launches": n, "device_ms": _device_ms(fn, symbol, n)}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    replay_pair_min()
    end.record()
    sync()
    shapes = defaultdict(int)
    for a, b, *_ in pm_calls:
        shapes[str((a.shape[0], a.shape[1], b.shape[1]))] += 1
    replay["pair_min"].update(
        call_ms=start.elapsed_time(end), shapes=dict(shapes),
        valid_a=float(sum(int(c[2].sum()) for c in pm_calls)
                      / sum(c[2].numel() for c in pm_calls)),
        valid_b=float(sum(int(c[3].sum()) for c in pm_calls)
                      / sum(c[3].numel() for c in pm_calls)))

    def pairs(st):
        return int((st["bounds"][3:].long() - st["bounds"][:3].long()).clamp(min=0).sum())

    def prep(a, kw):
        return lambda: sg.scan_prep(*a, **kw)

    def prep_and_scan(a, kw):
        return lambda: scan(sg.scan_prep(*a, **kw))

    a, kw, st = max(scans, key=lambda c: pairs(c[2]))
    prep_dev, prep_wall, _ = _whole_ms([prep(*c[:2]) for c in scans])
    w_prep_dev, w_prep_wall, w_prep_top = _whole_ms([prep(a, kw)])
    w_dev, w_wall, _ = _whole_ms([prep_and_scan(a, kw)])
    replay["radius_scan"].update(
        prep_device_ms=prep_dev, prep_wall_ms=prep_wall,
        run_pairs=sum(pairs(c[2]) for c in scans),
        queries=sum(c[2]["q_xyz"].shape[0] for c in scans),
        window={"queries": st["q_xyz"].shape[0], "refs": st["table"].shape[0],
                "run_pairs": pairs(st), "prep_device_ms": w_prep_dev, "prep_wall_ms": w_prep_wall,
                "prep_scan_device_ms": w_dev, "prep_scan_wall_ms": w_wall,
                "prep_top_device": w_prep_top})
    for r in replay.values():
        r["mean_device_ms"] = r["device_ms"] / r["launches"]
    print(json.dumps({"replay_of_a_bench_pass": replay}), flush=True)
    del pm_calls, cc_chunks, scans, a, kw, st

    # ---- 1. phase breakdown of the bench pass
    phases = defaultdict(float)
    patches = [(tb, "_icp_level"), (tb, "_smooth_velos"), (tb, "walk_direction"),
               (ct.ClusterTracking, "extract_traces_and_update_boxes"),
               (ct.ClusterTracking, "track_frame_batched_dispatch")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patches]
    for obj, name, fn in saved:
        setattr(obj, name, _timed(phases, name, fn, sync))
    for fn in (pm.pair_min, sg.cc_round, sg.radius_scan):
        fn.launches = 0
    d, times = pipeline.run(scene_dict(args.frames, args.points, seed=0), stages, sync=sync)
    for obj, name, fn in saved:
        setattr(obj, name, fn)
    total = sum(times.values())
    print(json.dumps({
        "scene": [args.frames, args.points], "stage_s": times, "total_s": total,
        "frames_per_hour": args.frames / total * 3600, "phase_s": dict(phases),
        "launches": {"pair_min": pm.pair_min.launches, "cc_round": sg.cc_round.launches,
                     "radius_scan": sg.radius_scan.launches},
        "box_miou": pipeline.box_miou(d)}), flush=True)

    # ---- 2. device time by kernel over one golden-scene pass
    from torch.profiler import ProfilerActivity, profile

    gstages = pipeline.build_stages(pipeline.PARITY, device="cuda")
    pipeline.run(scene_dict(12, 20_000), gstages, sync=sync)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.run(scene_dict(12, 20_000), gstages, sync=sync)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: -e.self_device_time_total)
    print(json.dumps({
        "golden_wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                        for e in rows[:15]]}), flush=True)


if __name__ == "__main__":
    main()
