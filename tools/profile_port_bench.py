"""Where the port's time goes on the card.

1. The bench scene (100 frames x 90k points, bench.py's stage configs)
   through the PyTorch/CUDA port twice; the second pass is timed with
   synchronizing wall-clock timers around the pipeline's phases (stages,
   the tracking walk, its ICP levels and velocity smoothing, the trace
   re-extraction) and each CUDA kernel's launch count.
2. torch.profiler over one pass of the golden scene (12 frames x 20k
   points): device time by kernel, and the device's busy share of the
   pass's wall time.

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
    pipeline.run(scene_dict(args.frames, args.points), stages, sync=sync)  # warm-up

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
