#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   compile the three CUDA kernels from pcseqlearning_tpu_torch/csrc
             (one nvcc per source, all started together)
  2. golden  the parity harness's scene (12 frames x 20k points) through the
             port; each stat must lie within its GOLDEN tolerance of GOLDEN
             or of the JAX package's Pallas-path reference
             (pcseqlearning_tpu_torch.pipeline.PALLAS_PATH_REFERENCE)
  3. bench   bench.py's scene at full width (100 frames x 90k points) with
             bench.py's three stage configs: stage times, frames/hr, peak
             memory, box mIoU (all >= 0.50), and every kernel's launch count
             over this pass (> 0)
  4. kernels every kernel against its plain PyTorch version on the card, at
             the shapes the bench pass gave it (inputs recorded during the
             pass), plus the issue's fixed pair_min case (C=2048, P=256,
             Q=512, masks, 1 km offset) and a full CC of a golden chunk;
             times of kernel, plain version and library yardstick, and the
             bound from the H100 data sheet
The last two lines are the kernel table as JSON and the contract's
{"ok": true, "device": ...} line. Needs no network and imports no JAX.

    python3 chip_smoke.py --cpu-rehearsal

runs the same phases on the CPU at a tiny size through the kernels' plain
versions (no build, no bounds checked, no result line) to check the script
itself without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense, no sparsity), at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# tests/test_golden_parity.py GOLDEN (value, tolerance), pinned on the JAX
# CPU path whose proposal runs kNN-graph CC
GOLDEN = {
    "ground_coverage": (1.0, 0.005),
    "foreground_precision": (1.0, 0.005),
    "proposal_miou": (0.8814, 0.01),
    "trace_miou": (0.9357, 0.01),
    "num_components": (1742, 20),
    "tracking_coverage_0.7": (0.7639, 0.02),
    "box_miou": (0.6875, 0.01),
    "moving_box_miou": (0.7683, 0.01),
}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _copy(x):
    if hasattr(x, "clone"):
        return x.contiguous().clone()
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return x


class Recorder:
    """Wrap a function where its caller looks it up and keep a copy of the
    arguments (or the result, ``of="result"``) of its largest call as
    measured by ``size_fn``; the function itself runs untouched. Wrapping
    the kernels' callers rather than the kernel wrappers leaves each
    wrapper's launch count on the wrapper."""

    def __init__(self, module, name, size_fn, of="args"):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.value, self.kwargs, self.size = None, None, -1

        def wrapper(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            s = size_fn(out) if of == "result" else size_fn(*args)
            if s > self.size:
                self.size, self.kwargs = s, dict(kwargs)
                self.value = _copy(out) if of == "result" else tuple(_copy(a) for a in args)
            return out

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def cuda_time_ms(fn, reps, warmup=2):
    import torch

    if not torch.cuda.is_available():  # rehearsal: host clock, one call
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def pair_min_bound(a, b):
    """10 operations per (p, q) pair (3 sub, 3 mul, 2 add, 2 compares); bytes:
    12 B of xyz and a 1 B mask in, 8 B (d2, index) out, per point."""
    C, P, Q = a.shape[0], a.shape[1], b.shape[1]
    return bound_ms(C * P * Q * 10, C * (P + Q) * (12 + 1 + 8))


def run_pairs(bounds):
    return int((bounds[3:].long() - bounds[:3].long()).clamp(min=0).sum())


def main():
    import torch

    rehearse = "--cpu-rehearsal" in sys.argv[1:]
    if not rehearse and not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    repo = Path(__file__).resolve().parent
    if not (repo / "pcseqlearning_tpu_torch" / "csrc").is_dir():
        fail("pcseqlearning_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, str(repo))
    if rehearse:
        gpu_line, dev = "cpu rehearsal", torch.device("cpu")
        golden_size, bench_size, fixed_c = (6, 2500), (10, 2500), 16

        def sync():
            pass
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        if smi.returncode != 0:
            fail(f"nvidia-smi failed: {smi.stderr.strip()}")
        gpu_line, dev = smi.stdout.strip().splitlines()[0], torch.device("cuda")
        golden_size, bench_size, fixed_c = (12, 20_000), (100, 90_000), 2048
        sync = torch.cuda.synchronize
    log(f"# gpu: {gpu_line}")
    log(f"# torch {torch.__version__}, cuda {torch.version.cuda}")

    from pcseqlearning_tpu_torch import pipeline
    from pcseqlearning_tpu_torch.ops import cuda_build, pair_min as pm_mod, sorted_grid as sg
    from pcseqlearning_tpu_torch.preprocessing import cluster_proposal as cp_mod
    from pcseqlearning_tpu_torch.preprocessing import tracking_batched as tb_mod
    from pcseqlearning_tpu_torch.scene import scene_dict
    from pcseqlearning_tpu_torch.utils import telemetry

    kernels = {"pair_min": pm_mod.pair_min, "cc_round": sg.cc_round,
               "radius_scan": sg.radius_scan}

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = {} if rehearse else cuda_build.build_kernels()
    log(f"# build: {time.perf_counter() - t0:.1f} s ({len(logs)} libraries compiled)")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {src}: {line.strip()}")

    # ---- 2. golden scene ----------------------------------------------------
    t0 = time.perf_counter()
    cc_rec = Recorder(cp_mod, "connected_components_radius",
                      lambda pts, *a: pts.shape[0])
    d, times = pipeline.run(scene_dict(*golden_size, frame_id="parity_seq_000"),
                            pipeline.build_stages(pipeline.PARITY, device=dev), sync=sync)
    cc_rec.restore()
    stats = pipeline.parity_stats(d)
    log(f"# golden: {time.perf_counter() - t0:.1f} s {json.dumps(stats)}")
    for k, (want, tol) in GOLDEN.items():
        if abs(stats[k] - want) > tol:
            log(f"# golden: {k} {stats[k]:.4f} outside GOLDEN {want} +- {tol}; the JAX "
                f"Pallas-path reference is {pipeline.PALLAS_PATH_REFERENCE[k]:.4f}")
    errs = pipeline.golden_errors(stats, GOLDEN)
    if errs and not rehearse:
        fail("golden scene: " + "; ".join(errs))
    golden_chunk = cc_rec.value, cc_rec.kwargs

    # ---- 3. bench scene, the main path --------------------------------------
    t0 = time.perf_counter()
    n_frames = bench_size[0]
    bench_in = scene_dict(*bench_size, frame_id="bench_seq_000")
    log(f"# bench scene: {bench_size[0]} frames x {bench_size[1]} points built in "
        f"{time.perf_counter() - t0:.1f} s")
    stages = pipeline.build_stages(pipeline.BENCH, device=dev)
    recs = {
        "pair_min": Recorder(tb_mod, "_pair_min", lambda a, *r: a.shape[0] * a.shape[1]
                             * r[0].shape[1]),
        "cc_round": Recorder(sg, "cc_prep", lambda st: run_pairs(st["bounds"]), of="result"),
        "radius_scan": Recorder(sg, "scan_prep", lambda st: run_pairs(st["bounds"]),
                                of="result"),
    }
    telemetry.reset()
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, times = pipeline.run(bench_in, stages, sync=sync)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    for r in recs.values():
        r.restore()
    peak_gb = 0.0 if rehearse else torch.cuda.max_memory_allocated() / 1e9
    all_m, mov_m, stat_m = pipeline.box_miou(out)
    log(f"# bench: stages {json.dumps({k: round(v, 3) for k, v in times.items()})} "
        f"total {wall:.3f} s -> {n_frames / wall * 3600:.1f} frames/hr; peak {peak_gb:.2f} GB")
    log(f"# bench: box mIoU all {all_m:.4f} moving {mov_m:.4f} static {stat_m:.4f}; "
        f"telemetry {json.dumps(telemetry.snapshot())}; launches {json.dumps(launches)}")
    if not rehearse and not all_m >= 0.50:
        fail(f"bench scene all-box mIoU {all_m:.4f} < 0.50")
    for name, n in launches.items():
        if n <= 0 and not rehearse:
            fail(f"kernel {name} was not launched on the main path")

    # ---- 4. kernels against their plain versions ----------------------------
    rows = []

    # pair_min: the issue's fixed case, then the bench pass's largest call
    g = torch.Generator(device="cpu").manual_seed(0)
    C, P, Q = fixed_c, 256, 512
    a = (torch.rand((C, P, 3), generator=g) * 8 + 1000.0).to(dev)
    b = (torch.rand((C, Q, 3), generator=g) * 8 + 1000.0).to(dev)
    am = (torch.rand((C, P), generator=g) > 0.2).to(dev)
    bm = (torch.rand((C, Q), generator=g) > 0.2).to(dev)
    am[1] = False
    bm[C - 1] = False
    for label, args in ((f"fixed C={C} P={P} Q={Q} +1km", (a, b, am, bm)),
                        ("bench", recs["pair_min"].value)):
        k_out = pm_mod.pair_min(*args)
        p_out = pm_mod.pair_min_plain(*args)
        bad_idx = sum(int((ko != po).sum()) for ko, po in ((k_out[1], p_out[1]),
                                                            (k_out[3], p_out[3])))
        err = 0.0
        for ko, po in ((k_out[0], p_out[0]), (k_out[2], p_out[2])):
            fin = torch.isfinite(po)
            if not torch.equal(fin, torch.isfinite(ko)):
                fail(f"pair_min ({label}): +inf pattern differs from the plain version")
            rel = ((ko[fin] - po[fin]).abs() / po[fin].abs().clamp(min=1e-30))
            err = max(err, float(rel.max()) if rel.numel() else 0.0)
        log(f"# pair_min ({label}, {tuple(args[0].shape)} x {tuple(args[1].shape)}): "
            f"index mismatches {bad_idx}, max rel d2 err {err:.3g}")
        if bad_idx or err > 1e-6:
            fail(f"pair_min ({label}) disagrees with its plain version")
        log(f"# pair_min ({label}): {cuda_time_ms(lambda: pm_mod.pair_min(*args), 20):.4f} ms, "
            f"bound {pair_min_bound(args[0], args[1])[0]:.4f} ms")
    a, b, am, bm = recs["pair_min"].value
    C, P, Q = a.shape[0], a.shape[1], b.shape[1]
    k_ms = cuda_time_ms(lambda: pm_mod.pair_min(a, b, am, bm), 50)
    p_ms = cuda_time_ms(lambda: pm_mod.pair_min_plain(a, b, am, bm), 5)

    def cdist_min():
        d2 = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist")
        torch.where(bm[:, None, :], d2, float("inf")).min(2)
        torch.where(am[:, :, None], d2, float("inf")).min(1)

    lib_ms = cuda_time_ms(cdist_min, 5)
    bms, by = pair_min_bound(a, b)
    k_out, p_out = pm_mod.pair_min(a, b, am, bm), pm_mod.pair_min_plain(a, b, am, bm)
    abs_err = 0.0
    for ko, po in ((k_out[0], p_out[0]), (k_out[2], p_out[2])):
        fin = torch.isfinite(po)
        if fin.any():
            abs_err = max(abs_err, float((ko[fin] - po[fin]).abs().max()))
    rows.append(dict(
        name="pair_min", route="cuda", source="pcseqlearning_tpu_torch/csrc/pair_min.cu",
        replaces="pcseqlearning_tpu/ops/pallas_tpu.py:55", launches=launches["pair_min"],
        max_abs_err=abs_err,
        ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        shape=[C, P, Q]))

    # cc_round: the bench pass's largest round; then a full CC of a golden chunk
    st = recs["cc_round"].value  # the first round of the chunk with most run pairs
    xyz, bnds, r2 = st["sorted_xyz"], st["bounds"], st["r2"]
    labels = torch.arange(xyz.shape[0], dtype=torch.int32, device=dev)
    k_lab = sg.cc_round(xyz, labels, bnds, r2)
    p_lab = sg.cc_round_plain(xyz, labels, bnds, r2)
    bad = int((k_lab != p_lab).sum())
    log(f"# cc_round (bench, {xyz.shape[0]} slots, {run_pairs(bnds)} run pairs): "
        f"label mismatches {bad}")
    if bad:
        fail("cc_round disagrees with its plain version")
    (pts, valid, radius), grid = golden_chunk
    comp_k, num_k = sg.connected_components_radius(pts, valid, radius, **grid)
    comp_p, num_p = sg.connected_components_radius(
        pts.cpu(), None if valid is None else valid.cpu(), radius, **grid)
    if num_k != num_p or not torch.equal(comp_k.cpu(), comp_p):
        fail(f"full CC of a golden chunk: kernel {num_k} components vs plain {num_p}")
    log(f"# full CC (golden chunk, {pts.shape[0]} points, r={radius}): "
        f"{num_k} components, labels equal")
    m = labels.shape[0]
    pairs = run_pairs(bnds)
    bms, by = bound_ms(pairs * 10, m * (12 + 4 + 24 + 4))
    rows.append(dict(
        name="cc_round", route="cuda", source="pcseqlearning_tpu_torch/csrc/cc_round.cu",
        replaces="pcseqlearning_tpu/ops/pallas_scan.py:600", launches=launches["cc_round"],
        max_abs_err=float((k_lab - p_lab).abs().max()),
        ms=cuda_time_ms(lambda: sg.cc_round(xyz, labels, bnds, r2), 20),
        plain_ms=cuda_time_ms(lambda: sg.cc_round_plain(xyz, labels, bnds, r2), 2),
        bound_ms=bms, bound_by=by, library_ms=None, shape=[m, pairs]))

    # radius_scan: the bench pass's largest tracked-window claim
    st = recs["radius_scan"].value
    table, q, bnds, r2, k = st["table"], st["q_xyz"], st["bounds"], st["r2"], 1
    kd, kp = sg.radius_scan(table, q, bnds, r2, k)
    pd, pp = sg.radius_scan_plain(table, q, bnds, r2, k)
    bad = int((kp != pp).sum())
    fin = torch.isfinite(pd)
    err = float((kd[fin] - pd[fin]).abs().max()) if fin.any() else 0.0
    log(f"# radius_scan (bench window, {q.shape[0]} queries, {table.shape[0]} refs, k={k}): "
        f"index mismatches {bad}, max abs d2 err {err:.3g}")
    if bad or err > 0 or not torch.equal(fin, torch.isfinite(kd)):
        fail("radius_scan disagrees with its plain version")
    pairs = run_pairs(bnds)
    n, m = table.shape[0], q.shape[0]
    bms, by = bound_ms(pairs * 10, n * 12 + m * (12 + 24) + m * k * 8)
    rows.append(dict(
        name="radius_scan", route="cuda", source="pcseqlearning_tpu_torch/csrc/radius_scan.cu",
        replaces="pcseqlearning_tpu/ops/pallas_scan.py:275", launches=launches["radius_scan"],
        max_abs_err=err, ms=cuda_time_ms(lambda: sg.radius_scan(table, q, bnds, r2, k), 20),
        plain_ms=cuda_time_ms(lambda: sg.radius_scan_plain(table, q, bnds, r2, k), 2),
        bound_ms=bms, bound_by=by, library_ms=None, shape=[m, n, pairs]))

    for r in rows:
        log(f"# {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']}) "
            f"launches {r['launches']} shape {r['shape']}")
    log(f"# ledger: {json.dumps(dict(gpu=gpu_line, golden=stats, bench_times=times, bench_wall=wall, bench_frames_per_hour=n_frames / wall * 3600, peak_gb=peak_gb, box_miou=[all_m, mov_m, stat_m]))}")
    if rehearse:
        log("# cpu rehearsal finished: no device result")
        return
    print(gpu_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
