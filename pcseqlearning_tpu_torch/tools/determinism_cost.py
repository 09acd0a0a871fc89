"""What reproducibility costs on the card, in one process on one card.

    python -m pcseqlearning_tpu_torch.tools.determinism_cost [--passes 4] [--detector-passes 4]

(1) The extraction path: the bench pass and the README command with
``ops.segment_ops``' sorted segmented sums against the atomic
``index_add_`` they replaced. The arms alternate atomic, sorted, sorted,
atomic (``--passes`` of them; 0 skips the part). Each arm runs
``chip_smoke.py``'s phase 3 (pipeline.BENCH over the bench scene, 100
frames x 90,000 points) and its phase 6(a) (the README's three configs
through ``train.main`` on a 24 x 90,000-point Waymo sequence written once
to a temporary directory, a fresh output directory each time), and prints
a ``# arm`` JSON line: each run's wall seconds (the stages synchronized),
box mIoU, and whether its result equals the previous run of the same arm.

(2) The CenterPoint train step at bench_detector's cell (``chip_smoke.py``
phase 7(b), TF32 off) with cuDNN's default algorithms against
``torch.backends.cudnn.deterministic``. The arms alternate default,
deterministic, deterministic, default (``--detector-passes`` of them).
Each builds the model from seed 0, takes 2 steps, then 4 timed ones
with a host read each, and prints a ``# detector arm`` JSON line: the
median timed step, the first two steps' losses, and against the previous
run of the same arm whether the two steps' losses, gradients and
parameters are equal bit for bit (else the largest gradient difference
over its tensor's max |g| and the tensors that differ). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

README_CFGS = ("tools/cfgs/waymo_models/registration/cluster_tracking_TLS_multiradius_every8.yaml",
               "tools/cfgs/dataset_configs/waymo/registration/all_sequence.yaml",
               "tools/cfgs/optimizers/registration.yaml")


def _atomic_sums(segment_ops):
    """The atomic float sums of the parent code, to patch in."""
    def segment_sum(data, segment_ids, num_segments):
        ok = segment_ops._in_range(segment_ids, num_segments)
        out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
        return out.index_add_(0, segment_ids[ok].long(), data[ok])

    def index_add(base, index, data):
        return base.index_add(0, index, data)

    return {"segment_sum": segment_sum, "index_add": index_add}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m pcseqlearning_tpu_torch.tools.determinism_cost")
    parser.add_argument("--passes", type=int, default=4)
    parser.add_argument("--detector-passes", type=int, default=4)
    args = parser.parse_args(argv)

    import subprocess
    import torch

    from ..device import resolve_device

    dev = resolve_device("cuda")
    repo = Path(__file__).resolve().parents[2]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"# gpu: {gpu}; torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}",
          flush=True)
    if args.passes:
        sums_cost(repo, dev, args.passes)
    if args.detector_passes:
        detector_cost(repo, dev, args.detector_passes)


def sums_cost(repo, dev, passes):
    import numpy as np
    import pickle
    import torch

    from .. import pipeline, train
    from ..ops import cuda_build, segment_ops
    from ..scene import make_scene, scene_dict, write_waymo_sequence

    cuda_build.build_kernels()
    sorted_fns = {k: getattr(segment_ops, k) for k in ("segment_sum", "index_add")}
    atomic_fns = _atomic_sums(segment_ops)
    # warm up the card, the kernels and the libraries on the golden scene
    pipeline.run(scene_dict(12, 20_000, frame_id="parity_seq_000"),
                 pipeline.build_stages(pipeline.PARITY, device=dev), sync=torch.cuda.synchronize)
    last = {}
    with tempfile.TemporaryDirectory(prefix="determinism_cost_") as root:
        write_waymo_sequence(root, *make_scene(num_frames=24, points_per_frame=90_000, seed=0),
                             "entry_seq")
        for i in range(passes):
            arm = "atomic" if i % 4 in (0, 3) else "sorted"
            for k, fn in (atomic_fns if arm == "atomic" else sorted_fns).items():
                setattr(segment_ops, k, fn)
            bench_in = scene_dict(100, 90_000, frame_id="bench_seq_000")  # the stages edit it
            t0 = time.perf_counter()
            out, _ = pipeline.run(bench_in, pipeline.build_stages(pipeline.BENCH, device=dev),
                                  sync=torch.cuda.synchronize)
            bench_s = time.perf_counter() - t0
            bench_miou = pipeline.box_miou(out)
            outdir = Path(root) / f"out{i}"
            argv = [str(repo / c) for c in README_CFGS] + [
                "--device", "cuda", "--set", "DATA_CONFIG.DATA_PATH", root, "ROOT_DIR", root,
                "MODEL.SAVE_DIR", str(outdir / "tracking"),
                "MODEL.PREPROCESSORS.0.DIR", str(outdir / "height"),
                "MODEL.PREPROCESSORS.0.LOG_DIR", str(outdir / "log"),
                "MODEL.PREPROCESSORS.1.DIR", str(outdir / "proposal"),
                "MODEL.PREPROCESSORS.2.DIR", str(outdir / "tracking")]
            t0 = time.perf_counter()
            train.main(argv)
            torch.cuda.synchronize()
            entry_s = time.perf_counter() - t0
            with open(outdir / "tracking" / "entry_seq" / "all.pkl", "rb") as f:
                iou = np.asarray(pickle.load(f)["best_iou"])
            result = (bench_miou, float(iou.mean()), iou.tobytes())
            rec = dict(arm=arm, run=i, bench_pass_s=bench_s, bench_box_miou=bench_miou,
                       entry_main_s=entry_s, entry_box_miou_all=float(iou.mean()),
                       equals_previous_run_of_arm=(result == last[arm]) if arm in last else None)
            last[arm] = result
            print(f"# arm {json.dumps(rec)}", flush=True)
    for k, fn in sorted_fns.items():
        setattr(segment_ops, k, fn)


def detector_cost(repo, dev, passes, steps=4):
    import torch

    from ..config import cfg_from_yaml_file
    from ..models import build_network
    from ..parallel.train_step import init_train_state, make_train_step
    from ..scene import DETECTOR_CFG, bench_detector_batch
    from ..utils.edict import EDict

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_from_yaml_file(str(repo / DETECTOR_CFG), EDict())
    runtime = dict(data_cfg={"POINT_CLOUD_RANGE": [-74.88, -74.88, -2.0, 74.88, 74.88, 4.0],
                             "VOXEL_SIZE": [0.1, 0.1, 0.15]},
                   class_names=list(cfg.CLASS_NAMES), voxel_cap=120_000)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in bench_detector_batch(2, 160_000, 70.0).items()}
    step = make_train_step(loss_key="center_loss", device=dev)
    last = {}
    for i in range(passes):
        arm = "default" if i % 4 in (0, 3) else "deterministic"
        torch.backends.cudnn.deterministic = arm == "deterministic"
        state = init_train_state(build_network(cfg.MODEL, runtime, device=dev), device=dev)
        losses2 = []
        for _ in range(2):
            state, losses = step(state, batch)
            losses2.append({k: float(v) for k, v in losses.items()})
        named = list(state.model.named_parameters())
        grads = {n: p.grad.clone() for n, p in named}
        params = {n: p.detach().clone() for n, p in named}
        durs = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, losses = step(state, batch)
            float(losses["center_loss"])  # a host read each step, as bench.py
            durs.append(time.perf_counter() - t0)
        rec = dict(arm=arm, run=i, step_s=sorted(durs)[len(durs) // 2], steps_s=durs,
                   losses=losses2)
        if arm in last:
            g0, p0, l0 = last[arm]
            diff = [n for n in grads if not torch.equal(grads[n], g0[n])]
            rec.update(
                equals_previous_run_of_arm=l0 == losses2 and not diff and all(
                    torch.equal(params[n], p0[n]) for n in params),
                grads_differing=len(diff), grads_of=len(grads), first_differing=diff[:5],
                grad_err_of_max=max([float((grads[n] - g0[n]).abs().max() / g0[n].abs().max())
                                     for n in diff] or [0.0]))
        last[arm] = (grads, params, losses2)
        print(f"# detector arm {json.dumps(rec)}", flush=True)
        del state
    torch.backends.cudnn.deterministic = False


if __name__ == "__main__":
    main()
