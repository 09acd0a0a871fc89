"""Where a CenterPoint train step spends its time on the card, at
bench_detector's cell (``chip_smoke.py`` phase 7(b): 2 x 160,000 points,
a 120,000-voxel cap, the +-74.88 m Waymo grid, Adam 1e-3, TF32 off).

    python -m pcseqlearning_tpu_torch.tools.profile_detector_step

Once with cuDNN's heuristic algorithm choice (torch's default) and once
with ``torch.backends.cudnn.benchmark``, after two warm-up steps, it prints
(1) one step by the program's own spans (``utils.profiler``: each span's
calls, device ms from its CUDA events, self ms, host ms and parent: the
train step's forward, backward and optimizer, the detector's modules, the
sparse convolutions' rulebooks and gather-GEMMs), with the step's peak
memory; (2) torch.profiler over one step: the kernels' summed device time against
the step's wall time, and the top operators by device time and by host
time; then (3) each 2D convolution of the forward alone at its shapes,
with cuDNN's heuristic choice, with cudnn.benchmark and on channels_last
tensors. Needs a card.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path


def main():
    import torch

    from ..config import cfg_from_yaml_file
    from ..device import resolve_device
    from ..models import build_network
    from ..scene import DETECTOR_CFG, bench_detector_batch
    from ..utils.edict import EDict

    repo = Path(__file__).resolve().parents[2]
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"# gpu: {gpu}; torch {torch.__version__}", flush=True)
    cfg = cfg_from_yaml_file(str(repo / DETECTOR_CFG), EDict())
    runtime = dict(data_cfg={"POINT_CLOUD_RANGE": [-74.88, -74.88, -2.0, 74.88, 74.88, 4.0],
                             "VOXEL_SIZE": [0.1, 0.1, 0.15]},
                   class_names=list(cfg.CLASS_NAMES), voxel_cap=120_000)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in bench_detector_batch(2, 160_000, 70.0).items()}
    for arm in ("heuristic", "benchmark"):
        torch.backends.cudnn.benchmark = arm == "benchmark"
        print(f"## cuDNN algorithms: {arm}", flush=True)
        profile_step(build_network(cfg.MODEL, runtime, device=dev), batch, dev)
    torch.backends.cudnn.benchmark = False
    conv_times(build_network(cfg.MODEL, runtime, device=dev), batch)


def conv_times(model, batch):
    """(3) Each 2D convolution of the step's forward alone, at the shapes the
    step gives it: milliseconds a call (CUDA events, 5 calls after 2) with
    cuDNN's heuristic choice on NCHW tensors, with cudnn.benchmark, on
    channels_last tensors, with cuDNN off (PyTorch's own convolution) and
    with TF32 allowed; and its FLOPs."""
    import torch

    from ..parallel.train_step import _flatten_local

    convs = [(n, m) for n, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    inputs = {}

    def keep(name):
        def hook(module, args, out):
            inputs.setdefault(name, (args[0], out.shape))
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in convs]
    model.train()
    with torch.no_grad():
        model(_flatten_local(**batch))
    for h in hooks:
        h.remove()

    def ms(fn):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5

    rows = []
    with torch.no_grad():
        for name, m in convs:
            x, out_shape = inputs[name]
            k = m.weight.shape
            flops = 2 * out_shape.numel() * (k[1] if isinstance(m, torch.nn.Conv2d) else k[0]) \
                * k[2] * k[3] / (1 if isinstance(m, torch.nn.Conv2d) else 4)
            torch.backends.cudnn.benchmark = False
            t_heur = ms(lambda: m(x))
            torch.backends.cudnn.benchmark = True
            t_bench = ms(lambda: m(x))
            torch.backends.cudnn.benchmark = False
            with torch.backends.cudnn.flags(enabled=False):
                t_native = ms(lambda: m(x))
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                t_tf32 = ms(lambda: m(x))
            mc, xc = m.to(memory_format=torch.channels_last), x.to(memory_format=torch.channels_last)
            t_cl = ms(lambda: mc(xc))
            m.to(memory_format=torch.contiguous_format)
            rows.append(dict(conv=name, input=list(x.shape), weight=list(k), flops=flops,
                             ms_heuristic=t_heur, ms_benchmark=t_bench, ms_channels_last=t_cl,
                             ms_cudnn_off=t_native, ms_tf32=t_tf32))
    for r in rows:
        print(f"# conv {json.dumps(r)}", flush=True)
    sums = {k: sum(r[k] for r in rows) for k in rows[0] if k.startswith("ms_")}
    print(f"# convs summed: {json.dumps(sums)}; FLOPs {sum(r['flops'] for r in rows):.4e}",
          flush=True)


def profile_step(model, batch, dev):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.train_step import init_train_state, make_train_step
    from ..utils import profiler

    state = init_train_state(model, device=dev)
    step = make_train_step(loss_key="center_loss", device=dev)
    for _ in range(2):
        state, losses = step(state, batch)
    torch.cuda.synchronize()

    # (1) the step by the program's spans
    torch.cuda.reset_peak_memory_stats()
    profiler.enable(True)
    try:
        state, losses = step(state, batch)
    finally:
        profiler.enable(False)
    for name, row in profiler.read(reset=True).items():
        print(f"# span {name} {json.dumps(row)}", flush=True)
    print(f"# peak memory of the step (GB): {torch.cuda.max_memory_allocated() / 1e9:.3f}",
          flush=True)

    # (2) torch.profiler over one whole step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, losses = step(state, batch)
        float(losses["center_loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    print(f"# profiled step: wall {wall:.4f} s, {len(kernels)} kernels, their device time "
          f"{busy:.4f} s ({100 * busy / wall:.1f}% of the wall)", flush=True)
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=60))

if __name__ == "__main__":
    main()
