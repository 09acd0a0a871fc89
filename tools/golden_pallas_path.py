"""The golden scene's stats on the JAX package's Pallas path, on the CPU.

The GOLDEN table (tests/test_golden_parity.py) was pinned on the JAX CPU
path: proposal by kNN-graph connected components (K=16, cell cap 24) and
trace re-extraction by per-component point tiles. On the TPU, and in the
PyTorch/CUDA port, proposal runs exact radius-graph CC through the
sorted-grid CC kernel and re-extraction runs the sorted-grid k-NN scan.
This script runs ``tools/parity_harness.run`` (same scene, same configs)
with the JAX package switched to that path: both Pallas kernels run in
interpret mode. ``pair_min`` stays on its TPU default, the XLA composition,
or with ``--pair-min direct`` uses direct differences (what the Pallas
pair_min kernel and the port compute).

Usage:
    python tools/golden_pallas_path.py [--frames 12] [--points 20000]
                                           [--pair-min xla|direct]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def _direct_pair_min(a, b, a_mask, b_mask):
    import jax.numpy as jnp

    d = a[:, :, None, :] - b[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    f = jnp.where(b_mask[:, None, :], d2, jnp.inf)
    w = jnp.where(a_mask[:, :, None], d2, jnp.inf)
    return (f.min(2), f.argmin(2).astype(jnp.int32), w.min(1),
            w.argmin(1).astype(jnp.int32))


def run(num_frames=12, points_per_frame=20_000, pair_min="xla"):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pcseqlearning_tpu.ops import pallas_scan, pallas_tpu

    import parity_harness

    finish = pallas_scan.cc_finish
    pallas_scan.use_pallas_scan = lambda: True
    pallas_scan.cc_finish = lambda *a, **k: finish(*a, interpret=True, **k)
    pallas_scan.radius_neighbors_sorted = functools.partial(
        pallas_scan.radius_neighbors_sorted, interpret=True)
    if pair_min == "direct":
        pallas_tpu.pair_min = _direct_pair_min
    return parity_harness.run(num_frames=num_frames, points_per_frame=points_per_frame)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--points", type=int, default=20_000)
    ap.add_argument("--pair-min", choices=("xla", "direct"), default="xla")
    args = ap.parse_args()
    print(json.dumps(run(args.frames, args.points, args.pair_min)))
