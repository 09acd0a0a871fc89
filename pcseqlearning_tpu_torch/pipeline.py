"""The extraction pipeline's stage configs and a runner.

``BENCH`` holds the three stage configs of ``bench.py`` (the 100-frame,
90k-points-per-frame benchmark scene); ``PARITY`` those of
``tools/parity_harness.run`` (the 12-frame, 20k-points-per-frame golden
scene). ``parity_stats`` computes the golden table's stats the way the
parity harness does; ``walk_summary`` and ``walk_drift`` the per-walk
record and host-walk comparison of ``tools/walk_parity.py``.
"""

from __future__ import annotations

import time

import numpy as np

from .convert import config_from_jax
from .preprocessing import ClusterProposal, ClusterTracking, GroundPlaneRemover
from .utils.edict import EDict


def _tracking_cfg(track_interval, min_move_frame):
    return EDict(
        ANGLE_REGULARIZER=10,
        COMPONENT_KEYS=["component_rad1x25"],
        REGISTRATION=EDict(
            GRAPH=EDict(TYPE="RadiusGraph", RADIUS=[2.5, 1.25, 1.0], MAX_NUM_NEIGHBORS=1,
                        SORT_BY_DIST=True, RELATIVE_KEY="fxyz"),
            VOXEL_SIZE=[[0.4, 0.4, 0.6], [0.2, 0.2, 0.3], [0.1, 0.1, 0.15]],
            STOPPING_DELTA=[0.05, 0.05, 0.05],
        ),
        NN_GRAPH=EDict(TYPE="RadiusGraph", RADIUS=0.5, MAX_NUM_NEIGHBORS=1,
                       SORT_BY_DIST=True, RELATIVE_KEY="fxyz"),
        TRACKING_PARAMS=EDict(REGISTRATION_ERROR_COEFFICIENT=0.13,
                              TRACK_INTERVAL=track_interval, ANGLE_THRESHOLD=45,
                              MIN_MOVE_FRAME=min_move_frame),
        MAX_ICP_ITER=20,
    )


def _ground_cfg(decay, iters):
    return EDict(PILLAR_SIZE=[2, 2], LR=0.01, DECAY_STEPS=[decay], RIGID_WEIGHT=0.5,
                 MAX_NUM_ITERS=iters, TRUNCATE_HEIGHT=[0.5], RANSAC=True, JointOpt=True,
                 SIGMA2=0.0025, K=8)


def _proposal_cfg(radii, keys):
    return EDict(GRAPH=EDict(TYPE="RadiusGraph", RADIUS=radii, MAX_NUM_NEIGHBORS=32,
                             SORT_BY_DIST=True, RELATIVE_KEY="fxyz"),
                 COMPONENT_KEYS=keys)


BENCH = dict(
    ground=_ground_cfg(1600, 2000),
    proposal=_proposal_cfg([1.25, 0.75], ["component_rad1x25", "component_rad0x75"]),
    tracking=_tracking_cfg(8, 6),
)

PARITY = dict(
    ground=_ground_cfg(400, 500),
    proposal=_proposal_cfg([1.25], ["component_rad1x25"]),
    tracking=_tracking_cfg(4, 3),
)


# The golden scene's stats from the JAX package on the path this port
# implements: proposal by the Pallas radius-graph CC and trace claims by the
# Pallas k-NN scan (both in interpret mode), pair_min by direct differences
# (the Pallas pair_min kernel's arithmetic); printed by
# ``python tools/golden_pallas_path.py --pair-min direct`` on the CPU. The
# GOLDEN table of tests/test_golden_parity.py was pinned with kNN-graph CC
# and the XLA pair_min (|a|^2 + |b|^2 - 2ab), the TPU's default; with the
# XLA pair_min the Pallas path reproduces GOLDEN exactly, with direct
# differences its tracking stats move to these values.
PALLAS_PATH_REFERENCE = {
    "ground_coverage": 1.0,
    "foreground_precision": 1.0,
    "proposal_miou": 0.8814036250114441,
    "trace_miou": 0.9356957077980042,
    "num_components": 1739,
    "tracking_coverage_0.7": 0.7604166666666666,
    "box_miou": 0.6781527996063232,
    "moving_box_miou": 0.7489031553268433,
}


def golden_errors(stats, golden):
    """Stats outside their GOLDEN tolerance of both GOLDEN and
    PALLAS_PATH_REFERENCE, as messages; ``golden`` maps stat -> (value, tol)."""
    errs = []
    for k, (want, tol) in golden.items():
        got = stats[k]
        if abs(got - want) > tol and abs(got - PALLAS_PATH_REFERENCE[k]) > tol:
            errs.append(f"{k}: got {got:.4f}, GOLDEN {want} +- {tol}, "
                        f"Pallas-path reference {PALLAS_PATH_REFERENCE[k]:.4f}")
    return errs


def build_stages(configs, device="cuda"):
    """(GroundPlaneRemover, ClusterProposal, ClusterTracking) for a config
    set, pinned through ``config_from_jax``."""
    return (GroundPlaneRemover(config_from_jax(configs["ground"]), device=device),
            ClusterProposal(config_from_jax(configs["proposal"]), device=device),
            ClusterTracking(config_from_jax(configs["tracking"]), device=device))


def run(seq_dict, stages, sync=None):
    """Run the three stages in order; returns (seq_dict, seconds per stage).
    ``sync`` (e.g. torch.cuda.synchronize) ends each stage's timing."""
    times = {}
    for name, stage in zip(("ground", "proposal", "tracking"), stages):
        t0 = time.perf_counter()
        seq_dict = stage(seq_dict)
        if sync is not None:
            sync()
        times[name] = time.perf_counter() - t0
    return seq_dict, times


def parity_stats(d):
    """The golden table's stats of a finished pipeline dict (as
    tools/parity_harness.run computes them)."""
    full_h = np.asarray(d["full_point_height"]).reshape(-1)
    is_ground = np.asarray(d["full_point_fxyz"])[:, 3] < 0.3
    removed = full_h <= 0.5
    sb = d["seq_boxes"]
    mov = sb.moving.astype(bool)
    return {
        "ground_coverage": float((removed & is_ground).sum() / max(is_ground.sum(), 1)),
        "foreground_precision": float((~removed & ~is_ground).sum() / max((~removed).sum(), 1)),
        "proposal_miou": float(np.asarray(d["gt_box_best_iou"]).mean()),
        "trace_miou": float(np.asarray(d["gt_trace_best_iou"]).mean()),
        "num_components": int(np.asarray(d["point_component_rad1x25"]).max()) + 1,
        "tracking_coverage_0.7": float((sb.best_iou > 0.7).mean()),
        "box_miou": float(sb.best_iou.mean()),
        "moving_box_miou": float(sb.best_iou[mov].mean()) if mov.any() else float("nan"),
    }


def box_miou(d):
    """(all, moving, static) box mIoU of a finished pipeline dict."""
    sb = d["seq_boxes"]
    iou = np.asarray(sb.best_iou)
    mov = np.asarray(sb.moving, bool)
    return (float(iou.mean()), float(iou[mov].mean()) if mov.any() else None,
            float(iou[~mov].mean()) if (~mov).any() else None)


def walk_summary(seq_boxes, wall_s):
    """One walk's record in tools/walk_parity.py's fields."""
    iou = np.asarray(seq_boxes.best_iou)
    mov = np.asarray(seq_boxes.moving, bool)
    return dict(wall_s=wall_s, box_miou=float(iou.mean()),
                coverage_0p7=float((iou > 0.7).mean()),
                moving_miou=float(iou[mov].mean()) if mov.any() else None,
                static_miou=float(iou[~mov].mean()) if (~mov).any() else None)


def walk_drift(iou_host, iou_walk):
    """Per-box best IoU of a walk against the host walk's on the same
    proposals (tools/walk_parity.py's record, its "batched" the walk), and
    the drift bounds of tests/test_walk_parity.py that it breaks: coverage
    within 0.1 below the host's, mean IoU within 0.08, and more than 90% of
    the boxes the host walk nails (IoU > 0.8) found (> 0.3). Returns
    (record, list of messages)."""
    iou_host, iou_walk = np.asarray(iou_host), np.asarray(iou_walk)
    delta = iou_walk - iou_host
    nailed = iou_host > 0.8
    found = float((iou_walk[nailed] > 0.3).mean()) if nailed.any() else None
    rec = dict(iou_delta_mean=float(delta.mean()),
               iou_delta_p10=float(np.percentile(delta, 10)),
               iou_delta_p90=float(np.percentile(delta, 90)),
               host_nailed_batched_found=found,
               batched_only=int(((iou_walk > 0.7) & (iou_host <= 0.7)).sum()),
               host_only=int(((iou_host > 0.7) & (iou_walk <= 0.7)).sum()),
               num_boxes=int(len(iou_host)))
    errs = []
    if (iou_walk > 0.7).mean() < (iou_host > 0.7).mean() - 0.1:
        errs.append("coverage more than 0.1 below the host walk's")
    if iou_walk.mean() < iou_host.mean() - 0.08:
        errs.append(f"mean IoU {iou_walk.mean():.4f} < host {iou_host.mean():.4f} - 0.08")
    if found is not None and found <= 0.9:
        errs.append(f"found {found:.4f} of the boxes the host walk nails (needs > 0.9)")
    return rec, errs
