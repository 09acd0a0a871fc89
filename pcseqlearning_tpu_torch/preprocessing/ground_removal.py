"""Ground plane estimation and removal (counterpart of
pcseqlearning_tpu.preprocessing.ground_removal).

  1. grid subsample of the whole sequence (frame-agnostic) at the finest
     dyadic coarsening of 0.10 x 0.10 x 0.03 m whose occupied-cell count
     fits SOLVE_VOX_CAP
  2. 2D pillar stats on a static pillar grid
  3. RANSAC over 30 height ratios at once, each a 50-iteration IRLS plane
     fit per 4x-coarsened pillar; best plane per pillar by inlier count
  4. truncated-least-squares filter of the plane set (kNN curvature, 100
     log-spaced thresholds), then confidence propagation to fine pillars
  5. L1 joint optimization of the pillar height field (AdamW, MultiStep
     decay, early-stop countdown)
  6. per-point height / horizon / error through the voxel inverse map

Everything runs on the entry point's device; the only host reads are loop
conditions (the IRLS and L1 early stops) and the final per-point masks.

With DIR, the stage keeps each sequence's height field in
``DIR/<sequence>/pillar_height.npz`` (keys ``pillar_height`` and
``pillar_min_z``, the JAX module's file): a sequence whose file exists skips
steps 2-5 and reads its heights from the file (a warm start). With LOG_DIR
and segmentation labels, it writes ground precision and coverage per
TRUNCATE_HEIGHT to ``LOG_DIR/height<h>/<sequence>.txt`` in the JAX module's
format (``tools/parse_ground_removal_results.py`` reads both).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops import geometry, grid_utils, sampling, segment_ops
from ..ops.optim import AdamW, abs_grad, multistep_lr
from ..utils.edict import EDict

_BASE_CELL = (0.10, 0.10, 0.03)


# ---------------------------------------------------------------------------
# pillars
# ---------------------------------------------------------------------------


def format_pillars(bxyz, valid, pillar_size, pc_range_min, pillar_dims):
    """Per-pillar stats from voxel centers bxyz [V, 4] (valid [V]).

    Returns (points: pillar_coords, pillar_idx; pillars: density, min_z,
    max_z, xyz, weight); invalid voxels get pillar id X*Y (dropped)."""
    X, Y = pillar_dims
    P = X * Y
    dev = bxyz.device
    ps = torch.tensor(pillar_size, dtype=bxyz.dtype, device=dev)
    coords = torch.floor((bxyz[:, 1:3] - pc_range_min) / ps).to(torch.int64)
    coords = torch.minimum(torch.clamp(coords, min=0),
                           torch.tensor([X - 1, Y - 1], device=dev))
    pidx = coords[:, 0] * Y + coords[:, 1]
    pidx = torch.where(valid, pidx, torch.full_like(pidx, P))
    density = segment_ops.segment_count(pidx, P)
    pillars = EDict(
        density=density,
        min_z=segment_ops.segment_min_or(bxyz[:, 3], pidx, P, 0.0),
        max_z=segment_ops.segment_max_or(bxyz[:, 3], pidx, P, 0.0),
        xyz=segment_ops.segment_mean(bxyz[:, 1:4], pidx, P),
        weight=(density > 0.5).to(bxyz.dtype),
    )
    return EDict(pillar_coords=coords, pillar_idx=pidx), pillars


# ---------------------------------------------------------------------------
# RANSAC over 30 height ratios (all ratios at once)
# ---------------------------------------------------------------------------


def _ransac_all_ratios(vox_xyz, vox_valid, z, new_pidx, n_min_z, n_max_z, NP, sigma2,
                       num_ratios=30):
    """The 30 independent IRLS plane fits per coarse pillar, run as one
    batch (one 50-iteration loop at 30x width). Per-pillar moments are taken
    in a per-pillar local frame so cov = E[xx^T] - cc^T does not cancel.
    Returns (best_conf [NP], best_normal [NP, 3], best_center [NP, 3])."""
    R = num_ratios
    n = vox_xyz.shape[0]
    dev = vox_xyz.device
    f32 = z.dtype
    ratios = 0.3 + 0.7 * torch.arange(R, dtype=f32, device=dev) / (R - 1.0)
    pid = torch.clamp(new_pidx, 0, NP - 1)
    acc_id = torch.where(vox_valid, pid, torch.full_like(pid, NP))
    cur_z = n_min_z[None, :] * ratios[:, None] + n_max_z[None, :] * (1.0 - ratios[:, None])
    z_diff = cur_z[:, pid] - z[None, :]
    w0 = sigma2 / (z_diff * z_diff + sigma2)
    zero = torch.zeros((), dtype=f32, device=dev)
    w0 = torch.where(vox_valid[None, :], w0, zero)

    def pillar_accum(M):
        """[K, N] -> [K, NP]: column sums of M per pillar (valid voxels)."""
        return segment_ops.segment_sum(M.t(), acc_id, NP).t()

    cnt = torch.clamp(pillar_accum(vox_valid.to(f32)[None, :])[0], min=1.0)
    pctr = pillar_accum(torch.where(vox_valid[None, :], vox_xyz.t(), zero)) / cnt[None, :]
    xl = vox_xyz - pctr.t()[pid]
    xlT = xl.t()
    x6 = torch.stack([xlT[0] * xlT[0], xlT[0] * xlT[1], xlT[0] * xlT[2],
                      xlT[1] * xlT[1], xlT[1] * xlT[2], xlT[2] * xlT[2]])
    xl_sq = (xl * xl).sum(-1)

    def step(w):
        V = torch.cat([w[:, None, :], w[:, None, :] * xlT[None], w[:, None, :] * x6[None]],
                      dim=1).reshape(R * 10, n)
        S = pillar_accum(V).reshape(R, 10, NP)
        sw = torch.clamp(S[:, 0], min=1e-6)
        c = S[:, 1:4] / sw[:, None, :]
        m2 = S[:, 4:10] / sw[:, None, :]
        cxx = m2[:, 0] - c[:, 0] * c[:, 0]
        cxy = m2[:, 1] - c[:, 0] * c[:, 1]
        cxz = m2[:, 2] - c[:, 0] * c[:, 2]
        cyy = m2[:, 3] - c[:, 1] * c[:, 1]
        cyz = m2[:, 4] - c[:, 1] * c[:, 2]
        czz = m2[:, 5] - c[:, 2] * c[:, 2]
        cov = torch.stack([torch.stack([cxx, cxy, cxz], -1),
                           torch.stack([cxy, cyy, cyz], -1),
                           torch.stack([cxz, cyz, czz], -1)], -2)  # [R, NP, 3, 3]
        _, eigvecs = geometry.eigh3x3(cov)
        normal = eigvecs[..., 0]
        cT = c.permute(0, 2, 1)  # [R, NP, 3]
        cn = (cT * normal).sum(-1)
        cc2 = (cT * cT).sum(-1)
        n_pp = normal[:, pid]  # [R, N, 3]
        err = ((xl[None] * n_pp).sum(-1) - cn[:, pid]).abs()
        d2 = torch.clamp(xl_sq[None] - 2.0 * (xl[None] * cT[:, pid]).sum(-1) + cc2[:, pid],
                         min=0.0)
        new_w = sigma2 / (err * err + sigma2) * (0.25 / (d2 + 0.25))
        new_w = torch.where(vox_valid[None, :], new_w, zero)
        return new_w, cT + pctr.t()[None], normal, err

    w, it = w0, 0
    while True:
        new_w, center, normal, err = step(w)
        done = bool((new_w - w).abs().max() < 1e-2) if n else True
        w, it = new_w, it + 1
        if done or it >= 50:
            break
    hit = ((err < sigma2 ** 0.5) & vox_valid[None, :]).to(f32)
    num_hit = pillar_accum(hit)  # [R, NP]
    best_r = torch.argmax(num_hit, dim=0)
    ar = torch.arange(NP, device=dev)
    return num_hit[best_r, ar], normal[best_r, ar], center[best_r, ar]


def ransac_min_height(vox_bxyz, vox_valid, points, pillars, pillar_dims, cfg_sigma2, cfg_k,
                      window_size=4):
    """Best-fit ground plane per coarse pillar -> TLS filter -> propagation
    to the fine pillars; returns (min_z [P], fine_normal, fine_center)."""
    X, Y = pillar_dims
    NX, NY = (X + window_size - 1) // window_size, (Y + window_size - 1) // window_size
    NP = NX * NY
    new_coords = points.pillar_coords // window_size
    new_pidx = new_coords[:, 0] * NY + new_coords[:, 1]
    new_pidx = torch.where(vox_valid, new_pidx, torch.full_like(new_pidx, NP))
    z = vox_bxyz[:, 3]
    n_min_z = segment_ops.segment_min_or(z, new_pidx, NP, 0.0)
    n_max_z = segment_ops.segment_max_or(z, new_pidx, NP, 0.0)
    best = _ransac_all_ratios(vox_bxyz[:, 1:4], vox_valid, z, new_pidx, n_min_z, n_max_z,
                              NP, float(cfg_sigma2))
    return _tls_propagate_heights(*best, pillars.xyz, points.pillar_idx, vox_bxyz[:, 1:4], z,
                                  vox_valid, X * Y, int(cfg_k))


def _tls_propagate_heights(best_conf, best_normal, best_center, pillars_xyz, pillar_idx,
                           vox_xyz, z, vox_valid, P, cfg_k):
    # truncated least squares: thresholds sweep log-space 5 -> 0.01 in 100
    # steps; each drops planes whose kNN mean curvature exceeds it (steps
    # above the current max are skipped; never drop everything)
    valid = best_conf > 0.5
    thresholds = np.logspace(np.log10(5.0), np.log10(0.01), 100).astype(np.float32)
    minus_inf = torch.tensor(float("-inf"), dtype=best_center.dtype, device=best_center.device)
    for thr in thresholds:
        idx, _ = sampling.knn_bruteforce(best_center, best_center, cfg_k, ref_valid=valid)
        diff = best_center[idx] - best_center[:, None, :]
        p2p = (diff * best_normal[:, None, :]).sum(-1).abs()
        curv = p2p / (torch.linalg.vector_norm(diff, dim=-1) + 1e-4)
        mean_curv = torch.where(valid, curv.mean(-1), minus_inf)
        new_valid = valid & (mean_curv < float(thr))
        new_valid = torch.where(new_valid.any(), new_valid, valid)
        valid = torch.where(float(thr) <= mean_curv.max(), new_valid, valid)

    # confidence propagation: each fine pillar takes the nearest surviving
    # plane center (max of 1 / (dist + 1))
    dist = torch.linalg.vector_norm(pillars_xyz[:, None, :2] - best_center[None, :, :2], dim=-1)
    conf = torch.where(valid[None, :], 1.0 / (dist + 1.0), minus_inf)
    sel = torch.argmax(conf, dim=1)
    fine_normal, fine_center = best_normal[sel], best_center[sel]

    # per-voxel height above the selected plane
    pc = torch.clamp(pillar_idx, 0, P - 1)
    vn, vc = fine_normal[pc], fine_center[pc]
    vnz = (torch.clamp(vn[:, 2].abs(), min=0.01)
           * ((vn[:, 2] >= 0).to(z.dtype) + 1.0) / 2.0)
    vheight = ((vox_xyz - vc) * vn).sum(-1) / vnz
    pidx_safe = torch.where(vox_valid, pillar_idx, torch.full_like(pillar_idx, P))
    return segment_ops.segment_mean(z - vheight, pidx_safe, P), fine_normal, fine_center


# ---------------------------------------------------------------------------
# L1 joint height-field optimization
# ---------------------------------------------------------------------------


def l1_loss_grad(h, m, w, rigid_weight):
    """Loss of the L1 height-field solve and its gradient in ``h`` [X, Y]:
    mean |(h - m) w| plus rigid_weight times the mean |second difference|
    along x, y and both diagonals (weights + 1e-2), each mean over its own
    element count."""
    X, Y = h.shape
    wl, wu, wt = w[1:-1] + 1e-2, w[:, 1:-1] + 1e-2, w[1:-1, 1:-1] + 1e-2
    n_all, n_l, n_u, n_t = X * Y, (X - 2) * Y, X * (Y - 2), (X - 2) * (Y - 2)
    a = (h - m) * w
    left = (h[:-2] - 2 * h[1:-1] + h[2:]) * wl
    up = (h[:, :-2] - 2 * h[:, 1:-1] + h[:, 2:]) * wu
    t1 = (h[:-2, :-2] - 2 * h[1:-1, 1:-1] + h[2:, 2:]) * wt
    t2 = (h[2:, :-2] - 2 * h[1:-1, 1:-1] + h[:-2, 2:]) * wt
    loss = a.abs().sum() / n_all + (left.abs().sum() / n_l + up.abs().sum() / n_u
                                     + t1.abs().sum() / n_t + t2.abs().sum() / n_t
                                     ) * rigid_weight
    g = abs_grad(a) * w / n_all
    gl = abs_grad(left) * wl * (rigid_weight / n_l)
    g[:-2] += gl
    g[1:-1] -= 2 * gl
    g[2:] += gl
    gu = abs_grad(up) * wu * (rigid_weight / n_u)
    g[:, :-2] += gu
    g[:, 1:-1] -= 2 * gu
    g[:, 2:] += gu
    g1 = abs_grad(t1) * wt * (rigid_weight / n_t)
    g[:-2, :-2] += g1
    g[1:-1, 1:-1] -= 2 * g1
    g[2:, 2:] += g1
    g2 = abs_grad(t2) * wt * (rigid_weight / n_t)
    g[2:, :-2] += g2
    g[1:-1, 1:-1] -= 2 * g2
    g[:-2, 2:] += g2
    return loss, g


def l1_minimization(pillar_min_z, pillar_weight, pillar_dims, lr, decay_steps, rigid_weight,
                    max_iters, max_countdown=3):
    """AdamW on the pillar height grid: L1 data term plus 2nd-order
    smoothness along x, y and both diagonals; MultiStep decay (x0.1 at
    ``decay_steps``); stops after ``max_countdown`` steps whose loss drop is
    below 1e-4 (one host read per step)."""
    X, Y = pillar_dims
    dev = pillar_min_z.device
    m = pillar_min_z.reshape(X, Y)
    w = pillar_weight.reshape(X, Y)
    h = torch.zeros((X, Y), dtype=pillar_min_z.dtype, device=dev)
    opt = AdamW(h)
    last = torch.tensor(1e10, dtype=h.dtype, device=dev)
    tol = torch.tensor(1e-4, dtype=h.dtype, device=dev)
    countdown, it = max_countdown, 0
    while countdown > 0 and it < max_iters:
        loss, g = l1_loss_grad(h, m, w, rigid_weight)
        h = opt.step(h, g, multistep_lr(lr, it, decay_steps))
        countdown = countdown - 1 if bool(last - loss < tol) else max_countdown
        last = loss
        it += 1
    return h


# ---------------------------------------------------------------------------
# whole solve
# ---------------------------------------------------------------------------


def ground_solve_fused(fxyz0, pc_range_min, pillar_dims, pillar_size=(2.0, 2.0),
                       use_ransac=True, joint_opt=True, lr=0.01, decay_steps=(1600,),
                       rigid_weight=0.5, max_iters=10000, sigma2=0.0025, tls_k=8,
                       cell=_BASE_CELL, field=None):
    """Grid subsample -> pillar stats -> 30-ratio RANSAC -> TLS propagation
    -> L1 height field -> per-point height / horizon / error. With ``field``
    (a stored ``pillar_height`` and ``pillar_min_z``, [P] each: the DIR warm
    start) the RANSAC, TLS and L1 steps are skipped and the per-point
    outputs come from the stored field."""
    vox = grid_utils.grid_sample_mean(fxyz0, list(cell))
    vox_bxyz, vox_valid, inverse = vox["bxyz"], vox["valid"], vox["inverse"]
    dev = fxyz0.device
    pcr = torch.as_tensor(pc_range_min, dtype=torch.float32, device=dev)
    points, pillars = format_pillars(vox_bxyz, vox_valid, pillar_size, pcr, pillar_dims)
    if field is not None:
        height = torch.as_tensor(np.asarray(field["pillar_height"]), device=dev).reshape(-1)
        pillars.min_z = torch.as_tensor(np.asarray(field["pillar_min_z"]), device=dev).reshape(-1)
    else:
        if use_ransac:
            pillars.min_z = ransac_min_height(vox_bxyz, vox_valid, points, pillars, pillar_dims,
                                              sigma2, tls_k)[0]
        if joint_opt:
            height = l1_minimization(pillars.min_z, pillars.weight, pillar_dims, lr,
                                     tuple(decay_steps), rigid_weight, max_iters).reshape(-1)
        else:
            height = pillars.min_z
    pidx = torch.clamp(points.pillar_idx, 0, height.shape[0] - 1)
    vheight = vox_bxyz[:, 3] - height[pidx]
    vmin = pillars.min_z[pidx]
    return dict(
        pillar_height=height,
        pillar_min_z=pillars.min_z,
        point_height=vheight[inverse],
        point_horizon=(vox_bxyz[:, 3] > vmin)[inverse],
        point_error=(vheight - vmin)[inverse],
        num_voxels=vox["num_voxels"],
    )


def count_voxel_levels(fxyz0, solve_cap, S=6):
    """Pick the finest dyadic coarsening s of the 0.10 x 0.10 x 0.03 m solve
    grid whose exact occupied-cell count fits ``solve_cap`` (any level fits
    when the sequence itself has at most ``solve_cap`` points); returns
    (s, occupied cells at s)."""
    n = fxyz0.shape[0]
    xyz = fxyz0[:, 1:4]
    mn = xyz.min(dim=0).values
    count = 0
    for s in range(S):
        cell = torch.tensor([c * 2.0 ** s for c in _BASE_CELL], dtype=torch.float32,
                            device=xyz.device)
        c = torch.floor((xyz - mn) * (1.0 / cell)).to(torch.int64)
        dims = c.max(dim=0).values + 1
        key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        count = int(torch.unique(key).numel())
        if count <= solve_cap or n <= solve_cap:
            return s, count
    return S - 1, count


class GroundPlaneRemover:
    """Subsample, solve, truncate below TRUNCATE_HEIGHT (config keys as in
    the JAX module, DIR and LOG_DIR among them). The ``full_*`` keys keep the
    pre-removal arrays."""

    def __init__(self, model_cfg, runtime_cfg=None, device="cuda"):
        self.model_cfg = EDict(model_cfg)
        self.device = resolve_device(device)

    def _solve(self, pts_np, warm=None):
        """The per-point height, horizon and error and the pillar height
        field; from the field in ``warm`` (a loaded pillar_height.npz),
        without the solve, when it is given."""
        cfg = self.model_cfg
        fxyz0 = torch.as_tensor(pts_np, dtype=torch.float32, device=self.device).clone()
        fxyz0[:, 0] = 0.0  # frame-agnostic
        s, _ = count_voxel_levels(fxyz0, int(cfg.get("SOLVE_VOX_CAP", 1 << 21)))
        cell = tuple(c * (2.0 ** s) for c in _BASE_CELL)
        if s:
            print(f"Ground Removal: solve grid coarsened to {cell[0]:.2f} m")
        xy = pts_np[:, 1:3]
        pc_range_min = xy.min(0) - 0.05
        pillar_size = tuple(float(v) for v in cfg.get("PILLAR_SIZE", [2, 2]))
        dims = np.floor((xy.max(0) - pc_range_min) / np.asarray(pillar_size)).astype(int) + 1
        dims = (int(np.ceil(dims[0] / 8) * 8), int(np.ceil(dims[1] / 8) * 8))
        return ground_solve_fused(
            fxyz0, pc_range_min, dims, pillar_size=pillar_size,
            use_ransac=bool(cfg.get("RANSAC", False)),
            joint_opt=bool(cfg.get("JointOpt", False)),
            lr=float(cfg.get("LR", 0.01)),
            decay_steps=tuple(int(d) for d in cfg.get("DECAY_STEPS", [1600])),
            rigid_weight=float(cfg.get("RIGID_WEIGHT", 0.5)),
            max_iters=int(cfg.get("MAX_NUM_ITERS", 10000)),
            sigma2=float(cfg.get("SIGMA2", 0.0025)),
            tls_k=int(cfg.get("K", 8)),
            cell=cell,
            field=warm,
        )

    def output_stats(self, segmentation_label, ground_mask, sequence_id, log_dir):
        """Write and return the removal's precision and coverage for one
        sequence (Waymo labels: 1..7 foreground, >= 17 ground)."""
        os.makedirs(log_dir, exist_ok=True)
        seg = np.asarray(segmentation_label)
        gm = np.asarray(ground_mask)
        rm_fg = int(((seg[gm] > 0) & (seg[gm] <= 7)).sum())
        rm_gd = int((seg[gm] >= 17).sum())
        rm = int(gm.sum())
        fg = int(((seg > 0) & (seg <= 7)).sum())
        gd = int((seg >= 17).sum())
        stats = dict(
            num_removed_points=rm,
            num_removed_foreground=rm_fg,
            num_removed_ground=rm_gd,
            ground_precision=rm_gd / (rm + 1e-6),
            ground_coverage=rm_gd / (gd + 1e-6),
            foreground_precision=rm_fg / (rm + 1e-6),
            foreground_coverage=rm_fg / (fg + 1e-6),
        )
        with open(os.path.join(log_dir, f"{sequence_id}.txt"), "w") as f:
            f.write(f"{dict(self.model_cfg)}\n")
            f.write(f"#removed_points={rm}\n")
            f.write(f"#removed_foreground={rm_fg}\n")
            f.write(f"#removed_ground={rm_gd}\n")
            f.write(f"ground_precision={stats['ground_precision']:.6f}\n")
            f.write(f"ground_coverage={stats['ground_coverage']:.6f}\n")
            f.write(f"foreground_precision={stats['foreground_precision']:.6f}\n")
            f.write(f"foreground_coverage={stats['foreground_coverage']:.6f}\n")
        return stats

    def __call__(self, seq_dict):
        cfg = self.model_cfg
        sequence_id = str(seq_dict["frame_id"])[:-4] if "frame_id" in seq_dict else "seq"
        path = os.path.join(cfg.DIR, sequence_id) if "DIR" in cfg else None
        npz = os.path.join(path, "pillar_height.npz") if path else None
        warm = None
        if npz and os.path.exists(npz):
            with np.load(npz) as f:
                warm = {k: f[k] for k in ("pillar_height", "pillar_min_z")}
        out = self._solve(np.asarray(seq_dict["point_fxyz"]), warm)
        if npz and warm is None:
            os.makedirs(path, exist_ok=True)
            np.savez(npz, pillar_height=out["pillar_height"].cpu().numpy(),
                     pillar_min_z=out["pillar_min_z"].cpu().numpy())
        height = out["point_height"].cpu().numpy()
        seq_dict["point_height"] = height
        seq_dict["point_horizon"] = out["point_horizon"].cpu().numpy()
        seq_dict["point_error"] = out["point_error"].cpu().numpy()
        heights = cfg.get("TRUNCATE_HEIGHT", [0.5])
        if "segmentation_label" in seq_dict and "LOG_DIR" in cfg:
            for h in heights:
                self.output_stats(seq_dict["segmentation_label"], height < h, sequence_id,
                                  os.path.join(cfg.LOG_DIR, f"height{h}"))
        # the final mask uses the last height, like the reference
        keep = ~(height < heights[-1])
        seq_dict["full_point_keep0"] = height > 0.0
        for key in ("point_fxyz", "segmentation_label", "point_sweep", "instance_label",
                    "point_height", "point_horizon"):
            if key in seq_dict:
                seq_dict[f"full_{key}"] = seq_dict[key]
                seq_dict[key] = np.asarray(seq_dict[key])[keep]
        return seq_dict
