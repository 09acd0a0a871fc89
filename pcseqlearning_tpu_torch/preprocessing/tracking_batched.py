"""Component-bucketed tracking walk (counterpart of
pcseqlearning_tpu.preprocessing.tracking_batched).

Anchor points are packed into dense [C, P] tiles; per walk step each
component selects Q next-frame candidates once, then a 3-level voxel/radius
ICP pyramid runs on [C, P] x [C, Q] tiles whose correspondences come from
the ``pair_min`` kernel. Velocity warm start, AdamW temporal smoothing, the
stopping rules and nearest-component member extraction follow the JAX walk
step for step.

Where JAX ran each walk direction as one ``lax.while_loop``, the port runs
a Python loop with one host read per step (the all-stopped / window-end
exit), and each ICP level and smoothing solve likewise reads its
convergence scalar once per iteration. The loop condition guarantees every
step it runs is active, so the step body carries no ``active`` masks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry, segment_ops
from ..ops.pair_min import pair_min
from ..ops.sorted_grid import radius_r2
from .tracking_device import _smooth_velos

_INF = float("inf")


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def pack_components_device(xyz, comp, keep, C, P):
    """[K] anchor rows -> ([C, P, 3] tiles, [C, P] mask).

    Components with more than P kept points keep every ceil(cnt / P)-th
    point in row order."""
    K = xyz.shape[0]
    dev = xyz.device
    ok = keep & (comp >= 0) & (comp < C)
    skey = torch.where(ok, comp.long(), torch.full_like(comp, C, dtype=torch.int64))
    skey_s, idx_s = torch.sort(skey, stable=True)
    xyz_s = xyz[idx_s]
    ok_s = skey_s < C
    iota = torch.arange(K, device=dev)
    first = torch.ones(K, dtype=torch.bool, device=dev)
    first[1:] = skey_s[1:] != skey_s[:-1]
    seg_start = torch.cummax(torch.where(first, iota, torch.full_like(iota, -1)), 0).values
    pos = iota - seg_start
    cnt = segment_ops.segment_count(
        torch.where(ok_s, skey_s, torch.full_like(skey_s, C)), C + 1, dtype=torch.int64)[:C]
    stride = torch.clamp(-(-cnt // P), min=1)
    st = stride[torch.clamp(skey_s, 0, C - 1)]
    slot = pos // st
    sel = ok_s & (pos % st == 0) & (slot < P)
    flat = torch.clamp(skey_s, 0, C - 1)[sel] * P + slot[sel]
    tile = torch.zeros((C * P, 3), dtype=xyz.dtype, device=dev)
    tile[flat] = xyz_s[sel]
    mask = torch.zeros(C * P, dtype=torch.bool, device=dev)
    mask[flat] = True
    return tile.reshape(C, P, 3), mask.reshape(C, P)


# ---------------------------------------------------------------------------
# tile ops
# ---------------------------------------------------------------------------


def _masked_center(pts, mask):
    """[C, K, 3], [C, K] -> [C, 3] mean over the mask."""
    w = mask.to(pts.dtype)
    n = torch.clamp(w.sum(1), min=1.0)
    return (pts * w[..., None]).sum(1) / n[:, None]


def _gather_rows(x, idx):
    """x [C, K, 3] rows idx [C, M] -> [C, M, 3]."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, 3))


def _transform(T, pts):
    """Apply per-component [C, 4, 4] transforms to [C, K, 3] tiles."""
    return geometry.mv(T[:, None, :3, :3], pts) + T[:, None, :3, 3]


def _pair_min(a, b, a_mask, b_mask):
    return pair_min(a.contiguous(), b.contiguous(), a_mask.contiguous(), b_mask.contiguous())


def _voxel_dedup(xyz, mask, voxel_size):
    """Per-component voxel-mean dedup in the [C, K] tile layout.

    Voxel keys (relative to the row's min cell) are sorted per row; the
    first occurrence of each voxel carries the voxel's mean position.
    Returns (rep_xyz [C, K, 3], rep_mask [C, K]) in sorted-key order."""
    C, K, _ = xyz.shape
    dev = xyz.device
    vs = torch.tensor(voxel_size, dtype=xyz.dtype, device=dev)
    coords = torch.floor(xyz / vs).to(torch.int64)
    cmin = torch.where(mask[..., None], coords, torch.full_like(coords, 2 ** 20)).min(
        dim=1, keepdim=True).values
    rel = torch.clamp(coords - cmin, 0, 1023)
    key = (rel[..., 0] << 20) | (rel[..., 1] << 10) | rel[..., 2]
    key = torch.where(mask, key, torch.full_like(key, 2 ** 30))
    skey, sidx = torch.sort(key, dim=1, stable=True)
    sxyz = _gather_rows(xyz, sidx)
    svalid = skey != 2 ** 30
    first = torch.ones((C, K), dtype=torch.bool, device=dev)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first = first & svalid
    seg_in_row = torch.cumsum(first.to(torch.int64), dim=1)
    gid = (torch.arange(C, device=dev)[:, None] * (K + 1)
           + torch.where(svalid, seg_in_row, torch.zeros_like(seg_in_row))).reshape(-1)
    flat_xyz = torch.where(svalid[..., None], sxyz, torch.zeros_like(sxyz)).reshape(C * K, 3)
    w = svalid.to(xyz.dtype).reshape(-1)
    sums = segment_ops.segment_sum(flat_xyz * w[:, None], gid, C * (K + 1))
    cnts = segment_ops.segment_sum(w, gid, C * (K + 1))
    means = sums / torch.clamp(cnts, min=1.0)[:, None]
    rep = means[gid].reshape(C, K, 3)
    return torch.where(first[..., None], rep, torch.zeros_like(rep)), first


def _icp_level(m_xyz, m_mask, r_xyz, r_mask, T_prior, radius, angle_regularizer,
               max_iter, stopping_delta, trunc_dist=0.3):
    """Batched per-component rigid ICP on [C, P] vs [C, Q] tiles:
    bidirectional NN edges (pair_min), centered covariance + Procrustes with
    the angle-regularizer prior on the accumulated rotation, truncated
    robust mean error, loss-countdown stopping.

    Returns (T [C, 4, 4], l1_err [C], edge_ratio [C])."""
    C = m_xyz.shape[0]
    dev = m_xyz.device
    _, r2 = radius_r2(radius)
    n_r = r_mask.sum(1)
    sd = torch.tensor(stopping_delta, dtype=torch.float32, device=dev)

    def solve(xyz, T):
        f_d2, f_j, b_d2, b_i = _pair_min(xyz, r_xyz, m_mask, r_mask)
        f_ok = m_mask & (f_d2 <= r2)
        b_ok = r_mask & (b_d2 <= r2)
        pm = torch.cat([xyz, _gather_rows(xyz, b_i)], dim=1)
        pr = torch.cat([_gather_rows(r_xyz, f_j), r_xyz], dim=1)
        ok = torch.cat([f_ok, b_ok], dim=1)
        w = ok.to(xyz.dtype)
        n = torch.clamp(w.sum(1), min=1e-6)
        mc = (pm * w[..., None]).sum(1) / n[:, None]
        rc = (pr * w[..., None]).sum(1) / n[:, None]
        zero = torch.zeros((), dtype=xyz.dtype, device=dev)
        Pc = torch.where(ok[..., None], pm - mc[:, None, :], zero)
        Qc = torch.where(ok[..., None], pr - rc[:, None, :], zero)
        dist = torch.linalg.vector_norm(Pc - Qc, dim=-1)
        mean0 = (dist * w).sum(1) / n
        clamped = torch.minimum(torch.maximum(dist, (mean0 - trunc_dist)[:, None]),
                                (mean0 + trunc_dist)[:, None])
        l1 = (clamped * w).sum(1) / n
        loss = (w * dist * dist).sum()
        cov = (Pc[..., :, None] * Qc[..., None, :]).sum(1) / n[:, None, None]
        R = geometry.procrustes_rotation((cov + T[:, :3, :3] * angle_regularizer)
                                         .transpose(-1, -2))
        t = rc - geometry.mv(R, mc)
        return R, t, l1, loss

    xyz, T = m_xyz, T_prior
    l1 = torch.zeros(C, dtype=m_xyz.dtype, device=dev)
    last_loss = torch.tensor(1e10, dtype=torch.float32, device=dev)
    countdown, it = 3, 0
    while countdown > 0 and it < max_iter:
        R, t, l1, loss = solve(xyz, T)
        xyz = geometry.mv(R[:, None], xyz) + t[:, None, :]
        T = geometry.mm(geometry.make_rigid(R, t), T)
        countdown = countdown - 1 if bool(last_loss - loss < sd) else 3
        last_loss = loss
        it += 1

    f_d2_fin = _pair_min(xyz, r_xyz, m_mask, r_mask)[0]
    f_ok = m_mask & (f_d2_fin <= r2)
    deg = torch.clamp(m_mask.sum(1).to(torch.float32), min=1e-6)
    ratio = f_ok.sum(1) / deg
    empty = n_r < 0.5
    eye = torch.eye(4, dtype=T.dtype, device=dev).expand_as(T)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return (torch.where(empty[:, None, None], eye, T), torch.where(empty, zero, l1),
            torch.where(empty, zero, ratio))


# ---------------------------------------------------------------------------
# one walk step
# ---------------------------------------------------------------------------


def _hash01(N, device):
    """Per-point pseudo-random tie breaker in [0, 1): (i * 2654435761 mod
    2^32) >> 12, over 2^20."""
    pidx = torch.arange(N, dtype=torch.int64, device=device)
    h = ((pidx * 2654435761) & 0xFFFFFFFF) >> 12
    return h.to(torch.float32) / float(1 << 20)


def _center_d2(centers, pts):
    """[C, 3] x [N, 3] -> [C, N] squared distances by the |c|^2 + |p|^2 -
    2 c.p expansion (the JAX walk's candidate/gating metric)."""
    c2 = (centers * centers).sum(-1)
    n2 = (pts * pts).sum(-1)
    cross = (centers[:, None, 0] * pts[None, :, 0] + centers[:, None, 1] * pts[None, :, 1]
             + centers[:, None, 2] * pts[None, :, 2])
    return c2[:, None] + n2[None, :] - 2.0 * cross


def _step_core(consts, carry, track_dir, s, *, interval, levels, max_icp_iter,
               min_move_frame, num_candidates, fine_candidates, angle_velo_exempt):
    """One (active) walk step: candidate selection + ICP pyramid + velocity
    smoothing + stopping rules + member-point extraction, batched over
    components. ``carry`` is a dict of tensors, updated and returned."""
    c = consts
    carry = dict(carry)
    window_xyz = c["window_xyz"]
    W, N, _ = window_xyz.shape
    cur_pts = carry["cur_pts"]
    C = cur_pts.shape[0]
    dev = cur_pts.device
    anchor = interval
    pos = anchor + track_dir * s
    prev = pos - track_dir
    stopped, last_velo = carry["stopped"], carry["last_velo"]
    has_last_velo = carry["has_last_velo"]
    diam, pmask = c["comp_diameter"], c["comp_pmask"]
    nxt_xyz = window_xyz[pos]
    nxt_ok = c["window_valid"][pos]
    nxt_usable = c["window_usable"][pos]

    T_cum = carry["transforms"][:, prev].clone()
    # velocity warm start
    trans = torch.where((~stopped & has_last_velo)[:, None], last_velo,
                        torch.zeros_like(last_velo))
    cur_pts = cur_pts + (trans * track_dir)[:, None, :]
    T_cum[:, :3, 3] += trans * track_dir

    # ---- candidate selection: Q next-frame points per component; core
    # points first, ties broken by a per-point hash (an unbiased sample)
    d2cn = _center_d2(_masked_center(cur_pts, pmask), nxt_xyz)
    sel_r = diam * 0.5 + c["sel_margin"]
    core_r = diam * 0.5 + 1.0
    in_ball = nxt_ok[None, :] & (d2cn <= (sel_r * sel_r)[:, None])
    in_core = d2cn <= (core_r * core_r)[:, None]
    score = torch.where(in_ball, in_core.to(torch.float32) * 2.0 + _hash01(N, dev)[None, :],
                        torch.full_like(d2cn, -_INF))
    top = torch.topk(score, num_candidates, dim=1)
    cand_sel = torch.isfinite(top.values)
    cand_idx = top.indices
    cand_xyz = nxt_xyz[cand_idx]
    cand_usable = cand_sel & nxt_usable[cand_idx]

    # ---- ICP pyramid (coarse to fine)
    l1_err = edge_ratio = None
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(C, 4, 4)
    for li, (vx, vy, vz, radius, sdelta) in enumerate(levels):
        # cross-component exclusivity: a candidate joins only the component
        # whose moved points are nearest
        _, _, mind_cp, _ = _pair_min(cur_pts, cand_xyz, pmask, cand_usable)
        flat_idx = torch.where(cand_usable, cand_idx, torch.full_like(cand_idx, N)).reshape(-1)
        flat_d = torch.where(cand_usable, mind_cp, inf).reshape(-1)
        best_cp = segment_ops.segment_min(flat_d, flat_idx, N + 1)[:N]
        excl = cand_usable & (mind_cp <= best_cp[cand_idx])
        m_xyz, m_mask = _voxel_dedup(cur_pts, pmask, (vx, vy, vz))
        r_xyz, r_mask = _voxel_dedup(cand_xyz, excl, (vx, vy, vz))
        T_l, l1_l, ratio_l = _icp_level(
            m_xyz, m_mask, r_xyz, r_mask, eye, radius, c["angle_regularizer"],
            max_icp_iter, sdelta)
        if li == 0:
            edge_ratio = ratio_l
        if li == len(levels) - 1:
            l1_err = l1_l
        cur_pts = _transform(T_l, cur_pts)
        T_cum = geometry.mm(T_l, T_cum)
        if li == 0 and fine_candidates < cand_xyz.shape[1]:
            # fine levels keep only the candidates nearest the aligned tile
            _, _, bd0, _ = _pair_min(cur_pts, cand_xyz, pmask, cand_usable)
            top0 = torch.topk(-torch.where(cand_usable, bd0, inf), fine_candidates, dim=1)
            near = torch.isfinite(top0.values)
            keep_i = top0.indices
            cand_xyz = _gather_rows(cand_xyz, keep_i)
            cand_idx = torch.gather(cand_idx, 1, keep_i)
            cand_usable = torch.gather(cand_usable, 1, keep_i) & near

    # ---- component centers + velocity
    centers = _masked_center(cur_pts, pmask)
    comp_centers = carry["comp_centers"].clone()
    comp_velos = carry["comp_velos"].clone()
    comp_center_diffs = carry["comp_center_diffs"].clone()
    comp_centers[:, pos] = centers
    velo = (centers - carry["last_center"]) * track_dir
    velo[:, 2] = 0.0
    comp_velos[:, pos] = velo
    if track_dir == -1 and s == 1:
        comp_velos[:, anchor] = velo
    comp_center_diffs[:, pos] = (comp_centers[:, pos] - comp_centers[:, prev]) * track_dir

    # temporal smoothing over the walked span
    w_idx = torch.arange(W, device=dev)
    lo, hi = min(anchor + track_dir, pos), max(anchor + track_dir, pos)
    comp_velos = _smooth_velos(comp_velos, comp_center_diffs, (w_idx >= lo) & (w_idx <= hi))
    delta = comp_velos[:, pos] - velo
    velo = comp_velos[:, pos]
    cur_pts = cur_pts + (delta * track_dir)[:, None, :]
    T_cum[:, :3, 3] += delta * track_dir
    last_center = _masked_center(cur_pts, pmask)
    transforms = carry["transforms"].clone()
    transforms[:, pos] = T_cum

    # ---- stopping rules
    new_stopped = stopped | (l1_err > c["reg_error_coeff"] * diam * (1.0 + c["dist_comp"]))
    new_stopped = new_stopped | (edge_ratio < 0.5)
    moving = carry["moving"]
    if min_move_frame >= 1 and s == min_move_frame:
        moved = torch.linalg.vector_norm(comp_centers[:, pos] - comp_centers[:, anchor], dim=-1)
        moving = moving & (moved > 0.08 * diam)
    dev_v = torch.linalg.vector_norm(velo - last_velo, dim=-1)
    new_stopped = new_stopped | (has_last_velo & (dev_v > 0.24 * diam))
    prev_v = comp_velos[:, prev]
    nrm = torch.clamp(torch.linalg.vector_norm(velo, dim=-1)
                      * torch.linalg.vector_norm(prev_v, dim=-1), min=1e-6)
    ang = torch.rad2deg(torch.arccos(torch.clamp((velo * prev_v).sum(-1) / nrm, -1.0, 1.0)))
    new_stopped = new_stopped | (
        has_last_velo & (ang > c["angle_threshold_deg"])
        & (torch.linalg.vector_norm(velo[:, :2], dim=-1) > angle_velo_exempt))
    pos_t = torch.full_like(carry["reach_min"], pos)
    if track_dir == -1:
        carry["reach_min"] = torch.where(~new_stopped, pos_t, carry["reach_min"])
    else:
        carry["reach_max"] = torch.where(~new_stopped, pos_t, carry["reach_max"])

    # ---- NN member extraction over ALL next-frame points: each point tests
    # its 2 nearest open component centers, the exact distance to the moved
    # extraction tile decides
    comp_open = ~new_stopped & (c["ext_mask"].sum(1) > 0)
    d2gate = torch.where(comp_open[:, None], _center_d2(last_center, nxt_xyz), inf)
    near2 = torch.topk(-d2gate.t(), min(2, C), dim=1).indices
    if C < 2:
        near2 = torch.cat([near2, near2], dim=1)
    moved_ext = _transform(T_cum, c["comp_ext"])
    ext_mask = c["ext_mask"]
    _, nn_r2 = radius_r2(c["nn_radius"])
    extract_comp = carry["extract_comp"].clone()
    step = max(1, (1 << 24) // max(2 * moved_ext.shape[1], 1))
    for n0 in range(0, N, step):
        nb = near2[n0:n0 + step]
        tiles = moved_ext[nb]  # [n, 2, Pe, 3]
        q = nxt_xyz[n0:n0 + step, None, None, :]
        dx, dy, dz = (tiles[..., 0] - q[..., 0], tiles[..., 1] - q[..., 1],
                      tiles[..., 2] - q[..., 2])
        dd = torch.where(ext_mask[nb], dx * dx + dy * dy + dz * dz, inf)
        mind2 = dd.min(dim=2).values
        claim2 = (mind2 <= nn_r2) & comp_open[nb] & nxt_ok[n0:n0 + step, None]
        mind2 = torch.where(claim2, mind2, inf)
        pick = torch.argmin(mind2, dim=1)
        any_claim = claim2.any(dim=1)
        best = torch.gather(nb, 1, pick[:, None])[:, 0]
        cur = extract_comp[pos, n0:n0 + step]
        extract_comp[pos, n0:n0 + step] = torch.where(any_claim, best.to(cur.dtype), cur)

    reg_errors = carry["reg_errors"].clone()
    edge_ratios = carry["edge_ratios"].clone()
    reg_errors[:, pos] = l1_err
    edge_ratios[:, pos] = edge_ratio
    carry.update(
        cur_pts=cur_pts, last_center=last_center, stopped=new_stopped, moving=moving,
        last_velo=velo, has_last_velo=True, transforms=transforms, comp_velos=comp_velos,
        comp_centers=comp_centers, comp_center_diffs=comp_center_diffs,
        reg_errors=reg_errors, edge_ratios=edge_ratios, extract_comp=extract_comp)
    return carry


def walk_direction(consts, carry, track_dir, frame_nonempty, **kw):
    """One direction of the walk: steps s = 1, 2, ... while the step stays in
    the window, its frame has points and some component is still open (one
    host read per step)."""
    interval = kw["interval"]
    W = consts["window_xyz"].shape[0]
    s = 1
    while s <= interval:
        pos = interval + track_dir * s
        if not (0 <= pos < W and frame_nonempty[pos]):
            break
        if not bool((~carry["stopped"]).any()):
            break
        carry = _step_core(consts, carry, track_dir, s, **kw)
        s += 1
    return carry


def _dist_compensate(comp_deg):
    """Registration-error slack for small components."""
    out = torch.zeros_like(comp_deg, dtype=torch.float32)
    for lo, hi, v in ((0, 10, 1.0), (10, 40, 0.5), (40, 100, 0.3), (100, 200, 0.2),
                      (200, 400, 0.1)):
        out = torch.where((comp_deg >= lo) & (comp_deg < hi), torch.full_like(out, v), out)
    return out


def track_window_batched_dispatch(
    window_xyz, window_valid, window_stationary, comp_xyz, comp_pmask,
    comp_valid0, comp_diameter, comp_deg,
    interval, levels, num_candidates,
    nn_radius, angle_regularizer, reg_error_coeff, angle_threshold_deg,
    min_move_frame, max_icp_iter=80, sel_margin=6.0,
    comp_ext=None, ext_mask=None, frame_nonempty=None,
    fine_candidates=256, angle_velo_exempt=0.05,
):
    """Run the walk (both directions) on the device.

    window_*: [W, N(,3)] frame tables with the anchor at slot ``interval``;
    comp_xyz/comp_pmask: [C, P(,3)] packed anchor points per component.
    Returns a dict of device tensors for ``track_window_batched_drain``."""
    W = 2 * interval + 1
    C = comp_xyz.shape[0]
    N = window_xyz.shape[1]
    dev = comp_xyz.device
    anchor = interval
    if comp_ext is None:
        comp_ext, ext_mask = comp_xyz, comp_pmask
    consts = dict(
        window_xyz=window_xyz, window_valid=window_valid,
        window_usable=window_valid & ~window_stationary,
        comp_pmask=comp_pmask, comp_ext=comp_ext, ext_mask=ext_mask,
        comp_diameter=comp_diameter, dist_comp=_dist_compensate(comp_deg),
        nn_radius=float(nn_radius), angle_regularizer=float(angle_regularizer),
        reg_error_coeff=float(reg_error_coeff),
        angle_threshold_deg=float(angle_threshold_deg), sel_margin=float(sel_margin),
    )
    if frame_nonempty is None:
        frame_nonempty = window_valid.any(dim=1).tolist()
    center0 = _masked_center(comp_xyz, comp_pmask)
    comp_centers = torch.zeros((C, W, 3), dtype=torch.float32, device=dev)
    comp_centers[:, anchor] = center0
    g = dict(
        transforms=torch.eye(4, dtype=torch.float32, device=dev).expand(C, W, 4, 4).clone(),
        comp_velos=torch.zeros((C, W, 3), dtype=torch.float32, device=dev),
        comp_centers=comp_centers,
        comp_center_diffs=torch.zeros((C, W, 3), dtype=torch.float32, device=dev),
        reg_errors=torch.zeros((C, W), dtype=torch.float32, device=dev),
        edge_ratios=torch.zeros((C, W), dtype=torch.float32, device=dev),
        extract_comp=torch.full((W, N), -1, dtype=torch.int32, device=dev),
        reach_min=torch.full((C,), anchor, dtype=torch.int64, device=dev),
        reach_max=torch.full((C,), anchor, dtype=torch.int64, device=dev),
    )
    kw = dict(interval=interval, levels=levels, max_icp_iter=max_icp_iter,
              min_move_frame=min_move_frame, num_candidates=num_candidates,
              fine_candidates=fine_candidates, angle_velo_exempt=angle_velo_exempt)
    moving_final = comp_valid0.clone()
    for track_dir in (-1, 1):
        has_lv = track_dir == 1 and bool((g["comp_velos"][:, anchor] != 0).any())
        carry = dict(
            cur_pts=comp_xyz, last_center=center0, stopped=~comp_valid0,
            moving=comp_valid0.clone(), last_velo=g["comp_velos"][:, anchor].clone(),
            has_last_velo=has_lv, **g)
        carry = walk_direction(consts, carry, track_dir, frame_nonempty, **kw)
        # AND across directions: each direction's min-move gate can veto
        moving_final = moving_final & carry["moving"]
        for k in g:
            g[k] = carry[k]
    g["valid_final"] = comp_valid0 & ((g["reach_max"] >= anchor + min_move_frame)
                                      | (g["reach_min"] <= anchor - min_move_frame))
    g["moving"] = moving_final
    return g


def track_window_batched_drain(g):
    """Host copies of the walk outputs the caller consumes
    (``extract_comp`` as a dense [W, N] int32 table)."""
    keys = ("transforms", "reg_errors", "edge_ratios", "extract_comp", "moving", "valid_final",
            "reach_min", "reach_max")
    return {k: g[k].cpu().numpy() for k in keys}


def track_window_batched(*args, **kwargs):
    """Dispatch + drain in one call."""
    return track_window_batched_drain(track_window_batched_dispatch(*args, **kwargs))
