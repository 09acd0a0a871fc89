"""The [W, N]-window tracking walk (counterpart of
pcseqlearning_tpu.preprocessing.tracking_device) and the velocity smoothing
that every walk shares.

The window of frames is one [W, N, 3] device table; one step function
advances the walk a frame in one direction: velocity warm start, the 3-level
grid-subsample + ``register_to_next_frame`` pyramid, the component centers
and AdamW velocity smoothing, the stopping rules, and the hash-grid
nearest-neighbour extraction of the step frame's member points. The host
drives 2 x interval steps.

JAX has two programs for this walk, ``track_window`` (one ``lax.scan``) and
``track_window_stepped`` (host-driven steps), only because of TPU compile
limits; both compute the same thing, so here ``track_window`` is
``track_window_stepped``. A step that is not active (out of the window, an
empty frame, or every component stopped) changes nothing but the carried
velocity, as JAX's ``jnp.where(active, ...)`` masks have it, so the port
returns those outputs without running the step.
"""

from __future__ import annotations

import torch

from ..ops import geometry, grid_utils, hash_graph, segment_ops
from ..ops.optim import AdamW, abs_grad, multistep_lr
from .registration import _zero_frame, register_to_next_frame


def _smooth_velos(velos, diffs, active, num_itr=300, stopping=1e-3, weight0=1.0,
                  weight=10.0):
    """AdamW velocity smoothing over the active span: L2 fit of xy velocities
    to the center differences plus an L1 temporal-smoothness term, MultiStep
    decay at 100/200/300 steps, early-stop countdown. Frames outside the
    span keep their values."""
    dev = velos.device
    act = active.to(velos.dtype)[None, :, None]
    pair_act = (active[:-1] & active[1:]).to(velos.dtype)[None, :, None]
    Cn = velos.shape[0]
    n_act = torch.clamp(act.sum() * 2.0, min=1.0) * Cn
    n_pair = torch.clamp(pair_act.sum() * 2.0, min=1.0) * Cn
    v = velos
    opt = AdamW(v)
    stop = torch.tensor(stopping, dtype=torch.float32, device=dev)
    last = torch.tensor(1e10, dtype=velos.dtype, device=dev)
    cd, it = 3, 0
    while cd > 0 and it < num_itr:
        r = (v - diffs)[..., :2] * act
        e = (v[:, :-1, :2] - v[:, 1:, :2]) * pair_act
        loss = (r * r).sum() / n_act * weight0 + e.abs().sum() / n_pair * weight
        g = torch.zeros_like(v)
        g[..., :2] = (2.0 * weight0) * r * act / n_act
        ge = weight * abs_grad(e) * pair_act / n_pair
        g[:, :-1, :2] += ge
        g[:, 1:, :2] -= ge
        v = opt.step(v, g, multistep_lr(1e-2, it, (100, 200, 300)))
        cd = cd - 1 if bool(last - loss < stop) else 3
        last = loss
        it += 1
    return torch.where(active[None, :, None], v, velos)


def _sample_frame_kernel(fxyz, comp, stationary, valid, voxel_size):
    """Voxel subsample of the valid rows of one frame [N, 4]: per-voxel mean
    position, median component id and mean>0.5 stationary flag, in [N]-row
    tables whose first rows are the occupied voxels in lexicographic voxel
    order (``occupied`` marks them). The host walk's per-frame sample
    (cluster_tracking._sample_frame) and ``_grid_sample_masked`` below."""
    n = fxyz.shape[0]
    coords = grid_utils.voxel_coords(fxyz, voxel_size)
    coords = torch.where(valid[:, None], coords, torch.full_like(coords, 2 ** 24))
    inverse, _, _ = grid_utils.unique_rows(coords)
    zero = torch.zeros((), dtype=fxyz.dtype, device=fxyz.device)
    mean = segment_ops.segment_mean(torch.where(valid[:, None], fxyz, zero), inverse, n)
    stat = segment_ops.segment_mean(torch.where(valid, stationary.to(fxyz.dtype), zero),
                                    inverse, n) > 0.5
    med_comp = segment_ops.segment_median(torch.where(valid, comp, torch.full_like(comp, -1)),
                                          inverse, n)
    occ = segment_ops.segment_count(torch.where(valid, inverse, torch.full_like(inverse, n)),
                                    n + 1)[:n]
    return mean, med_comp, stat, occ > 0.5


def _grid_sample_masked(xyz, comp, stationary, valid, voxel_size):
    """The device walk's per-voxel mean xyz [N, 3], median component,
    stationary flag, and validity (occupied, with a component)."""
    mean, med_comp, stat, occ = _sample_frame_kernel(_zero_frame(xyz), comp, stationary, valid,
                                                     voxel_size)
    return mean[:, 1:4], med_comp, stat, occ & (med_comp >= 0)


def _comp_stats(xyz, comp_safe, valid, C):
    """Per-component point count and mean of the valid rows."""
    seg = torch.where(valid, comp_safe, torch.full_like(comp_safe, C))
    deg = segment_ops.segment_count(seg, C + 1)[:C]
    zero = torch.zeros((), dtype=xyz.dtype, device=xyz.device)
    return deg, segment_ops.segment_mean(torch.where(valid[:, None], xyz, zero), seg, C + 1)[:C]


def _step_impl(consts, carry, track_dir, s, *, C, anchor_pos, levels, max_icp_iter,
               min_move_frame):
    """One walk step at window slot anchor_pos + track_dir * s; ``carry``
    is a dict, returned updated."""
    c = consts
    carry = dict(carry)
    window_xyz, anchor_valid, comp_safe = c["window_xyz"], c["anchor_valid"], c["comp_safe"]
    W, N, _ = window_xyz.shape
    dev = window_xyz.device
    pos = anchor_pos + track_dir * s
    pos_c = min(max(pos, 0), W - 1)
    prev_c = min(max(pos - track_dir, 0), W - 1)
    in_win = 0 <= pos < W
    nxt_valid = c["window_valid"][pos_c] & in_win
    stopped = carry["stopped"]
    if not (in_win and bool(nxt_valid.any()) and bool((~stopped).any())):
        # inactive: every masked output keeps its value; the velocity carried
        # to the next step becomes the one stored at this slot
        carry.update(last_velo=carry["comp_velos"][:, pos_c], has_last_velo=True)
        return carry
    nxt_xyz = window_xyz[pos]
    ci = torch.clamp(comp_safe, 0, C - 1)
    cur_xyz, last_velo = carry["cur_xyz"], carry["last_velo"]
    has_last_velo = carry["has_last_velo"]
    T_cum = carry["transforms"][:, prev_c].clone()

    # velocity warm start
    trans = torch.where((~stopped & has_last_velo)[:, None], last_velo,
                        torch.zeros_like(last_velo))
    cur_xyz = cur_xyz + trans[ci] * track_dir
    T_cum[:, :3, 3] += trans * track_dir

    # the registration pyramid, coarse to fine
    l1_err = edge_ratio = None
    for li, (vx, vy, vz, radius, sdelta) in enumerate(levels):
        vs = (vx, vy, vz)
        m_xyz, m_comp, m_stat, m_valid = _grid_sample_masked(
            cur_xyz, c["anchor_comp"], c["anchor_stationary"], anchor_valid, vs)
        r_xyz, _, _, r_valid = _grid_sample_masked(
            nxt_xyz, torch.zeros(N, dtype=torch.int64, device=dev),
            torch.zeros(N, dtype=torch.bool, device=dev), nxt_valid, vs)
        T_l, l1_l, ratio_l, _ = register_to_next_frame(
            m_xyz, m_comp, m_valid & ~m_stat, r_xyz, r_valid, C, radius,
            angle_regularizer=c["angle_regularizer"], max_iter=max_icp_iter,
            stopping_delta=sdelta, cell_cap=c["cell_cap"])
        if li == 0:
            edge_ratio = ratio_l
        if li == len(levels) - 1:
            l1_err = l1_l
        cur_xyz = geometry.mv(T_l[ci, :3, :3], cur_xyz) + T_l[ci, :3, 3]
        T_cum = geometry.mm(T_l, T_cum)

    # component centers and velocity
    _, centers = _comp_stats(cur_xyz, comp_safe, anchor_valid, C)
    comp_centers = carry["comp_centers"].clone()
    comp_velos = carry["comp_velos"].clone()
    comp_center_diffs = carry["comp_center_diffs"].clone()
    comp_centers[:, pos] = centers
    zero = torch.zeros((), dtype=cur_xyz.dtype, device=dev)
    velo = segment_ops.segment_mean(
        torch.where(anchor_valid[:, None], (cur_xyz - carry["last_xyz"]) * track_dir, zero),
        torch.where(anchor_valid, comp_safe, torch.full_like(comp_safe, C)), C + 1)[:C]
    velo[:, 2] = 0.0
    comp_velos[:, pos] = velo
    if track_dir == -1 and s == 1:  # the first backward step seeds the anchor's velocity
        comp_velos[:, anchor_pos] = velo
    comp_center_diffs[:, pos] = (comp_centers[:, pos] - comp_centers[:, prev_c]) * track_dir

    # temporal smoothing over the walked span
    w_idx = torch.arange(W, device=dev)
    lo, hi = min(anchor_pos + track_dir, pos), max(anchor_pos + track_dir, pos)
    comp_velos = _smooth_velos(comp_velos, comp_center_diffs, (w_idx >= lo) & (w_idx <= hi))
    delta = comp_velos[:, pos] - velo
    velo = comp_velos[:, pos]
    cur_xyz = cur_xyz + delta[ci] * track_dir
    T_cum[:, :3, 3] += delta * track_dir
    transforms = carry["transforms"].clone()
    transforms[:, pos] = T_cum

    # stopping rules
    diam = c["comp_diameter"]
    new_stopped = stopped | (l1_err > c["reg_error_coeff"] * diam * (1.0 + c["dist_comp"]))
    new_stopped = new_stopped | (edge_ratio < 0.5)
    moving = carry["moving"]
    if min_move_frame >= 1 and s == min_move_frame:
        moved = torch.linalg.vector_norm(comp_centers[:, pos] - comp_centers[:, anchor_pos],
                                         dim=-1)
        moving = moving & (moved > 0.08 * diam)
    dev_v = torch.linalg.vector_norm(velo - last_velo, dim=-1)
    new_stopped = new_stopped | (has_last_velo & (dev_v > 0.24 * diam))
    prev_v = comp_velos[:, prev_c]
    nrm = torch.clamp(torch.linalg.vector_norm(velo, dim=-1)
                      * torch.linalg.vector_norm(prev_v, dim=-1), min=1e-6)
    ang = torch.rad2deg(torch.arccos(torch.clamp((velo * prev_v).sum(-1) / nrm, -1.0, 1.0)))
    new_stopped = new_stopped | (
        has_last_velo & (ang > c["angle_threshold_deg"])
        & (torch.linalg.vector_norm(velo[:, :2], dim=-1) > c["angle_velo_exempt"]))
    key = "reach_min" if track_dir == -1 else "reach_max"
    carry[key] = torch.where(~new_stopped, torch.full_like(carry[key], pos), carry[key])

    # nearest-neighbour extraction of the step frame's member points
    grid = hash_graph.build_hash_grid(_zero_frame(cur_xyz), c["nn_radius"], anchor_valid)
    nn_idx, _, nn_ok = hash_graph.radius_neighbors(
        grid, _zero_frame(nxt_xyz), c["nn_radius"], 1, query_valid=nxt_valid,
        cell_cap=c["cell_cap"])
    src, ok = nn_idx[:, 0], nn_ok[:, 0]
    src_comp = torch.where(ok, c["anchor_comp"][torch.clamp(src, 0, N - 1)],
                           torch.full_like(src, -1))
    keep = ok & (src_comp >= 0) & ~new_stopped[torch.clamp(src_comp, 0, C - 1)]
    extract_src = carry["extract_src"].clone()
    extract_src[pos] = torch.where(keep, src, extract_src[pos])
    reg_errors = carry["reg_errors"].clone()
    edge_ratios = carry["edge_ratios"].clone()
    reg_errors[:, pos] = l1_err
    edge_ratios[:, pos] = edge_ratio
    carry.update(
        cur_xyz=cur_xyz, last_xyz=cur_xyz, stopped=new_stopped, moving=moving, last_velo=velo,
        has_last_velo=True, transforms=transforms, comp_velos=comp_velos,
        comp_centers=comp_centers, comp_center_diffs=comp_center_diffs,
        reg_errors=reg_errors, edge_ratios=edge_ratios, extract_src=extract_src)
    return carry


def _make_consts(window_xyz, window_valid, anchor_comp, anchor_stationary, comp_diameter,
                 comp_deg, C, anchor_pos, nn_radius, angle_regularizer, reg_error_coeff,
                 angle_threshold_deg, angle_velo_exempt, cell_cap):
    anchor_valid = window_valid[anchor_pos]
    anchor_comp = anchor_comp.long()
    dist_comp = torch.zeros(C, dtype=torch.float32, device=window_xyz.device)
    for lo, hi, v in ((0, 10, 1.0), (10, 40, 0.5), (40, 100, 0.3), (100, 200, 0.2),
                      (200, 400, 0.1)):
        dist_comp = torch.where((comp_deg >= lo) & (comp_deg < hi), torch.full_like(dist_comp, v),
                                dist_comp)
    return dict(
        window_xyz=window_xyz, window_valid=window_valid, anchor_comp=anchor_comp,
        anchor_stationary=anchor_stationary, comp_diameter=comp_diameter, dist_comp=dist_comp,
        comp_safe=torch.where(anchor_valid & (anchor_comp >= 0), anchor_comp,
                              torch.full_like(anchor_comp, C)),
        anchor_valid=anchor_valid, nn_radius=float(nn_radius),
        angle_regularizer=float(angle_regularizer), reg_error_coeff=float(reg_error_coeff),
        angle_threshold_deg=float(angle_threshold_deg),
        angle_velo_exempt=float(angle_velo_exempt), cell_cap=int(cell_cap))


def _init_arrays(window_xyz, comp_safe, anchor_valid, C, anchor_pos):
    W, N, _ = window_xyz.shape
    dev = window_xyz.device
    _, center0 = _comp_stats(window_xyz[anchor_pos], comp_safe, anchor_valid, C)
    comp_centers = torch.zeros((C, W, 3), dtype=torch.float32, device=dev)
    comp_centers[:, anchor_pos] = center0
    return dict(
        transforms=torch.eye(4, dtype=torch.float32, device=dev).expand(C, W, 4, 4).clone(),
        comp_velos=torch.zeros((C, W, 3), dtype=torch.float32, device=dev),
        comp_centers=comp_centers,
        comp_center_diffs=torch.zeros((C, W, 3), dtype=torch.float32, device=dev),
        reg_errors=torch.zeros((C, W), dtype=torch.float32, device=dev),
        edge_ratios=torch.zeros((C, W), dtype=torch.float32, device=dev),
        extract_src=torch.full((W, N), -1, dtype=torch.int64, device=dev),
        reach_min=torch.full((C,), anchor_pos, dtype=torch.int64, device=dev),
        reach_max=torch.full((C,), anchor_pos, dtype=torch.int64, device=dev),
    )


def _finalize(g, comp_valid0, anchor_pos, min_move_frame, moving):
    out = dict(g)
    out["valid_final"] = comp_valid0 & ((g["reach_max"] >= anchor_pos + min_move_frame)
                                        | (g["reach_min"] <= anchor_pos - min_move_frame))
    out["moving"] = moving
    del out["comp_center_diffs"]
    return out


def track_window_stepped(window_xyz, window_valid, anchor_comp, anchor_stationary,
                         comp_valid0, comp_diameter, comp_deg, num_components, interval,
                         levels, nn_radius, angle_regularizer, reg_error_coeff,
                         angle_threshold_deg, min_move_frame, max_icp_iter=80,
                         angle_velo_exempt=0.05, cell_cap=hash_graph.DEFAULT_CELL_CAP):
    """The walk, both directions, on the device.

    window_xyz [W, N, 3] / window_valid [W, N]: the frames around the anchor
    (slot ``interval``); anchor_comp / anchor_stationary [N]: the anchor's
    component ids (-1 none) and stationary flags; comp_valid0, comp_diameter,
    comp_deg [C]. ``levels``: (vx, vy, vz, radius, stopping_delta) per
    pyramid level. Returns a dict of device tensors: transforms [C, W, 4, 4],
    comp_velos, comp_centers [C, W, 3], reg_errors, edge_ratios [C, W],
    extract_src [W, N] (the anchor row each point was extracted from, -1
    none), reach_min, reach_max [C], moving, valid_final [C]."""
    C = num_components
    anchor_pos = interval
    consts = _make_consts(window_xyz, window_valid, anchor_comp, anchor_stationary,
                          comp_diameter, comp_deg, C, anchor_pos, nn_radius, angle_regularizer,
                          reg_error_coeff, angle_threshold_deg, angle_velo_exempt, cell_cap)
    g = _init_arrays(window_xyz, consts["comp_safe"], consts["anchor_valid"], C, anchor_pos)
    anchor_xyz = window_xyz[anchor_pos]
    moving_final = comp_valid0.clone()
    for track_dir in (-1, 1):
        has_lv = track_dir == 1 and bool((g["comp_velos"][:, anchor_pos] != 0).any())
        carry = dict(g, cur_xyz=anchor_xyz, last_xyz=anchor_xyz, stopped=~comp_valid0,
                     moving=comp_valid0.clone(), last_velo=g["comp_velos"][:, anchor_pos],
                     has_last_velo=has_lv)
        for s in range(1, interval + 1):
            carry = _step_impl(consts, carry, track_dir, s, C=C, anchor_pos=anchor_pos,
                               levels=levels, max_icp_iter=max_icp_iter,
                               min_move_frame=min_move_frame)
        moving_final = carry["moving"]
        g = {k: carry[k] for k in g}
    return _finalize(g, comp_valid0, anchor_pos, min_move_frame, moving_final)


# JAX's whole-walk program computes the same walk (see the module docstring)
track_window = track_window_stepped
