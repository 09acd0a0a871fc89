"""Cluster tracking (counterpart of
pcseqlearning_tpu.preprocessing.cluster_tracking).

For every TRACK_INTERVAL-th frame, every proposed component is tracked
+-TRACK_INTERVAL frames by one of three walks, chosen as the JAX module
chooses them:

  * ``WALK_MODE="batched"`` (default): the component-tiled ICP walk
    (``tracking_batched``, the ``pair_min`` kernel);
  * ``WALK_MODE="host"`` or ``DEVICE_WALK=False``: the reference-shaped
    walk (``track_frame_host``), one registration pyramid per frame step
    over grid-subsampled whole frames (``registration``), nearest-neighbour
    member extraction through the hash grid; its per-component [C]/[C, F]
    bookkeeping is host NumPy, its point-scale work runs on the device;
  * ``WALK_MODE`` in ("stepped", "full", "device"): the [W, N]-window walk
    (``tracking_device``), unless bucket_size(n) * bucket_size(C, 64) of the
    anchor frame exceeds STEP_COMPILE_BUDGET (default 2^21), which takes the
    host walk.

``REGISTRATION.SOLVER`` "GD" / "GDSolver" makes the host walk register with
the gradient-descent solver (``solver_utils``) instead of ICP. Member points
are then re-claimed from the full-resolution above-ground cloud by one
sorted-grid nearest-neighbour scan per tracked window (the ``radius_scan``
kernel, k=1, radius NN_GRAPH.RADIUS * 1.732, z-band filtered) and scored
against the GT boxes.

The per-sequence tables (per-frame point tables, stationary flags, box
assignment of the full cloud) are built once on the device; the per-window
bookkeeping and box IoU accounting stay on the host, as in the JAX module.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..ops import boxes as box_ops
from ..ops import geometry, hash_graph, segment_ops
from ..ops.sorted_grid import radius_neighbors_sorted
from ..utils import telemetry
from ..utils.edict import EDict
from ..utils.frame_index import FrameIndex
from ..utils.padding import bucket_size
from .cluster_proposal import frame_table
from .registration import _zero_frame, register_to_next_frame
from .solver_utils import gd_register_components
from .tracking_batched import (pack_components_device, track_window_batched_dispatch,
                               track_window_batched_drain)
from .tracking_device import _sample_frame_kernel, _smooth_velos, track_window_stepped

WALKS = ("host", "device", "batched")


def comp_stats(xyz, comp, C):
    """Per-component count, centroid (one residual-refinement pass against
    float32 cancellation) and diameter (2x max distance to the centroid)."""
    m = comp >= 0
    seg = torch.where(m, comp, torch.full_like(comp, C))
    cc = torch.clamp(comp, 0, C - 1)
    zero = torch.zeros((), dtype=xyz.dtype, device=xyz.device)
    cnt = segment_ops.segment_count(seg, C + 1)[:C]
    ctr = segment_ops.segment_sum(torch.where(m[:, None], xyz, zero), seg, C + 1)[:C]
    ctr = ctr / torch.clamp(cnt[:, None], min=1.0)
    res = segment_ops.segment_sum(torch.where(m[:, None], xyz - ctr[cc], zero), seg, C + 1)[:C]
    ctr = ctr + res / torch.clamp(cnt[:, None], min=1.0)
    r = torch.linalg.vector_norm(xyz - ctr[cc], dim=-1)
    diam = 2.0 * segment_ops.segment_max(torch.where(m, r, torch.full_like(r, -1.0)), seg,
                                         C + 1)[:C]
    return cnt, ctr, torch.clamp(diam, min=0.0)


def box_assign(pts, boxes, bvalid):
    """Per-point owning box (first containing box, -1 outside all) and
    per-box point counts, batched over frames: pts [F, N, 3], boxes
    [F, B, 7], bvalid [F, B] -> (gid [F, N], counts [F, B])."""
    bp = box_ops.points_in_boxes(pts, boxes) & bvalid[:, :, None]
    gid = torch.where(bp.any(dim=1), bp.to(torch.uint8).argmax(dim=1),
                      torch.full((bp.shape[0], bp.shape[2]), -1, dtype=torch.int64,
                                 device=pts.device))
    F, B = boxes.shape[:2]
    fo = torch.arange(F, device=pts.device)[:, None]
    cnt = segment_ops.segment_count(
        torch.where(gid >= 0, fo * B + gid, torch.full_like(gid, F * B)).reshape(-1), F * B,
        dtype=torch.int64).reshape(F, B)
    return gid, cnt


def window_claim(refs, ref_comp, q, qv, radius, F, X, Y):
    """Claim every query point of a tracked window for the component of its
    nearest extracted point (same frame, within ``radius``), kept only when
    that point's z is within (-0.05, 0.5) m above the query's. refs [E, 4]
    and q [M, 4] are (frame, x, y, z) rows. Returns [M] int64 (-1 none)."""
    idx, _, mask = radius_neighbors_sorted(refs, q, radius, 1, F=F, X=X, Y=Y, query_valid=qv)
    i0 = torch.clamp(idx[:, 0], 0, refs.shape[0] - 1)
    zdiff = refs[i0, 3] - q[:, 3]
    ok = mask[:, 0] & (zdiff < 0.5) & (zdiff > -0.05)
    return torch.where(ok, ref_comp[i0], torch.full_like(ref_comp[i0], -1))


def _component_stats(xyz, comp, valid, num_components):
    """Per-component point count, center and diameter (2x the largest
    distance to the center) of the valid rows with a component."""
    C = num_components
    ok = valid & (comp >= 0)
    cs = torch.where(ok, comp.long(), torch.full_like(comp, C, dtype=torch.int64))
    deg = segment_ops.segment_count(cs, C + 1)[:C]
    center = segment_ops.segment_mean(xyz, cs, C + 1)[:C]
    d = torch.linalg.vector_norm(xyz - center[torch.clamp(cs, 0, C - 1)], dim=-1)
    d = torch.where(ok, d, torch.full_like(d, -float("inf")))
    diam = segment_ops.segment_max_or(d, cs, C + 1, 0.0)[:C]
    return deg, center, torch.clamp(diam, min=0.0) * 2.0


def _nn_match(ref_xyz, ref_valid, query_xyz, query_valid, radius,
              cell_cap=hash_graph.DEFAULT_CELL_CAP):
    """Nearest reference within ``radius`` of each query through the hash
    grid: (idx [M], ok [M])."""
    grid = hash_graph.build_hash_grid(_zero_frame(ref_xyz), radius, ref_valid)
    idx, _, mask = hash_graph.radius_neighbors(grid, _zero_frame(query_xyz), radius, 1,
                                               query_valid=query_valid, cell_cap=cell_cap)
    return idx[:, 0], mask[:, 0]


def dist_compensate(comp_deg):
    """Registration-error slack for small components."""
    thresholds = [0, 10, 40, 100, 200, 400, 10 ** 7]
    comp_dist = [1.0, 0.5, 0.3, 0.2, 0.1, 0.0]
    out = np.zeros_like(comp_deg, dtype=np.float32)
    for i in range(1, len(thresholds)):
        m = (comp_deg >= thresholds[i - 1]) & (comp_deg < thresholds[i])
        out[m] = comp_dist[i - 1]
    return out


def _pad(x, cap, fill):
    """Pad axis 0 of a device tensor to ``cap`` rows: (padded, valid)."""
    n = x.shape[0]
    out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    out[:n] = x
    valid = torch.zeros(cap, dtype=torch.bool, device=x.device)
    valid[:n] = True
    return out, valid


def _anchor_components(frame, C):
    """Per-component count, diameter and initial validity of the anchor
    frame (host NumPy, [C] bucketed)."""
    deg = np.bincount(frame.component, minlength=C).astype(np.float32)[:C]
    ctr = np.zeros((C, 3), np.float32)
    for d in range(3):
        ctr[:, d] = np.bincount(frame.component, weights=frame.xyz[:, d], minlength=C)[:C]
    ctr[deg > 0] /= deg[deg > 0, None]
    rr = np.linalg.norm(frame.xyz - ctr[frame.component], axis=-1)
    diam = np.zeros(C, np.float32)
    np.maximum.at(diam, frame.component, rr)
    diam *= 2
    return deg, diam, (deg > 0.5) & (diam < 12.5)


def _save(path, table):
    """Pickle ``table`` (host NumPy arrays) as a plain dict, as the JAX
    module does: a reader needs neither torch nor a card."""
    with open(path, "wb") as f:
        pickle.dump(dict(table), f)


class ClusterTracking:
    """Config keys as in the JAX module (WALK_MODE, DEVICE_WALK,
    STEP_COMPILE_BUDGET, REGISTRATION.SOLVER among them). Extra port keys,
    which ``convert.config_from_jax`` fills from the JAX side's import-time
    environment: ANGLE_VELO_EXEMPT (default 0.05), FINE_CANDIDATES (default
    256) and CELL_CAP (default 48, the hash grid's per-probe scan cap).
    ``walk_frames`` counts, per call, the tracked frames each walk handled.

    With DIR, as in the JAX module: a sequence whose ``DIR/<sequence>/all.pkl``
    exists is skipped; otherwise every tracked frame's extraction goes to
    ``DIR/<sequence>/<frame:03d>_<component key>.pkl`` and the sequence's box
    table to ``all.pkl``, as pickled dicts of NumPy arrays under the JAX
    module's keys (``tools/parse_cluster_tracking_results.py`` reads them)."""

    def __init__(self, model_cfg, runtime_cfg=None, device="cuda"):
        self.model_cfg = EDict(model_cfg)
        cfg = self.model_cfg
        self.device = resolve_device(device)
        reg_cfg = cfg["REGISTRATION"]
        self.stopping_delta = [float(s) for s in reg_cfg["STOPPING_DELTA"]]
        self.radius_list = [float(r) for r in reg_cfg["GRAPH"]["RADIUS"]]
        self.voxel_size_list = [list(map(float, v)) for v in reg_cfg["VOXEL_SIZE"]]
        self.gd_solver = str(reg_cfg.get("SOLVER", "ICP")) in ("GD", "GDSolver")
        self.angle_regularizer = float(cfg.get("ANGLE_REGULARIZER", 10))
        self.nn_radius = float(cfg["NN_GRAPH"]["RADIUS"])
        params = cfg.get("TRACKING_PARAMS", {})
        self.reg_error_coeff = float(params.get("REGISTRATION_ERROR_COEFFICIENT", 0.13))
        self.track_interval = int(params.get("TRACK_INTERVAL", 10))
        self.angle_threshold = float(params.get("ANGLE_THRESHOLD", 45))
        self.min_move_frame = int(params.get("MIN_MOVE_FRAME", 6))
        self.component_keys = list(cfg["COMPONENT_KEYS"])
        self.max_icp_iter = int(cfg.get("MAX_ICP_ITER", 80))
        self.device_walk = bool(cfg.get("DEVICE_WALK", True))
        self.angle_velo_exempt = float(cfg.get("ANGLE_VELO_EXEMPT", 0.05))
        self.fine_candidates = int(cfg.get("FINE_CANDIDATES", 256))
        self.cell_cap = int(cfg.get("CELL_CAP", hash_graph.DEFAULT_CELL_CAP))
        self.walk_frames = dict.fromkeys(WALKS, 0)

    # ------------------------------------------------------------------
    def _levels(self):
        return tuple(
            (float(v[0]), float(v[1]), float(v[2]), float(r), float(sd))
            for v, r, sd in zip(self.voxel_size_list, self.radius_list, self.stopping_delta))

    def track_frame(self, seq_points, frame, seq_boxes, seq_index):
        """Walk-mode dispatch: the JAX module's rule, counted in
        ``walk_frames``."""
        mode = str(self.model_cfg.get("WALK_MODE", "batched"))
        if not self.device_walk or mode == "host":
            walk = "host"
        elif mode in ("stepped", "full", "device"):
            num_components = int(frame.component.max()) + 1 if len(frame.component) else 0
            n_cap = bucket_size(max(len(frame.xyz), 1))
            c_cap = bucket_size(max(num_components, 1), base=64)
            budget = int(self.model_cfg.get("STEP_COMPILE_BUDGET", 1 << 21))
            walk = "host" if n_cap * c_cap > budget else "device"
        else:
            walk = "batched"
        self.walk_frames[walk] += 1
        if walk == "host":
            return self.track_frame_host(seq_points, frame, seq_boxes, seq_index)
        if walk == "device":
            return self.track_frame_device(seq_points, frame, seq_boxes, seq_index)
        return self.track_frame_batched(seq_points, frame, seq_boxes, seq_index)

    def track_frame_batched(self, seq_points, frame, seq_boxes, seq_index):
        """Walk dispatch + finish for one tracked frame."""
        h = self.track_frame_batched_dispatch(seq_points, frame, seq_boxes, seq_index)
        if h is None:
            return None
        return self.track_frame_batched_finish(h, seq_points)

    def track_frame_batched_dispatch(self, seq_points, frame, seq_boxes, seq_index):
        """Pack the anchor frame's components into tiles, slice the [W, N]
        frame window from the resident per-frame table and run the walk."""
        num_components = int(frame.component.max()) + 1 if len(frame.component) else 0
        if num_components == 0:
            return None
        dev = self.device
        frame_id = int(frame.frame[0])
        iv = self.track_interval
        frame_rows = [seq_index.rows(frame_id - iv + w) for w in range(2 * iv + 1)]
        anchor = iv
        na = len(frame.xyz)
        tab, tval, n_cap = self._seq_tab
        F_all = tab.shape[0]
        fids = np.arange(frame_id - iv, frame_id + iv + 1)
        in_rng = torch.as_tensor((fids >= 0) & (fids < F_all), device=dev)
        sel = torch.as_tensor(np.clip(fids, 0, F_all - 1), device=dev)
        window_valid = tval[sel] & in_rng[:, None]
        window_xyz = torch.where(window_valid[..., None], tab[sel][..., 1:4],
                                 torch.full((), 1e8, device=dev))
        window_stat = self._stat_tab[sel] & window_valid

        C = bucket_size(num_components, base=64)
        deg, diam, comp_valid0 = _anchor_components(frame, C)

        cfg = self.model_cfg
        P = int(cfg.get("TRACK_POINTS_PER_COMPONENT", 256))
        P_ext = int(cfg.get("TRACK_EXTRACT_POINTS", 512))
        Q = min(int(cfg.get("TRACK_NUM_CANDIDATES", 512)), n_cap)
        comp_p = np.full(n_cap, -1, np.int64)
        comp_p[:na] = frame.component
        comp_d = torch.as_tensor(comp_p, device=dev)
        a_xyz, a_valid = window_xyz[anchor], window_valid[anchor]
        comp_xyz, comp_pmask = pack_components_device(
            a_xyz, comp_d, a_valid & ~window_stat[anchor], C, P)
        comp_ext, ext_mask = pack_components_device(a_xyz, comp_d, a_valid, C, P_ext)
        levels = self._levels()
        g = track_window_batched_dispatch(
            window_xyz, window_valid, window_stat, comp_xyz, comp_pmask,
            torch.as_tensor(comp_valid0, device=dev), torch.as_tensor(diam, device=dev),
            torch.as_tensor(deg, device=dev),
            frame_nonempty=[len(r) > 0 for r in frame_rows],
            interval=iv, levels=levels, num_candidates=Q,
            nn_radius=self.nn_radius, angle_regularizer=self.angle_regularizer,
            reg_error_coeff=self.reg_error_coeff, angle_threshold_deg=self.angle_threshold,
            min_move_frame=self.min_move_frame, max_icp_iter=self.max_icp_iter,
            sel_margin=float(cfg.get("SELECTION_MARGIN", max(self.radius_list) + 4.0)),
            comp_ext=comp_ext, ext_mask=ext_mask,
            fine_candidates=self.fine_candidates, angle_velo_exempt=self.angle_velo_exempt,
        )
        return EDict(g=g, frame=frame, frame_id=frame_id, frame_rows=frame_rows,
                     num_components=num_components, anchor_slot=anchor)

    def track_frame_batched_finish(self, h, seq_points):
        """Assemble the extracted points: the kept anchor members plus every
        window frame's claims of components that stayed valid."""
        out = track_window_batched_drain(h.g)
        frame, frame_id, anchor = h.frame, h.frame_id, h.anchor_slot
        num_components = h.num_components
        valid_final = out["valid_final"][:num_components]
        moving = out["moving"][:num_components]
        keep = valid_final[frame.component]
        ex_xyzf = [np.concatenate([np.full((keep.sum(), 1), frame_id, np.float32),
                                   frame.xyz[keep]], axis=1)]
        ex_comp = [frame.component[keep]]
        ex_seg = [frame.segmentation_label[keep]]
        ex_orig = [frame.original_indices[keep]]
        for w, rows in enumerate(h.frame_rows):
            if w == anchor or len(rows) == 0:
                continue
            comp = out["extract_comp"][w, :len(rows)].astype(np.int64)
            ok = (comp >= 0) & (comp < num_components)
            ok &= valid_final[np.clip(comp, 0, num_components - 1)]
            if not ok.any():
                continue
            sel = np.nonzero(ok)[0]
            ex_xyzf.append(np.concatenate([
                np.full((len(sel), 1), frame_id - self.track_interval + w, np.float32),
                seq_points.xyz[rows[sel]]], axis=1))
            ex_comp.append(comp[sel])
            ex_seg.append(seq_points.segmentation_label[rows[sel]])
            ex_orig.append(rows[sel])
        extracted = EDict(
            fxyz=np.concatenate(ex_xyzf, axis=0),
            component=np.concatenate(ex_comp, axis=0),
            segmentation_label=np.concatenate(ex_seg, axis=0),
            original_indices=np.concatenate(ex_orig, axis=0),
        )
        extracted.moving = (moving[extracted.component] if len(extracted.component)
                            else np.zeros(0, bool))
        extracted.transforms = out["transforms"][:num_components]
        extracted.reg_errors = out["reg_errors"][:num_components]
        extracted.comp_edge_ratios = out["edge_ratios"][:num_components]
        return extracted

    # ------------------------------------------------------------------
    def track_frame_device(self, seq_points, frame, seq_boxes, seq_index):
        """The [W, N]-window walk (``tracking_device``): the window sliced
        from the resident per-frame table at the window's own row capacity,
        the outputs assembled into the host walk's extracted-points format."""
        num_components = int(frame.component.max()) + 1 if len(frame.component) else 0
        if num_components == 0:
            return None
        dev = self.device
        frame_id = int(frame.frame[0])
        iv = self.track_interval
        W = 2 * iv + 1
        frame_rows = [seq_index.rows(frame_id - iv + w) for w in range(W)]
        na = len(frame.xyz)
        n_cap = bucket_size(max([na] + [len(r) for r in frame_rows]))
        tab, tval, _ = self._seq_tab
        F_all = tab.shape[0]
        fids = np.arange(frame_id - iv, frame_id + iv + 1)
        in_rng = torch.as_tensor((fids >= 0) & (fids < F_all), device=dev)
        sel = torch.as_tensor(np.clip(fids, 0, F_all - 1), device=dev)
        window_valid = tval[sel][:, :n_cap] & in_rng[:, None]
        window_xyz = torch.where(window_valid[..., None], tab[sel][:, :n_cap, 1:4],
                                 torch.full((), 1e8, device=dev))
        anchor_comp = np.full(n_cap, -1, np.int64)
        anchor_comp[:na] = frame.component
        anchor_stat = np.zeros(n_cap, bool)
        anchor_stat[:na] = frame.stationary
        C = bucket_size(num_components, base=64)
        deg, diam, comp_valid0 = _anchor_components(frame, C)
        out = track_window_stepped(
            window_xyz, window_valid, torch.as_tensor(anchor_comp, device=dev),
            torch.as_tensor(anchor_stat, device=dev), torch.as_tensor(comp_valid0, device=dev),
            torch.as_tensor(diam, device=dev), torch.as_tensor(deg, device=dev),
            num_components=C, interval=iv, levels=self._levels(), nn_radius=self.nn_radius,
            angle_regularizer=self.angle_regularizer, reg_error_coeff=self.reg_error_coeff,
            angle_threshold_deg=self.angle_threshold, min_move_frame=self.min_move_frame,
            max_icp_iter=self.max_icp_iter, angle_velo_exempt=self.angle_velo_exempt,
            cell_cap=self.cell_cap)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        valid_final = out["valid_final"][:num_components]
        moving = out["moving"][:num_components]

        keep = valid_final[frame.component]
        ex_xyzf = [np.concatenate([np.full((keep.sum(), 1), frame_id, np.float32),
                                   frame.xyz[keep]], axis=1)]
        ex_comp = [frame.component[keep]]
        ex_seg = [frame.segmentation_label[keep]]
        ex_orig = [frame.original_indices[keep]]
        for w, rows in enumerate(frame_rows):
            if w == iv or len(rows) == 0:
                continue
            src = out["extract_src"][w, :len(rows)]
            ok = src >= 0
            if not ok.any():
                continue
            comp = anchor_comp[np.clip(src, 0, n_cap - 1)]
            ok &= (comp >= 0) & valid_final[np.clip(comp, 0, num_components - 1)]
            sel_w = np.nonzero(ok)[0]
            ex_xyzf.append(np.concatenate([
                np.full((len(sel_w), 1), frame_id - iv + w, np.float32),
                seq_points.xyz[rows[sel_w]]], axis=1))
            ex_comp.append(comp[sel_w])
            ex_seg.append(seq_points.segmentation_label[rows[sel_w]])
            ex_orig.append(rows[sel_w])
        extracted = EDict(
            fxyz=np.concatenate(ex_xyzf, axis=0),
            component=np.concatenate(ex_comp, axis=0),
            segmentation_label=np.concatenate(ex_seg, axis=0),
            original_indices=np.concatenate(ex_orig, axis=0),
        )
        extracted.moving = (moving[extracted.component] if len(extracted.component)
                            else np.zeros(0, bool))
        extracted.transforms = out["transforms"][:num_components]
        extracted.reg_errors = out["reg_errors"][:num_components]
        extracted.comp_edge_ratios = out["edge_ratios"][:num_components]
        return extracted

    # ------------------------------------------------------------------
    @staticmethod
    def _sample_frame(xyz, comp, stationary, voxel_size):
        """Voxel subsample of one frame's device rows: (mean xyz [V, 3],
        median component [V], stationary [V]) over its V occupied voxels in
        lexicographic voxel order."""
        n = xyz.shape[0]
        mean, med_comp, stat, occ = _sample_frame_kernel(
            _zero_frame(xyz), comp, stationary, torch.ones(n, dtype=torch.bool, device=xyz.device),
            voxel_size)
        return mean[occ][:, 1:4], med_comp[occ], stat[occ]

    def _register_level(self, cur_xyz, cur_comp, cur_stat, nxt_xyz, nxt_stat, num_components,
                        level):
        """One pyramid level of the host walk: subsample both frames, drop
        stationary voxels, pad to the bucket ladder, register by ICP or the
        GD solver. Returns (T [nc, 4, 4] on the device, and T, l1, ratio [nc]
        as host arrays)."""
        vs = self.voxel_size_list[level]
        mx, mc, m_stat = self._sample_frame(cur_xyz, cur_comp, cur_stat, vs)
        rx, _, r_stat = self._sample_frame(
            nxt_xyz, torch.zeros(nxt_xyz.shape[0], dtype=torch.int64, device=nxt_xyz.device),
            nxt_stat, vs)
        m_keep = ~m_stat & (mc >= 0)
        mx, mc, rx = mx[m_keep], mc[m_keep], rx[~r_stat]
        mx_p, m_valid = _pad(mx, bucket_size(max(mx.shape[0], 1)), 1e8)
        mc_p, _ = _pad(mc, mx_p.shape[0], -1)
        rx_p, r_valid = _pad(rx, bucket_size(max(rx.shape[0], 1)), 1e8)
        C = bucket_size(num_components, base=64)
        radius = self.radius_list[level]
        if self.gd_solver:
            T, l1, ratio = gd_register_components(mx_p, mc_p, m_valid, rx_p, r_valid, C, radius)
        else:
            T, l1, ratio, _ = register_to_next_frame(
                mx_p, mc_p, m_valid, rx_p, r_valid, C, radius,
                angle_regularizer=self.angle_regularizer, max_iter=self.max_icp_iter,
                stopping_delta=self.stopping_delta[level], cell_cap=self.cell_cap)
        T = T[:num_components]
        return (T, T.cpu().numpy(), l1[:num_components].cpu().numpy(),
                ratio[:num_components].cpu().numpy())

    def track_frame_host(self, seq_points, frame, seq_boxes, seq_index):
        """The reference-shaped walk: frame by frame in each direction, the
        registration pyramid over whole subsampled frames, velocity
        smoothing, the stopping rules and nearest-neighbour extraction of the
        step frame's member points."""
        num_components = nc = int(frame.component.max()) + 1 if len(frame.component) else 0
        if num_components == 0:
            return None
        dev = self.device
        frame_id = int(frame.frame[0])
        frames_arr = seq_points.frame
        min_frame_id = max(int(frames_arr.min()), frame_id - self.track_interval)
        max_frame_id = min(int(frames_arr.max()), frame_id + self.track_interval)
        W = max_frame_id - min_frame_id + 1
        tab, _, _ = self._seq_tab
        xyz0 = torch.as_tensor(frame.xyz, dtype=torch.float32, device=dev)
        comp_d = torch.as_tensor(frame.component, device=dev)
        stat0 = torch.as_tensor(frame.stationary, device=dev)
        deg, center0, comp_diameter = (x.cpu().numpy()[:nc] for x in _component_stats(
            xyz0, comp_d, torch.ones(len(frame.component), dtype=torch.bool, device=dev),
            bucket_size(nc, base=64)))
        comp_deg = deg

        transforms = np.tile(np.eye(4, dtype=np.float64), (nc, W, 1, 1))
        F = max_frame_id + 1
        reg_errors = np.zeros((nc, F), np.float32)
        comp_edge_ratios = np.zeros((nc, F), np.float32)
        comp_min_frame_id = np.full(nc, frame_id)
        comp_max_frame_id = np.full(nc, frame_id)
        comp_velos = np.zeros((nc, F, 3), np.float32)
        comp_centers = np.zeros((nc, F, 3), np.float32)
        comp_centers[:, frame_id] = center0
        comp_center_diffs = np.zeros((nc, F, 3), np.float32)
        cnts = np.bincount(frame.component, minlength=nc).astype(np.float32)

        def comp_mean(x):
            """Per-component mean of device rows x (float64 sums, as
            np.bincount forms them), host [nc, 3] float32."""
            out = segment_ops.segment_sum(x.double(), comp_d, nc).cpu().numpy().astype(np.float32)
            out[cnts > 0] /= cnts[cnts > 0, None]
            return out

        # filter out huge / empty components
        valid_comp_mask = (deg > 0.5) & (comp_diameter < 12.5)
        vpm = valid_comp_mask[frame.component]
        ex_xyzf = [np.concatenate([np.full((vpm.sum(), 1), frame_id, np.float32),
                                   frame.xyz[vpm]], axis=1)]
        ex_component = [frame.component[vpm]]
        ex_seglabel = [frame.segmentation_label[vpm]]
        ex_orig_idx = [frame.original_indices[vpm]]
        moving_total = np.ones(nc, bool)

        for track_dir in (-1, 1):
            next_frame_id = frame_id + track_dir
            stopped = ~valid_comp_mask.copy()
            moving = valid_comp_mask.copy()
            cur_xyz = last_xyz = xyz0
            last_velo = None
            if track_dir == 1 and frame_id > 0:
                last_velo = comp_velos[:, frame_id].copy()

            while min_frame_id <= next_frame_id <= max_frame_id and (~stopped).any():
                rows = seq_index.rows(next_frame_id)
                if not len(rows):
                    break
                nxt_xyz = tab[next_frame_id, :len(rows), 1:4]
                nxt_stat = self._stat_tab[next_frame_id, :len(rows)]
                w = next_frame_id - min_frame_id
                transforms[:, w] = transforms[:, w - track_dir]
                if last_velo is not None:
                    trans = last_velo.copy()
                    trans[stopped] = 0
                    cur_xyz = cur_xyz + torch.as_tensor(trans, device=dev)[comp_d] * track_dir
                    transforms[:, w, :3, 3] += trans.astype(np.float64) * track_dir

                l1_reg_error = np.zeros(nc, np.float32)
                comp_edge_ratio = np.zeros(nc, np.float32)
                for lvl in range(len(self.radius_list)):
                    T_d, T, l1, ratio = self._register_level(cur_xyz, comp_d, stat0, nxt_xyz,
                                                             nxt_stat, nc, lvl)
                    if lvl == 0:
                        comp_edge_ratio = ratio
                    if lvl == len(self.radius_list) - 1:
                        l1_reg_error = l1
                    cur_xyz = geometry.mv(T_d[comp_d, :3, :3], cur_xyz) + T_d[comp_d, :3, 3]
                    transforms[:, w] = T.astype(np.float64) @ transforms[:, w]

                comp_centers[:, next_frame_id] = comp_mean(cur_xyz)
                # velocity estimate + smoothing
                comp_velo = comp_mean((cur_xyz - last_xyz) * track_dir)
                comp_velo[:, 2] = 0
                comp_velos[:, next_frame_id] = comp_velo
                comp_center_diffs[:, next_frame_id] = (
                    comp_centers[:, next_frame_id] - comp_centers[:, next_frame_id - track_dir]
                ) * track_dir
                lo, hi = sorted((frame_id + track_dir, next_frame_id))
                span = np.zeros(F, bool)
                span[lo:hi + 1] = True
                comp_velos = _smooth_velos(
                    torch.as_tensor(comp_velos, device=dev),
                    torch.as_tensor(comp_center_diffs, device=dev),
                    torch.as_tensor(span, device=dev)).cpu().numpy().copy()
                delta_velo = comp_velos[:, next_frame_id] - comp_velo
                comp_velo = comp_velos[:, next_frame_id]
                cur_xyz = cur_xyz + torch.as_tensor(delta_velo, device=dev)[comp_d] * track_dir
                transforms[:, w, :3, 3] += delta_velo.astype(np.float64) * track_dir
                last_xyz = cur_xyz

                # stopping rules
                stopped = stopped | (l1_reg_error > self.reg_error_coeff * comp_diameter
                                     * (1 + dist_compensate(comp_deg)))
                stopped = stopped | (comp_edge_ratio < 0.5)
                if (next_frame_id - frame_id) * track_dir == self.min_move_frame:
                    moved = np.linalg.norm(comp_centers[:, next_frame_id]
                                           - comp_centers[:, frame_id], axis=-1)
                    moving = moving & (moved > 0.08 * comp_diameter)
                if last_velo is not None:
                    dev_v = np.linalg.norm(comp_velo - last_velo, axis=-1)
                    stopped = stopped | (dev_v > 0.24 * comp_diameter)
                    prev = comp_velos[:, next_frame_id - track_dir]
                    norm = np.maximum(np.linalg.norm(comp_velo, axis=-1)
                                      * np.linalg.norm(prev, axis=-1), 1e-6)
                    ang = np.degrees(np.arccos(np.clip((comp_velo * prev).sum(-1) / norm, -1, 1)))
                    stopped = stopped | (
                        (ang > self.angle_threshold)
                        & (np.linalg.norm(comp_velos[:, next_frame_id, :2], axis=-1)
                           > self.angle_velo_exempt))
                last_velo = comp_velo
                if next_frame_id == frame_id - 1:
                    comp_velos[:, frame_id] = comp_velo
                if track_dir == -1:
                    comp_min_frame_id[~stopped] = next_frame_id
                else:
                    comp_max_frame_id[~stopped] = next_frame_id

                # nearest-neighbour extraction of the step frame's member points
                rx, r_valid = _pad(cur_xyz, bucket_size(cur_xyz.shape[0]), 1e8)
                qx, q_valid = _pad(nxt_xyz, bucket_size(len(rows)), 1e8)
                nn_idx, nn_ok = _nn_match(rx, r_valid, qx, q_valid, self.nn_radius,
                                          cell_cap=self.cell_cap)
                nn_idx, nn_ok = nn_idx[:len(rows)], nn_ok[:len(rows)]
                src_comp = torch.where(nn_ok, comp_d[torch.clamp(nn_idx, 0, len(frame.xyz) - 1)],
                                       torch.full_like(nn_idx, -1))
                keep = (nn_ok & (src_comp >= 0)
                        & ~torch.as_tensor(stopped, device=dev)[torch.clamp(src_comp, 0, nc - 1)])
                keep = keep.cpu().numpy()
                ex_xyzf.append(np.concatenate([np.full((keep.sum(), 1), next_frame_id, np.float32),
                                               seq_points.xyz[rows[keep]]], axis=1))
                ex_component.append(src_comp.cpu().numpy()[keep])
                ex_seglabel.append(seq_points.segmentation_label[rows[keep]])
                ex_orig_idx.append(rows[keep])

                reg_errors[:, next_frame_id] = l1_reg_error
                comp_edge_ratios[:, next_frame_id] = comp_edge_ratio
                next_frame_id += track_dir

            moving_total = moving_total & moving

        extracted = EDict(
            fxyz=np.concatenate(ex_xyzf, axis=0),
            component=np.concatenate(ex_component, axis=0),
            segmentation_label=np.concatenate(ex_seglabel, axis=0),
            original_indices=np.concatenate(ex_orig_idx, axis=0),
        )
        # final validity: tracked at least min_move_frame in one direction
        valid_comp_mask = valid_comp_mask & (
            (comp_max_frame_id >= frame_id + self.min_move_frame)
            | (comp_min_frame_id <= frame_id - self.min_move_frame))
        keep = valid_comp_mask[extracted.component]
        for k in ("fxyz", "component", "segmentation_label", "original_indices"):
            extracted[k] = extracted[k][keep]
        extracted.moving = (moving_total[extracted.component] if len(extracted.component)
                            else np.zeros(0, bool))
        extracted.transforms = transforms
        extracted.reg_errors = reg_errors
        extracted.comp_edge_ratios = comp_edge_ratios
        return extracted

    # ------------------------------------------------------------------
    def _box_table(self, seq_boxes):
        """Box assignment [F, n_cap] and per-box counts [F, b_cap] of the
        full-resolution cloud, computed once per sequence (frames in chunks
        of 32 bound the [F, B, N] membership temporaries)."""
        tab, _, _ = self._full_tab
        F = tab.shape[0]
        fr = seq_boxes.frame.astype(np.int64)
        b_cap = bucket_size(max(int(np.bincount(fr).max()) if len(fr) else 1, 1), base=32)
        boxes_np = np.zeros((F, b_cap, 7), np.float32)
        bval_np = np.zeros((F, b_cap), bool)
        for fid in range(F):
            b_idx = np.nonzero(fr == fid)[0]
            boxes_np[fid, :len(b_idx)] = seq_boxes.attr[b_idx]
            bval_np[fid, :len(b_idx)] = True
        bx = torch.as_tensor(boxes_np, device=self.device)
        bv = torch.as_tensor(bval_np, device=self.device)
        gts, m1s = [], []
        for i0 in range(0, F, 32):
            g, m1 = box_assign(tab[i0:i0 + 32, :, 1:4], bx[i0:i0 + 32], bv[i0:i0 + 32])
            gts.append(g)
            m1s.append(m1)
        return torch.cat(gts), torch.cat(m1s)

    def extract_traces_and_update_boxes(self, all_points, extracted, seq_boxes):
        """Re-claim member points from the full-resolution cloud for every
        frame of the tracked window and update the per-box best IoU."""
        num_components = int(extracted.component.max()) + 1 if len(extracted.component) else 0
        if num_components == 0:
            return extracted, seq_boxes
        dev = self.device
        ex_frames = np.round(extracted.fxyz[:, 0]).astype(int)
        active_comps = np.unique(extracted.component)
        comp_to_local = np.full(num_components, -1, np.int64)
        comp_to_local[active_comps] = np.arange(len(active_comps))
        claim_r = self.nn_radius * 1.732
        frames_info = []
        for fid in np.unique(ex_frames):
            rm = self._ap_index.rows(fid)
            em = ex_frames == fid
            if len(rm) == 0 or not em.any():
                continue
            frames_info.append((fid, rm, all_points.xyz[rm], extracted.fxyz[em][:, 1:4],
                                extracted.component[em], extracted.moving[em],
                                np.nonzero(seq_boxes.frame == fid)[0]))
        full = EDict(fxyz=[], component=[], segmentation_label=[], original_indices=[],
                     moving=[])
        component_hit = np.zeros(num_components, np.int64)
        claims = []
        if frames_info:
            tab, tval, n_cap = self._full_tab
            rows = torch.as_tensor([int(fi[0]) for fi in frames_info], device=dev)
            refs = torch.as_tensor(extracted.fxyz, dtype=torch.float32, device=dev)
            ref_comp = torch.as_tensor(comp_to_local[extracted.component], device=dev)
            span = float((extracted.fxyz[:, 1:3].max(0) - extracted.fxyz[:, 1:3].min(0)).max())
            XY = 1 << max(int(np.ceil(span / claim_r)) + 3, 2).bit_length()
            comp_all = window_claim(refs, ref_comp, tab[rows].reshape(-1, 4),
                                    tval[rows].reshape(-1), claim_r,
                                    F=2 * self.track_interval + 1, X=XY, Y=XY)
            # the CUDA scan walks whole runs: no claim window is truncated
            telemetry.add("tracking_claim_windows_truncated", 0)
            gt_tab, m1_tab = self._boxtab
            pos = torch.nonzero(comp_all >= 0)[:, 0]
            pos_np = pos.cpu().numpy()
            comp_np = comp_all[pos].cpu().numpy()
            gt_np = gt_tab[rows].reshape(-1)[pos].cpu().numpy()
            m1_np = m1_tab[rows].cpu().numpy()
            fi_np, row_np = pos_np // n_cap, pos_np % n_cap
            for i in range(len(frames_info)):
                mi = fi_np == i
                claims.append((row_np[mi], comp_np[mi], gt_np[mi], m1_np[i]))

        for (fid, rm, ref_xyz, ex_xyz, ex_comp, ex_mov, b_idx), claim in zip(frames_info, claims):
            n_ref = len(ref_xyz)
            rows_j, comp_vals, gt_vals, m1cnt = claim
            comp_local = np.full(n_ref, -1, np.int64)
            comp_local[rows_j] = comp_vals
            comp_np = np.where(
                (comp_local >= 0) & (comp_local < len(active_comps)),
                active_comps[np.clip(comp_local, 0, len(active_comps) - 1)], -1)
            ok = (comp_np >= 0) & (comp_np < num_components)

            # component center / BEV radius for the edge filter
            cc = np.zeros((num_components, 2), np.float32)
            cnt = np.bincount(ex_comp, minlength=num_components).astype(np.float32)
            for d in range(2):
                cc[:, d] = np.bincount(ex_comp, weights=ex_xyz[:, d], minlength=num_components)
            cc[cnt > 0] /= cnt[cnt > 0, None]
            rad = np.linalg.norm(ex_xyz[:, :2] - cc[ex_comp], axis=-1)
            cd = np.zeros(num_components, np.float32)
            np.maximum.at(cd, ex_comp, rad)
            mov_by_comp = np.zeros(num_components, bool)
            mov_by_comp[ex_comp] = ex_mov
            comp_c = np.clip(comp_np, 0, num_components - 1)
            ok &= np.linalg.norm(ref_xyz[:, :2] - cc[comp_c], axis=-1) < cd[comp_c] + 0.05

            sel = np.nonzero(ok)[0]
            comp_sel = comp_np[sel]
            full.fxyz.append(np.concatenate([np.full((len(sel), 1), fid, np.float32),
                                             ref_xyz[sel]], axis=1))
            full.component.append(comp_sel)
            full.segmentation_label.append(all_points.segmentation_label[rm][sel])
            full.original_indices.append(rm[sel])
            full.moving.append(mov_by_comp[comp_sel])

            # box IoU update, vectorized over components
            if len(sel) and len(b_idx):
                Bf = len(b_idx)
                ref_gt = np.full(n_ref, -1, np.int64)
                ref_gt[rows_j] = gt_vals
                gt_sel = ref_gt[sel]
                pair_ok = gt_sel >= 0
                inter = np.bincount(comp_sel[pair_ok] * Bf + gt_sel[pair_ok],
                                    minlength=num_components * Bf).reshape(num_components, Bf)
                cnt_c = np.bincount(comp_sel, minlength=num_components)
                abox = inter.argmax(1)
                inter_best = inter.max(1)
                has = inter_best > 0
                union = cnt_c + m1cnt[:Bf][abox] - inter_best
                iou_c = np.where(has, inter_best / (union + 1e-6), 0.0)
                component_hit[:num_components] += (iou_c > 0.7).astype(np.int64)
                np.maximum.at(seq_boxes.best_iou, b_idx[abox[has]], iou_c[has])

        def cat(parts, empty):
            return np.concatenate(parts, axis=0) if parts else empty

        out = EDict(
            fxyz=cat(full.fxyz, np.zeros((0, 4), np.float32)),
            component=cat(full.component, np.zeros(0, np.int64)),
            segmentation_label=cat(full.segmentation_label, np.zeros(0, np.int64)),
            original_indices=cat(full.original_indices, np.zeros(0, np.int64)),
            moving=cat(full.moving, np.zeros(0, bool)),
        )
        out.component_hit = component_hit
        out.transforms = extracted.transforms
        return out, seq_boxes

    # ------------------------------------------------------------------
    @staticmethod
    def format_boxes(seq_dict):
        return EDict(
            attr=np.asarray(seq_dict["gt_box_attr"]).reshape(-1, 7),
            cls_label=np.asarray(seq_dict["gt_box_cls_label"]).reshape(-1),
            trace_id=np.asarray(seq_dict["gt_box_track_label"]).reshape(-1),
            frame=np.asarray(seq_dict["gt_box_frame"]).reshape(-1),
            velo=np.asarray(seq_dict["gt_box_velo"]).reshape(-1),
            moving=np.asarray(seq_dict["moving"]).reshape(-1),
        )

    def _load_sequence(self, seq_dict):
        """Host point tables of the sequence and its resident device tables
        (per-frame tables of the tracked and of the full-resolution
        above-ground points). Returns (seq_points, all_points, seq_dev,
        seq_index)."""
        dev = self.device
        fxyz = np.asarray(seq_dict["point_fxyz"])
        frame = np.asarray(seq_dict["point_sweep"]).reshape(-1).astype(int, copy=False)
        n = len(frame)
        seq_points = EDict(
            xyz=fxyz[:, 1:4].astype(np.float32),
            frame=frame,
            segmentation_label=np.asarray(
                seq_dict.get("segmentation_label", np.zeros(n, np.int64))).reshape(-1),
        )
        # full-resolution, above-ground points for the trace re-extraction
        if "full_point_fxyz" in seq_dict:
            f_fxyz = np.asarray(seq_dict["full_point_fxyz"])
            if "full_point_keep0" in seq_dict:
                keep = np.asarray(seq_dict["full_point_keep0"]).reshape(-1)
            else:
                keep = np.asarray(seq_dict["full_point_height"]).reshape(-1) > 0.0
            rows = np.nonzero(keep)[0]
            all_points = EDict(
                xyz=f_fxyz[rows][:, 1:4].astype(np.float32),
                frame=np.asarray(seq_dict["full_point_sweep"]).reshape(-1)[rows].astype(int),
                segmentation_label=np.asarray(seq_dict.get(
                    "full_segmentation_label", np.zeros(len(f_fxyz), np.int64))
                ).reshape(-1)[rows],
            )
        else:
            all_points = seq_points
        seq_index = FrameIndex(frame)
        self._ap_index = FrameIndex(all_points.frame)
        seq_dev = torch.as_tensor(fxyz, dtype=torch.float32, device=dev)
        self._seq_tab = frame_table(seq_dev, frame)
        ap_fxyz = np.concatenate([all_points.frame[:, None].astype(np.float32),
                                  all_points.xyz], axis=1)
        self._full_tab = frame_table(torch.as_tensor(ap_fxyz, device=dev), all_points.frame)
        return seq_points, all_points, seq_dev, seq_index

    def _set_components(self, seq_points, seq_dev, component):
        """Attach one component key's ids to the sequence, with the
        stationary flags (components over 12.5 m across) and their
        per-frame device table."""
        dev = self.device
        n = len(component)
        C_all = int(component.max()) + 1 if n else 0
        cc_diam = np.zeros(C_all, np.float32)
        if C_all:
            _, _, diam = comp_stats(seq_dev[:, 1:4], torch.as_tensor(component, device=dev), C_all)
            cc_diam = diam.cpu().numpy()
        seq_points.component = component
        seq_points.stationary = cc_diam[component] > 12.5 if C_all else np.zeros(n, bool)
        stab, _, _ = frame_table(torch.as_tensor(seq_points.stationary, device=dev)[:, None]
                                 .to(torch.float32), seq_points.frame, p_cap=self._seq_tab[2])
        self._stat_tab = (stab[..., 0] == 1.0)

    @staticmethod
    def _anchor_frame(seq_points, seq_index, frame_id):
        """The tracked frame's points with its components renumbered from 0,
        or None for an empty frame."""
        fm = seq_index.rows(frame_id)
        if not len(fm):
            return None
        comp = seq_points.component[fm]
        return EDict(xyz=seq_points.xyz[fm], frame=seq_points.frame[fm],
                     component=comp - comp.min(), stationary=seq_points.stationary[fm],
                     segmentation_label=seq_points.segmentation_label[fm], original_indices=fm)

    def __call__(self, seq_dict):
        self.walk_frames = dict.fromkeys(WALKS, 0)
        sequence_id = str(seq_dict.get("frame_id", "seq"))[:-4] or "seq"
        outfolder = (os.path.join(self.model_cfg.DIR, sequence_id) if "DIR" in self.model_cfg
                     else None)
        if outfolder:
            outpath = os.path.join(outfolder, "all.pkl")
            if os.path.exists(outpath):
                print(f"{outpath} already exists. skipping...")
                return seq_dict
            os.makedirs(outfolder, exist_ok=True)
        seq_points, all_points, seq_dev, seq_index = self._load_sequence(seq_dict)
        frame = seq_points.frame
        num_frames = int(frame.max()) + 1 if len(frame) else 0

        seq_boxes = self.format_boxes(seq_dict)
        if seq_boxes.attr.shape[0] == 0:
            return seq_dict
        seq_boxes.best_iou = np.zeros(seq_boxes.attr.shape[0], np.float32)
        self._boxtab = self._box_table(seq_boxes)

        for comp_key in self.component_keys:
            self._set_components(seq_points, seq_dev,
                                 np.asarray(seq_dict[f"point_{comp_key}"]).astype(np.int64))
            for frame_id in range(0, num_frames, self.track_interval):
                fr = self._anchor_frame(seq_points, seq_index, frame_id)
                if fr is None:
                    continue
                extracted = self.track_frame(seq_points, fr, seq_boxes, seq_index)
                if extracted is None or len(extracted.fxyz) == 0:
                    continue
                extracted_f, _ = self.extract_traces_and_update_boxes(all_points, extracted,
                                                                      seq_boxes)
                if outfolder:
                    _save(os.path.join(outfolder, f"{frame_id:03d}_{comp_key}.pkl"),
                          extracted_f)
                sb = ((seq_boxes.frame >= frame_id - self.track_interval)
                      & (seq_boxes.frame <= frame_id + self.track_interval))
                if sb.any():
                    cov = float((seq_boxes.best_iou[sb] > 0.7).mean())
                    print(f"segment [{frame_id - self.track_interval}, "
                          f"{frame_id + self.track_interval}]: num_boxes={int(sb.sum())}, "
                          f"coverage={cov:.6f}")

        moving = seq_boxes.moving.astype(bool)
        moving_miou = float(seq_boxes.best_iou[moving].mean()) if moving.any() else "NA"
        print(f"All Box mIoU={seq_boxes.best_iou.mean()}")
        print(f"Moving Box mIoU={moving_miou}")
        if outfolder:
            _save(outpath, seq_boxes)
        seq_dict["seq_boxes"] = seq_boxes
        return seq_dict
