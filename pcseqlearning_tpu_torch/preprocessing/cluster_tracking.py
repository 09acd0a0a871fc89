"""Cluster tracking in batched-walk mode (counterpart of
pcseqlearning_tpu.preprocessing.cluster_tracking with WALK_MODE="batched").

For every TRACK_INTERVAL-th frame, every proposed component is tracked
+-TRACK_INTERVAL frames through the component-tiled ICP walk
(``tracking_batched``). Member points are then re-claimed from the
full-resolution above-ground cloud by one sorted-grid nearest-neighbour
scan per tracked window (the ``radius_scan`` kernel, k=1, radius
NN_GRAPH.RADIUS * 1.732, z-band filtered) and scored against the GT boxes.

The per-sequence tables (per-frame point tables, stationary flags, box
assignment of the full cloud) are built once on the device; the per-window
bookkeeping and box IoU accounting stay on the host, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import boxes as box_ops
from ..ops import segment_ops
from ..ops.sorted_grid import radius_neighbors_sorted
from ..utils import telemetry
from ..utils.edict import EDict
from ..utils.frame_index import FrameIndex
from ..utils.padding import bucket_size
from .cluster_proposal import frame_table
from .tracking_batched import (pack_components_device, track_window_batched_dispatch,
                               track_window_batched_drain)


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


class ClusterTracking:
    """Config keys as in the JAX module. Extra port keys (``convert.
    config_from_jax`` fills them from the JAX side's import-time
    environment): ANGLE_VELO_EXEMPT (default 0.05) and FINE_CANDIDATES
    (default 256). Only WALK_MODE="batched" is ported; DIR is not."""

    def __init__(self, model_cfg, runtime_cfg=None, device="cuda"):
        self.model_cfg = EDict(model_cfg)
        cfg = self.model_cfg
        if "DIR" in cfg:
            raise ValueError("ClusterTracking: DIR is not supported by the port")
        if str(cfg.get("WALK_MODE", "batched")) != "batched" or not cfg.get("DEVICE_WALK", True):
            raise ValueError("ClusterTracking: the port has only WALK_MODE='batched'")
        self.device = resolve_device(device)
        reg_cfg = cfg["REGISTRATION"]
        self.stopping_delta = [float(s) for s in reg_cfg["STOPPING_DELTA"]]
        self.radius_list = [float(r) for r in reg_cfg["GRAPH"]["RADIUS"]]
        self.voxel_size_list = [list(map(float, v)) for v in reg_cfg["VOXEL_SIZE"]]
        self.angle_regularizer = float(cfg.get("ANGLE_REGULARIZER", 10))
        self.nn_radius = float(cfg["NN_GRAPH"]["RADIUS"])
        params = cfg.get("TRACKING_PARAMS", {})
        self.reg_error_coeff = float(params.get("REGISTRATION_ERROR_COEFFICIENT", 0.13))
        self.track_interval = int(params.get("TRACK_INTERVAL", 10))
        self.angle_threshold = float(params.get("ANGLE_THRESHOLD", 45))
        self.min_move_frame = int(params.get("MIN_MOVE_FRAME", 6))
        self.component_keys = list(cfg["COMPONENT_KEYS"])
        self.max_icp_iter = int(cfg.get("MAX_ICP_ITER", 80))
        self.angle_velo_exempt = float(cfg.get("ANGLE_VELO_EXEMPT", 0.05))
        self.fine_candidates = int(cfg.get("FINE_CANDIDATES", 256))

    # ------------------------------------------------------------------
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
        deg = np.bincount(frame.component, minlength=C).astype(np.float32)[:C]
        ctr = np.zeros((C, 3), np.float32)
        for d in range(3):
            ctr[:, d] = np.bincount(frame.component, weights=frame.xyz[:, d], minlength=C)[:C]
        ctr[deg > 0] /= deg[deg > 0, None]
        rr = np.linalg.norm(frame.xyz - ctr[frame.component], axis=-1)
        diam = np.zeros(C, np.float32)
        np.maximum.at(diam, frame.component, rr)
        diam *= 2
        comp_valid0 = (deg > 0.5) & (diam < 12.5)

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
        levels = tuple(
            (float(v[0]), float(v[1]), float(v[2]), float(r), float(sd))
            for v, r, sd in zip(self.voxel_size_list, self.radius_list, self.stopping_delta))
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

    def __call__(self, seq_dict):
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
        num_frames = int(frame.max()) + 1 if n else 0
        seq_index = FrameIndex(frame)
        self._ap_index = FrameIndex(all_points.frame)
        seq_dev = torch.as_tensor(fxyz, dtype=torch.float32, device=dev)
        self._seq_tab = frame_table(seq_dev, frame)
        ap_fxyz = np.concatenate([all_points.frame[:, None].astype(np.float32),
                                  all_points.xyz], axis=1)
        self._full_tab = frame_table(torch.as_tensor(ap_fxyz, device=dev), all_points.frame)

        seq_boxes = self.format_boxes(seq_dict)
        if seq_boxes.attr.shape[0] == 0:
            return seq_dict
        seq_boxes.best_iou = np.zeros(seq_boxes.attr.shape[0], np.float32)
        self._boxtab = self._box_table(seq_boxes)

        for comp_key in self.component_keys:
            component = np.asarray(seq_dict[f"point_{comp_key}"]).astype(np.int64)
            C_all = int(component.max()) + 1 if n else 0
            cc_diam = np.zeros(C_all, np.float32)
            if C_all:
                _, _, diam = comp_stats(seq_dev[:, 1:4], torch.as_tensor(component, device=dev),
                                        C_all)
                cc_diam = diam.cpu().numpy()
            seq_points.component = component
            # stationary = very large components
            seq_points.stationary = cc_diam[component] > 12.5 if C_all else np.zeros(n, bool)
            stat_dev = torch.as_tensor(seq_points.stationary, device=dev)
            stab, _, _ = frame_table(stat_dev[:, None].to(torch.float32), frame,
                                     p_cap=self._seq_tab[2])
            self._stat_tab = (stab[..., 0] == 1.0)

            for frame_id in range(0, num_frames, self.track_interval):
                fm = seq_index.rows(frame_id)
                if not len(fm):
                    continue
                fr = EDict(
                    xyz=seq_points.xyz[fm],
                    frame=frame[fm],
                    component=component[fm] - component[fm].min(),
                    stationary=seq_points.stationary[fm],
                    segmentation_label=seq_points.segmentation_label[fm],
                    original_indices=fm,
                )
                extracted = self.track_frame_batched(seq_points, fr, seq_boxes, seq_index)
                if extracted is None or len(extracted.fxyz) == 0:
                    continue
                self.extract_traces_and_update_boxes(all_points, extracted, seq_boxes)
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
        seq_dict["seq_boxes"] = seq_boxes
        return seq_dict
