"""Multi-radius connected-component cluster proposal and its IoU evaluation
(counterpart of pcseqlearning_tpu.preprocessing.cluster_proposal,
single device).

Per radius, the sequence is cut into CHUNK_FRAMES-frame chunks and each
chunk is labelled by one of the JAX module's two CC paths, chosen by the
config key CC_GRAPH:

  "radius" (default)  the exact same-frame radius-graph components of the
                      sorted-grid CC (``ops.sorted_grid``, the ``cc_round``
                      kernel): the JAX module's TPU path
  "knn"               a spatial-hash neighbour table (``ops.hash_graph``,
                      CC_NEIGHBORS nearest within the radius, CC_CELL_CAP
                      rows scanned per probe) through kNN-graph label
                      propagation (``ops.connected_components``): the JAX
                      module's path on every other backend, or with
                      PCSEQ_PALLAS=0 / PCSEQ_PALLAS_SCAN=0

``convert.config_from_jax`` writes the key the JAX side would take. Nothing
switches from one path to the other on its own.

With NUM_SHARDS > 1 (and HALO_CAP, default 4096), each chunk is x-sharded
over NUM_SHARDS devices and labelled by the halo-exchange CC of
``parallel.point_shard`` (kNN graph, as in JAX, whatever CC_GRAPH says),
its components numbered by ``np.unique`` of the root ids; the devices are
the ``devices`` argument (default: the visible cards on "cuda",
NUM_SHARDS CPU slots on "cpu"), the counterpart of ``jax.devices()``. As in
JAX, fewer devices than shards runs every chunk on one device, and a chunk
whose slabs would be thinner than the radius runs on one device (each with
a printed message); the halo points dropped at HALO_CAP are counted in the
``proposal_halo_truncated`` telemetry, with a warning.

Proposals are scored per frame by best point-set IoU against the GT boxes,
batched over frames. DIR, as in the JAX module, only creates its directory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops import boxes as box_ops
from ..ops import connected_components as cc
from ..ops import hash_graph, segment_ops
from ..ops.sorted_grid import connected_components_radius
from ..parallel.mesh import make_mesh, visible_devices
from ..parallel.point_shard import shard_points_by_x, sharded_connected_components
from ..utils import telemetry
from ..utils.edict import EDict
from ..utils.frame_index import FrameIndex
from ..utils.padding import bucket_size

CC_GRAPHS = ("radius", "knn")


def frame_table(fxyz, frame, p_cap=None):
    """[F, p_cap, 4] per-frame table (pads at 1e8) + [F, p_cap] valid of a
    device point table ``fxyz`` [N, 4] with host frame ids ``frame`` (frames
    0..F-1, F = max + 1)."""
    frame = np.asarray(frame).reshape(-1).astype(np.int64)
    F = int(frame.max()) + 1 if len(frame) else 0
    counts = np.bincount(frame, minlength=F)
    if p_cap is None:
        p_cap = bucket_size(int(counts.max()) if len(frame) else 1)
    order = np.argsort(frame, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(frame)) - starts[frame[order]]
    dev = fxyz.device
    tab = torch.full((F, p_cap, fxyz.shape[1]), 1e8, dtype=fxyz.dtype, device=dev)
    valid = torch.zeros((F, p_cap), dtype=torch.bool, device=dev)
    fo = torch.as_tensor(frame[order], device=dev)
    so = torch.as_tensor(slot, device=dev)
    tab[fo, so] = fxyz[torch.as_tensor(order, device=dev)]
    valid[fo, so] = True
    return tab, valid, p_cap


def evaluate_frames(xyz, pvalid, comp_local, boxes, bvalid, c_cap):
    """Per-frame proposal scoring, batched over frames.

    xyz [F, N, 3] (pvalid [F, N]), comp_local [F, N] dense per-frame ids
    (< c_cap, -1 invalid), boxes [F, B, 7] (bvalid [F, B]). Returns
    box_best_iou [F, B], gt_box_id [F, N], pred_box_id [F, N] (indices into
    the padded frame box arrays, -1 unassigned)."""
    F, N, _ = xyz.shape
    B = boxes.shape[1]
    dev = xyz.device
    bp = box_ops.points_in_boxes(xyz, boxes) & pvalid[:, None, :] & bvalid[:, :, None]
    in_any = bp.any(dim=1)
    gt = torch.where(in_any, bp.to(torch.uint8).argmax(dim=1), torch.full_like(in_any, -1,
                                                                               dtype=torch.int64))
    fo = torch.arange(F, device=dev)[:, None]
    box_size = segment_ops.segment_count(
        torch.where(in_any, fo * B + gt, torch.full_like(gt, F * B)).reshape(-1), F * B
    ).reshape(F, B)
    comp_ok = (comp_local >= 0) & (comp_local < c_cap) & pvalid
    comp_safe = torch.where(comp_ok, comp_local.long(), torch.zeros_like(comp_local.long()))
    comp_size = segment_ops.segment_count(
        torch.where(comp_ok, fo * c_cap + comp_safe, torch.full_like(comp_safe, F * c_cap))
        .reshape(-1), F * c_cap).reshape(F, c_cap)
    pair_ok = comp_ok & in_any
    pair_key = torch.where(pair_ok, (fo * c_cap + comp_safe) * B + gt,
                           torch.full_like(gt, F * c_cap * B))
    pair_count = segment_ops.segment_count(pair_key.reshape(-1), F * c_cap * B
                                           ).reshape(F, c_cap, B)
    best = pair_count.max(dim=2)
    comp2box = pair_count.argmax(dim=2)
    comp_has_box = best.values > 0.5
    inter = best.values
    union = comp_size + torch.gather(box_size, 1, comp2box) - inter
    iou = torch.where(comp_has_box, inter / torch.clamp(union, min=1e-6),
                      torch.zeros_like(inter))
    box_best_iou = torch.zeros((F, B), dtype=torch.float32, device=dev)
    box_best_iou.scatter_reduce_(1, torch.where(comp_has_box, comp2box, torch.zeros_like(comp2box)),
                                 torch.where(comp_has_box, iou, torch.zeros_like(iou)), "amax")
    has_pt = torch.gather(comp_has_box, 1, comp_safe)
    box_pt = torch.gather(comp2box, 1, comp_safe)
    pred = torch.where(comp_ok & has_pt, box_pt, torch.full_like(box_pt, -1))
    return box_best_iou, gt, pred


def knn_chunk_components(pts, radius, k, cell_cap):
    """The kNN-graph CC of one chunk's points [n, 4] (frame, x, y, z), padded
    as the JAX module pads them (to ``bucket_size(n)`` rows at 1e8, which
    sizes the hash table). Returns (component [n] int32, count)."""
    n, cap = pts.shape[0], bucket_size(pts.shape[0])
    padded = torch.full((cap, 4), 1e8, dtype=torch.float32, device=pts.device)
    padded[:n] = pts
    valid = torch.arange(cap, device=pts.device) < n
    idx, _, mask = hash_graph.radius_graph(padded, padded, radius, k, ref_valid=valid,
                                           query_valid=valid, cell_cap=cell_cap)
    comp, num = cc.compact_labels(cc.connected_components_knn(idx, mask), node_valid=valid)
    return comp[:n], num


class ClusterProposal:
    """Chunked multi-radius CC + per-frame evaluation. Config keys as in the
    JAX module: GRAPH.RADIUS, GRAPH.MAX_NUM_NEIGHBORS, COMPONENT_KEYS,
    CHUNK_FRAMES, CELL_CAP, CC_NEIGHBORS (default min(MAX_NUM_NEIGHBORS,
    16)), CC_CELL_CAP (default min(CELL_CAP, 24); the JAX module reads 24
    from PCSEQ_CELL_CAP when set), NUM_SHARDS (default ``runtime_cfg``'s
    ``num_shards``, else 1), HALO_CAP and DIR; the port's CC_GRAPH picks the
    unsharded CC path. ``devices`` are the sharded path's devices."""

    def __init__(self, model_cfg, runtime_cfg=None, device="cuda", devices=None):
        self.model_cfg = EDict(model_cfg)
        self.device = resolve_device(device)
        self.component_keys = list(self.model_cfg["COMPONENT_KEYS"])
        graph_cfg = self.model_cfg["GRAPH"]
        radii = graph_cfg["RADIUS"]
        if not isinstance(radii, (list, tuple)):
            radii = [radii] * len(self.component_keys)
        self.radii = [float(r) for r in radii]
        self.chunk_frames = int(self.model_cfg.get("CHUNK_FRAMES", 10))
        self.cc_graph = str(self.model_cfg.get("CC_GRAPH", "radius"))
        if self.cc_graph not in CC_GRAPHS:
            raise ValueError(f"ClusterProposal: CC_GRAPH {self.cc_graph!r} not in {CC_GRAPHS}")
        cell_cap = int(self.model_cfg.get("CELL_CAP", hash_graph.DEFAULT_CELL_CAP))
        self.cc_neighbors = int(self.model_cfg.get(
            "CC_NEIGHBORS", min(int(graph_cfg.get("MAX_NUM_NEIGHBORS", 32)), 16)))
        self.cc_cell_cap = int(self.model_cfg.get("CC_CELL_CAP", min(cell_cap, 24)))
        self.num_shards = int(self.model_cfg.get(
            "NUM_SHARDS", runtime_cfg.get("num_shards", 1) if isinstance(runtime_cfg, dict) else 1))
        self.halo_cap = int(self.model_cfg.get("HALO_CAP", 4096))
        self.devices = devices
        self._mesh = None

    def _shard_mesh(self):
        if self._mesh is None and self.num_shards > 1:
            devs = self.devices
            if devs is None:
                devs = (visible_devices() if self.device.type == "cuda"
                        else [self.device] * self.num_shards)
            if len(devs) >= self.num_shards:
                self._mesh = make_mesh(devices=devs[:self.num_shards], dp=self.num_shards)
            else:
                print(f"Cluster Proposal: NUM_SHARDS={self.num_shards} but only "
                      f"{len(devs)} devices — falling back to single-device")
                self.num_shards = 1
        return self._mesh

    def _propose_chunk_sharded(self, pts, radius):
        """One chunk's (root gid [n], halo points truncated) by the sharded
        CC, or None to run it on one device (no mesh, or a slab thinner
        than the radius)."""
        mesh = self._shard_mesh()
        if mesh is None:
            return None
        try:
            sp, gi, va = shard_points_by_x(pts.astype(np.float32), self.num_shards, radius=radius)
        except ValueError as e:
            print(f"Cluster Proposal: sharded CC fallback ({e})")
            return None
        roots, ntrunc = sharded_connected_components(
            sp, gi, va, radius, mesh, k=self.cc_neighbors, halo_cap=self.halo_cap,
            cell_cap=self.cc_cell_cap)
        roots = roots.cpu().numpy().reshape(-1)
        gi, va = gi.reshape(-1), va.reshape(-1)
        root_by_row = np.empty(len(pts), np.int64)
        root_by_row[gi[va]] = roots[va]
        return root_by_row, int(ntrunc.sum())

    def propose_cluster(self, seq_dict):
        fxyz = np.asarray(seq_dict["point_fxyz"])
        frame = np.asarray(seq_dict["point_sweep"]).reshape(-1)
        n = fxyz.shape[0]
        num_frames = int(frame.max()) + 1 if n else 0
        findex = FrameIndex(frame)
        pts_all = torch.as_tensor(fxyz, dtype=torch.float32, device=self.device)
        components = {k: np.zeros(n, dtype=np.int64) for k in self.component_keys}
        totals = {k: 0 for k in self.component_keys}
        for f0 in range(0, num_frames, self.chunk_frames):
            m = findex.rows_range(f0, f0 + self.chunk_frames)
            if not len(m):
                continue
            pts_np = fxyz[m]
            pts = pts_all[torch.as_tensor(m, device=self.device)]
            span = float((pts_np[:, 1:3].max(0) - pts_np[:, 1:3].min(0)).max())
            for comp_key, radius in zip(self.component_keys, self.radii):
                res = self._propose_chunk_sharded(pts_np, radius) if self.num_shards > 1 else None
                if res is not None:
                    _, comp_np = np.unique(res[0], return_inverse=True)
                    components[comp_key][m] = comp_np + totals[comp_key]
                    totals[comp_key] += int(comp_np.max()) + 1 if len(comp_np) else 0
                    telemetry.add("proposal_halo_truncated", res[1])
                    if res[1] > 0:
                        print(f"Cluster Proposal {comp_key}: WARNING {res[1]} halo points "
                              f"truncated at HALO_CAP={self.halo_cap}")
                    continue
                if self.cc_graph == "knn":
                    comp, num = knn_chunk_components(pts, radius, self.cc_neighbors,
                                                     self.cc_cell_cap)
                else:
                    cells = int(np.ceil(span / radius)) + 3
                    XY = 1 << max(cells - 1, 1).bit_length()
                    comp, num = connected_components_radius(
                        pts, None, radius, F=self.chunk_frames, X=XY, Y=XY)
                components[comp_key][m] = comp.cpu().numpy().astype(np.int64) + totals[comp_key]
                totals[comp_key] += num
        # neither path has a scan window to truncate (the CUDA CC walks whole
        # cell runs)
        telemetry.add("proposal_scan_windows_truncated", 0)
        for comp_key in self.component_keys:
            seq_dict[f"point_{comp_key}"] = components[comp_key]
            print(f"Cluster Proposal {comp_key}: num_components={totals[comp_key]}")
        return seq_dict

    @staticmethod
    def format_boxes(seq_dict):
        return EDict(
            attr=np.asarray(seq_dict["gt_box_attr"]).reshape(-1, 7),
            cls_label=np.asarray(seq_dict["gt_box_cls_label"]).reshape(-1),
            trace_id=np.asarray(seq_dict["gt_box_track_label"]).reshape(-1),
            frame=np.asarray(seq_dict["gt_box_frame"]).reshape(-1),
        )

    def evaluate_proposal(self, seq_dict, frames_per_batch=16):
        fxyz = np.asarray(seq_dict["point_fxyz"])
        frame = np.asarray(seq_dict["point_sweep"]).reshape(-1)
        n = fxyz.shape[0]
        num_frames = int(frame.max()) + 1 if n else 0
        seq_boxes = self.format_boxes(seq_dict)
        num_boxes = seq_boxes.attr.shape[0]
        if num_boxes == 0:
            for key in ["gt_box_id", "gt_trace_id", "pred_trace_id", "pred_box_id"]:
                seq_dict[f"point_{key}"] = np.zeros(n, np.int64) - 1
            return seq_dict

        num_traces = int(seq_boxes.trace_id.max()) + 1
        trace_best = np.zeros(num_traces, np.float32)
        trace_min_frame = np.full(num_traces, 10 ** 9)
        trace_max_frame = np.full(num_traces, -1)
        for t in range(num_traces):
            tm = seq_boxes.trace_id == t
            if tm.any():
                trace_min_frame[t] = seq_boxes.frame[tm].min()
                trace_max_frame[t] = seq_boxes.frame[tm].max()

        findex = FrameIndex(frame)
        frames_geo = []
        b_cap = 1
        for fid in range(num_frames):
            rows = findex.rows(fid)
            b_idx = np.nonzero(seq_boxes.frame == fid)[0]
            if len(rows) and len(b_idx):
                frames_geo.append((fid, rows, b_idx))
                b_cap = max(b_cap, len(b_idx))
        b_cap = bucket_size(b_cap, base=32)
        dev = self.device
        tab, tval, p_cap = frame_table(torch.as_tensor(fxyz, dtype=torch.float32, device=dev),
                                       frame)
        box_a = np.zeros((len(frames_geo), b_cap, 7), np.float32)
        bv_a = np.zeros((len(frames_geo), b_cap), bool)
        for i, (_, _, b_idx) in enumerate(frames_geo):
            box_a[i, :len(b_idx)] = seq_boxes.attr[b_idx]
            bv_a[i, :len(b_idx)] = True
        box_d, bv_d = torch.as_tensor(box_a, device=dev), torch.as_tensor(bv_a, device=dev)
        sel = torch.as_tensor([fg[0] for fg in frames_geo], dtype=torch.int64, device=dev)

        results = EDict()
        for comp_key in self.component_keys:
            component = np.asarray(seq_dict[f"point_{comp_key}"])
            best_iou = np.zeros(num_boxes, np.float32)
            gt_box_id = np.zeros(n, np.int64) - 1
            pred_box_id = np.zeros(n, np.int64) - 1
            frames_data, c_cap = [], 1
            for fid, rows, b_idx in frames_geo:
                uniq, local = np.unique(component[rows], return_inverse=True)
                frames_data.append((rows, local, b_idx))
                c_cap = max(c_cap, len(uniq))
            c_cap = bucket_size(c_cap, base=128)
            for i0 in range(0, len(frames_geo), frames_per_batch):
                i1 = min(i0 + frames_per_batch, len(frames_geo))
                loc_a = np.full((i1 - i0, p_cap), -1, np.int64)
                for i in range(i0, i1):
                    loc_a[i - i0, :len(frames_data[i][1])] = frames_data[i][1]
                bb_a, gid_a, pid_a = (t.cpu().numpy() for t in evaluate_frames(
                    tab[sel[i0:i1]][..., 1:4], tval[sel[i0:i1]],
                    torch.as_tensor(loc_a, device=dev), box_d[i0:i1], bv_d[i0:i1], c_cap))
                for i in range(i0, i1):
                    rows, local, b_idx = frames_data[i]
                    bb = bb_a[i - i0][:len(b_idx)]
                    upd = bb > best_iou[b_idx]
                    best_iou[b_idx[upd]] = bb[upd]
                    gid = gid_a[i - i0][:len(local)]
                    pid = pid_a[i - i0][:len(local)]
                    gt_box_id[rows] = np.where(gid >= 0, b_idx[np.clip(gid, 0, None)], -1)
                    pred_box_id[rows] = np.where(pid >= 0, b_idx[np.clip(pid, 0, None)], -1)
            for t in range(num_traces):
                tm = seq_boxes.trace_id == t
                if tm.any():
                    trace_best[t] = max(trace_best[t], best_iou[tm].max())
            results[f"best_iou_after_{comp_key}"] = best_iou.copy()
            nf = trace_max_frame - trace_min_frame + 1
            trace_miou = float((trace_best * nf).sum() / (nf.sum() + 1e-6))
            print(f"mIoU({comp_key})={float(best_iou.mean()):.6f}, "
                  f"Trace-propagated mIoU({comp_key})={trace_miou:.6f}")
            seq_dict["point_gt_box_id"] = gt_box_id
            seq_dict["point_pred_box_id"] = pred_box_id
            seq_dict["point_gt_trace_id"] = np.where(
                gt_box_id >= 0, seq_boxes.trace_id[np.clip(gt_box_id, 0, None)], -1)
            seq_dict["point_pred_trace_id"] = np.where(
                pred_box_id >= 0, seq_boxes.trace_id[np.clip(pred_box_id, 0, None)], -1)
        seq_dict["gt_box_best_iou"] = results[f"best_iou_after_{self.component_keys[-1]}"]
        seq_dict["gt_trace_best_iou"] = trace_best
        seq_dict.update(results)
        return seq_dict

    def __call__(self, seq_dict):
        seq_dict = self.propose_cluster(seq_dict)
        if "gt_box_attr" in seq_dict:
            seq_dict = self.evaluate_proposal(seq_dict)
        if "DIR" in self.model_cfg:
            os.makedirs(self.model_cfg.DIR, exist_ok=True)
        return seq_dict
