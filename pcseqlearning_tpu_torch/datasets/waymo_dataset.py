"""Waymo sequence dataset over the npy/pkl layout of
``tools/create_waymo_infos.py`` (counterpart of
pcseqlearning_tpu.datasets.waymo_dataset; host NumPy, as there).

Per-sequence info pkls feed a (sequence, sample) pool; ``get_lidar`` loads
``NNNN.npy`` with the channel normalisation (tanh(intensity), range / 75,
rimage_w * 2650, rimage_h * 64); segmentation labels come from
``NNNN_seg.npy`` (or ``_propseg.npy``). Multi-sweep assembly aligns every
frame to the anchor frame's ego pose, attaches the sweep id, transforms the
boxes and their headings, and pads the objects per sweep. In sequence mode
(NUM_SWEEPS covering the sequence) there is one item per sequence, its last
sample being the anchor.

Options, as in JAX:
- USE_SHARED_MEMORY: decoded frames are kept in an in-process cache, the
  oldest dropped once it holds more than SHARED_MEMORY_CACHE_SIZE (512);
- SPHERICAL_RESAMPLING: each range-image row is densified along azimuth
  (``spherical_resampling``);
- WITH_TIME_FEAT (with NUM_SWEEPS > 1): each point's features gain, in
  front, its sweep id over (sweeps - 1);
- MIX3D (training): with probability PROB the item is mixed with another
  item drawn at random (its points, point labels, boxes and names
  appended). The dataset's ``rng`` draws ``rand`` then ``randint`` before
  the other item's own draws.

``generate_prediction_dicts`` formats a batch's predictions as detection
annos, and ``evaluation`` scores them against the infos' annos with the
"waymo" metric (``runtime.eval_utils.waymo_style_ap``), the "waymo_ii"
interaction-index breakdown (``waymo_eval_ii.ap_by_interaction_index``)
or the "simple" one.
"""

from __future__ import annotations

import copy
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from ..ops import boxes as box_ops
from ..utils.edict import EDict
from ..utils.polar_utils import cartesian_to_spherical
from .dataset import DatasetTemplate
from .processor import knn


def _boxes_to_corners_np(boxes):
    """[B, 7+] boxes -> [B, 8, 3] float32 corners, on the CPU."""
    if len(boxes) == 0:
        return np.zeros((0, 8, 3), np.float32)
    return box_ops.boxes_to_corners_3d(
        torch.as_tensor(boxes[:, :7].astype(np.float32))).numpy()


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None,
                 rng=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger, rng=rng)
        cfg = self.dataset_cfg
        self.data_path = (Path(root_path or cfg.get("DATA_PATH", "."))
                          / cfg.get("PROCESSED_DATA_TAG", "waymo_processed_data"))
        self.num_sweeps = int(cfg.get("NUM_SWEEPS", 1))
        self.sweep_dir = int(cfg.get("SWEEP_DIR", -1))
        self.with_time_feat = bool(cfg.get("WITH_TIME_FEAT", False))
        self.load_seg = bool(cfg.get("LOAD_SEG", False))
        interval = cfg.get("SAMPLED_INTERVAL", 1)
        self.sampled_interval = int(interval.get("train" if training else "test", 1)
                                    if isinstance(interval, dict) else interval)
        self.infos = []
        self.info_pool = {}
        self._frame_cache = {}
        self.include_waymo_data()

    def include_waymo_data(self):
        """Load the per-sequence info pkls: the sequences of SPLIT_DIR's file
        when it exists, else every sequence directory under the data path."""
        split_file = self.dataset_cfg.get("SPLIT_DIR", None)
        seq_list = []
        if split_file and os.path.exists(split_file):
            with open(split_file) as f:
                seq_list = [x.strip().split(".")[0] for x in f if x.strip()]
        elif self.data_path.exists():
            seq_list = sorted(d.name for d in self.data_path.iterdir() if d.is_dir())
        for seq in seq_list:
            pkl = self.data_path / seq / f"{seq}.pkl"
            if not pkl.exists():
                continue
            with open(pkl, "rb") as f:
                infos = pickle.load(f)
            self.infos.extend(infos[::self.sampled_interval])
        for info in self.infos:
            pc = info["point_cloud"]
            self.info_pool[(pc["lidar_sequence"], pc["sample_idx"])] = info
        # sequence mode: one item per sequence, anchored at its last sample
        if self.num_sweeps > 1 and self.dataset_cfg.get("SEQUENCE_MODE", self.num_sweeps >= 100):
            last = {}
            for info in self.infos:
                pc = info["point_cloud"]
                seq = pc["lidar_sequence"]
                if seq not in last or pc["sample_idx"] > last[seq]["point_cloud"]["sample_idx"]:
                    last[seq] = info
            self.infos = [last[s] for s in sorted(last)]

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, sequence_name, sample_idx):
        key = (sequence_name, int(sample_idx))
        if key in self._frame_cache:
            return self._frame_cache[key].copy()
        pts = np.load(self.data_path / sequence_name / ("%04d.npy" % sample_idx)).astype(np.float32)
        pts[:, 3] = np.tanh(pts[:, 3])
        if pts.shape[1] > 5:
            pts[:, 5] /= 75.0
        if pts.shape[1] > 7:
            pts[:, 7] *= 64
            pts[:, 6] *= 2650
        if bool(self.dataset_cfg.get("USE_SHARED_MEMORY", False)):
            if len(self._frame_cache) > int(self.dataset_cfg.get("SHARED_MEMORY_CACHE_SIZE", 512)):
                self._frame_cache.pop(next(iter(self._frame_cache)))
            self._frame_cache[key] = pts.copy()
        return pts

    def spherical_resampling(self, point_wise, config=None):
        """Densifies each range-image row (``point_rimage_h``, else the
        fifth feature, rounded; rows of fewer than 10 points are left) along
        azimuth: each point joins the neighbour among its 10 nearest with the
        smallest azimuth above its own by more than 1e-6 (the first such on
        a tie), if within 0.3 m, and points are interpolated every ~0.1 m
        along that edge (ceil((d + 1e-6) / 0.1) - 1 of them). Every other
        point-wise key of a new point comes from its nearest original
        point (the lowest index of equally near ones). The kNN is
        ``processor.knn`` (cKDTree) where JAX uses scikit-learn's
        ``NearestNeighbors``, whose tree breaks such a tie in its own
        traversal order."""
        point_xyz = point_wise["point_xyz"]
        point_feat = point_wise["point_feat"]
        if "point_rimage_h" in point_wise:
            rim_h = np.round(np.asarray(point_wise["point_rimage_h"])).astype(np.int64)
        elif point_feat.shape[1] > 4:
            rim_h = np.round(point_feat[:, 4]).astype(np.int64)
        else:
            return point_wise
        new_xyz, new_feat = [point_xyz], [point_feat]
        for h in np.unique(rim_h):
            rows = np.nonzero(rim_h == h)[0]
            if len(rows) < 10:
                continue
            p = point_xyz[rows]
            f = point_feat[rows]
            azimuth = np.asarray(cartesian_to_spherical(p))[:, 2]
            dists, e1 = knn(p, p, min(10, len(rows)))
            e0 = np.arange(len(rows))[:, None]
            az_diff = azimuth[e0] - azimuth[e1]
            az_diff[az_diff < 1e-6] = 1e10
            nn_index = az_diff.argmin(axis=-1)
            e0 = e0[:, 0]
            d = dists[(e0, nn_index)]
            e1 = e1[(e0, nn_index)]
            keep = d < 0.3
            e0, e1, d = e0[keep], e1[keep], d[keep]
            if len(e0) == 0:
                continue
            n_samp = np.ceil((d + 1e-6) / 0.1) + 1
            for s in range(1, int(n_samp.max())):
                em = s <= n_samp - 1
                ratio = s / (n_samp - 1)
                em = em & (ratio > 1e-6) & (ratio < 1 - 1e-6)
                if em.any():
                    r = ratio[em, None]
                    new_xyz.append(p[e0[em]] * r + p[e1[em]] * (1.0 - r))
                    new_feat.append(f[e0[em]] * r + f[e1[em]] * (1.0 - r))
        out = dict(point_xyz=np.concatenate(new_xyz).astype(np.float32),
                   point_feat=np.concatenate(new_feat).astype(np.float32))
        idx = knn(point_xyz, out["point_xyz"], 1)[1][:, 0]
        for key in point_wise:
            if key not in out:
                out[key] = np.asarray(point_wise[key])[idx]
        return EDict(out)

    def get_seg_label(self, sequence_name, sample_idx):
        seg_file = self.data_path / sequence_name / ("%04d_seg.npy" % sample_idx)
        if not seg_file.exists():
            seg_file = self.data_path / sequence_name / ("%04d_propseg.npy" % sample_idx)
        if not seg_file.exists():
            return None
        return np.load(seg_file)

    def load_frame(self, info):
        """One frame as point-wise, object-wise and scene-wise dicts."""
        pc = info["point_cloud"]
        seq, idx = pc["lidar_sequence"], pc["sample_idx"]
        points = self.get_lidar(seq, idx)
        point_wise = EDict(point_xyz=points[:, :3], point_feat=points[:, 3:])
        if self.load_seg:
            seg = self.get_seg_label(seq, idx)
            if seg is not None:
                point_wise.instance_label = seg[:, 0].astype(np.int64)
                point_wise.segmentation_label = seg[:, 1].astype(np.int64)
        if bool(self.dataset_cfg.get("SPHERICAL_RESAMPLING", False)):
            point_wise = self.spherical_resampling(point_wise)
        annos = info.get("annos", {})
        object_wise = EDict(
            gt_box_attr=np.asarray(annos.get("gt_boxes_lidar", np.zeros((0, 7))))
            .astype(np.float32).reshape(-1, 7),
            gt_names=np.asarray(annos.get("name", [])).astype(str),
            obj_ids=np.asarray(annos.get("obj_ids", [])).astype(str),
            num_points_in_gt=np.asarray(annos.get("num_points_in_gt", np.zeros(0)))
            .astype(np.int64),
        )
        scene_wise = EDict(frame_id=info.get("frame_id", f"{seq}_{idx:03d}"),
                           pose=np.asarray(info.get("pose", np.eye(4))).reshape(4, 4))
        if "top_lidar_pose" in info:
            scene_wise.top_lidar_origin = np.asarray(info["top_lidar_pose"]).reshape(4, 4)[:3, 3]
        return EDict(point_wise=point_wise, object_wise=object_wise, scene_wise=scene_wise)

    def assemble_sweeps(self, index):
        """The item's sweeps in the anchor frame's ego coordinates, objects
        padded per sweep and flattened."""
        info = copy.deepcopy(self.infos[index])
        cur_idx = info["point_cloud"]["sample_idx"]
        seq = info["point_cloud"]["lidar_sequence"]
        data_dicts = [self.load_frame(info)]
        if self.num_sweeps > 1:
            for cur in range(cur_idx + self.sweep_dir, cur_idx + self.sweep_dir * self.num_sweeps,
                             self.sweep_dir):
                if (seq, cur) not in self.info_pool:
                    continue
                dd = self.load_frame(self.info_pool[(seq, cur)])
                data_dicts = [dd] + data_dicts if self.sweep_dir == -1 else data_dicts + [dd]

        anchor = data_dicts[-1] if self.sweep_dir == -1 else data_dicts[0]
        T0_inv = np.linalg.inv(anchor.scene_wise.pose)
        max_objs = 0
        for dd in data_dicts:
            T = T0_inv @ dd.scene_wise.pose
            pw = dd.point_wise
            pw.point_xyz = (pw.point_xyz @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
            fid = int(str(dd.scene_wise.frame_id)[-3:])
            pw.point_sweep = np.full((len(pw.point_xyz), 1), fid, np.int32)
            if self.num_sweeps > 1 and self.with_time_feat:
                pw.point_feat = np.concatenate(
                    [pw.point_sweep.astype(np.float32) / max(len(data_dicts) - 1, 1),
                     pw.point_feat], axis=-1)
            boxes = dd.object_wise.gt_box_attr
            if len(boxes):
                corners = _boxes_to_corners_np(boxes)
                corners = (corners @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
                boxes[:, :3] = boxes[:, :3] @ T[:3, :3].T + T[:3, 3]
                theta = boxes[:, 6]
                heading = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)], -1)
                heading = heading @ T[:3, :3].T
                nrm = np.linalg.norm(heading[:, :2], axis=-1, keepdims=True)
                heading[:, :2] /= np.maximum(nrm, 1e-6)
                boxes[:, 6] = np.arctan2(heading[:, 1], heading[:, 0])
                dd.object_wise.gt_box_corners_3d = corners.reshape(-1, 24)
            else:
                dd.object_wise.gt_box_corners_3d = np.zeros((0, 24), np.float32)
            dd.object_wise.gt_box_attr = boxes
            if "top_lidar_origin" in dd.scene_wise:
                o = dd.scene_wise.top_lidar_origin
                dd.scene_wise.top_lidar_origin = o @ T[:3, :3].T + T[:3, 3]
            max_objs = max(max_objs, len(boxes))

        max_objs = max(max_objs, 1)
        merged = EDict(point_wise=EDict(), object_wise=EDict(), scene_wise=EDict())
        for k in data_dicts[0].point_wise:
            merged.point_wise[k] = np.concatenate([dd.point_wise[k] for dd in data_dicts], axis=0)
        for k in ("gt_box_attr", "gt_names", "obj_ids", "num_points_in_gt", "gt_box_corners_3d"):
            padded = []
            for dd in data_dicts:
                v = dd.object_wise.get(k)
                if v is None:
                    continue
                v = np.asarray(v)
                pad_n = max_objs - v.shape[0]
                if pad_n > 0:
                    pad = (np.full((pad_n,), "", v.dtype) if v.dtype.kind in "US"
                           else np.zeros((pad_n,) + v.shape[1:], v.dtype))
                    v = np.concatenate([v, pad], axis=0)
                padded.append(v)
            if padded:
                merged.object_wise[k] = np.concatenate(padded, axis=0)
        merged.scene_wise.frame_id = anchor.scene_wise.frame_id
        merged.scene_wise.pose = np.stack([dd.scene_wise.pose for dd in data_dicts])
        merged.scene_wise.num_sweeps = len(data_dicts)
        if "top_lidar_origin" in anchor.scene_wise:
            merged.scene_wise.top_lidar_origin = np.stack(
                [dd.scene_wise.get("top_lidar_origin", np.zeros(3)) for dd in data_dicts])
        return merged

    def __getitem__(self, index, _mix3d_inner=False):
        merged = self.assemble_sweeps(index)
        cls_map = {n: i + 1 for i, n in enumerate(self.class_names)}
        ow = merged.object_wise
        names = ow.get("gt_names", np.zeros(0, str))
        cls_label = np.asarray([cls_map.get(n, 0) for n in names], np.int64)
        attr = ow.get("gt_box_attr", np.zeros((0, 7), np.float32))
        data_dict = {
            "points": np.concatenate([merged.point_wise.point_xyz, merged.point_wise.point_feat],
                                     axis=1).astype(np.float32),
            "point_sweep": merged.point_wise.point_sweep.reshape(-1),
            "frame_id": str(merged.scene_wise.frame_id),
            "pose": merged.scene_wise.pose,
            "num_sweeps": merged.scene_wise.num_sweeps,
            "gt_box_attr": attr,
            "gt_box_cls_label": cls_label,
            "obj_ids": ow.get("obj_ids", np.zeros(0, str)),
            "num_points_in_gt": ow.get("num_points_in_gt", np.zeros(0, np.int64)),
            "gt_box_corners_3d": ow.get("gt_box_corners_3d", np.zeros((0, 24), np.float32)),
            "augmented": np.zeros(len(names), bool),
            "gt_boxes": (np.concatenate([attr, cls_label[:, None].astype(np.float32)], axis=1)
                         if len(names) else np.zeros((0, 8), np.float32)),
            "gt_names": names,
        }
        for k in ("segmentation_label", "instance_label"):
            if k in merged.point_wise:
                data_dict[k] = merged.point_wise[k]
        data_dict = self.prepare_data(data_dict)
        mix_cfg = self.dataset_cfg.get("MIX3D", None)
        if mix_cfg and self.training and not _mix3d_inner:
            if self.rng.rand() < float(mix_cfg.get("PROB", 1.0)):
                other = self.__getitem__(self.rng.randint(len(self)), _mix3d_inner=True)
                for key in ("points", "point_sweep", "segmentation_label", "instance_label"):
                    if key in data_dict and key in other:
                        data_dict[key] = np.concatenate([data_dict[key], other[key]], axis=0)
                for key in ("gt_boxes", "gt_names"):
                    if key in data_dict and key in other and len(other[key]):
                        data_dict[key] = np.concatenate([data_dict[key], other[key]], axis=0)
        return data_dict

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names, output_path=None):
        """One anno per sample: frame_id, boxes_lidar, score, name (label l
        names class l - 1; label 0 names the first class) and pred_labels."""
        annos = []
        for i, pd in enumerate(pred_dicts):
            labels = np.asarray(pd["pred_labels"]).astype(int)
            annos.append(dict(
                frame_id=batch_dict["frame_id"][i],
                boxes_lidar=np.asarray(pd["pred_boxes"]),
                score=np.asarray(pd["pred_scores"]),
                name=np.asarray([class_names[max(lab - 1, 0)] for lab in labels]),
                pred_labels=labels,
            ))
        return annos

    def evaluation(self, det_annos, class_names, eval_metric="waymo", **kwargs):
        """(result_str, results) of ``det_annos`` against the annos of the
        first ``len(det_annos)`` infos, in order: "simple" is greedy-matching
        AP, "waymo_ii" the AP/APH by interaction-index level (the annos'
        ``interaction_index``), any other metric the Waymo-style AP/APH."""
        from ..runtime import eval_utils
        from .waymo_eval_ii import ap_by_interaction_index

        gt_annos = [copy.deepcopy(info["annos"]) for info in self.infos[:len(det_annos)]]
        if eval_metric == "simple":
            return eval_utils.simple_detection_eval(det_annos, gt_annos, class_names)
        if eval_metric == "waymo_ii":
            return ap_by_interaction_index(det_annos, gt_annos, class_names)
        return eval_utils.waymo_style_ap(det_annos, gt_annos, class_names)
