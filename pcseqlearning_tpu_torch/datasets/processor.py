"""Point feature encoding and the config-driven data processing queue
(counterpart of pcseqlearning_tpu.datasets.processor), on host NumPy.

Processors: ``mask_points_and_boxes_outside_range``, ``shuffle_points``,
``limit_num_points``, ``transform_points_to_voxels`` (the DRY path that the
detection configs use: the dynamic VFE voxelizes on the device, so the
processor records the grid's voxel size and shape),
``propagate_box_label_to_points`` (``ops.boxes.points_in_boxes`` on CPU
tensors), ``attach_spherical_feature``, ``point_centering``,
``remove_seg_class``, ``shift_to_top_lidar_origin``, ``estimate_velocity``
(keeps the object traces seen from sweep 0), ``sync_box_motion`` (a no-op,
as in JAX) and ``lidar_line_segment`` / ``_v2`` (v1 runs v2, as in JAX).
Random draws come from an explicit ``np.random.RandomState`` (the JAX
module draws from the global one; with the same seed the draws are equal).

``lidar_line_segment_v2`` finds each range-image row's 10 nearest
neighbours with ``knn`` (``scipy.spatial.cKDTree``) where JAX uses
scikit-learn's ``NearestNeighbors``: the same neighbours, with distances that
may differ by one rounding, so an edge may flip only for a pair within a
rounding of DIST_TH, or where the 10th and 11th neighbours tie (``knn``
takes the lower index, scikit-learn's tree its own traversal order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.boxes import points_in_boxes
from ..utils.edict import EDict

_POINT_KEYS = ("points", "point_sweep", "segmentation_label", "instance_label")


class PointFeatureEncoder:
    """Selects the ``used_feature_list`` channels of the raw point array
    (whose channels ``src_feature_list`` names); x, y, z first."""

    def __init__(self, config):
        self.config = EDict(config)
        self.src_list = list(self.config.get("src_feature_list", ["x", "y", "z", "intensity"]))
        self.used_list = list(self.config.get("used_feature_list", ["x", "y", "z", "intensity"]))

    @property
    def num_point_features(self):
        return len(self.used_list)

    def __call__(self, data_dict):
        idx = [self.src_list.index(f) for f in self.used_list]
        data_dict["points"] = data_dict["points"][:, idx]
        data_dict["use_lead_xyz"] = True
        return data_dict


class DataProcessor:
    """Processor queue: each config entry's NAME selects a method, which
    returns the callable the queue runs."""

    def __init__(self, processor_configs, point_cloud_range, training, rng=None):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.grid_size = None
        self.voxel_size = None
        self.queue = []
        for cfg in processor_configs:
            cfg = EDict(cfg)
            self.queue.append(getattr(self, cfg.NAME)(config=cfg))

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return lambda d: self.mask_points_and_boxes_outside_range(d, config)
        pts = data_dict["points"]
        pcr = self.point_cloud_range
        mask = np.all((pts[:, 0:3] >= pcr[0:3]) & (pts[:, 0:3] <= pcr[3:6]), axis=1)
        for key in _POINT_KEYS:
            if key in data_dict and data_dict[key] is not None and len(data_dict[key]) == len(mask):
                data_dict[key] = data_dict[key][mask]
        if config.get("REMOVE_OUTSIDE_BOXES", True) and self.training and "gt_boxes" in data_dict:
            gb = data_dict["gt_boxes"]
            bm = np.all((gb[:, 0:3] >= pcr[0:3] - 1) & (gb[:, 0:3] <= pcr[3:6] + 1), axis=1)
            data_dict["gt_boxes"] = gb[bm]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = np.asarray(data_dict["gt_names"])[bm]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return lambda d: self.shuffle_points(d, config)
        if config.get("SHUFFLE_ENABLED", {}).get("train" if self.training else "test",
                                                 self.training):
            n = len(data_dict["points"])
            perm = self.rng.permutation(n)
            for key in _POINT_KEYS:
                if key in data_dict and data_dict[key] is not None and len(data_dict[key]) == n:
                    data_dict[key] = data_dict[key][perm]
        return data_dict

    def limit_num_points(self, data_dict=None, config=None):
        """A uniform subsample (without replacement) to MAX_NUM_POINTS."""
        if data_dict is None:
            return lambda d: self.limit_num_points(d, config)
        max_n = int(config["MAX_NUM_POINTS"])
        n = len(data_dict["points"])
        if n > max_n:
            sel = self.rng.choice(n, max_n, replace=False)
            for key in _POINT_KEYS:
                if key in data_dict and data_dict[key] is not None and len(data_dict[key]) == n:
                    data_dict[key] = data_dict[key][sel]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        """Records the grid: VOXEL_SIZE and the range over it, rounded."""
        if data_dict is None:
            self.voxel_size = np.asarray(config["VOXEL_SIZE"], np.float32)
            grid = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / self.voxel_size
            self.grid_size = np.round(grid).astype(np.int64)
            return lambda d: self.transform_points_to_voxels(d, config)
        data_dict["voxel_size"] = self.voxel_size
        data_dict["grid_size"] = self.grid_size
        return data_dict

    def propagate_box_label_to_points(self, data_dict=None, config=None):
        """``point_box_label``: the first GT box holding each point, -1
        where none does."""
        if data_dict is None:
            return lambda d: self.propagate_box_label_to_points(d, config)
        if "gt_boxes" in data_dict and len(data_dict["gt_boxes"]):
            bp = points_in_boxes(
                torch.as_tensor(data_dict["points"][:, :3].astype(np.float32)),
                torch.as_tensor(data_dict["gt_boxes"][:, :7].astype(np.float32))).numpy()
            data_dict["point_box_label"] = np.where(bp.any(0), bp.argmax(0), -1)
        else:
            data_dict["point_box_label"] = np.full(len(data_dict["points"]), -1)
        return data_dict

    def attach_spherical_feature(self, data_dict=None, config=None):
        """Appends (r, theta, phi) to each point."""
        if data_dict is None:
            return lambda d: self.attach_spherical_feature(d, config)
        xyz = data_dict["points"][:, :3]
        r = np.linalg.norm(xyz, axis=1)
        theta = np.arccos(np.clip(xyz[:, 2] / np.maximum(r, 1e-6), -1, 1))
        phi = np.arctan2(xyz[:, 1], xyz[:, 0])
        data_dict["points"] = np.concatenate(
            [data_dict["points"], np.stack([r, theta, phi], 1).astype(np.float32)], axis=1)
        return data_dict

    def point_centering(self, data_dict=None, config=None):
        """Moves the points' mean to the origin; ``center_offset`` is it."""
        if data_dict is None:
            return lambda d: self.point_centering(d, config)
        center = data_dict["points"][:, :3].mean(0)
        data_dict["points"][:, :3] -= center
        data_dict["center_offset"] = center
        return data_dict

    def remove_seg_class(self, data_dict=None, config=None):
        """Drops the points whose segmentation label is in CLASS_IDS."""
        if data_dict is None:
            return lambda d: self.remove_seg_class(d, config)
        if "segmentation_label" in data_dict:
            seg = data_dict["segmentation_label"]
            keep = ~np.isin(seg, np.asarray(config["CLASS_IDS"]))
            n = len(seg)
            for key in _POINT_KEYS:
                if key in data_dict and data_dict[key] is not None and len(data_dict[key]) == n:
                    data_dict[key] = data_dict[key][keep]
        return data_dict

    def shift_to_top_lidar_origin(self, data_dict=None, config=None):
        """Re-origins the points at ``top_lidar_origin``, then zeroes it."""
        if data_dict is None:
            return lambda d: self.shift_to_top_lidar_origin(d, config)
        origin = np.asarray(data_dict.get("top_lidar_origin", np.zeros(3)), np.float32)
        data_dict["points"][:, :3] -= origin
        data_dict["top_lidar_origin"] = np.zeros_like(origin)
        return data_dict

    def estimate_velocity(self, data_dict=None, config=None):
        """Keeps only the object traces (``obj_ids``) whose earliest
        ``obj_sweep`` is 0: every ``obj_*`` / ``gt_*`` array of their length
        is filtered; ``obj_ids`` is popped. Without ``obj_sweep`` nothing
        changes."""
        if data_dict is None:
            return lambda d: self.estimate_velocity(d, config)
        if "obj_ids" not in data_dict or "obj_sweep" not in data_dict:
            return data_dict
        obj_ids = np.asarray(data_dict["obj_ids"])
        obj_sweeps = np.asarray(data_dict["obj_sweep"])
        keep = np.ones(len(obj_ids), bool)
        for oid in np.unique(obj_ids):
            m = obj_ids == oid
            if obj_sweeps[m].min() != 0:
                keep[m] = False
        n = len(obj_ids)
        for key in list(data_dict.keys()):
            v = data_dict[key]
            if isinstance(v, np.ndarray) and len(v) == n and key.startswith(("obj_", "gt_")):
                data_dict[key] = v[keep]
        data_dict.pop("obj_ids", None)
        return data_dict

    def sync_box_motion(self, data_dict=None, config=None):
        """A no-op, as in the JAX package (whose reference is a stub)."""
        if data_dict is None:
            return lambda d: self.sync_box_motion(d, config)
        return data_dict

    def lidar_line_segment(self, data_dict=None, config=None):
        """Runs ``lidar_line_segment_v2`` (v1 is a stub in the reference)."""
        if data_dict is None:
            return lambda d: self.lidar_line_segment(d, config)
        return self.lidar_line_segment_v2(data_dict, config)

    def lidar_line_segment_v2(self, data_dict=None, config=None):
        """Per range-image row (``point_rimage_h``): the 10-NN graph, edges
        kept where distance / (range + 1e-6) < DIST_TH, its connected
        components. ``point_segment_id``: a global segment id a point;
        ``point_in_large_segment``: its segment has more than
        LARGE_SEGMENT_SIZE points."""
        if data_dict is None:
            return lambda d: self.lidar_line_segment_v2(d, config)
        import scipy.sparse as sp
        import scipy.sparse.csgraph as csg

        cfg = config or {}
        dist_th = float(cfg.get("DIST_TH", 0.05))
        min_large = int(cfg.get("LARGE_SEGMENT_SIZE", 30))
        pts = data_dict["points"][:, :3]
        n = len(pts)
        if "point_rimage_h" not in data_dict or n == 0:
            data_dict["point_segment_id"] = np.zeros(n, np.int64)
            data_dict["point_in_large_segment"] = np.zeros(n, bool)
            return data_dict
        rh = np.asarray(data_dict["point_rimage_h"]).astype(np.int64)
        seg_id = np.zeros(n, np.int64)
        offset = 0
        for h in np.unique(rh):
            rows = np.nonzero(rh == h)[0]
            p = pts[rows]
            kk = min(10, len(rows))
            dists, idx = knn(p, p, kk)
            prange = np.linalg.norm(p, axis=-1)
            e0 = np.arange(len(rows)).repeat(kk)
            e1 = idx.reshape(-1)
            ok = dists.reshape(-1) / (prange.repeat(kk) + 1e-6) < dist_th
            g = sp.csr_matrix((np.ones(ok.sum()), (e0[ok], e1[ok])),
                              shape=(len(rows), len(rows)))
            nc, lab = csg.connected_components(g, directed=False)
            seg_id[rows] = offset + lab
            offset += nc
        data_dict["point_segment_id"] = seg_id
        _, inv, counts = np.unique(seg_id, return_inverse=True, return_counts=True)
        data_dict["point_in_large_segment"] = counts[inv] > min_large
        return data_dict

    def forward(self, data_dict):
        for proc in self.queue:
            data_dict = proc(data_dict)
        return data_dict

    __call__ = forward


def knn(ref, query, k):
    """(dists [Q, k] float64, idx [Q, k]): the ``k`` nearest rows of
    ``ref`` to each row of ``query``, nearest first and, among equal
    distances, lowest index first (``scipy.spatial.cKDTree`` over k + 1
    neighbours; distances in float64, as scikit-learn's ``NearestNeighbors``
    gives them)."""
    from scipy.spatial import cKDTree

    kq = min(k + 1, len(ref))
    dists, idx = cKDTree(np.asarray(ref, np.float64)).query(np.asarray(query, np.float64), k=kq)
    if kq == 1:
        dists, idx = dists[:, None], idx[:, None]
    order = np.lexsort((idx, dists), axis=-1)[:, :k]
    return np.take_along_axis(dists, order, -1), np.take_along_axis(idx, order, -1)
