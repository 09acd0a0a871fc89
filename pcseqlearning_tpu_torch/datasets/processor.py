"""Point feature encoding and the config-driven data processing queue
(counterpart of pcseqlearning_tpu.datasets.processor), on host NumPy.

Ported processors: ``limit_num_points`` (the only one the registration
dataset configs name), ``mask_points_and_boxes_outside_range``,
``shuffle_points`` and ``transform_points_to_voxels`` (the DRY path that
the detection configs use: the dynamic VFE voxelizes on the device, so the
processor records the grid's voxel size and shape). Their random draws come
from an explicit ``np.random.RandomState`` (the JAX module draws from the
global one; with the same seed the draws are equal). Any other processor
NAME raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np

from ..utils.edict import EDict

_POINT_KEYS = ("points", "point_sweep", "segmentation_label", "instance_label")
_PORTED = ("mask_points_and_boxes_outside_range", "shuffle_points", "limit_num_points",
           "transform_points_to_voxels")


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
            if cfg.NAME not in _PORTED:
                raise NotImplementedError(
                    f"DataProcessor: {cfg.NAME} is not ported yet (ROADMAP.md, queue 1 "
                    "item 5)")
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

    def forward(self, data_dict):
        for proc in self.queue:
            data_dict = proc(data_dict)
        return data_dict

    __call__ = forward
