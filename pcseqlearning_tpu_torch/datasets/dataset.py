"""Dataset template and key-name-driven batch collation (counterpart of
pcseqlearning_tpu.datasets.dataset).

``prepare_data`` filters the GT boxes by class and augments (training),
sets the class ids, encodes the point features and runs the processors;
``collate_batch`` pads boxes to [B, max_gt, C], concatenates point arrays
and prefixes a batch index, turning ``points`` into ``point_bxyz`` and
``point_feat``.
"""

from __future__ import annotations

import numpy as np

from ..utils.edict import EDict
from .augmentor import DataAugmentor
from .processor import DataProcessor, PointFeatureEncoder


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True, root_path=None,
                 logger=None, rng=None):
        self.dataset_cfg = EDict(dataset_cfg or {})
        self.training = training
        self.class_names = class_names or []
        self.root_path = root_path
        self.logger = logger
        self.point_cloud_range = np.asarray(
            self.dataset_cfg.get("POINT_CLOUD_RANGE", [-75.2, -75.2, -2, 75.2, 75.2, 4]),
            np.float32)
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg.get("POINT_FEATURE_ENCODING", {}))
        # one RandomState for the dataset, the augmentor and the processors:
        # their draws follow the JAX package's global sequence
        self.rng = rng if rng is not None else np.random.RandomState(0)
        aug_cfg = self.dataset_cfg.get("DATA_AUGMENTOR", None)
        self.data_augmentor = (DataAugmentor(aug_cfg, class_names, rng=self.rng)
                               if training and aug_cfg else None)
        self.data_processor = DataProcessor(
            self.dataset_cfg.get("DATA_PROCESSOR", []),
            point_cloud_range=self.point_cloud_range, training=training, rng=self.rng)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def prepare_data(self, data_dict):
        if (self.training and "gt_names" in data_dict
                and data_dict.get("gt_boxes") is not None):
            keep = np.isin(data_dict["gt_names"], self.class_names)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][keep]
            data_dict["gt_names"] = np.asarray(data_dict["gt_names"])[keep]
            if self.data_augmentor is not None:
                data_dict = self.data_augmentor(data_dict)
        if ("gt_names" in data_dict and data_dict.get("gt_boxes") is not None
                and len(data_dict["gt_boxes"])):
            cls_ids = np.array(
                [self.class_names.index(n) + 1 if n in self.class_names else 0
                 for n in data_dict["gt_names"]], np.float32)
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"][:, :7], cls_ids[:, None]], axis=1).astype(np.float32)
        data_dict = self.point_feature_encoder(data_dict)
        return self.data_processor(data_dict)


_CONCAT_KEYS = ("point_sweep", "segmentation_label", "instance_label", "point_box_label",
                "is_foreground")
_LIST_KEYS = ("frame_id", "metadata", "obj_ids", "pose", "gt_names", "gt_box_attr",
              "gt_box_cls_label", "augmented", "num_points_in_gt", "top_lidar_origin",
              "num_sweeps", "gt_box_corners_3d")


def collate_batch(batch_list):
    """One batch dict from a list of samples, by key name."""
    out = {}
    keys = set()
    for s in batch_list:
        keys |= set(s.keys())
    batch_size = len(batch_list)
    for key in keys:
        vals = [s.get(key) for s in batch_list]
        if key in ("points", "point_xyz", "point_fxyz"):
            cat = []
            for b, v in enumerate(vals):
                if v is None:
                    continue
                cat.append(np.concatenate([np.full((len(v), 1), b, v.dtype), v[:, :3]], axis=1))
            out["point_bxyz"] = np.concatenate(cat, axis=0)
            if key == "points" and vals[0] is not None and vals[0].shape[1] > 3:
                out["point_feat"] = np.concatenate([v[:, 3:] for v in vals if v is not None],
                                                   axis=0)
        elif key in _CONCAT_KEYS:
            if vals[0] is not None:
                out[key] = np.concatenate([v for v in vals if v is not None], axis=0)
        elif key == "gt_boxes":
            max_gt = max(len(v) if v is not None else 0 for v in vals)
            c = vals[0].shape[-1] if (vals[0] is not None and len(vals[0])) else 8
            padded = np.zeros((batch_size, max(max_gt, 1), c), np.float32)
            for b, v in enumerate(vals):
                if v is not None and len(v):
                    padded[b, :len(v)] = v
            out[key] = padded
        elif key in _LIST_KEYS:
            out[key] = list(vals)
        elif isinstance(vals[0], np.ndarray):
            try:
                out[key] = np.stack(vals, axis=0)
            except ValueError:
                out[key] = vals
        else:
            out[key] = vals
    out["batch_size"] = batch_size
    return out
