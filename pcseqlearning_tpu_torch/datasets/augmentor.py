"""Global data augmentation on host NumPy (counterpart of
pcseqlearning_tpu.datasets.augmentor): random world flip, rotation, scaling
and translation of the points and the GT boxes.

The arithmetic is the JAX module's: ``_rotate_z`` builds a float32 matrix
and returns ``pts @ rot``; a flip along x negates y and the heading, a flip
along y negates x and sets the heading to ``-(h + pi)``; rotation and
scaling record ``aug_world_rotation`` and ``aug_world_scaling``. The draws
come from an explicit ``np.random.RandomState`` where the JAX module draws
from the global one. The dataset hands the augmentor and its processors one
``RandomState``, so with the same seed the draws follow JAX's global
sequence: the augmentors first, then ``shuffle_points``.

The local (per-object) augmentors, ``gt_sampling``, ``SemanticSegSampler``
and ``point_contrast_views`` are not ported: no config under
``tools/cfgs/`` names them, and they raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np

from ..utils.edict import EDict

_GLOBAL = ("random_world_flip", "random_world_rotation", "random_world_scaling",
           "random_world_translation")


def _rotate_z(pts, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    return pts @ rot


class DataAugmentor:
    """Augmentor queue: each AUG_CONFIG_LIST entry's NAME selects a method
    (entries named in DISABLE_AUG_LIST are skipped), which returns the
    callable the queue runs on a sample dict."""

    def __init__(self, augmentor_configs, class_names=None, root_path=None, logger=None,
                 rng=None):
        self.class_names = class_names
        self.root_path = root_path
        self.rng = rng if rng is not None else np.random.RandomState(0)
        if isinstance(augmentor_configs, dict):
            cfg_list = augmentor_configs["AUG_CONFIG_LIST"]
            disable = augmentor_configs.get("DISABLE_AUG_LIST", [])
        else:
            cfg_list, disable = augmentor_configs, []
        self.queue = []
        for cfg in cfg_list:
            cfg = EDict(cfg)
            if cfg.NAME in disable:
                continue
            if cfg.NAME not in _GLOBAL:
                raise NotImplementedError(
                    f"DataAugmentor: {cfg.NAME} is not ported yet (ROADMAP.md, queue 1 item 5: "
                    "the local augmentors and gt_sampling)")
            self.queue.append(getattr(self, cfg.NAME)(config=cfg))

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return lambda d: self.random_world_flip(d, config)
        for axis in config.get("ALONG_AXIS_LIST", ["x"]):
            if self.rng.rand() < 0.5:
                continue
            pts = data_dict["points"]
            gb = data_dict.get("gt_boxes")
            if axis == "x":  # flip y
                pts[:, 1] = -pts[:, 1]
                if gb is not None and len(gb):
                    gb[:, 1] = -gb[:, 1]
                    gb[:, 6] = -gb[:, 6]
            else:  # flip x
                pts[:, 0] = -pts[:, 0]
                if gb is not None and len(gb):
                    gb[:, 0] = -gb[:, 0]
                    gb[:, 6] = -(gb[:, 6] + np.pi)
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return lambda d: self.random_world_rotation(d, config)
        rot_range = config.get("WORLD_ROT_ANGLE", [-0.78539816, 0.78539816])
        angle = self.rng.uniform(rot_range[0], rot_range[1])
        pts = data_dict["points"]
        pts[:, :3] = _rotate_z(pts[:, :3], angle)
        gb = data_dict.get("gt_boxes")
        if gb is not None and len(gb):
            gb[:, :3] = _rotate_z(gb[:, :3], angle)
            gb[:, 6] += angle
        data_dict["aug_world_rotation"] = angle
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return lambda d: self.random_world_scaling(d, config)
        lo, hi = config.get("WORLD_SCALE_RANGE", [0.95, 1.05])
        scale = self.rng.uniform(lo, hi)
        data_dict["points"][:, :3] *= scale
        gb = data_dict.get("gt_boxes")
        if gb is not None and len(gb):
            gb[:, :6] *= scale
        data_dict["aug_world_scaling"] = scale
        return data_dict

    def random_world_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return lambda d: self.random_world_translation(d, config)
        std = config.get("NOISE_TRANSLATE_STD", [0.0, 0.0, 0.0])
        offset = self.rng.normal(0, std, 3).astype(np.float32)
        data_dict["points"][:, :3] += offset
        gb = data_dict.get("gt_boxes")
        if gb is not None and len(gb):
            gb[:, :3] += offset
        return data_dict

    def forward(self, data_dict):
        for aug in self.queue:
            data_dict = aug(data_dict)
        return data_dict

    __call__ = forward
