"""Data augmentation on host NumPy (counterpart of
pcseqlearning_tpu.datasets.augmentor): random world flip, rotation, scaling
and translation of the points and the GT boxes; the local (per-object)
translation, rotation and scaling; GT-database paste sampling
(``gt_sampling``); the semantic paste sampler ``SemanticSegSampler``; and
``point_contrast_views``.

The arithmetic is the JAX module's: ``_rotate_z`` builds a float32 matrix
and returns ``pts @ rot``; a flip along x negates y and the heading, a flip
along y negates x and sets the heading to ``-(h + pi)``; rotation and
scaling record ``aug_world_rotation`` and ``aug_world_scaling``. The draws
come from an explicit ``np.random.RandomState`` where the JAX module draws
from the global one, in the same order: per box, then per axis, in the
local augmentors; one ``choice(..., replace=False)`` per class in
``gt_sampling``. The dataset hands the augmentor and its processors one
``RandomState``, so with the same seed the draws follow JAX's global
sequence: the augmentors first, then ``shuffle_points``.

``gt_sampling`` reads the database that ``tools.create_gt_database`` writes
(``DB_INFO_PATH``, default ``waymo_dbinfos_train.pkl``, and each object's
``path``), resolved against ``root_path``, or the working directory when
there is none (the dataset builds its augmentor without one, as JAX's
does). Where the pickle is missing the sampler pastes nothing, as in JAX.
It keeps JAX's quirk of carrying only ``[:, :7]`` of the scene's boxes
once it pastes. The scene's points inside a pasted box are found with
``ops.boxes.points_in_boxes`` on CPU tensors.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from ..ops.boxes import points_in_boxes
from ..utils.box_utils import boxes3d_nearest_bev_iou
from ..utils.edict import EDict

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

    # -- local (per-object) augmentors ----------------------------------

    def _member_mask(self, points, box):
        """[N] bool: the points inside one rotated box [7]."""
        d = points[:, :3] - box[:3]
        c, s = np.cos(-box[6]), np.sin(-box[6])
        lx = d[:, 0] * c - d[:, 1] * s
        ly = d[:, 0] * s + d[:, 1] * c
        return ((np.abs(lx) < box[3] / 2) & (np.abs(ly) < box[4] / 2)
                & (np.abs(d[:, 2]) < box[5] / 2))

    def random_local_translation(self, data_dict=None, config=None):
        """Each GT box and its member points moved by one uniform draw per
        axis of ALONG_AXIS_LIST."""
        if data_dict is None:
            return lambda d: self.random_local_translation(d, config)
        lo, hi = config["LOCAL_TRANSLATION_RANGE"]
        axes = {"x": 0, "y": 1, "z": 2}
        boxes = data_dict.get("gt_boxes", np.zeros((0, 7), np.float32))
        pts = data_dict["points"]
        for bi in range(len(boxes)):
            m = self._member_mask(pts, boxes[bi])
            for ax in config.get("ALONG_AXIS_LIST", ["x", "y"]):
                off = self.rng.uniform(lo, hi)
                pts[m, axes[ax]] += off
                boxes[bi, axes[ax]] += off
        data_dict["points"] = pts
        if len(boxes):
            data_dict["gt_boxes"] = boxes
        return data_dict

    def random_local_rotation(self, data_dict=None, config=None):
        """Each GT box and its member points rotated about the box centre."""
        if data_dict is None:
            return lambda d: self.random_local_rotation(d, config)
        rr = config["LOCAL_ROT_ANGLE"]
        if not isinstance(rr, (list, tuple)):
            rr = [-rr, rr]
        boxes = data_dict.get("gt_boxes", np.zeros((0, 7), np.float32))
        pts = data_dict["points"]
        for bi in range(len(boxes)):
            m = self._member_mask(pts, boxes[bi])
            ang = self.rng.uniform(rr[0], rr[1])
            ctr = boxes[bi, :3]
            pts[m, :3] = _rotate_z(pts[m, :3] - ctr, ang) + ctr
            boxes[bi, 6] += ang
        data_dict["points"] = pts
        if len(boxes):
            data_dict["gt_boxes"] = boxes
        return data_dict

    def random_local_scaling(self, data_dict=None, config=None):
        """Each GT box's sizes and its member points scaled about its
        centre."""
        if data_dict is None:
            return lambda d: self.random_local_scaling(d, config)
        lo, hi = config["LOCAL_SCALE_RANGE"]
        boxes = data_dict.get("gt_boxes", np.zeros((0, 7), np.float32))
        pts = data_dict["points"]
        for bi in range(len(boxes)):
            m = self._member_mask(pts, boxes[bi])
            s = self.rng.uniform(lo, hi)
            ctr = boxes[bi, :3]
            pts[m, :3] = (pts[m, :3] - ctr) * s + ctr
            boxes[bi, 3:6] *= s
        data_dict["points"] = pts
        if len(boxes):
            data_dict["gt_boxes"] = boxes
        return data_dict

    def gt_sampling(self, data_dict=None, config=None):
        """Paste database objects: up to SAMPLE_GROUPS of each class, none
        whose BEV extent meets a scene box or an already pasted one."""
        if data_dict is None:
            self._db_sampler = _DatabaseSampler(config, self.root_path, self.rng)
            return lambda d: self.gt_sampling(d, config)
        return self._db_sampler(data_dict)

    def forward(self, data_dict):
        for aug in self.queue:
            data_dict = aug(data_dict)
        return data_dict

    __call__ = forward


class _DatabaseSampler:
    """The GT paste sampler of ``gt_sampling``. ``db_infos``: {class: the
    database records with at least MIN_POINTS points}, empty where the
    pickle is missing; ``groups``: {class: the count SAMPLE_GROUPS asks a
    scene to hold} ("Vehicle:15" specs)."""

    def __init__(self, config, root_path=None, rng=None):
        self.cfg = EDict(config)
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.root = Path(root_path or ".")
        self.db_infos = {}
        db_path = self.root / self.cfg.get("DB_INFO_PATH", "waymo_dbinfos_train.pkl")
        if db_path.exists():
            with open(db_path, "rb") as f:
                infos = pickle.load(f)
            min_pts = int(self.cfg.get("MIN_POINTS", 5))
            self.db_infos = {k: [x for x in v if x["num_points_in_gt"] >= min_pts]
                             for k, v in infos.items()}
        self.groups = {}
        for spec in self.cfg.get("SAMPLE_GROUPS", []):
            name, num = str(spec).split(":")
            self.groups[name] = int(num)

    def __call__(self, data_dict):
        if not self.db_infos:
            return data_dict
        existing = data_dict.get("gt_boxes", np.zeros((0, 7), np.float32))[:, :7]
        names = list(data_dict.get("gt_names", []))
        new_pts, new_boxes, new_names = [], [], []
        for cls, want in self.groups.items():
            pool = self.db_infos.get(cls, [])
            need = max(want - sum(1 for n in names if n == cls), 0)
            if need == 0 or not pool:
                continue
            for p in self.rng.choice(len(pool), min(need, len(pool)), replace=False):
                info = pool[p]
                box = np.asarray(info["box3d_lidar"], np.float32)[:7]
                if len(existing) or new_boxes:
                    all_boxes = np.concatenate(
                        [existing] + ([np.stack(new_boxes)] if new_boxes else []), axis=0)
                    if len(all_boxes) and boxes3d_nearest_bev_iou(box[None], all_boxes).max() > 0:
                        continue
                path = self.root / info["path"]
                if not path.exists():
                    continue
                pts = np.fromfile(path, np.float32).reshape(-1, int(info.get("num_features", 8)))
                pts[:, :3] += box[:3]
                new_pts.append(pts)
                new_boxes.append(box)
                new_names.append(cls)
        if new_boxes:
            nb = np.stack(new_boxes)
            # the scene's points inside a pasted box go before the paste
            pts0 = data_dict["points"]
            if len(pts0):
                inside = points_in_boxes(torch.as_tensor(pts0[:, :3].astype(np.float32)),
                                         torch.as_tensor(nb)).numpy()
                data_dict["points"] = pts0[~inside.any(axis=0)]
            data_dict["gt_boxes"] = np.concatenate([existing, nb], axis=0)
            data_dict["gt_names"] = np.asarray(names + new_names)
            c = data_dict["points"].shape[1]
            add = np.concatenate(new_pts, axis=0)[:, :c]
            if add.shape[1] < c:
                add = np.pad(add, ((0, 0), (0, c - add.shape[1])))
            data_dict["points"] = np.concatenate([data_dict["points"], add.astype(np.float32)],
                                                 axis=0)
        return data_dict


class SemanticSegSampler:
    """Semantic paste augmentation: foreground instance crops of a seg
    database (``DB_PATH``, a pickle {"infos": [{points, support_cls,
    trans_z}], "by_cls": {class id: [info index]}}) pasted onto a random
    point of their support class (SUPPORT_CLASSES), centred there and
    lifted by the crop's ``trans_z``, SAMPLE_GROUPS ("cls:num") of each
    class, or up to SCENE_LIMIT instances of it in the scene. Each class
    walks a permutation of its pool round-robin across scenes and draws a
    new one when the pool is used up. Draws come from ``rng`` in the JAX
    module's order."""

    def __init__(self, config, root_path=None, rng=None):
        self.cfg = EDict(config)
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.root = Path(root_path or ".")
        db_path = self.root / self.cfg.get("DB_PATH", "waymo_seg_db.pkl")
        self.db = {"infos": [], "by_cls": {}}
        if db_path.exists():
            with open(db_path, "rb") as f:
                self.db = pickle.load(f)
        self.sample_groups = {}
        for spec in self.cfg.get("SAMPLE_GROUPS", []):
            cls_id, num = str(spec).split(":")
            self.sample_groups[int(cls_id)] = dict(
                sample_num=int(num), scene_limit=int(self.cfg.get("SCENE_LIMIT", 0)),
                pointer=1 << 30, indices=np.zeros(0, np.int64))

    def _draw(self, cls_id, group, sample_num):
        """The next ``sample_num`` infos of the class's permutation (the
        group dict persists across scenes)."""
        pool = self.db["by_cls"].get(cls_id, [])
        if not pool:
            return []
        if group["pointer"] >= len(pool):
            group["indices"] = self.rng.permutation(len(pool))
            group["pointer"] = 0
        take = group["indices"][group["pointer"]:group["pointer"] + sample_num]
        group["pointer"] += sample_num
        return [self.db["infos"][pool[i]] for i in take]

    def __call__(self, data_dict):
        pts = data_dict["points"]
        seg = data_dict.get("segmentation_label")
        if seg is None or not self.sample_groups:
            return data_dict
        inst = data_dict.get("instance_label", np.zeros_like(seg))
        support_ids = list(self.cfg.get("SUPPORT_CLASSES", [18, 21, 22]))
        support_pts = {c: pts[seg == c, :3] for c in support_ids}
        add_p, add_s, add_i = [], [], []
        next_inst = int(inst.max()) + 1 if len(inst) else 0
        for cls_id, group in self.sample_groups.items():
            want = group["sample_num"]
            if group["scene_limit"] > 0:
                want = max(group["scene_limit"] - len(np.unique(inst[seg == cls_id])), 0)
            if want <= 0:
                continue
            for info in self._draw(cls_id, group, want):
                cand = support_pts.get(int(info.get("support_cls", support_ids[0])))
                if cand is None or len(cand) == 0:
                    continue
                loc = cand[self.rng.randint(len(cand))]
                crop = np.asarray(info["points"], np.float32).copy()
                crop[:, :3] -= crop[:, :3].mean(0)
                crop[:, :3] += loc
                crop[:, 2] += float(info.get("trans_z", 0.0))
                add_p.append(crop[:, :pts.shape[1]])
                add_s.append(np.full(len(crop), cls_id, seg.dtype))
                add_i.append(np.full(len(crop), next_inst, inst.dtype))
                next_inst += 1
        if add_p:
            data_dict["points"] = np.concatenate([pts] + add_p, axis=0)
            data_dict["segmentation_label"] = np.concatenate([seg] + add_s, axis=0)
            data_dict["instance_label"] = np.concatenate([inst] + add_i, axis=0)
        return data_dict


def point_contrast_views(points, rot_range=(-np.pi, np.pi), scale_range=(0.9, 1.1),
                         jitter=0.02, rng=None):
    """Two randomly rotated, scaled and jittered views of a scene for
    contrastive pretraining, and their correspondence: (view1, view2,
    pair_idx), row i of view1 matching row i of view2. Draws come from
    ``rng``: per view the angle, the scale, then the jitter."""
    rng = rng if rng is not None else np.random.RandomState(0)

    def one_view(p):
        q = p.copy()
        q[:, :3] = _rotate_z(q[:, :3], rng.uniform(*rot_range))
        q[:, :3] *= rng.uniform(*scale_range)
        q[:, :3] += rng.randn(*q[:, :3].shape).astype(q.dtype) * jitter
        return q

    v1 = one_view(points)
    return v1, one_view(points), np.arange(len(points))
