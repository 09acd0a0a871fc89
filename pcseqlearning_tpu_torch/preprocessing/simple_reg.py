"""SimpleReg, the extraction pipeline's entry point (counterpart of
pcseqlearning_tpu.preprocessing.simple_reg).

Splits a collated batch into per-sequence dicts, optionally keeps one point
per 8 cm voxel, formats the GT boxes (frame ids, trace ids from object ids,
per-trace velocity, moving flags), and runs the preprocessor chain once per
sequence, skipping a sequence whose ``SAVE_DIR/<sequence>/all.pkl`` exists.
``device`` is handed to every stage.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops import boxes as box_ops
from ..ops import grid_utils
from ..utils.edict import EDict

_POINT_KEYS = ("point_feat", "segmentation_label", "instance_label", "is_foreground",
               "point_sweep")
_SEQ_KEYS = ("gt_box_cls_label", "gt_box_attr", "augmented", "num_points_in_gt", "gt_boxes",
             "obj_ids", "frame_id", "pose", "top_lidar_origin", "num_sweeps")


def build_preprocessors(model_cfg, runtime_cfg=None, device="cuda"):
    """The PREPROCESSORS stages named in ``model_cfg.PREPROCESSORS``."""
    from . import PREPROCESSORS

    return [PREPROCESSORS[pcfg["NAME"]](pcfg, runtime_cfg, device=device)
            for pcfg in model_cfg.get("PREPROCESSORS", [])]


class SimpleReg:
    def __init__(self, model_cfg, runtime_cfg=None, dataset=None, device="cuda"):
        self.model_cfg = EDict(model_cfg)
        self.dataset = dataset
        self.device = resolve_device(device)
        self.preprocessors = build_preprocessors(self.model_cfg, runtime_cfg, device=self.device)
        self.subsample = bool(self.model_cfg.get("SUBSAMPLE", False))
        self.training = True

    # ------------------------------------------------------------------
    def format_boxes(self, seq_dict):
        """Per-box frame ids, trace ids from object ids, per-trace velocity
        (mean corner displacement between consecutive boxes of the trace)
        and the moving flag (velocity > 0.05)."""
        sweeps = np.asarray(seq_dict["point_sweep"]).reshape(-1)
        num_frames = int(sweeps.max()) - int(sweeps.min()) + 1
        attr = np.asarray(seq_dict["gt_box_attr"]).reshape(-1, 7)
        cls_label = np.asarray(seq_dict["gt_box_cls_label"]).reshape(-1)
        assert attr.shape[0] % num_frames == 0, "boxes must be padded per frame"
        per_frame = attr.shape[0] // num_frames
        boxes = EDict(gt_box_attr=attr, gt_box_cls_label=cls_label,
                      gt_box_frame=np.repeat(np.arange(num_frames), per_frame))
        non_empty = np.linalg.norm(attr[:, 3:6], axis=-1) > 1e-5
        for k in boxes:
            boxes[k] = boxes[k][non_empty]
        obj_ids = np.asarray(seq_dict["obj_ids"]).reshape(-1)[non_empty].astype(str)
        track_label = np.unique(obj_ids, return_inverse=True)[1]
        boxes.gt_box_track_label = track_label

        velo = np.zeros(boxes.gt_box_attr.shape[0], np.float32)
        for t in np.unique(track_label):
            tm = track_label == t
            order = np.argsort(boxes.gt_box_frame[tm])
            tattr = boxes.gt_box_attr[tm][order]
            corners = box_ops.boxes_to_corners_3d(
                torch.as_tensor(tattr.astype(np.float32), device=self.device)).cpu().numpy()
            tv = np.zeros(len(tattr), np.float32)
            if len(tattr) > 1:
                tv[1:] = np.linalg.norm(corners[1:] - corners[:-1], axis=-1).mean(-1)
                tv[0] = tv[1]
            velo[np.nonzero(tm)[0][order]] = tv
        boxes.gt_box_velo = velo
        boxes.moving = velo > 5e-2
        seq_dict.update(boxes)
        seq_dict["obj_ids"] = obj_ids
        return seq_dict

    # ------------------------------------------------------------------
    def process_sequence(self, seq_dict):
        for module in self.preprocessors:
            seq_dict = module(seq_dict)
        return seq_dict

    def forward(self, batch_dict):
        """Run the chain on every sequence of ``batch_dict``; the results
        land in ``batch_dict["seq_<b>"]``."""
        batch_size = int(batch_dict["batch_size"])
        point_bxyz = np.asarray(batch_dict["point_bxyz"])
        for b in range(batch_size):
            m = point_bxyz[:, 0].round().astype(int) == b
            seq_dict = EDict()
            for key in _POINT_KEYS:
                if key in batch_dict:
                    seq_dict[key] = np.asarray(batch_dict[key])[m]
            sweep = np.asarray(seq_dict["point_sweep"]).reshape(-1, 1).astype(np.float32)
            seq_dict["point_fxyz"] = np.concatenate([sweep, point_bxyz[m][:, 1:4]], axis=1)

            if self.subsample:
                rep, valid, _, _ = grid_utils.grid_subsample_indices(
                    torch.as_tensor(seq_dict["point_fxyz"].astype(np.float32),
                                    device=self.device), [0.08, 0.08, 0.08])
                idx = rep[valid].cpu().numpy()
                print(f"num points={len(idx)}")
                for key in ("point_fxyz",) + _POINT_KEYS:
                    if key in seq_dict:
                        seq_dict[key] = np.asarray(seq_dict[key])[idx]

            for key in _SEQ_KEYS:
                if key in batch_dict:
                    v = batch_dict[key]
                    seq_dict[key] = (v[b] if isinstance(v, (list, np.ndarray))
                                     and len(v) == batch_size else v)

            seq_dict = self.format_boxes(seq_dict)
            fid = seq_dict.get("frame_id", "seq_000")
            sequence_id = str(fid[0] if isinstance(fid, (list, np.ndarray)) else fid)
            seq_dict["frame_id"] = sequence_id
            save_dir = self.model_cfg.get("SAVE_DIR", None)
            done = save_dir and os.path.exists(os.path.join(save_dir, sequence_id[:-4], "all.pkl"))
            if not done:
                print(f"Working on {sequence_id}")
                self.process_sequence(seq_dict)
            else:
                print(f"Skipping {sequence_id}")
            batch_dict[f"seq_{b}"] = seq_dict

        if self.training:
            return dict(loss=0.0), {}, {}
        return {}, None

    __call__ = forward
