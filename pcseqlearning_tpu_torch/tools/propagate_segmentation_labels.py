"""Propagate a sequence's sparse segmentation labels to its unlabeled frames
through the GT boxes (counterpart of the repository's
``tools/propagate_segmentation_labels.py``).

    python -m pcseqlearning_tpu_torch.tools.propagate_segmentation_labels \
        <data_cfg.yaml> [--device cuda|cpu]

For every sequence directory under DATA_CONFIG's DATA_PATH /
PROCESSED_DATA_TAG (relative to the working directory unless absolute) that
holds its ``<seq>.pkl``: pass 1 takes, in each frame with a ``_seg.npy``,
each GT object's points (``ops.boxes.points_in_boxes`` over the whole frame
on ``--device``) and the median of their non-zero semantic labels; an
object's label is the median of those medians over the labeled frames.
Pass 2 writes, for each frame without a ``_seg.npy``, ``NNNN_propseg.npy``
[N, 2] int64: (box index + 1, the object's label) for the points in a box
of a labeled object, zeros elsewhere (a later box overwrites an earlier
one), as the JAX tool does: the first column is the box's index in the
frame, not an instance id.
"""

from __future__ import annotations

import argparse
import pickle
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..config import cfg_from_yaml_file
from ..device import resolve_device
from ..ops.boxes import points_in_boxes
from ..utils.edict import EDict


def _inside(pts, boxes, dev):
    """[M, N] bool: point n in box m, computed on ``dev``."""
    return points_in_boxes(torch.as_tensor(pts.astype(np.float32), device=dev),
                           torch.as_tensor(boxes.astype(np.float32), device=dev)).cpu().numpy()


def box_face_distance(xyz, boxes, margin=1e-2):
    """Each point's distance (m, float64) to the nearest face of
    ``points_in_boxes``' test over ``boxes`` [M, 7] (x and y half-sizes
    grown by ``margin``): where float32 rounding on two devices may decide
    a point's membership differently."""
    p = np.asarray(xyz, np.float64)[:, None, :] - boxes[None, :, :3].astype(np.float64)
    heading = -boxes[:, 6].astype(np.float64)
    c, s = np.cos(heading), np.sin(heading)
    lx = p[..., 0] * c - p[..., 1] * s
    ly = p[..., 0] * s + p[..., 1] * c
    d = np.stack([np.abs(np.abs(lx) - (boxes[:, 3] / 2 + margin)),
                  np.abs(np.abs(ly) - (boxes[:, 4] / 2 + margin)),
                  np.abs(np.abs(p[..., 2]) - boxes[:, 5] / 2)], -1)
    return d.min(-1).min(-1)


def _boxes_and_ids(info):
    annos = info.get("annos", {})
    boxes = np.asarray(annos.get("gt_boxes_lidar", np.zeros((0, 7)))).reshape(-1, 7)
    return boxes, np.asarray(annos.get("obj_ids", []))


def process_sequence(seq_dir, infos, device="cuda"):
    """Write the ``_propseg.npy`` files of one sequence; returns how many."""
    dev = resolve_device(device)
    seq_dir = Path(seq_dir)
    # pass 1: each object's median label over the labeled frames
    obj_labels = defaultdict(list)
    for info in infos:
        idx = info["point_cloud"]["sample_idx"]
        seg_file = seq_dir / ("%04d_seg.npy" % idx)
        if not seg_file.exists():
            continue
        seg = np.load(seg_file)
        pts = np.load(seq_dir / ("%04d.npy" % idx))[:, :3]
        boxes, obj_ids = _boxes_and_ids(info)
        if len(boxes) == 0:
            continue
        bp = _inside(pts, boxes, dev)
        for j, oid in enumerate(obj_ids):
            lab = seg[bp[j], 1]
            lab = lab[lab > 0]
            if len(lab):
                obj_labels[oid].append(int(np.median(lab)))
    obj_label = {k: int(np.median(v)) for k, v in obj_labels.items() if v}

    # pass 2: the unlabeled frames
    n_written = 0
    for info in infos:
        idx = info["point_cloud"]["sample_idx"]
        if (seq_dir / ("%04d_seg.npy" % idx)).exists():
            continue
        pts = np.load(seq_dir / ("%04d.npy" % idx))[:, :3]
        boxes, obj_ids = _boxes_and_ids(info)
        prop = np.zeros((len(pts), 2), np.int64)
        if len(boxes):
            bp = _inside(pts, boxes, dev)
            for j, oid in enumerate(obj_ids):
                if oid in obj_label:
                    prop[bp[j], 1] = obj_label[oid]
                    prop[bp[j], 0] = j + 1
        np.save(seq_dir / ("%04d_propseg.npy" % idx), prop)
        n_written += 1
    return n_written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_cfg", type=str)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = cfg_from_yaml_file(args.data_cfg, EDict())
    data_path = Path(cfg.DATA_CONFIG.get("DATA_PATH", ".")) / cfg.DATA_CONFIG.get(
        "PROCESSED_DATA_TAG", "waymo_processed_data")
    written = {}
    for seq_dir in sorted(p for p in data_path.iterdir() if p.is_dir()):
        pkl = seq_dir / f"{seq_dir.name}.pkl"
        if not pkl.exists():
            continue
        with open(pkl, "rb") as f:
            infos = pickle.load(f)
        written[seq_dir.name] = process_sequence(seq_dir, infos, args.device)
        print(f"{seq_dir.name}: wrote {written[seq_dir.name]} propseg frames")
    return written


if __name__ == "__main__":
    main()
