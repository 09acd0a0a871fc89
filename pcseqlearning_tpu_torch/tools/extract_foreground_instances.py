"""The segmentation-driven foreground instance database (counterpart of the
repository's ``tools/extract_foreground_instances.py``).

    python -m pcseqlearning_tpu_torch.tools.extract_foreground_instances \
        --data_path <sequence dir> --out_dir <dir> [--info_pkl <infos.pkl>] \
        [--device cuda|cpu]

For each ``NNNN.npy`` with a ``NNNN_seg.npy`` (instance, class) beside it,
and each foreground class of the strategy table: instances are peeled off
the class's points (by instance label where the strategy uses labels and
a point has one > 0, else by BEV distance to the first remaining point
under the strategy's radius); an instance of more than min_num_points
points is kept; it takes the GT box that holds over 90% of its points
(``ops.boxes.points_in_boxes`` on ``--device``) where the strategy attaches
boxes; points of companion classes within the radius join it; its support
surface is the first support class with a point near its lowest point, and
``trans_z`` the z-gap to the nearest such point; every keep_every-th
instance of a class is written as ``<frame>_class_<cc>_inst_<nnnnnn>.npy``
under ``--out_dir``, and the records of all frames go to
``<out_dir>/foreground_db_infos.pkl``.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..ops.boxes import points_in_boxes

# per foreground seg class: support = surface classes that can carry the
# instance; radius = BEV instance-growth radius; keep_every = keep every
# n-th instance of the class (4 for class 1, 2 for classes 6 and 7)
DEFAULT_STRATEGIES = {
    1: dict(support=[17, 18, 19, 20, 21, 22], radius=3.0, min_num_points=20,
            use_inst_label=True, attach_box=True, keep_every=4),
    2: dict(support=[17, 18, 19, 20, 21, 22], radius=4.0, min_num_points=30,
            use_inst_label=True, attach_box=True),
    3: dict(support=[17, 18, 19, 20, 21, 22], radius=4.0, min_num_points=30,
            use_inst_label=True, attach_box=True),
    4: dict(support=[17, 18, 19, 20, 21, 22], radius=3.0, min_num_points=20,
            use_inst_label=True, attach_box=True),
    5: dict(support=[17, 18, 19, 20, 21, 22], radius=1.5, min_num_points=10,
            use_inst_label=True, attach_box=True, group_with=[6]),
    6: dict(support=[17, 18, 19, 20, 21, 22], radius=1.0, min_num_points=10,
            use_inst_label=True, attach_box=True, keep_every=2),
    7: dict(support=[17, 18, 19, 20, 21, 22], radius=1.0, min_num_points=5,
            use_inst_label=False, attach_box=False, keep_every=2),
}


def extract_foreground_instances(points, seg_cls, seg_inst, gt_boxes, frame_id,
                                 database_save_path, strategies=None, sample_idx=0,
                                 sequence_name="", device="cuda"):
    """{class: [record]} of one frame; writes each kept instance's points
    as an npy under ``database_save_path``."""
    dev = resolve_device(device)
    strategies = strategies or DEFAULT_STRATEGIES
    os.makedirs(database_save_path, exist_ok=True)
    instance_dict = {c: [] for c in strategies}
    instance_count = {c: 0 for c in strategies}
    for fg_cls, strat in strategies.items():
        radius = strat.get("radius", 2.0)
        min_np = strat.get("min_num_points", 5)
        use_inst = strat.get("use_inst_label", False)
        cls_mask = seg_cls == fg_cls
        cls_points = points[cls_mask]
        inst_labels = seg_inst[cls_mask]
        while cls_points.shape[0] > min_np:
            # labels <= 0 mark no instance: peel labelled instances by label,
            # unlabelled points by BEV radius growth
            labeled = inst_labels > 0
            if use_inst and labeled.any():
                m = inst_labels == np.unique(inst_labels[labeled])[0]
            else:
                m = np.linalg.norm((cls_points - cls_points[0])[:, :2], axis=-1) < radius
            instance_pc = cls_points[m]
            cls_points = cls_points[~m]
            inst_labels = inst_labels[~m]
            if instance_pc.shape[0] <= min_np:
                continue
            attaching_box = None
            if strat.get("attach_box") and gt_boxes is not None and len(gt_boxes):
                avg = points_in_boxes(
                    torch.as_tensor(np.asarray(instance_pc[:, :3], np.float32), device=dev),
                    torch.as_tensor(np.asarray(gt_boxes[:, :7], np.float32), device=dev),
                ).cpu().numpy().mean(axis=1)
                if avg.max() > 0.9:
                    attaching_box = gt_boxes[int(avg.argmax())]
            grouping = None
            for g in strat.get("group_with", []):
                g_pts = points[seg_cls == g]
                if not len(g_pts):
                    continue
                gd = np.linalg.norm((g_pts - instance_pc.mean(axis=0))[:, :2], axis=-1)
                if not (gd < radius).any():
                    continue
                grouped = g_pts[gd < radius]
                grouping = dict(cls=[fg_cls, g], offsets=[0, len(instance_pc)],
                                sizes=[len(instance_pc), len(grouped)])
                instance_pc = np.concatenate([instance_pc, grouped])
            low = instance_pc[instance_pc[:, 2].argmin()]
            for support_cls in strat.get("support", []):
                s_pts = points[seg_cls == support_cls]
                if not len(s_pts):
                    continue
                sd = np.linalg.norm((s_pts - low)[:, :3], axis=-1)
                if not use_inst and sd.min() > radius:
                    continue
                trans = (s_pts[sd.argmin()] - low)[2]
                cnt = instance_count[fg_cls]
                instance_count[fg_cls] += 1
                if cnt % strat.get("keep_every", 1) != 0:
                    break
                path = os.path.join(database_save_path,
                                    f"{frame_id}_class_{fg_cls:02d}_inst_{cnt:06d}.npy")
                np.save(path, instance_pc)
                instance_dict[fg_cls].append(dict(
                    trans_z=float(trans), grouping=grouping, support=support_cls, path=path,
                    obj_class=fg_cls, sample_idx=sample_idx, sequence_name=sequence_name,
                    num_points=int(instance_pc.shape[0]), box3d=attaching_box))
                break
    return instance_dict


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_path", required=True,
                        help="sequence dir with NNNN.npy + NNNN_seg.npy")
    parser.add_argument("--info_pkl", default=None, help="sequence infos")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    infos = None
    if args.info_pkl:
        with open(args.info_pkl, "rb") as f:
            infos = pickle.load(f)
    db = {}
    for fn in sorted(os.listdir(args.data_path)):
        if not fn.endswith(".npy") or fn.endswith("_seg.npy"):
            continue
        idx = fn[:-4]
        seg_path = os.path.join(args.data_path, f"{idx}_seg.npy")
        if not os.path.exists(seg_path):
            continue
        pts = np.load(os.path.join(args.data_path, fn))
        seg = np.load(seg_path)
        gt = None
        for info in infos or []:
            if str(info.get("point_cloud", {}).get("sample_idx")) == idx:
                gt = info["annos"]["gt_boxes_lidar"]
                break
        d = extract_foreground_instances(
            pts[:len(seg)], seg[:, 1], seg[:, 0], gt, frame_id=idx,
            database_save_path=args.out_dir, sample_idx=int(idx),
            sequence_name=os.path.basename(args.data_path), device=args.device)
        for k, v in d.items():
            db.setdefault(k, []).extend(v)
    with open(os.path.join(args.out_dir, "foreground_db_infos.pkl"), "wb") as f:
        pickle.dump(db, f)
    print({k: len(v) for k, v in db.items()})
    return db


if __name__ == "__main__":
    main()
