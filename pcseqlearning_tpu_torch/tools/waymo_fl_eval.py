"""Feature-leakage evaluation over Waymo prediction and GT info pickles
(counterpart of the repository's ``tools/waymo_fl_eval.py``).

    python -m pcseqlearning_tpu_torch.tools.waymo_fl_eval --pred_infos P \
        --gt_infos G [--class_names Vehicle Pedestrian Cyclist] \
        [--sampled_interval 1] [--device cuda|cpu]

For each class, each GT box's best 3D IoU with the frame's predictions of
that class (``ops.boxes.boxes_iou3d`` on ``--device``; 0 without one),
bucketed by the GT's tracking difficulty (0 where the info has none, as in
infos written by ``create_waymo_infos``): per bucket n, the mean IoU, its
50th and 90th percentiles and the share above 0.7. Whether boxes hard to
track are detected on par with easy ones is what "feature leakage"
measures. A GT frame with no prediction frame of its frame_id is skipped
and counted in a warning.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..ops.boxes import boxes_iou3d


def eval_feature_leakage(gt_infos, pred_infos, class_names, device="cuda"):
    """Returns {class: {difficulty: {n, mean_iou, p50, p90, recall_0_7}}}."""
    dev = resolve_device(device)
    if len(gt_infos) != len(pred_infos):
        raise ValueError("infos should have same length")
    frame2pred = {p["frame_id"]: p for p in pred_infos}

    per_cls = {c: {} for c in class_names}
    missing = 0
    for gt_info in gt_infos:
        pred_info = frame2pred.get(gt_info["frame_id"])
        if pred_info is None:  # mismatched sampled_interval or a skipped frame
            missing += 1
            continue
        gt_names = np.asarray(gt_info["name"])
        gt_boxes = np.asarray(gt_info["gt_boxes_lidar"], np.float32)[:, :7]
        trk_diff = np.asarray(
            gt_info.get("tracking_difficulty", np.zeros(len(gt_names), np.int64)))
        pred_names = np.asarray(pred_info["name"])
        pred_boxes = np.asarray(pred_info["boxes_lidar"], np.float32)
        pred_boxes = pred_boxes[:, :7] if len(pred_boxes) else pred_boxes.reshape(0, 7)

        for cls in class_names:
            g = gt_boxes[gt_names == cls]
            d = trk_diff[gt_names == cls]
            if g.shape[0] == 0:
                continue
            p = pred_boxes[pred_names == cls]
            if p.shape[0] == 0:
                iou1 = np.zeros(g.shape[0], np.float32)
            else:
                iou = boxes_iou3d(torch.as_tensor(g, device=dev),
                                  torch.as_tensor(p, device=dev)).cpu().numpy()
                iou1 = iou.max(axis=1)
            for lvl in np.unique(d):
                bucket = per_cls[cls].setdefault(int(lvl), [])
                bucket.extend(iou1[d == lvl].tolist())

    if missing:
        print(f"WARNING: {missing}/{len(gt_infos)} gt frames have no "
              f"matching prediction frame_id — skipped")
    out = {}
    for cls, by_lvl in per_cls.items():
        out[cls] = {}
        for lvl, vals in sorted(by_lvl.items()):
            v = np.asarray(vals, np.float32)
            out[cls][lvl] = dict(
                n=int(len(v)),
                mean_iou=float(v.mean()),
                p50=float(np.percentile(v, 50)),
                p90=float(np.percentile(v, 90)),
                recall_0_7=float((v > 0.7).mean()),
            )
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pred_infos", type=str, default=None, help="pickle file")
    parser.add_argument("--gt_infos", type=str, default=None, help="pickle file")
    parser.add_argument("--class_names", type=str, nargs="+",
                        default=["Vehicle", "Pedestrian", "Cyclist"])
    parser.add_argument("--sampled_interval", type=int, default=1,
                        help="sampled interval for GT sequences")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    with open(args.pred_infos, "rb") as f:
        pred_infos = pickle.load(f)
    with open(args.gt_infos, "rb") as f:
        gt_infos = pickle.load(f)
    print("Start to evaluate the waymo format results via Feature Leakage Metric")

    gt_infos_dst = []
    for idx in range(0, len(gt_infos), args.sampled_interval):
        cur_info = gt_infos[idx]["annos"]
        cur_info["frame_id"] = gt_infos[idx]["frame_id"]
        gt_infos_dst.append(cur_info)

    stats = eval_feature_leakage(gt_infos_dst, pred_infos, args.class_names, args.device)
    for cls, by_lvl in stats.items():
        for lvl, s in by_lvl.items():
            print(f"{cls} tracking_difficulty={lvl}: n={s['n']} "
                  f"mean_iou={s['mean_iou']:.4f} p50={s['p50']:.4f} "
                  f"p90={s['p90']:.4f} recall@0.7={s['recall_0_7']:.4f}")
    return stats


if __name__ == "__main__":
    main()
