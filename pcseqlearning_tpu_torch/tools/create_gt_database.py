"""Build the GT-sampling database that ``gt_sampling`` reads: each GT
object's points as a ``.bin`` crop and a dbinfos pickle (counterpart of the
repository's ``tools/create_gt_database.py``).

    python -m pcseqlearning_tpu_torch.tools.create_gt_database <data_cfg.yaml> \
        [--split train] [--sampled_interval 10] [--device cuda|cpu]

The dataset of ``<data_cfg.yaml>``'s DATA_CONFIG (DATA_PATH relative to the
working directory unless absolute) is read frame by frame, every
``--sampled_interval``-th info of the split. For each GT box of a class in
CLASS_NAMES, the points inside it (``ops.boxes.points_in_boxes`` on
``--device``) are written relative to the box centre as float32 to
``<DATA_PATH>/gt_database_<split>/<seq>_<sample:04d>_<name>_<j>.bin``, and
a record (name, path ``gt_database_<split>/<file>``, sequence_name,
sample_idx, gt_idx, box3d_lidar, num_points_in_gt, num_features) goes to
``<DATA_PATH>/waymo_dbinfos_<split>.pkl``. An object with no point inside
is skipped. The card and the CPU write the same files.

The crop paths are relative to the database's parent: ``gt_sampling``
resolves them, and DB_INFO_PATH, against the working directory, so train
from there.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from ..config import cfg_from_yaml_file
from ..datasets import WaymoDataset
from ..device import resolve_device
from ..ops.boxes import points_in_boxes
from ..utils.edict import EDict


def create_gt_database(data_cfg, class_names, split="train", sampled_interval=10,
                       device="cuda", verbose=True):
    """Write the database of ``data_cfg``'s dataset; returns the dbinfos
    dict ({class: [record]}) and the pickle's path."""
    dev = resolve_device(device)
    dataset = WaymoDataset(data_cfg, class_names, training=(split == "train"))
    db_root = dataset.data_path.parent / f"gt_database_{split}"
    db_root.mkdir(parents=True, exist_ok=True)
    db_infos = {n: [] for n in class_names}
    for idx in range(0, len(dataset.infos), sampled_interval):
        info = dataset.infos[idx]
        pc = info["point_cloud"]
        seq, sample = pc["lidar_sequence"], pc["sample_idx"]
        points = dataset.get_lidar(seq, sample)
        annos = info.get("annos", {})
        boxes = np.asarray(annos.get("gt_boxes_lidar", np.zeros((0, 7)))).reshape(-1, 7)
        names = np.asarray(annos.get("name", []))
        if len(boxes) == 0:
            continue
        inside = points_in_boxes(
            torch.as_tensor(points[:, :3].astype(np.float32), device=dev),
            torch.as_tensor(boxes.astype(np.float32), device=dev)).cpu().numpy()
        for j, name in enumerate(names):
            if name not in db_infos:
                continue
            obj_pts = points[inside[j]]
            if len(obj_pts) == 0:
                continue
            obj_pts[:, :3] -= boxes[j, :3]
            fname = f"{seq}_{sample:04d}_{name}_{j}.bin"
            obj_pts.astype(np.float32).tofile(db_root / fname)
            db_infos[name].append(dict(
                name=name, path=str(Path(db_root.name) / fname), sequence_name=seq,
                sample_idx=sample, gt_idx=j, box3d_lidar=boxes[j],
                num_points_in_gt=len(obj_pts), num_features=obj_pts.shape[1]))
        if verbose and idx % 100 == 0:
            print(f"[{idx}/{len(dataset.infos)}]", flush=True)
    out = dataset.data_path.parent / f"waymo_dbinfos_{split}.pkl"
    with open(out, "wb") as f:
        pickle.dump(db_infos, f)
    return db_infos, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_cfg", type=str)
    ap.add_argument("--split", default="train")
    ap.add_argument("--sampled_interval", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = cfg_from_yaml_file(args.data_cfg, EDict())
    class_names = list(cfg.get("CLASS_NAMES", ["Vehicle", "Pedestrian", "Cyclist"]))
    db_infos, out = create_gt_database(cfg.DATA_CONFIG, class_names, args.split,
                                       args.sampled_interval, args.device)
    for k, v in db_infos.items():
        print(f"{k}: {len(v)} objects")
    print("saved", out)
    return db_infos, out


if __name__ == "__main__":
    main()
