"""Waymo TFRecords -> per-sequence npy frames and info pickles (counterpart of
the repository's ``tools/create_waymo_infos.py``, its third tier: the
vendored schema, a TFRecord reader and the spherical projection, with no
TensorFlow and no waymo_open_dataset).

    python -m pcseqlearning_tpu_torch.tools.create_waymo_infos --raw_dir D \
        --out_dir O [--sampled_interval 1] [--workers 8] [--device cuda|cpu]

For each ``<raw_dir>/<seq>.tfrecord``, every ``--sampled_interval``-th
frame is decoded on the host (``datasets.tfrecord_io``, the wire-format
reader of ``datasets.waymo_protos``, zlib), each laser's first-return range
image is projected to points on ``--device`` in float64
(``datasets.range_image``), and the converter writes what the JAX tool
writes, under ``<out_dir>/<seq>/``:

  NNNN.npy       [N, 8] float32: x, y, z, intensity, elongation, range and
                 two zero columns, the lasers in calibration order
  NNNN_seg.npy   [N, 2] int32 (instance, semantic), only when a label of the
                 frame is non-zero (lasers without labels give zeros)
  <seq>.pkl      one info a frame: point_cloud (lidar_sequence, sample_idx),
                 frame_id "<seq>_<idx:03d>", pose [4, 4] float64, annos
                 (name, gt_boxes_lidar [M, 7] float32, obj_ids,
                 num_points_in_gt, difficulty)

The JAX tool's quirks are kept: type 3 is "Sign" and an unknown type
"Unknown"; the annos have no tracking_difficulty; a calibration whose laser
is missing raises StopIteration; only the first return is read; the TOP
lidar's per-pixel rolling-shutter pose correction is not applied. The JAX
tool's first two tiers (waymo_open_dataset's frame_utils over TensorFlow,
and TensorFlow's record reader) are not ported: neither package is
installed.

With ``--workers`` > 1 and several sequences, a ``spawn`` pool converts one
sequence a worker, each worker decoding on the host and projecting on the
card (a forked child cannot use CUDA once its parent has).
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import pickle
import time
import zlib
from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..datasets.range_image import extract_points
from ..datasets.tfrecord_io import read_tfrecord
from ..datasets.waymo_protos import Frame, MatrixFloat, MatrixInt32
from ..device import resolve_device
from ..utils.profiler import span

TYPE_NAMES = {1: "Vehicle", 2: "Pedestrian", 3: "Sign", 4: "Cyclist"}


def _parse_matrix(comp_bytes, cls):
    """ZLIB-compressed serialized MatrixFloat / MatrixInt32 -> ndarray."""
    msg = cls.decode(zlib.decompress(comp_bytes))
    return np.asarray(msg.data).reshape(list(msg.shape.dims))


def decode_laser(frame, calibration):
    """One laser's first return, decoded on the host: a dict of the range
    image [H, W, C] float32, the extrinsic [4, 4], the beam inclinations (or
    None) and their range, and the segmentation labels [H, W, 2] (or None);
    None when the laser has no first-return image."""
    laser = next(l for l in frame.lasers if l.name == calibration.name)
    ri = laser.ri_return1
    if not ri.range_image_compressed:
        return None
    incl = calibration.beam_inclinations
    return dict(
        tensor=_parse_matrix(ri.range_image_compressed, MatrixFloat).astype(np.float32),
        extrinsic=np.asarray(calibration.extrinsic.transform, np.float64).reshape(4, 4),
        inclination=np.asarray(incl, np.float64) if len(incl) else None,
        inclination_range=(calibration.beam_inclination_min,
                           calibration.beam_inclination_max),
        seg=(_parse_matrix(ri.segmentation_label_compressed, MatrixInt32)
             if ri.segmentation_label_compressed else None))


def project_lasers(lasers, device):
    """The decoded lasers' points [N, 6] float32 (range, intensity,
    elongation, x, y, z), projected on ``device``, and their (instance,
    semantic) labels [N, 2] int32 (zeros for a laser without labels)."""
    pts, seg = [], []
    for d in lasers:
        if d is None:
            seg.append(np.zeros((0, 2), np.int32))
            continue
        pts.append(extract_points(d["tensor"], d["extrinsic"], inclination=d["inclination"],
                                  inclination_range=d["inclination_range"], device=device))
        mask = d["tensor"][..., 0] > 0
        seg.append(d["seg"][mask].astype(np.int32) if d["seg"] is not None
                   else np.zeros((int(mask.sum()), 2), np.int32))
    if not pts:
        return np.zeros((0, 6), np.float32), np.concatenate(seg)
    return torch.cat(pts).cpu().numpy(), np.concatenate(seg)


def frame_annos(frame, has_label=True):
    """The frame's labels as the info's annos."""
    annos = dict(name=[], gt_boxes_lidar=[], obj_ids=[], num_points_in_gt=[], difficulty=[])
    if has_label:
        for obj in frame.laser_labels:
            b = obj.box
            annos["gt_boxes_lidar"].append(
                [b.center_x, b.center_y, b.center_z, b.length, b.width, b.height, b.heading])
            annos["name"].append(TYPE_NAMES.get(obj.type, "Unknown"))
            annos["obj_ids"].append(obj.id)
            annos["num_points_in_gt"].append(obj.num_lidar_points_in_box)
            annos["difficulty"].append(obj.detection_difficulty_level)
    return {
        "name": np.asarray(annos["name"]),
        "gt_boxes_lidar": np.asarray(annos["gt_boxes_lidar"], np.float32).reshape(-1, 7),
        "obj_ids": np.asarray(annos["obj_ids"]),
        "num_points_in_gt": np.asarray(annos["num_points_in_gt"], np.int64),
        "difficulty": np.asarray(annos["difficulty"], np.int64),
    }


def process_single_sequence(seq_file, out_dir, has_label=True, sampled_interval=1,
                            device="cuda", timings=None):
    """Convert one sequence; returns its infos. ``timings``, a dict, gets the
    seconds of the host decode, the projection (to the points back on the
    host) and the writes, and the frame count, added in."""
    dev = resolve_device(device)
    seq_name = Path(seq_file).stem.replace(".tfrecord", "")
    seq_dir = Path(out_dir) / seq_name
    seq_dir.mkdir(parents=True, exist_ok=True)
    spent = dict(decode=0.0, projection=0.0, write=0.0, frames=0)
    infos = []
    for idx, data in enumerate(read_tfrecord(seq_file)):
        if idx % sampled_interval != 0:
            continue
        t0 = time.perf_counter()
        with span("create_waymo_infos.decode"):
            frame = Frame.decode(data)
            lasers = [decode_laser(frame, c) for c in frame.context.laser_calibrations]
        t1 = time.perf_counter()
        with span("create_waymo_infos.projection"):
            pts, seg_pts = project_lasers(lasers, dev)
        t2 = time.perf_counter()
        with span("create_waymo_infos.write"):
            out = np.zeros((len(pts), 8), np.float32)
            out[:, 0:3] = pts[:, 3:6]  # xyz
            out[:, 3] = pts[:, 1]  # intensity
            out[:, 4] = pts[:, 2]  # elongation
            out[:, 5] = pts[:, 0]  # range
            np.save(seq_dir / ("%04d.npy" % idx), out)
            if (seg_pts != 0).any():
                np.save(seq_dir / ("%04d_seg.npy" % idx), seg_pts)
            infos.append(dict(
                point_cloud=dict(lidar_sequence=seq_name, sample_idx=idx),
                frame_id=f"{seq_name}_{idx:03d}",
                pose=np.asarray(frame.pose.transform, np.float64).reshape(4, 4),
                annos=frame_annos(frame, has_label)))
        t3 = time.perf_counter()
        spent["decode"] += t1 - t0
        spent["projection"] += t2 - t1
        spent["write"] += t3 - t2
        spent["frames"] += 1
    with open(seq_dir / f"{seq_name}.pkl", "wb") as f:
        pickle.dump(infos, f)
    if timings is not None:
        for k, v in spent.items():
            timings[k] = timings.get(k, 0) + v
    return infos


def _convert(seq_file, out_dir, sampled_interval, device):
    """One sequence in a pool worker: its name and timings."""
    timings = {}
    process_single_sequence(seq_file, out_dir, sampled_interval=sampled_interval,
                            device=device, timings=timings)
    return Path(seq_file).name, timings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--raw_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--sampled_interval", type=int, default=1)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    seq_files = [str(p) for p in sorted(Path(args.raw_dir).glob("*.tfrecord"))]
    print(f"extracting {len(seq_files)} sequences -> {args.out_dir}")
    fn = partial(_convert, out_dir=args.out_dir, sampled_interval=args.sampled_interval,
                 device=args.device)
    workers = min(args.workers, len(seq_files))
    results = []
    if workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            for i, r in enumerate(pool.imap(fn, seq_files)):
                results.append(r)
                print(f"[{i + 1}/{len(seq_files)}] done")
    else:
        for i, seq_file in enumerate(seq_files):
            results.append(fn(seq_file))
            print(f"[{i + 1}/{len(seq_files)}] done")
    return results


if __name__ == "__main__":
    main()
