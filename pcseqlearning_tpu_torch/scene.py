"""Synthetic scenes, so that the port's smoke run and tests need neither
``bench.py`` nor ``jax``.

``make_scene`` (a copy of ``bench.make_scene``): a static ground surface
(65% of the points, the same cells every frame) plus 24 rigid Gaussian
clusters: even-indexed ones move at 0.15-0.8 m/frame, the rest drift below
the 0.05 m/frame moving threshold. ``scene_dict`` is its pipeline input
dict and ``scene_batch`` a collated SimpleReg batch of such sequences.
``make_rigid_scene`` (a copy of tests/test_registration_oracle.py's) is a
two-frame registration problem with a known rigid motion per cluster.
``write_waymo_sequence`` writes such a scene to disk in the layout that
``datasets.WaymoDataset`` reads; ``write_detector_sequences`` writes the
train and val sequences of the detector CLIs' smoke run and tests, and
``detector_argv`` is those CLIs' command line over ``DETECTOR_CFGS``;
``write_data_path_cfg`` writes their data config with the whole training
data path switched on (GT-database paste, the local augmentors, the frame
cache, MIX3D).
``bench_detector_batch`` is ``bench.py::bench_detector``'s batch for
``DETECTOR_CFG`` (CenterPoint); ``lattice_detector_batch`` is the same
with its boxes on a lattice, one heatmap cell each, and
``camera_detector_batch`` the same with RGB images and a side camera for
CaDDN. ``make_scene(...,
ring=R)`` puts the clusters evenly on a circle of radius R instead and
keeps their points' z in [0, 3.5] m (every draw unchanged): well apart,
inside the detector's range under any global rotation and scaling, so each
frame keeps all its boxes and points, each box on a heatmap cell of its own
(the data-parallel checks need equal positives and no invalid point per
sample).
``write_waymo_tfrecord`` writes raw Waymo frames (range images,
calibrations, labels, segmentation labels) as a TFRecord, through the
port's own wire-format writer, for the offline converter.
``reconstruction_keys`` is the ``pair_min`` call of
``ImplicitReconstructionHead.loss`` on a synthetic cloud.
"""

from __future__ import annotations

import math
import pickle
import zlib
from pathlib import Path

import numpy as np
import torch


def make_scene(num_frames=20, points_per_frame=90_000, seed=0, moving_fraction=0.5,
               n_clusters=24, ring=None):
    """Returns (seq [F * points_per_frame, 4] float32 (frame, x, y, z),
    gt dict of per-frame boxes, track ids, velocities and moving flags).
    ``ring``: the clusters' centres evenly on a circle of that radius."""
    rng = np.random.RandomState(seed)
    frames = []
    centers = rng.rand(n_clusters, 2) * 120 - 60
    if ring is not None:
        a = 2 * np.pi * np.arange(n_clusters) / n_clusters
        centers = ring * np.stack([np.cos(a), np.sin(a)], 1)
    n_moving = int(round(n_clusters * moving_fraction))
    velo = np.zeros((n_clusters, 2))
    ang = rng.rand(n_moving) * 2 * np.pi
    spd = rng.rand(n_moving) * 0.65 + 0.15
    velo[:n_moving] = np.stack([np.cos(ang), np.sin(ang)], 1) * spd[:, None]
    velo[n_moving:] = rng.randn(n_clusters - n_moving, 2) * 0.01
    sizes = rng.rand(n_clusters) * 1.5 + 0.5
    gt_attr, gt_frame, gt_track = [], [], []
    n_ground = int(points_per_frame * 0.65)
    gx_fixed = rng.rand(n_ground, 2) * 150 - 75
    gz_fixed = 0.02 * np.sin(gx_fixed[:, 0] / 10) + rng.randn(n_ground) * 0.02
    ground = np.stack([gx_fixed[:, 0], gx_fixed[:, 1], gz_fixed], axis=1)
    for f in range(num_frames):
        objs = []
        per = (points_per_frame - n_ground) // n_clusters
        for c in range(n_clusters):
            pos = centers[c] + velo[c] * f
            pts = rng.randn(per, 3) * sizes[c] * np.array([1, 1, 0.5])
            pts[:, :2] += pos
            pts[:, 2] += sizes[c] + 0.5
            if ring is not None:
                pts[:, 2] = np.clip(pts[:, 2], 0.0, 3.5)
            objs.append(pts)
            gt_attr.append([pos[0], pos[1], sizes[c] + 0.5, 4 * sizes[c], 4 * sizes[c],
                            2 * sizes[c], 0.0])
            gt_frame.append(f)
            gt_track.append(c)
        xyz = np.concatenate([ground] + objs).astype(np.float32)
        fcol = np.full((len(xyz), 1), f, np.float32)
        frames.append(np.concatenate([fcol, xyz], axis=1))
    speed = np.linalg.norm(velo, axis=1)[np.asarray(gt_track)]
    gt = dict(
        gt_box_attr=np.asarray(gt_attr, np.float32),
        gt_box_frame=np.asarray(gt_frame, np.int64),
        gt_box_track_label=np.asarray(gt_track, np.int64),
        gt_box_cls_label=np.ones(len(gt_attr), np.int64),
        gt_box_velo=speed.astype(np.float32),
        moving=speed > 0.05,
    )
    return np.concatenate(frames), gt


def scene_dict(num_frames, points_per_frame, seed=0, frame_id="seq_000"):
    """The pipeline's input dict for ``make_scene`` (as bench.py and the
    parity harness build it)."""
    seq, gt = make_scene(num_frames=num_frames, points_per_frame=points_per_frame, seed=seed)
    return {
        "point_fxyz": seq,
        "point_sweep": seq[:, 0].astype(np.int64),
        "point_feat": np.zeros((len(seq), 1), np.float32),
        "frame_id": frame_id,
        **gt,
    }


def scene_batch(num_frames, points_per_frame, seeds=(0,), name="seq"):
    """A collated batch of ``make_scene`` sequences in SimpleReg's input
    layout: point_bxyz [N, 4] (sequence index, x, y, z), point_sweep and
    point_feat [N], and per sequence the boxes padded per frame,
    gt_box_attr [B, F * 24, 7], gt_box_cls_label and obj_ids [B, F * 24],
    frame_id [B] ("<name>_<b>.npy")."""
    bxyz, sweep, attr, cls, obj = [], [], [], [], []
    for b, seed in enumerate(seeds):
        seq, gt = make_scene(num_frames=num_frames, points_per_frame=points_per_frame, seed=seed)
        bxyz.append(np.concatenate([np.full((len(seq), 1), b, np.float32), seq[:, 1:4]], axis=1))
        sweep.append(seq[:, 0].astype(np.int64))
        attr.append(gt["gt_box_attr"])
        cls.append(gt["gt_box_cls_label"])
        obj.append(np.asarray([f"obj_{t}" for t in gt["gt_box_track_label"]]))
    return {
        "batch_size": len(seeds),
        "point_bxyz": np.concatenate(bxyz),
        "point_sweep": np.concatenate(sweep),
        "point_feat": np.zeros((sum(len(s) for s in sweep), 1), np.float32),
        "gt_box_attr": np.stack(attr),
        "gt_box_cls_label": np.stack(cls),
        "obj_ids": np.stack(obj),
        "frame_id": [f"{name}_{b:03d}.npy" for b in range(len(seeds))],
    }


def make_rigid_scene(seed, C=5, per=60, rot_deg=8.0, trans=0.4):
    """C clusters 14 m apart (far beyond any registration radius) and their
    images under one rigid motion each (a rotation about the cluster center
    up to ``rot_deg`` degrees, a translation up to ``trans`` m). Returns
    (moving [C * per, 3] f32, comp [C * per] int32, ref [C * per, 3] f32,
    gt_T [C, 4, 4] f64)."""
    rng = np.random.RandomState(seed)
    centers = np.stack([np.arange(C) * 14.0, (np.arange(C) % 2) * 14.0, np.zeros(C)], 1)
    centers = centers + rng.randn(C, 3)
    pts, comp, gt_T = [], [], []
    for c in range(C):
        p = centers[c] + rng.randn(per, 3) * np.array([1.2, 1.0, 0.5])
        ang = np.deg2rad(rng.uniform(-rot_deg, rot_deg))
        ca, sa = np.cos(ang), np.sin(ang)
        R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1.0]])
        t = rng.uniform(-trans, trans, 3)
        pts.append((p, (p - centers[c]) @ R.T + centers[c] + t))
        comp.append(np.full(per, c))
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = centers[c] - R @ centers[c] + t
        gt_T.append(M)
    moving = np.concatenate([p for p, _ in pts]).astype(np.float32)
    ref = np.concatenate([q for _, q in pts]).astype(np.float32)
    return moving, np.concatenate(comp).astype(np.int32), ref, np.stack(gt_T)


def reconstruction_keys(n, seed=0, invalid=0.0):
    """``pair_min``'s arguments in ``ImplicitReconstructionHead.loss`` for n
    returns in two batches (uniform in 80 x 80 x 6 m) and their 27 samples
    each (a 3^3 grid of offsets 0.2 m apart): the keys (1e3 * batch, polar
    angle, azimuth) of the samples [1, 27 n, 3] and of the returns [1, n, 3],
    float32, and their masks; a share ``invalid`` of the returns is masked,
    and their samples with them. NumPy arrays."""
    rng = np.random.RandomState(seed)
    bidx = (np.arange(n) >= n // 2).astype(np.float32)
    xyz = (rng.rand(n, 3) * [80, 80, 6] - [40, 40, 2]).astype(np.float32)
    lin = np.linspace(-0.2, 0.2, 3, dtype=np.float32)
    offs = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    smp = (xyz[:, None] + offs[None]).reshape(-1, 3)

    def key(p, bi):
        rho = np.maximum(np.linalg.norm(p, axis=-1), np.float32(1e-4))
        pol = np.arccos(np.clip(p[:, 2] / rho, -1.0, 1.0))
        return np.stack([bi * np.float32(1e3), pol, np.arctan2(p[:, 1], p[:, 0])],
                        -1).astype(np.float32)

    valid = rng.rand(n) >= invalid
    return (key(smp, np.repeat(bidx, 27))[None], key(xyz, bidx)[None],
            np.repeat(valid, 27)[None], valid[None])


def write_waymo_sequence(root, frames, gt, name, processed_data_tag="waymo_processed_data_v0_5_0"):
    """Write a ``make_scene`` sequence (``frames`` [N, 4] (frame, x, y, z),
    ``gt`` its box dict) as the Waymo sequence ``name`` under ``root``, in
    the layout of ``tools/create_waymo_infos.py``:

      <root>/<processed_data_tag>/<name>/NNNN.npy      [n, 8] float32: x, y, z
          and zeros for intensity, elongation, range, rimage_w, rimage_h
      <root>/<processed_data_tag>/<name>/NNNN_seg.npy  [n, 2] int64
          (instance, class): a point inside a GT box gets the box's track id
          and class 1 (Vehicle), every other point -1 and 18 (ground)
      <root>/<processed_data_tag>/<name>/<name>.pkl    one info dict a frame:
          point_cloud, frame_id "<name>_<idx:03d>", identity pose, and annos
          (name, gt_boxes_lidar, obj_ids, num_points_in_gt)

    Returns the sequence directory."""
    from .ops.boxes import points_in_boxes

    seq_dir = Path(root) / processed_data_tag / name
    seq_dir.mkdir(parents=True, exist_ok=True)
    fid = frames[:, 0].astype(np.int64)
    infos = []
    for f in range(int(fid.max()) + 1):
        xyz = frames[fid == f, 1:4].astype(np.float32)
        b = np.nonzero(gt["gt_box_frame"] == f)[0]
        boxes = gt["gt_box_attr"][b].astype(np.float32)
        tracks = gt["gt_box_track_label"][b]
        inside = points_in_boxes(torch.as_tensor(xyz), torch.as_tensor(boxes)).numpy()  # [B, n]
        in_any = inside.any(0)
        seg = np.stack([np.where(in_any, tracks[inside.argmax(0)], -1),
                        np.where(in_any, 1, 18)], axis=1).astype(np.int64)
        pts = np.zeros((len(xyz), 8), np.float32)
        pts[:, :3] = xyz
        np.save(seq_dir / ("%04d.npy" % f), pts)
        np.save(seq_dir / ("%04d_seg.npy" % f), seg)
        infos.append(dict(
            point_cloud=dict(lidar_sequence=name, sample_idx=f),
            frame_id=f"{name}_{f:03d}",
            pose=np.eye(4),
            annos=dict(
                name=np.asarray(["Vehicle"] * len(b)),
                gt_boxes_lidar=boxes,
                obj_ids=np.asarray([f"obj_{t}" for t in tracks]),
                num_points_in_gt=inside.sum(1).astype(np.int64),
            ),
        ))
    with open(seq_dir / f"{name}.pkl", "wb") as fo:
        pickle.dump(infos, fo)
    return seq_dir


DETECTOR_CFG = "tools/cfgs/waymo_models/centerpoint.yaml"
# the detector CLIs' configs: model, data, optimizer (the README's command)
DETECTOR_CFGS = (DETECTOR_CFG, "tools/cfgs/dataset_configs/waymo/detection_1sweep.yaml",
                 "tools/cfgs/optimizers/onecycle_centerpoint.yaml")


# the augmentors and options that write_data_path_cfg adds to the data config
DATA_PATH_GT_SAMPLING = """\
            - NAME: gt_sampling
              DB_INFO_PATH: {db_info_path}
              SAMPLE_GROUPS: ['Vehicle:40']
              MIN_POINTS: 5
"""
DATA_PATH_LOCAL_AUGMENTORS = """\
            - NAME: random_local_translation
              LOCAL_TRANSLATION_RANGE: [-0.25, 0.25]
              ALONG_AXIS_LIST: ['x', 'y', 'z']
            - NAME: random_local_rotation
              LOCAL_ROT_ANGLE: [-0.15707963, 0.15707963]
            - NAME: random_local_scaling
              LOCAL_SCALE_RANGE: [0.95, 1.05]
"""
DATA_PATH_OPTIONS = """\
    USE_SHARED_MEMORY: True
    MIX3D: {PROB: 0.5}
"""


def write_data_path_cfg(path, db_info_path, data_path=None,
                        repo=Path(__file__).resolve().parent.parent):
    """Write to ``path`` the detector CLIs' data config (``DETECTOR_CFGS[1]``)
    with ``gt_sampling`` (``db_info_path``, 'Vehicle:40', MIN_POINTS 5)
    before its augmentors, the three local augmentors after them, and
    USE_SHARED_MEMORY and MIX3D (PROB 0.5); DATA_PATH set to ``data_path``
    where given. Returns ``path`` as a string."""
    text = (Path(repo) / DETECTOR_CFGS[1]).read_text()
    if data_path is not None:
        text = text.replace("    DATA_PATH: data/waymo\n", f"    DATA_PATH: '{data_path}'\n")
        assert f"'{data_path}'" in text
    head, rest = text.split("        AUG_CONFIG_LIST:\n")
    augs, tail = rest.split("    DATA_PROCESSOR:\n")
    text = (head + "        AUG_CONFIG_LIST:\n"
            + DATA_PATH_GT_SAMPLING.format(db_info_path=db_info_path) + augs
            + DATA_PATH_LOCAL_AUGMENTORS + "    DATA_PROCESSOR:\n" + tail.rstrip("\n") + "\n"
            + DATA_PATH_OPTIONS)
    Path(path).write_text(text)
    return str(path)


def write_detector_sequences(root, frames, points, val_frames=0, **scene_kw):
    """A ``make_scene`` sequence (seed 0, every GT box a Vehicle; the
    ``scene_kw`` passed on) under ``<root>/train`` and, when
    ``val_frames``, one of seed 1 under ``<root>/val``: the paths of the two
    DATA_PATHs."""
    root = Path(root)
    write_waymo_sequence(root / "train", *make_scene(num_frames=frames, points_per_frame=points,
                                                     seed=0, **scene_kw), "det_train")
    if val_frames:
        write_waymo_sequence(root / "val", *make_scene(num_frames=val_frames,
                                                       points_per_frame=points, seed=1), "det_val")
    return str(root / "train"), str(root / "val")


def detector_argv(repo, data_path, root, device, *args, overrides=(), cfgs=DETECTOR_CFGS):
    """The detector CLIs' argv: ``cfgs`` (model, data, optimizer; default
    ``DETECTOR_CFGS``) under ``repo``, then ``args``, then ``--set`` with the
    data path, the output root and ``overrides``."""
    return ([str(Path(repo) / c) for c in cfgs]
            + ["--device", device, *args, "--set", "DATA_CONFIG.DATA_PATH", data_path,
               "ROOT_DIR", str(root), *overrides])


def bench_detector_batch(batch_size, n_points, extent, seed=0):
    """bench.py's detector batch (bench_detector): uniform points over
    +-``extent`` m, z in [-1.5, 3.5], one feature, 64 car-sized GT boxes a
    sample, all drawn from RandomState(seed) in bench.py's order."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n_points, 4), np.float32)
    pts[..., 1] = rng.rand(batch_size, n_points) * 2 * extent - extent
    pts[..., 2] = rng.rand(batch_size, n_points) * 2 * extent - extent
    pts[..., 3] = rng.rand(batch_size, n_points) * 5 - 1.5
    feats = rng.rand(batch_size, n_points, 1).astype(np.float32)
    gt = np.zeros((batch_size, 64, 8), np.float32)
    for b in range(batch_size):
        gt[b, :, 0:2] = rng.rand(64, 2) * (2 * extent - 20) - (extent - 10)
        gt[b, :, 2] = 1.0
        gt[b, :, 3:6] = [4.5, 2.0, 1.8]
        gt[b, :, 7] = rng.randint(1, 4, 64)
    return dict(points=pts, feats=feats, valid=np.ones((batch_size, n_points), bool),
                gt_boxes=gt)


def lattice_detector_batch(batch_size, n_points, extent, seed=0, boxes=64, spacing=2.0):
    """``bench_detector_batch`` with its GT boxes moved onto a square
    lattice of ``spacing`` m about the origin (the sizes and classes kept;
    every box with a class), so that no two boxes of a sample share a
    heatmap cell: every sample holds ``boxes`` positives."""
    out = bench_detector_batch(batch_size, n_points, extent, seed)
    side = int(np.ceil(np.sqrt(boxes)))
    g = (np.arange(side) - (side - 1) / 2.0) * spacing
    xy = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)[:boxes]
    out["gt_boxes"][:, :boxes, 0:2] = xy + 0.3
    return out


def camera_detector_batch(batch_size, n_points, extent, image_hw, camera_y, seed=0,
                          focal=2055.0):
    """``bench_detector_batch`` with what CaDDN's ImageVFE reads: uniform
    RGB images [B, H, W, 3] in [0, 1) (drawn from RandomState(seed + 1)),
    and a pinhole camera (``focal`` px at the Waymo front camera's width of
    1,920, scaled to W; the principal point at the centre) 1.5 m up at y =
    ``camera_y``, looking along -y: lidar to camera x_cam = -x, y_cam = 1.5
    - z, z_cam = camera_y - y. ImageVFE keeps the dense grid's first rows
    (sample 0's lowest z-slab, from y = -extent up): put the camera a few
    metres past the last kept row, so that every kept voxel lies in front
    of it beyond the first depth bin."""
    out = bench_detector_batch(batch_size, n_points, extent, seed)
    rng = np.random.RandomState(seed + 1)
    h, w = image_hw
    f = focal * w / 1920.0
    K = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]], np.float32)
    T = np.array([[-1.0, 0, 0, 0], [0, 0, -1.0, 1.5], [0, -1.0, 0, camera_y], [0, 0, 0, 1.0]],
                 np.float32)
    out.update(images=rng.rand(batch_size, h, w, 3).astype(np.float32),
               calib_K=np.broadcast_to(K, (batch_size, 3, 3)).copy(),
               calib_T=np.broadcast_to(T, (batch_size, 4, 4)).copy())
    return out


def caddn_camera_y(extent, voxel_y, voxel_cap, standoff=12.0):
    """``camera_y`` for ``camera_detector_batch``: ``standoff`` m past the
    last y row that ImageVFE's ``voxel_cap`` keeps of a +-``extent`` m grid
    with ``voxel_y`` m cells (the rows of sample 0's lowest z-slab)."""
    nx = int(round(2 * extent / voxel_y))
    rows = -(-voxel_cap // nx)
    return -extent + rows * voxel_y + standoff


# Waymo's five lidars: name, rows, columns, inclination range (rad), whether
# the calibration lists per-beam inclinations (TOP) or only the range, the
# mount point (m) and yaw (rad) in the vehicle frame, and the share of
# pixels with a first return
WAYMO_LIDARS = (
    ("TOP", 64, 2650, (-0.3075, 0.0436), True, (1.43, 0.0, 2.184), 0.0148, 0.9),
    ("FRONT", 200, 600, (-1.5708, 0.5236), False, (4.07, 0.0, 0.691), 0.0, 0.035),
    ("SIDE_LEFT", 200, 600, (-1.5708, 0.5236), False, (3.245, 1.025, 0.981), math.pi / 2,
     0.035),
    ("SIDE_RIGHT", 200, 600, (-1.5708, 0.5236), False, (3.245, -1.025, 0.981),
     -math.pi / 2, 0.035),
    ("REAR", 200, 600, (-1.5708, 0.5236), False, (-1.154, 0.0, 0.464), math.pi, 0.035),
)
# per label type (vehicle, pedestrian, sign, cyclist): its share and box
# extents (length, width, height) in m
_LABEL_TYPES = ((1, 0.5, (4.5, 2.0, 1.7)), (2, 0.3, (0.9, 0.8, 1.75)),
                (3, 0.1, (0.3, 0.6, 0.8)), (4, 0.1, (1.8, 0.7, 1.7)))


def _yaw_transform(xyz, yaw):
    t = np.eye(4)
    c, s = math.cos(yaw), math.sin(yaw)
    t[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    t[:3, 3] = xyz
    return t


def _matrix(cls, arr):
    from .datasets.waymo_protos import MatrixShape

    return zlib.compress(cls(data=arr.reshape(-1), shape=MatrixShape(dims=list(arr.shape)))
                         .encode())


def write_waymo_tfrecord(path, frames, seed=0, lidars=WAYMO_LIDARS, labels=60,
                         seg_frames=None):
    """Write ``frames`` synthetic Waymo frames to the TFRecord ``path``, as
    the public dataset lays them out, through the port's wire-format writer
    (``datasets.waymo_protos``), from ``np.random.RandomState(seed)``:

    - per lidar of ``lidars`` (``WAYMO_LIDARS``: TOP 64 x 2,650 with
      per-beam inclinations, four short-range lidars 200 x 600 with an
      inclination range, yawed extrinsics), a ZLIB MatrixFloat first return
      [H, W, 4] (range, intensity, elongation, no-label-zone; range -1 where
      there is no return; TOP's downward beams see a ground plane) and a
      sparse second return;
    - ``labels`` boxes a frame, each around a TOP return of that frame, of
      the four types (the same id and type for index j in every frame),
      with difficulty levels and point counts;
    - on the frames of ``seg_frames`` (every 5th by default), TOP's ZLIB
      MatrixInt32 segmentation labels [H, W, 2] (instance 0-60, semantic
      1-22 on returns);
    - a pose that drives forward and turns.

    Returns (valid first-return pixels per frame, bytes written)."""
    from .datasets.tfrecord_io import write_tfrecord
    from .datasets.waymo_protos import (Box, Context, Frame, Label, Laser, LaserCalibration,
                                        LaserName, MatrixFloat, MatrixInt32, RangeImage,
                                        Transform)

    rng = np.random.RandomState(seed)
    seg_frames = set(range(0, frames, 5) if seg_frames is None else seg_frames)
    shares = np.array([t[1] for t in _LABEL_TYPES])
    kinds = rng.choice(len(_LABEL_TYPES), labels, p=shares / shares.sum())
    kinds[:len(_LABEL_TYPES)] = np.arange(len(_LABEL_TYPES))[:labels]  # every type present
    cals = []
    for name, rows, cols, (lo, hi), per_beam, mount, yaw, _ in lidars:
        ex = _yaw_transform(mount, yaw)
        incl = (np.sort(lo + (hi - lo) * (np.arange(rows) + 0.5 + rng.uniform(-0.3, 0.3, rows))
                        / rows) if per_beam else None)
        cals.append((incl, ex, LaserCalibration(
            name=getattr(LaserName, name), beam_inclination_min=lo, beam_inclination_max=hi,
            extrinsic=Transform(transform=ex.reshape(-1)),
            **({"beam_inclinations": incl} if per_beam else {}))))
    payloads, valid_counts = [], []
    for f in range(frames):
        lasers, n_valid, anchors = [], 0, None
        for (name, rows, cols, (lo, hi), per_beam, mount, yaw, share), (incl, ex, _) in zip(
                lidars, cals):
            beams = incl if incl is not None else lo + (hi - lo) * (np.arange(rows) + 0.5) / rows
            row_incl = beams[::-1][:, None]
            valid = rng.rand(rows, cols) < share
            ground = np.clip(mount[2] / np.sin(np.maximum(-row_incl, 1e-3)), 0.5, 75.0)
            far = rng.uniform(5.0, 75.0, (rows, cols))
            rng_m = np.where(row_incl < -0.02, ground * (1 + 0.02 * rng.randn(rows, cols)), far)
            t = np.zeros((rows, cols, 4), np.float32)
            t[..., 0] = np.where(valid, rng_m, -1.0)
            t[..., 1] = np.where(valid, rng.rand(rows, cols), 0.0)
            t[..., 2] = np.where(valid, rng.rand(rows, cols) * 1.5, 0.0)
            t[..., 3] = np.where(valid, rng.rand(rows, cols) < 0.02, 0.0)
            second = np.full((rows, cols, 4), -1.0, np.float32)
            sparse = valid & (rng.rand(rows, cols) < 0.02)
            second[sparse, 0] = t[sparse, 0] + rng.uniform(0.5, 5.0, int(sparse.sum()))
            second[sparse, 1:3] = 0.1
            ri1 = dict(range_image_compressed=_matrix(MatrixFloat, t))
            if name == "TOP":
                if f in seg_frames:
                    seg = np.zeros((rows, cols, 2), np.int32)
                    seg[..., 0] = np.where(valid, rng.randint(0, labels + 1, (rows, cols)), 0)
                    seg[..., 1] = np.where(valid, rng.randint(1, 23, (rows, cols)), 0)
                    ri1["segmentation_label_compressed"] = _matrix(MatrixInt32, seg)
                # label anchors: TOP returns, in the vehicle frame
                r, c = np.nonzero(valid)
                pick = rng.choice(len(r), labels, replace=False)
                r, c = r[pick], c[pick]
                az = (1.0 - 2.0 * (c + 0.5) / cols) * np.pi - math.atan2(ex[1, 0], ex[0, 0])
                rr, inc = t[r, c, 0].astype(np.float64), row_incl[r, 0]
                p = np.stack([rr * np.cos(inc) * np.cos(az), rr * np.cos(inc) * np.sin(az),
                              rr * np.sin(inc)], -1)
                anchors = p @ ex[:3, :3].T + ex[:3, 3]
            lasers.append(Laser(name=getattr(LaserName, name), ri_return1=RangeImage(**ri1),
                                ri_return2=RangeImage(
                                    range_image_compressed=_matrix(MatrixFloat, second))))
            n_valid += int(valid.sum())
        boxes = []
        for j in range(labels):
            typ, _, (ln, wd, ht) = _LABEL_TYPES[kinds[j]]
            cx, cy, cz = anchors[j] + rng.uniform(-0.2, 0.2, 3) if anchors is not None else (
                0.0, 0.0, 0.0)
            boxes.append(Label(
                box=Box(center_x=cx, center_y=cy, center_z=cz, length=ln, width=wd, height=ht,
                        heading=rng.uniform(-np.pi, np.pi)),
                type=typ, id=f"obj_{j:03d}", detection_difficulty_level=int(rng.randint(1, 3)),
                tracking_difficulty_level=int(rng.randint(1, 3)),
                num_lidar_points_in_box=int(rng.randint(1, 500))))
        frame = Frame(
            context=Context(name=Path(path).stem, laser_calibrations=[c for *_, c in cals]),
            timestamp_micros=1_550_000_000_000_000 + 100_000 * f,
            pose=Transform(transform=_yaw_transform((1.5 * f, 0.05 * f * f, 0.0), 0.01 * f)
                           .reshape(-1)),
            lasers=lasers, laser_labels=boxes)
        payloads.append(frame.encode())
        valid_counts.append(n_valid)
    write_tfrecord(path, payloads)
    return valid_counts, sum(len(p) + 16 for p in payloads)
