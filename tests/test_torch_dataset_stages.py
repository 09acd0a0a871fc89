"""The port's dataset stages against the JAX package's: every case of
``tests/test_dataset_stages.py`` (the interaction index and its AP, the
processors, the local augmentors, ``gt_sampling``, spherical resampling,
``SemanticSegSampler``, ``point_contrast_views``, the foreground instance
database) run through both packages on the same inputs, plus the two kNN
stages on a scanline of realistic density, the other processors, the
NumPy box and polar utilities, and the GT database builder.

Host NumPy stages are held exactly. The JAX package draws from the global
NumPy generator, the port from an explicit ``RandomState``: both are seeded
alike. Masks from ``points_in_boxes`` (XLA's cos/sin against torch's) are
equal except for points within 1e-5 m of a box face, which are listed. The
kNN stages (sklearn's ``NearestNeighbors`` in JAX, ``cKDTree`` in the port)
give equal counts and segment ids; coordinates agree within 1e-6 m except
for a pair within 1e-6 of a threshold (0.3 m, the 0.1 m steps, DIST_TH),
which is listed; a resampled point's labels come from the same original
point except where two originals are exactly as near (listed: the port
takes the lower index). Each interaction-index AP and APH is within 1e-9.
"""

import copy
import importlib.util
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from pcseqlearning_tpu.datasets import augmentor as j_aug
from pcseqlearning_tpu.datasets import waymo_eval_ii as j_ii
from pcseqlearning_tpu.datasets.processor import DataProcessor as JProcessor
from pcseqlearning_tpu.datasets.waymo_dataset import WaymoDataset as JWaymo
from pcseqlearning_tpu.utils import box_utils as j_box
from pcseqlearning_tpu.utils import polar_utils as j_polar
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.datasets import augmentor as t_aug
from pcseqlearning_tpu_torch.datasets import waymo_eval_ii as t_ii
from pcseqlearning_tpu_torch.datasets.processor import DataProcessor as TProcessor
from pcseqlearning_tpu_torch.datasets.waymo_dataset import WaymoDataset as TWaymo
from pcseqlearning_tpu_torch.scene import make_scene, write_waymo_sequence
from pcseqlearning_tpu_torch.tools import create_gt_database as t_gtdb
from pcseqlearning_tpu_torch.tools import extract_foreground_instances as t_fg
from pcseqlearning_tpu_torch.utils import box_utils as t_box
from pcseqlearning_tpu_torch.utils import polar_utils as t_polar
from pcseqlearning_tpu_torch.utils.edict import EDict

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
PCR = [-75, -75, -2, 75, 75, 4]
FACE_EPS = 1e-5
KNN_EPS = 1e-6


def jax_tool(name):
    """The repository's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_equal(got, want, path="out"):
    """Dicts key by key, lists item by item, arrays by value and dtype."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def near_face(points, boxes, margin=1e-2, eps=FACE_EPS):
    """[B, N] bool: point n within ``eps`` m of a face of box b as
    ``points_in_boxes`` tests it (x/y half-sizes + margin, z half-size), in
    float64."""
    p = np.asarray(points, np.float64)[None, :, :3]
    b = np.asarray(boxes, np.float64)[:, None, :]
    d = p - b[..., :3]
    c, s = np.cos(-b[..., 6]), np.sin(-b[..., 6])
    lx = np.abs(d[..., 0] * c - d[..., 1] * s) - (b[..., 3] / 2 + margin)
    ly = np.abs(d[..., 0] * s + d[..., 1] * c) - (b[..., 4] / 2 + margin)
    lz = np.abs(d[..., 2]) - b[..., 5] / 2
    return (np.abs(lx) < eps) | (np.abs(ly) < eps) | (np.abs(lz) < eps)


def procs(methods):
    return (TProcessor([EDict(m) for m in methods], point_cloud_range=PCR, training=True,
                       rng=np.random.RandomState(0)),
            JProcessor([JEDict(m) for m in methods], point_cloud_range=PCR, training=True))


def augs(cfg_list, seed, root_path=None):
    np.random.seed(seed)
    return (t_aug.DataAugmentor(EDict(AUG_CONFIG_LIST=[EDict(c) for c in cfg_list]),
                                root_path=root_path, rng=np.random.RandomState(seed)),
            j_aug.DataAugmentor(JEDict(AUG_CONFIG_LIST=[JEDict(c) for c in cfg_list]),
                                root_path=root_path))


# ---------------------------------------------------------------------------
# interaction index
# ---------------------------------------------------------------------------


def ii_scene(seed, n_boxes=6, per=40):
    """Rotated boxes with member points (an instance each), foreign points
    of other instances around them, road and sidewalk points."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.rand(n_boxes, 2) * 40 - 20, np.full((n_boxes, 1), 1.0),
                            rng.rand(n_boxes, 3) * [3, 1.5, 1] + [2, 1, 1],
                            rng.rand(n_boxes, 1) * 6 - 3], 1).astype(np.float32)
    pts, inst, seg = [], [], []
    for b in range(n_boxes):
        pts.append(boxes[b, :3] + rng.randn(per, 3) * [0.4, 0.2, 0.2])
        inst += [b + 1] * per
        seg += [1 + b % 7] * per
    pts.append(rng.rand(150, 3) * [40, 40, 2] - [20, 20, 0])
    inst += list(rng.randint(20, 30, 150))
    seg += list(rng.choice([3, 5, 10, 11], 150))
    labels = np.stack([np.asarray(inst), np.asarray(seg)], 1).astype(np.int64)
    return np.concatenate(pts).astype(np.float32), labels, boxes


def test_interaction_index_masks():
    rng = np.random.RandomState(0)
    boxes = np.array([[0.0, 0.0, 1.0, 4.0, 2.0, 1.6, 0.0],
                      [20.0, 0.0, 1.0, 4.0, 2.0, 1.6, 0.0]], np.float32)
    mem_a = rng.randn(20, 3) * 0.3 + [0, 0, 1.0]
    mem_b = rng.randn(20, 3) * 0.3 + [20, 0, 1.0]
    intruder = np.array([[20.0 + 2.0 + 0.2, 0.0, 1.0]])
    pts = np.concatenate([mem_a, mem_b, intruder]).astype(np.float32)
    inst = np.concatenate([np.ones(20), np.full(20, 2), [3]]).astype(np.int64)
    labels = np.stack([inst, np.full(41, 5, np.int64)], axis=1)
    for r in (0.1, 0.5):
        assert_equal(t_ii.check_box_interaction(boxes, r, pts, labels),
                     j_ii.check_box_interaction(boxes, r, pts, labels))
    out = t_ii.check_box_interaction(boxes, 0.5, pts, labels)
    assert not out[0] and out[1]
    ii = t_ii.compute_interaction_index(pts, labels, boxes, radius_list=(0.1, 0.5, 2.0))
    assert_equal(ii, j_ii.compute_interaction_index(pts, labels, boxes, radius_list=(0.1, 0.5, 2.0)))
    assert not ii["0.1"][1] and ii["0.5"][1] and ii["2.0"][1]
    assert_equal(t_ii.ii_difficulty_levels(ii, 2), j_ii.ii_difficulty_levels(ii, 2))
    # a crowded scene of rotated boxes over the whole ladder
    for seed in (1, 2):
        pts, labels, boxes = ii_scene(seed)
        got = t_ii.compute_interaction_index(pts, labels, boxes)
        assert_equal(got, j_ii.compute_interaction_index(pts, labels, boxes))
        assert_equal(t_ii.split_by_seg_label(pts, labels), j_ii.split_by_seg_label(pts, labels))
        levels = t_ii.ii_difficulty_levels(got, len(boxes))
        assert_equal(levels, j_ii.ii_difficulty_levels(got, len(boxes)))
        assert len(np.unique(levels)) > 1


def ii_annos(seed, frames=3):
    """GT annos with interaction masks and detections jittered from them
    (some missed, some false), two classes."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for _ in range(frames):
        pts, labels, boxes = ii_scene(rng.randint(1000), n_boxes=8)
        names = np.asarray(["Vehicle", "Pedestrian"] * 4)
        gts.append(dict(name=names, gt_boxes_lidar=boxes,
                        interaction_index=t_ii.compute_interaction_index(pts, labels, boxes)))
        keep = rng.rand(8) > 0.2
        d = boxes[keep].copy()
        d[:, :3] += rng.randn(len(d), 3).astype(np.float32) * 0.15
        d[:, 6] += rng.randn(len(d)).astype(np.float32) * 0.2
        false = np.concatenate([rng.rand(2, 2) * 40 - 20, np.ones((2, 1)), np.full((2, 3), 2.0),
                                np.zeros((2, 1))], 1).astype(np.float32)
        dets.append(dict(name=np.concatenate([names[keep], ["Vehicle", "Pedestrian"]]),
                         boxes_lidar=np.concatenate([d, false]),
                         score=rng.rand(len(d) + 2).astype(np.float32)))
    return dets, gts


def test_ap_by_interaction_index():
    gt = [dict(name=np.array(["Vehicle", "Vehicle"]),
               gt_boxes_lidar=np.array([[0.0, 0.0, 0.5, 4.0, 4.0, 1.5, 0.0],
                                        [40.0, 0.0, 0.5, 4.0, 4.0, 1.5, 0.0]], np.float32),
               interaction_index={"8.0": np.array([False, True])})]
    det = [dict(name=np.array(["Vehicle"]), score=np.array([0.9], np.float32),
                boxes_lidar=np.array([[0.0, 0.0, 0.5, 4.0, 4.0, 1.5, 0.0]], np.float32))]
    groups = ((0,), (1,))
    _, r = t_ii.ap_by_interaction_index(det, gt, ["Vehicle"], level_groups=groups)
    _, rj = j_ii.ap_by_interaction_index(det, gt, ["Vehicle"], level_groups=groups)
    assert abs(r["Vehicle/II_0/AP"] - 1.0) < 1e-6 and r["Vehicle/II_1/AP"] == 0.0
    dets, gts = ii_annos(3)
    for got, want in ((r, rj), (t_ii.ap_by_interaction_index(dets, gts, ["Vehicle", "Pedestrian"])[1],
                                j_ii.ap_by_interaction_index(dets, gts, ["Vehicle", "Pedestrian"])[1])):
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])
    assert 0 < sum(got.values()) < len(got)
    # a frame with detections of a class but no GT of it raises, in both
    gt = [dict(name=np.array(["Pedestrian"]), gt_boxes_lidar=np.array([[0, 0, 0, 1, 1, 1, 0]],
                                                                      np.float32))]
    for ii in (t_ii, j_ii):
        with pytest.raises(IndexError):
            ii.ap_by_interaction_index(det, gt, ["Vehicle"])


# ---------------------------------------------------------------------------
# processor stages
# ---------------------------------------------------------------------------


def test_shift_to_top_lidar_origin():
    t, j = procs([{"NAME": "shift_to_top_lidar_origin"}])
    d = {"points": np.ones((5, 4), np.float32), "top_lidar_origin": np.array([1.0, 2.0, 3.0])}
    got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
    assert_equal(got, want)
    assert np.allclose(got["points"][:, :3], [0, -1, -2]) and np.allclose(got["top_lidar_origin"], 0)


def test_estimate_velocity_trace_gating():
    t, j = procs([{"NAME": "estimate_velocity"}])
    d = {"points": np.zeros((1, 4), np.float32), "obj_ids": np.array(["a", "a", "b", "b"]),
         "obj_sweep": np.array([0, 1, 1, 2]), "gt_box_attr": np.arange(4, dtype=np.float32),
         "gt_names": np.array(["Vehicle"] * 4)}
    got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
    assert_equal(got, want)
    assert "obj_ids" not in got and np.allclose(got["gt_box_attr"], [0, 1])
    d.pop("obj_sweep")  # nothing to gate on
    assert_equal(t(copy.deepcopy(d)), j(copy.deepcopy(d)))


def test_lidar_line_segment_v2():
    cfg = {"NAME": "lidar_line_segment_v2", "DIST_TH": 0.05, "LARGE_SEGMENT_SIZE": 30}
    t, j = procs([cfg])
    n1, n2 = 60, 5
    th1, th2 = np.linspace(0, 0.5, n1), np.linspace(2.0, 2.02, n2)
    pts = np.concatenate([np.stack([10 * np.cos(th1), 10 * np.sin(th1), np.zeros(n1)], 1),
                          np.stack([10 * np.cos(th2), 10 * np.sin(th2), np.zeros(n2)], 1)]
                         ).astype(np.float32)
    d = {"points": np.concatenate([pts, np.zeros((n1 + n2, 1), np.float32)], 1),
         "point_rimage_h": np.zeros(n1 + n2, np.int64)}
    got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
    assert_equal(got, want)
    seg = got["point_segment_id"]
    assert len(np.unique(seg[:n1])) == 1 and len(np.unique(seg)) >= 2
    assert got["point_in_large_segment"][:n1].all()
    assert not got["point_in_large_segment"][n1:].any()
    d.pop("point_rimage_h")  # no rows: every point in segment 0
    assert_equal(t(copy.deepcopy(d)), j(copy.deepcopy(d)))


# ---------------------------------------------------------------------------
# local augmentations + gt_sampling point removal
# ---------------------------------------------------------------------------


def test_random_local_rotation_moves_members_only():
    t, j = augs([{"NAME": "random_local_rotation", "LOCAL_ROT_ANGLE": [0.5, 0.5]}], 0)
    box = np.array([[5.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]], np.float32)
    inside = np.array([[5.5, 0.2, 0.0, 0.0]], np.float32)
    outside = np.array([[20.0, 0.0, 0.0, 0.0]], np.float32)
    d = {"points": np.concatenate([inside, outside]), "gt_boxes": box.copy()}
    got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
    assert_equal(got, want)
    assert abs(got["gt_boxes"][0, 6] - 0.5) < 1e-6
    assert np.allclose(got["points"][1, :3], [20, 0, 0])
    rel = inside[0, :3] - box[0, :3]
    c, s = np.cos(0.5), np.sin(0.5)
    want_pt = box[0, :3] + np.array([rel[0] * c - rel[1] * s, rel[0] * s + rel[1] * c, rel[2]])
    assert np.allclose(got["points"][0, :3], want_pt, atol=1e-5)


def test_random_local_scaling_and_translation():
    t, j = augs([{"NAME": "random_local_scaling", "LOCAL_SCALE_RANGE": [1.2, 1.2]},
                 {"NAME": "random_local_translation", "LOCAL_TRANSLATION_RANGE": [0.3, 0.3],
                  "ALONG_AXIS_LIST": ["x"]}], 0)
    d = {"points": np.array([[0.5, 0.0, 0.0, 0.0]], np.float32),
         "gt_boxes": np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]], np.float32)}
    got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
    assert_equal(got, want)
    assert np.allclose(got["gt_boxes"][0, 3:6], 2.4, atol=1e-5)
    assert abs(got["gt_boxes"][0, 0] - 0.3) < 1e-6
    assert abs(got["points"][0, 0] - (0.5 * 1.2 + 0.3)) < 1e-5


def test_gt_sampling_removes_occupied_points(tmp_path):
    obj = np.zeros((10, 4), np.float32)
    (tmp_path / "gt_db").mkdir()
    obj.tofile(tmp_path / "gt_db" / "obj0.bin")
    infos = {"Vehicle": [dict(path="gt_db/obj0.bin", box3d_lidar=[8.0, 8.0, 0.0, 2.0, 2.0, 2.0, 0.0],
                              num_features=4, num_points_in_gt=10)]}
    with open(tmp_path / "dbinfos.pkl", "wb") as f:
        pickle.dump(infos, f)
    cfg = [dict(NAME="gt_sampling", DB_INFO_PATH="dbinfos.pkl", SAMPLE_GROUPS=["Vehicle:1"])]
    t, j = augs(cfg, 0, root_path=str(tmp_path))
    d = {"points": np.array([[8.0, 8.0, 0.2, 0.0], [-20.0, 0.0, 0.0, 0.0]], np.float32),
         "gt_boxes": np.zeros((0, 7), np.float32), "gt_names": np.array([], str)}
    got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
    assert_equal(got, want)
    assert len(got["gt_boxes"]) == 1
    assert not any(np.allclose(p[:3], [8.0, 8.0, 0.2]) for p in got["points"])
    assert any(np.allclose(p[:3], [-20.0, 0.0, 0.0]) for p in got["points"])
    # a scene wider than the crops: the pasted points are zero-padded
    d5 = dict(d, points=np.concatenate([d["points"], np.ones((2, 1), np.float32)], 1))
    t, j = augs(cfg, 1, root_path=str(tmp_path))
    got = t(copy.deepcopy(d5))
    assert_equal(got, j(copy.deepcopy(d5)))
    assert got["points"].shape == (11, 5) and (got["points"][1:, 4] == 0).all()
    # without the database the sampler pastes nothing, in both packages
    t, j = augs([dict(cfg[0], DB_INFO_PATH="missing.pkl")], 0, root_path=str(tmp_path))
    got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
    assert_equal(got, want)
    assert_equal(got, d)


def test_spherical_resampling_densifies_scanline():
    n = 30
    th = np.linspace(0, 0.7, n)
    xyz = np.stack([10 * np.cos(th), 10 * np.sin(th), np.zeros(n)], 1).astype(np.float32)
    pw = dict(point_xyz=xyz, point_feat=np.ones((n, 2), np.float32),
              point_rimage_h=np.zeros(n, np.int64), segmentation_label=np.arange(n))
    got = TWaymo.spherical_resampling(None, copy.deepcopy(pw))
    assert_equal(dict(got), dict(JWaymo.spherical_resampling(None, copy.deepcopy(pw))))
    assert len(got["point_xyz"]) > n
    assert len(got["segmentation_label"]) == len(got["point_xyz"])
    assert np.abs(np.linalg.norm(got["point_xyz"][:, :2], axis=1) - 10).max() < 0.2
    # no row key and no fifth feature: unchanged
    pw = dict(point_xyz=xyz, point_feat=np.ones((n, 2), np.float32))
    assert TWaymo.spherical_resampling(None, pw) is pw


def test_semantic_seg_sampler(tmp_path):
    rng = np.random.RandomState(0)
    crop = np.concatenate([rng.randn(30, 3) * 0.3, np.ones((30, 1))], 1).astype(np.float32)
    crop2 = np.concatenate([rng.randn(12, 3) * 0.2, np.ones((12, 1))], 1).astype(np.float32)
    db = {"infos": [dict(points=crop, support_cls=18, trans_z=0.9),
                    dict(points=crop2, support_cls=21, trans_z=0.2),
                    dict(points=crop2 * 2, support_cls=18, trans_z=0.0)],
          "by_cls": {2: [0, 2], 5: [1]}}
    with open(tmp_path / "segdb.pkl", "wb") as f:
        pickle.dump(db, f)
    pts = np.zeros((100, 4), np.float32)
    pts[:, :2] = rng.rand(100, 2) * 20
    seg = np.where(np.arange(100) < 80, 18, 21).astype(np.int64)
    for groups, limit, seed in ((["2:1"], 0, 0), (["2:1", "5:2"], 0, 4), (["2:3", "5:1"], 2, 7)):
        np.random.seed(seed)
        cfg = dict(DB_PATH="segdb.pkl", SAMPLE_GROUPS=groups, SUPPORT_CLASSES=[18, 21],
                   SCENE_LIMIT=limit)
        ts = t_aug.SemanticSegSampler(EDict(cfg), root_path=str(tmp_path),
                                      rng=np.random.RandomState(seed))
        js = j_aug.SemanticSegSampler(JEDict(cfg), root_path=str(tmp_path))
        for _ in range(3):  # the round-robin pointers carry across scenes
            d = {"points": pts.copy(), "segmentation_label": seg.copy()}
            got = ts(copy.deepcopy(d))
            assert_equal(got, js(copy.deepcopy(d)))
    np.random.seed(0)
    cfg = EDict(DB_PATH="segdb.pkl", SAMPLE_GROUPS=["2:1"], SUPPORT_CLASSES=[18])
    d = {"points": pts.copy(), "segmentation_label": np.full(100, 18, np.int64)}
    got = t_aug.SemanticSegSampler(cfg, root_path=str(tmp_path), rng=np.random.RandomState(0))(
        copy.deepcopy(d))
    assert_equal(got, j_aug.SemanticSegSampler(JEDict(cfg), root_path=str(tmp_path))(
        copy.deepcopy(d)))
    assert len(got["points"]) - 100 == (got["segmentation_label"] == 2).sum() in (30, 12)


def test_point_contrast_views():
    np.random.seed(0)
    pts = np.random.rand(50, 4).astype(np.float32)
    want = j_aug.point_contrast_views(pts)
    rs = np.random.RandomState(0)
    rs.rand(50, 4)  # the generator where JAX's global one is after drawing pts
    got = t_aug.point_contrast_views(pts, rng=rs)
    assert_equal(list(got), list(want))
    v1, v2, pairs = got
    assert v1.shape == v2.shape == pts.shape and (pairs == np.arange(50)).all()
    d0 = np.linalg.norm(pts[0, :3] - pts[1, :3])
    assert abs(np.linalg.norm(v1[0, :3] - v1[1, :3]) - d0) < 0.3 * d0 + 0.2


def fg_scene(seed):
    rng = np.random.RandomState(seed)
    ground = np.concatenate([rng.rand(500, 2) * 30 - 15, np.zeros((500, 1))], axis=1)
    cars = [rng.randn(60, 3) * 0.5 + c for c in ([3.0, 0.0, 1.0], [-5.0, 2.0, 1.2], [8, -6, 1])]
    peds = [rng.randn(15, 3) * 0.2 + c for c in ([0.0, 6.0, 0.9], [0.5, 6.3, 0.9])]
    bikes = rng.randn(14, 3) * 0.3 + [0.2, 6.0, 1.0]
    signs = rng.randn(9, 3) * 0.1 + [-9.0, -9.0, 2.5]
    pts = np.concatenate([ground] + cars + peds + [bikes, signs]).astype(np.float32)
    seg_cls = np.concatenate([np.full(500, 17), np.full(180, 1), np.full(30, 6), np.full(14, 5),
                              np.full(9, 7)])
    seg_inst = np.concatenate([np.zeros(500), np.full(60, 7), np.full(60, 9), np.zeros(60),
                               np.full(15, 3), np.full(15, 4), np.full(14, 5),
                               np.zeros(9)]).astype(np.int64)
    boxes = np.asarray([[3.0, 0.0, 1.0, 4.0, 4.0, 4.0, 0.3], [0.0, 6.0, 0.9, 1.5, 1.5, 2.0, 0.0]],
                       np.float32)
    return pts, seg_cls, seg_inst, boxes


def test_extract_foreground_instances(tmp_path):
    """Seg-driven instance extraction: peeling by label and by radius, box
    attachment at >90% coverage, companion grouping, the support surface's
    z-gap and keep_every; records and files equal JAX's."""
    j_fg = jax_tool("extract_foreground_instances")
    pts, seg_cls, seg_inst, boxes = fg_scene(0)
    strategies = {1: dict(support=[17], radius=3.0, min_num_points=20, use_inst_label=True,
                          attach_box=True),
                  5: dict(support=[17], radius=1.5, min_num_points=10, use_inst_label=True,
                          attach_box=True, group_with=[6]),
                  6: dict(support=[17], radius=1.0, min_num_points=10, use_inst_label=True,
                          attach_box=True, keep_every=2),
                  7: dict(support=[17], radius=1.0, min_num_points=5, use_inst_label=False,
                          attach_box=False)}
    for strat in (strategies, None):
        got = t_fg.extract_foreground_instances(pts, seg_cls, seg_inst, boxes, "0001",
                                                str(tmp_path / "t"), strategies=strat,
                                                device="cpu")
        want = j_fg.extract_foreground_instances(pts, seg_cls, seg_inst, boxes, "0001",
                                                 str(tmp_path / "j"), strategies=strat)
        for recs in (got, want):
            for r in (x for v in recs.values() for x in v):
                assert os.path.exists(r["path"])
                r["path"] = (os.path.basename(r["path"]), np.load(r["path"]))
        assert_equal(got, want)
    assert len(got[1]) >= 1
    recs = t_fg.extract_foreground_instances(
        pts, seg_cls, seg_inst, boxes, "0002", str(tmp_path / "t"),
        strategies={1: strategies[1]}, device="cpu")[1]
    assert len(recs) == 3 and sum(r["box3d"] is not None for r in recs) == 1
    for r in recs:
        assert r["support"] == 17 and abs(r["trans_z"]) < 3.0
        assert np.load(r["path"]).shape[0] == r["num_points"]


def test_extract_foreground_instances_cli(tmp_path):
    """The module's main over a sequence directory equals the repository
    tool's main (the database pickle and every npy)."""
    seq = tmp_path / "seq"
    seq.mkdir()
    infos = []
    for f in range(2):
        pts, seg_cls, seg_inst, boxes = fg_scene(f + 1)
        np.save(seq / f"{f:04d}.npy", pts)
        np.save(seq / f"{f:04d}_seg.npy", np.stack([seg_inst, seg_cls], 1))
        infos.append(dict(point_cloud=dict(sample_idx=f), annos=dict(gt_boxes_lidar=boxes)))
    with open(tmp_path / "infos.pkl", "wb") as fo:
        pickle.dump(infos, fo)
    j_fg = jax_tool("extract_foreground_instances")
    args = ["--data_path", str(seq), "--info_pkl", str(tmp_path / "infos.pkl")]
    got = t_fg.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"])
    import sys

    argv = sys.argv
    try:
        sys.argv = ["extract_foreground_instances.py"] + args + ["--out_dir", str(tmp_path / "j")]
        j_fg.main()
    finally:
        sys.argv = argv
    with open(tmp_path / "j" / "foreground_db_infos.pkl", "rb") as f:
        want = pickle.load(f)
    for recs in (got, want):
        for r in (x for v in recs.values() for x in v):
            r["path"] = (os.path.basename(r["path"]), np.load(r["path"]))
    assert_equal(got, want)
    assert sum(len(v) for v in got.values()) >= 4


# ---------------------------------------------------------------------------
# the kNN stages at realistic density, the other processors, the utilities
# ---------------------------------------------------------------------------


def scanline(seed, n=2000, rows=(7,)):
    """Range-image rows of ``n`` points each over the full azimuth: ranges
    that run smoothly between jumps (walls, cars, open road), the row's
    elevation, 1 cm noise; features (intensity, elongation, range,
    rimage_w, rimage_h)."""
    rng = np.random.RandomState(seed)
    xyz, feat = [], []
    for h in rows:
        az = np.sort(rng.rand(n) * 2 * np.pi - np.pi)
        knots = np.sort(rng.rand(12) * 2 * np.pi - np.pi)
        level = rng.rand(13) * 45 + 5
        rng_m = level[np.searchsorted(knots, az)] * (1 + 0.05 * np.sin(5 * az))
        elev = -0.3 + 0.02 * h
        p = np.stack([rng_m * np.cos(elev) * np.cos(az), rng_m * np.cos(elev) * np.sin(az),
                      rng_m * np.sin(elev) + 1.8], 1) + rng.randn(n, 3) * 0.01
        xyz.append(p)
        feat.append(np.stack([rng.rand(n), rng.rand(n), rng_m / 75, az, np.full(n, h)], 1))
    return np.concatenate(xyz).astype(np.float32), np.concatenate(feat).astype(np.float32)


def knn_threshold_pairs(xyz, rows, k=10):
    """The (point, neighbour, d) of each row's 10-NN within KNN_EPS of a
    threshold of spherical resampling (0.3 m; (d + 1e-6) / 0.1 an integer)
    or of lidar_line_segment_v2 (d / (range + 1e-6) = DIST_TH 0.05)."""
    from scipy.spatial import cKDTree

    out = []
    for h in np.unique(rows):
        r = np.nonzero(rows == h)[0]
        p = xyz[r].astype(np.float64)
        d, idx = cKDTree(p).query(p, k=min(k, len(r)))
        steps = (d + 1e-6) / 0.1
        ratio = d / (np.linalg.norm(p, axis=1)[:, None] + 1e-6)
        near = ((np.abs(d - 0.3) < KNN_EPS) | (np.abs(steps - np.round(steps)) < KNN_EPS * 10)
                | (np.abs(ratio - 0.05) < KNN_EPS))
        near &= d > 0
        for i, j in zip(*np.nonzero(near)):
            out.append((int(r[i]), int(r[idx[i, j]]), float(d[i, j])))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_stages_on_a_dense_scanline(seed):
    """spherical_resampling and lidar_line_segment_v2 on one 2,000-point
    scanline (and, for seed 1, three rows) of realistic density."""
    xyz, feat = scanline(seed, rows=(7,) if seed == 0 else (3, 7, 40))
    rows = np.round(feat[:, 4]).astype(np.int64)
    near = knn_threshold_pairs(xyz, rows)
    print(f"kNN pairs within {KNN_EPS} of a threshold: {near}")
    pw = dict(point_xyz=xyz, point_feat=feat, segmentation_label=np.arange(len(xyz)))
    got = TWaymo.spherical_resampling(None, copy.deepcopy(pw))
    want = JWaymo.spherical_resampling(None, copy.deepcopy(pw))
    assert set(got) == set(want)
    assert len(got["point_xyz"]) == len(want["point_xyz"]) > len(xyz) * 1.2, near
    np.testing.assert_allclose(got["point_xyz"], want["point_xyz"], rtol=0, atol=KNN_EPS)
    np.testing.assert_allclose(got["point_feat"], want["point_feat"], rtol=0, atol=KNN_EPS)
    # a new point's labels come from its nearest original point; where two
    # originals are exactly as near (a midpoint), the port takes the lower
    # index and sklearn's tree its traversal's pick: listed, and held to be
    # such ties
    lab_t, lab_j = got.pop("segmentation_label"), want.pop("segmentation_label")
    q = got["point_xyz"].astype(np.float64)
    dist = lambda lab: np.linalg.norm(xyz[lab].astype(np.float64) - q, axis=1)  # noqa: E731
    ties = np.nonzero(lab_t != lab_j)[0]
    print(f"new points with two equally near originals, picked apart: "
          f"{[(int(i), int(lab_t[i]), int(lab_j[i])) for i in ties]}")
    assert (dist(lab_t)[ties] == dist(lab_j)[ties]).all()
    assert (lab_t[ties] < lab_j[ties]).all()
    assert (dist(lab_t) <= dist(lab_j)).all() and len(ties) < len(q) // 50
    if not near:
        assert_equal(dict(got), dict(want))
    cfg = {"NAME": "lidar_line_segment_v2", "DIST_TH": 0.05, "LARGE_SEGMENT_SIZE": 30}
    t, j = procs([cfg])
    d = {"points": np.concatenate([xyz, feat], 1), "point_rimage_h": rows}
    got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
    assert_equal(got, want)
    n_seg = len(np.unique(got["point_segment_id"]))
    assert 1 < n_seg < len(xyz) // 10 and got["point_in_large_segment"].mean() > 0.5
    t, _ = procs([dict(cfg, NAME="lidar_line_segment")])  # v1 runs v2
    assert_equal(t(copy.deepcopy(d)), got)


def processor_sample(seed, n=800, g=5):
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.rand(g, 2) * 30 - 15, rng.rand(g, 1), rng.rand(g, 3) * 3 + 1,
                            rng.rand(g, 1) * 6 - 3], 1).astype(np.float32)
    pts = np.concatenate([rng.rand(n - 20 * g, 3) * [40, 40, 4] - [20, 20, 1]]
                         + [boxes[b, :3] + rng.randn(20, 3) * 0.5 for b in range(g)])
    pts = np.concatenate([pts, rng.rand(n, 2)], 1).astype(np.float32)
    return {"points": pts, "gt_boxes": np.concatenate([boxes, np.ones((g, 1), np.float32)], 1),
            "gt_names": np.asarray(["Vehicle"] * g), "point_sweep": np.zeros(n, np.int32),
            "segmentation_label": rng.randint(0, 23, n), "instance_label": rng.randint(0, 9, n)}


@pytest.mark.parametrize("name,cfg", [
    ("propagate_box_label_to_points", {}),
    ("attach_spherical_feature", {}),
    ("point_centering", {}),
    ("remove_seg_class", {"CLASS_IDS": [0, 3, 17]}),
    ("sync_box_motion", {}),
])
def test_processor_equals_jax(name, cfg):
    t, j = procs([dict(cfg, NAME=name), {"NAME": "shuffle_points"}])
    for seed in (0, 1):
        np.random.seed(seed)
        t.rng = np.random.RandomState(seed)
        d = processor_sample(seed)
        got, want = t(copy.deepcopy(d)), j(copy.deepcopy(d))
        if name == "propagate_box_label_to_points":
            # labels equal except at points within FACE_EPS of a face
            near = near_face(got["points"], got["gt_boxes"]).any(0)
            print(f"points within {FACE_EPS} m of a face: {np.nonzero(near)[0].tolist()}")
            diff = got.pop("point_box_label") != want.pop("point_box_label")
            assert not (diff & ~near).any()
            assert (t(copy.deepcopy(d))["point_box_label"] >= 0).sum() > 50
        assert_equal(got, want)
    d = {"points": np.zeros((4, 5), np.float32)}  # no boxes, no labels
    assert_equal(t(copy.deepcopy(d)), j(copy.deepcopy(d)))


def test_box_and_polar_utils_equal_jax():
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.randn(40, 3) * 20, rng.rand(40, 3) * 4 + 0.5,
                            rng.rand(40, 1) * 12 - 6], 1)
    boxes[:5, 6] = [0, np.pi / 4, np.pi / 2, 3 * np.pi / 4, -np.pi]  # the axis-rounding edges
    for b in (boxes.astype(np.float32), boxes):
        assert_equal(t_box.boxes_to_corners_3d_np(b), j_box.boxes_to_corners_3d_np(b))
        assert_equal(t_box.boxes3d_lidar_to_aligned_bev_boxes(b),
                     j_box.boxes3d_lidar_to_aligned_bev_boxes(b))
        assert_equal(t_box.boxes3d_nearest_bev_iou(b[:25], b[10:]),
                     j_box.boxes3d_nearest_bev_iou(b[:25], b[10:]))
        for rng_lim, k in (([-30, -30, -2, 30, 30, 4], 1), ([-10, -40, -2, 40, 10, 4], 4)):
            assert_equal(t_box.mask_boxes_outside_range(b, rng_lim, k),
                         j_box.mask_boxes_outside_range(b, rng_lim, k))
        assert_equal(t_box.enlarge_box3d(b, (0.1, 0.2, 0.3)), j_box.enlarge_box3d(b, (0.1, 0.2, 0.3)))
    xyz = (rng.randn(500, 3) * 30).astype(np.float32)
    xyz[0] = 0
    for x in (xyz, xyz.astype(np.float64)):
        sph = t_polar.cartesian_to_spherical(x)
        assert_equal(sph, j_polar.cartesian_to_spherical(x))
        assert_equal(t_polar.spherical_to_cartesian(sph), j_polar.spherical_to_cartesian(sph))
    back = t_polar.spherical_to_cartesian(t_polar.cartesian_to_spherical(torch.as_tensor(xyz)))
    assert isinstance(back, torch.Tensor)
    np.testing.assert_allclose(back.numpy(), xyz, atol=1e-4)


# ---------------------------------------------------------------------------
# the GT database builder
# ---------------------------------------------------------------------------


def write_data_cfg(path, data_path):
    path.write_text(
        "CLASS_NAMES: ['Vehicle', 'Pedestrian']\n"
        "DATA_CONFIG:\n"
        "    DATASET: WaymoDataset\n"
        f"    DATA_PATH: '{data_path}'\n"
        "    PROCESSED_DATA_TAG: waymo_processed_data_v0_5_0\n"
        "    POINT_CLOUD_RANGE: [-74.88, -74.88, -2, 74.88, 74.88, 4]\n")
    return str(path)


@pytest.fixture(scope="module")
def two_roots(tmp_path_factory):
    """One written sequence (rotated boxes) under two roots, one for each
    package's database."""
    roots = [tmp_path_factory.mktemp(n) for n in ("t", "j")]
    seq, gt = make_scene(num_frames=3, points_per_frame=1500, seed=1)
    gt["gt_box_attr"][:, 6] = np.linspace(-2.0, 2.5, len(gt["gt_box_attr"]))
    for r in roots:
        write_waymo_sequence(r, seq, gt, "segment-db")
    return roots


def test_create_gt_database_equals_jax(two_roots, capsys):
    """The port's builder on the CPU against tools/create_gt_database.py
    (every frame): the dbinfos pickle and every crop file equal, except a
    crop holding a point within FACE_EPS of its box's face (listed)."""
    import sys

    troot, jroot = two_roots
    got, out = t_gtdb.main([write_data_cfg(troot / "data.yaml", troot), "--split", "val",
                            "--sampled_interval", "1", "--device", "cpu"])
    argv = sys.argv
    try:
        sys.argv = ["create_gt_database.py", write_data_cfg(jroot / "data.yaml", jroot),
                    "--split", "val", "--sampled_interval", "1"]
        jax_tool("create_gt_database").main()
    finally:
        sys.argv = argv
    assert out == troot / "waymo_dbinfos_val.pkl"
    with open(out, "rb") as f:
        assert_equal(pickle.load(f), got)
    with open(jroot / "waymo_dbinfos_val.pkl", "rb") as f:
        want = pickle.load(f)
    assert sorted(os.listdir(troot / "gt_database_val")) == sorted(
        os.listdir(jroot / "gt_database_val"))
    ds = TWaymo(dict(DATA_PATH=str(troot)), ["Vehicle"], training=False)
    flagged = []
    for info in ds.infos:
        pc = info["point_cloud"]
        pts = ds.get_lidar(pc["lidar_sequence"], pc["sample_idx"])
        near = near_face(pts, info["annos"]["gt_boxes_lidar"]).any(1)
        flagged += [f"{pc['lidar_sequence']}_{pc['sample_idx']:04d}_Vehicle_{j}.bin"
                    for j in np.nonzero(near)[0]]
    print(f"crops with a point within {FACE_EPS} m of a face: {flagged}")
    for recs in (got, want):
        for r in (x for v in recs.values() for x in v):
            r["path"] = (r["path"], None if Path(r["path"]).name in flagged else
                         np.fromfile((troot if recs is got else jroot) / r["path"], np.float32))
            if Path(r["path"][0]).name in flagged:
                r["num_points_in_gt"] = None
    assert_equal(got, want)
    assert len(got["Vehicle"]) == 72 and got["Pedestrian"] == []
    assert "Vehicle: 72 objects" in capsys.readouterr().out
