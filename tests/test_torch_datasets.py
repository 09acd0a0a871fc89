"""The port's data layer against the JAX package's: the Waymo sequence
dataset over a layout written by ``scene.write_waymo_sequence``, the
processors, the loader and the collation.

Both packages read the same files; the batches must be equal key by key
and value by value (dtype included), except the box corners
``gt_box_corners_3d``, which each package computes with its own cos/sin
and products (XLA against torch on the CPU): those are held to 2 ulp of
float32 at the scene's coordinates (2e-5 absolute). Random draws
(``limit_num_points``, ``shuffle_points``) come from the global NumPy
generator in JAX and from an explicit ``RandomState`` in the port: with the
same seed they are equal.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

from pcseqlearning_tpu.datasets import build_dataloader as j_build
from pcseqlearning_tpu.datasets import collate_batch as j_collate
from pcseqlearning_tpu.datasets.processor import DataProcessor as JProcessor
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.datasets import build_dataloader as t_build
from pcseqlearning_tpu_torch.datasets import collate_batch as t_collate
from pcseqlearning_tpu_torch.datasets.processor import DataProcessor as TProcessor
from pcseqlearning_tpu_torch.scene import make_scene, write_waymo_sequence
from pcseqlearning_tpu_torch.utils.edict import EDict

torch.set_num_threads(1)
DATASET_CFG = "tools/cfgs/dataset_configs/waymo/registration/all_sequence.yaml"
CORNER_ATOL = 2e-5


def _write(root, num_seqs=2, frames=4, points=600, moving_ego=True):
    """Two short sequences; the ego pose turns and drives so that the
    sweeps' alignment and the boxes' headings are exercised."""
    for s in range(num_seqs):
        seq, gt = make_scene(num_frames=frames, points_per_frame=points, seed=s)
        gt["gt_box_attr"][:, 6] = np.linspace(-2.0, 2.5, len(gt["gt_box_attr"]))
        d = write_waymo_sequence(root, seq, gt, f"segment-{s:04d}")
        if moving_ego:
            with open(d / f"segment-{s:04d}.pkl", "rb") as f:
                infos = pickle.load(f)
            for i, info in enumerate(infos):
                a = 0.05 * i + 0.3 * s
                pose = np.eye(4)
                pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
                pose[:3, 3] = [2.0 * i, -0.5 * i, 0.01 * i]
                info["pose"] = pose
            with open(d / f"segment-{s:04d}.pkl", "wb") as f:
                pickle.dump(infos, f)
    return root


def _assert_batches_equal(bt, bj):
    assert set(bt) == set(bj)
    for key in bj:
        vt, vj = bt[key], bj[key]
        if key == "gt_box_corners_3d":
            for a, b in zip(vt, vj):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=0, atol=CORNER_ATOL)
        elif isinstance(vj, np.ndarray):
            assert isinstance(vt, np.ndarray) and vt.dtype == vj.dtype, key
            np.testing.assert_array_equal(vt, vj, err_msg=key)
        elif isinstance(vj, list):
            assert len(vt) == len(vj), key
            for a, b in zip(vt, vj):
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype, key
                    np.testing.assert_array_equal(a, b, err_msg=key)
                else:
                    assert a == b, key
        else:
            assert vt == vj, key


def _batches(loader):
    return list(iter(loader))


def test_sequence_mode_batches_match_jax(tmp_path):
    """The README's dataset config (sequence mode, 210 sweeps, segmentation
    labels, limit_num_points) over a written layout."""
    _write(tmp_path)
    cfg = EDict()
    cfg_from_yaml_file(DATASET_CFG, cfg)
    dcfg = cfg.DATA_CONFIG
    dcfg.DATA_PATH = str(tmp_path)
    dcfg.DATA_PROCESSOR[0].MAX_NUM_POINTS = 2000  # draw a subsample
    names = ["Vehicle", "Pedestrian", "Cyclist"]
    np.random.seed(3)
    ds_j, ld_j = j_build(JEDict(dcfg), names, 1, training=True, seed=3)
    ds_t, ld_t = t_build(dcfg, names, 1, training=True, seed=3)
    assert len(ds_t) == len(ds_j) == 2  # one item per sequence
    bj, bt = _batches(ld_j), _batches(ld_t)
    assert len(bt) == len(bj) == 2
    for a, b in zip(bt, bj):
        _assert_batches_equal(a, b)
    b = bt[0]
    assert b["point_bxyz"].shape == (2000, 4) and b["point_feat"].shape == (2000, 2)
    assert sorted(np.unique(b["point_sweep"])) == [0, 1, 2, 3]
    assert b["frame_id"][0].endswith("_003")  # anchored at the last sample
    assert len(b["gt_box_attr"][0]) == 4 * 24  # padded per sweep


def test_single_sweep_batches_match_jax(tmp_path):
    """Single sweeps, two to a batch, shuffled, with the range mask, the
    point shuffle and a subsample."""
    _write(tmp_path)
    cfg = EDict(
        DATASET="WaymoDataset",
        DATA_PATH=str(tmp_path),
        PROCESSED_DATA_TAG="waymo_processed_data_v0_5_0",
        POINT_CLOUD_RANGE=[-50, -50, -3, 50, 50, 5],
        NUM_SWEEPS=1,
        LOAD_SEG=True,
        POINT_FEATURE_ENCODING=dict(
            used_feature_list=["x", "y", "z", "intensity"],
            src_feature_list=["x", "y", "z", "intensity", "elongation", "range", "rimage_w",
                              "rimage_h"]),
        DATA_PROCESSOR=[
            dict(NAME="mask_points_and_boxes_outside_range", REMOVE_OUTSIDE_BOXES=True),
            dict(NAME="shuffle_points", SHUFFLE_ENABLED=dict(train=True, test=False)),
            dict(NAME="limit_num_points", MAX_NUM_POINTS=300),
        ],
    )
    np.random.seed(7)
    ds_j, ld_j = j_build(JEDict(cfg), ["Vehicle"], 2, training=True, seed=7)
    ds_t, ld_t = t_build(cfg, ["Vehicle"], 2, training=True, seed=7)
    assert len(ds_t) == len(ds_j) == 8 and len(ld_t) == len(ld_j) == 4
    bj, bt = _batches(ld_j), _batches(ld_t)
    for a, b in zip(bt, bj):
        _assert_batches_equal(a, b)
    gb = bt[0]["gt_boxes"]
    assert gb.shape[0] == 2 and gb.shape[2] == 8
    assert (np.abs(gb[..., :2]) <= 51).all()  # boxes outside the range dropped
    # evaluation mode: no shuffle, no box filter, sequential order
    np.random.seed(0)
    ds_t2, ld_t2 = t_build(cfg, ["Vehicle"], 2, training=False, seed=0)
    ds_j2, ld_j2 = j_build(JEDict(cfg), ["Vehicle"], 2, training=False, seed=0)
    for a, b in zip(_batches(ld_t2), _batches(ld_j2)):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("n, max_n", [(5000, 1200), (300, 1200)])
def test_limit_num_points_matches_jax(n, max_n):
    rng = np.random.RandomState(0)
    d = {"points": rng.rand(n, 4).astype(np.float32), "point_sweep": rng.randint(0, 4, n),
         "segmentation_label": rng.randint(0, 20, n)}
    cfgs = [dict(NAME="limit_num_points", MAX_NUM_POINTS=max_n)]
    np.random.seed(11)
    want = JProcessor([JEDict(c) for c in cfgs], [-1] * 3 + [1] * 3, True)(dict(d))
    got = TProcessor(cfgs, [-1] * 3 + [1] * 3, True, rng=np.random.RandomState(11))(dict(d))
    for k in d:
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["points"]) == min(n, max_n)


def test_collate_batch_on_mixed_keys():
    rng = np.random.RandomState(1)
    samples = []
    for b, n in enumerate((5, 3)):
        samples.append(dict(
            points=rng.rand(n, 5).astype(np.float32),
            point_sweep=np.full(n, b, np.int32),
            gt_boxes=rng.rand(b + 1, 8).astype(np.float32),
            frame_id=f"s_{b:03d}",
            obj_ids=np.asarray([f"o{i}" for i in range(b + 1)]),
            use_lead_xyz=True,
            image_shape=np.array([4, 6]),
            ragged=rng.rand(n, 2),
        ))
    samples[1]["only_second"] = 7
    want, got = j_collate(samples), t_collate(samples)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        elif isinstance(want[k], list):
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
        else:
            assert got[k] == want[k]
    assert got["point_bxyz"].shape == (8, 4) and got["point_feat"].shape == (8, 2)
    assert got["gt_boxes"].shape == (2, 2, 8) and got["batch_size"] == 2
    assert got["only_second"] == [None, 7]


def test_unported_pieces_raise(tmp_path):
    """What the port once lacked and refused now builds and equals JAX: the
    voxel processor's grid, a processor beyond the first four
    (attach_spherical_feature), gt_sampling in the training split (none in
    the test split), SPHERICAL_RESAMPLING, MIX3D, WITH_TIME_FEAT,
    USE_SHARED_MEMORY (with its FIFO bound) and the "waymo" and "waymo_ii"
    metrics. Batches are held as in the other tests of this file."""
    _write(tmp_path, num_seqs=2, frames=3, points=500)
    base = dict(DATASET="WaymoDataset", DATA_PATH=str(tmp_path),
                PROCESSED_DATA_TAG="waymo_processed_data_v0_5_0", NUM_SWEEPS=1,
                POINT_CLOUD_RANGE=[-75.2, -75.2, -2, 75.2, 75.2, 4],
                DATA_PROCESSOR=[dict(NAME="shuffle_points",
                                     SHUFFLE_ENABLED=dict(train=True, test=False))])
    ds, _ = t_build(dict(DATASET="WaymoDataset", DATA_PATH=str(tmp_path), DATA_PROCESSOR=[
        dict(NAME="transform_points_to_voxels", VOXEL_SIZE=[0.1, 0.1, 0.1])]), [], 1)
    assert ds.grid_size.tolist() == [1504, 1504, 60] and ds.voxel_size.dtype == np.float32
    ds, _ = t_build(dict(base, DATA_AUGMENTOR=dict(AUG_CONFIG_LIST=[dict(NAME="gt_sampling")])),
                    [], 1, training=True)
    assert len(ds.data_augmentor.queue) == 1 and ds.data_augmentor._db_sampler.db_infos == {}
    ds, _ = t_build(dict(base, DATA_AUGMENTOR=dict(AUG_CONFIG_LIST=[dict(NAME="gt_sampling")])),
                    [], 1, training=False)  # no augmentor in the test split
    assert ds.data_augmentor is None
    names = ["Vehicle"]
    cases = {
        "attach_spherical_feature": (dict(base, DATA_PROCESSOR=base["DATA_PROCESSOR"] + [
            dict(NAME="attach_spherical_feature")]), True),
        "SPHERICAL_RESAMPLING": (dict(base, SPHERICAL_RESAMPLING=True), False),
        "MIX3D": (dict(base, MIX3D=dict(PROB=0.6)), True),
        "WITH_TIME_FEAT": (dict(base, NUM_SWEEPS=3, SEQUENCE_MODE=False, WITH_TIME_FEAT=True,
                                POINT_FEATURE_ENCODING=dict(
                                    src_feature_list=["x", "y", "z", "time", "intensity"],
                                    used_feature_list=["x", "y", "z", "time", "intensity"])),
                           True),
        "USE_SHARED_MEMORY": (dict(base, USE_SHARED_MEMORY=True, SHARED_MEMORY_CACHE_SIZE=2),
                              True),
    }
    for key, (cfg, training) in cases.items():
        np.random.seed(5)
        ds_t, ld_t = t_build(cfg, names, 2, training=training, seed=5)
        ds_j, ld_j = j_build(JEDict(cfg), names, 2, training=training, seed=5)
        bt, bj = _batches(ld_t) + _batches(ld_t), _batches(ld_j) + _batches(ld_j)
        assert len(bt) == len(bj) > 0, key
        for a, b in zip(bt, bj):
            _assert_batches_equal(a, b)
        n_plain = 500 * 2 * (3 if key == "WITH_TIME_FEAT" else 1)
        if key == "SPHERICAL_RESAMPLING":
            assert len(bt[0]["point_bxyz"]) > n_plain
        if key == "MIX3D":
            assert max(len(b["point_bxyz"]) for b in bt) > n_plain
        if key == "WITH_TIME_FEAT":
            assert sorted(np.unique(bt[0]["point_feat"][:, 0])) == [0.0, 0.5, 1.0]
        if key == "USE_SHARED_MEMORY":
            assert len(ds_t._frame_cache) == len(ds_j._frame_cache) == 3
    ds, _ = t_build(base, names, 1, training=False)
    for metric, key in (("waymo", "Vehicle/L1/AP"), ("waymo_ii", "Vehicle/II_0/AP")):
        dets = [dict(name=info["annos"]["name"], boxes_lidar=info["annos"]["gt_boxes_lidar"],
                     score=np.linspace(0.9, 0.1, len(info["annos"]["name"])).astype(np.float32))
                for info in ds.infos]
        got = ds.evaluation(copy.deepcopy(dets), names, eval_metric=metric)[1]
        want = j_build(JEDict(base), names, 1, training=False)[0].evaluation(
            copy.deepcopy(dets), names, eval_metric=metric)[1]
        assert set(got) == set(want)
        assert all(abs(got[k] - want[k]) <= 1e-9 for k in want)
        assert abs(got[key] - 1.0) < 1e-9
