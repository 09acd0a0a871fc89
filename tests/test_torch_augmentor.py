"""The port's data augmentor and training-mode dataset item against the JAX
package's: the global and local augmentors, gt_sampling, and the training
items of detection_1sweep.yaml alone and with the whole data path.

The JAX augmentor and processors draw from the global NumPy generator, the
port's from one explicit ``RandomState`` that the dataset hands to both;
seeded alike, the draws are the same numbers in the same order
(augmentors, then ``shuffle_points``), and the arithmetic is the same
NumPy, so everything is held bit for bit: points, boxes, the recorded
``aug_world_rotation`` / ``aug_world_scaling``, and the voxel processor's
``voxel_size`` / ``grid_size``.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

from pcseqlearning_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml
from pcseqlearning_tpu.datasets import build_dataloader as j_build
from pcseqlearning_tpu.datasets.augmentor import DataAugmentor as JAugmentor
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.datasets import build_dataloader as t_build
from pcseqlearning_tpu_torch.datasets.augmentor import DataAugmentor as TAugmentor
from pcseqlearning_tpu_torch.scene import make_scene, write_data_path_cfg, write_waymo_sequence
from pcseqlearning_tpu_torch.tools.create_gt_database import create_gt_database
from pcseqlearning_tpu_torch.utils.edict import EDict

torch.set_num_threads(1)
DATA_CFG = "tools/cfgs/dataset_configs/waymo/detection_1sweep.yaml"

AUGMENTORS = {
    "flip_x": [dict(NAME="random_world_flip", ALONG_AXIS_LIST=["x"])],
    "flip_y": [dict(NAME="random_world_flip", ALONG_AXIS_LIST=["y"])],
    "flip_xy": [dict(NAME="random_world_flip", ALONG_AXIS_LIST=["x", "y"])],
    "rotation": [dict(NAME="random_world_rotation", WORLD_ROT_ANGLE=[-0.78539816, 0.78539816])],
    "scaling": [dict(NAME="random_world_scaling", WORLD_SCALE_RANGE=[0.95, 1.05])],
    "translation": [dict(NAME="random_world_translation", NOISE_TRANSLATE_STD=[0.2, 0.3, 0.05])],
}


def sample(seed, n=300, g=6):
    rng = np.random.RandomState(100 + seed)
    boxes = np.concatenate([rng.randn(g, 3) * 20, rng.rand(g, 3) * 4 + 0.5,
                            rng.rand(g, 1) * 6 - 3, rng.randint(1, 4, (g, 1))], 1)
    return {"points": (rng.randn(n, 5) * 30).astype(np.float32),
            "gt_boxes": boxes.astype(np.float32),
            "gt_names": np.asarray(["Vehicle"] * g)}


def assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v and type(got[k]) is type(v), k


def run_both(cfg, seed, calls=3):
    """``calls`` samples through each package's augmentor from one seed."""
    np.random.seed(seed)
    jaug = JAugmentor(JEDict(cfg))
    taug = TAugmentor(EDict(cfg), rng=np.random.RandomState(seed))
    outs = []
    for i in range(calls):
        d = sample(i)
        outs.append((taug(copy.deepcopy(d)), jaug(copy.deepcopy(d))))
    return outs, taug


@pytest.mark.parametrize("name", sorted(AUGMENTORS))
@pytest.mark.parametrize("seed", [0, 3])
def test_global_augmentor_equals_jax(name, seed):
    outs, _ = run_both(dict(AUG_CONFIG_LIST=AUGMENTORS[name]), seed)
    changed = 0
    for got, want in outs:
        assert_dicts_equal(got, want)
        changed += not np.array_equal(got["points"], sample(0)["points"])
    assert changed  # the draws did something in at least one call


def test_flip_headings_follow_the_jax_convention():
    """Along x: y and the heading negate; along y: x negates and the
    heading becomes -(h + pi)."""
    d = sample(0)
    for axis, col, head in (("x", 1, lambda h: -h), ("y", 0, lambda h: -(h + np.pi))):
        aug = TAugmentor(dict(AUG_CONFIG_LIST=[dict(NAME="random_world_flip",
                                                    ALONG_AXIS_LIST=[axis])]))
        aug.rng = type("Always", (), {"rand": staticmethod(lambda: 0.9)})()
        out = aug(copy.deepcopy(d))
        np.testing.assert_array_equal(out["points"][:, col], -d["points"][:, col])
        np.testing.assert_array_equal(out["gt_boxes"][:, 6], head(d["gt_boxes"][:, 6]))


def test_disable_list_and_queue_equal_jax():
    """detection_1sweep.yaml's queue with one entry disabled: the queue
    skips it, and three samples in a row (the draws carry on) equal JAX."""
    cfg = cfg_from_yaml_file(DATA_CFG, EDict()).DATA_CONFIG.DATA_AUGMENTOR
    cfg.DISABLE_AUG_LIST = ["random_world_rotation"]
    outs, taug = run_both(cfg, 5)
    assert len(taug.queue) == 2  # flip and scaling
    for got, want in outs:
        assert_dicts_equal(got, want)
        assert "aug_world_scaling" in got and "aug_world_rotation" not in got


LOCAL = {
    "random_local_translation": dict(NAME="random_local_translation",
                                     LOCAL_TRANSLATION_RANGE=[-0.5, 0.5],
                                     ALONG_AXIS_LIST=["x", "y", "z"]),
    "random_local_rotation": dict(NAME="random_local_rotation", LOCAL_ROT_ANGLE=0.4),
    "random_local_scaling": dict(NAME="random_local_scaling", LOCAL_SCALE_RANGE=[0.9, 1.1]),
    "gt_sampling": dict(NAME="gt_sampling", DB_INFO_PATH="dbinfos.pkl", MIN_POINTS=5,
                        SAMPLE_GROUPS=["Vehicle:9", "Pedestrian:2"]),
}


def object_sample(seed, n=400, g=6):
    """``sample``'s boxes with 25 member points each among the scatter."""
    d = sample(seed, n - 25 * g, g)
    rng = np.random.RandomState(200 + seed)
    members = [np.concatenate([b[:3] + (rng.rand(25, 3) - 0.5) * b[3:6] * 0.9,
                               rng.rand(25, 2)], 1) for b in d["gt_boxes"]]
    d["points"] = np.concatenate([d["points"]] + members).astype(np.float32)
    d["gt_boxes"] = d["gt_boxes"][:, :7]
    return d


@pytest.fixture(scope="module")
def crop_db(tmp_path_factory):
    """A database of 24 Vehicle crops (some under MIN_POINTS) and 4
    Pedestrian crops, 6 features a point (the samples have 5), its boxes
    spread over +-60 m."""
    root = tmp_path_factory.mktemp("db")
    (root / "gt_db").mkdir()
    rng = np.random.RandomState(9)
    infos = {"Vehicle": [], "Pedestrian": []}
    for i, (cls, nf) in enumerate([("Vehicle", 6)] * 24 + [("Pedestrian", 6)] * 4):
        box = np.concatenate([rng.rand(2) * 120 - 60, [0.5], rng.rand(3) * 3 + 1,
                              [rng.rand() * 6 - 3]]).astype(np.float32)
        n = int(rng.randint(2, 40))
        pts = np.concatenate([(rng.rand(n, 3) - 0.5) * box[3:6], rng.rand(n, nf - 3)], 1)
        pts.astype(np.float32).tofile(root / "gt_db" / f"obj{i}.bin")
        infos[cls].append(dict(path=f"gt_db/obj{i}.bin", box3d_lidar=box, num_features=nf,
                               num_points_in_gt=n))
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(infos, f)
    return root


@pytest.mark.parametrize("name", ["random_local_translation", "random_local_rotation",
                                  "random_local_scaling", "gt_sampling"])
def test_unported_augmentors_raise(name, crop_db):
    """Each of the four augmentors that were not ported (and raised) builds
    and equals JAX's bit for bit, over four samples in a row from one seed
    (the draws carry on), alone and after the global ones; a disabled entry
    is never built."""
    for cfg_list in ([LOCAL[name]], AUGMENTORS["flip_xy"] + AUGMENTORS["rotation"]
                     + [LOCAL[name]]):
        for seed in (0, 3):
            np.random.seed(seed)
            jaug = JAugmentor(JEDict(AUG_CONFIG_LIST=cfg_list), root_path=str(crop_db))
            taug = TAugmentor(EDict(AUG_CONFIG_LIST=cfg_list), root_path=str(crop_db),
                              rng=np.random.RandomState(seed))
            changed = 0
            for i in range(4):
                d = object_sample(i)
                got = taug(copy.deepcopy(d))
                assert_dicts_equal(got, jaug(copy.deepcopy(d)))
                changed += not np.array_equal(got["gt_boxes"][:, :7], d["gt_boxes"][:, :7])
            assert changed == 4
    if name == "gt_sampling":
        assert len(got["gt_boxes"]) > len(d["gt_boxes"]) and len(got["gt_names"]) == len(
            got["gt_boxes"])
    aug = TAugmentor(dict(AUG_CONFIG_LIST=[dict(NAME=name)], DISABLE_AUG_LIST=[name]))
    assert aug.queue == []


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    seq, gt = make_scene(num_frames=3, points_per_frame=1500, seed=2)
    gt["gt_box_attr"][:, 6] = np.linspace(-2.0, 2.5, len(gt["gt_box_attr"]))
    write_waymo_sequence(root, seq, gt, "segment-det")
    return root


@pytest.mark.parametrize("seed", [0, 11])
def test_training_item_equals_jax(written, seed):
    """detection_1sweep.yaml's training items (class filter, augmentor,
    class ids, encoder, range mask, shuffle, voxel processor), three in a
    row from one seed, bit for bit."""
    tcfg = cfg_from_yaml_file(DATA_CFG, EDict()).DATA_CONFIG
    jcfg = j_cfg_from_yaml(DATA_CFG, JEDict()).DATA_CONFIG
    for c in (tcfg, jcfg):
        c.DATA_PATH = str(written)
    names = ["Vehicle", "Pedestrian", "Cyclist"]
    tds, _ = t_build(tcfg, names, 1, training=True, rng=np.random.RandomState(seed))
    jds, _ = j_build(jcfg, names, 1, training=True)
    np.testing.assert_array_equal(tds.grid_size, jds.grid_size)
    np.testing.assert_array_equal(tds.voxel_size, jds.voxel_size)
    assert tds.grid_size.tolist() == [1498, 1498, 40]
    np.random.seed(seed)
    keys = ("points", "gt_boxes", "gt_names", "aug_world_rotation", "aug_world_scaling",
            "voxel_size", "grid_size")
    for i in range(3):
        got, want = tds[i], jds[i]
        assert_dicts_equal({k: got[k] for k in keys}, {k: want[k] for k in keys})
        assert got["points"].shape[1] == 5 and len(got["gt_boxes"])


@pytest.fixture(scope="module")
def scene_db(tmp_path_factory):
    """The GT database of another scene (seed 5, 3 frames, 72 objects),
    built by the port's builder on the CPU."""
    root = tmp_path_factory.mktemp("scene_db")
    write_waymo_sequence(root, *make_scene(num_frames=3, points_per_frame=1500, seed=5),
                         "segment-db")
    cfg = EDict(DATASET="WaymoDataset", DATA_PATH=str(root),
                PROCESSED_DATA_TAG="waymo_processed_data_v0_5_0")
    infos, _ = create_gt_database(cfg, ["Vehicle"], split="train", sampled_interval=1,
                                  device="cpu", verbose=False)
    assert len(infos["Vehicle"]) == 72
    return root


@pytest.mark.parametrize("seed", [0, 11])
def test_training_item_on_the_whole_data_path_equals_jax(written, scene_db, seed, monkeypatch):
    """``scene.write_data_path_cfg``'s config (chip_smoke.py's phase 13):
    gt_sampling from the database (DB_INFO_PATH and the crops resolved
    against the working directory, in both packages), the global and local
    augmentors, the frame cache and MIX3D; four training items in a row
    from one seed equal JAX's bit for bit, boxes are pasted and a cached
    frame is read back."""
    monkeypatch.chdir(scene_db)
    path = write_data_path_cfg(scene_db / "data.yaml", "waymo_dbinfos_train.pkl")
    tcfg = cfg_from_yaml_file(path, EDict()).DATA_CONFIG
    jcfg = j_cfg_from_yaml(path, JEDict()).DATA_CONFIG
    for c in (tcfg, jcfg):
        c.DATA_PATH = str(written)
    names = ["Vehicle", "Pedestrian", "Cyclist"]
    np.random.seed(seed)
    tds, _ = t_build(tcfg, names, 1, training=True, rng=np.random.RandomState(seed))
    jds, _ = j_build(jcfg, names, 1, training=True)
    keys = ("points", "point_sweep", "gt_boxes", "gt_names", "aug_world_rotation",
            "aug_world_scaling")
    sampler, pasted = tds.data_augmentor._db_sampler, []

    def counting(d):
        n = len(d["gt_boxes"])
        out = sampler(d)
        pasted.append(len(out["gt_boxes"]) - n)
        return out

    tds.data_augmentor._db_sampler = counting
    for i in (0, 1, 2, 0):
        got, want = tds[i], jds[i]
        assert_dicts_equal({k: got[k] for k in keys}, {k: want[k] for k in keys})
    print(f"boxes pasted per sample (MIX3D's inner items included): {pasted}")
    assert len(pasted) > 4 and 0 < max(pasted) <= 16 and len(tds._frame_cache) == 3
