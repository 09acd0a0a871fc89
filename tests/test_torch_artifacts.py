"""The stages' on-disk artifacts against the JAX package's: the ground
stage's DIR warm-start file and LOG_DIR stat files, the proposal's DIR, and
the tracking stage's DIR pickles (per tracked frame and ``all.pkl``), which
``tools/parse_*_results.py`` read.

Tolerances: the warm start runs no solve, only the voxel mean and the
pillar lookups, so per-point height and error agree to float32 rounding of
the voxel sums (1e-5 m) and the horizon flags exactly; the stat files are
text-identical; the pickles hold NumPy arrays only, under the JAX module's
file names and keys.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pcseqlearning_tpu.preprocessing import cluster_tracking as jct
from pcseqlearning_tpu.preprocessing import ground_removal as jg
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch import pipeline
from pcseqlearning_tpu_torch.convert import config_from_jax
from pcseqlearning_tpu_torch.preprocessing import ClusterProposal, ClusterTracking
from pcseqlearning_tpu_torch.preprocessing import ground_removal as tg
from pcseqlearning_tpu_torch.scene import scene_dict

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
HEIGHT_ATOL = 1e-5


def _ground_cfg(tmp_path, **extra):
    return dict(pipeline.PARITY["ground"], DIR=str(tmp_path / "height"),
                LOG_DIR=str(tmp_path / "log"), TRUNCATE_HEIGHT=[0.3, 0.5], **extra)


def _scene():
    d = scene_dict(3, 2000, seed=2, frame_id="segment-7_002")
    d["segmentation_label"] = np.where(d["point_fxyz"][:, 3] < 0.3, 18, 1).astype(np.int64)
    return d


def _outputs(d):
    return (np.asarray(d["full_point_height"]), np.asarray(d["full_point_horizon"]),
            np.asarray(d["point_error"]))


def test_ground_warm_start_matches_jax_and_runs_no_solve(tmp_path, monkeypatch):
    cfg = _ground_cfg(tmp_path)
    d = _scene()
    npz = tmp_path / "height" / "segment-7" / "pillar_height.npz"
    jg.GroundPlaneRemover(JEDict(cfg))(dict(d))  # the JAX package writes the file
    with np.load(npz) as f:
        shapes = {k: f[k].shape for k in f.files}
        assert sorted(f.files) == ["pillar_height", "pillar_min_z"]
    rng = np.random.RandomState(0)  # a given random field of the same shape
    field = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    np.savez(npz, **field)
    want = _outputs(jg.GroundPlaneRemover(JEDict(cfg))(dict(d)))

    def no_solve(*a, **k):
        raise AssertionError("the warm start ran the solve")

    monkeypatch.setattr(tg, "ransac_min_height", no_solve)
    monkeypatch.setattr(tg, "l1_minimization", no_solve)
    got = _outputs(tg.GroundPlaneRemover(cfg, device="cpu")(dict(d)))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=HEIGHT_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=HEIGHT_ATOL)
    with np.load(npz) as f:  # read, not rewritten
        np.testing.assert_array_equal(f["pillar_height"], field["pillar_height"])


def test_ground_files_are_interchangeable(tmp_path):
    """A port-written file is the JAX one's layout and loads in JAX; both
    packages' warm starts from it agree."""
    cfg = _ground_cfg(tmp_path)
    d = _scene()
    cold = tg.GroundPlaneRemover(cfg, device="cpu")(dict(d))
    npz = tmp_path / "height" / "segment-7" / "pillar_height.npz"
    with np.load(npz) as f:
        port_file = {k: f[k] for k in f.files}
    assert sorted(port_file) == ["pillar_height", "pillar_min_z"]
    assert all(v.dtype == np.float32 and v.ndim == 1 for v in port_file.values())
    jax_dir = tmp_path / "jax"
    jg.GroundPlaneRemover(JEDict(_ground_cfg(jax_dir)))(dict(d))
    with np.load(jax_dir / "height" / "segment-7" / "pillar_height.npz") as f:
        assert {k: (f[k].shape, f[k].dtype) for k in f.files} == {
            k: (v.shape, v.dtype) for k, v in port_file.items()}
    want = _outputs(jg.GroundPlaneRemover(JEDict(cfg))(dict(d)))  # JAX reads the port's file
    got = _outputs(tg.GroundPlaneRemover(cfg, device="cpu")(dict(d)))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=HEIGHT_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    # the warm start reproduces the cold run's heights from its own field
    np.testing.assert_allclose(got[0], np.asarray(cold["full_point_height"]), rtol=0,
                               atol=HEIGHT_ATOL)


@pytest.mark.parametrize("height", [0.3, 0.5])
def test_ground_stat_files_match_jax_text(tmp_path, height):
    cfg = _ground_cfg(tmp_path)
    rng = np.random.RandomState(1)
    seg = rng.randint(0, 23, 5000)
    mask = rng.rand(5000) < 0.6
    jstats = jg.GroundPlaneRemover(JEDict(cfg)).output_stats(seg, mask, "seq-a",
                                                               str(tmp_path / "j"))
    tstats = tg.GroundPlaneRemover(cfg, device="cpu").output_stats(seg, mask, "seq-a",
                                                                    str(tmp_path / "t"))
    assert tstats == jstats
    assert (tmp_path / "t" / "seq-a.txt").read_text() == (tmp_path / "j" / "seq-a.txt").read_text()
    # the stage writes one file per TRUNCATE_HEIGHT, which the parse tool reads
    tg.GroundPlaneRemover(cfg, device="cpu")(_scene())
    path = tmp_path / "log" / f"height{height}" / "segment-7.txt"
    assert path.read_text().startswith(repr(dict(cfg)))
    out = subprocess.run([sys.executable, str(REPO / "tools" / "parse_ground_removal_results.py"),
                          str(tmp_path / "log")], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"height{height}: sequences=1 ground_precision=" in out.stdout


def test_proposal_dir_only_creates_the_directory(tmp_path):
    d = scene_dict(3, 1500)
    cfg = config_from_jax(dict(pipeline.PARITY["proposal"], DIR=str(tmp_path / "prop")))
    ClusterProposal(cfg, device="cpu")(d)
    assert (tmp_path / "prop").is_dir() and not any((tmp_path / "prop").iterdir())


def _tracking_cfg(tmp_path, **extra):
    return dict(pipeline.PARITY["tracking"], DIR=str(tmp_path / "trk"),
                TRACK_POINTS_PER_COMPONENT=64, TRACK_EXTRACT_POINTS=128,
                TRACK_NUM_CANDIDATES=128, **extra)


def _proposed(frames=5, points=2000):
    stages = pipeline.build_stages(pipeline.PARITY, device="cpu")
    d = scene_dict(frames, points, seed=4, frame_id="segment-9_004")
    for stage in stages[:2]:
        d = stage(d)
    return d


def _numpy_only(table):
    return all(isinstance(v, (np.ndarray, np.generic)) for v in table.values())


@pytest.fixture(scope="module")
def proposed():
    return _proposed()


@pytest.mark.parametrize("walk", ["batched", "host", "stepped"])
def test_tracking_dir_files_skip_and_payloads(tmp_path, proposed, walk):
    cfg = config_from_jax(_tracking_cfg(tmp_path, WALK_MODE=walk))
    out = ClusterTracking(cfg, device="cpu")(dict(proposed))
    seq_dir = tmp_path / "trk" / "segment-9"
    names = sorted(p.name for p in seq_dir.iterdir())
    assert names == ["000_component_rad1x25.pkl", "004_component_rad1x25.pkl", "all.pkl"]
    with open(seq_dir / "all.pkl", "rb") as f:
        boxes = pickle.load(f)
    assert type(boxes) is dict and _numpy_only(boxes)
    assert sorted(boxes) == ["attr", "best_iou", "cls_label", "frame", "moving", "trace_id", "velo"]
    np.testing.assert_array_equal(boxes["best_iou"], out["seq_boxes"].best_iou)
    with open(seq_dir / "004_component_rad1x25.pkl", "rb") as f:
        ex = pickle.load(f)
    assert type(ex) is dict and _numpy_only(ex)
    assert sorted(ex) == ["component", "component_hit", "fxyz", "moving", "original_indices",
                          "segmentation_label", "transforms"]
    stamp = {n: os.stat(seq_dir / n).st_mtime_ns for n in names}
    again = ClusterTracking(cfg, device="cpu")(dict(proposed))  # skipped
    assert "seq_boxes" not in again
    assert {n: os.stat(seq_dir / n).st_mtime_ns for n in names} == stamp
    res = subprocess.run([sys.executable, str(REPO / "tools" / "parse_cluster_tracking_results.py"),
                          str(tmp_path / "trk")], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"segment-9: boxes={len(boxes['best_iou'])}" in res.stdout
    assert f"mIoU={boxes['best_iou'].mean():.4f}" in res.stdout


def test_tracking_dir_matches_jax_layout(tmp_path, proposed):
    """The JAX stage on the same proposals writes the same file names and
    keys."""
    ClusterTracking(config_from_jax(_tracking_cfg(tmp_path / "t")), device="cpu")(dict(proposed))
    jct.ClusterTracking(JEDict(_tracking_cfg(tmp_path / "j")))(dict(proposed))
    tdir, jdir = tmp_path / "t" / "trk" / "segment-9", tmp_path / "j" / "trk" / "segment-9"
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    for n in names:
        with open(tdir / n, "rb") as f:
            t = pickle.load(f)
        with open(jdir / n, "rb") as f:
            j = pickle.load(f)
        assert sorted(t) == sorted(j), n
        for k in j:
            assert np.asarray(t[k]).dtype.kind == np.asarray(j[k]).dtype.kind, (n, k)
            assert np.asarray(t[k]).ndim == np.asarray(j[k]).ndim, (n, k)
