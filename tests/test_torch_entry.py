"""The port's entry point, ``python -m pcseqlearning_tpu_torch.train``, on a
sequence written in the Waymo layout, and the slice as a whole against the
JAX package's ``build_dataloader`` and ``SimpleReg``.

The CLI runs the README's three YAML files unchanged, shrunk through
``--set`` only (one component key, a shorter ground solve, a tracking
interval that fits the tiny sequence). The whole-slice comparison feeds one
written sequence to both packages with the same composed config: the
proposal on the JAX package's CPU path (kNN-graph CC; the port with
``CC_GRAPH="knn"``), the tracking on the path the port implements (the
Pallas k-NN claims in interpret mode, ``pair_min`` by direct differences).
Tolerances are those of tests/test_torch_pipeline.py: proposal stats and
component counts equal, ground stats +-0.005, tracked box stats +-0.01.
"""

import copy
import functools
import os
import pickle
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pcseqlearning_tpu import config as jconfig
from pcseqlearning_tpu.datasets import build_dataloader as j_build
from pcseqlearning_tpu.models import build_network as j_build_network
from pcseqlearning_tpu.ops import pallas_scan, pallas_tpu
from pcseqlearning_tpu.preprocessing import cluster_proposal as jcp
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch import pipeline, train
from pcseqlearning_tpu_torch.scene import make_scene, write_waymo_sequence

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
README = [str(REPO / "tools" / "cfgs" / p) for p in (
    "waymo_models/registration/cluster_tracking_TLS_multiradius_every8.yaml",
    "dataset_configs/waymo/registration/all_sequence.yaml",
    "optimizers/registration.yaml")]
OUT = Path("output/waymo_sequence_registration")
SHRINK = ["MODEL.PREPROCESSORS.0.MAX_NUM_ITERS", "300",
          "MODEL.PREPROCESSORS.1.COMPONENT_KEYS", "['component_rad1x25']",
          "MODEL.PREPROCESSORS.1.GRAPH.RADIUS", "[1.25]",
          "MODEL.PREPROCESSORS.2.COMPONENT_KEYS", "['component_rad1x25']",
          "MODEL.PREPROCESSORS.2.TRACKING_PARAMS.TRACK_INTERVAL", "4",
          "MODEL.PREPROCESSORS.2.TRACKING_PARAMS.MIN_MOVE_FRAME", "3"]


def _write(root, frames, points, name="segment-3"):
    seq, gt = make_scene(num_frames=frames, points_per_frame=points, seed=1)
    write_waymo_sequence(root / "data", seq, gt, name)


def test_cli_runs_the_readme_configs_and_skips_a_finished_sequence(tmp_path):
    _write(tmp_path, 4, 800)
    cmd = [sys.executable, "-m", "pcseqlearning_tpu_torch.train", *README, "--device", "cpu",
           "--set", "DATA_CONFIG.DATA_PATH", "data", "ROOT_DIR", str(tmp_path),
           "MODEL.PREPROCESSORS.2.FINE_CANDIDATES", "64", *SHRINK]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    runs = [subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                           timeout=600) for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    first, second = runs[0].stdout, runs[1].stdout
    assert "Working on segment-3_003" in first and "All Box mIoU=" in first
    assert "Skipping segment-3_003" in second and "Cluster Proposal" not in second
    out = tmp_path / OUT
    assert (out / "ground_removal/TLS/height/segment-3/pillar_height.npz").is_file()
    assert (out / "ground_removal/TLS/log/height0.5/segment-3.txt").is_file()
    assert (out / "cluster_proposal/TLS_multiradius").is_dir()
    trk = out / "cluster_tracking/TLS_multiradius_every8"
    assert sorted(p.name for p in (trk / "segment-3").iterdir()) == [
        "000_component_rad1x25.pkl", "all.pkl"]
    logs = list((tmp_path / "output").rglob("log_train_*.txt"))
    assert len(logs) == 2 and "cfg.MODEL.NAME: SimpleReg" in logs[0].read_text()
    with open(trk / "segment-3" / "all.pkl", "rb") as f:
        boxes = pickle.load(f)
    res = subprocess.run([sys.executable, str(REPO / "tools" / "parse_cluster_tracking_results.py"),
                          str(trk)], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"segment-3: boxes={len(boxes['best_iou'])}" in res.stdout


def test_cli_needs_a_card_unless_cpu_and_refuses_detectors(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train.parse_config(README)[0].device == "cuda"  # the default
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(README + ["--set", "ROOT_DIR", str(tmp_path)])
    args, cfg = train.parse_config(README + ["--set", "MODEL.PREPROCESSORS.1.CC_GRAPH", "knn"])
    assert cfg.MODEL.PREPROCESSORS[1].CC_GRAPH == "knn"  # the port's keys are settable
    assert cfg.TAG == "cluster_tracking_TLS_multiradius_every8"
    assert cfg.EXP_GROUP_PATH.endswith("tools/cfgs/waymo_models/registration")
    detector = [str(REPO / "tools/cfgs/waymo_models/centerpoint.yaml"),
                str(REPO / "tools/cfgs/dataset_configs/waymo/detection_1sweep.yaml"),
                str(REPO / "tools/cfgs/optimizers/onecycle_centerpoint.yaml"),
                "--set", "ROOT_DIR", str(tmp_path)]
    with pytest.raises(RuntimeError, match="cuda"):  # the detector CLI needs a card too
        train.main(detector)
    # a module neither package has is refused by build_network, as in JAX
    with pytest.raises(KeyError, match="NoSuchVFE"):
        train.main(detector[:3] + ["--device", "cpu"] + detector[3:]
                   + ["MODEL.VFE.NAME", "NoSuchVFE"])


def _direct_pair_min(a, b, a_mask, b_mask):
    import jax.numpy as jnp

    d = a[:, :, None, :] - b[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    f = jnp.where(b_mask[:, None, :], d2, jnp.inf)
    w = jnp.where(a_mask[:, :, None], d2, jnp.inf)
    return f.min(2), f.argmin(2).astype(jnp.int32), w.min(1), w.argmin(1).astype(jnp.int32)


@pytest.fixture
def jax_knn_proposal_pallas_tracking(monkeypatch):
    """The JAX package with its proposal on the CPU (kNN CC) path and its
    tracking on the Pallas claims path in interpret mode."""
    monkeypatch.setattr(jcp, "pallas_scan", types.SimpleNamespace(use_pallas_scan=lambda: False))
    monkeypatch.setattr(pallas_scan, "use_pallas_scan", lambda: True)
    monkeypatch.setattr(pallas_scan, "radius_neighbors_sorted",
                        functools.partial(pallas_scan.radius_neighbors_sorted, interpret=True))
    monkeypatch.setattr(pallas_tpu, "pair_min", _direct_pair_min)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _ground_stats(d):
    """The golden table's two ground stats, as ``pipeline.parity_stats``
    computes them (it needs a tracked sequence)."""
    removed = np.asarray(d["full_point_height"]).reshape(-1) <= 0.5
    is_ground = np.asarray(d["full_point_fxyz"])[:, 3] < 0.3
    return {"ground_coverage": float((removed & is_ground).sum() / max(is_ground.sum(), 1)),
            "foreground_precision": float((~removed & ~is_ground).sum() / max((~removed).sum(), 1))}


def test_slice_matches_jax(tmp_path, monkeypatch, jax_knn_proposal_pallas_tracking):
    """The ground solve is an Adam loop on sign gradients, so the two
    packages' removal masks differ on a few points (2 of 11,966 here), which
    moves the component count: the port's own solve is held to the ground
    tolerance, and the rest of the slice runs from the JAX package's height
    field, which the port reads from the JAX-written DIR file (the warm
    start), so that the proposal can be held to equality."""
    _write(tmp_path, 6, 2000)
    overrides = ["DATA_CONFIG.DATA_PATH", str(tmp_path / "data"), *SHRINK]
    args, cfg = train.parse_config(README + ["--set", *overrides,
                                             "MODEL.PREPROCESSORS.1.CC_GRAPH", "knn"])
    jcfg = JEDict(ROOT_DIR="r")
    for p in README:
        jconfig.cfg_from_yaml_file(p, jcfg)
    jconfig.cfg_from_list(list(overrides), jcfg)
    for c in (cfg, jcfg):  # small tracking tiles (keys both packages read): a short CPU run
        c.MODEL.PREPROCESSORS[2].update(TRACK_POINTS_PER_COMPONENT=64, TRACK_EXTRACT_POINTS=128,
                                        TRACK_NUM_CANDIDATES=128, MAX_ICP_ITER=20)
    height_dir = Path(cfg.MODEL.PREPROCESSORS[0].DIR)

    def run(name, build, model, c):
        (tmp_path / name).mkdir(exist_ok=True)
        monkeypatch.chdir(tmp_path / name)  # the stages' DIRs are relative
        _, loader = build(c.DATA_CONFIG, c.CLASS_NAMES, 1, training=True)
        batch = next(iter(loader))
        model(batch)
        return batch["seq_0"]

    dj = run("jax", j_build, j_build_network(jcfg.MODEL), jcfg)
    cold = copy.deepcopy(cfg.MODEL)
    cold.PREPROCESSORS = [dict(cold.PREPROCESSORS[0])]
    del cold.PREPROCESSORS[0]["DIR"]
    dc = run("port_cold", train.build_dataloader, train.build_network(cold, device="cpu"), cfg)
    for k, v in _ground_stats(dj).items():
        assert _ground_stats(dc)[k] == pytest.approx(v, abs=0.005), k
        assert v == pipeline.parity_stats(dj)[k]
    shutil.copytree(tmp_path / "jax" / height_dir, tmp_path / "port" / height_dir)
    dt = run("port", train.build_dataloader, train.build_network(cfg.MODEL, device="cpu"), cfg)
    sj, st = pipeline.parity_stats(dj), pipeline.parity_stats(dt)
    assert st["num_components"] == sj["num_components"]
    for k in ("proposal_miou", "trace_miou"):
        assert st[k] == pytest.approx(sj[k], abs=1e-6), k
    for k in ("ground_coverage", "foreground_precision"):
        assert st[k] == pytest.approx(sj[k], abs=0.005), k
    for k in ("tracking_coverage_0.7", "box_miou", "moving_box_miou"):
        assert st[k] == pytest.approx(sj[k], abs=0.01), k
    assert st["box_miou"] > 0.1  # the walk tracked something


def test_cli_refuses_detector_training_before_building(tmp_path):
    """The detector-training command with a module that neither package has
    (centerpoint.yaml with VFE.NAME NoSuchVFE) exits with the KeyError that
    JAX's build_network raises, naming it, before the model or a checkpoint
    is built: no checkpoint directory is written."""
    res = subprocess.run(
        [sys.executable, "-m", "pcseqlearning_tpu_torch.train",
         "tools/cfgs/waymo_models/centerpoint.yaml",
         "tools/cfgs/dataset_configs/waymo/detection_1sweep.yaml",
         "tools/cfgs/optimizers/adamW_onecycle.yaml", "--device", "cpu",
         "--set", "ROOT_DIR", str(tmp_path), "DATA_CONFIG.DATA_PATH", str(tmp_path / "none"),
         "MODEL.VFE.NAME", "NoSuchVFE"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    last = res.stderr.strip().splitlines()[-1]
    assert last.startswith("KeyError") and "NoSuchVFE" in last, res.stderr
    assert not list(tmp_path.rglob("ckpt")) and not list(tmp_path.rglob("checkpoint_epoch_*"))
