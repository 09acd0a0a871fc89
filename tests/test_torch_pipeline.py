"""The whole slice: the port's three stages against the JAX pipeline on a
tiny scene, the no-hidden-CPU rule of the entry points, the package's
import isolation from JAX, the config conversion, and chip_smoke.py's
refusal to run without a card.

The JAX pipeline runs on the path the port implements (Pallas CC and k-NN
scan kernels in interpret mode, pair_min by direct differences) with both
sides pinned through ``config_from_jax``. Tolerances: proposal stats and
component counts must be equal; tracked box stats +-0.01 (one box of the
tiny scene is ~0.005 of its mean, and the walk's Adam smoothing differs in
float rounding); ground stats +-0.005 (the GOLDEN tolerance).
"""

import copy
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import pallas_scan, pallas_tpu
from pcseqlearning_tpu.preprocessing.cluster_proposal import ClusterProposal as JProposal
from pcseqlearning_tpu.preprocessing.cluster_tracking import ClusterTracking as JTracking
from pcseqlearning_tpu.preprocessing.ground_removal import GroundPlaneRemover as JGround
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch import pipeline
from pcseqlearning_tpu_torch.convert import config_from_jax
from pcseqlearning_tpu_torch.scene import scene_dict

REPO = Path(__file__).resolve().parent.parent
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)


def _direct_pair_min(a, b, a_mask, b_mask):
    d = a[:, :, None, :] - b[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    f = jnp.where(b_mask[:, None, :], d2, jnp.inf)
    w = jnp.where(a_mask[:, :, None], d2, jnp.inf)
    return f.min(2), f.argmin(2).astype(jnp.int32), w.min(1), w.argmin(1).astype(jnp.int32)


@pytest.fixture
def jax_pallas_path(monkeypatch):
    finish = pallas_scan.cc_finish
    monkeypatch.setattr(pallas_scan, "use_pallas_scan", lambda: True)
    monkeypatch.setattr(pallas_scan, "cc_finish",
                        lambda *a, **k: finish(*a, interpret=True, **k))
    monkeypatch.setattr(pallas_scan, "radius_neighbors_sorted",
                        functools.partial(pallas_scan.radius_neighbors_sorted, interpret=True))
    monkeypatch.setattr(pallas_tpu, "pair_min", _direct_pair_min)
    jax.clear_caches()  # drop programs traced on the default CPU path
    yield
    jax.clear_caches()


def test_slice_matches_jax_pipeline(jax_pallas_path):
    cfgs = copy.deepcopy(pipeline.PARITY)
    # small tiles keep the CPU run short; both packages read these keys
    cfgs["tracking"].update(TRACK_POINTS_PER_COMPONENT=64, TRACK_EXTRACT_POINTS=128,
                            TRACK_NUM_CANDIDATES=128)
    env = {"PCSEQ_FINE_CANDIDATES": "256", "PCSEQ_ANGLE_VELO_EXEMPT": "0.05"}  # JAX defaults
    d = scene_dict(6, 4000)
    dj = dict(d)
    for stage in (JGround(JEDict(cfgs["ground"])), JProposal(JEDict(cfgs["proposal"])),
                  JTracking(JEDict(cfgs["tracking"]))):
        dj = stage(dj)
    sj = pipeline.parity_stats(dj)
    stages = [cls(config_from_jax(cfgs[k], env=env), device="cpu") for k, cls in (
        ("ground", pipeline.GroundPlaneRemover), ("proposal", pipeline.ClusterProposal),
        ("tracking", pipeline.ClusterTracking))]
    dt, _ = pipeline.run(dict(d), stages)
    st = pipeline.parity_stats(dt)
    assert st["num_components"] == sj["num_components"]
    for k in ("proposal_miou", "trace_miou"):
        assert st[k] == pytest.approx(sj[k], abs=1e-6), k
    for k in ("ground_coverage", "foreground_precision"):
        assert st[k] == pytest.approx(sj[k], abs=0.005), k
    for k in ("tracking_coverage_0.7", "box_miou", "moving_box_miou"):
        assert st[k] == pytest.approx(sj[k], abs=0.01), k


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    from pcseqlearning_tpu_torch.preprocessing import (PREPROCESSORS, ClusterProposal,
                                                       ClusterTracking, GroundPlaneRemover,
                                                       SimpleReg)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = dict(pipeline.BENCH["tracking"], WALK_MODE="host")
    chain = dict(PREPROCESSORS=[dict(pipeline.BENCH[k], NAME=name) for k, name in (
        ("ground", "GroundPlaneRemover"), ("proposal", "ClusterProposal"),
        ("tracking", "ClusterTracking"))])
    for cls, cfg in ((GroundPlaneRemover, pipeline.BENCH["ground"]),
                     (ClusterProposal, pipeline.BENCH["proposal"]),
                     (ClusterTracking, pipeline.BENCH["tracking"]), (ClusterTracking, host),
                     (SimpleReg, chain)):
        cfg = config_from_jax(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            cls(cfg)  # the default device is the card
        assert cls(cfg, device="cpu").device.type == "cpu"
    reg = SimpleReg(chain, device="cpu")  # hands its device to every stage
    assert [type(m) for m in reg.preprocessors] == [PREPROCESSORS[n] for n in (
        "GroundPlaneRemover", "ClusterProposal", "ClusterTracking")]
    assert all(m.device.type == "cpu" for m in reg.preprocessors)
    with pytest.raises(ValueError):
        GroundPlaneRemover(pipeline.BENCH["ground"], device="meta")


def test_import_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import pcseqlearning_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pcseqlearning_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pcseqlearning_tpu' or m.startswith('pcseqlearning_tpu.')\n"
        "       or m == 'yaml']\n"
        "new = ['config', 'train', 'datasets.waymo_dataset', 'datasets.processor',\n"
        "       'models', 'ops.connected_components', 'utils.yaml_subset', 'utils.common_utils',\n"
        "       'ops.sparse_conv', 'models.layers', 'models.vfe', 'models.backbones_3d',\n"
        "       'models.backbones_2d', 'models.dense_heads', 'models.detectors',\n"
        "       'utils.loss_utils', 'parallel.train_step', 'tools.determinism_cost',\n"
        "       'tools.profile_detector_step']\n"
        "missing = [n for n in new if 'pcseqlearning_tpu_torch.' + n not in sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith('pcseqlearning_tpu_torch')]))\n"
        "assert not bad and not missing, (bad, missing)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50  # every module of the port was imported


def test_config_from_jax_carries_the_environment_defaults():
    trk = pipeline.BENCH["tracking"]
    assert config_from_jax(trk, env={}).ANGLE_VELO_EXEMPT == 0.05
    assert config_from_jax(trk, env={}).FINE_CANDIDATES == 256
    assert config_from_jax(trk, env={}).CELL_CAP == 48  # hash_graph.DEFAULT_CELL_CAP
    c = config_from_jax(trk, env={"PCSEQ_ANGLE_VELO_EXEMPT": "0.01",
                                  "PCSEQ_FINE_CANDIDATES": "128", "PCSEQ_CELL_CAP": "96"})
    assert (c.ANGLE_VELO_EXEMPT, c.FINE_CANDIDATES, c.CELL_CAP) == (0.01, 128, 96)
    assert "ANGLE_VELO_EXEMPT" not in config_from_jax(pipeline.BENCH["ground"], env={})
    assert "CELL_CAP" not in config_from_jax(pipeline.BENCH["proposal"], env={})
    explicit = dict(trk, FINE_CANDIDATES=64, CELL_CAP=24)
    c = config_from_jax(explicit, env={"PCSEQ_FINE_CANDIDATES": "128", "PCSEQ_CELL_CAP": "96"})
    assert (c.FINE_CANDIDATES, c.CELL_CAP) == (64, 24)
    from pcseqlearning_tpu.ops import hash_graph as jhg

    # under this process's environment, the JAX package's own cap
    assert config_from_jax(trk).CELL_CAP == jhg.DEFAULT_CELL_CAP


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:  # a directory holding chip_smoke.py and nothing else
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
