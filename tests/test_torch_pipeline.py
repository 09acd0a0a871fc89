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
    from pcseqlearning_tpu_torch.preprocessing import (ClusterProposal, ClusterTracking,
                                                       GroundPlaneRemover)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, key in ((GroundPlaneRemover, "ground"), (ClusterProposal, "proposal"),
                     (ClusterTracking, "tracking")):
        cfg = config_from_jax(pipeline.BENCH[key])
        with pytest.raises(RuntimeError, match="cuda"):
            cls(cfg)  # the default device is the card
        assert cls(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        GroundPlaneRemover(pipeline.BENCH["ground"], device="meta")


def test_import_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import pcseqlearning_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pcseqlearning_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pcseqlearning_tpu' or m.startswith('pcseqlearning_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('pcseqlearning_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module of the slice was imported


def test_config_from_jax_carries_the_environment_defaults():
    trk = pipeline.BENCH["tracking"]
    assert config_from_jax(trk, env={}).ANGLE_VELO_EXEMPT == 0.05
    assert config_from_jax(trk, env={}).FINE_CANDIDATES == 256
    c = config_from_jax(trk, env={"PCSEQ_ANGLE_VELO_EXEMPT": "0.01",
                                  "PCSEQ_FINE_CANDIDATES": "128"})
    assert (c.ANGLE_VELO_EXEMPT, c.FINE_CANDIDATES) == (0.01, 128)
    assert "ANGLE_VELO_EXEMPT" not in config_from_jax(pipeline.BENCH["ground"], env={})
    explicit = dict(trk, FINE_CANDIDATES=64)
    assert config_from_jax(explicit, env={"PCSEQ_FINE_CANDIDATES": "128"}).FINE_CANDIDATES == 64


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
