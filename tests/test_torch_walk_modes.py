"""ClusterTracking end to end in the walk modes beside the batched one: the
host walk, the device ("stepped") walk and the host walk with the GD
registration solver, against the JAX package on the Pallas claim path
(the jax_pallas_path fixture of tests/test_torch_pipeline.py), both fed the
same proposals; and the walk-mode dispatch's budget rule.

Tolerance: the tracked box stats within 0.01, as the batched slice test of
tests/test_torch_pipeline.py (one box of this scene is ~0.008 of the mean,
and the walks' Adam smoothing and loss-countdown stops differ in float
rounding); the walk each tracked frame took must be the JAX package's.
"""

import copy

import pytest
import torch

from pcseqlearning_tpu.preprocessing import cluster_tracking as jct
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch import pipeline
from pcseqlearning_tpu_torch.convert import config_from_jax
from pcseqlearning_tpu_torch.preprocessing import cluster_tracking as tct
from pcseqlearning_tpu_torch.scene import scene_dict
from test_torch_pipeline import jax_pallas_path  # noqa: F401 (a fixture)

# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)
# the JAX package's import-time defaults, written into the port's config
JAX_ENV = {"PCSEQ_FINE_CANDIDATES": "256", "PCSEQ_ANGLE_VELO_EXEMPT": "0.05",
           "PCSEQ_CELL_CAP": "48"}


@pytest.fixture(scope="module")
def proposed():
    """A 5-frame scene (tracked frames 0 and 4) through the port's ground
    removal and proposal."""
    ground, proposal, _ = pipeline.build_stages(pipeline.PARITY, device="cpu")
    return proposal(ground(scene_dict(5, 1500)))


@pytest.mark.parametrize("mode", ["host", "stepped", "GD"])
def test_cluster_tracking_matches_jax(jax_pallas_path, proposed, mode):
    cfg = copy.deepcopy(pipeline.PARITY["tracking"])
    cfg["WALK_MODE"] = "host" if mode == "GD" else mode
    if mode == "GD":
        cfg["REGISTRATION"]["SOLVER"] = "GD"
    tr = tct.ClusterTracking(config_from_jax(cfg, env=JAX_ENV), device="cpu")
    st = pipeline.parity_stats(tr(dict(proposed)))
    walk = "device" if mode == "stepped" else "host"
    assert tr.walk_frames == dict({"host": 0, "device": 0, "batched": 0}, **{walk: 2})
    jt = jct.ClusterTracking(JEDict(cfg))
    calls = []
    for name in ("track_frame_host", "track_frame_device"):
        fn = getattr(jt, name)
        setattr(jt, name, lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    sj = pipeline.parity_stats(jt(dict(proposed)))
    assert calls == [f"track_frame_{walk}"] * 2
    for k in ("tracking_coverage_0.7", "box_miou", "moving_box_miou"):
        assert st[k] == pytest.approx(sj[k], abs=0.01), k


def test_budget_rule_sends_large_frames_to_the_host_walk(proposed):
    cfg = dict(pipeline.PARITY["tracking"], WALK_MODE="device", STEP_COMPILE_BUDGET=1)
    tr = tct.ClusterTracking(config_from_jax(cfg), device="cpu")
    tr.track_frame_host = lambda *a: None  # count the dispatch only
    tr(dict(proposed))
    assert tr.walk_frames == {"host": 2, "device": 0, "batched": 0}
    cfg = dict(pipeline.PARITY["tracking"], WALK_MODE="batched", DEVICE_WALK=False)
    tr = tct.ClusterTracking(config_from_jax(cfg), device="cpu")
    tr.track_frame_host = lambda *a: None
    tr(dict(proposed))
    assert tr.walk_frames == {"host": 2, "device": 0, "batched": 0}
