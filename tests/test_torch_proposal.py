"""Cluster proposal: the port against the JAX ClusterProposal on its Pallas
path (the radius-CC kernel in interpret mode), and the per-frame proposal
scoring against ``_evaluate_frame``.

Partitions must be equal up to relabelling (both compute the exact
same-frame radius-graph components); the IoU scores come from integer
point counts, so they are compared at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import pallas_scan
from pcseqlearning_tpu.preprocessing import cluster_proposal as jcp
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.pipeline import BENCH
from pcseqlearning_tpu_torch.preprocessing import cluster_proposal as tcp
from pcseqlearning_tpu_torch.scene import scene_dict

T = torch.as_tensor
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)


def _same_partition(a, b):
    m1, m2 = {}, {}
    return all(m1.setdefault(x, y) == y and m2.setdefault(y, x) == x for x, y in zip(a, b))


@pytest.fixture
def jax_pallas_cc(monkeypatch):
    finish = pallas_scan.cc_finish
    monkeypatch.setattr(pallas_scan, "use_pallas_scan", lambda: True)
    monkeypatch.setattr(pallas_scan, "cc_finish",
                        lambda *a, **k: finish(*a, interpret=True, **k))


def _above_ground_scene():
    d = scene_dict(3, 2500, seed=3)
    keep = d["point_fxyz"][:, 3] > 0.3
    for k in ("point_fxyz", "point_sweep", "point_feat"):
        d[k] = d[k][keep]
    return d


def test_proposal_matches_jax_pallas_path(jax_pallas_cc):
    cfg = dict(BENCH["proposal"], CHUNK_FRAMES=2)  # two chunks per radius
    dj = jcp.ClusterProposal(JEDict(cfg))(_above_ground_scene())
    dt = tcp.ClusterProposal(cfg, device="cpu")(_above_ground_scene())
    for key in cfg["COMPONENT_KEYS"]:
        a, b = dt[f"point_{key}"], np.asarray(dj[f"point_{key}"])
        assert a.max() == b.max()
        assert _same_partition(a, b)
        np.testing.assert_allclose(dt[f"best_iou_after_{key}"],
                                   np.asarray(dj[f"best_iou_after_{key}"]), atol=1e-6)
    for key in ("gt_box_best_iou", "gt_trace_best_iou"):
        np.testing.assert_allclose(dt[key], np.asarray(dj[key]), atol=1e-6)
    for key in ("point_gt_box_id", "point_pred_box_id", "point_gt_trace_id",
                "point_pred_trace_id"):
        np.testing.assert_array_equal(dt[key], np.asarray(dj[key]))


def test_evaluate_frames_matches_jax_evaluate_frame():
    rng = np.random.RandomState(0)
    F, N, B, c_cap = 3, 300, 8, 32
    xyz = (rng.rand(F, N, 3) * 10 - 5).astype(np.float32)
    pvalid = rng.rand(F, N) > 0.1
    comp = rng.randint(-1, 20, (F, N)).astype(np.int32)
    boxes = np.concatenate([rng.rand(F, B, 3) * 8 - 4, rng.rand(F, B, 3) * 3 + 1,
                            rng.rand(F, B, 1) * 3], -1).astype(np.float32)
    bvalid = rng.rand(F, B) > 0.2
    got = [x.numpy() for x in tcp.evaluate_frames(T(xyz), T(pvalid), T(comp), T(boxes),
                                                  T(bvalid), c_cap)]
    want = [np.asarray(x) for x in jax.vmap(
        lambda p, v, c, b, bv: jcp._evaluate_frame(p, v, c, b, bv, c_cap=c_cap))(
        jnp.asarray(xyz), jnp.asarray(pvalid), jnp.asarray(comp), jnp.asarray(boxes),
        jnp.asarray(bvalid))]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_proposal_reports_no_truncation_and_rejects_unported_keys():
    from pcseqlearning_tpu_torch.utils import telemetry

    telemetry.reset()
    tcp.ClusterProposal(BENCH["proposal"], device="cpu").propose_cluster(_above_ground_scene())
    assert telemetry.snapshot()["proposal_scan_windows_truncated"] == 0
    with pytest.raises(ValueError):
        tcp.ClusterProposal(dict(BENCH["proposal"], CC_GRAPH="pallas"), device="cpu")
    # NUM_SHARDS is ported: the x-sharded CC, its halo truncation reported
    telemetry.reset()
    tcp.ClusterProposal(dict(BENCH["proposal"], NUM_SHARDS=2), device="cpu").propose_cluster(
        _above_ground_scene())
    assert telemetry.snapshot()["proposal_halo_truncated"] == 0
