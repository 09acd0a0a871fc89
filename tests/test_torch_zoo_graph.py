"""The model zoo's graph, sampler and volume registries against the JAX
package's, as tests/test_sampler_volume.py and tests/test_registry_apis.py
run them: ``build_graph`` (RadiusGraph, KNNGraph, KNNGraphV2, VoxelGraph,
VolumeGraph), ``build_sampler`` (the five samplers), ``build_volume``
(PCAVolume) and ``connected_components``, on seeded NumPy inputs.

Tolerances: edge lists, masks, indices, sample picks, coords and validity
exactly (neighbour rows compared where the mask holds: padding is -1 in the
port); float32 values (means, centres, edge weights, eigenvalues,
extents) 1e-4 absolute, as tests/test_sampler_volume.py holds them against
its oracles; eigenvectors up to sign. Budget: ~20 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import graph_utils as jgu
from pcseqlearning_tpu.models import sampler_utils as jsu
from pcseqlearning_tpu.models import volume_utils as jvu
from pcseqlearning_tpu_torch.models import graph_utils as tgu
from pcseqlearning_tpu_torch.models import sampler_utils as tsu
from pcseqlearning_tpu_torch.models import volume_utils as tvu

torch.set_num_threads(1)
T = torch.as_tensor


def _pts(rng, n, scale=1.0, frames=1):
    pts = (rng.rand(n, 4) * scale).astype(np.float32)
    pts[:, 0] = rng.randint(0, frames, n)
    return pts


def _edges_equal(got, want, weights_atol=1e-4):
    (tr, tq, tw, tm), (jr, jq, jw, jm) = got, [None if x is None else np.asarray(x) for x in want]
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tr.numpy()[jm], jr[jm])
    np.testing.assert_array_equal(tq.numpy()[jm], jq[jm])
    assert (tw is None) == (jw is None)
    if tw is not None:
        np.testing.assert_allclose(tw.numpy()[jm], jw[jm], atol=weights_atol)


@pytest.mark.parametrize("cfg", [
    {"TYPE": "RadiusGraph", "RADIUS": 0.5, "MAX_NUM_NEIGHBORS": 8, "SORT_BY_DIST": True,
     "RELATIVE_KEY": "fxyz"},
    {"TYPE": "KNNGraph", "NUM_NEIGHBORS": 6},
    {"TYPE": "KNNGraphV2", "NUM_NEIGHBORS": 4},
    {"TYPE": "KNNGraphV2", "NUM_NEIGHBORS": 5},
    {"TYPE": "VoxelGraph", "VOXEL_SIZE": [0.25, 0.25, 0.25], "KERNEL_OFFSET": 1},
], ids=["radius", "knn", "knn_v2_even", "knn_v2_odd", "voxel"])
def test_build_graph_equals_jax(rng, cfg):
    """Two frames of 100 points (RadiusGraph keys on the frame, the kNN
    graphs on the batch); 10 references not valid."""
    key = cfg.get("RELATIVE_KEY", "bxyz")
    pts = _pts(rng, 100, frames=2)
    valid = np.arange(100) % 10 != 3
    want = jgu.build_graph(cfg)({key: jnp.asarray(pts), "valid": jnp.asarray(valid)},
                                {key: jnp.asarray(pts), "valid": jnp.asarray(valid)})
    got = tgu.build_graph(cfg)({key: T(pts), "valid": T(valid)}, {key: T(pts), "valid": T(valid)})
    _edges_equal(got, want)
    assert got[3].sum() > 0


def test_volume_graph_and_pca_volume_equal_jax():
    """tests/test_sampler_volume.py's end-to-end chain: VoxelCenterSampler,
    PCAVolume (stencil 0 and 1), VolumeGraph's weighted edges."""
    rng = np.random.RandomState(2)
    base = np.concatenate([np.zeros((300, 1)), rng.rand(300, 3) * 6.0], axis=1).astype(np.float32)
    vs = [2.0, 2.0, 2.0]
    jout = jsu.VoxelCenterSampler(model_cfg=dict(GRID_SIZE=vs))(jnp.asarray(base))
    tout = tsu.build_sampler(dict(TYPE="VoxelCenterSampler", GRID_SIZE=vs))(T(base))
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    for ko in (0, 1):
        jref = jvu.PCAVolume(model_cfg=dict(VOXEL_SIZE=vs, KERNEL_OFFSET=ko))(
            dict(bxyz=jout[0], bcenter=jout[0], valid=jout[1]), jnp.asarray(base))
        tref = tvu.build_volume(dict(TYPE="PCAVolume", VOXEL_SIZE=vs, KERNEL_OFFSET=ko))(
            dict(bxyz=tout[0], bcenter=tout[0], valid=tout[1]), T(base))
        m = np.asarray(jref["volume_mask"])
        np.testing.assert_array_equal(tref["volume_mask"].numpy(), m)
        for k in ("bxyz", "volume", "eigvals", "l1_proj_min", "l1_proj_max"):
            np.testing.assert_allclose(tref[k].numpy(), np.asarray(jref[k]), atol=1e-4,
                                       err_msg=f"{k} offset {ko}")
        dots = np.abs((tref["eigvecs"].numpy() * np.asarray(jref["eigvecs"])).sum(1))[m]
        np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    g_cfg = dict(VOXEL_SIZE=vs, KERNEL_OFFSET=1, REF_KEY="bxyz")
    want = jgu.VolumeGraph(g_cfg)(jref, jref)
    got = tgu.build_graph(dict(g_cfg, TYPE="VolumeGraph"))(tref, tref)
    _edges_equal(got, want)
    assert got[2] is not None and got[3].sum() > 0


@pytest.mark.parametrize("stride,dst,zp", [([1, 1, 1], [1, 1, 1], 1),
                                           ([2, 2, 2], [2, 2, 2], 0),
                                           ([2, 2, 2], [2, 2, 1], -1)])
def test_volume_sampler_equals_jax(stride, dst, zp):
    rng = np.random.RandomState(0)
    pts = np.concatenate([np.zeros((64, 1)), rng.rand(64, 3) * 4.0], axis=1).astype(np.float32)
    valid = np.arange(64) != 9
    cfg = dict(VOXEL_SIZE=[0.8, 0.8, 0.8], STRIDE=stride, DOWNSAMPLE_TIMES=dst, Z_PADDING=zp)
    want = jsu.VolumeSampler(model_cfg=cfg)(jnp.asarray(pts), jnp.asarray(valid))
    got = tsu.build_sampler(dict(cfg, TYPE="VolumeSampler"))(T(pts), T(valid))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.bcoords.numpy()[v], np.asarray(want.bcoords)[v])
    for k in ("bcenter", "bxyz"):
        np.testing.assert_allclose(got[k].numpy()[v], np.asarray(want[k])[v], atol=1e-4)


@pytest.mark.parametrize("cfg", [{"TYPE": "FPSSampler", "NUM_SAMPLES": 40},
                                 {"TYPE": "GridSampler", "GRID_SIZE": [0.3, 0.3, 0.3]},
                                 {"TYPE": "HybridSampler", "GRID_SIZE": [0.2, 0.2, 0.2],
                                  "NUM_SAMPLES": 30}],
                         ids=["fps", "grid", "hybrid"])
def test_point_samplers_equal_jax(rng, cfg):
    pts = _pts(rng, 200, scale=2.0, frames=2)
    valid = np.arange(200) % 7 != 0
    want = jsu.build_sampler(cfg)(jnp.asarray(pts), jnp.asarray(valid))
    got = tsu.build_sampler(cfg)(T(pts), T(valid))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_connected_components_equals_jax():
    e_src, e_dst = np.array([0, 1, 3, 6, -1]), np.array([1, 2, 4, 6, 2])
    num_j, comp_j = jgu.connected_components(jnp.asarray(e_src), jnp.asarray(e_dst), 8)
    num_t, comp_t = tgu.connected_components(T(e_src), T(e_dst), 8)
    assert int(num_t) == int(num_j) == 5
    np.testing.assert_array_equal(comp_t.numpy(), np.asarray(comp_j))
