"""The model zoo's ops against the JAX package's: ``VoxelAggregation``,
``primitive_fitting`` (its iteration count, weights, fits), ``voxel_graph``,
``weighted_segment_mean`` and the widened ``grid_utils`` (``voxel_coords``
with an origin, ``grid_sample_mean`` with extras and a cap), on seeded
NumPy inputs.

Tolerances: integer outputs (inverse maps, edges, masks, medians, the
iteration count) exactly; float32 values 1e-5; primitive_fitting's normals
up to JAX's own sign convention (|n . n_jax| > 1 - 1e-5) on voxels whose two
smallest eigenvalues are apart, and its weights 1e-5. Budget: ~15 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import grid_utils as jgu
from pcseqlearning_tpu.ops import primitives as jprim
from pcseqlearning_tpu.ops import segment_ops as jseg
from pcseqlearning_tpu.ops.voxel_modules import VoxelAggregation as JVoxelAggregation
from pcseqlearning_tpu_torch.ops import grid_utils as tgu
from pcseqlearning_tpu_torch.ops import primitives as tprim
from pcseqlearning_tpu_torch.ops import segment_ops as tseg
from pcseqlearning_tpu_torch.ops.voxel_modules import VoxelAggregation as TVoxelAggregation

torch.set_num_threads(1)
T = torch.as_tensor


def _cloud(seed=0, n=400):
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:4] = rng.rand(n, 3).astype(np.float32) * np.array([3, 3, 1], np.float32)
    return pts, rng


def test_weighted_segment_mean_equals_jax(rng):
    data = rng.randn(50, 3).astype(np.float32)
    w = rng.rand(50).astype(np.float32)
    ids = rng.randint(0, 8, 50)
    ids[:3] = 9  # past num_segments: dropped
    want = np.asarray(jseg.weighted_segment_mean(jnp.asarray(data), jnp.asarray(w),
                                                 jnp.asarray(ids), 8))
    got = tseg.weighted_segment_mean(T(data), T(w), T(ids), 8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_voxel_coords_and_grid_sample_mean_options_equal_jax():
    pts, rng = _cloud()
    origin = np.array([-0.5, -0.25, -1.0], np.float32)
    want = np.asarray(jgu.voxel_coords(jnp.asarray(pts), [0.3, 0.3, 0.2],
                                       origin=jnp.asarray(origin), batch_size_hint=2))
    got = tgu.voxel_coords(T(pts), [0.3, 0.3, 0.2], origin=T(origin), batch_size_hint=2)
    np.testing.assert_array_equal(got.numpy(), want)
    extra = {"intensity": rng.rand(400).astype(np.float32),
             "label": rng.randint(0, 5, 400).astype(np.int32)}
    jout = jgu.grid_sample_mean(jnp.asarray(pts), [0.5, 0.5, 0.5],
                                extra={k: jnp.asarray(v) for k, v in extra.items()},
                                num_voxels_cap=300)
    tout = tgu.grid_sample_mean(T(pts), [0.5, 0.5, 0.5], extra={k: T(v) for k, v in extra.items()},
                                num_voxels_cap=300)
    for k in ("valid", "inverse"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    for k in ("bxyz", "intensity", "label"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-5, err_msg=k)
    assert tout["num_voxels"] == int(jout["num_voxels"]) and tout["bxyz"].shape == (300, 4)


@pytest.mark.parametrize("cap", [None, 64])
def test_voxel_aggregation_equals_jax(cap):
    """Means of float features and medians of integer labels per voxel;
    with a cap of 64 (fewer than the occupied voxels) the voxels past it
    are dropped, as in JAX."""
    pts, rng = _cloud(1)
    valid = rng.rand(400) > 0.1
    feats = {"feat": rng.rand(400, 2).astype(np.float32), "w": rng.rand(400).astype(np.float32),
             "seg": rng.randint(0, 6, 400).astype(np.int32)}
    jout = JVoxelAggregation([0.4, 0.4, 0.4], cap)(
        jnp.asarray(pts), {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(valid))
    tout = TVoxelAggregation([0.4, 0.4, 0.4], cap)(T(pts), {k: T(v) for k, v in feats.items()},
                                                   T(valid))
    assert set(tout) == set(jout)
    for k in ("valid", "inverse", "seg"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    for k in ("bxyz", "feat", "w"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-5, err_msg=k)


def _planes(seed=0):
    """Six voxels' worth of noisy planes with outliers, a voxel of three
    collinear points and padding."""
    rng = np.random.RandomState(seed)
    rows = []
    for v in range(6):
        n = 40
        uv = rng.rand(n, 2) * 0.45
        tilt = rng.randn(2) * 0.3
        z = uv @ tilt + rng.randn(n) * 0.01
        z[:4] += rng.rand(4) * 0.3  # outliers
        xyz = np.stack([uv[:, 0] + 0.5 * (v % 3), uv[:, 1] + 0.5 * (v // 3), z + 0.05], 1)
        rows.append(np.concatenate([np.full((n, 1), v % 2), xyz], 1))
    rows.append(np.array([[0, 1.6, 0.1, 0.1], [0, 1.7, 0.1, 0.1], [0, 1.8, 0.1, 0.1]]))
    pts = np.concatenate(rows).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[-10:-5] = False
    return pts, valid


@pytest.mark.parametrize("num_iters", [10, 2])
def test_primitive_fitting_equals_jax(num_iters):
    """The IRLS plane fits: the port's iteration count is JAX's (found as
    the fewest iterations whose JAX result equals the full run's), the
    weights and fits equal, the normals up to sign."""
    pts, valid = _planes()
    vs, P = [0.5, 0.5, 0.5], 32
    full = jprim.primitive_fitting(jnp.asarray(pts), jnp.asarray(valid), vs, P,
                                   num_iters=num_iters)
    ran = next(k for k in range(1, num_iters + 1) if np.array_equal(
        np.asarray(jprim.primitive_fitting(jnp.asarray(pts), jnp.asarray(valid), vs, P,
                                           num_iters=k)["point_weight"]),
        np.asarray(full["point_weight"])))
    out = tprim.primitive_fitting(T(pts), T(valid), vs, P, num_iters=num_iters)
    assert int(out["num_iters_run"]) == ran and 1 < ran
    for k in ("inverse", "valid"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(full[k]), err_msg=k)
    for k in ("point_weight", "centers", "eigvals", "weight_sum", "point_error"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(full[k]), atol=1e-5, err_msg=k)
    vals = np.asarray(full["eigvals"])
    apart = np.asarray(full["valid"]) & (vals[:, 1] - vals[:, 0] > 1e-4)
    assert apart.sum() >= 6
    dots = np.abs((out["normals"].numpy() * np.asarray(full["normals"])).sum(-1))
    assert (dots[apart] > 1 - 1e-5).all()


def test_voxel_graph_equals_jax():
    pts, rng = _cloud(2, 300)
    valid = rng.rand(300) > 0.1
    coords = np.array(jgu.voxel_coords(jnp.asarray(pts), [0.5, 0.5, 0.5]))
    for k in (1, 2):
        want = [np.asarray(x) for x in jprim.voxel_graph(jnp.asarray(coords), jnp.asarray(valid),
                                                         kernel_offset=k)]
        got = [x.numpy() for x in tprim.voxel_graph(T(coords), T(valid), kernel_offset=k)]
        for g, w, name in zip(got, want, ("e_src", "e_dst", "mask")):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} k={k}")
        assert got[2].sum() > 0 and got[0].shape[0] == 300 * ((2 * k + 1) ** 3 - 1)


def _knn_one_pass(ref_xyz, query_xyz, k, ref_valid, ref_batch, query_batch):
    """knn_bruteforce as it was before chunking: every row at once, the
    candidates by a stable sort of whole rows."""
    from pcseqlearning_tpu_torch.ops.sampling import top_k

    other = query_batch[:, None] != ref_batch[None, :]
    d2 = ((query_xyz * query_xyz).sum(-1)[:, None] + (ref_xyz * ref_xyz).sum(-1)[None, :]
          - 2.0 * (query_xyz[:, None, :] * ref_xyz[None, :, :]).sum(-1))
    inf = torch.tensor(float("inf"))
    d2 = torch.where(other | ~ref_valid[None, :], inf, d2)
    cand = top_k(-d2, min(ref_xyz.shape[0], 2 * k + 8))[1]
    diff = ref_xyz[cand] - query_xyz[:, None, :]
    bad = torch.gather(other, 1, cand) | ~ref_valid[cand]
    neg, pos = top_k(torch.where(bad, inf, (diff * diff).sum(-1)).neg(), k)
    return torch.gather(cand, 1, pos), -neg


@pytest.mark.parametrize("block", [1, 300, 5000, 1 << 25])
def test_knn_bruteforce_in_chunks_equals_one_pass(block):
    """Queries in chunks of block / N rows, candidates by one topk over
    unique keys: the same indices and distances as one pass with a stable
    sort, on a lattice (many equal distances), two samples and references
    that are not valid; and JAX's indices."""
    from pcseqlearning_tpu.ops import sampling as jsm
    from pcseqlearning_tpu_torch.ops import sampling as tsm

    rng = np.random.RandomState(4)
    ref = rng.randint(0, 4, (150, 3)).astype(np.float32) * 0.5
    qry = rng.randint(0, 4, (90, 3)).astype(np.float32) * 0.5 + 0.25 * (rng.rand(90, 1) > 0.5)
    rb, qb = rng.randint(0, 2, 150), rng.randint(0, 2, 90)
    rv = rng.rand(150) > 0.1
    args = (T(ref), T(qry), 7, T(rv), T(rb), T(qb))
    want = _knn_one_pass(*args)
    got = tsm.knn_bruteforce(*args, block=block)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    ji, jd = jsm.knn_bruteforce(jnp.asarray(ref), jnp.asarray(qry), 7, ref_valid=jnp.asarray(rv),
                                ref_batch=jnp.asarray(rb), query_batch=jnp.asarray(qb))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ji))
