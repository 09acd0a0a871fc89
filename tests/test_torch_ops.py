"""The port's tensor ops against the JAX package's, on the same NumPy inputs.

Tolerances: float sums may be taken in another order by the two packages,
so float results are compared at 1e-5 relative (a few float32 ulps of
accumulated rounding); integer and boolean results must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import boxes as jboxes
from pcseqlearning_tpu.ops import geometry as jgeo
from pcseqlearning_tpu.ops import grid_utils as jgrid
from pcseqlearning_tpu.ops import sampling as jsamp
from pcseqlearning_tpu.ops import segment_ops as jseg
from pcseqlearning_tpu_torch.ops import boxes as tboxes
from pcseqlearning_tpu_torch.ops import geometry as tgeo
from pcseqlearning_tpu_torch.ops import grid_utils as tgrid
from pcseqlearning_tpu_torch.ops import sampling as tsamp
from pcseqlearning_tpu_torch.ops import segment_ops as tseg

T = torch.as_tensor
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)


def _seg_case(seed=0, n=200, k=17, dim=None):
    rng = np.random.RandomState(seed)
    shape = (n,) if dim is None else (n, dim)
    data = rng.randn(*shape).astype(np.float32)
    ids = rng.randint(0, k + 3, n).astype(np.int32)  # ids >= k are dropped
    return data, ids, k


_SEG_CASES = [(name, dim) for name in ("segment_sum", "segment_mean", "segment_min_or",
                                        "segment_max_or", "truncated_segment_mean")
               for dim in (None, 3)]
_SEG_CASES.append(("segment_median", None))  # 1-D data only, in both packages


@pytest.mark.parametrize("name,dim", _SEG_CASES)
def test_segment_ops_match_jax(name, dim):
    data, ids, k = _seg_case(dim=dim)
    if name in ("segment_min_or", "segment_max_or"):
        args_j, args_t = (jnp.asarray(data), jnp.asarray(ids), k, 0.5), (T(data), T(ids), k, 0.5)
    elif name == "truncated_segment_mean":
        ids = np.minimum(ids, k - 1)  # gathers mean0[ids]: keep ids in range
        args_j, args_t = (jnp.asarray(data), jnp.asarray(ids), k), (T(data), T(ids), k)
    else:
        args_j, args_t = (jnp.asarray(data), jnp.asarray(ids), k), (T(data), T(ids), k)
    want = np.asarray(getattr(jseg, name)(*args_j))
    got = getattr(tseg, name)(*args_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dim", [None, 3])
def test_sorted_segment_sum_matches_jax(dim):
    """The card's atomic-free segment sum (stable sort by id, one reduction
    per run), run here on the CPU: equal to the JAX package's segment_sum
    at 1e-5, empty segments zero; and ``index_add`` on the CPU is
    ``Tensor.index_add`` bit for bit."""
    data, ids, k = _seg_case(seed=3, dim=dim)
    ok = ids < k
    got = tseg._sorted_segment_sum(T(data)[T(ok)], T(ids)[T(ok)], k + 2)
    ref = np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), k))
    np.testing.assert_allclose(got[:k].numpy(), ref, rtol=1e-5, atol=1e-6)
    assert not got[k:].any()
    base = T(np.random.RandomState(4).randn(k, *data.shape[1:]).astype(np.float32))
    assert torch.equal(tseg.index_add(base, T(ids)[T(ok)], T(data)[T(ok)]),
                       base.index_add(0, T(ids)[T(ok)].long(), T(data)[T(ok)]))


def test_segment_median_int_and_empty():
    ids = np.array([0, 0, 0, 2, 2, 1, 1, 1, 1], np.int32)
    data = np.array([5, 1, 3, 7, 9, 4, 2, 8, 6], np.int32)
    want = np.asarray(jseg.segment_median(jnp.asarray(data), jnp.asarray(ids), 4))
    got = tseg.segment_median(T(data), T(ids), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] == -1


def test_unique_rows_and_grid_sample_match_jax():
    rng = np.random.RandomState(0)
    coords = rng.randint(-3, 4, (300, 4)).astype(np.int32)
    inv_j, num_j, _ = jgrid.unique_rows(jnp.asarray(coords))
    inv_t, num_t, perm_t = tgrid.unique_rows(T(coords))
    assert num_t == int(num_j)
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    srt = coords[perm_t.numpy()]
    assert all(tuple(a) <= tuple(b) for a, b in zip(srt[:-1], srt[1:]))

    pts = np.concatenate([rng.randint(0, 2, (500, 1)), rng.rand(500, 3) * 3], 1).astype(np.float32)
    vs = [0.4, 0.4, 0.3]
    np.testing.assert_array_equal(tgrid.voxel_coords(T(pts), vs).numpy(),
                                  np.asarray(jgrid.voxel_coords(jnp.asarray(pts), vs)))
    gj = jgrid.grid_sample_mean(jnp.asarray(pts), vs)
    gt = tgrid.grid_sample_mean(T(pts), vs)
    nv = gt["num_voxels"]
    assert nv == int(gj["num_voxels"])
    np.testing.assert_array_equal(gt["inverse"].numpy(), np.asarray(gj["inverse"]))
    np.testing.assert_allclose(gt["bxyz"].numpy(), np.asarray(gj["bxyz"])[:nv], rtol=1e-5,
                               atol=1e-6)
    assert gt["valid"].all()


def test_eigh3x3_matches_jax():
    rng = np.random.RandomState(0)
    M = rng.randn(64, 3, 3).astype(np.float32)
    A = M @ np.swapaxes(M, 1, 2)
    A[0] = np.diag([1.0, 1.0, 2.0])  # repeated eigenvalue
    A[1] = np.eye(3)  # isotropic
    vj, Vj = map(np.asarray, jgeo.eigh3x3(jnp.asarray(A)))
    vt, Vt = (x.numpy() for x in tgeo.eigh3x3(T(A)))
    scale = np.abs(vj).max(-1, keepdims=True)
    np.testing.assert_allclose(vt / scale, vj / scale, atol=1e-5)
    # eigenvectors of distinct eigenvalues agree up to sign; all columns are
    # orthonormal eigenvectors
    gap = np.minimum(vj[:, 1] - vj[:, 0], vj[:, 2] - vj[:, 1]) > 1e-3 * scale[:, 0]
    dots = np.abs(np.einsum("bij,bij->bj", Vt, Vj))
    assert (dots[gap] > 1 - 1e-4).all()
    np.testing.assert_allclose(np.einsum("bji,bjk->bik", Vt, Vt),
                               np.broadcast_to(np.eye(3), Vt.shape), atol=1e-5)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", A, Vt), Vt * vt[:, None, :],
                               atol=1e-4 * scale.max())


def test_procrustes_and_rigid_match_jax():
    rng = np.random.RandomState(1)
    M = rng.randn(32, 3, 3).astype(np.float32)
    M[0, :, 2] = 0.0  # rank 2 (planar correspondences)
    Rj = np.asarray(jgeo.procrustes_rotation(jnp.asarray(M)))
    Rt = tgeo.procrustes_rotation(T(M)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Rt), 1.0, atol=1e-5)
    t = rng.randn(32, 3).astype(np.float32)
    Tj = jgeo.make_rigid(jnp.asarray(Rj), jnp.asarray(t))
    Tt = tgeo.make_rigid(T(Rj), T(t))
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(Tj))
    pts = rng.randn(32, 3).astype(np.float32)
    np.testing.assert_allclose(tgeo.apply_rigid(Tt, T(pts)).numpy(),
                               np.asarray(jgeo.apply_rigid(Tj, jnp.asarray(pts))), atol=1e-5)


def test_points_in_boxes_matches_jax():
    rng = np.random.RandomState(2)
    pts = (rng.rand(400, 3) * 10 - 5).astype(np.float32)
    boxes = np.concatenate([rng.rand(12, 3) * 6 - 3, rng.rand(12, 3) * 3 + 0.5,
                            rng.rand(12, 1) * 6], 1).astype(np.float32)
    want = np.asarray(jboxes.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))
    got = tboxes.points_in_boxes(T(pts), T(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    # leading (frame) dims broadcast
    got2 = tboxes.points_in_boxes(T(pts)[None].repeat(2, 1, 1), T(boxes)[None].repeat(2, 1, 1))
    np.testing.assert_array_equal(got2[1].numpy(), want)


def test_knn_bruteforce_matches_jax():
    rng = np.random.RandomState(3)
    ref = rng.randn(120, 3).astype(np.float32)
    valid = rng.rand(120) > 0.2
    ij, dj = jsamp.knn_bruteforce(jnp.asarray(ref), jnp.asarray(ref), 8,
                                  ref_valid=jnp.asarray(valid))
    it, dt = tsamp.knn_bruteforce(T(ref), T(ref), 8, ref_valid=T(valid))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_utils_match_jax():
    from pcseqlearning_tpu.utils import edict as jedict
    from pcseqlearning_tpu.utils import frame_index as jfi
    from pcseqlearning_tpu.utils import padding as jpad
    from pcseqlearning_tpu_torch.utils import edict as tedict
    from pcseqlearning_tpu_torch.utils import frame_index as tfi
    from pcseqlearning_tpu_torch.utils import padding as tpad
    from pcseqlearning_tpu_torch.utils import telemetry

    for n in (0, 1, 256, 257, 1000, 90_000, 9_000_000):
        for base in (64, 256, 4096):
            assert tpad.bucket_size(n, base=base) == jpad.bucket_size(n, base=base)
    arr = np.arange(12, dtype=np.float32).reshape(6, 2)
    for got, want in zip(tpad.pad_rows(arr, 8, fill=-1), jpad.pad_rows(arr, 8, fill=-1)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tpad.pad_rows(arr, 4)
    frame = np.random.RandomState(0).randint(0, 5, 50)
    for sorted_input in (False, True):
        f = np.sort(frame) if sorted_input else frame
        a, b = tfi.FrameIndex(f), jfi.FrameIndex(f)
        for fid in range(6):
            np.testing.assert_array_equal(a.rows(fid), b.rows(fid))
            assert a.count(fid) == b.count(fid)
        np.testing.assert_array_equal(a.rows_range(1, 4), b.rows_range(1, 4))
        assert a.max_count() == b.max_count()
    e = tedict.EDict({"A": {"B": [{"C": 1}]}}, D=2)
    assert e.A.B[0].C == 1 and e.D == 2 and dict(e) == dict(jedict.EDict(e))
    telemetry.reset()
    telemetry.add("tracking_claim_overflow", 2)
    snap = telemetry.snapshot(reset=True)
    assert snap["tracking_claim_overflow"] == 2
    assert snap["proposal_scan_windows_truncated"] == 0  # every bench key is present
    assert telemetry.snapshot()["tracking_claim_overflow"] == 0
