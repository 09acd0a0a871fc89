"""The three kernels' plain PyTorch versions against the JAX package's Pallas
kernels (run in interpret mode, at the small shapes of
tests/test_pallas_kernels.py) and against NumPy / scipy oracles. On CPU
tensors each wrapper must take its plain version and count no launch
(tests/test_torch_cuda.py holds the CUDA kernels to the plain versions on a
card).

Tolerances: pair_min's distances are compared at 1e-5 absolute with the
Pallas kernel (both take direct float32 differences, possibly summed in
another order) and at 1e-6 relative with a float64 oracle 1 km from the
origin (float32 rounding of the squared terms); indices, labels and
neighbour ids must be equal, except argmins at float32 near-ties, which
are excluded by the stated gap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components as scipy_cc

from pcseqlearning_tpu.ops import pallas_scan as jscan
from pcseqlearning_tpu.ops import pallas_tpu as jpt
from pcseqlearning_tpu_torch.ops import pair_min as tpm
from pcseqlearning_tpu_torch.ops import sorted_grid as tsg

T = torch.as_tensor
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)


def _pm_case(C=4, P=128, Q=256, seed=0, offset=0.0):
    rng = np.random.RandomState(seed)
    a = (rng.rand(C, P, 3) * 10 + offset).astype(np.float32)
    b = (rng.rand(C, Q, 3) * 10 + offset).astype(np.float32)
    am = rng.rand(C, P) > 0.2
    bm = rng.rand(C, Q) > 0.2
    am[1] = False  # one fully-masked component per side
    bm[C - 1] = False
    return a, b, am, bm


def _oracle(a, b, am, bm):
    a, b = a.astype(np.float64), b.astype(np.float64)
    d2 = np.sum((a[:, :, None, :] - b[:, None, :, :]) ** 2, axis=-1)
    d2f = np.where(bm[:, None, :], d2, np.inf)
    d2b = np.where(am[:, :, None], d2, np.inf)
    return d2f, d2b


def _argmin_clear(d, axis):
    """Rows whose best value beats the runner-up by more than 1e-5 relative."""
    s = np.sort(d, axis=axis)
    first, second = np.take(s, 0, axis=axis), np.take(s, 1, axis=axis)
    return np.isfinite(first) & (second - first > 1e-5 * np.maximum(first, 1e-6))


def test_pair_min_plain_matches_pallas_interpret():
    a, b, am, bm = _pm_case(C=2, P=128, Q=128, seed=1)
    C, P, _ = a.shape
    Q = b.shape[1]
    at = jnp.asarray(np.concatenate([np.swapaxes(a, 1, 2), np.zeros((C, 1, P), np.float32)], 1))
    bt = jnp.asarray(np.concatenate([np.swapaxes(b, 1, 2), np.zeros((C, 1, Q), np.float32)], 1))
    jfd, jfi, jbd, jbi = map(np.asarray, jpt._pallas_pair_min(
        at, bt, jnp.asarray(am.astype(np.float32)), jnp.asarray(bm.astype(np.float32)),
        interpret=True))
    fd, fi, bd, bi = (x.numpy() for x in tpm.pair_min(T(a), T(b), T(am), T(bm)))
    fin = np.isfinite(fd)
    np.testing.assert_allclose(fd[fin], jfd[fin], atol=1e-5)
    np.testing.assert_allclose(bd[np.isfinite(bd)], jbd[np.isfinite(bd)], atol=1e-5)
    d2f, d2b = _oracle(a, b, am, bm)
    clear_f, clear_b = _argmin_clear(d2f, 2), _argmin_clear(d2b, 1)
    np.testing.assert_array_equal(fi[clear_f], jfi[clear_f])
    np.testing.assert_array_equal(bi[clear_b], jbi[clear_b])
    # the empty-row contract (+inf, index 0); the Pallas kernel's masked
    # rows are +1e30-biased, its wrapper maps them to +inf
    assert np.isinf(fd[C - 1]).all() and (fi[C - 1] == 0).all()
    assert np.isinf(bd[1]).all() and (bi[1] == 0).all()


@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_pair_min_plain_matches_f64_oracle(offset):
    a, b, am, bm = _pm_case(offset=offset)
    fd, fi, bd, bi = (x.numpy() for x in tpm.pair_min(T(a), T(b), T(am), T(bm)))
    d2f, d2b = _oracle(a, b, am, bm)
    for got, d, idx, axis in ((fd, d2f, fi, 2), (bd, d2b, bi, 1)):
        want = d.min(axis)
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all()
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-7)
        clear = _argmin_clear(d, axis)
        np.testing.assert_array_equal(idx[clear], d.argmin(axis)[clear])
    assert tpm.pair_min.launches == 0  # CPU tensors never launch the kernel


def test_pair_min_ties_go_to_first_index():
    a = np.zeros((1, 2, 3), np.float32)
    b = np.zeros((1, 4, 3), np.float32)
    b[0, 2:] = 1.0  # q 0, 1 tie at distance 0
    am, bm = np.ones((1, 2), bool), np.array([[False, True, True, True]])
    fd, fi, bd, bi = (x.numpy() for x in tpm.pair_min(T(a), T(b), T(am), T(bm)))
    assert fi.tolist() == [[1, 1]] and fd.tolist() == [[0.0, 0.0]]
    assert bi.tolist() == [[0, 0, 0, 0]]


def _cloud(rng, n, frames=2, extent=10.0, zs=0.5):
    return np.concatenate([
        rng.randint(0, frames, (n, 1)).astype(np.float32),
        rng.rand(n, 2).astype(np.float32) * extent - extent / 2,
        rng.randn(n, 1).astype(np.float32) * zs,
    ], axis=1)


def _same_partition(a, b):
    m1, m2 = {}, {}
    for x, y in zip(a, b):
        if m1.setdefault(x, y) != y or m2.setdefault(y, x) != x:
            return False
    return True


def test_connected_components_match_pallas_interpret_and_scipy(rng):
    n = 400
    fxyz = _cloud(rng, n)
    valid = rng.rand(n) > 0.12
    r = 0.9
    comp_j, num_j, ntrunc = jscan.connected_components_radius(
        jnp.asarray(fxyz), jnp.asarray(valid), r, F=2, X=16, Y=16, W=256, Bq=128,
        interpret=True)
    assert int(ntrunc) == 0
    comp, num = tsg.connected_components_radius(T(fxyz), T(valid), r, F=2, X=16, Y=16)
    comp = comp.numpy()
    assert num == int(num_j)
    assert (comp[~valid] == -1).all()
    assert _same_partition(comp[valid], np.asarray(comp_j)[valid])
    d2 = ((fxyz[None, :, 1:4] - fxyz[:, None, 1:4]) ** 2).sum(-1)
    adj = (d2 <= r * r) & (fxyz[None, :, 0] == fxyz[:, None, 0]) & valid[None] & valid[:, None]
    _, lab = scipy_cc(sp.csr_matrix(adj), directed=False)
    assert _same_partition(comp[valid], lab[valid])
    assert tsg.cc_round.launches == 0


def test_cc_round_plain_is_one_propagation_round(rng):
    """One round = min label over in-radius members of the three probe
    runs (brute force over the same sorted slots)."""
    fxyz = _cloud(rng, 300, frames=1, extent=6.0)
    st = tsg.cc_prep(T(fxyz), None, 0.7, F=1, X=16, Y=16)
    xyz = st["sorted_xyz"].numpy()
    labels = np.random.RandomState(5).permutation(300).astype(np.int32)
    got = tsg.cc_round(st["sorted_xyz"], T(labels), st["bounds"], st["r2"]).numpy()
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    want = np.where(d2 <= st["r2"], labels[None, :], np.iinfo(np.int32).max).min(1)
    np.testing.assert_array_equal(got, np.minimum(want, labels))


@pytest.mark.parametrize("k", [1, 4])
def test_radius_scan_matches_pallas_interpret_and_brute_force(rng, k):
    n = 300
    fxyz = _cloud(rng, n, extent=8.0, zs=1.0)
    valid = rng.rand(n) > 0.15
    r = 1.0
    ij, dj, mj, ntrunc = jscan.radius_neighbors_sorted(
        jnp.asarray(fxyz), jnp.asarray(fxyz), r, k, F=2, X=16, Y=16,
        ref_valid=jnp.asarray(valid), query_valid=jnp.asarray(valid), W=256, Bq=128,
        interpret=True)
    assert int(ntrunc) == 0
    idx, d2, mask = tsg.radius_neighbors_sorted(T(fxyz), T(fxyz), r, k, F=2, X=16, Y=16,
                                                ref_valid=T(valid), query_valid=T(valid))
    idx, d2, mask = idx.numpy(), d2.numpy(), mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(mj))
    np.testing.assert_allclose(d2[mask], np.asarray(dj)[mask], atol=1e-6)
    np.testing.assert_array_equal(idx, np.asarray(ij))
    for q in range(0, n, 7):
        if not valid[q]:
            assert not mask[q].any()
            continue
        dd = ((fxyz[:, 1:4] - fxyz[q, 1:4]) ** 2).sum(1)
        cand = np.where(valid & (fxyz[:, 0] == fxyz[q, 0]) & (dd <= r * r + 1e-9))[0]
        np.testing.assert_allclose(np.sort(d2[q][mask[q]]), np.sort(dd[cand])[:k], atol=1e-5)
    assert tsg.radius_scan.launches == 0


def test_radius_scan_ties_go_to_lower_sorted_position():
    ref = np.array([[0, 0.5, 0.0, 0.0], [0, -0.5, 0.0, 0.0], [0, 0.0, 0.9, 0.0]], np.float32)
    q = np.array([[0, 0.0, 0.0, 0.0]], np.float32)
    st = tsg.scan_prep(T(ref), T(q), 1.0, F=1, X=8, Y=8)
    d2, pos = tsg.radius_scan(st["table"], st["q_xyz"], st["bounds"], st["r2"], 3)
    assert d2[0, :2].tolist() == [0.25, 0.25]
    assert pos[0, 0] < pos[0, 1]  # the tie keeps sorted-position order
    assert pos[0, 2] >= 0 and d2[0, 2] == pytest.approx(0.81)


def test_kernel_wrappers_validate_k():
    st = tsg.scan_prep(T(np.zeros((2, 4), np.float32)), T(np.zeros((1, 4), np.float32)),
                       1.0, F=1, X=4, Y=4)
    with pytest.raises(ValueError):
        tsg.radius_scan(st["table"], st["q_xyz"], st["bounds"], st["r2"], 9)
