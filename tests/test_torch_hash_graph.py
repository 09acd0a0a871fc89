"""The spatial-hash neighbour search: the port's ops/hash_graph.py against the
JAX package's on the same seeded inputs.

Tolerance: none on decisions. Hashes, buckets, the bucket sort, run
offsets, neighbour indices, masks, overflow counts, point hits and coord
lookups must be equal. Squared distances agree to one float32 rounding of
their sum (rtol 3e-7): XLA on the CPU contracts dx*dx + dy*dy + dz*dz into
fused multiply-adds, PyTorch rounds each product, as the CUDA kernels do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import hash_graph as jhg
from pcseqlearning_tpu_torch.ops import hash_graph as thg

T = torch.as_tensor
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)


def _cloud(rng, n, frames, extent, offset=0.0):
    return np.concatenate([rng.randint(0, frames, (n, 1)).astype(np.float32),
                           (rng.rand(n, 3) * extent + offset).astype(np.float32)], axis=1)


def _grids(ref, cell, valid=None):
    gj = jhg.build_hash_grid(jnp.asarray(ref), cell, None if valid is None else jnp.asarray(valid))
    gt = thg.build_hash_grid(T(ref), cell, None if valid is None else T(valid))
    return gj, gt


def _assert_neighbors_equal(out_t, out_j):
    (it, dt, mt), (ij, dj, mj) = [[np.asarray(x) for x in o] for o in (out_t, out_j)]
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=3e-7, atol=0)


def test_hash_cells_bit_equal_with_negative_and_large_cells():
    rng = np.random.RandomState(0)
    cells = rng.randint(-2 ** 31, 2 ** 31 - 1, size=(20000, 4), dtype=np.int64).astype(np.int32)
    cells[:4] = [[-1, -1, -1, -1], [2 ** 31 - 1] * 4, [-2 ** 31] * 4, [0, 0, 0, 0]]
    cells[4:1000] = rng.randint(-3, 3, size=(996, 4))  # small cells of both signs
    want = np.asarray(jhg._hash_cells(jnp.asarray(cells))).astype(np.int64)
    got = thg._hash_cells(T(cells)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 0xFFFFFFFF).all() and (got >= 0).all()


@pytest.mark.parametrize("case", ["dense", "large_offset", "padded"])
def test_build_hash_grid_bit_equal(case):
    """Buckets, the bucket sort's order and the run offsets; 'dense' packs
    500 points into one column (a bucket far over the cap), 'large_offset'
    puts the cloud 5 km from the origin (large cell ids), 'padded' masks a
    fifth of the rows."""
    rng = np.random.RandomState(1)
    ref = _cloud(rng, 3000, 3, 3.0, offset=5000.0 if case == "large_offset" else -1.5)
    valid = None
    if case == "dense":
        ref[:500, 1:3] = ref[:500, 1:3] * 0.01
    if case == "padded":
        valid = rng.rand(3000) > 0.2
        ref[~valid, 1:] = 1e8
    gj, gt = _grids(ref, 0.4, valid)
    for name in ("sorted_bucket", "sorted_idx", "offsets", "sorted_valid"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(gt.origin.numpy(), np.asarray(gj.origin))
    assert int(thg.cell_cap_overflow(gt, 48)) == int(jhg.cell_cap_overflow(gj, 48))
    if case == "dense":
        assert int(thg.cell_cap_overflow(gt, 48)) > 0


def _neighbor_case(name, rng):
    """(ref, query, radius, ref_valid, query_valid) for the cases of
    tests/test_grid_and_graph.py and their edges."""
    ref = _cloud(rng, 400, 3, 4.0)
    query = _cloud(rng, 300, 3, 4.0)
    rv = qv = None
    if name == "padded":
        rv, qv = np.arange(400) < 300, np.arange(300) < 200
    elif name == "duplicates_and_ties":
        ref[200:260] = ref[:60]  # each of these refs twice: equal distances
        query[:60] = ref[:60]  # queries on a duplicated point: d2 = 0 twice
        query[60:80] = ref[100:120] + np.array([0, 0.05, 0, 0], np.float32)
    elif name == "over_cap":
        ref[:300, 1:3] = 1.0 + rng.rand(300, 2).astype(np.float32) * 0.05  # one column
        ref[:300, 0] = 1
        query[:100] = ref[:100] + np.array([0, 0.01, 0.0, 0.02], np.float32)
    elif name == "frame_shift":
        ref[:, 0] = 5
        query[:, 0] = 5  # the registration contract: queries shifted to the target frame
    return ref, query, 0.5, rv, qv


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("name", ["random", "padded", "duplicates_and_ties", "over_cap",
                                  "frame_shift"])
def test_radius_neighbors_equal(name, k):
    ref, query, r, rv, qv = _neighbor_case(name, np.random.RandomState(2))
    gj, gt = _grids(ref, r, rv)
    out_j = jhg.radius_neighbors(gj, jnp.asarray(query), r, k,
                                 query_valid=None if qv is None else jnp.asarray(qv), cell_cap=48)
    out_t = thg.radius_neighbors(gt, T(query), r, k, query_valid=None if qv is None else T(qv),
                                 cell_cap=48)
    _assert_neighbors_equal(out_t, out_j)
    mask = out_t[2].numpy()
    assert mask.any()
    if qv is not None:
        assert not mask[~qv].any()
    if name == "duplicates_and_ties" and k > 1:
        d2 = out_t[1].numpy()
        assert (d2[:60, 0] == 0).all() and (d2[:60, 1] == 0).all()  # both copies, tied


def test_radius_neighbors_chunked_queries_equal(monkeypatch):
    """Queries in several chunks: both modules' slot budget lowered so a
    chunk holds 97 queries (9 probes x cap 48 slots each)."""
    rng = np.random.RandomState(3)
    ref = _cloud(rng, 2000, 2, 20.0)
    query = _cloud(rng, 1000, 2, 20.0)
    gj, gt = _grids(ref, 0.6)
    for mod in (jhg, thg):
        monkeypatch.setattr(mod, "_VECTORIZE_MAX_SLOTS", 97 * 9 * 48)
    jhg.radius_neighbors._clear_cache()
    _assert_neighbors_equal(thg.radius_neighbors(gt, T(query), 0.6, 2),
                            jhg.radius_neighbors(gj, jnp.asarray(query), 0.6, 2))
    monkeypatch.undo()
    jhg.radius_neighbors._clear_cache()


def test_radius_graph_points_in_radius_and_edges_equal():
    rng = np.random.RandomState(4)
    ref = _cloud(rng, 500, 2, 3.0)
    query = _cloud(rng, 200, 2, 3.0)
    _assert_neighbors_equal(thg.radius_graph(T(ref), T(query), 0.3, 4, cell_cap=32),
                            jhg.radius_graph(jnp.asarray(ref), jnp.asarray(query), 0.3, 4,
                                             cell_cap=32))
    gj, gt = _grids(ref, 0.3)
    np.testing.assert_array_equal(thg.points_in_radius(gt, T(query), 0.3, cell_cap=16).numpy(),
                                  np.asarray(jhg.points_in_radius(gj, jnp.asarray(query), 0.3,
                                                                  cell_cap=16)))
    idx, _, mask = thg.radius_graph(T(ref), T(query), 0.3, 4, cell_cap=32)
    for a, b in zip(thg.edges_from_neighbors(idx, mask),
                    jhg.edges_from_neighbors(jnp.asarray(idx.numpy()), jnp.asarray(mask.numpy()))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_coord_lookup_equal():
    rng = np.random.RandomState(5)
    coords = np.unique(rng.randint(-20, 20, size=(600, 4)), axis=0).astype(np.int32)
    n = len(coords)
    valid = rng.rand(n) > 0.1
    q = np.concatenate([coords[rng.choice(n, 200)], coords[rng.choice(n, 100)] + 1000,
                        rng.randint(-20, 20, size=(100, 4))]).astype(np.int32)
    qv = rng.rand(len(q)) > 0.05
    want = np.asarray(jhg.coord_lookup(jhg.build_coord_table(jnp.asarray(coords),
                                                             jnp.asarray(valid)),
                                       jnp.asarray(q), jnp.asarray(qv)))
    got = thg.coord_lookup(thg.build_coord_table(T(coords), T(valid)), T(q), T(qv)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 100 and (got[200:300] == -1).all()
