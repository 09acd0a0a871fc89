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

import re
from pathlib import Path

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
from pcseqlearning_tpu_torch.scene import reconstruction_keys

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
    got = tsg.cc_round(st["sorted_xyz"], T(labels), st["bounds"], st["r2"],
                       st["plan"]).numpy()
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    want = np.where(d2 <= st["r2"], labels[None, :], np.iinfo(np.int32).max).min(1)
    np.testing.assert_array_equal(got, np.minimum(want, labels))


def _plan_case(seed, radius):
    """A 2-frame cloud whose columns hold more than one block of slots,
    with slots outside the X x X grid; returns cc_prep's state and the
    column (frame * X + cx, or F * X off the grid) of every sorted slot."""
    rng = np.random.RandomState(seed)
    n, X = 8000, 8 if radius < 0.7 else 6  # the grid covers 4-5.4 m of the 6 m cloud
    fxyz = T(_cloud(rng, n, frames=2, extent=6.0))
    st = tsg.cc_prep(fxyz, None, radius, F=2, X=X, Y=X)
    g = tsg._grid(fxyz, torch.ones(n, dtype=torch.bool), radius, 2, X, X)
    si = g["sorted_idx"]
    column = torch.where(g["in_grid"][si], g["rf"][si] * X + g["rcx"][si],
                         torch.full_like(si, 2 * X))
    return st, column.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("radius", [0.5, 0.9])
def test_cc_plan_covers_every_run_and_never_crosses_a_column(seed, radius):
    st, column = _plan_case(seed, radius)
    plan, bounds = st["plan"].numpy(), st["bounds"].numpy()
    m = column.shape[0]
    work = (plan[:, 1] - plan[:, 0]) * (plan[:, 5:8] - plan[:, 2:5]).sum(1)
    assert (np.diff(work) <= 0).all()  # heaviest blocks first
    plan = plan[np.argsort(plan[:, 0])]
    slot0, slot1, lo, hi = plan[:, 0], plan[:, 1], plan[:, 2:5], plan[:, 5:8]
    # the blocks tile the slots in order, at most PLAN_BLOCK each
    assert slot0[0] == 0 and slot1[-1] == m and (slot0[1:] == slot1[:-1]).all()
    assert ((slot1 - slot0 >= 1) & (slot1 - slot0 <= tsg.PLAN_BLOCK)).all()
    # one column per block, and every column starts a block
    assert (column[slot0] == column[slot1 - 1]).all()
    col_starts = np.flatnonzero(np.r_[True, column[1:] != column[:-1]])
    assert np.isin(col_starts, slot0).all()
    assert (slot1 - slot0 < tsg.PLAN_BLOCK).sum() >= len(col_starts) - 1  # ragged column ends
    assert (np.diff(slot0) == tsg.PLAN_BLOCK).any()  # some column holds several blocks
    assert (column == column.max()).any() and (bounds[:, column == column.max()] == 0).all()
    # every non-empty run lies in its block's range for its probe column
    blk = np.repeat(np.arange(len(plan)), slot1 - slot0)
    s, e = bounds[:3].T, bounds[3:].T
    ne = e > s
    assert ne.any()
    assert ((lo[blk] <= s) | ~ne).all() and ((e <= hi[blk]) | ~ne).all()
    # and the ranges are no wider than those runs
    for d in range(3):
        has = np.bincount(blk, weights=ne[:, d], minlength=len(plan)) > 0
        assert (lo[~has, d] == 0).all() and (hi[~has, d] == 0).all()
        first_s = np.full(len(plan), np.iinfo(np.int64).max)
        np.minimum.at(first_s, blk[ne[:, d]], s[ne[:, d], d])
        assert (lo[has, d] == first_s[has]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("radius", [0.5, 0.9])
def test_cc_union_range_rounds_equal_the_plain_round(seed, radius):
    """The kernel's algorithm in plain PyTorch: every slot of a block scans
    its block's range for each probe column and keeps a member j when
    s_i <= j < e_i (the index test) and d2 <= r2."""
    st, _ = _plan_case(seed, radius)
    xyz, bounds, plan, r2 = st["sorted_xyz"], st["bounds"].long(), st["plan"].long(), st["r2"]
    m = xyz.shape[0]
    labels = T(np.random.RandomState(seed + 7).permutation(m).astype(np.int32))
    out = labels.clone()
    for slot0, slot1, *rng_ in plan.tolist():
        i = torch.arange(slot0, slot1)
        for d in range(3):
            j = torch.arange(rng_[d], rng_[3 + d])
            if not len(j):
                continue
            in_run = (bounds[d, i, None] <= j) & (j < bounds[3 + d, i, None])
            diff = xyz[i, None, :] - xyz[None, j, :]
            d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                  + diff[..., 2] * diff[..., 2])
            cand = torch.where(in_run & (d2 <= r2), labels[j][None, :],
                               torch.full_like(d2, torch.iinfo(torch.int32).max, dtype=torch.int32))
            out[i] = torch.minimum(out[i], cand.min(1).values)
    want = tsg.cc_round_plain(xyz, labels, st["bounds"], r2)
    assert not torch.equal(want, labels)  # the round propagates something
    assert torch.equal(out, want)


def _cu_define(source, name):
    """The integer value of ``#define name`` in a kernel source file."""
    text = (Path(tpm.__file__).resolve().parent.parent / "csrc" / source).read_text()
    return int(re.search(rf"^#define {name} (\d+)", text, re.M).group(1))


@pytest.mark.parametrize("C", [1, 7, 144, 2048])
@pytest.mark.parametrize("P,Q", [(256, 512), (256, 256), (100, 300)])
def test_pair_min_split_covers_every_row_once(C, P, Q):
    """The kernel's block/thread/row mapping (csrc/pair_min.cu, with its own
    THREADS and SEGMENTS) writes each forward and backward row of each
    component exactly once (from segment 0's thread), has every segment of
    the row's scan run on it, and splits any number of staged points into
    segments that cover them once."""
    threads, segments = _cu_define("pair_min.cu", "THREADS"), _cu_define("pair_min.cu", "SEGMENTS")
    rows_per_block = threads // segments
    fb, bb = -(-P // rows_per_block), -(-Q // rows_per_block)  # as pair_min_launch
    blocks = np.arange(C * (fb + bb))
    c, s = blocks // (fb + bb), blocks % (fb + bb)
    t = np.arange(threads)
    g, h = t % rows_per_block, t // rows_per_block
    for fwd, n in ((True, P), (False, Q)):
        writes, scans = np.zeros((C, n), int), np.zeros((C, n), int)
        sel = (s < fb) if fwd else (s >= fb)
        sl = np.where(fwd, s, s - fb)[sel]
        rows = sl[:, None] * rows_per_block + g[None, :]
        cc = np.broadcast_to(c[sel][:, None], rows.shape)
        ok = rows < n
        np.add.at(scans, (cc[ok], rows[ok]), 1)
        w = ok & (h[None, :] == 0)
        np.add.at(writes, (cc[w], rows[w]), 1)
        assert (writes == 1).all() and (scans == segments).all()
    for n in range(max(P, Q) + 1):  # segment hh scans [n*hh/S, n*(hh+1)/S)
        seg = [np.arange(n * hh // segments, n * (hh + 1) // segments) for hh in range(segments)]
        assert np.array_equal(np.concatenate(seg), np.arange(n))
    if C >= 144:  # a walk-sized C fills the card: at least 4 blocks per SM
        assert len(blocks) >= 4 * 132


def _tie_case(C=3, P=70, Q=90, seed=3):
    """Points on a coarse lattice (many equal distances, so ties straddle
    the chunk edges), one empty row on each side."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 3, (C, P, 3)).astype(np.float32)
    b = rng.randint(0, 3, (C, Q, 3)).astype(np.float32)
    am, bm = rng.rand(C, P) > 0.3, rng.rand(C, Q) > 0.3
    am[1], bm[2] = False, False
    return a, b, am, bm


@pytest.mark.parametrize("block", [1, 64, 700, 2100, 1 << 24])
def test_pair_min_plain_chunked_equals_unchunked(block):
    """The plain version in tiles of at most ``block`` distances (P rows by
    Q columns, merged with a strict <) equals one min over whole rows, bit
    for bit: values, first argmin on ties across tile edges, and +inf /
    index 0 for empty rows."""
    args = tuple(T(x) for x in _tie_case())
    whole = tpm.pair_min_plain(*args, block=1 << 30)
    got = tpm.pair_min_plain(*args, block=block)
    for g, w in zip(got, whole):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    a, b, am, bm = (x.numpy() for x in args)
    d = ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1)
    fwd = np.where(bm[:, None, :], d, np.inf)
    np.testing.assert_array_equal(whole[1].numpy(), fwd.argmin(2))  # NumPy's first argmin
    assert np.isinf(whole[2].numpy()[1]).all() and (whole[3].numpy()[1] == 0).all()


def _stream_sizes(scale, half=False):
    """csrc/pair_min.cu's streamed-mode sizes, read from its #defines: as
    they are (scale 1), or divided so that a small case crosses every
    border (scale 0: 4 lanes, a quarter of the warps and of the rows a warp,
    2 passes a tile, the slice by 64). ``half`` takes the smallest tile the
    launch may choose, S_TILE / 2. The kernel's static_asserts hold."""
    z = {k: _cu_define("pair_min.cu", f"S_{k}")
         for k in ("WARPS", "THREADS", "RPW", "STEP", "TILE", "SLICE")}
    assert z["THREADS"] == 32 * z["WARPS"] == z["STEP"]
    assert z["TILE"] % (2 * z["WARPS"] * z["RPW"]) == 0 and z["SLICE"] % z["STEP"] == 0
    if scale:
        lanes, warps, rpw, passes = 32, z["WARPS"], z["RPW"], z["TILE"] // (z["WARPS"] * z["RPW"])
        slice_len = z["SLICE"]
    else:
        lanes, warps, rpw, passes, slice_len = 4, z["WARPS"] // 4, z["RPW"] // 4, 2, z["SLICE"] // 64
    step = z["STEP"] // 32 * lanes  # columns a lane takes in a step, as in the kernel
    tile = warps * rpw * (passes // 2 if half else passes)
    assert slice_len % step == 0
    return dict(lanes=lanes, warps=warps, rpw=rpw, step=step, tile=tile, slice_len=slice_len)


def _first_min(d, ok, axis):
    """A strict-< chain from (+inf, 0) along ``axis``, in index order, over
    the entries where ``ok``: the minimum and its first position, (+inf, 0)
    where no entry is below +inf (NaN never is)."""
    v = np.where(ok & (d < np.inf), d, np.float32(np.inf))
    i = v.argmin(axis)
    m = np.take_along_axis(v, np.expand_dims(i, axis), axis).squeeze(axis)
    return m, np.where(m < np.inf, i, 0)


def _key(d, i):
    """The kernel's 64-bit key: d2 bits << 32 | index."""
    d, i = np.asarray(d, np.float32), np.asarray(i)
    return (d.view(np.uint32).astype(np.uint64) << np.uint64(32)) | i.astype(np.uint64)


def _d2(x, y):
    """(x - y) squared and summed as float32, (dx2 + dy2) + dz2, like the kernel."""
    dd = x - y
    return (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) + dd[..., 2] * dd[..., 2]


def _stream_design(a, b, am, bm, lanes, warps, rpw, step, tile, slice_len, cover=None):
    """csrc/pair_min.cu's streamed mode in NumPy, block by block. The larger
    side holds the rows. A block takes ``tile`` rows by ``slice_len``
    columns of one component and stages the columns (padded to whole steps
    with masked ones); pass p gives warp w the group g = p * warps + w of
    rows tile_start + g * rpw onward, the same rows in every lane; step s
    gives lane l columns s * step + i * lanes + l. Each d2 is computed once,
    as (row - column) in float32, and feeds the lane's strict-< chain of its
    row (columns ascending, where the column is valid) and the group's min
    of its column (over the valid rows). The step's group minima merge into
    the slice's column keys in group order, a later group only when strictly
    smaller; at the block's end the key's group is computed again and its
    first valid row with an equal d2 is the argmin. The lanes' row minima
    merge by the lexicographic (d2, index) minimum, and blocks by the 64-bit
    key minimum from (+inf, 0). ``cover`` [C, rows, columns], where given,
    counts every pair the scan computes."""
    inf = np.float32(np.inf)
    swap = b.shape[1] > a.shape[1]
    rows, cols, rmask, cmask = (b, a, bm, am) if swap else (a, b, am, bm)
    C, nr, nc = rows.shape[0], rows.shape[1], cols.shape[1]
    rkeys, ckeys = np.full((C, nr), _key(inf, 0)), np.full((C, nc), _key(inf, 0))
    cpl = step // lanes
    for c in range(C):
        for r0 in range(0, nr, tile):
            r1 = min(nr, r0 + tile)
            for j0 in range(0, nc, slice_len):
                n = min(slice_len, nc - j0)
                steps = -(-n // step)
                staged = np.zeros((steps * step, 3), np.float32)
                staged[:n] = cols[c, j0:j0 + n]
                live = np.zeros(steps * step, bool)
                live[:n] = cmask[c, j0:j0 + n]
                kd, kg = np.full(steps * step, inf), np.zeros(steps * step, np.int64)
                for p, p0 in enumerate(range(r0, r1, warps * rpw)):
                    rid = p0 + np.arange(warps * rpw).reshape(warps, rpw)
                    ok = rid < r1
                    at = np.minimum(rid, nr - 1)
                    x = np.where(ok[..., None], rows[c, at], np.float32(0))
                    valid = ok & rmask[c, at]
                    best, arg = np.full((warps, rpw, lanes), inf), np.zeros((warps, rpw, lanes),
                                                                            np.int64)
                    for s in range(steps):
                        k = s * step + np.arange(step).reshape(cpl, lanes)
                        d = _d2(x[:, :, None, None, :], staged[k][None, None])  # [w, r, i, l]
                        m, i = _first_min(d, live[k][None, None], 2)  # [warps, rpw, lanes]
                        take = m < best  # this step's columns come after the earlier steps'
                        best = np.where(take, m, best)
                        arg = np.where(take, j0 + k[i, np.arange(lanes)], arg)
                        cd = np.where(valid[:, :, None, None] & (d < inf), d, inf).min(1)
                        ks = k.reshape(-1)
                        m, w = _first_min(np.concatenate([kd[ks][None], cd.reshape(warps, step)]),
                                          np.ones((1, 1), bool), 0)  # the key first, then groups
                        kg[ks] = np.where(w == 0, kg[ks], p * warps + w - 1)
                        kd[ks] = np.where(w == 0, kd[ks], m)
                        if cover is not None:
                            cover[c, rid[ok][:, None], (j0 + ks[ks < n])[None, :]] += 1
                    key = _key(best, arg).min(2)  # the butterfly over the lanes
                    send = ok & ((key >> np.uint64(32)) != _key(inf, 0) >> np.uint64(32))
                    np.minimum.at(rkeys[c], rid[send], key[send])
                fin = np.nonzero(kd[:n] < inf)[0]
                grp = r0 + kg[fin, None] * rpw + np.arange(rpw)[None]  # the key's group
                hit = (grp < r1) & rmask[c, np.minimum(grp, nr - 1)] & (
                    _d2(rows[c, np.minimum(grp, nr - 1)], staged[fin][:, None]) == kd[fin, None])
                assert hit.any(1).all()
                first = grp[np.arange(len(fin)), hit.argmax(1)]
                np.minimum.at(ckeys[c], j0 + fin, _key(kd[fin], first))
    out = [((k >> np.uint64(32)).astype(np.uint32).view(np.float32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.int32)) for k in (rkeys, ckeys)]
    (fd, fi), (bd, bi) = out[::-1] if swap else out
    return fd, fi, bd, bi


def _lattice_case(C, P, Q, seed, masked=0.3):
    """Points on a 3-step lattice: many equal distances, so ties straddle
    every tile, slice, pass and step border; random masks on both sides."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 3, (C, P, 3)).astype(np.float32)
    b = rng.randint(0, 3, (C, Q, 3)).astype(np.float32)
    return a, b, rng.rand(C, P) > masked, rng.rand(C, Q) > masked


def _masks_case():
    a, b, am, bm = _lattice_case(3, 90, 75, seed=5, masked=0.5)
    am[1, ::2] = False  # a masked row's own forward result is still checked
    return a, b, am, bm


def _all_masked_case():
    a, b, am, bm = _lattice_case(3, 50, 80, seed=6)
    am[0], bm[1] = False, False
    am[2], bm[2] = False, False
    return a, b, am, bm


_STREAM_CASES = {
    "lattice_ties_rows_a": lambda: _lattice_case(2, 150, 70, seed=3),
    "lattice_ties_rows_b": lambda: _lattice_case(2, 70, 150, seed=4),
    "partial_masks": _masks_case,
    "all_masked_components": _all_masked_case,
    "p_much_larger_ragged": lambda: _lattice_case(1, 203, 37, seed=7),
    "p_much_smaller_ragged": lambda: _lattice_case(2, 45, 301, seed=8),
}


def _assert_design_equals_plain(args, sizes, cover=None):
    got = _stream_design(*args, **sizes, cover=cover)
    want = tpm.pair_min_plain(*(T(x) for x in args))
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())
    return got


def test_pair_min_stream_mode_design_equals_plain():
    """The streamed mode's single pass (emulated with csrc/pair_min.cu's own
    S_* sizes, scaled down) gives the plain version's results bit for bit
    on lattice ties across its tile, slice, pass and step borders, with
    masked and empty rows on both sides; its grid computes every (row,
    column) pair of each component exactly once, for both directions."""
    args = _tie_case()
    for half in (False, True):  # the largest and the smallest row tile
        cover = np.zeros((3, 90, 70), int)  # rows are the larger side: b
        _assert_design_equals_plain(args, _stream_sizes(0, half), cover)
        assert (cover == 1).all()


@pytest.mark.parametrize("case", sorted(_STREAM_CASES))
def test_pair_min_stream_mode_design_cases_equal_plain(case):
    """As above on each case: ties where rows are a or b, partial masks on
    both sides, components with a side or both sides masked, ragged edges
    with P much larger or smaller than Q."""
    a, b, am, bm = _STREAM_CASES[case]()
    C, P, Q = a.shape[0], a.shape[1], b.shape[1]
    cover = np.zeros((C, max(P, Q), min(P, Q)), int)
    fd, fi, bd, bi = _assert_design_equals_plain((a, b, am, bm), _stream_sizes(0), cover)
    assert (cover == 1).all()
    if case == "partial_masks":
        assert np.isfinite(fd[1, ::2]).all()  # masked rows have their own minima
    if case == "all_masked_components":
        assert np.isinf(bd[0]).all() and (bi[0] == 0).all()  # no valid row
        assert np.isinf(fd[1]).all() and (fi[1] == 0).all()  # no valid column
        assert np.isinf(fd[2]).all() and np.isinf(bd[2]).all()


def test_pair_min_stream_mode_design_on_the_heads_keys():
    """The single pass at the kernel's own sizes on the reconstruction
    head's key layout (1e3 * batch, polar, azimuth), n = 2,048 returns in two
    batches and their 27 samples each: the plain version bit for bit."""
    args = reconstruction_keys(2048)
    fd, fi, bd, bi = _assert_design_equals_plain(args, _stream_sizes(1))
    assert (fi[0, : 27 * 1024] < 1024).all() and (fi[0, 27 * 1024:] >= 1024).all()


def test_pair_min_stream_grid_at_the_heads_full_width():
    """At the head's full-width call (P = 884,736, Q = 32,768) the grid's row
    tiles and slices cover each side exactly, its blocks fill 132 SMs at two
    an SM many times over, and the atomics stay under 0.2% of the pairs."""
    z = _stream_sizes(1)
    P, Q = 884_736, 32_768
    tiles, slices = -(-P // z["tile"]), -(-Q // z["slice_len"])
    assert tiles * z["tile"] >= P > (tiles - 1) * z["tile"]
    assert slices * z["slice_len"] >= Q > (slices - 1) * z["slice_len"]
    assert tiles * slices >= 20 * 2 * 132
    assert (P * slices + Q * tiles) < 0.002 * P * Q


def test_pair_min_plain_holds_the_heads_shape_in_tiles():
    """At the reconstruction head's shape the plain version never builds
    more than its block of distances at once: P = 27 * 2048 samples
    against Q = 2048 returns in tiles of 8192 rows (2^24 / Q)."""
    rng = np.random.RandomState(0)
    P, Q = 27 * 2048, 2048
    a = T(rng.rand(1, P, 3).astype(np.float32))
    b = T(rng.rand(1, Q, 3).astype(np.float32))
    am, bm = torch.ones(1, P, dtype=torch.bool), T(rng.rand(1, Q) > 0.1)
    fd, fi, bd, bi = tpm.pair_min_plain(a, b, am, bm)
    sub = slice(0, 2048)  # spot-check against the whole-row min
    whole = tpm.pair_min_plain(a[:, sub], b, am[:, sub], bm, block=1 << 30)
    np.testing.assert_array_equal(fd[:, sub].numpy(), whole[0].numpy())
    np.testing.assert_array_equal(fi[:, sub].numpy(), whole[1].numpy())
    assert fd.shape == (1, P) and bd.shape == (1, Q) and int(bi.max()) < P


@pytest.mark.parametrize("k", [1, 4, 8])
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
    d2, pos = tsg.radius_scan(st["table"], st["q_xyz"], st["bounds"], st["r2"], 3, st["plan"])
    assert d2[0, :2].tolist() == [0.25, 0.25]
    assert pos[0, 0] < pos[0, 1]  # the tie keeps sorted-position order
    assert pos[0, 2] >= 0 and d2[0, 2] == pytest.approx(0.81)


def test_kernel_wrappers_validate_k():
    st = tsg.scan_prep(T(np.zeros((2, 4), np.float32)), T(np.zeros((1, 4), np.float32)),
                       1.0, F=1, X=4, Y=4)
    with pytest.raises(ValueError):
        tsg.radius_scan(st["table"], st["q_xyz"], st["bounds"], st["r2"], 9, st["plan"])


def _scan_case(seed):
    """Reference points filling a 2-frame, 8 x 8-cell grid at r = 0.9 (100
    of them duplicated: exact ties), and shuffled queries of every kind:
    inside the grid, one cell outside it on each side and at the corners
    (their runs reach the edge columns and rows), three cells outside (no
    runs), in a frame outside the grid, invalid, padded rows (zeros,
    invalid, as the tracking window's table pads), and duplicated queries.
    Returns (ref_fxyz, query_fxyz, query_valid, radius, F, X) with X = Y."""
    rng = np.random.RandomState(seed)
    r, F, X = 0.9, 2, 8
    ref = _cloud(rng, 1400, frames=F, extent=X * r - 0.3)
    ref = np.concatenate([ref, ref[rng.choice(len(ref), 100, replace=False)]])
    ox, oy = ref[:, 1].min(), ref[:, 2].min()  # the grid's origin
    inside = _cloud(rng, 1200, frames=F, extent=X * r - 0.3)
    inside[:, 1:3] += np.array([ox, oy], np.float32) - inside[:, 1:3].min(0)
    cells = np.array([-1, 0, X // 2, X - 1, X, -3, X + 2], np.float32)
    ex, ey = np.meshgrid(cells, cells)
    ring = np.stack([np.zeros(ex.size), ox + (ex.ravel() + 0.5) * r,
                     oy + (ey.ravel() + 0.5) * r, np.zeros(ex.size)], 1).astype(np.float32)
    ring = np.concatenate([ring, ring + np.array([1, 0.2, -0.2, 0.1], np.float32)])
    other_frame = inside[:40] + np.array([3, 0, 0, 0], np.float32)
    q = np.concatenate([inside, ring, other_frame, inside[:150]])  # the last: duplicates
    valid = rng.rand(len(q)) > 0.1
    q = np.concatenate([q, np.zeros((300, 4), np.float32)])
    valid = np.concatenate([valid, np.zeros(300, bool)])
    perm = rng.permutation(len(q))
    return ref, q[perm], valid[perm], r, F, X


def _caller_order_bounds(ref, q, valid, r, F, X):
    """Run bounds of the queries in the caller's order, from the same grid."""
    ref, q, valid = T(ref), T(q), T(valid)
    g = tsg._grid(ref, torch.ones(len(ref), dtype=torch.bool), r, F, X, X)
    qf, qcx, qcy = tsg._cell_ids(q, g["origin"], g["inv_cell"], g["f_min"])
    q_in = valid & (qf >= 0) & (qf < F)
    return tsg._probe_bounds(qf, qcx, qcy, q_in, g["offsets"], F, X, X)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_plan_covers_every_query_once_and_holds_its_runs(seed):
    ref, q, valid, r, F, X = _scan_case(seed)
    st = tsg.scan_prep(T(ref), T(q), r, F, X, X, query_valid=T(valid))
    plan, bounds = st["plan"].numpy(), st["bounds"].numpy()
    order = st["q_order"].numpy()
    m = len(q)
    assert np.array_equal(np.sort(order), np.arange(m))  # a permutation
    # the sorted queries' bounds are the caller-order bounds, permuted
    assert np.array_equal(bounds, _caller_order_bounds(ref, q, valid, r, F, X).numpy()[:, order])
    plan = plan[np.argsort(plan[:, 0])]
    q0, q1, lo, hi = plan[:, 0], plan[:, 1], plan[:, 2:5], plan[:, 5:8]
    # the blocks tile the sorted queries in order: each query in one block
    assert q0[0] == 0 and q1[-1] == m and (q0[1:] == q1[:-1]).all()
    assert ((q1 - q0 >= 1) & (q1 - q0 <= tsg.PLAN_BLOCK)).all()
    blk = np.repeat(np.arange(len(plan)), q1 - q0)
    s, e = bounds[:3].T, bounds[3:].T
    ne = e > s
    assert ne.any() and (~ne.any(1)).sum() > tsg.PLAN_BLOCK
    assert ((lo[blk] <= s) | ~ne).all() and ((e <= hi[blk]) | ~ne).all()
    # queries one cell off the grid have runs; those three cells off do not
    g = tsg._grid(T(ref), torch.ones(len(ref), dtype=torch.bool), r, F, X, X)
    _, cx, cy = (t.numpy() for t in tsg._cell_ids(T(q)[order], g["origin"], g["inv_cell"],
                                                  g["f_min"]))
    assert ne[(cx == -1) | (cx == X) | (cy == -1) | (cy == X)].any()
    assert not ne[(cx <= -3) | (cx >= X + 2) | (cy <= -3) | (cy >= X + 2)].any()
    # a block whose queries have no runs has empty ranges; and the queries
    # without a frame in the grid (invalid, padded, other frames) sort last
    empty = np.bincount(blk, weights=ne.any(1), minlength=len(plan)) == 0
    assert empty.sum() >= 2 and (lo[empty] == 0).all() and (hi[empty] == 0).all()
    f = np.round(q[order, 0]).astype(int) - int(g["f_min"])
    off = ~valid[order] | (f < 0) | (f >= F)
    assert not off[:np.argmax(off)].any() and off[np.argmax(off):].all()


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_radius_neighbors_sorted_equals_the_plain_scan_of_unsorted_queries(seed, k):
    """Sorting the queries changes nothing: the public entry equals
    radius_scan_plain over the queries in the caller's order."""
    ref, q, valid, r, F, X = _scan_case(seed)
    idx, d2, mask = tsg.radius_neighbors_sorted(T(ref), T(q), r, k, F, X, X,
                                                query_valid=T(valid))
    st = tsg.scan_prep(T(ref), T(q), r, F, X, X, query_valid=T(valid))
    bounds = _caller_order_bounds(ref, q, valid, r, F, X)
    pd, pp = tsg.radius_scan_plain(st["table"], T(q[:, 1:4]), bounds, st["r2"], k)
    ok = pp >= 0
    assert torch.equal(mask, ok & torch.isfinite(pd))
    assert torch.equal(d2, torch.where(ok, pd, torch.full_like(pd, float("inf"))))
    assert torch.equal(idx, torch.where(ok, st["sorted_idx"][pp.long().clamp(min=0)],
                                        torch.full_like(pp, -1, dtype=torch.int64)))
    assert mask[:, 0].sum() > 100 and not mask[T(~valid)].any()
    if k > 1:
        assert mask[:, k - 1].any()  # some queries fill their whole list
    # duplicated reference points tie: the lower sorted position comes first
    tie = (pd[:, 1:] == pd[:, :-1]) & (pp[:, 1:] >= 0)
    assert k == 1 or (tie.any() and (pp[:, 1:][tie] > pp[:, :-1][tie]).all())
    assert tsg.radius_scan.launches == 0


def _insert(bd, bp, d, j):
    """csrc/radius_scan.cu's insert(), over rows of numpy arrays."""
    for t in range(tsg.KMAX - 1, 0, -1):
        up, here = d < bd[:, t - 1], d < bd[:, t]
        bp[:, t] = np.where(up, bp[:, t - 1], np.where(here, j, bp[:, t]))
        bd[:, t] = np.where(up, bd[:, t - 1], np.where(here, d, bd[:, t]))
    first = d < bd[:, 0]
    bd[first, 0], bp[first, 0] = d[first], j[first] if np.ndim(j) else j


@pytest.mark.parametrize("k", [1, 4, 8])
def test_scan_block_algorithm_equals_the_plain_scan(k):
    """The kernel's algorithm in NumPy: each block visits dx = 0, 1, 2 and
    each of its ranges in ascending position; every query keeps the pairs
    of its own runs in a register list whose empty entries hold the least
    float above r2 (so d < list[-1] is also the radius test), with the
    kernel's stable insertion. Each query must see its positions in
    ascending order (the tie rule rests on it) and end equal to
    radius_scan_plain."""
    ref, q, valid, r, F, X = _scan_case(3)
    st = tsg.scan_prep(T(ref), T(q), r, F, X, X, query_valid=T(valid))
    xyz, qx = st["table"].numpy(), st["q_xyz"].numpy()
    bounds, r2 = st["bounds"].numpy(), np.float32(st["r2"])
    empty = np.nextafter(r2, np.float32(np.inf))
    out_d = np.full((len(qx), k), np.inf, np.float32)
    out_p = np.full((len(qx), k), -1, np.int32)
    for q0, q1, *rng_ in st["plan"].tolist():
        i = np.arange(q0, q1)
        bd = np.where(np.arange(tsg.KMAX) < tsg.KMAX - k, -np.inf, empty).astype(np.float32)
        bd = np.repeat(bd[None], len(i), 0)
        bp = np.full((len(i), tsg.KMAX), -1, np.int64)
        last = np.full(len(i), -1)
        for dx in range(3):
            for j in range(rng_[dx], rng_[3 + dx]):
                diff = qx[i] - xyz[j]
                d = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
                run = (bounds[dx, i] <= j) & (j < bounds[3 + dx, i])
                assert (last[run] < j).all()  # ascending positions
                last[run] = j
                take = run & (d < bd[:, -1])
                if take.any():
                    sub_d, sub_p = bd[take], bp[take]
                    _insert(sub_d, sub_p, d[take], j)
                    bd[take], bp[take] = sub_d, sub_p
        got = bp[:, tsg.KMAX - k:]
        out_p[i] = got
        out_d[i] = np.where(got >= 0, bd[:, tsg.KMAX - k:], np.inf)
    pd, pp = tsg.radius_scan_plain(st["table"], st["q_xyz"], st["bounds"], st["r2"], k)
    assert (pp >= 0).any()
    np.testing.assert_array_equal(out_p, pp.numpy())
    np.testing.assert_array_equal(out_d, pd.numpy())


def test_scan_of_no_queries_gives_empty_results():
    ref = T(np.array([[0, 0.5, 0.0, 0.0], [0, 2.0, 1.0, 0.0]], np.float32))
    st = tsg.scan_prep(ref, T(np.zeros((0, 4), np.float32)), 1.0, F=1, X=8, Y=8)
    assert st["plan"].shape == (0, 8) and st["bounds"].shape == (6, 0)
    idx, d2, mask = tsg.radius_neighbors_sorted(ref, T(np.zeros((0, 4), np.float32)), 1.0, 2,
                                                F=1, X=8, Y=8)
    assert idx.shape == d2.shape == mask.shape == (0, 2)
