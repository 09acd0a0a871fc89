"""Sorted-grid neighbour search: exact radius connected components and the
radius k-NN scan (counterpart of pcseqlearning_tpu.ops.pallas_scan).

Points are sorted by the linear cell key L = (frame * X + cx) * Y + cy at
cell size = radius, so every neighbour of a query lies in three contiguous
runs of the sorted table: columns cx-1, cx, cx+1, each spanning rows
cy-1..cy+1. The prep (plain PyTorch, as the XLA prep was) computes the
sort, the cell offsets and each query's three [start, end) run bounds; two
hand-written CUDA kernels then walk the runs:

  * ``cc_round`` (csrc/cc_round.cu, replaces ``_cc_kernel``): one
    label-propagation round, the min label over in-radius run members.
    ``connected_components_radius`` repeats it with five pointer-jump hops
    per round, at most 24 rounds, as ``_cc_rounds`` did.
  * ``radius_scan`` (csrc/radius_scan.cu, replaces ``_scan_kernel``): the
    k nearest in-radius run members, ascending, ties to the lower sorted
    position, padded with +inf / -1. Its prep sorts the queries by cell, as
    the XLA prep did, and ``radius_neighbors_sorted`` returns the results
    in the caller's order.

Both kernels work in blocks of consecutive sorted rows of one column whose
runs' union ranges ``block_plan`` computes in the prep (once per CC chunk,
once per scan).

The TPU kernels copied a fixed union window per block of 256 queries and
counted the blocks whose runs outgrew it; the CUDA kernels walk whole runs,
so nothing is truncated and the truncation counters are 0 by construction.

On CPU tensors each wrapper runs its plain PyTorch version; on CUDA tensors
it launches its kernel and counts the launch (``cc_round.launches``,
``radius_scan.launches``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import cuda_build

_BIGI = 2 ** 31 - 1
_PAIR_BUDGET = 1 << 24  # (query, run member) pairs per plain-version chunk
# rows per plan block: the threads of a cc_round or radius_scan block
# (CC_THREADS, SCAN_THREADS in csrc/)
PLAN_BLOCK = 128


def radius_r2(radius):
    """(radius, r2) as float32 values, r2 rounded like radius * radius in f32."""
    r = np.float32(radius)
    return float(r), float(r * r)


def _cell_ids(fxyz, origin, inv_cell, f_min):
    f = torch.round(fxyz[:, 0]).to(torch.int64) - f_min
    cx = torch.floor((fxyz[:, 1] - origin[0]) * inv_cell).to(torch.int64)
    cy = torch.floor((fxyz[:, 2] - origin[1]) * inv_cell).to(torch.int64)
    return f, cx, cy


def _grid(ref_fxyz, ref_valid, radius, F, X, Y):
    """Sorted reference table of the grid: origin, cell ids, sort order and
    the cell offsets [L + 2] (refs outside the F x X x Y grid sort last and
    belong to no run)."""
    dev = ref_fxyz.device
    r, _ = radius_r2(radius)
    inv_cell = 1.0 / torch.tensor(r, dtype=torch.float32, device=dev)
    big = torch.tensor(3e38, dtype=ref_fxyz.dtype, device=dev)
    origin = torch.where(ref_valid[:, None], ref_fxyz[:, 1:3], big).min(dim=0).values
    f_all = torch.round(ref_fxyz[:, 0]).to(torch.int64)
    f_min = torch.where(ref_valid, f_all, torch.full_like(f_all, _BIGI)).min()
    rf, rcx, rcy = _cell_ids(ref_fxyz, origin, inv_cell, f_min)
    in_grid = (ref_valid & (rf >= 0) & (rf < F) & (rcx >= 0) & (rcx < X)
               & (rcy >= 0) & (rcy < Y))
    L = F * X * Y
    rlin = torch.where(in_grid, (rf * X + rcx) * Y + rcy, torch.full_like(rf, L))
    sorted_idx = torch.sort(rlin, stable=True).indices
    counts = torch.bincount(rlin, minlength=L + 1)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return dict(origin=origin, inv_cell=inv_cell, f_min=f_min, rf=rf, rcx=rcx,
                rcy=rcy, in_grid=in_grid, sorted_idx=sorted_idx, offsets=offsets)


def _probe_bounds(qf, qcx, qcy, q_in, offsets, F, X, Y):
    """[6, M] int32: run starts (rows 0-2) and ends (rows 3-5) of the three
    probe columns cx-1, cx, cx+1; probes off the grid get empty runs."""
    dxs = torch.tensor([-1, 0, 1], dtype=torch.int64, device=qf.device)
    cxd = qcx[None, :] + dxs[:, None]
    probe_ok = (q_in[None, :] & (cxd >= 0) & (cxd < X)
                & (qcy[None, :] >= -1) & (qcy[None, :] <= Y))
    lo_cy = torch.clamp(qcy - 1, 0, Y - 1)[None, :]
    hi_cy = torch.clamp(qcy + 1, 0, Y - 1)[None, :]
    cxd_c = torch.clamp(cxd, 0, X - 1)
    f_c = torch.clamp(qf, 0, F - 1)[None, :]
    start = offsets[(f_c * X + cxd_c) * Y + lo_cy]
    end = offsets[(f_c * X + cxd_c) * Y + hi_cy + 1]
    zero = torch.zeros_like(start)
    return torch.cat([torch.where(probe_ok, start, zero),
                      torch.where(probe_ok, end, zero)]).to(torch.int32).contiguous()


def _query_chunks(bounds, budget=_PAIR_BUDGET):
    """Query ranges [i0, i1) whose runs hold about ``budget`` pairs each."""
    m = bounds.shape[1]
    if m == 0:
        return []
    lens = (bounds[3:].long() - bounds[:3].long()).clamp(min=0).sum(0)
    csum = torch.cumsum(lens, 0)
    total = int(csum[-1])
    cuts = [0]
    if total > budget:
        targets = torch.arange(budget, total, budget, device=csum.device)
        cuts += torch.searchsorted(csum, targets, right=True).tolist()
    cuts.append(m)
    cuts = sorted(set(cuts))
    return list(zip(cuts[:-1], cuts[1:]))


def _run_pairs(bounds, i0, i1):
    """(query, sorted position) pairs of the runs of queries [i0, i1)."""
    st = bounds[:3, i0:i1].long()
    lens = (bounds[3:, i0:i1].long() - st).clamp(min=0).reshape(-1)
    qi = torch.arange(i0, i1, device=bounds.device).repeat(3)
    q = torch.repeat_interleave(qi, lens)
    first = torch.cumsum(lens, 0) - lens
    base = torch.repeat_interleave(st.reshape(-1) - first, lens)
    return q, base + torch.arange(q.shape[0], device=bounds.device)


def _pair_d2(q_xyz, ref_xyz, q, j):
    dx = q_xyz[q, 0] - ref_xyz[j, 0]
    dy = q_xyz[q, 1] - ref_xyz[j, 1]
    dz = q_xyz[q, 2] - ref_xyz[j, 2]
    return dx * dx + dy * dy + dz * dz


# ---------------------------------------------------------------------------
# kernel 1: one CC label-propagation round
# ---------------------------------------------------------------------------


def cc_round_plain(xyz, labels, bounds, r2):
    """out[i] = min(labels[i], labels[j] for j in i's runs with d2 <= r2)."""
    out = labels.clone()
    for i0, i1 in _query_chunks(bounds):
        q, j = _run_pairs(bounds, i0, i1)
        ok = _pair_d2(xyz, xyz, q, j) <= r2
        out.scatter_reduce_(0, q[ok], labels[j[ok]], "amin", include_self=True)
    return out


def _cc_launcher():
    fn = cuda_build.load("cc_round.cu").cc_round_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p, p]
        fn.restype = ctypes.c_int
    return fn


def cc_round(xyz, labels, bounds, r2, plan):
    """One round over the sorted slots: xyz [m, 3] f32, labels [m] i32,
    bounds [6, m] i32, r2 float, plan [nb, 8] i32 (``block_plan``: the
    kernel's blocks; the plain version needs none) -> new labels [m] i32."""
    if xyz.device.type == "cpu":
        return cc_round_plain(xyz, labels, bounds, r2)
    if xyz.device.type != "cuda":
        raise ValueError(f"cc_round: unsupported device {xyz.device}")
    m = labels.shape[0]
    dev = xyz.device
    cuda_build.require(xyz, "xyz", torch.float32, (m, 3), dev)
    cuda_build.require(labels, "labels", torch.int32, (m,), dev)
    cuda_build.require(bounds, "bounds", torch.int32, (6, m), dev)
    cuda_build.require(plan, "plan", torch.int32, (plan.shape[0], 8), dev)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out
    fn = _cc_launcher()
    with torch.cuda.device(dev):
        code = fn(xyz.data_ptr(), labels.data_ptr(), bounds.data_ptr(), plan.data_ptr(),
                  plan.shape[0], PLAN_BLOCK, m, r2, out.data_ptr(), cuda_build.stream_of(xyz))
    cuda_build.check(code, "cc_round")
    cc_round.launches += 1
    return out


cc_round.launches = 0


def block_plan(column, bounds):
    """The block plan of the cc_round and radius_scan kernels over m rows
    sorted by cell (CC slots or scan queries): [nb, 8] int32 rows (row0,
    row1, lo0, lo1, lo2, hi0, hi1, hi2).

    Blocks are runs of at most PLAN_BLOCK consecutive rows of one column
    (``column`` [m], non-decreasing along the rows: frame * X + cx, with
    the rows outside the grid in a column of their own). For probe column
    dx the block's non-empty runs all lie in [lo_dx, hi_dx), their smallest
    start and largest end ((0, 0) where every run is empty). Within a
    column of CC slots, run starts and ends do not decrease with the slot,
    so the ranges are as narrow as the runs; queries one cell off the grid,
    sorted into an edge column, only widen their block's ranges. Runs
    cleared to (0, 0) at the grid's edge and runs over empty cells take no
    part. Rows come heaviest first (rows times range lengths), so that the
    kernel starts its longest blocks first."""
    m = column.shape[0]
    dev = column.device
    idx = torch.arange(m, device=dev)
    col_first = torch.searchsorted(column, column)  # each row's column starts here
    row0 = idx[(idx - col_first) % PLAN_BLOCK == 0]
    row1 = torch.cat([row0[1:], row0.new_full((1,), m)])[:row0.shape[0]]
    # each block's rows as [nb, PLAN_BLOCK], a short block repeating its
    # last row (which moves neither the min nor the max)
    rows = torch.minimum(row0[:, None] + torch.arange(PLAN_BLOCK, device=dev), row1[:, None] - 1)
    st, en = bounds[:3, rows], bounds[3:, rows]
    nonempty = en > st
    big = torch.iinfo(torch.int32).max
    lo = torch.where(nonempty, st, big).amin(2)
    hi = torch.where(nonempty, en, 0).amax(2)
    lo = torch.where(lo == big, 0, lo)
    row0, row1 = row0.to(torch.int32), row1.to(torch.int32)
    plan = torch.cat([row0[None], row1[None], lo, hi]).T
    work = (row1 - row0).long() * (hi - lo).long().sum(0)
    return plan[torch.argsort(work, descending=True, stable=True)].contiguous()


def cc_prep(fxyz, valid, radius, F, X, Y):
    """Sort, offsets, per-slot probe bounds and the kernel's block plan of one
    chunk (the counterpart of ``_cc_prep``). Returns the state consumed by
    ``cc_rounds``, whose rounds all reuse it."""
    n = fxyz.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=fxyz.device)
    g = _grid(fxyz, valid, radius, F, X, Y)
    si = g["sorted_idx"]
    in_grid = g["in_grid"][si]
    bounds = _probe_bounds(g["rf"][si], g["rcx"][si], g["rcy"][si], in_grid,
                           g["offsets"], F, X, Y)
    column = torch.where(in_grid, g["rf"][si] * X + g["rcx"][si],
                         torch.full_like(si, F * X))
    return dict(sorted_xyz=fxyz[si, 1:4].to(torch.float32).contiguous(), sorted_idx=si,
                node_ok=valid[si], bounds=bounds, plan=block_plan(column, bounds),
                r2=radius_r2(radius)[1])


def cc_rounds(state, max_rounds=24):
    """Label propagation to convergence (at most ``max_rounds`` kernel
    rounds, five pointer-jump hops after each; one host read per round),
    then dense component ids in the caller's row order.

    Returns (component [n] int32 with -1 for invalid rows, num_components)."""
    xyz, bounds, r2, plan = state["sorted_xyz"], state["bounds"], state["r2"], state["plan"]
    si, node_ok = state["sorted_idx"], state["node_ok"]
    m = xyz.shape[0]
    slots = torch.arange(m, dtype=torch.int32, device=xyz.device)
    labels = slots
    for _ in range(max_rounds):
        new = cc_round(xyz, labels, bounds, r2, plan)
        for _ in range(5):
            new = new[new.long()]
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    is_root = (labels == slots) & node_ok
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    comp_slot = torch.where(node_ok, rank[labels.long()], torch.full_like(rank, -1))
    component = torch.empty(m, dtype=torch.int32, device=xyz.device)
    component[si] = comp_slot
    return component, int(is_root.sum())


def connected_components_radius(fxyz, valid, radius, F, X, Y, max_rounds=24):
    """Exact connected components of the same-frame radius graph over
    (frame, x, y, z) rows; F, X, Y bound the cell grid (rows outside it are
    singletons). Returns (component [N] int32, -1 for invalid rows;
    num_components)."""
    return cc_rounds(cc_prep(fxyz, valid, radius, F, X, Y), max_rounds=max_rounds)


# ---------------------------------------------------------------------------
# kernel 3: radius k-NN scan
# ---------------------------------------------------------------------------

KMAX = 8


def radius_scan_plain(ref_xyz, q_xyz, bounds, r2, k):
    """k smallest d2 <= r2 over each query's runs, ascending, ties to the
    lower sorted position: (d2 [m, k] f32 +inf pads, pos [m, k] i32 -1 pads)."""
    m = q_xyz.shape[0]
    out_d = torch.full((m, k), float("inf"), dtype=torch.float32, device=q_xyz.device)
    out_p = torch.full((m, k), -1, dtype=torch.int32, device=q_xyz.device)
    for i0, i1 in _query_chunks(bounds):
        q, j = _run_pairs(bounds, i0, i1)
        d2 = _pair_d2(q_xyz, ref_xyz, q, j)
        ok = d2 <= r2
        q, j, d2 = q[ok], j[ok], d2[ok]
        order = j.argsort(stable=True)
        order = order[d2[order].argsort(stable=True)]
        order = order[q[order].argsort(stable=True)]
        q, j, d2 = q[order], j[order], d2[order]
        rank = torch.arange(q.shape[0], device=q.device) - torch.searchsorted(q, q)
        keep = rank < k
        out_d[q[keep], rank[keep]] = d2[keep]
        out_p[q[keep], rank[keep]] = j[keep].to(torch.int32)
    return out_d, out_p


def _scan_launcher():
    fn = cuda_build.load("radius_scan.cu").radius_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def radius_scan(ref_xyz, q_xyz, bounds, r2, k, plan):
    """ref_xyz [n, 3] f32 (sorted table), q_xyz [m, 3] f32 (queries sorted
    by cell), bounds [6, m] i32, r2 float, k <= 8, plan [nb, 8] i32
    (``block_plan`` over the sorted queries: the kernel's blocks; the plain
    version needs none) -> (d2 [m, k] f32, sorted positions [m, k] i32)."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"radius_scan: k={k} outside 1..{KMAX}")
    if q_xyz.device.type == "cpu":
        return radius_scan_plain(ref_xyz, q_xyz, bounds, r2, k)
    if q_xyz.device.type != "cuda":
        raise ValueError(f"radius_scan: unsupported device {q_xyz.device}")
    if not math.isfinite(r2):  # the kernel's radius test is d2 < nextafter(r2, +inf)
        raise ValueError(f"radius_scan: r2={r2} must be finite")
    n, m = ref_xyz.shape[0], q_xyz.shape[0]
    dev = q_xyz.device
    cuda_build.require(ref_xyz, "ref_xyz", torch.float32, (n, 3), dev)
    cuda_build.require(q_xyz, "q_xyz", torch.float32, (m, 3), dev)
    cuda_build.require(bounds, "bounds", torch.int32, (6, m), dev)
    cuda_build.require(plan, "plan", torch.int32, (plan.shape[0], 8), dev)
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m == 0:
        return out_d, out_p
    fn = _scan_launcher()
    with torch.cuda.device(dev):
        code = fn(ref_xyz.data_ptr(), q_xyz.data_ptr(), bounds.data_ptr(), plan.data_ptr(),
                  plan.shape[0], PLAN_BLOCK, m, r2, k, out_d.data_ptr(), out_p.data_ptr(),
                  cuda_build.stream_of(q_xyz))
    cuda_build.check(code, "radius_scan")
    radius_scan.launches += 1
    return out_d, out_p


radius_scan.launches = 0


def scan_prep(ref_fxyz, query_fxyz, radius, F, X, Y, ref_valid=None, query_valid=None):
    """Sorted reference table, the queries sorted by cell with their run
    bounds, and the kernel's block plan (the counterpart of the XLA prep of
    ``radius_neighbors_sorted``). Queries are ordered stably by the JAX
    key (frame, clip(cx), clip(cy)); queries outside the frames or invalid
    take the key L = F * X * Y and sort last, with empty runs. ``q_order``
    [m] is the caller's row of each sorted query."""
    dev = ref_fxyz.device
    if ref_valid is None:
        ref_valid = torch.ones(ref_fxyz.shape[0], dtype=torch.bool, device=dev)
    if query_valid is None:
        query_valid = torch.ones(query_fxyz.shape[0], dtype=torch.bool, device=dev)
    g = _grid(ref_fxyz, ref_valid, radius, F, X, Y)
    qf, qcx, qcy = _cell_ids(query_fxyz, g["origin"], g["inv_cell"], g["f_min"])
    q_in = query_valid & (qf >= 0) & (qf < F)
    # the key in int32, as the JAX prep computes it: (column * Y + clip(cy)),
    # L = (F * X) * Y for the queries outside the frames
    column = torch.where(q_in, qf * X + torch.clamp(qcx, 0, X - 1),
                         torch.full_like(qf, F * X)).to(torch.int32)
    key = column * Y + torch.clamp(qcy, 0, Y - 1).to(torch.int32) * q_in
    q_order = torch.sort(key, stable=True).indices
    bounds = _probe_bounds(qf, qcx, qcy, q_in, g["offsets"], F, X, Y)[:, q_order]
    column = column[q_order]
    return dict(
        table=ref_fxyz[g["sorted_idx"], 1:4].to(torch.float32).contiguous(),
        sorted_idx=g["sorted_idx"],
        q_xyz=query_fxyz[q_order, 1:4].to(torch.float32).contiguous(),
        bounds=bounds, plan=block_plan(column, bounds), q_order=q_order,
        r2=radius_r2(radius)[1], query_valid=query_valid,
    )


def radius_neighbors_sorted(ref_fxyz, query_fxyz, radius, k, F, X, Y,
                            ref_valid=None, query_valid=None):
    """K nearest same-frame neighbours within ``radius``.

    Returns (ref_idx [M, k] int64 with -1 pads, dist2 [M, k] f32 with +inf
    pads, mask [M, k] bool) in the caller's query order, neighbours
    ascending by distance. F, X, Y bound the cell grid as in the JAX
    version (cells outside it have no candidates)."""
    st = scan_prep(ref_fxyz, query_fxyz, radius, F, X, Y, ref_valid, query_valid)
    d2, pos = radius_scan(st["table"], st["q_xyz"], st["bounds"], st["r2"], k, st["plan"])
    # the one unsort: sorted query i is the caller's row q_order[i]
    d2 = torch.empty_like(d2).index_copy_(0, st["q_order"], d2)
    pos = torch.empty_like(pos).index_copy_(0, st["q_order"], pos)
    ok = (pos >= 0) & torch.isfinite(d2) & st["query_valid"][:, None]
    ref_idx = torch.where(ok, st["sorted_idx"][pos.long().clamp(min=0)],
                          torch.full_like(pos, -1, dtype=torch.int64))
    dist2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    return ref_idx, dist2, ok
