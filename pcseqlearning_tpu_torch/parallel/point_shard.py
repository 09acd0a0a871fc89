"""The x-sharded radius search and connected components with a halo
exchange (counterpart of pcseqlearning_tpu.parallel.point_shard).

Layout, as in JAX: the host sorts the points by x and splits them into D
slabs of equal count (``shard_points_by_x``). Each slab extracts its
boundary strips (points within the radius of its slab edges, at most
``halo_cap`` each), sends them to its ring neighbours, builds a hash grid
over its own points plus the two halos and queries its own points;
neighbour ids are GLOBAL row ids. The ring's wrap-around halos (slab 0 <->
D - 1) are spatially distant by construction, so the exact distance test
drops them; strip points past ``halo_cap`` are dropped and counted.

Where JAX runs one program under ``shard_map`` over a device mesh, this is
single-controller code over a ``parallel.mesh.Mesh``: stacked [D, N_loc, ...]
tensors go in and [D, ...] come out (on the mesh's first device). Slab d's
local work runs on the mesh's d-th device; the two ``ppermute``s become
copies of the strips to the ring neighbours' devices, the ``all_gather``
copies the concatenated boundary pairs to every device, and the merge runs
replicated on each device. A device may stand for several slabs (one card,
or CPU slots). The local steps are the port's ``ops.hash_graph`` and
``ops.connected_components``; the JAX module's are XLA, not Pallas kernels.
Halo and gather traffic are counted in ``utils.telemetry``
(``shard_halo_bytes``, ``shard_gather_bytes``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import connected_components as cc
from ..ops import hash_graph
from ..utils import telemetry

_BIG = 2 ** 31 - 1
_FAR = 1e8


def shard_points_by_x(fxyz, num_shards, radius=None):
    """Host prep: x-sort and split into equal-count slabs.

    Returns (points [D, N_loc, 4], gids [D, N_loc] int32, valid [D, N_loc]),
    NumPy; ``gids[d, i]`` is the original row of each slot, -1 for padding
    (padding rows sit at 1e8). With ``radius``, raises ValueError unless
    every slab is wider than it: halos come only from the ring neighbours,
    so a thinner slab would drop true neighbours two slabs away."""
    n = len(fxyz)
    order = np.argsort(fxyz[:, 1], kind="stable").astype(np.int64)
    n_loc = -(-n // num_shards)
    pad = num_shards * n_loc - n
    if radius is not None and num_shards > 1 and n >= num_shards:
        xs = fxyz[order, 1]
        bounds = xs[[min(d * n_loc, n - 1) for d in range(num_shards)] + [n - 1]]
        widths = np.diff(bounds)
        if (widths <= radius).any():
            raise ValueError(
                f"x-slab widths {widths.tolist()} must all exceed the query "
                f"radius {radius}: dense regions make immediate-neighbor halo "
                "exchange incomplete — use fewer shards or width-based slabs"
            )
    fxyz_s = np.concatenate([fxyz[order], np.full((pad, fxyz.shape[1]), _FAR, fxyz.dtype)])
    gids = np.concatenate([order, np.full(pad, -1, np.int64)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return (fxyz_s.reshape(num_shards, n_loc, -1),
            gids.reshape(num_shards, n_loc).astype(np.int32),
            valid.reshape(num_shards, n_loc))


def _compact_strip(points, ids, sel, cap):
    """The first ``cap`` rows of a stable sort that puts the selected rows
    first: (points, ids, sel) of those rows."""
    take = torch.argsort((~sel).to(torch.uint8), stable=True)[:cap]
    return points[take], ids[take], sel[take]


def _slabs(points, gids, valid, devices):
    """Slab d of each stacked input on devices[d]."""
    as_t = torch.as_tensor
    return [(as_t(points[d]).to(dev), as_t(gids[d]).to(dev).to(torch.int32),
             as_t(valid[d]).to(dev)) for d, dev in enumerate(devices)]


def _strips(pts, ids, val, radius, halo_cap):
    """A slab's boundary strips: (left_sel, right_sel, left strip, right
    strip, truncated count), each strip (points, ids, valid)."""
    x = pts[:, 1]
    r = torch.tensor(radius, dtype=pts.dtype, device=pts.device)
    xmin = torch.where(val, x, torch.full_like(x, _FAR)).min()
    xmax = torch.where(val, x, torch.full_like(x, -_FAR)).max()
    left_sel = val & (x <= xmin + r)
    right_sel = val & (x >= xmax - r)
    n_trunc = (torch.clamp(left_sel.sum() - halo_cap, min=0)
               + torch.clamp(right_sel.sum() - halo_cap, min=0))
    return (left_sel, right_sel, _compact_strip(pts, ids, left_sel, halo_cap),
            _compact_strip(pts, ids, right_sel, halo_cap), n_trunc)


def _exchange(strips, devices):
    """The ring exchange: slab d receives slab d - 1's right strip (its
    left halo) and slab d + 1's left strip (its right halo), copied to its
    device. Returns [(halo_left, halo_right)] per slab."""
    D = len(devices)
    out = []
    for d, dev in enumerate(devices):
        from_left = tuple(t.to(dev) for t in strips[(d - 1) % D][3])
        from_right = tuple(t.to(dev) for t in strips[(d + 1) % D][2])
        out.append((from_left, from_right))
    nbytes = sum(t.numel() * t.element_size() for s in strips for strip in s[2:4] for t in strip)
    telemetry.add("shard_halo_bytes", nbytes)
    return out


def _with_halos(slab, halos):
    (pts, ids, val), (hl, hr) = slab, halos
    return (torch.cat([pts, hl[0], hr[0]]), torch.cat([ids, hl[1], hr[1]]),
            torch.cat([val, hl[2], hr[2]]))


def sharded_radius_neighbors(points, gids, valid, radius, mesh, axis="dp", k=16,
                             halo_cap=4096, cell_cap=48):
    """Radius k-NN over an x-sharded point table.

    points [D, N_loc, 4] (frame, x, y, z), gids [D, N_loc] global row ids,
    valid [D, N_loc], tensors or arrays. Returns (neighbor_gids [D, N_loc,
    k] (-1 where none), dist2, mask, num_halo_truncated [D]: per slab, the
    strip points past ``halo_cap`` that its halos dropped), on the mesh's
    first device."""
    devices = mesh.axis_devices(axis)
    D = len(devices)
    slabs = _slabs(points, gids, valid, devices)
    if D == 1:
        # one slab: the ring would hand the slab its own strips (duplicate
        # points in its grid), so query the slab alone
        pts, ids, val = slabs[0]
        idx, d2, mask = hash_graph.radius_graph(pts, pts, radius, k, ref_valid=val,
                                                query_valid=val, cell_cap=cell_cap)
        out = torch.where(mask, ids[idx.clamp(0, pts.shape[0] - 1)], torch.full_like(ids[:1], -1))
        return out[None], d2[None], mask[None], torch.zeros(1, dtype=torch.int64,
                                                            device=devices[0])
    strips = [_strips(*s, radius, halo_cap) for s in slabs]
    halos = _exchange(strips, devices)
    res = []
    for slab, h in zip(slabs, halos):
        pts, _, val = slab
        all_pts, all_ids, all_val = _with_halos(slab, h)
        grid = hash_graph.build_hash_grid(all_pts, radius, all_val)
        idx, d2, mask = hash_graph.radius_neighbors(grid, pts, radius, k, query_valid=val,
                                                    cell_cap=cell_cap)
        n_all = all_pts.shape[0]
        out = torch.where(mask, all_ids[idx.clamp(0, n_all - 1)], torch.full_like(all_ids[:1], -1))
        res.append((out, d2, mask))
    first = devices[0]
    return tuple(torch.stack([r[i].to(first) for r in res]) for i in range(3)) + (
        torch.stack([s[4].to(first) for s in strips]),)


def _rank_in_sorted(sorted_vals, queries):
    """Dense rank of each query in a sorted array (first-occurrence index
    compression): (rank [Q], -1 where absent; found [Q])."""
    pos = torch.searchsorted(sorted_vals, queries, side="left")
    pos = pos.clamp(0, sorted_vals.shape[0] - 1)
    found = sorted_vals[pos] == queries
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=sorted_vals.device),
                       sorted_vals[1:] != sorted_vals[:-1]])
    dense = torch.cumsum(first.to(torch.int64), 0) - 1
    return torch.where(found, dense[pos], torch.full_like(pos, -1)), found


def _merge_table(allp):
    """The replicated merge over all boundary pairs allp [P, 2] (gid,
    local root gid; -1 rows padded): (svals, final root gid of each dense
    rank). Ranks follow the sorted gid order, so a merged component's least
    label is its least gid."""
    dev = allp.device
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    pmask = allp[:, 0] >= 0
    vals = torch.where(pmask.repeat(2), torch.cat([allp[:, 0], allp[:, 1]]), big)
    svals = torch.sort(vals, stable=True).values
    r_g, _ = _rank_in_sorted(svals, torch.where(pmask, allp[:, 0], big))
    r_r, _ = _rank_in_sorted(svals, torch.where(pmask, allp[:, 1], big))
    n_small = svals.shape[0]
    mlab = cc.connected_components(r_g, r_r, n_small, e_mask=pmask)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), svals[1:] != svals[:-1]])
    node_gid = torch.full((n_small,), _BIG, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.cumsum(first.to(torch.int64), 0) - 1, svals, "amin")
    return svals, node_gid[mlab.long()]


def sharded_connected_components(points, gids, valid, radius, mesh, axis="dp", k=16,
                                 halo_cap=4096, cell_cap=48):
    """Connected components of the k-capped radius graph over an x-sharded
    point table, by local CC and a boundary merge:

    1. each slab builds its local + halo table (the ring exchange of
       ``sharded_radius_neighbors``), labels the WHOLE table by kNN-graph
       label propagation and maps each root slot to its global id;
    2. every strip and halo point gives a pair (gid, local root gid); the
       pairs of all slabs are gathered to every device, where a replicated
       merge compacts the gids by sort and dense rank, labels the (point,
       root) pair graph by edge-list CC and takes each merged component's
       least gid;
    3. each slab's points re-root through that table (a component that
       touches no slab boundary keeps its local root).

    Every edge of the global graph is covered: an edge inside a slab is
    local to it, and a cross-slab edge (u, v) has u inside v's boundary
    strip (slabs are wider than the radius), so it is a local-halo edge of
    v's slab. With no halo truncation the partition equals the single-table
    CC's. Returns (root_gid [D, N_loc] int32, -1 for padding;
    num_halo_truncated [D]) on the mesh's first device."""
    devices = mesh.axis_devices(axis)
    D = len(devices)
    slabs = _slabs(points, gids, valid, devices)
    if D == 1:
        pts, ids, val = slabs[0]
        idx, _, mask = hash_graph.radius_graph(pts, pts, radius, k, ref_valid=val,
                                               query_valid=val, cell_cap=cell_cap)
        lab = cc.connected_components_knn(idx, mask)
        root = torch.where(val, ids[lab.long()], torch.full_like(ids, -1))
        return root[None], torch.zeros(1, dtype=torch.int64, device=devices[0])
    strips = [_strips(*s, radius, halo_cap) for s in slabs]
    halos = _exchange(strips, devices)
    local, pairs = [], []
    for slab, strip, h in zip(slabs, strips, halos):
        pts, ids, val = slab
        n_loc = pts.shape[0]
        left_sel, right_sel, (_, _, lv), (_, _, rv), _ = strip
        all_pts, all_ids, all_val = _with_halos(slab, h)
        grid = hash_graph.build_hash_grid(all_pts, radius, all_val)
        idx, _, mask = hash_graph.radius_neighbors(grid, all_pts, radius, k,
                                                   query_valid=all_val, cell_cap=cell_cap)
        lab = cc.connected_components_knn(idx, mask).long()
        root_gid = torch.where(all_val, all_ids[lab], torch.full_like(all_ids, -1))
        slots = torch.arange(n_loc, device=pts.device)
        n_halo = h[0][2].shape[0] + h[1][2].shape[0]
        strip_slots = torch.cat([
            _compact_strip(slots, slots, left_sel, halo_cap)[0],
            _compact_strip(slots, slots, right_sel, halo_cap)[0],
            torch.arange(n_loc, n_loc + n_halo, device=pts.device)])
        strip_ok = torch.cat([lv, rv, h[0][2], h[1][2]])
        neg = torch.full_like(strip_slots, -1, dtype=torch.int32)
        pg = torch.where(strip_ok, all_ids[strip_slots], neg)
        pr = torch.where(strip_ok, root_gid[strip_slots], neg)
        pairs.append(torch.stack([pg, pr], dim=1))  # [4H, 2]
        local.append(root_gid[:n_loc])
    telemetry.add("shard_gather_bytes", D * sum(p.numel() * p.element_size() for p in pairs))
    merged = []
    for d, dev in enumerate(devices):
        allp = torch.cat([p.to(dev) for p in pairs])  # the all_gather: [4H * D, 2]
        svals, final_of_node = _merge_table(allp)
        my_root, val = local[d], slabs[d][2]
        big = torch.full_like(my_root, _BIG)
        rr, found = _rank_in_sorted(svals, torch.where(val, my_root, big))
        n_small = svals.shape[0]
        merged.append(torch.where(found & val, final_of_node[rr.clamp(0, n_small - 1)],
                                  my_root).to(torch.int32))
    first = devices[0]
    return (torch.stack([m.to(first) for m in merged]),
            torch.stack([s[4].to(first) for s in strips]))
