"""Spatial-hash fixed-radius neighbour search (counterpart of
pcseqlearning_tpu.ops.hash_graph).

Reference points are binned into 2-D (frame, x, y) columns of edge
``cell_size``; each column hashes into a power-of-two bucket table and the
points are sorted by bucket, so every bucket is one contiguous run. A query
probes its 9 neighbouring columns, scans at most ``cell_cap`` members of
each probe's run, and keeps the k nearest within the radius in its own
frame (z folds into the exact distance test).

The semantics are the JAX module's:
  * the same uint32 spatial hash (the products wrap modulo 2^32; here they
    are formed in int64 from 16-bit halves, so no product overflows) and so
    the same buckets: the same points share a run and the same ones fall
    past ``cell_cap``;
  * the bucket sort is stable (a bucket's rows in ascending row order);
  * probes of one query that collide in a bucket scan its run once (the
    first in probe order);
  * equal distances go to the lower (probe, slot) candidate position;
  * queries run in chunks of at most 32768 rows.

The JAX module is XLA code, not a Pallas kernel; this is PyTorch on the
device the tensors live on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Per-probe scan cap. The JAX package reads PCSEQ_CELL_CAP (default 48) at
# import time; the port takes it from the tracking config's CELL_CAP, which
# convert.config_from_jax fills from that variable.
DEFAULT_CELL_CAP = 48

_H = (2654435761, 73856093, 19349663, 83492791)
_MASK32 = 0xFFFFFFFF
_INVALID_HASH = _MASK32
# the 9 xy-column probes (dx, dy), frame offset always 0
_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
# candidate slots per query chunk: chunk = min(this // (9 * cap), 32768)
_VECTORIZE_MAX_SLOTS = 1 << 25
_INF = float("inf")


def _mul32(c, h):
    """(c * h) mod 2^32 for c in [0, 2^32) and a 32-bit constant h."""
    return ((c & 0xFFFF) * h + ((((c >> 16) * h) & 0xFFFF) << 16)) & _MASK32


def _hash_cells(cells):
    """Spatial hash of integer cell coords [N, 4] -> [N] int64 in [0, 2^32):
    each coordinate taken as uint32, the four wrapped products XORed,
    0xFFFFFFFF (the invalid sentinel) remapped to 0xFFFFFFFE."""
    c = cells.to(torch.int64) & _MASK32
    h = (_mul32(c[:, 0], _H[0]) ^ _mul32(c[:, 1], _H[1]) ^ _mul32(c[:, 2], _H[2])
         ^ _mul32(c[:, 3], _H[3]))
    return torch.where(h == _MASK32, torch.full_like(h, _MASK32 - 1), h)


class HashGrid(NamedTuple):
    """Bucket-sorted spatial-hash table over reference points (rows in
    bucket order in ``sorted_*``; ``offsets`` [T + 2] are the bucket run
    starts, bucket T holding the invalid rows)."""

    sorted_bucket: torch.Tensor  # [N] int64, ascending (T = invalid)
    sorted_idx: torch.Tensor  # [N] int64, original row of each slot
    ref_fxyz: torch.Tensor  # [N, 4] (frame, x, y, z)
    ref_valid: torch.Tensor  # [N] bool
    origin: torch.Tensor  # [3] binning origin (min over valid rows)
    cell: torch.Tensor  # [] cell edge, float32
    sorted_fxyz: torch.Tensor  # [N, 4] ref_fxyz in slot order
    sorted_valid: torch.Tensor  # [N] ref_valid in slot order
    offsets: torch.Tensor  # [T + 2] int64


def _cells_of(fxyz, origin, cell):
    """(frame, cx, cy, 0) cells: lidar point sets are z-thin, so 9 xy-column
    probes cover the radius ball and z folds into the distance test."""
    f = torch.round(fxyz[:, 0]).to(torch.int64)
    cxy = torch.floor((fxyz[:, 1:3] - origin[:2]) / cell).to(torch.int64)
    return torch.stack([f, cxy[:, 0], cxy[:, 1], torch.zeros_like(f)], dim=1)


def _table_size(n):
    """Bucket-table size for an N-row grid: next pow2 of 2N in [2^12, 2^22]."""
    t = 4096
    while t < 2 * n and t < (1 << 22):
        t <<= 1
    return t


def build_hash_grid(ref_fxyz, cell_size, ref_valid=None):
    """Bin and sort reference points [N, 4] (frame, x, y, z) into a
    HashGrid with cell edge ``cell_size`` (the query radius for radius
    searches); ``ref_valid`` [N] masks padded rows."""
    n = ref_fxyz.shape[0]
    dev = ref_fxyz.device
    if ref_valid is None:
        ref_valid = torch.ones(n, dtype=torch.bool, device=dev)
    cell = torch.tensor(float(cell_size), dtype=ref_fxyz.dtype, device=dev)
    masked = torch.where(ref_valid[:, None], ref_fxyz[:, 1:4],
                         torch.tensor(3e38, dtype=ref_fxyz.dtype, device=dev))
    origin = (masked.min(dim=0).values if n else
              torch.zeros(3, dtype=ref_fxyz.dtype, device=dev))
    T = _table_size(n)
    bucket = _hash_cells(_cells_of(ref_fxyz, origin, cell)) & (T - 1)
    bucket = torch.where(ref_valid, bucket, torch.full_like(bucket, T))
    sorted_bucket, sorted_idx = torch.sort(bucket, stable=True)
    counts = torch.bincount(bucket, minlength=T + 1)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)])
    return HashGrid(sorted_bucket, sorted_idx, ref_fxyz, ref_valid, origin, cell,
                    ref_fxyz[sorted_idx], ref_valid[sorted_idx], offsets)


def radius_neighbors(grid: HashGrid, query_fxyz, radius, k, query_valid=None, cell_cap=48):
    """Up to k nearest reference rows within ``radius`` in the query's own
    frame, ascending by distance.

    Returns (ref_idx [M, k] int64 (-1 where none), dist2 [M, k] float32
    (+inf where none), mask [M, k] bool)."""
    m = query_fxyz.shape[0]
    n = grid.sorted_bucket.shape[0]
    T = grid.offsets.shape[0] - 2
    dev = query_fxyz.device
    if query_valid is None:
        query_valid = torch.ones(m, dtype=torch.bool, device=dev)
    r = np.float32(radius)
    r2 = float(r * r)
    best_d = torch.full((m, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.int64, device=dev)
    if n and m:
        # the sorted table padded by cell_cap rows that no query can reach
        n_pad = n + cell_cap
        table = torch.full((n_pad, 4), 3e38, dtype=torch.float32, device=dev)
        table[:n] = grid.sorted_fxyz
        tvalid = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        tvalid[:n] = grid.sorted_valid
        offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)
        ar = torch.arange(cell_cap, device=dev)
        chunk = max(1, min(_VECTORIZE_MAX_SLOTS // (len(_OFFSETS) * cell_cap), 32768))
        for q0 in range(0, m, chunk):
            q = query_fxyz[q0:q0 + chunk]
            mc = q.shape[0]
            probe = _cells_of(q, grid.origin, grid.cell)[None].repeat(len(_OFFSETS), 1, 1)
            probe[..., 1:3] += offs[:, None, :]
            b = (_hash_cells(probe.reshape(-1, 4)) & (T - 1)).reshape(len(_OFFSETS), mc)
            dup = torch.zeros_like(b, dtype=torch.bool)
            for o in range(1, len(_OFFSETS)):
                dup[o] = (b[:o] == b[o][None]).any(dim=0)
            end = grid.offsets[b + 1]
            slots = torch.clamp(grid.offsets[b][..., None] + ar, max=n_pad - 1)  # [9, mc, cap]
            w = table[slots]  # [9, mc, cap, 4]
            dq = w - q[None, :, None, :]
            d2 = dq[..., 1] * dq[..., 1] + dq[..., 2] * dq[..., 2] + dq[..., 3] * dq[..., 3]
            ok = ((slots < end[..., None]) & tvalid[slots] & ~dup[..., None] & (d2 <= r2)
                  & (dq[..., 0].abs() < 0.5))
            # candidates in (probe, slot) order per query
            d2 = torch.where(ok, d2, torch.full_like(d2, _INF)).permute(1, 0, 2).reshape(mc, -1)
            cand = torch.where(ok, slots, torch.full_like(slots, -1))
            cand = cand.permute(1, 0, 2).reshape(mc, -1)
            if k == 1:  # min returns the first minimal position
                vals, pos = d2.min(dim=1, keepdim=True)
            else:  # a stable ascending sort keeps equal distances in position order
                vals, pos = torch.sort(d2, dim=1, stable=True)
                vals, pos = vals[:, :k], pos[:, :k]
            slot = torch.gather(cand, 1, pos)
            best_d[q0:q0 + mc] = vals
            best_i[q0:q0 + mc] = torch.where(slot >= 0, grid.sorted_idx[slot.clamp(0, n - 1)],
                                             torch.full_like(slot, -1))
    mask = torch.isfinite(best_d) & query_valid[:, None]
    return (torch.where(mask, best_i, torch.full_like(best_i, -1)),
            torch.where(mask, best_d, torch.full_like(best_d, _INF)), mask)


def cell_cap_overflow(grid: HashGrid, cell_cap=48):
    """Rows past the per-bucket ``cell_cap`` scan: the sum over valid
    buckets of max(0, count - cell_cap) (0-d int64 tensor)."""
    counts = grid.offsets[1:-1] - grid.offsets[:-2]
    return torch.clamp(counts - cell_cap, min=0).sum()


def radius_graph(ref_fxyz, query_fxyz, radius, k, ref_valid=None, query_valid=None,
                 cell_cap=48):
    """build_hash_grid + radius_neighbors in one call (cell = radius)."""
    grid = build_hash_grid(ref_fxyz, radius, ref_valid)
    return radius_neighbors(grid, query_fxyz, radius, k, query_valid, cell_cap)


def edges_from_neighbors(ref_idx, mask):
    """[M, K] neighbour tables -> (e_ref [M*K], e_query [M*K], e_mask [M*K])."""
    m, k = ref_idx.shape
    e_query = torch.repeat_interleave(torch.arange(m, device=ref_idx.device), k)
    return ref_idx.reshape(-1), e_query, mask.reshape(-1)


def points_in_radius(grid: HashGrid, query_fxyz, radius, query_valid=None, cell_cap=48):
    """[N] bool over the grid's reference rows: within ``radius`` of some
    query (each query reports at most ``cell_cap`` neighbours)."""
    ref_idx, _, mask = radius_neighbors(grid, query_fxyz, radius, cell_cap, query_valid,
                                        cell_cap)
    n = grid.ref_fxyz.shape[0]
    hit = torch.zeros(n + 1, dtype=torch.bool, device=ref_idx.device)
    hit[torch.where(mask, ref_idx, torch.full_like(ref_idx, n)).reshape(-1)] = True
    return hit[:n]


# ---------------------------------------------------------------------------
# exact integer-coordinate lookup
# ---------------------------------------------------------------------------


class CoordTable(NamedTuple):
    sorted_hash: torch.Tensor  # [N] int64 (0xFFFFFFFF = invalid)
    sorted_idx: torch.Tensor  # [N] int64
    coords: torch.Tensor  # [N, 4] integer coords
    valid: torch.Tensor  # [N] bool


def build_coord_table(coords, valid=None):
    """Hash-sorted table of integer coords [N, 4] for ``coord_lookup``."""
    n = coords.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=coords.device)
    h = torch.where(valid, _hash_cells(coords),
                    torch.full((n,), _INVALID_HASH, dtype=torch.int64, device=coords.device))
    sorted_hash, sorted_idx = torch.sort(h, stable=True)
    return CoordTable(sorted_hash, sorted_idx, coords, valid)


def coord_lookup(table: CoordTable, query_coords, query_valid=None, probe_cap=4):
    """Row of the valid reference exactly matching each query coord (-1 if
    none), scanning up to ``probe_cap`` equal-hash slots."""
    m = query_coords.shape[0]
    n = table.sorted_hash.shape[0]
    dev = query_coords.device
    if query_valid is None:
        query_valid = torch.ones(m, dtype=torch.bool, device=dev)
    if n == 0:
        return torch.full((m,), -1, dtype=torch.int64, device=dev)
    h_q = _hash_cells(query_coords)
    start = torch.searchsorted(table.sorted_hash, h_q, side="left")
    slots = start[:, None] + torch.arange(probe_cap, device=dev)
    slots_c = torch.clamp(slots, max=n - 1)
    cand_idx = table.sorted_idx[slots_c]
    ok = ((slots < n) & (table.sorted_hash[slots_c] == h_q[:, None])
          & (table.coords[cand_idx] == query_coords[:, None, :]).all(dim=-1)
          & table.valid[cand_idx] & query_valid[:, None])
    first = ok.to(torch.uint8).argmax(dim=1)  # the first match
    return torch.where(ok.any(dim=1), torch.gather(cand_idx, 1, first[:, None])[:, 0],
                       torch.full((m,), -1, dtype=torch.int64, device=dev))
