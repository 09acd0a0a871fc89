"""Per-component rigid ICP between two frames (counterpart of
pcseqlearning_tpu.preprocessing.registration).

All components are solved together as one [C, 3, 3] Procrustes batch per
ICP iteration. Each iteration takes bidirectional nearest-neighbour
correspondences within the radius from ``_nn1``: a brute-force distance
matrix for tables of at most 2^28 (query, reference) pairs, the spatial
hash grid (``ops.hash_graph``) above that.

Where JAX runs the iterations in one ``lax.while_loop``, the port runs a
Python loop that reads the loss-countdown stop once per iteration; the
iteration count is the JAX loop's. Counters (``utils.telemetry``):
``registration_nn1_brute`` / ``registration_nn1_hash`` count the
correspondence searches by path, ``registration_icp_iterations`` the ICP
iterations, ``registration_icp_calls`` the calls.
"""

from __future__ import annotations

import torch

from ..ops import geometry, hash_graph, segment_ops
from ..ops.sorted_grid import radius_r2
from ..utils import telemetry

# largest (query, reference) pair count that takes the brute-force path
_BRUTE_NN_MAX_ENTRIES = 1 << 28
_CPU_BLOCK_ENTRIES = 1 << 20
_INF = float("inf")


def _zero_frame(xyz):
    return torch.cat([torch.zeros_like(xyz[:, :1]), xyz], dim=1)


def _nn1_brute(ref_xyz, ref_valid, query_xyz, query_valid, radius):
    """Nearest valid reference within ``radius`` of each query by a dense
    distance matrix. The |q|^2 + |r|^2 - 2 q.r expansion about the valid
    references' mean (the cross term one float32 matrix product, TF32 off)
    preselects four candidates in (value, index) order; exact differences
    then pick the first nearest of them.

    Returns (idx [M] int64, d2 [M], ok [M] bool)."""
    m, n = query_xyz.shape[0], ref_xyz.shape[0]
    dev = query_xyz.device
    if n == 0:
        return (torch.zeros(m, dtype=torch.int64, device=dev),
                torch.full((m,), _INF, device=dev), torch.zeros(m, dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=ref_xyz.dtype, device=dev)
    mid = (torch.where(ref_valid[:, None], ref_xyz, zero).sum(0)
           / torch.clamp(ref_valid.sum(), min=1))
    q = query_xyz - mid
    r = ref_xyz - mid
    qn = (q * q).sum(-1)
    rn = (r * r).sum(-1)
    invalid = ~ref_valid[None, :]
    # the card forms the whole matrix at once; the CPU goes in row blocks
    # that stay in cache (rows are independent, the result is the same)
    rows = m if dev.type == "cuda" else max(1, _CPU_BLOCK_ENTRIES // n)
    cand = []
    for i in range(0, m, rows):
        d2 = qn[i:i + rows, None] + rn[None, :]  # (|q|^2 + |r|^2) - 2 q.r, in place
        d2.sub_(torch.matmul(q[i:i + rows], r.t()).mul_(2.0)).masked_fill_(invalid, _INF)
        c = torch.topk(d2, min(4, n), dim=1, largest=False).indices
        # JAX's top_k order: ascending value, equal values by ascending index
        c = torch.sort(c, dim=1).values
        cand.append(torch.gather(c, 1, torch.sort(torch.gather(d2, 1, c), dim=1,
                                                  stable=True).indices))
    cand = torch.cat(cand)
    diff = ref_xyz[cand] - query_xyz[:, None, :]
    d2c = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    d2c = torch.where(ref_valid[cand], d2c, torch.full_like(d2c, _INF))
    d2_exact, best = d2c.min(dim=1, keepdim=True)  # the first minimal candidate
    idx = torch.gather(cand, 1, best)[:, 0]
    d2_exact = d2_exact[:, 0]
    _, r2 = radius_r2(radius)
    return idx, d2_exact, query_valid & ref_valid.any() & (d2_exact <= r2)


def _nn1(ref_xyz, ref_valid, query_xyz, query_valid, radius, cell_cap):
    """Nearest reference within ``radius``: brute force for small tables,
    the hash grid otherwise."""
    m, n = query_xyz.shape[0], ref_xyz.shape[0]
    if m * n <= _BRUTE_NN_MAX_ENTRIES:
        telemetry.add("registration_nn1_brute", 1)
        return _nn1_brute(ref_xyz, ref_valid, query_xyz, query_valid, radius)
    telemetry.add("registration_nn1_hash", 1)
    grid = hash_graph.build_hash_grid(_zero_frame(ref_xyz), radius, ref_valid)
    idx, d2, mask = hash_graph.radius_neighbors(grid, _zero_frame(query_xyz), radius, 1,
                                                query_valid=query_valid, cell_cap=cell_cap)
    return idx[:, 0], d2[:, 0], mask[:, 0]


def register_to_next_frame(moving_xyz, moving_comp, moving_valid, ref_xyz, ref_valid,
                           num_components, radius, angle_regularizer=10.0, max_iter=80,
                           stopping_delta=5e-2, trunc_dist=0.3,
                           cell_cap=hash_graph.DEFAULT_CELL_CAP):
    """Register each component of ``moving`` onto ``ref``.

    Args:
        moving_xyz [Nm, 3], moving_comp [Nm] (component id, -1 = padding),
        moving_valid [Nm]; ref_xyz [Nr, 3], ref_valid [Nr].
        num_components: C. radius: correspondence radius.
        angle_regularizer: weight of the accumulated rotation added to the
            covariance before each Procrustes solve (pulls toward identity).
        max_iter / stopping_delta: stop after three consecutive iterations
            that lower the loss by less than ``stopping_delta``.
        trunc_dist: clamp of the truncated robust mean error.
    Returns:
        T [C, 4, 4] (moving -> ref), l1_error [C], comp_edge_ratio [C]
        (share of a component's points with a forward match at the final
        pose), moved_xyz [Nm, 3].
    """
    C = num_components
    nm, nr = moving_xyz.shape[0], ref_xyz.shape[0]
    dev = moving_xyz.device
    comp_safe = torch.where(moving_valid & (moving_comp >= 0), moving_comp.long(),
                            torch.full_like(moving_comp, C, dtype=torch.int64))
    ci = torch.clamp(comp_safe, 0, C - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iota_m = torch.arange(nm, device=dev)
    iota_r = torch.arange(nr, device=dev)

    def solve(xyz, T):
        f_idx, _, f_ok = _nn1(ref_xyz, ref_valid, xyz, moving_valid, radius, cell_cap)
        b_idx, _, b_ok = _nn1(xyz, moving_valid, ref_xyz, ref_valid, radius, cell_cap)
        e_m = torch.clamp(torch.cat([iota_m, b_idx]), 0, nm - 1)
        e_r = torch.clamp(torch.cat([f_idx, iota_r]), 0, nr - 1)
        e_ok = torch.cat([f_ok, b_ok])
        e_c = torch.where(e_ok, comp_safe[e_m], torch.full_like(e_m, C))
        pm, pr = xyz[e_m], ref_xyz[e_r]
        mc = segment_ops.segment_mean(pm, e_c, C + 1)[:C]
        rc = segment_ops.segment_mean(pr, e_c, C + 1)[:C]
        e_cc = torch.clamp(e_c, 0, C - 1)
        P = torch.where(e_ok[:, None], pm - mc[e_cc], zero)
        Q = torch.where(e_ok[:, None], pr - rc[e_cc], zero)
        dist = torch.where(e_ok, torch.linalg.vector_norm(P - Q, dim=-1), zero)
        l1 = segment_ops.truncated_segment_mean(dist, e_c, C + 1, trunc_dist)[:C]
        loss = (dist * dist).sum()
        cov = segment_ops.segment_mean(P[:, :, None] * Q[:, None, :], e_c, C + 1)[:C]
        # R maximizes tr(R (cov + reg)): Procrustes on the transpose
        R = geometry.procrustes_rotation((cov + T[:, :3, :3] * angle_regularizer)
                                         .transpose(-1, -2))
        return R, rc - geometry.mv(R, mc), l1, loss

    xyz = moving_xyz
    T = torch.eye(4, dtype=torch.float32, device=dev).expand(C, 4, 4)
    l1 = torch.zeros(C, dtype=torch.float32, device=dev)
    sd = torch.tensor(stopping_delta, dtype=torch.float32, device=dev)
    last_loss = torch.tensor(1e10, dtype=torch.float32, device=dev)
    countdown, it = 3, 0
    while countdown > 0 and it < max_iter:
        R, t, l1, loss = solve(xyz, T)
        xyz = geometry.mv(R[ci], xyz) + t[ci]
        T = geometry.mm(geometry.make_rigid(R, t), T)
        countdown = countdown - 1 if bool(last_loss - loss < sd) else 3
        last_loss = loss
        it += 1
    telemetry.add("registration_icp_iterations", it)
    telemetry.add("registration_icp_calls", 1)

    _, _, f_ok = _nn1(ref_xyz, ref_valid, xyz, moving_valid, radius, cell_cap)
    deg = segment_ops.segment_count(comp_safe, C + 1)[:C]
    hits = segment_ops.segment_count(torch.where(f_ok, comp_safe, torch.full_like(comp_safe, C)),
                                     C + 1)[:C]
    return T, l1, hits / (deg + 1e-6), xyz
