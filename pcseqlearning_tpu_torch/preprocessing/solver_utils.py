"""Gradient-descent registration, the GDSolver alternative to Procrustes ICP
(counterpart of pcseqlearning_tpu.preprocessing.solver_utils).

A per-point translation field is fitted by Adam (optax.adam's defaults, a
fixed iteration count, no early stop) to nearest-neighbour correspondences
under a rigidity penalty over the moving cloud's own radius graph; the
per-component rigid transforms then come from a Procrustes fit to the
moved points. Neighbour searches go through ``ops.hash_graph``.
"""

from __future__ import annotations

import torch

from ..ops import geometry, hash_graph, segment_ops
from ..ops.optim import Adam
from .registration import _zero_frame


def _gd_loss_grad(v, moving_xyz, target, corr_ok, nbr, nbr_ok, rigid_weight):
    """(loss, d loss / d v) of the GD objective
        sum_p [corr_ok] |p + v_p - target_p|^2
          + rigid_weight * sum_(p, j) [nbr_ok] |v_p - v_nbr(p, j)|^2,
    the gradient written out (each neighbour pair pushes both ends)."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    r = torch.where(corr_ok[:, None], moving_xyz + v - target, zero)
    e = torch.where(nbr_ok[..., None], v[:, None, :] - v[nbr], zero)  # [N, K, 3]
    loss = (r * r).sum() + rigid_weight * (e * e).sum()
    g = 2.0 * r + (2.0 * rigid_weight) * e.sum(1)
    g = g.index_add(0, nbr.reshape(-1), (-2.0 * rigid_weight) * e.reshape(-1, 3))
    return loss, g


def gd_register(moving_xyz, moving_valid, ref_xyz, ref_valid, radius, rigid_weight=1.0,
                lr=1e-2, num_iters=200):
    """Per-point translation field aligning ``moving`` to ``ref``: Adam on
    the fit to each valid moving point's nearest reference within
    ``radius`` plus the rigidity term over its 8 nearest moving neighbours
    within ``radius``. Returns (velocity_field [N, 3], final_loss)."""
    n, nr = moving_xyz.shape[0], ref_xyz.shape[0]
    mov_f = _zero_frame(moving_xyz)
    ref_grid = hash_graph.build_hash_grid(_zero_frame(ref_xyz), radius, ref_valid)
    corr_idx, _, corr_ok = hash_graph.radius_neighbors(ref_grid, mov_f, radius, 1,
                                                       query_valid=moving_valid)
    target = ref_xyz[torch.clamp(corr_idx[:, 0], 0, nr - 1)]
    self_grid = hash_graph.build_hash_grid(mov_f, radius, moving_valid)
    nbr_idx, _, nbr_ok = hash_graph.radius_neighbors(self_grid, mov_f, radius, 8,
                                                     query_valid=moving_valid)
    args = (moving_xyz, target, corr_ok[:, 0], torch.clamp(nbr_idx, 0, n - 1), nbr_ok,
            rigid_weight)
    v = torch.zeros_like(moving_xyz)
    opt = Adam(v)
    for _ in range(num_iters):
        v = opt.step(v, _gd_loss_grad(v, *args)[1], lr)
    return v, _gd_loss_grad(v, *args)[0]


def gd_register_components(moving_xyz, moving_comp, moving_valid, ref_xyz, ref_valid,
                           num_components, radius, rigid_weight=1.0, lr=1e-2,
                           num_iters=200, num_rounds=4):
    """The config-wired GDSolver: ``num_rounds`` solves of the velocity
    field, each from refreshed correspondences, then one rigid [C, 4, 4]
    transform per component by Procrustes on (p, p + v_p). Returns
    (T [C, 4, 4], l1 [C] mean residual of the rigid fit, ratio [C] 1 for
    non-empty components) in register_to_next_frame's order."""
    C = num_components
    cur = moving_xyz
    for _ in range(num_rounds):
        dv, _ = gd_register(cur, moving_valid, ref_xyz, ref_valid, radius,
                            rigid_weight=rigid_weight, lr=lr, num_iters=num_iters)
        cur = cur + dv
    tgt = moving_xyz + (cur - moving_xyz)
    comp_safe = torch.where(moving_valid & (moving_comp >= 0), moving_comp.long(),
                            torch.full_like(moving_comp, C, dtype=torch.int64))
    cc = torch.clamp(comp_safe, 0, C - 1)
    zero = torch.zeros((), dtype=moving_xyz.dtype, device=moving_xyz.device)
    mc = segment_ops.segment_mean(moving_xyz, comp_safe, C + 1)[:C]
    tc = segment_ops.segment_mean(tgt, comp_safe, C + 1)[:C]
    P = torch.where(moving_valid[:, None], moving_xyz - mc[cc], zero)
    Q = torch.where(moving_valid[:, None], tgt - tc[cc], zero)
    cov = segment_ops.segment_mean(P[:, :, None] * Q[:, None, :], comp_safe, C + 1)[:C]
    R = geometry.procrustes_rotation(cov.transpose(-1, -2))
    t = tc - geometry.mv(R, mc)
    res = torch.linalg.vector_norm(geometry.mv(R[cc], moving_xyz) + t[cc] - tgt, dim=-1)
    l1 = segment_ops.segment_mean(torch.where(moving_valid, res, zero), comp_safe, C + 1)[:C]
    deg = segment_ops.segment_count(comp_safe, C + 1)[:C]
    return geometry.make_rigid(R, t), l1, (deg > 0.5).to(torch.float32)
