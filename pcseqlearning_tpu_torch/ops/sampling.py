"""Brute-force kNN (counterpart of
pcseqlearning_tpu.ops.sampling.knn_bruteforce) — the only sampling op the
ground stage calls (TLS curvature over plane centers)."""

from __future__ import annotations

import torch


def knn_bruteforce(ref_xyz, query_xyz, k, ref_valid=None):
    """Exact kNN: the |q|^2 + |r|^2 - 2 q.r expansion preselects 2k+8
    candidates, whose distances are then recomputed by direct differences.

    Returns (idx [M, k] int64, dist2 [M, k])."""
    n = ref_xyz.shape[0]
    if ref_valid is None:
        ref_valid = torch.ones(n, dtype=torch.bool, device=ref_xyz.device)
    qn = (query_xyz * query_xyz).sum(-1)
    rn = (ref_xyz * ref_xyz).sum(-1)
    cross = (query_xyz[:, None, :] * ref_xyz[None, :, :]).sum(-1)
    d2 = qn[:, None] + rn[None, :] - 2.0 * cross
    inf = torch.tensor(float("inf"), dtype=ref_xyz.dtype, device=ref_xyz.device)
    d2 = torch.where(ref_valid[None, :], d2, inf)
    k2 = min(n, 2 * k + 8)
    cand = torch.topk(-d2, k2, dim=1).indices
    diff = ref_xyz[cand] - query_xyz[:, None, :]
    d2_exact = (diff * diff).sum(-1)
    d2_exact = torch.where(~ref_valid[cand], inf, d2_exact)
    neg, pos = torch.topk(-d2_exact, k, dim=1)
    return torch.gather(cand, 1, pos), -neg
