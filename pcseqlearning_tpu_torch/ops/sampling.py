"""Point sampling (counterpart of pcseqlearning_tpu.ops.sampling): farthest
point sampling, and the brute-force kNN that the ground stage calls (TLS
curvature over plane centers) and PointNet++'s feature propagation, with
a stable top-k. Plain PyTorch, as the JAX module is XLA.
"""

from __future__ import annotations

import torch

from ..utils.profiler import span


def batched_farthest_point_sample(xyz, num_samples, valid=None):
    """Farthest point sampling of B point sets at once: xyz [B, N, 3] (or
    one [N, 3] table that every row of ``valid`` [B, N] masks) -> [B, S]
    int64 indices.

    Each row runs the JAX function's loop: the first valid point first;
    then, S - 1 times, every valid point's distance to the picks so far is
    the min of its old value and its squared distance to the last pick,
    and the next pick is the first point of the largest (points that are
    not valid hold -inf, which the min keeps, so they are never farthest
    while a valid point is left; once every valid point is picked the
    picks repeat). The squared distance is dx * dx + dy * dy + dz * dz in
    that order, one rounding each (eager ops: no fused multiply-add on the
    card), and ``torch.argmax`` takes the first of equal maxima, as
    ``jnp.argmax``. The B loops run as one loop over a [B, N] table, with
    no host read, eight launches an iteration. A call is one
    ``utils.profiler`` span, ``fps``."""
    with span("fps"):
        return _fps(xyz, num_samples, valid)


def _fps(xyz, num_samples, valid):
    if xyz.dim() == 2:
        xyz = xyz[None]
    b = xyz.shape[0] if valid is None else valid.shape[0]
    n = xyz.shape[1]
    dev = xyz.device
    if valid is None:
        valid = torch.ones(b, n, dtype=torch.bool, device=dev)
    table = xyz.expand(b, n, 3)
    flat = table.reshape(b * n, 3)
    inf = torch.tensor(float("inf"), dtype=xyz.dtype, device=dev)
    dist = torch.where(valid, inf, -inf)
    row_start = torch.arange(b, device=dev) * n
    last = torch.argmax(valid.to(torch.uint8), dim=1)  # the first valid point
    picks = [last]
    for _ in range(1, num_samples):
        sq = table - flat.index_select(0, row_start + last)[:, None, :]
        sq = sq * sq
        dist = torch.minimum(dist, sq[..., 0] + sq[..., 1] + sq[..., 2])
        last = torch.argmax(dist, dim=1)
        picks.append(last)
    return torch.stack(picks, dim=1)


def farthest_point_sample(xyz, num_samples, valid=None):
    """Farthest point sampling of one set: xyz [N, 3], valid [N] -> [S]
    int64 indices (see ``batched_farthest_point_sample``)."""
    return batched_farthest_point_sample(
        xyz, num_samples, None if valid is None else valid[None])[0]


def top_k(x, k):
    """The k largest values along x's last dimension and their indices, ties
    in index order (``jax.lax.top_k``'s order; ``torch.topk`` promises none):
    a stable sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _smallest_first(d2, k):
    """Indices of the k smallest entries of each row of d2 [M, N], equal
    values in index order: ``top_k(-d2, k)``'s indices, taken by one
    ``torch.topk`` over unique int64 keys (the value's float32 bits made
    monotonic, then the column) instead of a stable sort of whole rows."""
    bits = (d2.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)  # -0.0 -> +0.0
    mono = torch.where(bits < 0, -(bits & 0x7FFFFFFF) - 1, bits)  # ordered as the floats
    col = torch.arange(d2.shape[1], device=d2.device)
    keys = (mono << 32) | col
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).indices


def knn_bruteforce(ref_xyz, query_xyz, k, ref_valid=None, ref_batch=None, query_batch=None,
                   block=1 << 25):
    """Exact kNN: the |q|^2 + |r|^2 - 2 q.r expansion preselects 2k+8
    candidates, whose distances are then recomputed by direct differences.
    References that are not valid, and with ``ref_batch`` and
    ``query_batch`` those of another sample, are at d^2 = inf in both
    rankings; equal distances rank the lower index first, as in JAX. Each
    query's row is independent, so the queries go in chunks of at most
    ``block`` / N rows (the [chunk, N] distances bounded, the results those
    of one pass).

    Returns (idx [M, k] int64, dist2 [M, k])."""
    n, m = ref_xyz.shape[0], query_xyz.shape[0]
    if ref_valid is None:
        ref_valid = torch.ones(n, dtype=torch.bool, device=ref_xyz.device)
    step = max(1, block // max(n, 1))
    if m > step:
        parts = [knn_bruteforce(ref_xyz, query_xyz[i:i + step], k, ref_valid, ref_batch,
                                None if query_batch is None else query_batch[i:i + step], block)
                 for i in range(0, m, step)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    other = None
    if ref_batch is not None and query_batch is not None:
        other = query_batch[:, None] != ref_batch[None, :]
    qn = (query_xyz * query_xyz).sum(-1)
    rn = (ref_xyz * ref_xyz).sum(-1)
    cross = (query_xyz[:, None, :] * ref_xyz[None, :, :]).sum(-1)
    d2 = qn[:, None] + rn[None, :] - 2.0 * cross
    inf = torch.tensor(float("inf"), dtype=ref_xyz.dtype, device=ref_xyz.device)
    bad = ~ref_valid[None, :] if other is None else other | ~ref_valid[None, :]
    d2 = torch.where(bad, inf, d2)
    if d2.dtype == torch.float32:
        cand = _smallest_first(d2, min(n, 2 * k + 8))
    else:
        cand = top_k(-d2, min(n, 2 * k + 8))[1]
    diff = ref_xyz[cand] - query_xyz[:, None, :]
    d2_exact = (diff * diff).sum(-1)
    bad = ~ref_valid[cand] if other is None else torch.gather(other, 1, cand) | ~ref_valid[cand]
    neg, pos = top_k(torch.where(bad, inf, d2_exact).neg(), k)
    return torch.gather(cand, 1, pos), -neg
