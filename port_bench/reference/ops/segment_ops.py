"""Segment reducers (counterpart of pcseqlearning_tpu.ops.segment_ops).

Same contract as ``jax.ops.segment_*``: ``num_segments`` fixes the output
length and ids outside ``[0, num_segments)`` are dropped, so callers can
route padding to a sink id.

Float sums on the card give the same bits on every run of the same input:
a CUDA ``index_add_`` adds with atomics in whatever order the threads
arrive, and the extraction path's chaotic loops (the ground L1 solve, the
walks) carry that order into their outputs. So a float ``segment_sum`` of a
CUDA tensor sorts the rows by segment (stably, so each segment keeps its
rows' order) and reduces the contiguous runs with ``torch.segment_reduce``,
whose order of adds is a function of the input alone. The CPU keeps
``index_add_`` (sequential, hence already reproducible). Integer sums and
the min / max reductions commute exactly and keep their scatters.
"""

from __future__ import annotations

import torch


def _in_range(segment_ids, num_segments):
    return (segment_ids >= 0) & (segment_ids < num_segments)


def _sorted_segment_sum(data, segment_ids, num_segments):
    """Sum of the rows of each segment (every id in range), atomic-free:
    a stable sort by id, then one reduction per contiguous run."""
    ids, order = torch.sort(segment_ids.long(), stable=True)
    bounds = torch.searchsorted(ids, torch.arange(num_segments + 1, device=ids.device))
    return torch.segment_reduce(data[order], "sum", lengths=bounds[1:] - bounds[:-1],
                                axis=0, unsafe=True)


def segment_sum(data, segment_ids, num_segments):
    ok = _in_range(segment_ids, num_segments)
    if data.is_cuda and data.dtype.is_floating_point:
        return _sorted_segment_sum(data[ok], segment_ids[ok], num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids[ok].long(), data[ok])


def index_add(base, index, data):
    """``base.index_add(0, index, data)`` (every index in range), with the
    card's float sums made reproducible as ``segment_sum``'s are."""
    if base.is_cuda and base.dtype.is_floating_point:
        return base + _sorted_segment_sum(data, index, base.shape[0])
    return base.index_add(0, index, data)


class _TakeRows(torch.autograd.Function):
    """x[idx] for x [N, ...] and idx [M] (every index in range); the backward
    sums dY into the rows by ``segment_sum``, so a repeated index adds in a
    reproducible order on the card (autograd's own index backward adds with
    atomics there)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        return segment_sum(dy, idx, ctx.n), None


def take_rows(x, idx):
    """``x[idx]`` with a backward that is reproducible on the card."""
    return _TakeRows.apply(x, idx)


def segment_count(segment_ids, num_segments, weights=None, dtype=torch.float32):
    w = (torch.ones(segment_ids.shape[0], dtype=dtype, device=segment_ids.device)
         if weights is None else weights)
    return segment_sum(w, segment_ids, num_segments)


def _expand(v, data):
    return v.reshape((v.shape[0],) + (1,) * (data.dim() - 1))


def segment_mean(data, segment_ids, num_segments, eps=1e-6):
    """Per-segment mean; empty segments yield 0."""
    total = segment_sum(data, segment_ids, num_segments)
    cnt = _expand(segment_count(segment_ids, num_segments, dtype=data.dtype), data)
    return torch.where(cnt > 0.5, total / torch.clamp(cnt, min=eps),
                       torch.zeros((), dtype=data.dtype, device=data.device))


def _reduce(data, segment_ids, num_segments, how):
    ok = _in_range(segment_ids, num_segments)
    if data.dtype.is_floating_point:
        ident = float("inf") if how == "amin" else float("-inf")
    else:
        info = torch.iinfo(data.dtype)
        ident = info.max if how == "amin" else info.min
    out = torch.full((num_segments,) + tuple(data.shape[1:]), ident,
                     dtype=data.dtype, device=data.device)
    ids = segment_ids[ok].long()
    src = data[ok]
    ids = _expand(ids, src).expand_as(src)
    return out.scatter_reduce_(0, ids, src, how, include_self=True)


def segment_min(data, segment_ids, num_segments):
    """Per-segment min; empty segments hold the dtype's max / +inf."""
    return _reduce(data, segment_ids, num_segments, "amin")


def segment_max(data, segment_ids, num_segments):
    """Per-segment max; empty segments hold the dtype's min / -inf."""
    return _reduce(data, segment_ids, num_segments, "amax")


def _or_fill(out, segment_ids, num_segments, fill):
    cnt = _expand(segment_count(segment_ids, num_segments), out)
    return torch.where(cnt > 0.5, out, torch.full_like(out, fill))


def segment_min_or(data, segment_ids, num_segments, fill):
    """segment_min, but empty segments produce ``fill``."""
    return _or_fill(segment_min(data, segment_ids, num_segments), segment_ids,
                    num_segments, fill)


def segment_max_or(data, segment_ids, num_segments, fill):
    return _or_fill(segment_max(data, segment_ids, num_segments), segment_ids,
                    num_segments, fill)


def weighted_segment_mean(data, weights, segment_ids, num_segments, eps=1e-6):
    """sum(w * x) / (sum(w) + eps) per segment (the IRLS plane fits)."""
    total = segment_sum(data * _expand(weights, data), segment_ids, num_segments)
    wsum = _expand(segment_sum(weights, segment_ids, num_segments), data)
    return total / (wsum + eps)


def truncated_segment_mean(data, segment_ids, num_segments, trunc_dist=0.3):
    """Mean, then re-mean after clamping each element to mean +- trunc_dist."""
    mean0 = segment_mean(data, segment_ids, num_segments)
    per = mean0[segment_ids.long()]
    clamped = torch.minimum(torch.maximum(data, per - trunc_dist), per + trunc_dist)
    return segment_mean(clamped, segment_ids, num_segments)


def lexsort(keys):
    """Permutation sorting rows lexicographically by ``keys`` (first key
    most significant), stable — the counterpart of a multi-key lax.sort."""
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def segment_median(data, segment_ids, num_segments):
    """Per-segment median (upper middle of the sorted run); empty segments
    give -1 for integer data and -1e10 for floats."""
    n = data.shape[0]
    order = lexsort((segment_ids, data))
    sort_val = data[order]
    degree = segment_count(segment_ids[order], num_segments, dtype=torch.int64)
    start = torch.cumsum(degree, 0) - degree
    mid = torch.clamp(start + degree // 2, 0, n - 1)
    med = sort_val[mid]
    fill = -1 if not data.dtype.is_floating_point else -1e10
    return torch.where(degree > 0, med, torch.full_like(med, fill))
