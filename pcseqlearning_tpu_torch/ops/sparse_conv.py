"""Sparse 3D convolution as gather-GEMM over voxel coordinate tables
(counterpart of pcseqlearning_tpu.ops.sparse_conv).

A sparse tensor is a fixed-capacity padded table: features [V, C] (rows
that are not valid hold zeros), coords [V, 4] (b, z, y, x), valid [V], with
a static spatial shape (D, H, W) and batch size. A convolution resolves a
rulebook, a [K, M] table whose row k holds, for each output row, the input
row under kernel offset k (-1 where there is none), and computes
``sum_k feats[rulebook[k]] @ W[k]`` as one GEMM over the gathered rows.

The backward is gathers too (``_RulebookMM``): the transpose of a rulebook
gather is a gather through the reverse rulebook, so

    dfeats[i] = sum_k dY[idx_rev[k][i]] @ W[k]^T,   dW[k] = gather_k(feats)^T @ dY

and no scatter-add (and so no float atomic on the card) runs. For a
submanifold conv the reverse of offset k is the mirrored offset K-1-k; for a
strided or an inverse conv it is the lookup in the opposite direction.
``sparse_maxpool3d`` gathers through ``segment_ops.take_rows``.

Output coordinate tables are those of the JAX function row for row: the
occupied output cells in lexicographic (b, z, y, x) order, truncated at
``out_cap`` and padded with -1.

Rulebooks resolve through a dense int32 row table over the whole grid when
B * D * H * W is at most ``dense_table_cap`` (the JAX package reads the cap
from PCSEQ_DENSE_TABLE_CAP, default 300,000,000; here it is an argument with
that default), and through
``hash_graph.coord_lookup`` above it. Both give the same rulebook.

With ``utils.profiler`` tracing, every rulebook a conv resolves (the
output coordinates, the forward and reverse lookups) runs in a span
``sparse_conv.rulebook``, and the gather-GEMMs in ``sparse_conv.gemm`` and
``sparse_conv.gemm_bwd``.

Weight layout: [K, Cin, Cout], K enumerating the kernel offsets in
``itertools.product`` order over (dz, dy, dx).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from ..utils.profiler import span
from . import hash_graph, segment_ops

DENSE_TABLE_CAP = 300_000_000


class SparseTensor(NamedTuple):
    features: torch.Tensor  # [V, C] (rows that are not valid hold zeros)
    coords: torch.Tensor  # [V, 4] (b, z, y, x)
    valid: torch.Tensor  # [V] bool
    spatial_shape: tuple  # (D, H, W)
    batch_size: int


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def kernel_offsets(kernel_size, device=None):
    """[K, 3] int64 (dz, dy, dx) offsets in scan order."""
    offs = list(itertools.product(*[range(k) for k in _triple(kernel_size)]))
    return torch.tensor(offs, dtype=torch.int64, device=device)


def _mask_features(feats, valid):
    return torch.where(valid[:, None], feats, torch.zeros((), dtype=feats.dtype,
                                                          device=feats.device))


def _in_grid(c, spatial_shape, batch_size):
    """Rows of the [N, 4] coords ``c`` that lie inside the grid."""
    dims = torch.tensor((batch_size,) + tuple(spatial_shape), device=c.device)
    return ((c >= 0) & (c < dims)).all(dim=-1)


def _linear(c, spatial_shape):
    D, H, W = spatial_shape
    c = c.long()
    return ((c[:, 0] * D + c[:, 1]) * H + c[:, 2]) * W + c[:, 3]


# ---------------------------------------------------------------------------
# rulebook resolution
# ---------------------------------------------------------------------------


def _use_dense_table(spatial_shape, batch_size, dense_table_cap):
    D, H, W = spatial_shape
    return batch_size * D * H * W <= dense_table_cap


def _dense_coord_table(st: SparseTensor):
    """[B*D*H*W] int32 row table over the grid, -1 where no row is."""
    D, H, W = st.spatial_shape
    L = st.batch_size * D * H * W
    put = st.valid & _in_grid(st.coords, st.spatial_shape, st.batch_size)
    table = torch.full((L,), -1, dtype=torch.int32, device=st.coords.device)
    rows = torch.arange(st.coords.shape[0], dtype=torch.int32, device=st.coords.device)
    table[_linear(st.coords[put], st.spatial_shape)] = rows[put]  # valid cells are unique
    return table


def _dense_lookup(table, spatial_shape, batch_size, q, q_valid):
    """Row of the exact coord match of each [M, 4] query, or -1."""
    ok = q_valid & _in_grid(q, spatial_shape, batch_size)
    lin = torch.where(ok, _linear(q, spatial_shape), torch.zeros((), dtype=torch.int64,
                                                                 device=q.device))
    return torch.where(ok, table[lin].long(), torch.full_like(lin, -1))


def _lookup_coords(st: SparseTensor, q, q_valid, dense_table_cap=DENSE_TABLE_CAP):
    """Exact-match rulebook lookup: the dense table when the grid fits
    ``dense_table_cap``, else the sorted-hash path."""
    if _use_dense_table(st.spatial_shape, st.batch_size, dense_table_cap):
        return _dense_lookup(_dense_coord_table(st), st.spatial_shape, st.batch_size, q,
                             q_valid)
    table = hash_graph.build_coord_table(st.coords, st.valid)
    return hash_graph.coord_lookup(table, q, q_valid).long()


# ---------------------------------------------------------------------------
# gather-GEMM with a gather-only backward
# ---------------------------------------------------------------------------


def _gather_rows(x, idx):
    """[M, K * C]: row m holds x[idx[k, m]] for k = 0..K-1 (zeros where
    idx is -1)."""
    xz = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    sink = torch.full_like(idx, x.shape[0])
    g = xz[torch.where(idx >= 0, idx, sink).t()]  # [M, K, C]
    return g.reshape(idx.shape[1], -1)


def _gather_mm(feats, idx, weights):
    """sum_k gather(feats, idx[k]) @ weights[k] as one GEMM."""
    k, cin, cout = weights.shape
    return _gather_rows(feats, idx) @ weights.reshape(k * cin, cout)


class _RulebookMM(torch.autograd.Function):
    """``_gather_mm(feats, idx_fwd, weights)`` whose backward gathers
    through ``idx_rev`` (idx_rev[k][i] = j iff idx_fwd[k][j] = i)."""

    @staticmethod
    def forward(ctx, feats, idx_fwd, idx_rev, weights):
        with span("sparse_conv.gemm"):
            ctx.save_for_backward(feats, idx_fwd, idx_rev, weights)
            return _gather_mm(feats, idx_fwd, weights)

    @staticmethod
    def backward(ctx, dy):
        with span("sparse_conv.gemm_bwd"):
            feats, idx_fwd, idx_rev, weights = ctx.saved_tensors
            k, cin, cout = weights.shape
            dfeats = dw = None
            if ctx.needs_input_grad[0]:
                dfeats = _gather_mm(dy, idx_rev, weights.transpose(1, 2))
            if ctx.needs_input_grad[3]:
                dw = (_gather_rows(feats, idx_fwd).t() @ dy).reshape(k, cin, cout)
            return dfeats, None, None, dw


def rulebook_mm(feats, idx_fwd, idx_rev, weights):
    return _RulebookMM.apply(feats, idx_fwd, idx_rev, weights)


def _mirror_rulebook(idx_all, kernel_size):
    """Reverse rulebook of a submanifold conv: offset k's transpose is the
    mirrored offset K-1-k (odd kernel sizes only)."""
    if any(s % 2 == 0 for s in _triple(kernel_size)):
        return None
    return idx_all.flip(0)


def build_subm_rulebook(st: SparseTensor, kernel_size=3, dense_table_cap=DENSE_TABLE_CAP):
    """[K, V] rulebook of a submanifold conv on ``st``'s coordinate set. It
    depends on the coordinates alone, so every subm conv of a stage shares
    one."""
    with span("sparse_conv.rulebook"):
        ks = _triple(kernel_size)
        dev = st.coords.device
        center = torch.tensor([(s - 1) // 2 for s in ks], device=dev)
        delta = kernel_offsets(ks, dev) - center
        k, v = delta.shape[0], st.coords.shape[0]
        zyx = st.coords[None, :, 1:4].long() + delta[:, None, :]
        q = torch.cat([st.coords[None, :, 0:1].long().expand(k, v, 1), zyx],
                      dim=-1).reshape(k * v, 4)
        qv = st.valid[None, :].expand(k, v).reshape(-1)
        return _lookup_coords(st, q, qv, dense_table_cap).reshape(k, v)


def subm_conv3d(st: SparseTensor, weights, bias=None, kernel_size=3, rulebook=None,
                dense_table_cap=DENSE_TABLE_CAP):
    """Submanifold sparse conv: the output coords are the input coords.
    ``weights`` [K, Cin, Cout]; ``rulebook`` ([K, V] from
    ``build_subm_rulebook``) lets convs on one coordinate set share it."""
    feats = _mask_features(st.features, st.valid)
    idx_all = rulebook if rulebook is not None else build_subm_rulebook(
        st, kernel_size, dense_table_cap)
    idx_rev = _mirror_rulebook(idx_all, kernel_size)
    if idx_rev is not None:
        out = rulebook_mm(feats, idx_all, idx_rev, weights)
    else:  # an even kernel has no mirror: autograd's (scatter) backward
        out = _gather_mm(feats, idx_all, weights)
    if bias is not None:
        out = out + bias[None, :]
    return st._replace(features=_mask_features(out, st.valid))


def _downsample_coords(st: SparseTensor, kernel_size, stride, padding, out_cap,
                       dense_table_cap=DENSE_TABLE_CAP):
    """Active output coords of a strided sparse conv: every output cell
    whose receptive field holds an input (spconv's get_indice_pairs), the
    first ``out_cap`` in lexicographic order. Returns (coords [out_cap, 4]
    padded with -1, valid [out_cap], out_shape)."""
    ks, stride, padding = _triple(kernel_size), _triple(stride), _triple(padding)
    dev = st.coords.device
    stride_a = torch.tensor(stride, device=dev)
    out_shape = tuple((st.spatial_shape[i] + 2 * padding[i] - ks[i]) // stride[i] + 1
                      for i in range(3))
    offs = kernel_offsets(ks, dev)
    zyx = st.coords[None, :, 1:4].long() + torch.tensor(padding, device=dev) - offs[:, None, :]
    op = zyx // stride_a
    ok = ((zyx % stride_a == 0).all(-1) & (op >= 0).all(-1)
          & (op < torch.tensor(out_shape, device=dev)).all(-1) & st.valid[None, :])
    b = st.coords[None, :, 0:1].long().expand(ok.shape + (1,))
    cand = torch.cat([b, op], dim=-1)[ok]  # [n, 4]
    Do, Ho, Wo = out_shape
    L = st.batch_size * Do * Ho * Wo
    if L <= dense_table_cap:
        # occupancy over the output grid; ascending linear index is the
        # lexicographic coord order
        occ = torch.zeros(L, dtype=torch.bool, device=dev)
        occ[_linear(cand, out_shape)] = True
        lin = torch.nonzero(occ).squeeze(1)[:out_cap]
        uniq = torch.stack([lin // (Do * Ho * Wo), (lin // (Ho * Wo)) % Do,
                            (lin // Wo) % Ho, lin % Wo], dim=-1)
    else:
        uniq = torch.unique(cand, dim=0)[:out_cap]  # sorted lexicographically
    n = uniq.shape[0]
    out_coords = torch.full((out_cap, 4), -1, dtype=st.coords.dtype, device=dev)
    out_coords[:n] = uniq.to(st.coords.dtype)
    out_valid = torch.arange(out_cap, device=dev) < n
    return out_coords, out_valid, out_shape


def sparse_conv3d(st: SparseTensor, weights, bias=None, kernel_size=3, stride=2, padding=1,
                  out_cap=None, dense_table_cap=DENSE_TABLE_CAP):
    """Strided sparse conv (spconv SparseConv3d); ``out_cap`` bounds the
    output table (default: the input's capacity)."""
    ks, stride, padding = _triple(kernel_size), _triple(stride), _triple(padding)
    v = st.features.shape[0]
    out_cap = out_cap or v
    with span("sparse_conv.rulebook"):
        out_coords, out_valid, out_shape = _downsample_coords(st, ks, stride, padding, out_cap,
                                                              dense_table_cap)
        dev = st.coords.device
        offs = kernel_offsets(ks, dev)
        k = offs.shape[0]
        stride_a = torch.tensor(stride, device=dev)
        pad_a = torch.tensor(padding, device=dev)

        # forward rulebook: output o reads input o * stride - pad + off_k
        zyx = out_coords[None, :, 1:4].long() * stride_a - pad_a + offs[:, None, :]
        b = out_coords[None, :, 0:1].long().expand(k, out_cap, 1)
        q = torch.cat([b, zyx], dim=-1).reshape(k * out_cap, 4)
        qv = out_valid[None, :].expand(k, out_cap).reshape(-1)
        idx_all = _lookup_coords(st, q, qv, dense_table_cap).reshape(k, out_cap)

        # reverse rulebook: input i feeds output (i + pad - off_k) / stride
        out_st = SparseTensor(st.features.new_zeros((out_cap, 1)), out_coords, out_valid,
                              out_shape, st.batch_size)
        rzyx = st.coords[None, :, 1:4].long() + pad_a - offs[:, None, :]
        rb = st.coords[None, :, 0:1].long().expand(k, v, 1)
        rq = torch.cat([rb, rzyx // stride_a], dim=-1).reshape(k * v, 4)
        rqv = (st.valid[None, :] & (rzyx % stride_a == 0).all(-1)).reshape(-1)
        idx_rev = _lookup_coords(out_st, rq, rqv, dense_table_cap).reshape(k, v)

    feats = _mask_features(st.features, st.valid)
    out = rulebook_mm(feats, idx_all, idx_rev, weights)
    if bias is not None:
        out = out + bias[None, :]
    return SparseTensor(_mask_features(out, out_valid), out_coords, out_valid, out_shape,
                        st.batch_size)


class _GridDensify(torch.autograd.Function):
    """[V, C] rows -> [L, C] grid rows. The forward scatters V row ids into
    a cell -> row table and gathers feature rows per cell; where valid rows
    share a cell, the largest row id owns it on every device (a max
    scatter: the JAX scatter on the CPU keeps its last writer, the largest
    row; a plain indexed write is undefined on the card). The backward
    gathers dY at each valid row's cell, whether or not the row owns it, as
    the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, L, feats, valid, lin):
        v = feats.shape[0]
        dev = feats.device
        lin = lin.long()
        keep = valid & (lin >= 0) & (lin < L)  # the JAX scatter drops cells out of range
        rows = torch.where(keep, torch.arange(v, device=dev), torch.full((v,), -1, device=dev))
        table = torch.full((L,), -1, dtype=torch.int64, device=dev)
        table = table.scatter_reduce(0, torch.where(keep, lin, torch.zeros_like(lin)), rows, "amax")
        table = torch.where(table < 0, torch.full_like(table, v), table)
        fz = torch.cat([_mask_features(feats, valid), feats.new_zeros((1, feats.shape[1]))])
        ctx.save_for_backward(valid, lin)
        ctx.L = L
        return fz[table]

    @staticmethod
    def backward(ctx, dy):
        valid, lin = ctx.saved_tensors
        g = dy[torch.clamp(lin, 0, ctx.L - 1)]
        return None, _mask_features(g, valid), None, None


def grid_densify(L, feats, valid, lin):
    return _GridDensify.apply(L, feats, valid, lin)


def to_dense(st: SparseTensor):
    """The sparse table as a dense [B, D, H, W, C] grid (gathers in both
    directions, through ``grid_densify``)."""
    D, H, W = st.spatial_shape
    B = st.batch_size
    lin = _linear(st.coords, st.spatial_shape)
    dense = grid_densify(B * D * H * W, st.features, st.valid, lin)
    return dense.reshape(B, D, H, W, st.features.shape[1])


def sparse_inverse_conv3d(st: SparseTensor, target: SparseTensor, weights, bias=None,
                          kernel_size=3, stride=2, padding=1,
                          dense_table_cap=DENSE_TABLE_CAP):
    """Inverse (transposed) sparse conv onto the known finer coords of
    ``target`` (spconv SparseInverseConv3d, the UNet decoder): target voxel
    f sums, over the offsets k, coarse voxel c with c * stride - pad + off_k
    = f. The forward rulebook [K, T] resolves (f + pad - off_k) / stride
    where it divides exactly (floor division and floor remainder, as JAX's
    ``//`` and ``%`` on negative coords); the reverse rulebook [K, V] looks
    c * stride - pad + off_k up among the targets, so the backward gathers
    too. Output: ``target``'s coords and mask."""
    ks, stride, padding = _triple(kernel_size), _triple(stride), _triple(padding)
    v, t_cap = st.features.shape[0], target.features.shape[0]
    with span("sparse_conv.rulebook"):
        dev = st.coords.device
        offs = kernel_offsets(ks, dev)
        k = offs.shape[0]
        stride_a = torch.tensor(stride, device=dev)
        pad_a = torch.tensor(padding, device=dev)

        zyx = target.coords[None, :, 1:4].long() + pad_a - offs[:, None, :]  # [K, T, 3]
        div_ok = (torch.remainder(zyx, stride_a) == 0).all(-1)
        coarse = torch.div(zyx, stride_a, rounding_mode="floor")
        b = target.coords[None, :, 0:1].long().expand(k, t_cap, 1)
        q = torch.cat([b, coarse], dim=-1).reshape(k * t_cap, 4)
        qv = (target.valid[None, :] & div_ok).reshape(-1)
        idx_all = _lookup_coords(st, q, qv, dense_table_cap).reshape(k, t_cap)
        idx_all = torch.where(div_ok, idx_all, torch.full_like(idx_all, -1))

        rzyx = st.coords[None, :, 1:4].long() * stride_a - pad_a + offs[:, None, :]  # [K, V, 3]
        rb = st.coords[None, :, 0:1].long().expand(k, v, 1)
        rq = torch.cat([rb, rzyx], dim=-1).reshape(k * v, 4)
        rqv = st.valid[None, :].expand(k, v).reshape(-1)
        idx_rev = _lookup_coords(target, rq, rqv, dense_table_cap).reshape(k, v)

    feats = _mask_features(st.features, st.valid)
    out = rulebook_mm(feats, idx_all, idx_rev, weights)
    if bias is not None:
        out = out + bias[None, :]
    return SparseTensor(_mask_features(out, target.valid), target.coords, target.valid,
                        target.spatial_shape, target.batch_size)


def sparse_maxpool3d(st: SparseTensor, kernel_size=3, stride=2, padding=1, out_cap=None,
                     dense_table_cap=DENSE_TABLE_CAP):
    """Sparse max pooling (spconv indice_maxpool): the output coords of a
    strided conv, each the max over the inputs under its K offsets (0 where
    none). The max is taken offset by offset, pairwise, as the JAX
    function's scan of ``jnp.maximum`` does, so a tie halves the gradient
    at each step (one ``amax`` over the K offsets would split it evenly
    instead)."""
    ks, stride, padding = _triple(kernel_size), _triple(stride), _triple(padding)
    v = st.features.shape[0]
    out_cap = out_cap or v
    with span("sparse_conv.rulebook"):
        out_coords, out_valid, out_shape = _downsample_coords(st, ks, stride, padding, out_cap,
                                                              dense_table_cap)
        dev = st.coords.device
        offs = kernel_offsets(ks, dev)
        k = offs.shape[0]
        zyx = (out_coords[None, :, 1:4].long() * torch.tensor(stride, device=dev)
               - torch.tensor(padding, device=dev) + offs[:, None, :])
        b = out_coords[None, :, 0:1].long().expand(k, out_cap, 1)
        q = torch.cat([b, zyx], dim=-1).reshape(k * out_cap, 4)
        qv = out_valid[None, :].expand(k, out_cap).reshape(-1)
        idx_all = _lookup_coords(st, q, qv, dense_table_cap).reshape(k, out_cap)
    feats = _mask_features(st.features, st.valid)
    neg = torch.full((out_cap, feats.shape[1]), float("-inf"), dtype=feats.dtype, device=dev)
    out = neg
    for kk in range(k):
        idx = idx_all[kk]
        g = segment_ops.take_rows(feats, torch.clamp(idx, 0, v - 1))
        out = torch.maximum(out, torch.where((idx >= 0)[:, None], g, neg))
    out = torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype, device=dev))
    return SparseTensor(_mask_features(out, out_valid), out_coords, out_valid, out_shape,
                        st.batch_size)
