"""SST, the single-stride sparse transformer over BEV pillars (counterpart of
pcseqlearning_tpu.models.backbones_sst): the pillars are regrouped into
fixed-capacity windows (``flat2window`` / ``window2flat``), attention runs
within each window, and every other block shifts the windows by half a
window.

Plain PyTorch, as the JAX module is XLA. The attention, the layer norms and
the GELU are written out to match flax's ``MultiHeadDotProductAttention``,
``LayerNorm`` and ``nn.gelu`` (see ``WindowMSA``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import grid_utils, segment_ops
from ..ops import sparse_conv as sc
from ..ops.roi_pool import _true_div
from .layers import MaskedBatchNorm
from .vfe import linear


def window_mapping(coords_xy, valid, window_size, num_windows_cap, window_cap, shift=False):
    """Each pillar's window and slot: (win_id [P], slot [P], ok [P]).

    The window of a pillar is (coords_xy + shift) // window_size, the shift
    half a window when ``shift``; windows are numbered by
    ``grid_utils.unique_rows`` (lexicographic in (wx, wy), the pillars that
    are not valid last, all of them in one group). A window's pillars take
    slots 0, 1, ... in index order. ``ok``: valid, window id below
    ``num_windows_cap`` and slot below ``window_cap``; every other pillar
    is dropped."""
    p = coords_xy.shape[0]
    dev = coords_xy.device
    off = window_size // 2 if shift else 0
    wc = torch.where(valid[:, None], torch.div(coords_xy.long() + off, window_size,
                                               rounding_mode="floor"),
                     torch.full((p, 2), 2 ** 24, dtype=torch.int64, device=dev))
    inverse, _, _ = grid_utils.unique_rows(wc)
    win_id = torch.where(valid, inverse, torch.full_like(inverse, num_windows_cap))
    order = torch.sort(win_id, stable=True).indices
    sorted_w = win_id[order]
    idx = torch.arange(p, device=dev)
    start = torch.ones(p, dtype=torch.bool, device=dev)
    start[1:] = sorted_w[1:] != sorted_w[:-1]
    run_start = torch.cummax(torch.where(start, idx, torch.zeros_like(idx)), dim=0).values
    slot = torch.empty_like(idx)
    slot[order] = idx - run_start
    ok = valid & (win_id < num_windows_cap) & (slot < window_cap)
    return win_id, slot, ok


def flat2window(feats, mapping, num_windows, window_cap):
    """Flat pillar rows [P, C] -> (win_feats [Wn, L, C], win_mask [Wn, L])
    by ``mapping`` (``window_mapping``'s) for the first ``num_windows``
    windows (the cap, or fewer when fewer hold a kept pillar): each kept
    pillar fills its (window, slot); the rest are zeros and masked. Gathers
    both ways (``sparse_conv.grid_densify``)."""
    win_id, slot, ok = mapping
    total = num_windows * window_cap
    pos = torch.where(ok, win_id * window_cap + slot, torch.full_like(win_id, total))
    dense = sc.grid_densify(total, feats, ok, pos)
    mask = torch.zeros(total + 1, dtype=torch.bool, device=feats.device)
    mask[pos[ok]] = True
    return (dense.reshape(num_windows, window_cap, -1),
            mask[:-1].reshape(num_windows, window_cap))


def window2flat(win_feats, mapping):
    """Window rows back to the flat pillar table: a kept pillar takes its
    (window, slot) row, a dropped one zeros (the JAX function's)."""
    win_id, slot, ok = mapping
    wn, length, c = win_feats.shape
    pos = torch.clamp(win_id * length + slot, 0, wn * length - 1)
    out = segment_ops.take_rows(win_feats.reshape(wn * length, c), pos)
    return torch.where(ok[:, None], out, out.new_zeros(()))


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm``: epsilon 1e-6, the variance as E[x^2] -
    E[x]^2 clipped at 0 (``use_fast_variance``), statistics in at least
    float32, then (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, channels, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, no dropout):
    q, k and v projections with bias to ``heads`` x head_dim, the query
    scaled by 1 / sqrt(head_dim) before the product, masked logits set to
    the dtype's most negative finite value (so an all-masked row is
    uniform, not NaN), the softmax, then the output projection with bias.
    The projections are ``nn.Linear`` over the flattened (heads, head_dim)."""

    def __init__(self, dim, num_heads, generator=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, linear(dim, dim, bias=True, generator=generator))

    def forward(self, x, mask):
        """x [W, L, C]; mask [W, L] of the keys each query may see."""
        w, length, c = x.shape
        split = (w, length, self.num_heads, self.head_dim)
        q = self.query(x).reshape(split)
        q = q / torch.sqrt(torch.tensor(float(self.head_dim), dtype=q.dtype, device=q.device))
        k = self.key(x).reshape(split)
        v = self.value(x).reshape(split)
        logits = torch.einsum("wqhd,wkhd->whqk", q, k)
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full((), torch.finfo(logits.dtype).min, dtype=logits.dtype,
                                        device=logits.device))
        weights = torch.softmax(logits, dim=-1)
        y = torch.einsum("whqk,wkhd->wqhd", weights, v).reshape(w, length, c)
        return self.out(y)


class WindowMSA(nn.Module):
    """One SST block over windows [W, L, C]: masked self-attention of x +
    pos_embed (the masked slots' output zeroed), a residual and
    ``LayerNorm``, then a GELU (tanh form, flax's default) FFN of width
    ``ffn_mult`` * dim with a residual and ``LayerNorm``; masked slots
    come out zero."""

    def __init__(self, dim, num_heads=8, ffn_mult=2, generator=None):
        super().__init__()
        self.attn = MultiHeadAttention(dim, num_heads, generator=generator)
        self.norm0, self.norm1 = LayerNorm(dim), LayerNorm(dim)
        self.linear0 = linear(dim, dim * ffn_mult, bias=True, generator=generator)
        self.linear1 = linear(dim * ffn_mult, dim, bias=True, generator=generator)

    def forward(self, x, mask, pos_embed):
        zero = x.new_zeros(())
        y = torch.where(mask[..., None], self.attn(x + pos_embed, mask), zero)
        x = self.norm0(x + y)
        f = self.linear1(nn.functional.gelu(self.linear0(x), approximate="tanh"))
        return torch.where(mask[..., None], self.norm1(x + f), zero)


class SSTBackbone(nn.Module):
    """The pillar features through a linear (no bias), ``MaskedBatchNorm``
    and ReLU to ``dim``, then ``num_blocks`` ``WindowMSA`` blocks, the odd
    ones over windows shifted by half a window. Each block's positional
    embedding is a linear of the pillar's in-window offset over the window
    size. The batch index is folded into y (b * (ny + 2 * window)), so no
    window spans two samples. The blocks run only over the windows that
    hold a kept pillar (ids are dense from 0): a window with every slot
    masked comes out zero and gives no gradient, so leaving it out of the
    [num_windows_cap, window_cap] table changes nothing. With gradients on,
    each block keeps only its inputs and runs again in the backward
    (``torch.utils.checkpoint``; the block has no state to update, so the
    gradients are the same): six blocks' [windows, heads, 144, 144]
    attention tables and their FFN maps would not fit on one card beside a
    stride-1 BEV backbone at the Waymo grid. Writes the new
    features to ``pillar_features`` and ``voxel_features``;
    ``window_mappings`` keeps each block's (win_id, slot, ok)."""

    def __init__(self, cin, dim=128, num_blocks=4, window_size=12, num_heads=8,
                 grid_size=(468, 468), window_cap=144, num_windows_cap=2048, generator=None):
        super().__init__()
        self.dim, self.num_blocks, self.window_size = dim, num_blocks, window_size
        self.grid_size = tuple(grid_size)
        self.window_cap, self.num_windows_cap = window_cap, num_windows_cap
        self.linear0 = linear(cin, dim, generator=generator)
        self.norm0 = MaskedBatchNorm(dim)
        for blk in range(num_blocks):
            setattr(self, f"pos_embed_{blk}", linear(2, dim, bias=True, generator=generator))
            setattr(self, f"block_{blk}", WindowMSA(dim, num_heads, generator=generator))
        self.out_channels = dim

    def forward(self, batch_dict):
        feats = batch_dict.get("pillar_features", batch_dict["voxel_features"])
        coords, valid = batch_dict["voxel_coords"].long(), batch_dict["voxel_valid"]
        ws = self.window_size
        xy = torch.stack([coords[:, 3], coords[:, 2] + coords[:, 0] * (self.grid_size[1]
                                                                       + ws * 2)], dim=1)
        x = torch.relu(self.norm0(self.linear0(feats), valid))
        mappings = []
        for blk in range(self.num_blocks):
            shift = blk % 2 == 1
            mapping = window_mapping(xy, valid, ws, self.num_windows_cap, self.window_cap, shift)
            mappings.append(mapping)
            off = ws // 2 if shift else 0
            inwin = _true_div(torch.remainder(xy + off, ws).to(x.dtype), float(ws))
            pe = getattr(self, f"pos_embed_{blk}")(inwin)
            used = int(mapping[0][mapping[2]].max()) + 1 if bool(mapping[2].any()) else 1
            wf, wm = flat2window(x, mapping, used, self.window_cap)
            pe_w, _ = flat2window(pe, mapping, used, self.window_cap)
            block = getattr(self, f"block_{blk}")
            if torch.is_grad_enabled():  # recompute the block in the backward
                wf = checkpoint(block, wf, wm, pe_w, use_reentrant=False)
            else:
                wf = block(wf, wm, pe_w)
            x = window2flat(wf, mapping)
        batch_dict["pillar_features"] = batch_dict["voxel_features"] = x
        batch_dict["window_mappings"] = mappings
        return batch_dict

