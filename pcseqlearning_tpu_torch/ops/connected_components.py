"""Connected components by min-label propagation with pointer jumping
(counterpart of pcseqlearning_tpu.ops.connected_components), in plain
PyTorch: the JAX module is XLA, not a Pallas kernel.

Each round reads one "changed" flag to the host; the round cap
``max_iters`` is the JAX module's, so a graph that has not converged within
it gets the same labels as there.
"""

from __future__ import annotations

import torch

_BIG = 2 ** 31 - 1


def _jump(labels, times):
    for _ in range(times):
        labels = labels[labels.long()]
    return labels


def connected_components(e_src, e_dst, num_nodes, e_mask=None, max_iters=64):
    """Labels of an undirected graph given as an edge list.

    e_src, e_dst [E] int endpoints (-1 or ``e_mask`` False for padded
    edges); num_nodes N. Returns [N] int32: the smallest node id each node
    reaches (``compact_labels`` gives dense ids). No stage of the port calls
    it yet: the sharded proposal of ROADMAP.md §2 (multi-GPU) will, for
    the halo edges between slabs."""
    valid = (e_src >= 0) & (e_dst >= 0)
    if e_mask is not None:
        valid = valid & e_mask
    src = torch.where(valid, e_src, torch.zeros_like(e_src)).long()
    dst = torch.where(valid, e_dst, torch.zeros_like(e_dst)).long()
    labels = torch.arange(num_nodes, dtype=torch.int32, device=e_src.device)
    big = torch.full_like(src, _BIG, dtype=torch.int32)
    for _ in range(max_iters):
        m = torch.minimum(labels[src], labels[dst])
        m = torch.where(valid, m, big)
        new = labels.clone()
        new.scatter_reduce_(0, src, m, "amin")
        new.scatter_reduce_(0, dst, m, "amin")
        new = _jump(new, 3)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def connected_components_knn(idx, mask, n_pull=2, max_iters=64):
    """Labels straight from a neighbour table idx [N, K] (mask [N, K]).

    A round is ``n_pull`` pulls (each node takes the least label over its
    own neighbour list, then two pointer jumps) and one push (each listed
    neighbour takes the node's label by a scatter-min over a padded row,
    then two jumps), so an (a, b) pair that only a lists still merges."""
    n = idx.shape[0]
    dev = idx.device
    idx_pad = torch.where(mask, idx, torch.full_like(idx, n)).long()
    idx_g = torch.where(mask, idx, torch.zeros_like(idx)).long()
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        new = labels
        for _ in range(n_pull):
            ln = torch.where(mask, new[idx_g], big)
            new = torch.minimum(new, ln.min(dim=1).values)
            new = _jump(new, 2)
        padded = torch.cat([new, big[None]])
        pushed = padded.scatter_reduce(0, idx_pad.reshape(-1),
                                       new[:, None].expand_as(idx_pad).reshape(-1), "amin")
        new = _jump(torch.minimum(new, pushed[:n]), 2)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def compact_labels(labels, num_nodes=None, node_valid=None):
    """Dense component ids 0..C-1 in root order; (component [N] int32,
    num_components int). Invalid nodes get -1."""
    n = labels.shape[0]
    dev = labels.device
    if node_valid is None:
        node_valid = torch.ones(n, dtype=torch.bool, device=dev)
    is_root = (labels == torch.arange(n, dtype=labels.dtype, device=dev)) & node_valid
    rank = torch.cumsum(is_root.to(torch.int32), 0) - 1
    comp = torch.where(node_valid, rank[labels.long()], torch.full_like(rank, -1))
    return comp.to(torch.int32), int(is_root.sum())
