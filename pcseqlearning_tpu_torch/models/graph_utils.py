"""Config-driven graph builders (counterpart of
pcseqlearning_tpu.models.graph_utils): ``build_graph(cfg)`` over the
GRAPHS registry (KNNGraph, KNNGraphV2, RadiusGraph, VoxelGraph,
VolumeGraph) and ``connected_components``. A graph takes dicts with an
[N, 4] coordinate entry named by RELATIVE_KEY (default ``bxyz``) and an
optional ``valid`` mask, and returns a padded edge list (e_ref, e_query,
e_weight or None, e_mask).
"""

from __future__ import annotations

import torch

from ..ops import connected_components as cc_ops
from ..ops import hash_graph, sampling
from ..utils.edict import EDict


def connected_components(e_src, e_dst, num_nodes, e_mask=None):
    """(num_components, component [N]) of an edge list."""
    labels = cc_ops.connected_components(e_src, e_dst, num_nodes, e_mask)
    comp, num = cc_ops.compact_labels(labels)
    return num, comp


class GraphTemplate:
    def __init__(self, model_cfg, runtime_cfg=None):
        self.model_cfg = EDict(model_cfg)
        self.relative_key = self.model_cfg.get("RELATIVE_KEY", "bxyz")

    def _coords(self, d):
        return d[self.relative_key] if isinstance(d, dict) else d

    def _valid(self, d, n, device):
        if isinstance(d, dict) and "valid" in d:
            return torch.as_tensor(d["valid"], device=device)
        return torch.ones(n, dtype=torch.bool, device=device)


class RadiusGraph(GraphTemplate):
    """Up to MAX_NUM_NEIGHBORS (32) nearest references within RADIUS (1.0)
    of each query, in its own frame."""

    def __init__(self, model_cfg, runtime_cfg=None):
        super().__init__(model_cfg, runtime_cfg)
        self.radius = self.model_cfg.get("RADIUS", 1.0)
        self.max_num_neighbors = int(self.model_cfg.get("MAX_NUM_NEIGHBORS", 32))
        self.sort_by_dist = bool(self.model_cfg.get("SORT_BY_DIST", False))

    def __call__(self, ref, query):
        r, q = self._coords(ref), self._coords(query)
        idx, _, mask = hash_graph.radius_graph(
            r, q, float(self.radius), self.max_num_neighbors,
            ref_valid=self._valid(ref, r.shape[0], r.device),
            query_valid=self._valid(query, q.shape[0], q.device))
        e_ref, e_query, e_mask = hash_graph.edges_from_neighbors(idx, mask)
        return e_ref, e_query, None, e_mask


class KNNGraph(GraphTemplate):
    """The NUM_NEIGHBORS (32) nearest valid references of each query in its
    own sample, at any distance."""

    def __init__(self, model_cfg, runtime_cfg=None):
        super().__init__(model_cfg, runtime_cfg)
        self.k = int(self.model_cfg.get("NUM_NEIGHBORS", 32))

    def _knn(self, ref, query):
        r, q = self._coords(ref), self._coords(query)
        return sampling.knn_bruteforce(
            r[:, 1:4], q[:, 1:4], self.k, ref_valid=self._valid(ref, r.shape[0], r.device),
            ref_batch=torch.round(r[:, 0]).long(), query_batch=torch.round(q[:, 0]).long())

    def __call__(self, ref, query):
        idx, d2 = self._knn(ref, query)
        q = self._coords(query)
        mask = torch.isfinite(d2) & self._valid(query, q.shape[0], q.device)[:, None]
        e_ref, e_query, e_mask = hash_graph.edges_from_neighbors(
            torch.where(mask, idx, torch.full_like(idx, -1)), mask)
        return e_ref, e_query, None, e_mask


class KNNGraphV2(KNNGraph):
    """KNNGraph with edge weights median / (d^2 + median), the median of
    the finite neighbour d^2 (NumPy's nanmedian: the mean of the two middle
    values of an even count); every query keeps its edges."""

    def __call__(self, ref, query):
        idx, d2 = self._knn(ref, query)
        mask = torch.isfinite(d2)
        s = torch.sort(d2[mask]).values
        m = s.numel()
        median = (s[(m - 1) // 2] + s[m // 2]) / 2 if m else d2.new_tensor(float("nan"))
        weight = (median / (d2 + median)).reshape(-1)
        e_ref, e_query, e_mask = hash_graph.edges_from_neighbors(
            torch.where(mask, idx, torch.full_like(idx, -1)), mask)
        return e_ref, e_query, weight, e_mask


class VoxelGraph(GraphTemplate):
    """Edges from each voxel of REF_KEY's points (VOXEL_SIZE, 0.4 m cells
    from the points' minimum corner) to the valid voxels in its
    +-KERNEL_OFFSET (1) neighbourhood (``primitives.voxel_graph``)."""

    def __init__(self, model_cfg, runtime_cfg=None):
        super().__init__(model_cfg, runtime_cfg)
        self.voxel_size = [float(v) for v in self.model_cfg.get("VOXEL_SIZE", [0.4, 0.4, 0.4])]
        self.kernel_offset = int(self.model_cfg.get("KERNEL_OFFSET", 1))
        self.ref_key = self.model_cfg.get("REF_KEY", "bxyz")
        self.query_key = self.model_cfg.get("QUERY_KEY", "bcenter")

    def __call__(self, ref, query):
        from ..ops import grid_utils
        from ..ops.primitives import voxel_graph

        r = ref[self.ref_key] if isinstance(ref, dict) else ref
        coords = grid_utils.voxel_coords(r, self.voxel_size)
        e_src, e_dst, mask = voxel_graph(coords, self._valid(ref, r.shape[0], r.device),
                                         self.kernel_offset)
        return e_src, e_dst, None, mask


class VolumeGraph(VoxelGraph):
    """VoxelGraph with PCA-extent-aware edge weights, from the ``eigvecs``,
    ``eigvals``, ``l1_proj_min`` and ``l1_proj_max`` of the ref dict
    (``PCAVolume``); without them, VoxelGraph's unweighted edges."""

    def __call__(self, ref, query):
        e_src, e_dst, _, mask = super().__call__(ref, query)
        if not (isinstance(ref, dict) and "eigvecs" in ref):
            return e_src, e_dst, None, mask
        bxyz, eigvecs = ref[self.ref_key], ref["eigvecs"]
        pmin, pmax, eigvals = ref["l1_proj_min"], ref["l1_proj_max"], ref["eigvals"]
        center = bxyz[:, 1:4] + torch.einsum("nij,nj->ni", eigvecs, (pmin + pmax) / 2.0)
        n = bxyz.shape[0]
        es, ed = torch.clamp(e_src, 0, n - 1), torch.clamp(e_dst, 0, n - 1)
        diff = center[es] - center[ed]

        def proj_dist(e):
            width = torch.clamp((pmax - pmin)[e] / 2.0, min=1e-2)
            proj = torch.minimum(torch.abs(torch.einsum("nij,ni->nj", eigvecs[e], diff)), width)
            lam = torch.sqrt(torch.clamp(eigvals[e], min=1e-8))
            return torch.linalg.norm(lam * proj, dim=-1)

        dist = torch.clamp(torch.linalg.norm(diff, dim=-1) - proj_dist(es) - proj_dist(ed),
                           min=0.0)
        cdist = torch.clamp(torch.linalg.norm(bxyz[es, 1:4] - bxyz[ed, 1:4], dim=-1),
                            min=1e-4) / 2.0
        w = cdist ** 2 / (dist ** 2 + cdist ** 2)
        return e_src, e_dst, torch.where(mask, w, w.new_zeros(())), mask


GRAPHS = {"KNNGraph": KNNGraph, "KNNGraphV2": KNNGraphV2, "RadiusGraph": RadiusGraph,
          "VoxelGraph": VoxelGraph, "VolumeGraph": VolumeGraph}


def build_graph(graph_cfg, runtime_cfg=None):
    return GRAPHS[graph_cfg["TYPE"]](graph_cfg, runtime_cfg)
