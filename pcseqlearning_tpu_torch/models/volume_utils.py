"""Per-voxel PCA volume statistics (counterpart of
pcseqlearning_tpu.models.volume_utils): ``PCAVolume`` and
``build_volume``. Each base point looks up its (offset) cells in the
hashed coordinate table of the sampled voxels and every reduction is a
segment op, as in JAX."""

from __future__ import annotations

import itertools

import torch

from ..ops import geometry, grid_utils, hash_graph, segment_ops
from ..utils.edict import EDict


class PCAVolume:
    """For ``ref`` (``bcenter`` [V, 4], optional ``valid``) and the base
    points [N, 4]: each voxel's member points are the base points whose
    cell, moved by an offset of the +-KERNEL_OFFSET (0) stencil, is the
    voxel's (cells of VOXEL_SIZE from the valid base points' minimum
    corner). Adds ``bxyz`` (the members' mean, bcenter where empty),
    ``volume`` (the member count), ``volume_mask``, ``eigvals`` [V, 3]
    ascending, ``eigvecs`` [V, 3, 3] (columns) of the members'
    covariance, and ``l1_proj_min`` / ``l1_proj_max`` [V, 3], the members'
    extent along the eigenvectors (0 where empty)."""

    def __init__(self, runtime_cfg=None, model_cfg=None):
        cfg = EDict(model_cfg or {})
        vs = cfg.get("VOXEL_SIZE", 0.4)
        self.voxel_size = [float(v) for v in (vs if isinstance(vs, (list, tuple)) else [vs] * 3)]
        self.kernel_offset = int(cfg.get("KERNEL_OFFSET", 0))
        self.enabled = bool(cfg.get("ENABLED", True))

    def __call__(self, ref, base_bxyz, base_valid=None):
        if not self.enabled:
            return ref
        ref = EDict(ref)
        bcenter = ref["bcenter"]
        V = bcenter.shape[0]
        dev = bcenter.device
        vvalid = ref.get("valid")
        if vvalid is None:
            vvalid = torch.ones(V, dtype=torch.bool, device=dev)
        base = base_bxyz
        n, dt = base.shape[0], base.dtype
        if base_valid is None:
            base_valid = torch.ones(n, dtype=torch.bool, device=dev)
        vs = torch.tensor(self.voxel_size, dtype=dt, device=dev)
        origin = torch.where(base_valid[:, None], base[:, 1:4],
                             torch.full_like(base[:, 1:4], float("inf"))).amin(0)
        vcoords = grid_utils.voxel_coords(bcenter, vs, origin=origin)
        vcoords = torch.where(vvalid[:, None], vcoords, torch.full_like(vcoords, 2 ** 24))
        table = hash_graph.build_coord_table(vcoords, vvalid)
        pcoords = grid_utils.voxel_coords(base, vs, origin=origin)

        k = self.kernel_offset
        xyz = base[:, 1:4]
        segs = []
        for o in itertools.product(*[range(-k, k + 1)] * 3):
            q = pcoords.clone()
            q[:, 1:4] += torch.tensor(o, dtype=q.dtype, device=dev)
            idx = hash_graph.coord_lookup(table, q, base_valid)
            ok = (idx >= 0) & base_valid
            segs.append((torch.where(ok, idx, torch.full_like(idx, V)), ok))
        seg_all = torch.cat([s for s, _ in segs])
        vol = segment_ops.segment_sum(torch.cat([ok.to(torch.float32) for _, ok in segs]),
                                      seg_all, V + 1)[:V]
        ssum = segment_ops.segment_sum(
            torch.cat([torch.where(ok[:, None], xyz, xyz.new_zeros(())) for _, ok in segs]),
            seg_all, V + 1)[:V]
        mask = vol > 0.5
        mean = torch.where(mask[:, None], ssum / torch.clamp(vol, min=1.0)[:, None].to(dt),
                           bcenter[:, 1:4])
        ddts, projs = [], []
        for seg, ok in segs:
            d = xyz - mean[torch.clamp(seg, 0, V - 1)]
            ddts.append(torch.where(ok[:, None, None], d[:, :, None] * d[:, None, :],
                                    d.new_zeros(())))
        cov = segment_ops.segment_sum(torch.cat(ddts), seg_all, V + 1)[:V]
        cov = cov / torch.clamp(vol, min=1.0)[:, None, None].to(dt)
        eigvals, eigvecs = geometry.eigh3x3(cov)
        for seg, ok in segs:
            rows = torch.clamp(seg, 0, V - 1)
            projs.append(torch.einsum("ni,nij->nj", xyz - mean[rows], eigvecs[rows]))
        proj = torch.cat(projs)
        ok_all = torch.cat([ok for _, ok in segs])[:, None]
        inf = torch.full_like(proj, float("inf"))
        pmin = segment_ops.segment_min(torch.where(ok_all, proj, inf), seg_all, V + 1)[:V]
        pmax = segment_ops.segment_max(torch.where(ok_all, proj, -inf), seg_all, V + 1)[:V]
        zero = pmin.new_zeros(())
        ref["bxyz"] = torch.cat([bcenter[:, :1], mean], dim=1)
        ref["volume"] = vol
        ref["volume_mask"] = mask
        ref["eigvals"] = eigvals
        ref["eigvecs"] = eigvecs
        ref["l1_proj_min"] = torch.where(torch.isfinite(pmin), pmin, zero)
        ref["l1_proj_max"] = torch.where(torch.isfinite(pmax), pmax, zero)
        return ref


VOLUMES = {"PCAVolume": PCAVolume}


def build_volume(volume_cfg, runtime_cfg=None):
    return VOLUMES[volume_cfg["TYPE"]](runtime_cfg, volume_cfg)
