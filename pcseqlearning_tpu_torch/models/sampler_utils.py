"""Point samplers (counterpart of pcseqlearning_tpu.models.sampler_utils):
FPSSampler, GridSampler, VoxelCenterSampler, HybridSampler, VolumeSampler
and ``build_sampler``. Each maps a padded [N, 4] point table to a sampled
table, indices or an inverse map."""

from __future__ import annotations

import itertools

import torch

from ..ops import grid_utils, sampling, segment_ops
from ..utils.edict import EDict


class FPSSampler:
    """Farthest point sampling to NUM_SAMPLES (2048) indices."""

    def __init__(self, runtime_cfg=None, model_cfg=None):
        cfg = EDict(model_cfg or {})
        self.num_samples = int(cfg.get("NUM_SAMPLES", cfg.get("STRIDE", 4) and 2048))

    def __call__(self, point_bxyz, valid=None):
        return sampling.farthest_point_sample(point_bxyz[:, 1:4], self.num_samples, valid=valid)


class GridSampler:
    """One representative per GRID_SIZE cell (its largest row): (rep [N],
    rep_valid [N], inverse [N])."""

    def __init__(self, runtime_cfg=None, model_cfg=None):
        cfg = EDict(model_cfg or {})
        self.grid_size = [float(g) for g in cfg.get("GRID_SIZE", [0.4, 0.4, 0.4])]

    def __call__(self, point_bxyz, valid=None):
        rep, rep_valid, inverse, _ = grid_utils.grid_subsample_indices(point_bxyz, self.grid_size)
        return rep, rep_valid, inverse


class VoxelCenterSampler:
    """The mean point of each occupied GRID_SIZE cell: (bxyz [N, 4], valid
    [N], inverse [N]), the table padded to N rows as in JAX."""

    def __init__(self, runtime_cfg=None, model_cfg=None):
        cfg = EDict(model_cfg or {})
        self.grid_size = [float(g) for g in cfg.get("GRID_SIZE", [0.4, 0.4, 0.4])]

    def __call__(self, point_bxyz, valid=None):
        out = grid_utils.grid_sample_mean(point_bxyz, self.grid_size,
                                          num_voxels_cap=point_bxyz.shape[0])
        return out["bxyz"], out["valid"], out["inverse"]


class HybridSampler:
    """GridSampler, then farthest point sampling of NUM_SAMPLES (2048) of
    the representatives: their row indices."""

    def __init__(self, runtime_cfg=None, model_cfg=None):
        cfg = EDict(model_cfg or {})
        self.grid = GridSampler(runtime_cfg, cfg)
        self.num_samples = int(cfg.get("NUM_SAMPLES", 2048))

    def __call__(self, point_bxyz, valid=None):
        rep, rep_valid, _ = self.grid(point_bxyz, valid)
        xyz = point_bxyz[torch.clamp(rep, 0, point_bxyz.shape[0] - 1), 1:4]
        return rep[sampling.farthest_point_sample(xyz, self.num_samples, valid=rep_valid)]


class VolumeSampler:
    """Dilated voxel-centre sampler: each point replicated over the
    (2 STRIDE[2] - 1)^3 stencil of offsets (dx / STRIDE[0], dy / STRIDE[1],
    dz / STRIDE[2]) * VOXEL_SIZE (all three axes over STRIDE[2]'s range, as
    in JAX), the replicas aggregated on the VOXEL_SIZE / DOWNSAMPLE_TIMES
    grid (cells from the replicas' minimum corner), and only the voxels on
    the downsampled lattice kept (coords % DOWNSAMPLE_TIMES == 0 on x and y,
    == Z_PADDING on z, 0 when Z_PADDING is -1). Returns an EDict of
    ``bcoords`` [V, 4], ``bcenter`` [V, 4], ``bxyz`` [V, 4] (the replicas'
    mean) and ``valid`` [V], V = K N."""

    def __init__(self, runtime_cfg=None, model_cfg=None):
        cfg = EDict(model_cfg or {})

        def three(v, cast):
            return [cast(x) for x in (v if isinstance(v, (list, tuple)) else [v] * 3)]

        self.voxel_size = three(cfg.get("VOXEL_SIZE", 0.4), float)
        self.stride = three(cfg.get("STRIDE", 1), int)
        self.downsample_times = three(cfg.get("DOWNSAMPLE_TIMES", 1), int)
        self.z_padding = int(cfg.get("Z_PADDING", 1))

    def __call__(self, point_bxyz, valid=None):
        pts = point_bxyz
        n, dev, dt = pts.shape[0], pts.device, pts.dtype
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=dev)
        s0, s1, s2 = self.stride
        vs = self.voxel_size
        r = range(-s2 + 1, s2)
        offs = torch.tensor([[0.0, dx / s0 * vs[0], dy / s1 * vs[1], dz / s2 * vs[2]]
                             for dx, dy, dz in itertools.product(r, r, r)], dtype=dt, device=dev)
        rep = (pts[None, :, :] + offs[:, None, :]).reshape(-1, 4)
        rep_valid = valid.repeat(offs.shape[0])
        fine = torch.tensor([v / d for v, d in zip(vs, self.downsample_times)], dtype=dt,
                            device=dev)
        origin = torch.where(rep_valid[:, None], rep[:, 1:4],
                             torch.full_like(rep[:, 1:4], float("inf"))).amin(0)
        coords = grid_utils.voxel_coords(rep, fine, origin=origin)
        coords = torch.where(rep_valid[:, None], coords, torch.full_like(coords, 2 ** 24))
        inverse, _, _ = grid_utils.unique_rows(coords)
        cap = rep.shape[0]
        zero = rep.new_zeros(())
        vox_bxyz = segment_ops.segment_mean(torch.where(rep_valid[:, None], rep, zero), inverse,
                                            cap)
        cnt = segment_ops.segment_count(
            torch.where(rep_valid, inverse, torch.full_like(inverse, cap)), cap + 1)[:cap]
        # integer coords are constant within a voxel: their mean is the coord
        vox_coords = segment_ops.segment_mean(
            torch.where(rep_valid[:, None], coords, torch.zeros_like(coords)).to(dt), inverse,
            cap).to(torch.int32)
        dst = self.downsample_times
        zp = 0 if self.z_padding == -1 else self.z_padding
        on_lattice = ((vox_coords[:, 1] % dst[0] == 0) & (vox_coords[:, 2] % dst[1] == 0)
                      & (vox_coords[:, 3] % dst[2] == zp))
        bcenter = torch.cat([vox_coords[:, :1].to(dt),
                             origin[None, :] + (vox_coords[:, 1:4].to(dt) + 0.5) * fine[None, :]],
                            dim=1)
        return EDict(bcoords=vox_coords, bcenter=bcenter, bxyz=vox_bxyz,
                     valid=(cnt > 0.5) & on_lattice)


SAMPLERS = {"FPSSampler": FPSSampler, "GridSampler": GridSampler,
            "VoxelCenterSampler": VoxelCenterSampler, "HybridSampler": HybridSampler,
            "VolumeSampler": VolumeSampler}


def build_sampler(sampler_cfg, runtime_cfg=None):
    return SAMPLERS[sampler_cfg["TYPE"]](runtime_cfg, sampler_cfg)
