"""Point feature extraction (counterpart of pcseqlearning_tpu.models.pfe):
``voxel_centers`` only, which Voxel R-CNN's RoI head pools around. The rest
of the module, ``VoxelSetAbstraction`` and its SA groups, is PV-RCNN's and
waits for it (ROADMAP.md, queue 1 item 4.2)."""

from __future__ import annotations

import torch


def voxel_centers(coords_bzyx, valid, voxel_size, pc_range_min, stride):
    """[V, 3] xyz centres of (strided) voxel coords (b, z, y, x): cell + 0.5
    times the voxel size times ``stride``, from the range's minimum
    corner."""
    dev = coords_bzyx.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    origin = torch.tensor(pc_range_min, dtype=torch.float32, device=dev)
    xyz = coords_bzyx[:, 1:4].flip(-1).to(torch.float32)
    return (xyz + 0.5) * vs[None, :] + origin[None, :]
