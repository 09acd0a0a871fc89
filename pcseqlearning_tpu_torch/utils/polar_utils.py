"""Cartesian <-> spherical coordinates (counterpart of
pcseqlearning_tpu.utils.polar_utils): NumPy arrays in, NumPy out; torch
tensors in, tensors out."""

from __future__ import annotations

import numpy as np
import torch


def cartesian_to_spherical(xyz):
    """[..., 3] -> [..., 3] (r, theta: inclination from +z, phi: azimuth)."""
    if isinstance(xyz, torch.Tensor):
        r = torch.linalg.norm(xyz, dim=-1)
        theta = torch.arccos(torch.clip(xyz[..., 2] / torch.clamp(r, min=1e-9), -1.0, 1.0))
        return torch.stack([r, theta, torch.atan2(xyz[..., 1], xyz[..., 0])], dim=-1)
    r = np.linalg.norm(xyz, axis=-1)
    theta = np.arccos(np.clip(xyz[..., 2] / np.maximum(r, 1e-9), -1.0, 1.0))
    return np.stack([r, theta, np.arctan2(xyz[..., 1], xyz[..., 0])], axis=-1)


def spherical_to_cartesian(rtp):
    """[..., 3] (r, theta, phi) -> [..., 3] (x, y, z)."""
    xp = torch if isinstance(rtp, torch.Tensor) else np
    r, theta, phi = rtp[..., 0], rtp[..., 1], rtp[..., 2]
    st = xp.sin(theta)
    return xp.stack([r * st * xp.cos(phi), r * st * xp.sin(phi), r * xp.cos(theta)], -1)
