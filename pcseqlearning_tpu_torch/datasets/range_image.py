"""Waymo range image -> point cloud, in float64 on a torch device
(counterpart of pcseqlearning_tpu.datasets.range_image, which computes the
same in NumPy float64).

Conventions (Waymo Open Dataset spec, as the JAX module keeps them):
- range image rows sweep inclination with the TOP row at the MAX
  inclination; calibrations list beams bottom to top, so the rows are the
  reversed beam list;
- columns sweep azimuth from +pi (col 0) to -pi (last col), pixel centres
  at azimuth (1 - 2 (col + 0.5) / W) pi, less the extrinsic's yaw
  atan2(ex[1, 0], ex[0, 0]), so that azimuth is measured in the vehicle
  frame;
- a pixel (r, row, col) is x = r cos(incl) cos(az), y = r cos(incl)
  sin(az), z = r sin(incl) in the sensor frame, then goes through the
  extrinsic into the vehicle frame;
- pixels with range <= 0 are invalid.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _f64(x, device):
    """``x`` on ``device`` as float64, copied in its own dtype and cast there."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=device).to(torch.float64)


def compute_inclination(inclination_range, height, device="cpu"):
    """Inclinations [height] (float64) of ``height`` uniform rows spanning
    [min, max] at pixel centres, ascending: beam order, not row order."""
    lo, hi = float(inclination_range[0]), float(inclination_range[1])
    return lo + (hi - lo) * (torch.arange(height, dtype=torch.float64, device=device) + 0.5) \
        / height


def range_image_to_cartesian(range_image, extrinsic, inclination, device="cpu"):
    """[H, W] ranges -> [H, W, 3] vehicle-frame xyz, float64 on ``device``.

    extrinsic: [4, 4] sensor-to-vehicle transform; inclination: [H] beam
    inclinations in beam order (ascending)."""
    ri = _f64(range_image, device)
    H, W = ri.shape
    incl = _f64(inclination, device).flip(0)  # row order: top = max
    ex = _f64(extrinsic, device)
    ex_host = ex.cpu().numpy()
    az_correction = math.atan2(ex_host[1, 0], ex_host[0, 0])
    ratios = (torch.arange(W, dtype=torch.float64, device=device) + 0.5) / W
    azimuth = (1.0 - 2.0 * ratios) * math.pi - az_correction  # [W]
    cos_az, sin_az = torch.cos(azimuth)[None, :], torch.sin(azimuth)[None, :]
    cos_incl, sin_incl = torch.cos(incl)[:, None], torch.sin(incl)[:, None]
    x = ri * cos_incl * cos_az
    y = ri * cos_incl * sin_az
    z = ri * sin_incl
    pts = torch.stack([x, y, z], dim=-1)  # sensor frame
    return pts @ ex[:3, :3].T + ex[:3, 3]


def extract_points(range_image_tensor, extrinsic, inclination=None,
                   inclination_range=(-0.31, 0.06), device="cpu"):
    """One return's points: [N, 6] float32 (range, intensity, elongation, x,
    y, z) of the pixels whose range is > 0, in row-major pixel order, on
    ``device``. ``range_image_tensor`` is [H, W, C >= 3] with channels
    (range, intensity, elongation, ...); without ``inclination``, H uniform
    rows over ``inclination_range``."""
    t = _f64(range_image_tensor, device)
    H = t.shape[0]
    if inclination is None:
        inclination = compute_inclination(inclination_range, H, device)
    xyz = range_image_to_cartesian(t[..., 0], extrinsic, inclination, device)
    mask = t[..., 0] > 0
    return torch.cat([t[..., :3][mask], xyz[mask]], dim=-1).to(torch.float32)
