"""The port's range-image projection (datasets/range_image.py, torch float64)
against the JAX package's (NumPy float64) on seeded range images: 8 x 16
and 64 x 265, identity, yawed and translated extrinsics, with per-beam
inclinations and with an inclination range.

Tolerances: 1e-12 m in float64 before the cast (the two sum the rotation's
products in their own order); after the cast to float32, at most one ulp
apart, and the pixels kept are the same.
"""

import numpy as np
import pytest
import torch

from pcseqlearning_tpu.datasets import range_image as jri
from pcseqlearning_tpu_torch.datasets import range_image as tri

torch.set_num_threads(1)


def _case(rng, H, W, yaw, per_beam):
    t = np.zeros((H, W, 4), np.float32)
    valid = rng.rand(H, W) < 0.7
    t[..., 0] = np.where(valid, rng.uniform(0.5, 75.0, (H, W)), -1.0)
    t[..., 1] = rng.rand(H, W)
    t[..., 2] = rng.rand(H, W) * 1.5
    t[5 % H, 3 % W, 0] = 0.0  # a zero range is no return either
    ex = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    ex[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    ex[:3, 3] = [1.43, -0.2, 2.18] if yaw else 0.0
    incl = np.sort(rng.uniform(-0.31, 0.05, H)) if per_beam else None
    return t, ex, incl


CASES = [(H, W, yaw, per_beam) for H, W in ((8, 16), (64, 265))
         for yaw in (0.0, 0.3, -2.9) for per_beam in (True, False)]


@pytest.mark.parametrize("H,W,yaw,per_beam", CASES)
def test_range_image_equals_jax(H, W, yaw, per_beam):
    rng = np.random.RandomState(H * 1000 + W + int(per_beam))
    t, ex, incl = _case(rng, H, W, yaw, per_beam)
    rng_lim = (-0.4, 0.1)
    beams = incl if per_beam else jri.compute_inclination(rng_lim, H)
    np.testing.assert_array_equal(tri.compute_inclination(rng_lim, H).numpy(),
                                  jri.compute_inclination(rng_lim, H))
    ref = jri.range_image_to_cartesian(t[..., 0], ex, beams)
    got = tri.range_image_to_cartesian(t[..., 0], ex, beams)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)

    ref_pts = jri.extract_points(t, ex, inclination=incl, inclination_range=rng_lim)
    got_pts = tri.extract_points(t, ex, inclination=incl, inclination_range=rng_lim).numpy()
    assert got_pts.dtype == np.float32 and got_pts.shape == ref_pts.shape
    assert got_pts.shape[0] == int((t[..., 0] > 0).sum())
    ulp = np.spacing(np.maximum(np.abs(got_pts), np.abs(ref_pts)))
    assert (np.abs(got_pts - ref_pts) <= ulp).all()
    np.testing.assert_array_equal(got_pts[:, :3], ref_pts[:, :3])
