"""The port's RoI-aware pooling and PartA2's RoI head against the JAX
package's, on the same seeded NumPy inputs.

Tolerances: occupancy exact; pooled features 1e-6 absolute on O(1)
features (each cell sums its points in the same order); the feature
gradient 1e-6; PartA2FCHead's outputs 1e-5 of max |value|, its gradients
1e-3 of each tensor's max |g|, its new batch statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import roi_heads as jrh
from pcseqlearning_tpu.ops import roi_pool as jrp
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import roi_heads as trh
from pcseqlearning_tpu_torch.ops import roi_pool as trp

torch.set_num_threads(1)
T = torch.as_tensor


def _scene(rng, n=3000, r=40):
    """Points over 8 x 8 x 3 m (a fifth of them not valid), RoIs of 1-3 m
    at any heading around the points (a quarter of them not valid, and more
    RoIs than one chunk of the port's loop)."""
    pts = (rng.rand(n, 3) * [8, 8, 3] - [4, 4, 1]).astype(np.float32)
    feats = rng.randn(n, 3).astype(np.float32)
    rois = np.concatenate([rng.rand(r, 3) * [6, 6, 1] - [3, 3, 0], rng.rand(r, 3) * 2 + 1,
                           rng.rand(r, 1) * 2 * np.pi - np.pi], axis=1).astype(np.float32)
    return pts, feats, rois, rng.rand(n) > 0.2, rng.rand(r) > 0.25


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("grid", [2, 6])
def test_roiaware_pool_equals_jax(rng, pool, grid):
    pts, feats, rois, pv, rv = _scene(rng)
    dy = rng.randn(len(rois), grid, grid, grid, 3).astype(np.float32)

    def jloss(f):
        pooled, occ = jrp.roiaware_pool3d(jnp.asarray(pts), f, jnp.asarray(rois),
                                          point_valid=jnp.asarray(pv), roi_valid=jnp.asarray(rv),
                                          grid_size=grid, pool=pool)
        return jnp.sum(pooled * dy), (pooled, occ)

    (_, (jpooled, jocc)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(feats))
    f = T(feats).clone().requires_grad_(True)
    pooled, occ = trp.roiaware_pool3d(T(pts), f, T(rois), T(pv), T(rv), grid_size=grid, pool=pool)
    (pooled * T(dy)).sum().backward()
    jocc = np.asarray(jocc)
    print(pool, grid, "occupied cells", int(jocc.sum()), "of", jocc.size)
    assert jocc.sum() > len(rois) // 2
    assert not jocc[~rv].any()  # an invalid RoI pools nothing
    np.testing.assert_array_equal(occ.numpy(), jocc)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(jpooled), atol=1e-6)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_roiaware_pool_pools_across_samples():
    """The JAX function takes no batch index: a point of any sample pools
    into every RoI it falls in (PartA2's head passes the whole batch)."""
    pts = np.array([[0.1, 0.1, 0.1], [0.2, -0.1, 0.0]], np.float32)
    feats = np.array([[1.0], [3.0]], np.float32)
    roi = np.array([[0, 0, 0, 1, 1, 1, 0.3]], np.float32)
    pooled, occ = trp.roiaware_pool3d(T(pts), T(feats), T(roi), grid_size=1, pool="avg")
    jp, jo = jrp.roiaware_pool3d(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(roi),
                                 grid_size=1, pool="avg")
    assert float(pooled.reshape(-1)[0]) == float(np.asarray(jp).reshape(-1)[0]) == 2.0
    assert bool(occ.all()) and bool(np.asarray(jo).all())


@pytest.mark.parametrize("train", [True, False])
def test_part_a2_fc_head_equals_jax(rng, train):
    """PartA2FCHead (12^3 average pooling of the raw point features, the FC
    trunk) on a two-sample batch, in training and in eval mode: class and
    box outputs, in training the gradients of <cls, a> + <reg, b> and the
    new batch statistics."""
    pts, feats, rois, pv, rv = _scene(rng, n=2000, r=24)
    bxyz = np.concatenate([rng.randint(0, 2, (len(pts), 1)).astype(np.float32), pts], axis=1)
    batch = {"point_bxyz": bxyz, "point_feat": feats[:, :1], "point_valid": pv}
    a = rng.randn(len(rois)).astype(np.float32)
    b = rng.randn(len(rois), 7).astype(np.float32)
    jm = jrh.PartA2FCHead()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jm.init(jax.random.PRNGKey(0), jb, jnp.asarray(rois), jnp.asarray(rv), train=True)
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda v: v + 0.2, variables["batch_stats"])}

    def jloss(params):
        (cls, reg), mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jb, jnp.asarray(rois), jnp.asarray(rv), train=train,
                                   mutable=["batch_stats"])
        return jnp.sum(cls * a) + jnp.sum(reg * b), (cls, reg, mut)

    (_, (jcls, jreg, mut)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    sd = detector_params_from_flax({c: {"roi_head": v} for c, v in variables.items()})
    tm = trh.PartA2FCHead(1)
    tm.load_state_dict({k[len("roi_head."):]: v for k, v in sd.items()}, strict=True)
    tm.train(train)
    cls, reg = tm({k: T(v) for k, v in batch.items()}, T(rois), T(rv))
    ((cls * T(a)).sum() + (reg * T(b)).sum()).backward()
    for got, want in ((cls, jcls), (reg, jreg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5 * np.abs(want).max())
    ref = detector_params_from_flax({"params": {"roi_head": jg}})
    for n, p in tm.named_parameters():
        r = ref["roi_head." + n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-12),
                                   err_msg=n)
    if train:
        stats = detector_params_from_flax({"batch_stats": {"roi_head": mut["batch_stats"]}})
        tsd = tm.state_dict()
        for k, r in stats.items():
            np.testing.assert_allclose(tsd[k[len("roi_head."):]].numpy(), r.numpy(), atol=1e-5,
                                       err_msg=k)
