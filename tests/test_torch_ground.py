"""Ground removal: the port against the JAX GroundPlaneRemover.

The deterministic pieces must match to float32 rounding: pillar stats,
RANSAC inlier counts, the L1 loss gradient (JAX's d|x|/dx is +1 at 0) and
the AdamW step (bitwise, against optax). The whole stage is held
statistically: its L1 height field is Adam on sign gradients, where a
one-ulp difference in a near-zero second difference flips a sign and moves
a pillar by a whole learning-rate step, so per-point heights drift by up
to ~0.1 m between any two float orderings. What the pipeline consumes is
the removal mask (height < TRUNCATE_HEIGHT), which must agree on >= 99.9%
of points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcseqlearning_tpu.preprocessing import ground_removal as jg
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.ops.optim import AdamW, multistep_lr
from pcseqlearning_tpu_torch.pipeline import PARITY
from pcseqlearning_tpu_torch.preprocessing import ground_removal as tg
from pcseqlearning_tpu_torch.scene import make_scene, scene_dict

T = torch.as_tensor
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)


def _voxels(F=3, N=2500):
    seq, _ = make_scene(F, N)
    f0 = seq.copy()
    f0[:, 0] = 0
    xy = seq[:, 1:3]
    pcr = xy.min(0) - 0.05
    dims = np.floor((xy.max(0) - pcr) / 2.0).astype(int) + 1
    dims = (int(np.ceil(dims[0] / 8) * 8), int(np.ceil(dims[1] / 8) * 8))
    from pcseqlearning_tpu.ops import grid_utils as jgrid
    from pcseqlearning_tpu_torch.ops import grid_utils as tgrid

    return (jgrid.grid_sample_mean(jnp.asarray(f0), [0.1, 0.1, 0.03]),
            tgrid.grid_sample_mean(T(f0), [0.1, 0.1, 0.03]), pcr, dims)


def test_pillars_and_ransac_match_jax():
    vj, vt, pcr, dims = _voxels()
    pj, plj = jg.format_pillars(vj["bxyz"], vj["valid"], (2.0, 2.0), jnp.asarray(pcr), dims)
    pt, plt = tg.format_pillars(vt["bxyz"], vt["valid"], (2.0, 2.0), T(pcr), dims)
    for k in plt:
        np.testing.assert_allclose(plt[k].numpy(), np.asarray(plj[k]), rtol=1e-6, atol=1e-6)
    nv = vt["num_voxels"]  # the JAX voxel table is padded to the point count
    np.testing.assert_array_equal(pt.pillar_idx.numpy(), np.asarray(pj.pillar_idx)[:nv])

    X, Y = dims
    NY = (Y + 3) // 4
    NP = ((X + 3) // 4) * NY
    new_pidx, nmin, nmax = jg._coarse_tables(vj["bxyz"], vj["valid"], pj, dims, 4, NP, NY)
    cj, nj, ctrj = map(np.asarray, jg._ransac_all_ratios(
        vj["bxyz"][:, 1:4], vj["valid"], vj["bxyz"][:, 3], new_pidx, nmin, nmax, NP=NP,
        sigma2=0.0025))
    ct, nt, ctrt = (x.numpy() for x in tg._ransac_all_ratios(
        vt["bxyz"][:, 1:4], vt["valid"], vt["bxyz"][:, 3], T(np.asarray(new_pidx)[:nv]),
        T(np.asarray(nmin)), T(np.asarray(nmax)), NP, 0.0025))
    np.testing.assert_array_equal(ct, cj)  # inlier counts
    # plane normals agree up to the eigenvector sign and centers to 1 mm,
    # except in degenerate pillars (a few collinear voxels have no unique
    # normal; float noise picks one) — the inlier counts above, which pick
    # the plane, agree exactly
    fitted = cj > 0.5
    dots = np.abs((nt * nj).sum(-1))
    assert (dots[fitted] > 0.999).mean() >= 0.95
    assert (np.abs(ctrt - ctrj).max(-1)[fitted] < 1e-3).mean() >= 0.95


def _jax_l1_loss(h, min_z, weight, rigid_weight=0.5):
    """The loss of pcseqlearning_tpu's l1_minimization, written out."""
    l1 = jnp.mean(jnp.abs((h - min_z) * weight))
    left = jnp.mean(jnp.abs((h[:-2] - 2 * h[1:-1] + h[2:]) * (weight[1:-1] + 1e-2)))
    up = jnp.mean(jnp.abs((h[:, :-2] - 2 * h[:, 1:-1] + h[:, 2:]) * (weight[:, 1:-1] + 1e-2)))
    t1 = jnp.mean(jnp.abs((h[:-2, :-2] - 2 * h[1:-1, 1:-1] + h[2:, 2:])
                          * (weight[1:-1, 1:-1] + 1e-2)))
    t2 = jnp.mean(jnp.abs((h[2:, :-2] - 2 * h[1:-1, 1:-1] + h[:-2, 2:])
                          * (weight[1:-1, 1:-1] + 1e-2)))
    return l1 + (left + up + t1 + t2) * rigid_weight


def test_l1_loss_grad_matches_jax_autodiff():
    rng = np.random.RandomState(0)
    m = (rng.randn(16, 24) * 0.1).astype(np.float32)
    w = (rng.rand(16, 24) > 0.3).astype(np.float32)
    for h in (np.zeros((16, 24), np.float32),  # every term at |0|: JAX's grad is +1
              (rng.randn(16, 24) * 0.1).astype(np.float32)):
        lj, gj = jax.value_and_grad(_jax_l1_loss)(jnp.asarray(h), jnp.asarray(m), jnp.asarray(w))
        lt, gt = tg.l1_loss_grad(T(h), T(m), T(w), 0.5)
        assert float(lt) == pytest.approx(float(lj), rel=1e-6)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-8)


def test_adamw_matches_optax_bitwise():
    rng = np.random.RandomState(0)
    p0 = rng.randn(50).astype(np.float32)
    opt = optax.adamw(learning_rate=lambda s: 0.01 * jnp.where(s >= 3, 0.1, 1.0))
    pj = jnp.asarray(p0)
    st = opt.init(pj)
    pt = T(p0)
    ot = AdamW(pt)
    for i in range(6):
        g = rng.randn(50).astype(np.float32)
        u, st = opt.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, u)
        pt = ot.step(pt, T(g), multistep_lr(0.01, i, (3,)))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_l1_first_step_matches_jax():
    rng = np.random.RandomState(1)
    mz = (rng.randn(16 * 24) * 0.1).astype(np.float32)
    w = (rng.rand(16 * 24) > 0.3).astype(np.float32)
    hj = jg.l1_minimization(jnp.asarray(mz), jnp.asarray(w), (16, 24), 0.01, (400,), 0.5, 1)
    ht = tg.l1_minimization(T(mz), T(w), (16, 24), 0.01, (400,), 0.5, 1)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-8)


def test_ground_stage_masks_match_jax():
    d = scene_dict(3, 2000, seed=2)
    hj = np.asarray(jg.GroundPlaneRemover(JEDict(PARITY["ground"]))(dict(d))["full_point_height"])
    out = tg.GroundPlaneRemover(PARITY["ground"], device="cpu")(dict(d))
    ht = out["full_point_height"]
    assert ht.shape == hj.shape
    assert ((ht < 0.5) == (hj < 0.5)).mean() >= 0.999
    assert np.median(np.abs(ht - hj)) < 1e-2
    # the stage's outputs are the reference's: filtered and full_* tables
    keep = ~(ht < 0.5)
    np.testing.assert_array_equal(out["point_fxyz"], d["point_fxyz"][keep])
    np.testing.assert_array_equal(out["full_point_keep0"], ht > 0)


def test_ground_rejects_unported_keys():
    with pytest.raises(ValueError):
        tg.GroundPlaneRemover(dict(PARITY["ground"], DIR="/nonexistent"), device="cpu")
