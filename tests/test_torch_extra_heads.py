"""The heads of ``models/extra_heads.py`` against the JAX package's: each
head's train-mode forward, its loss and the loss's gradients w.r.t. the
head's parameters, on seeded NumPy inputs at tests/test_extra_heads.py's
sizes; the flax weights carried over by
``convert.detector_params_from_flax``.

``ImplicitReconstructionHead.loss`` matches each sample to its angularly
nearest lidar return with ``pair_min`` at C = 1 on keys (1e3 * batch,
polar, azimuth). The port's pair_min computes direct differences, as the
Pallas kernel does; the JAX package routes the call to XLA's
|a|^2 + |b|^2 - 2 a.b expansion (``pallas_tpu.pair_min``). With batch index
0 the keys are angles and the two agree; from batch 1 on the 1e3 offset
makes the expansion cancel at 1e6, so JAX's own head matches the wrong
return for most samples (on 400 rays, 27 samples each and angular jitter
0.02: 89.7% of batch 1's samples, 99.4% of batch 3's, d^2 errors 0.13-2.0
against spherical_radius^2 = 0.0016). So the head is held to JAX's head as
it runs at batch 1, and at batch 2 to JAX's head with ``pair_min``
replaced, in the test only, by the Pallas kernel in interpret mode (the
wrapper's transposition and +inf restore), which computes direct
differences as the port does.

Tolerances: outputs and losses 1e-5 (relative for losses above 1); each
parameter's gradient within 1e-4 of that tensor's max |g|, or within 1e-6
of the largest |g| of the head where that is more (a bias before a batch
norm carries only rounding); targets and labels exactly. Budget: ~55 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import extra_heads as jeh
from pcseqlearning_tpu.ops import pallas_tpu as jpt
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import extra_heads as teh

torch.set_num_threads(1)
T = torch.as_tensor
PCR = (-3.2, -3.2, -1.0, 3.2, 3.2, 2.2)
ANCHOR_CFGS = (
    dict(sizes=[(1.6, 1.6, 1.0)], rotations=(0.0, 1.57), heights=(0.0,),
         matched_threshold=0.4, unmatched_threshold=0.2),
    dict(sizes=[(0.8, 0.8, 1.0)], rotations=(0.0, 1.57), heights=(0.0,),
         matched_threshold=0.3, unmatched_threshold=0.15),
)


def _state(variables, parent="head"):
    sd = detector_params_from_flax({coll: {parent: jax.tree_util.tree_map(np.asarray, tree)}
                                    for coll, tree in variables.items()})
    return {k.split(".", 1)[1]: t for k, t in sd.items()}


def _to_j(bd):
    return {k: jnp.asarray(v) for k, v in bd.items()}


def _to_t(bd):
    return {k: T(v) for k, v in bd.items()}


def run_head(jm, tm, bd, jloss, tloss, out_keys, atol=1e-5, parent="head", loss_rtol=1e-5,
             grad_rtol=1e-4, jax_grads=True):
    """Train-mode forward and loss through both heads; the loss's gradients
    w.r.t. the parameters (without ``jax_grads``, only that JAX's are
    not finite). ``jloss(out)`` / ``tloss(out)`` take a head's output dict.
    Returns (port loss, JAX loss, port out, JAX out)."""
    jb = _to_j(bd)
    v = jm.init(jax.random.PRNGKey(0), jb, train=True)

    def f(p):
        out, _ = jm.apply({**v, "params": p}, dict(jb), train=True, mutable=["batch_stats"])
        return jloss(out), out

    (jl, jout), jg = jax.value_and_grad(f, has_aux=True)(v["params"])
    tm.load_state_dict(_state(v, parent), strict=True)
    tm.train()
    out = tm(_to_t(bd))
    tl = tloss(out)
    tl.backward()
    rel = max(1.0, abs(float(jl)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=loss_rtol * rel)
    for k in out_keys:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), atol=atol,
                                   err_msg=k)
    ref = _state({"params": jg}, parent)
    if not jax_grads:
        assert any(not torch.isfinite(r).all() for r in ref.values())
        return tl, jl, out, jout
    gmax = max(float(r.abs().max()) for r in ref.values())
    for name, p in tm.named_parameters():
        tol = max(grad_rtol * float(ref[name].abs().max()), 1e-6 * gmax)
        g = torch.zeros_like(p) if p.grad is None else p.grad  # a layer the loss skips
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=0, atol=tol, err_msg=name)
    return tl, jl, out, jout


def test_registry_names_equal_jax():
    assert set(teh.EXTRA_HEADS) == set(jeh.EXTRA_HEADS)


def test_anchor_head_multi_equals_jax(rng):
    """The shared conv and the single head's convs over an NHWC (JAX) /
    NCHW (port) map, then the single head's rpn_loss."""
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.5, 1.5, 1.0, 0.3, 1]
    gt[1, 1] = [-1.0, -1.0, 0.5, 1.0, 1.0, 1.0, -0.3, 2]
    jm = jeh.AnchorHeadMulti(num_classes=2, grid_size_xy=(8, 8), point_cloud_range=PCR,
                             anchor_cfgs=ANCHOR_CFGS, shared_channels=12)
    tm = teh.AnchorHeadMulti(16, 2, (8, 8), PCR, ANCHOR_CFGS, shared_channels=12)
    jb = {"spatial_features_2d": jnp.asarray(x), "gt_boxes": jnp.asarray(gt)}
    v = jm.init(jax.random.PRNGKey(0), jb)

    def f(p):
        out = jm.apply({"params": p}, dict(jb))
        return jm.apply({"params": p}, out, method=lambda m, d: m.loss(d))["rpn_loss"], out

    (jl, jout), jg = jax.value_and_grad(f, has_aux=True)(v["params"])
    tm.load_state_dict(_state(v, "x"), strict=True)
    out = tm({"spatial_features_2d": T(x).permute(0, 3, 1, 2), "gt_boxes": T(gt)})
    tl = tm.loss(out)["rpn_loss"]
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("cls_preds", "box_preds", "dir_preds"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), atol=1e-5)
    ref = _state({"params": jg}, "x")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=1e-4 * float(ref[name].abs().max()), err_msg=name)


def _points(rng, n=120, c=16):
    coords = np.concatenate([rng.randint(0, 2, (n, 1)), rng.rand(n, 3) * 4 - 2], 1)
    return {"point_features": rng.randn(n, c).astype(np.float32),
            "point_coords": coords.astype(np.float32), "point_valid": np.arange(n) < n - 8}


def test_part_offset_head_equals_jax(rng):
    bd = _points(rng)
    gt = np.zeros((2, 3, 8), np.float32)
    gt[0, 0] = [0, 0, 0, 2, 2, 2, 0.3, 1]
    gt[1, 0] = [0.5, -0.5, 0, 1.5, 2.5, 2, -0.4, 2]
    gt[1, 1] = [-1, 1, 0, 1, 1, 2, 0.0, 1]
    tl, jl, out, _ = run_head(
        jeh.PointIntraPartOffsetHead(num_classes=3, hidden=(32, 16)),
        teh.PointIntraPartOffsetHead(16, 3, hidden=(32, 16)), bd,
        lambda o: sum(jeh.PointIntraPartOffsetHead.loss(o, jnp.asarray(gt))),
        lambda o: sum(teh.PointIntraPartOffsetHead.loss(o, T(gt))),
        ("point_cls_preds", "point_part_preds"))
    for b in range(2):
        jlab, jpart = jeh.PointIntraPartOffsetHead.build_targets(
            jnp.asarray(bd["point_coords"]), jnp.asarray(gt[b]))
        tlab, tpart = teh.PointIntraPartOffsetHead.build_targets(T(bd["point_coords"]), T(gt[b]))
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
        np.testing.assert_allclose(tpart.numpy(), np.asarray(jpart), atol=1e-5)
        assert (np.asarray(jlab) > 0).sum() > 5


def _voxels(rng, n=64, c=16):
    return {"voxel_features": rng.randn(n, c).astype(np.float32),
            "voxel_valid": np.arange(n) < 50}


@pytest.mark.parametrize("use_lovasz", [False, True])
def test_voxel_seg_head_equals_jax(rng, use_lovasz):
    bd = _voxels(rng)
    labels = rng.randint(-1, 5, 64)
    run_head(jeh.VoxelSegHead(num_classes=5), teh.VoxelSegHead(16, 5), bd,
             lambda o: jeh.VoxelSegHead.loss(o, jnp.asarray(labels), jnp.asarray(bd["voxel_valid"]),
                                             use_lovasz=use_lovasz),
             lambda o: teh.VoxelSegHead.loss(o, T(labels), T(bd["voxel_valid"]),
                                             use_lovasz=use_lovasz),
             ("seg_logits",))


def test_lovasz_softmax_equals_jax(rng):
    """Ties in the errors (equal probabilities) sort stably, as in JAX."""
    probs = rng.rand(40, 4).astype(np.float32)
    probs[10:20] = probs[10]
    probs /= probs.sum(1, keepdims=True)
    labels = rng.randint(0, 4, 40)
    valid = np.arange(40) < 35
    pj = jnp.asarray(probs)
    want, jg = jax.value_and_grad(lambda p: jeh.lovasz_softmax(p, jnp.asarray(labels),
                                                               jnp.asarray(valid)))(pj)
    pt = T(probs).clone().requires_grad_()
    got = teh.lovasz_softmax(pt, T(labels), T(valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg), atol=1e-6)


def _discriminative_safe(embed, ids, valid, num, delta_v=0.5, delta_d=1.5):
    """JAX's discriminative loss written out with the centroid distances'
    norm taken only off the diagonal (JAX's own gradient is NaN there)."""
    from pcseqlearning_tpu.ops import segment_ops

    real = valid & (ids >= 0)
    seg = jnp.where(real, ids, num)
    cen = segment_ops.segment_mean(embed, seg, num + 1)[:num]
    has = segment_ops.segment_count(seg, num + 1)[:num] > 0.5
    d = jnp.linalg.norm(embed - cen[jnp.clip(ids, 0, num - 1)], axis=-1)
    pull = jnp.sum(jnp.where(real, jnp.maximum(d - delta_v, 0.0) ** 2, 0.0)) / jnp.maximum(
        jnp.sum(real), 1)
    eye = jnp.eye(num, dtype=bool)
    diff = jnp.where(eye[..., None], 1.0, cen[:, None] - cen[None, :])
    cd = jnp.linalg.norm(diff, axis=-1)
    pair = has[:, None] & has[None, :] & ~eye
    push = jnp.sum(jnp.where(pair, jnp.maximum(2 * delta_d - cd, 0.0) ** 2, 0.0)) / jnp.maximum(
        jnp.sum(pair), 1)
    return pull + push


def test_embed_seg_head_equals_jax(rng):
    """The head's outputs and the discriminative loss equal JAX's. JAX's
    gradient of that loss is NaN for every parameter: it takes the norm of
    the centroid distance matrix's zero diagonal, whose derivative is 0 / 0
    (masked afterwards, which does not clear a NaN); torch's norm has
    gradient 0 at 0. So the port's gradients are held to JAX's gradient of
    the same loss with that norm taken off the diagonal."""
    bd = _points(rng, 60)
    inst = np.repeat(np.arange(3), 20)
    inst[:4] = -1
    valid = bd["point_valid"]
    jm, tm = jeh.EmbedSegHead(num_classes=4, embed_dim=8), teh.EmbedSegHead(16, 4, embed_dim=8)

    def tloss(o):
        return teh.EmbedSegHead.discriminative_loss(o["seg_embedding"], T(inst), T(valid), 3)

    tl, jl, _, _ = run_head(
        jm, tm, bd, lambda o: jeh.EmbedSegHead.discriminative_loss(
            o["seg_embedding"], jnp.asarray(inst), jnp.asarray(valid), 3),
        tloss, ("seg_logits", "seg_embedding"), jax_grads=False)
    tm.zero_grad()
    run_head(jm, tm, bd, lambda o: _discriminative_safe(
        o["seg_embedding"], jnp.asarray(inst), jnp.asarray(valid), 3), tloss,
        ("seg_embedding",))
    assert float(jl) > 0


def test_primitive_head_equals_jax(rng):
    bd = _voxels(rng, 32, 10)
    gt_n = rng.randn(32, 3).astype(np.float32)
    gt_n /= np.linalg.norm(gt_n, axis=1, keepdims=True)
    run_head(jeh.PrimitiveHead(), teh.PrimitiveHead(10), bd,
             lambda o: jeh.PrimitiveHead.loss(o, jnp.asarray(gt_n), jnp.asarray(bd["voxel_valid"])),
             lambda o: teh.PrimitiveHead.loss(o, T(gt_n), T(bd["voxel_valid"])),
             ("primitive_normal_preds", "primitive_offset_preds"))


def test_hybrid_seg_head_equals_jax(rng):
    bd = _points(rng)
    labels = rng.randint(-1, 4, 120)
    labels[:30] = 0  # one class above the count floor of 20
    run_head(jeh.HybridSegHead(num_classes=4, fc=(32, 16)), teh.HybridSegHead(16, 4, fc=(32, 16)),
             bd, lambda o: jeh.HybridSegHead.loss(o, jnp.asarray(labels),
                                                  jnp.asarray(bd["point_valid"])),
             lambda o: teh.HybridSegHead.loss(o, T(labels), T(bd["point_valid"])),
             ("pred_seg_cls_logits",))


def _lidar(batch, n=96, seed=0):
    """n returns a sample: directions on a jittered polar-azimuth lattice
    (jitter 0.02 rad), ranges 4-12 m; 6 of them padding."""
    rng = np.random.RandomState(seed)
    rows = []
    for b in range(batch):
        pol = np.linspace(1.3, 1.8, 8).repeat(n // 8) + rng.randn(n) * 0.02
        az = np.tile(np.linspace(-1.0, 1.0, n // 8), 8) + rng.randn(n) * 0.02
        r = rng.rand(n) * 8 + 4
        xyz = np.stack([r * np.sin(pol) * np.cos(az), r * np.sin(pol) * np.sin(az),
                        r * np.cos(pol)], 1)
        rows.append(np.concatenate([np.full((n, 1), b), xyz], 1))
    coords = np.concatenate(rows).astype(np.float32)
    m = len(coords)
    return {"point_features": rng.randn(m, 16).astype(np.float32), "point_coords": coords,
            "point_valid": np.arange(m) % n < n - 6}


def _interpret_pair_min(a, b, a_mask, b_mask):
    """pallas_tpu.pair_min's kernel path, in interpret mode: direct
    differences."""
    C, P, _ = a.shape
    Q = b.shape[1]
    at = jnp.concatenate([jnp.swapaxes(a, 1, 2), jnp.zeros((C, 1, P), a.dtype)], 1)
    bt = jnp.concatenate([jnp.swapaxes(b, 1, 2), jnp.zeros((C, 1, Q), b.dtype)], 1)
    fd, fi, bd, bi = jpt._pallas_pair_min(at.astype(jnp.float32), bt.astype(jnp.float32),
                                          a_mask.astype(jnp.float32), b_mask.astype(jnp.float32),
                                          interpret=True)
    fd = jnp.where(fd >= jpt._BIG * 0.5, jnp.inf, fd)
    bd = jnp.where(bd >= jpt._BIG * 0.5, jnp.inf, bd)
    return fd, fi, bd, bi


@pytest.mark.parametrize("batch", [1, 2])
def test_implicit_reconstruction_head_equals_jax(batch, monkeypatch):
    """At batch 1 against JAX's head as it runs: its XLA expansion puts
    errors of ~1e-6 in the angular d^2, which the certainty (spherical_radius
    - sqrt(d^2)) / spherical_radius magnifies near a match; measured 7.2e-5
    relative in the loss and 2.2e-3 of a tensor's max in the gradients, so
    the loss is held to 1e-3 relative and the gradients to 1e-2 of each
    tensor's max. At batch 2 against the direct
    differences of the Pallas path, at the file's tolerances."""
    if batch > 1:
        monkeypatch.setattr(jpt, "pair_min", _interpret_pair_min)
    bd = _lidar(batch)
    loose = dict(loss_rtol=1e-3, grad_rtol=1e-2) if batch == 1 else {}
    tl, jl, out, _ = run_head(
        jeh.ImplicitReconstructionHead(latent=(32, 16)),
        teh.ImplicitReconstructionHead(16, latent=(32, 16)), bd,
        lambda o: jeh.ImplicitReconstructionHead.loss(o), teh.ImplicitReconstructionHead.loss,
        ("rec_occupancy_logits", "rec_sample_xyz"), **loose)
    assert float(jl) > 0


def test_implicit_reconstruction_matches_the_nearest_return(monkeypatch):
    """The head's matches are the float64 nearest returns in (1e3 batch,
    polar, azimuth) at batch 2, where JAX's XLA expansion is off: the
    port's loss equals a loss computed with float64 direct differences."""
    bd = _lidar(2, seed=1)
    tm = teh.ImplicitReconstructionHead(16, latent=(32, 16))
    out = tm(_to_t(bd))
    calls = []

    def f64_pair_min(a, b, am, bm):
        calls.append(a.shape)
        d = ((a[0].double()[:, None, :] - b[0].double()[None, :, :]) ** 2).sum(-1)
        d = torch.where(bm[0][None, :], d, torch.full_like(d, float("inf")))
        fd, fi = d.min(1)
        return fd.float()[None], fi.int()[None], None, None

    want = teh.ImplicitReconstructionHead.loss(out)
    monkeypatch.setattr(teh, "pair_min", f64_pair_min)
    got = teh.ImplicitReconstructionHead.loss(out)
    assert calls and calls[0][1] == 27 * 192
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_point_sequence_reconstruction_head_equals_jax(rng):
    bd = _points(rng, 80)
    bd["point_coords"][:, 1:4] *= 0.5
    run_head(jeh.PointSequenceReconstructionHead(latent=(32, 16), num_predicted_points=6),
             teh.PointSequenceReconstructionHead(16, latent=(32, 16), num_predicted_points=6), bd,
             lambda o: jeh.PointSequenceReconstructionHead.loss(o, radius=0.8),
             lambda o: teh.PointSequenceReconstructionHead.loss(o, radius=0.8),
             ("rec_pred_nbrhood",))
