"""The two-stage machinery against the JAX package's: RoI grid points, the
proposal layer, RoI target assignment, the refinement decode and losses,
and VoxelRCNNHead with flax weights carried over by
``convert.detector_params_from_flax``.

Inputs are seeded NumPy draws at toy sizes (10-30 RoIs, a few hundred
voxels a stage). Tolerances: grid points, targets, decode and losses, and
their gradients w.r.t. the RoIs, 1e-5; the proposal layer's valid mask and
order exact, its boxes 1e-6; VoxelRCNNHead's outputs and gradients (w.r.t.
the RoIs and the voxel features) 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import roi_heads as jrh
from pcseqlearning_tpu.ops import boxes as jbx
from pcseqlearning_tpu.ops import roi_pool as jrp
from pcseqlearning_tpu.ops import sparse_conv as jsc
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import roi_heads as trh
from pcseqlearning_tpu_torch.ops import boxes as tbx
from pcseqlearning_tpu_torch.ops import roi_pool as trp
from pcseqlearning_tpu_torch.ops import sparse_conv as tsc

torch.set_num_threads(1)
T = torch.as_tensor
VS, PCR = (0.2, 0.2, 0.2), (-3.2, -3.2, -1.0, 3.2, 3.2, 2.2)


def rois_near(rng, gt, per_gt=4, noise=0.2):
    r = np.repeat(gt, per_gt, 0) + rng.randn(len(gt) * per_gt, 7).astype(np.float32) * noise
    r[:, 3:6] = np.abs(r[:, 3:6]) + 0.3
    return r


def gt_boxes(rng, g=3):
    gt = np.zeros((g, 7), np.float32)
    gt[:, :3] = rng.randn(g, 3)
    gt[:, 3:6] = rng.rand(g, 3) + 1
    gt[:, 6] = rng.randn(g)
    return gt


def test_roi_grid_points_equal_jax(rng):
    rois = rois_near(rng, gt_boxes(rng))
    for g in (3, 6):
        got = trp.roi_grid_points(T(rois), g).numpy()
        np.testing.assert_allclose(got, np.asarray(jrp.roi_grid_points(jnp.asarray(rois), g)),
                                   atol=1e-5)
    # tests/test_roi_heads.py's case: every point strictly inside its box
    one = np.array([[5, 3, 1, 4, 2, 2, 0.7]], np.float32)
    pts = trp.roi_grid_points(T(one), 4)[0]
    assert tbx.points_in_boxes(pts, T(one)).all()


@pytest.mark.parametrize("thresh", [0.55, 0.3])
def test_proposal_layer_equals_jax(rng, thresh):
    """Tied scores, more candidates than pre_max and than num_rois."""
    gt = gt_boxes(rng, 6)
    cand = rois_near(rng, gt, per_gt=8, noise=0.4)
    scores = np.round(rng.rand(len(cand)), 1).astype(np.float32)
    iou = np.array(jbx.boxes_iou_bev(cand, cand))
    np.fill_diagonal(iou, -1)
    print("closest IoU to the threshold", np.abs(iou - thresh).min())
    assert np.abs(iou - thresh).min() > 1e-6
    ref = [np.asarray(x) for x in jrh.proposal_layer(jnp.asarray(cand), jnp.asarray(scores),
                                                     num_rois=20, nms_thresh=thresh, pre_max=40)]
    got = [x.numpy() for x in trh.proposal_layer(T(cand), T(scores), num_rois=20,
                                                 nms_thresh=thresh, pre_max=40)]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6)
    assert ref[2].any()


def test_targets_decode_and_loss_equal_jax(rng):
    """assign_roi_targets, decode_roi_boxes and roi_head_loss: values, and
    the gradient of the loss w.r.t. the RoIs (through the targets' 3D IoU
    and canonical encode), 1e-5."""
    gt = gt_boxes(rng)
    rois = rois_near(rng, gt)
    valid = rng.rand(len(rois)) > 0.15
    gcls, gvalid = np.array([1, 2, 0]), np.array([True, True, False])
    cls_p = rng.randn(len(rois)).astype(np.float32)
    cls_p[0] = 0.0  # abs's gradient at 0
    reg_p = rng.randn(len(rois), 7).astype(np.float32)

    def jloss(r):
        ct, rt, fg, best, arg = jrh.assign_roi_targets(r, jnp.asarray(valid), jnp.asarray(gt),
                                                       jnp.asarray(gcls), jnp.asarray(gvalid))
        a, b = jrh.roi_head_loss(jnp.asarray(cls_p), jnp.asarray(reg_p), ct, rt, fg,
                                 jnp.asarray(valid))
        return a + b, (ct, rt, fg, best, arg, a, b)

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(rois))
    r = T(rois).clone().requires_grad_()
    tout = trh.assign_roi_targets(r, T(valid), T(gt), T(gcls), T(gvalid))
    a, b = trh.roi_head_loss(T(cls_p), T(reg_p), tout[0], tout[1], tout[2], T(valid))
    (a + b).backward()
    for got, ref, name in zip(list(tout) + [a, b], jout,
                              ("cls_t", "reg_t", "fg", "best", "arg", "cls_loss", "reg_loss")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, err_msg=name)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jg), atol=1e-5)
    assert float(b) > 0 and np.abs(np.asarray(jg)).max() > 0
    dec = trh.decode_roi_boxes(T(rois), T(reg_p)).numpy()
    np.testing.assert_allclose(dec, np.asarray(jrh.decode_roi_boxes(jnp.asarray(rois),
                                                                    jnp.asarray(reg_p))), atol=1e-5)


def test_proposal_and_target_assignment():
    """tests/test_roi_heads.py's case on the port."""
    gt = T(np.array([[0, 0, 0, 4, 2, 1.6, 0.0]], np.float32))
    cands = T(np.array([[0.1, 0, 0, 4, 2, 1.6, 0.0], [1.5, 0.5, 0, 4, 2, 1.6, 0.3],
                        [20, 20, 0, 4, 2, 1.6, 0.0]], np.float32))
    scores = T(np.array([0.9, 0.8, 0.7], np.float32))
    rois, roi_scores, roi_valid = trh.proposal_layer(cands, scores, num_rois=3, nms_thresh=0.55)
    cls_t, reg_t, fg, best, arg = trh.assign_roi_targets(rois, roi_valid, gt, T([1]), T([True]))
    assert float(best.max()) > 0.8
    assert bool(fg[torch.argmax(best)])
    far = rois[:, 0] > 10
    assert not fg[far].any() and (cls_t[far] == 0).all()
    dec = trh.decode_roi_boxes(rois, reg_t)
    np.testing.assert_allclose(dec[torch.argmax(best)].numpy(), gt[0].numpy(), atol=1e-3)


def _voxel_table(rng, n, stride, channels):
    nxy, nz = 32 // stride, max(1, 16 // stride)
    c = np.stack([rng.randint(0, 2, n), rng.randint(0, nz, n), rng.randint(0, nxy, n),
                  rng.randint(0, nxy, n)], 1).astype(np.int32)
    c = np.unique(c, axis=0)
    valid = rng.rand(len(c)) > 0.1
    return c, valid, (rng.randn(len(c), channels) * valid[:, None]).astype(np.float32)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_voxel_rcnn_head_equals_jax(rng, train):
    srcs = {"x_conv3": _voxel_table(rng, 300, 4, 8), "x_conv4": _voxel_table(rng, 150, 8, 8)}
    r = 10
    rois = np.zeros((r, 7), np.float32)
    rois[:, :2] = rng.rand(r, 2) * 4 - 2
    rois[:, 2] = rng.rand(r) * 1.5 - 0.5
    rois[:, 3:6] = rng.rand(r, 3) * 2 + 1
    rois[:, 6] = rng.randn(r)
    roi_valid = rng.rand(r) > 0.2
    roi_batch = np.repeat(np.arange(2), r // 2).astype(np.int32)

    def jbatch(feats):
        return {"multi_scale_3d_features": {
            k: jsc.SparseTensor(feats[k], jnp.asarray(c), jnp.asarray(v), (4, 8, 8), 2)
            for k, (c, v, _) in srcs.items()}, "roi_batch": jnp.asarray(roi_batch)}

    jfeats = {k: jnp.asarray(f) for k, (_, _, f) in srcs.items()}
    head = jrh.VoxelRCNNHead(voxel_size=VS, point_cloud_range=PCR, grid_size=3)
    var = head.init(jax.random.PRNGKey(0), jbatch(jfeats), jnp.asarray(rois),
                    jnp.asarray(roi_valid), train=True)
    w1, w2 = rng.randn(r).astype(np.float32), rng.randn(r, 7).astype(np.float32)

    def jloss(rr, feats):
        (c, g), mut = head.apply(var, jbatch(feats), rr, jnp.asarray(roi_valid), train=train,
                                 mutable=["batch_stats"])
        return jnp.sum(c * w1) + jnp.sum(g * w2), (c, g, mut["batch_stats"])

    (_, (jc, jg, jstats)), (g_rois, g_feats) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(rois), jfeats)
    th = trh.VoxelRCNNHead(VS, PCR, source_channels=(8, 8), grid_size=3)
    th.load_state_dict(detector_params_from_flax(jax.tree_util.tree_map(np.asarray, var)),
                       strict=True)
    th.train(train)
    tr = T(rois).clone().requires_grad_()
    tf = {k: T(f).clone().requires_grad_() for k, (_, _, f) in srcs.items()}
    bd = {"multi_scale_3d_features": {k: tsc.SparseTensor(tf[k], T(c), T(v), (4, 8, 8), 2)
                                      for k, (c, v, _) in srcs.items()},
          "roi_batch": T(roi_batch).long()}
    c, g = th(bd, tr, T(roi_valid))
    ((c * T(w1)).sum() + (g * T(w2)).sum()).backward()
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(g_rois), atol=1e-5)
    for k in tf:
        np.testing.assert_allclose(tf[k].grad.numpy(), np.asarray(g_feats[k]), atol=1e-5)
    assert np.abs(np.asarray(g_rois)).max() > 0
    stats = detector_params_from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, jstats)})
    sd = th.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
