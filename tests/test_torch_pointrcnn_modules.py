"""The port's PointRCNN modules against the JAX package's:
PointResidualCoder, the batch-aware kNN with tied distances, RoI point
pooling (plain and masked), PointNet2MSG and PointHeadBox's targets, loss
and decode, all in float32 at tests/test_all_cfgs.py's toy (2 samples of
512 seeded points: SALayer's 4,096 FPS picks repeat points). The whole
model is in tests/test_torch_pointrcnn.py.

Tolerances: as stated in each test (exact where the function is a choice
or a gather).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models.backbones_point import PointHeadBox as JPointHeadBox
from pcseqlearning_tpu.models.backbones_point import PointNet2MSG as JPointNet2MSG
from pcseqlearning_tpu.ops import roi_pool as jroi_pool
from pcseqlearning_tpu.ops import sampling as jsampling
from pcseqlearning_tpu.utils import box_coder_utils as jcoder
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models.backbones_point import PointHeadBox, PointNet2MSG
from pcseqlearning_tpu_torch.ops import roi_pool, sampling
from pcseqlearning_tpu_torch.utils.box_coder_utils import PointResidualCoder
from test_torch_pointrcnn import as_numpy, gt_boxes, toy_points

torch.set_num_threads(1)
T = torch.as_tensor


def test_point_residual_coder_equals_jax():
    rng = np.random.RandomState(1)
    boxes = np.concatenate([rng.randn(64, 3) * 5, rng.rand(64, 3) * 4 + 0.2,
                            rng.rand(64, 1) * 6 - 3], 1).astype(np.float32)
    pts = (boxes[:, :3] + rng.randn(64, 3)).astype(np.float32)
    cls = rng.randint(0, 5, 64).astype(np.int32)  # 0 and 4 clip into the table
    jc, tc = jcoder.PointResidualCoder(), PointResidualCoder()
    enc = tc.encode(T(boxes), T(pts), T(cls))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jc.encode(boxes, pts, cls)), atol=1e-6)
    res = rng.randn(64, 8).astype(np.float32) * 0.5
    np.testing.assert_allclose(tc.decode(T(res), T(pts), T(cls)).numpy(),
                               np.asarray(jc.decode(res, pts, cls)), atol=1e-5)


def test_knn_with_batch_ids_and_ties_equals_jax():
    """References of another sample or not valid are never neighbours; the
    coarse table repeats points (as FPS picks do when they outnumber the
    points), so distances tie and the order must be XLA top_k's, lowest
    index first: the indices are held exactly."""
    rng = np.random.RandomState(2)
    base = rng.rand(40, 3).astype(np.float32) * 4
    ref = base[rng.randint(0, 40, 160)]  # many exact duplicates
    ref_b = rng.randint(0, 2, 160).astype(np.int32)
    ref_v = rng.rand(160) > 0.1
    qry = np.concatenate([base[:30], rng.rand(50, 3).astype(np.float32) * 4])
    qry_b = rng.randint(0, 2, 80).astype(np.int32)
    ji, jd = jsampling.knn_bruteforce(ref, qry, 3, ref_valid=ref_v, ref_batch=ref_b,
                                      query_batch=qry_b)
    ti, td = sampling.knn_bruteforce(T(ref), T(qry), 3, ref_valid=T(ref_v), ref_batch=T(ref_b),
                                     query_batch=T(qry_b))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    assert (ref_b[ti.numpy()] == qry_b[:, None]).all() and ref_v[ti.numpy()].all()
    ji, jd = jsampling.knn_bruteforce(ref, qry, 3, ref_valid=ref_v)  # the ground stage's call
    ti, td = sampling.knn_bruteforce(T(ref), T(qry), 3, ref_valid=T(ref_v))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


def _pool_case():
    rng = np.random.RandomState(3)
    pts = (rng.rand(400, 3) * [8, 8, 2] - [4, 4, 0]).astype(np.float32)
    feats = rng.randn(400, 5).astype(np.float32)
    rois = np.array([[0, 0, 1, 3, 3, 2, 0.3], [2, -1, 1, 1, 1, 1, -0.7],
                     [30, 30, 1, 1, 1, 1, 0],  # empty
                     [-1, 1, 1, 6, 4, 2, 1.2]], np.float32)  # more points than S
    return pts, feats, rois


@pytest.mark.parametrize("masked", [False, True])
def test_roipoint_pool3d_equals_jax(masked):
    """The first S inside points in index order, filled with the first;
    an empty RoI gives zeros and empty; the masked form restricts each RoI
    to its pair mask and centres xyz on the RoI. Equal to JAX's (a gather),
    and the features' gradient too."""
    pts, feats, rois = _pool_case()
    valid = np.arange(400) % 7 != 0
    s = 24
    if masked:
        pair = (np.arange(400)[None] % 2 == np.arange(4)[:, None] % 2) & valid[None]
        jp, je = jroi_pool.roipoint_pool3d_masked(pts, feats, rois, pair, num_sampled=s)
        fn = lambda f: roi_pool.roipoint_pool3d_masked(T(pts), f, T(rois), T(pair), s)  # noqa: E731
        jfn = lambda f: jroi_pool.roipoint_pool3d_masked(pts, f, rois, pair, num_sampled=s)  # noqa
    else:
        jp, je = jroi_pool.roipoint_pool3d(pts, feats, rois, num_sampled=s, point_valid=valid)
        fn = lambda f: roi_pool.roipoint_pool3d(T(pts), f, T(rois), s, T(valid))  # noqa: E731
        jfn = lambda f: jroi_pool.roipoint_pool3d(pts, f, rois, num_sampled=s,  # noqa: E731
                                                  point_valid=valid)
    jp, je = np.asarray(jp), np.asarray(je)
    f = T(feats).clone().requires_grad_(True)
    tp, te = fn(f)
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_allclose(tp.detach().numpy(), jp, atol=1e-6)
    assert je[2] and not je[[0, 3]].any()
    w = np.random.RandomState(4).randn(*tp.shape).astype(np.float32)
    (tp * T(w)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jfn(x)[0] * w))(jnp.asarray(feats))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jg), atol=1e-5)


def test_pointnet2msg_equals_jax():
    """PointNet2MSG with its defaults on the toy's points (the SA levels' FPS
    over the whole table with the 1e4 batch shift, the ball queries, the FP
    levels' batch-aware 3-NN), train mode, float32: the point features and
    the new batch statistics."""
    pts, feat = toy_points()
    batch = {"point_bxyz": jnp.asarray(pts), "point_feat": jnp.asarray(feat)}
    net = JPointNet2MSG()
    v = jax.jit(lambda k, b: net.init(k, b, train=True))(jax.random.PRNGKey(1), batch)
    out, mut = jax.jit(lambda v, b: net.apply(v, b, train=True, mutable=["batch_stats"]))(v, batch)
    m = PointNet2MSG(1)
    m.load_state_dict(detector_params_from_flax(as_numpy(v)), strict=True)
    m.train()
    got = m({"point_bxyz": T(pts), "point_feat": T(feat)})
    want = np.asarray(out["point_features"])
    np.testing.assert_allclose(got["point_features"].detach().numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got["point_coords"].numpy(), np.asarray(out["point_coords"]))
    sd = m.state_dict()
    for k, r in detector_params_from_flax({"batch_stats": as_numpy(mut["batch_stats"])}).items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


def test_point_head_box_targets_loss_and_decode_equal_jax():
    rng = np.random.RandomState(5)
    pts, _ = toy_points()
    coords = pts.copy()
    valid = rng.rand(len(pts)) > 0.05
    gt = gt_boxes()
    gt[1, 2, 7] = 0  # an empty GT slot
    logits = rng.randn(len(pts), 3).astype(np.float32)
    box = rng.randn(len(pts), 8).astype(np.float32) * 0.3
    jl, jt = JPointHeadBox.assign_targets(jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(gt))
    tl, tt = PointHeadBox.assign_targets(T(coords), T(valid), T(gt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tl > 0).sum() > 50
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    jb = {"point_cls_preds": jnp.asarray(logits), "point_box_preds": jnp.asarray(box),
          "point_coords": jnp.asarray(coords), "point_valid": jnp.asarray(valid)}
    tb = {k: T(np.asarray(v)) for k, v in jb.items()}
    tb["point_cls_preds"].requires_grad_(True)
    tb["point_box_preds"].requires_grad_(True)
    jloss = JPointHeadBox.loss(jb, jnp.asarray(gt))
    tloss = PointHeadBox.loss(tb, T(gt))
    for k in jloss:
        np.testing.assert_allclose(float(tloss[k].detach()), float(jloss[k]), rtol=1e-5, err_msg=k)
    tloss["point_loss"].backward()
    jg = jax.grad(lambda c, b: JPointHeadBox.loss({**jb, "point_cls_preds": c,
                                                   "point_box_preds": b}, jnp.asarray(gt))
                  ["point_loss"], argnums=(0, 1))(jb["point_cls_preds"], jb["point_box_preds"])
    np.testing.assert_allclose(tb["point_cls_preds"].grad.numpy(), np.asarray(jg[0]), atol=1e-6)
    np.testing.assert_allclose(tb["point_box_preds"].grad.numpy(), np.asarray(jg[1]), atol=1e-6)
    jd = JPointHeadBox.generate_predicted_boxes(jb)
    td = PointHeadBox.generate_predicted_boxes(tb)
    np.testing.assert_allclose(td[0].detach().numpy(), np.asarray(jd[0]), atol=1e-5)
    np.testing.assert_allclose(td[1].detach().numpy(), np.asarray(jd[1]), atol=1e-6)
    np.testing.assert_array_equal(td[2].numpy(), np.asarray(jd[2]))
