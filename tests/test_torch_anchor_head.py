"""The anchor head's parts against the JAX package's: ResidualCoder, the
detection losses, the anchors, the nearest-BEV IoU, the anchor target
assignment (with the force-match collision at anchor 0), AnchorHeadSingle's
losses and decode, and the pillar VFE with tied maxima.

Inputs are made from seeded NumPy draws at the JAX tests' toy sizes (an
8 x 8 feature grid over +-3.2 m, two classes, two rotations). Tolerances:
the coder and the losses 1e-6 (absolute, on values of order 1); anchors
exact; the IoU 1e-6; assigned labels and foreground exact, regression
targets 1e-5; the head's losses, their gradients and its decode 1e-5; the
pillar VFE's features and gradients 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import dense_heads as jdh
from pcseqlearning_tpu.models import vfe as jvfe
from pcseqlearning_tpu.utils import box_coder_utils as jbc
from pcseqlearning_tpu.utils import loss_utils as jlu
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import dense_heads as tdh
from pcseqlearning_tpu_torch.models import vfe as tvfe
from pcseqlearning_tpu_torch.utils import box_coder_utils as tbc
from pcseqlearning_tpu_torch.utils import loss_utils as tlu

torch.set_num_threads(1)
T = torch.as_tensor
PCR = (-3.2, -3.2, -1.0, 3.2, 3.2, 2.2)
ANCHOR_CFGS = (
    dict(sizes=((1.6, 1.6, 1.0),), rotations=(0.0, 1.57), heights=(0.0,),
         matched_threshold=0.4, unmatched_threshold=0.2),
    dict(sizes=((0.8, 0.8, 1.0),), rotations=(0.0, 1.57), heights=(0.0,),
         matched_threshold=0.3, unmatched_threshold=0.15),
)


def boxes(rng, n, extent=3.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.rand(n, 2) * 2 * extent - extent
    b[:, 2] = rng.rand(n) * 1.5 - 0.5
    b[:, 3:6] = rng.rand(n, 3) * 2 + 0.5
    b[:, 6] = rng.rand(n) * 2 * np.pi - np.pi
    return b


@pytest.mark.parametrize("sincos", [False, True])
def test_residual_coder_equals_jax(rng, sincos):
    gt, anchors = boxes(rng, 64), boxes(rng, 64)
    jc, tc = jbc.ResidualCoder(encode_angle_by_sincos=sincos), tbc.ResidualCoder(
        encode_angle_by_sincos=sincos)
    enc = tc.encode(T(gt), T(anchors)).numpy()
    np.testing.assert_allclose(enc, np.asarray(jc.encode(gt, anchors)), atol=1e-6)
    np.testing.assert_allclose(tc.decode(T(enc), T(anchors)).numpy(),
                               np.asarray(jc.decode(enc, anchors)), atol=1e-6)
    np.testing.assert_allclose(tc.decode(T(enc), T(anchors)).numpy()[:, :6], gt[:, :6], atol=1e-5)


def test_losses_equal_jax(rng):
    logits = rng.randn(50, 3).astype(np.float32) * 3
    logits[0, 0] = 0.0  # abs's and max's gradients at a tie
    targets = (rng.rand(50, 3) > 0.7).astype(np.float32)
    w = rng.rand(50).astype(np.float32)
    pred, tgt = rng.randn(50, 7).astype(np.float32), rng.randn(50, 7).astype(np.float32)
    tgt[1, 2] = pred[1, 2]  # an exact tie of the smooth-L1's abs
    cw = (1.0, 1.0, 2.0, 1.0, 1.0, 1.0, 0.5)
    cases = [
        (jlu.sigmoid_focal_cls_loss, tlu.sigmoid_focal_cls_loss, (logits, targets, w)),
        (lambda *a: jlu.weighted_smooth_l1_loss(*a, code_weights=cw),
         lambda *a: tlu.weighted_smooth_l1_loss(*a, code_weights=cw), (pred, tgt, w)),
        (jlu.weighted_cross_entropy_loss, tlu.weighted_cross_entropy_loss, (logits, targets, w)),
        (jlu.smooth_l1, tlu.smooth_l1, (pred - tgt,)),
    ]
    for jf, tf, args in cases:
        ref = np.asarray(jf(*args))
        gref = np.asarray(jax.grad(lambda x: jnp.sum(jf(x, *args[1:])))(args[0]))
        x = T(args[0]).clone().requires_grad_()
        got = tf(x, *(T(a) for a in args[1:]))
        got.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), gref, atol=1e-6)


def test_generate_anchors_exact():
    for cfg in ANCHOR_CFGS:
        args = ((8, 6), PCR, cfg["sizes"], cfg["rotations"], cfg["heights"])
        np.testing.assert_array_equal(tdh.generate_anchors(*args), jdh.generate_anchors(*args))


def test_nearest_bev_iou_equals_jax(rng):
    a, b = boxes(rng, 40), boxes(rng, 9)
    b[0, 6] = np.pi / 4  # on the rounding's boundary
    a[:3] = b[:3]  # full overlaps
    got = tdh.nearest_bev_iou(T(a), T(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdh.nearest_bev_iou(a, b)), atol=1e-6)
    assert (got > 0.99).sum() >= 3


def _anchors_flat():
    parts = [jdh.generate_anchors((8, 8), PCR, c["sizes"], c["rotations"], c["heights"])
             for c in ANCHOR_CFGS]
    a = np.concatenate([p.reshape(8, 8, -1, 7) for p in parts], axis=2)
    m_ids = np.arange(a.size // 7) % a.shape[2]
    return a.reshape(-1, 7), m_ids


def _assign_both(gt, cls, class_id):
    anchors, m_ids = _anchors_flat()
    cfg = ANCHOR_CFGS[class_id - 1]
    amask = (m_ids >= 2 * (class_id - 1)) & (m_ids < 2 * class_id)
    args = (gt, cls, cls > 0, class_id, cfg["matched_threshold"], cfg["unmatched_threshold"])
    ref = jax.jit(lambda a, g, c, m: jdh.assign_anchor_targets(
        a, g, c, c > 0, class_id, *args[4:], jbc.ResidualCoder(), anchor_mask=m))(
        anchors, gt, cls, amask)
    got = tdh.assign_anchor_targets(T(anchors), T(gt), T(cls).long(), T(cls > 0), class_id,
                                    *args[4:], tbc.ResidualCoder(), anchor_mask=T(amask))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("case", ["toy", "collision_valid_last", "collision_pad_last"])
def test_assign_anchor_targets_equals_jax(case):
    """Labels and foreground exact, regression targets 1e-5. The collision
    cases put a class-1 GT with no overlap with any anchor (it lies outside
    the grid, so every IoU of its column is 0 and it force-matches anchor
    0, class 1's first row) before or after padded GTs (whose all -1
    columns also pick anchor 0): anchor 0 takes the value of the last of
    them in table order, as XLA's scatter does on the CPU."""
    gt = np.zeros((5, 7), np.float32)
    cls = np.zeros(5, np.int32)
    gt[0], cls[0] = [1.0, 1.0, 0.5, 1.5, 1.5, 1.0, 0.3], 1
    gt[1], cls[1] = [-1.0, -1.0, 0.5, 1.0, 1.0, 1.0, -0.3], 2
    far = [40.0, 40.0, 0.5, 1.5, 1.5, 1.0, 0.0]
    if case == "collision_valid_last":
        gt[4], cls[4] = far, 1
    elif case == "collision_pad_last":
        gt[2], cls[2] = far, 1
    for class_id in (1, 2):
        (jl, jr, jf), (tl, tr, tf) = _assign_both(gt, cls, class_id)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tr, jr, atol=1e-5)
        if case != "toy" and class_id == 1:
            # the far GT's force-match survives only when it is written last
            assert bool(tf[0]) == (case == "collision_valid_last")


def _head_batch(rng, predict_iou):
    b, h, w, m = 2, 8, 8, 4
    bd = {"cls_preds": rng.randn(b, h, w, m, 2).astype(np.float32),
          "box_preds": (rng.randn(b, h, w, m, 7) * 0.3).astype(np.float32),
          "dir_preds": rng.randn(b, h, w, m, 2).astype(np.float32)}
    if predict_iou:
        bd["iou_preds"] = rng.randn(b, h, w, m).astype(np.float32)
    gt = np.zeros((b, 4, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.5, 1.5, 1.0, 0.3, 1]
    gt[:, 1] = [-1.0, -1.0, 0.5, 1.0, 1.0, 1.0, -0.3, 2]
    gt[1, 2] = [2.5, -2.0, 0.2, 0.8, 0.6, 1.2, 1.1, 2]
    bd["gt_boxes"] = gt
    return bd


@pytest.mark.parametrize("predict_iou", [False, True], ids=["second", "second_iou"])
def test_anchor_head_losses_and_decode_equal_jax(rng, predict_iou):
    """loss (and iou_loss) values and their gradients w.r.t. the
    predictions, and generate_predicted_boxes, at 1e-5."""
    bd = _head_batch(rng, predict_iou)
    jh = jdh.AnchorHeadSingle(num_classes=2, grid_size_xy=(8, 8), point_cloud_range=PCR,
                              anchor_cfgs=ANCHOR_CFGS, predict_iou=predict_iou)
    th = tdh.AnchorHeadSingle(16, 2, (8, 8), PCR, ANCHOR_CFGS, predict_iou=predict_iou)
    pred_keys = [k for k in bd if k != "gt_boxes"]

    def jloss(preds):
        losses = jh.apply({}, {**preds, "gt_boxes": jnp.asarray(bd["gt_boxes"])},
                          method=lambda m, d: m.loss(d))
        return losses["rpn_loss"], losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(bd[k]) for k in pred_keys})
    tp = {k: T(bd[k]).clone().requires_grad_() for k in pred_keys}
    tlosses = th.loss({**tp, "gt_boxes": T(bd["gt_boxes"])})
    tlosses["rpn_loss"].backward()
    assert sorted(tlosses) == sorted(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(tlosses[k].detach()), float(v), atol=1e-5, err_msg=k)
    for k in pred_keys:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrads[k]), atol=1e-5, err_msg=k)
    if predict_iou:
        ji = jh.apply({}, {**{k: jnp.asarray(v) for k, v in bd.items()}},
                      method=lambda m, d: m.iou_loss(d))
        np.testing.assert_allclose(float(th.iou_loss({k: T(v) for k, v in bd.items()})),
                                   float(ji), atol=1e-5)
        assert float(ji) > 0
    jb, jc = jh.apply({}, {k: jnp.asarray(v) for k, v in bd.items()},
                      method=lambda m, d: m.generate_predicted_boxes(d))
    tb, tc = th.generate_predicted_boxes({k: T(v) for k, v in bd.items()})
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


def test_anchor_head_forward_layout_equals_jax(rng):
    """The 1x1 convs' NCHW outputs land in JAX's [B, H, W, M, C] rows."""
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    jh = jdh.AnchorHeadSingle(num_classes=2, grid_size_xy=(8, 8), point_cloud_range=PCR,
                              anchor_cfgs=ANCHOR_CFGS, predict_iou=True)
    v = jh.init(jax.random.PRNGKey(0), {"spatial_features_2d": jnp.asarray(x)})
    out = jh.apply(v, {"spatial_features_2d": jnp.asarray(x)})
    th = tdh.AnchorHeadSingle(16, 2, (8, 8), PCR, ANCHOR_CFGS, predict_iou=True)
    th.load_state_dict(detector_params_from_flax(jax.tree_util.tree_map(np.asarray, v)),
                       strict=True)
    got = th({"spatial_features_2d": T(x).permute(0, 3, 1, 2)})
    for k in ("cls_preds", "box_preds", "dir_preds", "iou_preds", "anchors"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(out[k]), atol=1e-5,
                                   err_msg=k)


def _vfe_state(variables):
    """A flax DynPillarVFE's variables as the port module's state_dict (the
    converter's names under ``vfe``, that prefix dropped)."""
    sd = detector_params_from_flax({coll: {"vfe": jax.tree_util.tree_map(np.asarray, tree)}
                                    for coll, tree in variables.items()})
    return {k.split(".", 1)[1]: t for k, t in sd.items()}


def test_pillar_vfe_equals_jax_with_tied_maxima(rng):
    """DynPillarVFE in train mode on points that repeat (identical rows tie
    in their pillar's max, and the max splits the gradient among them),
    with padding and points out of range: pillar coords and validity exact,
    features and the PFN's gradients 1e-5. Both packages run in float64
    (JAX under ``jax.enable_x64``), where they agree to 3.4e-14: in float32
    each lies ~1.1e-5 from the float64 gradient (a sum over ~290 points
    of a tensor whose max |g| is 43.5), so the float32 distance between
    them, 1.14e-5 on an AMD EPYC, rests on the host's order of adds."""
    n = 300
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:3] = rng.rand(n, 2) * 6.4 - 3.2
    pts[:, 3] = rng.rand(n) * 3.0 - 0.9
    feat = rng.rand(n, 1).astype(np.float32)
    pts[200:260], feat[200:260] = pts[100:160], feat[100:160]  # exact duplicates
    pts[290:, 1] = 9.0  # outside the range
    valid = np.ones(n, bool)
    valid[280:290] = False
    bd = {"point_bxyz": pts.astype(np.float64), "point_feat": feat.astype(np.float64),
          "point_valid": valid}
    jm = jvfe.DynPillarVFE(voxel_size=(0.4, 0.4, 3.2), point_cloud_range=PCR, pillar_cap=256,
                           num_filters=(8,))
    w = rng.randn(256, 8)
    with jax.enable_x64(True):
        jb = {k: jnp.asarray(x) for k, x in bd.items()}
        v = jm.init(jax.random.PRNGKey(0), jb, train=True)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

        def jf(params):
            out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb,
                              train=True, mutable=["batch_stats"])
            return jnp.sum(out["pillar_features"] * w), out

        (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(v["params"])
        jout = {k: np.asarray(x) for k, x in jout.items()}
        jg = jax.tree_util.tree_map(np.asarray, jg)
    tm = tvfe.DynPillarVFE((0.4, 0.4, 3.2), PCR, 256, num_filters=(8,))
    tm.load_state_dict(_vfe_state(v), strict=True)
    tm.double().train()
    out = tm({k: T(x) for k, x in bd.items()})
    (out["pillar_features"] * T(w)).sum().backward()
    np.testing.assert_array_equal(out["voxel_coords"].numpy(), jout["voxel_coords"])
    np.testing.assert_array_equal(out["voxel_valid"].numpy(), jout["voxel_valid"])
    np.testing.assert_allclose(out["pillar_features"].detach().numpy(), jout["pillar_features"],
                               atol=1e-5)
    ref = _vfe_state({"params": jg})
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-5, err_msg=name)
