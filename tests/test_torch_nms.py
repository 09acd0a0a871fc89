"""Rotated and axis-aligned NMS, the NMS front ends and the anchor
detectors' post-processing against the JAX package's.

Boxes are seeded random rotated boxes in clusters (so that many pairs
overlap), with tied scores and padded rows. The keep masks must equal
JAX's exactly. An IoU within a rounding of the threshold could flip a
decision in either package, so each test asserts, and prints, how far the
closest pair's IoU (JAX's) lies from the threshold, at least 1e-6 (some
30 roundings of an IoU near 0.3), instead of choosing its seed. The front
ends' kept scores and boxes must equal JAX's to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import model_nms_utils as jnms
from pcseqlearning_tpu.models.detectors import post_process_anchor as jpost
from pcseqlearning_tpu.ops import boxes as jbx
from pcseqlearning_tpu_torch.models import model_nms_utils as tnms
from pcseqlearning_tpu_torch.models.detectors import post_process_anchor as tpost
from pcseqlearning_tpu_torch.ops import boxes as tbx

torch.set_num_threads(1)
T = torch.as_tensor
THRESH = 0.3


def clustered_boxes(rng, n=160, clusters=12):
    centres = rng.rand(clusters, 2) * 20 - 10
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = centres[rng.randint(0, clusters, n)] + rng.randn(n, 2) * 0.6
    b[:, 2] = rng.randn(n) * 0.2
    b[:, 3:6] = rng.rand(n, 3) * 2 + 1.0
    b[:, 6] = rng.rand(n) * 2 * np.pi - np.pi
    scores = np.round(rng.rand(n), 1).astype(np.float32)  # many ties
    valid = rng.rand(n) > 0.15
    return b, scores, valid


def closest_to_threshold(iou, valid, thresh):
    m = np.abs(np.array(iou) - thresh)[np.ix_(valid, valid)]
    np.fill_diagonal(m, np.inf)
    return float(m.min())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_bev_equals_jax(seed):
    rng = np.random.RandomState(seed)
    b, s, v = clustered_boxes(rng)
    margin = closest_to_threshold(jbx.boxes_iou_bev(b, b), v, THRESH)
    print(f"seed {seed}: closest IoU to {THRESH} is {margin:.3g} away")
    assert margin > 1e-6
    ref = np.asarray(jbx.nms_bev(jnp.asarray(b), jnp.asarray(s), THRESH, valid=jnp.asarray(v)))
    got = tbx.nms_bev(T(b), T(s), THRESH, valid=T(v)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < v.sum()  # something suppressed, something kept
    # no valid mask: every row takes part
    ref = np.asarray(jbx.nms_bev(jnp.asarray(b), jnp.asarray(s), THRESH))
    np.testing.assert_array_equal(tbx.nms_bev(T(b), T(s), THRESH).numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_normal_bev_equals_jax(seed):
    rng = np.random.RandomState(seed)
    b, s, v = clustered_boxes(rng)
    x1, x2 = b[:, 0] - b[:, 3] / 2, b[:, 0] + b[:, 3] / 2
    y1, y2 = b[:, 1] - b[:, 4] / 2, b[:, 1] + b[:, 4] / 2
    iw = np.clip(np.minimum(x2[:, None], x2) - np.maximum(x1[:, None], x1), 0, None)
    ih = np.clip(np.minimum(y2[:, None], y2) - np.maximum(y1[:, None], y1), 0, None)
    area = (x2 - x1) * (y2 - y1)
    iou = iw * ih / (area[:, None] + area - iw * ih)
    margin = closest_to_threshold(iou, v, THRESH)
    print(f"seed {seed}: closest axis-aligned IoU to {THRESH} is {margin:.3g} away")
    assert margin > 1e-6
    ref = np.asarray(jbx.nms_normal_bev(jnp.asarray(b), jnp.asarray(s), THRESH,
                                        valid=jnp.asarray(v)))
    got = tbx.nms_normal_bev(T(b), T(s), THRESH, valid=T(v)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < v.sum()


@pytest.mark.parametrize("thresh", [THRESH, 0.0, -0.5])
def test_chunked_iou_rows_change_nothing(thresh, monkeypatch):
    """``iou_bev_above`` equals ``boxes_iou_bev > thresh`` over every pair
    (the pairs whose circles are apart included: IoU 0, so True for a
    negative threshold), in one chunk or in chunks of 7 rows x 160 (1,120
    pairs); and NMS keeps the same either way."""
    b, s, v = clustered_boxes(np.random.RandomState(3))
    full = tbx.boxes_iou_bev(T(b), T(b)) > thresh
    whole = tbx.iou_bev_above(T(b), thresh)
    keep = tbx.nms_bev(T(b), T(s), thresh, valid=T(v))
    monkeypatch.setattr(tbx, "NMS_PAIRS_PER_CHUNK", 7 * 160)
    chunked = tbx.iou_bev_above(T(b), thresh)
    assert torch.equal(whole, full) and torch.equal(chunked, full)
    assert bool(full.all()) if thresh < 0 else 0 < int(full.sum()) < full.numel()
    assert torch.equal(keep, tbx.nms_bev(T(b), T(s), thresh, valid=T(v)))


def test_nms_suppresses_overlaps():
    """tests/test_geometry_boxes.py's case, in both packages."""
    boxes = np.array([[0, 0, 0, 2, 2, 2, 0], [0.1, 0, 0, 2, 2, 2, 0],
                      [10, 10, 0, 2, 2, 2, 0.3]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    keep = tbx.nms_bev(T(boxes), T(scores), 0.5)
    assert keep.tolist() == np.asarray(jbx.nms_bev(jnp.asarray(boxes), jnp.asarray(scores),
                                                   0.5)).tolist() == [True, False, True]


def _nms_inputs(seed):
    rng = np.random.RandomState(seed)
    b, s, _ = clustered_boxes(rng, n=200)
    cls = np.round(rng.rand(200, 3), 1).astype(np.float32)
    return b, s, cls


def test_class_agnostic_and_multi_classes_nms_equal_jax():
    b, s, cls = _nms_inputs(4)
    cfg = {"NMS_PRE_MAXSIZE": 150, "NMS_POST_MAXSIZE": 60, "NMS_THRESH": THRESH}
    for score_thresh in (None, 0.35):
        ref = [np.asarray(x) for x in jnms.class_agnostic_nms(jnp.asarray(s), jnp.asarray(b), cfg,
                                                              score_thresh)]
        got = [x.numpy() for x in tnms.class_agnostic_nms(T(s), T(b), cfg, score_thresh)]
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_allclose(got[0][ref[2]], ref[0][ref[2]], atol=1e-6)
        np.testing.assert_allclose(got[1][ref[2]], ref[1][ref[2]], atol=1e-6)
        ref = [np.asarray(x) for x in jnms.multi_classes_nms(jnp.asarray(cls), jnp.asarray(b),
                                                             cfg, score_thresh)]
        got = [x.numpy() for x in tnms.multi_classes_nms(T(cls), T(b), cfg, score_thresh)]
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[0][ref[3]], ref[0][ref[3]], atol=1e-6)
        np.testing.assert_allclose(got[2][ref[3]], ref[2][ref[3]], atol=1e-6)
        assert 0 < ref[3].sum() < ref[3].size


def test_post_process_anchor_equals_jax():
    """The anchor detectors' post-processing at its defaults (NMS 0.7,
    score 0.1, pre 4096, post 500) and cut down (pre 120, post 40): valid
    exact, the valid rows' boxes, scores and labels equal."""
    b, _, cls = _nms_inputs(5)
    for kw in ({}, dict(pre_max=120, post_max=40, nms_thresh=THRESH)):
        ref = [np.asarray(x) for x in jax.jit(lambda x, y: jpost(x, y, **kw))(
            jnp.asarray(b), jnp.asarray(cls))]
        got = [x.numpy() for x in tpost(T(b), T(cls), **kw)]
        jv = ref[3]
        np.testing.assert_array_equal(got[3], jv)
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(g[jv], r[jv], atol=1e-6)
        assert jv.any()
        if not kw:  # all 200 are candidates: NMS and the score bound leave some slots empty
            assert jv.sum() < jv.size
