"""The port's box IoUs, detection metrics and prediction formatting against
the JAX package's.

Tolerances: ``boxes_overlap_bev`` / ``boxes_iou_bev`` / ``boxes_iou3d``
1e-5 absolute (each package rounds its cos/sin and clipping products
itself); the metrics of ``runtime.eval_utils`` (``waymo_style_ap``,
``simple_detection_eval``, ``compute_recall``, ``average_precision``,
``segmentation_iou_table``) 1e-6 absolute on every value; the annos of
``generate_prediction_dicts`` equal. Predictions through both detectors
with the same flax weights (tests/test_torch_detector.py's toy, heatmap
kernel scaled so that scores cross the threshold), the test CLI's way:
the dense batch, ``predict``, the valid rows, ``generate_prediction_dicts``:
names and labels equal, scores and boxes to 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.datasets import build_dataloader as j_build
from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.ops import boxes as jboxes
from pcseqlearning_tpu.parallel import train_step as jts
from pcseqlearning_tpu.runtime import eval_utils as jeval
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.datasets import build_dataloader as t_build
from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild
from pcseqlearning_tpu_torch.ops import boxes as tboxes
from pcseqlearning_tpu_torch.parallel import train_step as tts
from pcseqlearning_tpu_torch.runtime import eval_utils as teval
from test_torch_detector import RUNTIME, centerpoint_cfg
from test_torch_train_step import dense_batch

torch.set_num_threads(1)
T = torch.as_tensor
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
PAD = 24  # the box count of every JAX IoU call (one compile of its eager ops)


def box(x, y, z, dx, dy, dz, h):
    return [x, y, z, dx, dy, dz, h]


SPECIAL = {
    "disjoint": ([box(0, 0, 0, 2, 1, 1, 0.3)], [box(10, 0, 0, 2, 1, 1, -0.2)]),
    "identical": ([box(1, 2, 0.5, 4, 2, 1.5, 0.7)], [box(1, 2, 0.5, 4, 2, 1.5, 0.7)]),
    "nested": ([box(0, 0, 0, 4, 4, 2, 0.4)], [box(0.2, -0.1, 0.1, 1, 1, 1, 1.1)]),
    "corner_touching": ([box(0, 0, 0, 2, 2, 1, 0)], [box(2, 2, 0, 2, 2, 1, 0)]),
    "rotated_90": ([box(0, 0, 0, 4, 2, 1, 0)], [box(0, 0, 0.25, 4, 2, 1, np.pi / 2)]),
    "z_apart": ([box(0, 0, 0, 2, 2, 1, 0)], [box(0, 0, 1.5, 2, 2, 1, 0)]),
}


def random_boxes(rng, n, spread=6.0):
    return np.concatenate([rng.rand(n, 2) * spread, rng.rand(n, 1), rng.rand(n, 3) * 3 + 0.5,
                           rng.rand(n, 1) * 2 * np.pi - np.pi], 1).astype(np.float32)


@pytest.mark.parametrize("case", ["random"] + sorted(SPECIAL))
def test_box_ious_equal_jax(case):
    if case == "random":
        rng = np.random.RandomState(0)
        a, b = random_boxes(rng, PAD), random_boxes(rng, PAD)  # the padded shape below
    else:
        a, b = (np.asarray(x, np.float32) for x in SPECIAL[case])
    for name in ("boxes_overlap_bev", "boxes_iou_bev", "boxes_iou3d"):
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(tboxes, name)(T(a), T(b)).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    iou = tboxes.boxes_iou_bev(T(a), T(b)).numpy()
    expected = {"disjoint": 0.0, "identical": 1.0, "nested": 1 / 16, "corner_touching": 0.0,
                "rotated_90": 4 / 12, "z_apart": 1.0}
    if case in expected:
        assert iou[0, 0] == pytest.approx(expected[case], abs=1e-5)
    if case == "z_apart":
        assert tboxes.boxes_iou3d(T(a), T(b)).numpy()[0, 0] == 0.0


def test_box_ious_of_empty_sets():
    e, a = np.zeros((0, 7), np.float32), random_boxes(np.random.RandomState(1), 3)
    assert tboxes.boxes_iou3d(T(e), T(a)).shape == (0, 3)
    assert tboxes.boxes_iou_bev(T(a), T(e)).shape == (3, 0)


def random_annos(seed, frames=6):
    """Detection and GT annos over three classes: noisy copies of most GTs,
    some duplicates and false positives, scores with ties, difficulty and
    point counts (some zero), boxes out to 70 m for the range buckets (at
    most 15 boxes a frame)."""
    rng = np.random.RandomState(seed)
    dets, gts = [], []
    for _ in range(frames):
        g = rng.randint(3, 9)
        gb = random_boxes(rng, g, 140.0)
        gb[:, :2] -= 70.0
        names = rng.choice(CLASSES, g)
        keep = rng.rand(g) > 0.2
        db = gb[keep] + rng.randn(keep.sum(), 7).astype(np.float32) * [0.2, 0.2, 0.1, 0.1, 0.1,
                                                                         0.1, 0.3]
        extra = random_boxes(rng, 3, 140.0)
        extra[:, :2] -= 70.0
        db = np.concatenate([db, db[:1], extra]).astype(np.float32)
        dn = np.concatenate([names[keep], names[keep][:1], rng.choice(CLASSES, 3)])
        scores = np.round(rng.rand(len(db)), 1).astype(np.float32)  # ties
        dets.append(dict(name=dn, score=scores, boxes_lidar=db))
        gts.append(dict(name=names, gt_boxes_lidar=gb, difficulty=rng.randint(0, 3, g),
                        num_points_in_gt=rng.randint(0, 12, g)))
    return dets, gts


def _padded_jax_iou3d(a, b, iou=jeval._iou3d_np):
    """JAX's own ``_iou3d_np`` at one padded shape (the pairs are
    independent, so padding changes no entry): each new shape would cost the
    eager JAX ops a compile."""
    if len(a) == 0 or len(b) == 0:
        return iou(a, b)
    pad = np.tile(np.asarray([[500, 500, 0, 1, 1, 1, 0]], np.float32), (PAD, 1))
    return iou(np.concatenate([a, pad])[:PAD], np.concatenate([b, pad])[:PAD])[:len(a), :len(b)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_metrics_equal_jax(seed, monkeypatch):
    monkeypatch.setattr(jeval, "_iou3d_np", _padded_jax_iou3d)
    dets, gts = random_annos(seed)
    for fn, kw in (("waymo_style_ap", {}), ("waymo_style_ap", {"with_range_breakdown": False}),
                   ("simple_detection_eval", {}), ("simple_detection_eval",
                                                   {"iou_threshold": 0.3})):
        gstr, got = getattr(teval, fn)(copy.deepcopy(dets), copy.deepcopy(gts), CLASSES, **kw)
        wstr, want = getattr(jeval, fn)(copy.deepcopy(dets), copy.deepcopy(gts), CLASSES, **kw)
        assert set(got) == set(want), fn
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), (fn, k)
        assert gstr == wstr
    assert any(v > 0 for v in teval.waymo_style_ap(dets, gts, CLASSES)[1].values())
    for d, g in zip(dets, gts):
        got = teval.compute_recall(d["boxes_lidar"], g["gt_boxes_lidar"])
        assert got == jeval.compute_recall(d["boxes_lidar"], g["gt_boxes_lidar"])
    assert teval.compute_recall(np.zeros((0, 7)), gts[0]["gt_boxes_lidar"]) == \
        jeval.compute_recall(np.zeros((0, 7)), gts[0]["gt_boxes_lidar"])


def test_average_precision_and_segmentation_table_equal_jax():
    rng = np.random.RandomState(3)
    scores, matched = rng.rand(50).astype(np.float32), rng.rand(50) > 0.5
    assert teval.average_precision(scores, matched, 40) == pytest.approx(
        jeval.average_precision(scores, matched, 40), abs=1e-6)
    pred, gt = rng.randint(0, 5, 400), rng.randint(-1, 5, 400)
    got = teval.segmentation_iou_table(pred, gt, 6, [f"c{i}" for i in range(6)])
    want = jeval.segmentation_iou_table(pred, gt, 6, [f"c{i}" for i in range(6)])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6, nan_ok=True), k


def test_non_finite_boxes_raise_as_in_jax():
    """A detection with a NaN size makes a NaN IoU, on which both
    packages' waymo_style_ap raise in linear_sum_assignment: the port keeps
    JAX's behaviour for the non-finite boxes of an overflowing head."""
    dets, gts = random_annos(0, frames=2)
    bad = copy.deepcopy(dets)
    bad[0]["boxes_lidar"] = np.concatenate([bad[0]["boxes_lidar"],
                                            [[0, 0, 0, np.nan, 2, 2, 0]]]).astype(np.float32)
    bad[0]["name"] = np.concatenate([bad[0]["name"], ["Vehicle"]])
    bad[0]["score"] = np.concatenate([bad[0]["score"], [0.05]]).astype(np.float32)
    for fn in (teval.waymo_style_ap, jeval.waymo_style_ap):
        with pytest.raises(ValueError, match="invalid numeric entries"):
            fn(bad, gts, CLASSES)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Both packages' Waymo datasets over an empty layout (no infos):
    generate_prediction_dicts and evaluation need no frames."""
    cfg = dict(DATASET="WaymoDataset", DATA_PATH=str(tmp_path_factory.mktemp("empty")))
    return (t_build(cfg, CLASSES, 1, training=False)[0],
            j_build(cfg, CLASSES, 1, training=False)[0])


def test_generate_prediction_dicts_equal_jax(datasets):
    tds, jds = datasets
    rng = np.random.RandomState(4)
    batch = {"frame_id": ["seq_000", "seq_001"]}
    preds = [dict(pred_boxes=random_boxes(rng, n), pred_scores=rng.rand(n).astype(np.float32),
                  pred_labels=rng.randint(0, 4, n)) for n in (5, 0)]
    got = tds.generate_prediction_dicts(batch, preds, CLASSES)
    want = jds.generate_prediction_dicts(batch, preds, CLASSES)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert set(a) == set(b) and a["frame_id"] == b["frame_id"]
        for k in ("boxes_lidar", "score", "name", "pred_labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_evaluation_dispatch(datasets):
    """"waymo" and "simple" reach their metrics; "waymo_ii" reaches the
    interaction-index AP and equals JAX's dataset's within 1e-9 (annos
    without interaction masks: every box at level 0)."""
    tds, jds = datasets
    tds.infos = [{"annos": g} for g in random_annos(5, frames=2)[1]]
    dets = random_annos(5, frames=2)[0]
    assert set(tds.evaluation(dets, CLASSES)[1]) == set(
        teval.waymo_style_ap(dets, [i["annos"] for i in tds.infos], CLASSES)[1])
    assert tds.evaluation(dets, CLASSES, eval_metric="simple")[1] == teval.simple_detection_eval(
        dets, [i["annos"] for i in tds.infos], CLASSES)[1]
    got = tds.evaluation(copy.deepcopy(dets), CLASSES, eval_metric="waymo_ii")[1]
    infos = jds.infos
    try:
        jds.infos = copy.deepcopy(tds.infos)
        want = jds.evaluation(copy.deepcopy(dets), CLASSES, eval_metric="waymo_ii")[1]
    finally:
        jds.infos = infos
    assert set(got) == set(want) and all(abs(got[k] - want[k]) <= 1e-9 for k in want)
    assert got["Pedestrian/II_0/AP"] > 0


def test_predictions_to_annos_equal_jax(datasets):
    """One dense batch through each detector's predict with the same
    weights, then the valid rows into generate_prediction_dicts."""
    tds, jds = datasets
    model = jbuild(centerpoint_cfg(), RUNTIME)
    dense = dense_batch(seed=3)
    jflat = jts._flatten_local(*(jnp.asarray(dense[k]) for k in ("points", "feats", "valid",
                                                                  "gt_boxes")))
    bs = jflat.pop("batch_size")
    variables = jax.jit(lambda key, a: model.init(key, {**a, "batch_size": bs}, train=True))(
        jax.random.PRNGKey(1), jflat)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    hm = variables["params"]["dense_head"]["head"]["Conv_1"]
    hm["kernel"] = (hm["kernel"] * 8.0).astype(np.float32)
    jout = jax.jit(lambda v, a: model.apply(v, {**a, "batch_size": bs}, method="predict")[1:])(
        variables, jflat)
    tmodel = tbuild(centerpoint_cfg(), RUNTIME, device="cpu")
    tmodel.load_state_dict(detector_params_from_flax(variables), strict=True)
    tout = tmodel.predict(tts._flatten_local(**tts._to_device(dense, torch.device("cpu"))))[1:]
    batch = {"frame_id": ["a_000", "a_001"]}

    def annos(ds, out):
        boxes, scores, labels, valid = (np.asarray(x) for x in out)
        return ds.generate_prediction_dicts(batch, [
            dict(pred_boxes=boxes[b][valid[b]], pred_scores=scores[b][valid[b]],
                 pred_labels=labels[b][valid[b]]) for b in range(2)], CLASSES[:2])

    got, want = annos(tds, [t.numpy() for t in tout]), annos(jds, jout)
    assert sum(len(a["score"]) for a in want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["name"], b["name"])
        np.testing.assert_array_equal(a["pred_labels"], b["pred_labels"])
        np.testing.assert_allclose(a["score"], b["score"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["boxes_lidar"], b["boxes_lidar"], rtol=0, atol=1e-4)
