"""The port's own tracing (``utils.profiler`` spans, ``utils.telemetry``
counters) on the toy CenterPoint of tests/test_torch_detector.py and the
toy PV-RCNN of tests/test_torch_detectors_pv.py, one train step each on
the CPU: with tracing off a step opens no profiler range and creates no
CUDA event; with it on, the span tree has the train step's and the
detector's names and parents, one ``fps`` a PV-RCNN forward and one
``sparse_conv.gemm`` a sparse convolution. The VFE's dropped-point counter
against a direct count of the voxels past the cap, and a tensor counter
kept on its device until ``snapshot``. The test marked ``cuda`` holds the
spans and a device counter to no synchronization on a card.

The toy configs are imported inside the fixtures, so that the card's run
(``--noconftest``, no JAX) imports no JAX with this file.
"""

import numpy as np
import pytest
import torch

from pcseqlearning_tpu_torch.models import layers
from pcseqlearning_tpu_torch.models.vfe import DynamicMeanVFE
from pcseqlearning_tpu_torch.parallel import train_step as tts
from pcseqlearning_tpu_torch.train import loss_key_for
from pcseqlearning_tpu_torch.utils import profiler, telemetry

SPARSE_CONVS = (layers.SubMConvBlock, layers.SparseConvBlock)
# span -> parent in every step of a voxel detector
TREE = {
    "train_step": None,
    "train_step.forward": "train_step",
    "train_step.backward": "train_step",
    "train_step.optimizer": "train_step",
    "vfe": "train_step.forward",
    "backbone_3d": "train_step.forward",
    "map_to_bev": "train_step.forward",
    "backbone_2d": "train_step.forward",
    "dense_head": "train_step.forward",
    "dense_head.loss": "train_step.forward",
    "sparse_conv.rulebook": "backbone_3d",
    "sparse_conv.gemm": "backbone_3d",
    "sparse_conv.gemm_bwd": "train_step.backward",
}
PV_TREE = dict(TREE, **{"pfe": "train_step.forward", "fps": "pfe",
                        "roi_stage": "train_step.forward", "roi_stage.proposal": "roi_stage"})


def _dense(batch):
    """A toy batch of the detector tests in the train step's dense layout."""
    return tts.dense_batch_from_collated(dict(batch, batch_size=2), n_cap=512)


@pytest.fixture(scope="module")
def centerpoint():
    from test_torch_detector import RUNTIME, centerpoint_cfg, toy_batch

    return centerpoint_cfg(), RUNTIME, _dense(toy_batch()), TREE


@pytest.fixture(scope="module")
def pv_rcnn():
    from test_torch_detectors_pv import RUNTIME, model_cfg, toy_batch

    return model_cfg("PVRCNN"), RUNTIME, _dense(toy_batch()), PV_TREE


@pytest.fixture(params=["centerpoint", "pv_rcnn"])
def detector(request):
    return request.getfixturevalue(request.param)


@pytest.fixture
def tracing():
    profiler.reset()
    telemetry.reset()
    yield
    profiler.enable(False)
    profiler.reset()
    telemetry.reset()


def _step(cfg, runtime, batch):
    from pcseqlearning_tpu_torch.models.detectors import build_detector

    torch.manual_seed(0)
    model = build_detector(cfg, runtime, device="cpu")
    state = tts.init_train_state(model, device="cpu")
    step = tts.make_train_step(loss_key=loss_key_for(cfg), device="cpu")
    state, losses = step(state, batch)
    return model, losses


def test_untraced_step_opens_no_range_and_no_event(detector, tracing, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    cfg, runtime, batch, _ = detector
    _, losses = _step(cfg, runtime, batch)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert profiler.read() == {} and not telemetry.COUNTERS


def test_traced_step_span_tree(detector, tracing):
    cfg, runtime, batch, tree = detector
    profiler.enable(True)
    model, _ = _step(cfg, runtime, batch)
    profiler.enable(False)
    table = profiler.read(reset=True)
    assert {k: v["parent"] for k, v in table.items()} == tree
    assert set(table) <= set(profiler.SPANS)
    convs = sum(isinstance(m, SPARSE_CONVS) for m in model.modules())
    assert table["sparse_conv.gemm"]["calls"] == table["sparse_conv.gemm_bwd"]["calls"] == convs
    assert table["train_step"]["calls"] == table["vfe"]["calls"] == 1
    if "pfe" in tree:
        assert table["fps"]["calls"] == 1
    for row in table.values():
        assert row["device_ms"] is None and row["host_ms"] >= row["self_ms"] >= -1e-6
    parts = sum(table[k]["host_ms"] for k in TREE if TREE[k] == "train_step")
    assert parts <= table["train_step"]["host_ms"]
    counts = telemetry.snapshot()
    assert counts["vfe.points"] == int(batch["valid"].sum()) and counts["vfe.points_dropped"] == 0


def test_dropped_points_equal_a_direct_count(tracing):
    from test_torch_detector import RUNTIME, toy_batch

    b = toy_batch(seed=3)
    pcr = RUNTIME["data_cfg"]["POINT_CLOUD_RANGE"]
    vs = RUNTIME["data_cfg"]["VOXEL_SIZE"]
    xyz = b["point_bxyz"][:, 1:4]
    inside = ((xyz >= pcr[:3]) & (xyz < pcr[3:])).all(1)
    cells = np.concatenate([b["point_bxyz"][:, :1].astype(np.int64),
                            np.floor((xyz - pcr[:3]) / vs).astype(np.int64)], 1)[inside]
    _, rank = np.unique(cells, axis=0, return_inverse=True)  # lexicographic voxel order
    cap = int(rank.max()) // 2
    vfe = DynamicMeanVFE(vs, pcr, cap)
    batch = {"point_bxyz": torch.as_tensor(b["point_bxyz"]),
             "point_feat": torch.as_tensor(b["point_feat"])}
    vfe(dict(batch))
    assert "vfe.points" not in telemetry.COUNTERS  # off: nothing counted
    profiler.enable(True)
    vfe(dict(batch))
    counts = telemetry.snapshot()
    assert counts["vfe.points"] == int(inside.sum())
    assert counts["vfe.points_dropped"] == int((rank.reshape(-1) >= cap).sum()) > 0


def test_tensor_counter_stays_a_tensor_until_snapshot(tracing):
    telemetry.add("x", torch.tensor(3))
    telemetry.add("x", torch.tensor(4))
    telemetry.add("n", 2)
    assert torch.is_tensor(telemetry.COUNTERS["x"]) and telemetry.COUNTERS["n"] == 2
    snap = telemetry.snapshot(reset=True)
    assert snap["x"] == 7 and snap["n"] == 2 and isinstance(snap["x"], int)
    assert snap["tracking_claim_overflow"] == 0 and not telemetry.COUNTERS


@pytest.mark.cuda
def test_spans_and_device_counters_do_not_synchronize(tracing):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.arange(1000, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    for on in (False, True):
        profiler.enable(on)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profiler.span("train_step"):
                with profiler.span("fps"):
                    y = x * 2
                telemetry.add("vfe.points", (y > 10).sum())
        finally:
            torch.cuda.set_sync_debug_mode(0)
    table = profiler.read()
    assert table["fps"]["calls"] == 1 and table["fps"]["parent"] == "train_step"
    assert table["train_step"]["device_ms"] >= table["fps"]["device_ms"] >= 0
    assert telemetry.snapshot()["vfe.points"] == 2 * (1000 - 6)
