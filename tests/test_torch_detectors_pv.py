"""The port's PartA2Net, PVRCNN, PVRCNNPlusPlus and PVRCNNPlusPlusCoTrain
against the JAX package's, whole, with the flax weights carried over by
``convert.detector_params_from_flax``.

Geometry and batch are tests/test_torch_detectors_anchor.py's toy (range
+-3.2 m x [-1, 2.2] m, 0.2 m voxels, a 1,024-voxel cap, 2 classes, 2
samples of 512 seeded points with no ``point_valid``), narrow two-block BEV
backbones and 16 RoIs a sample. PartA2 runs UNetV2, the anchor head and
PartA2FCHead (its 12^3 grid: the JAX detector ignores GRID_SIZE); the PV
models run 64 FPS keypoints a sample and PVRCNNHead on a 4^3 grid: PV-RCNN
with VoxelBackBone8x, the SA groups and the anchor head, PV-RCNN++ with
VoxelResBackBone8x, vector pooling and CenterHead, the co-train with the
seg head too. Each JAX model's train step and predict are one jitted
program each (module-scoped fixture); the GT boxes sit next to each
sample's first two RoIs, so that the RoI losses have foreground rows.

Tolerances: losses 1e-4 relative; each parameter's gradient within 1e-3 of
that tensor's max |g|; the new batch statistics 1e-5; predict's valid mask
exact, the valid rows' boxes 1e-4 and scores 1e-5.
"""

import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.utils.edict import EDict
from pcseqlearning_tpu_torch import test as test_cli
from pcseqlearning_tpu_torch import train
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import build_network
from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild
from pcseqlearning_tpu_torch.scene import detector_argv, write_detector_sequences

torch.set_num_threads(1)
T = torch.as_tensor
REPO = Path(__file__).resolve().parent.parent

RUNTIME = dict(data_cfg={"POINT_CLOUD_RANGE": [-3.2, -3.2, -1.0, 3.2, 3.2, 2.2],
                         "VOXEL_SIZE": [0.2, 0.2, 0.2]},
               class_names=["Vehicle", "Pedestrian"], voxel_cap=1024)
BEV = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2, 2], "LAYER_STRIDES": [1, 2],
       "NUM_FILTERS": [32, 64], "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [32, 32]}
ANCHORS = [
    {"anchor_sizes": [[1.6, 1.6, 1.0]], "anchor_rotations": [0, 1.57],
     "anchor_bottom_heights": [0.0], "matched_threshold": 0.4, "unmatched_threshold": 0.2},
    {"anchor_sizes": [[0.8, 0.8, 1.0]], "anchor_rotations": [0, 1.57],
     "anchor_bottom_heights": [0.0], "matched_threshold": 0.3, "unmatched_threshold": 0.15},
]
MODELS = ("PartA2Net", "PVRCNN", "PVRCNNPlusPlus", "PVRCNNPlusPlusCoTrain")


def model_cfg(name):
    cfg = EDict(NAME=name, VFE={"NAME": "DynamicMeanVFE"},
                MAP_TO_BEV={"NAME": "HeightCompression"}, BACKBONE_2D=BEV)
    anchor_head = {"NAME": "AnchorHeadSingle", "FEATURE_MAP_STRIDE": 8,
                   "ANCHOR_GENERATOR_CONFIG": ANCHORS}
    if name == "PartA2Net":
        cfg.update(BACKBONE_3D={"NAME": "UNetV2"}, DENSE_HEAD=anchor_head,
                   ROI_HEAD={"NAME": "PartA2FCHead", "NMS_POST_MAXSIZE": 16})
        return cfg
    cfg.update(BACKBONE_3D={"NAME": "VoxelBackBone8x" if name == "PVRCNN" else
                            "VoxelResBackBone8x"},
               PFE={"NAME": "VoxelSetAbstraction", "NUM_KEYPOINTS": 64},
               DENSE_HEAD=anchor_head if name == "PVRCNN" else
               {"NAME": "CenterHead", "FEATURE_MAP_STRIDE": 8},
               ROI_HEAD={"NAME": "PVRCNNHead", "GRID_SIZE": 4, "NMS_POST_MAXSIZE": 16})
    if "CoTrain" in name:
        cfg["SEG_HEAD"] = {"NAME": "PointSegHead", "NUM_SEG_CLASSES": 23}
    return cfg


def toy_batch(seed=0, n_points=512, batch=2):
    rng = np.random.RandomState(seed)
    pts = np.zeros((n_points, 4), np.float32)
    pts[:, 0] = rng.randint(0, batch, n_points)
    pts[:, 1:3] = rng.rand(n_points, 2) * 6.0 - 3.0
    pts[:, 3] = rng.rand(n_points) * 1.5 - 0.5
    feat = rng.rand(n_points, 1).astype(np.float32)
    gt = np.zeros((batch, 5, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.5, 1.5, 1.0, 0.3, 1]
    gt[:, 1] = [-1.0, -1.0, 0.5, 1.0, 1.0, 1.0, -0.3, 2]
    return {"point_bxyz": pts, "point_feat": feat, "gt_boxes": gt}


def torch_batch(b):
    return {**{k: T(v) for k, v in b.items()}, "batch_size": 2}


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def roi_gt(rois):
    """GT boxes next to each sample's first two RoIs (shifted by (0.1, 0.1,
    0.05) m, sizes 5% larger): foreground RoIs whose regression targets sit
    off the predictions."""
    gt = np.zeros((rois.shape[0], 5, 8), np.float32)
    for b in range(rois.shape[0]):
        for j, r in enumerate(rois[b, :2]):
            gt[b, j, :7] = r
            gt[b, j, :3] += (0.1, 0.1, 0.05)
            gt[b, j, 3:6] *= 1.05
            gt[b, j, 7] = 1 + j
    return gt


@pytest.fixture(scope="module", params=MODELS)
def jax_run(request):
    """One JAX model: its variables, a train-mode forward and backward of
    total_loss on GT boxes placed at its first RoIs, and predict."""
    name = request.param
    model = jbuild(model_cfg(name), RUNTIME)
    batch = toy_batch()
    arrs = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda key, a: model.init(key, {**a, "batch_size": 2}, train=True))(
        jax.random.PRNGKey(0), arrs)

    @jax.jit
    def train_fwd_bwd(params, stats, a):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, {**a, "batch_size": 2},
                                   train=True, mutable=["batch_stats"])
            return out["losses"]["total_loss"], (out["losses"], mut["batch_stats"], out["rois"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    run = lambda a: train_fwd_bwd(variables["params"], variables["batch_stats"], a)  # noqa: E731
    (_, (_, _, rois)), _ = run(arrs)
    batch["gt_boxes"] = roi_gt(np.asarray(rois))
    arrs["gt_boxes"] = jnp.asarray(batch["gt_boxes"])
    (_, (losses, new_stats, _)), grads = run(arrs)
    pred = jax.jit(lambda v, a: model.apply(v, {**a, "batch_size": 2}, method="predict")[1:])(
        variables, arrs)
    return dict(name=name, batch=batch, variables=as_numpy(variables), losses=as_numpy(losses),
                grads=as_numpy(grads), new_stats=as_numpy(new_stats), pred=as_numpy(pred))


def port_model(run):
    m = tbuild(model_cfg(run["name"]), RUNTIME, device="cpu")
    m.load_state_dict(detector_params_from_flax(run["variables"]), strict=True)
    return m


def test_train_step_equals_jax(jax_run):
    name = jax_run["name"]
    m = port_model(jax_run)
    m.train()
    out = m(torch_batch(jax_run["batch"]))
    out["losses"]["total_loss"].backward()
    keys = sorted(jax_run["losses"])
    assert sorted(out["losses"]) == keys
    assert ("seg_loss" in keys) == ("CoTrain" in name)
    rel = {k: abs(float(out["losses"][k].detach()) / float(jax_run["losses"][k]) - 1)
           for k in keys if float(jax_run["losses"][k]) != 0}
    ref = detector_params_from_flax({"params": jax_run["grads"]})
    grads = dict(m.named_parameters())
    assert set(grads) == set(ref)
    missing = [n for n, p in grads.items() if p.grad is None]
    assert all(not ref[n].any() for n in missing), missing  # only JAX's zero gradients
    errs = {n: float((p.grad - ref[n]).abs().max() / max(float(ref[n].abs().max()), 1e-30))
            for n, p in grads.items() if p.grad is not None}
    print(name, "losses' relative errors", rel, "worst gradient errors of max",
          sorted(errs.items(), key=lambda kv: -kv[1])[:3])
    for k in keys:
        np.testing.assert_allclose(float(out["losses"][k].detach()), float(jax_run["losses"][k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    for n, p in grads.items():
        if p.grad is not None:
            r = ref[n].numpy()
            np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-12),
                                       err_msg=n)
    stats = detector_params_from_flax({"batch_stats": jax_run["new_stats"]})
    sd = m.state_dict()
    for k, r in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


def _dense_head_boxes(m):
    """The dense head's box-regressing conv weights."""
    names = [n for n, _ in m.named_parameters() if n.startswith("dense_head.")
             and n.endswith(".weight") and any(c in n for c in ("center", "dim", "rot", "conv_box"))]
    assert names
    return names


@pytest.mark.parametrize("jax_run", MODELS, indirect=True)
def test_roi_losses_reach_the_dense_head(jax_run):
    """The RoI losses alone give the dense head's box convs a gradient well
    above the 1e-3 of max that the step's comparison resolves, and both are
    positive. The RoIs are not detached, as in JAX: the regression targets
    (in the RoI's frame) and the IoU-guided class targets depend on them in
    every model, and PV-RCNN's grid points too; PartA2's pooling takes them
    through discrete cells only."""
    m = port_model(jax_run)
    m.train()
    losses = m(torch_batch(jax_run["batch"]))["losses"]
    assert float(losses["rcnn_loss_reg"].detach()) > 0
    assert float(losses["rcnn_loss_cls"].detach()) > 0
    (losses["rcnn_loss_cls"] + losses["rcnn_loss_reg"]).backward()
    ref = detector_params_from_flax({"params": jax_run["grads"]})
    params = dict(m.named_parameters())
    for n in _dense_head_boxes(m):
        share = float(params[n].grad.abs().max() / ref[n].abs().max())
        print(jax_run["name"], n, "RoI-loss gradient of the total's max", share)
        assert share > 1e-2, (n, share)


def test_predict_equals_jax(jax_run):
    m = port_model(jax_run)
    m.train()  # predict runs in eval mode and restores the mode
    _, boxes, scores, labels, valid = m.predict(torch_batch(jax_run["batch"]))
    assert m.training
    jb, js, jl, jv = jax_run["pred"]
    assert boxes.shape == jb.shape and valid.shape == jv.shape
    print(jax_run["name"], "valid", int(jv.sum()), "of", jv.size, "boxes' error",
          np.abs(boxes.numpy()[jv] - jb[jv]).max() if jv.any() else None)
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert jv.any()
    np.testing.assert_allclose(boxes.numpy()[jv], jb[jv], atol=1e-4)
    np.testing.assert_allclose(scores.numpy()[jv], js[jv], atol=1e-5)
    np.testing.assert_array_equal(labels.numpy()[jv], jl[jv])


def test_converter_takes_every_flax_leaf_once(jax_run):
    leaves = jax.tree_util.tree_leaves(jax_run["variables"])
    sd = detector_params_from_flax(jax_run["variables"])
    assert len(sd) == len(leaves)
    m = tbuild(model_cfg(jax_run["name"]), RUNTIME, device="cpu")
    assert set(m.state_dict()) == set(sd)
    m.load_state_dict(sd, strict=True)


def test_cotrain_raises_with_point_valid_as_jax_does():
    """The seg head masks the keypoint rows with the raw points'
    ``point_valid``: with the mask that the train step always adds (512
    points against 128 keypoints), JAX raises while it traces the forward
    (the shapes do not broadcast), and so does the port."""
    name = "PVRCNNPlusPlusCoTrain"
    batch = toy_batch()
    batch["point_valid"] = np.ones(len(batch["point_bxyz"]), bool)
    model = jbuild(model_cfg(name), RUNTIME)
    arrs = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), {**a, "batch_size": 2},
                                            train=True), arrs)
    m = tbuild(model_cfg(name), RUNTIME, device="cpu")
    for mode in (True, False):
        m.train(mode)
        with pytest.raises(ValueError, match="do not broadcast"):
            m(torch_batch(batch))
    del batch["point_valid"]
    m.train()
    assert "seg_loss" in m(torch_batch(batch))["losses"]


# ---------------------------------------------------------------------------
# the YAML configs through build_network and the CLIs
# ---------------------------------------------------------------------------

YAMLS = ("part_a2", "pv_rcnn", "pv_rcnn_plusplus", "pv_rcnn_plusplus_cotrain")
TINY = dict(data_cfg={"POINT_CLOUD_RANGE": [-6.4, -6.4, -1.0, 6.4, 6.4, 2.2],
                      "VOXEL_SIZE": [0.4, 0.4, 0.2]}, voxel_cap=1024)


def _yaml(name):
    return cfg_from_yaml_file(str(REPO / f"tools/cfgs/waymo_models/{name}.yaml"), EDict())


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_builds_the_configured_modules(name, monkeypatch):
    """Each config's MODEL at full widths: the modules it names (UNetV2 and
    PartA2FCHead's 12^3 grid; the PFE's 4,096 keypoints and aggregation;
    PVRCNNHead's 6^3 grid; the co-train's seg head), and no card means no
    default build."""
    cfg = _yaml(name)
    runtime = dict(TINY, class_names=list(cfg.CLASS_NAMES))
    m = build_network(cfg.MODEL, runtime, device="cpu")
    assert type(m.backbone_3d).__name__ == cfg.MODEL.BACKBONE_3D.NAME
    assert type(m.roi_head).__name__ == cfg.MODEL.ROI_HEAD.NAME
    assert (m.pfe is not None) == ("PFE" in cfg.MODEL)
    assert (m.seg_head is not None) == ("SEG_HEAD" in cfg.MODEL)
    if name == "part_a2":
        assert m.roi_head.grid_size == 12 and m.roi_head.head.linear0.in_features == 12 ** 3
    else:
        assert m.pfe.num_keypoints == 4096 and m.roi_head.grid_size == 6
        assert m.pfe.aggregation == ("sa" if name == "pv_rcnn" else "vector_pool")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_network(cfg.MODEL, runtime)


SHRINK = ["DATA_CONFIG.POINT_CLOUD_RANGE", "[-76.8,-76.8,-2,76.8,76.8,4]",
          "DATA_CONFIG.VOXEL_SIZE", "[1.6,1.6,0.2]",
          "DATA_CONFIG.DATA_PROCESSOR.2.VOXEL_SIZE", "[1.6,1.6,0.2]",
          "MODEL.POINT_CAP", "2000", "MODEL.VOXEL_CAP", "1024",
          "MODEL.BACKBONE_2D.LAYER_NUMS", "[1,1]", "MODEL.BACKBONE_2D.NUM_FILTERS", "[16,32]",
          "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16,16]",
          "MODEL.ROI_HEAD.NMS_POST_MAXSIZE", "16"]


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pv_cli")
    train_path, val_path = write_detector_sequences(root, frames=2, points=2000, val_frames=1)
    return root, train_path, val_path


@pytest.mark.parametrize("model", ["part_a2", "pv_rcnn"])
def test_part_a2_and_pv_rcnn_through_both_clis(cli_data, model):
    """part_a2.yaml and pv_rcnn.yaml (PV-RCNN at 128 keypoints) with
    detection_1sweep.yaml and adam_onecycle.yaml, shrunk through ``--set``
    as tests/test_torch_detector_cli.py does: one epoch writes its
    checkpoint with finite losses, and the test CLI scores it with every
    AP/APH value finite."""
    root, train_path, val_path = cli_data
    cfgs = (f"tools/cfgs/waymo_models/{model}.yaml",
            "tools/cfgs/dataset_configs/waymo/detection_1sweep.yaml",
            "tools/cfgs/optimizers/adam_onecycle.yaml")
    shrink = SHRINK + (["MODEL.PFE.NUM_KEYPOINTS", "128"] if model == "pv_rcnn" else [])
    res = train.main(detector_argv(REPO, train_path, root, "cpu", "--batch_size", "2", "--epochs",
                                   "1", "--fix_random_seed", "--extra_tag", "cli", cfgs=cfgs,
                                   overrides=shrink))
    hist = res["history"]
    assert len(hist) == 1 and all(math.isfinite(v) for v in hist[0]["losses"].values())
    assert {"rcnn_loss_cls", "rcnn_loss_reg", "rpn_loss", "total_loss"} <= set(hist[0]["losses"])
    assert os.listdir(res["ckpt_dir"]) == ["checkpoint_epoch_1"]
    argv = detector_argv(REPO, val_path, root, "cpu", "--extra_tag", "cli", cfgs=cfgs,
                         overrides=shrink)
    ckpt = str(Path(res["ckpt_dir"]) / "checkpoint_epoch_1")
    table = test_cli.main(argv[:3] + ["--ckpt", ckpt] + argv[3:])[ckpt]
    assert {"Vehicle/L1/AP", "Vehicle/L2/APH"} <= set(table)
    assert all(math.isfinite(v) for v in table.values())
