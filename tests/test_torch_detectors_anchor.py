"""The port's SECONDNet, SECONDNetIoU, PointPillar and VoxelRCNN against the
JAX package's, whole, with the flax weights carried over by
``convert.detector_params_from_flax``.

Geometry and batch are tests/test_detectors.py's toy (range +-3.2 m x
[-1, 2.2] m, 0.2 m voxels, a 1,024-voxel cap, 2 classes, 2 samples of 512
seeded points), with narrow two-block BEV backbones; SECOND's anchors are
test_detectors.py's two classes, PointPillar's head runs at feature stride
2 over a 16-filter PFN, Voxel R-CNN pools a 4^3 grid for 16 RoIs a sample.
Each JAX model is built once per file, its train step and its predict one
jitted program each (module-scoped fixtures).

Tolerances: losses 1e-4 relative; each parameter's gradient within 1e-3 of
that tensor's max |g|; the new batch statistics 1e-5; predict's valid mask
exact and the valid rows' boxes 1e-4 (scores 1e-5).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.utils.edict import EDict
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import build_network
from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild

torch.set_num_threads(1)
T = torch.as_tensor
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def model_cfg(name):
    voxel = dict(VFE={"NAME": "DynamicMeanVFE"}, BACKBONE_3D={"NAME": "VoxelBackBone8x"},
                 MAP_TO_BEV={"NAME": "HeightCompression"}, BACKBONE_2D=BEV)
    anchor_head = {"NAME": "AnchorHeadSingle", "FEATURE_MAP_STRIDE": 8,
                   "ANCHOR_GENERATOR_CONFIG": ANCHORS}
    if name in ("SECONDNet", "SECONDNetIoU"):
        return EDict(NAME=name, DENSE_HEAD=anchor_head, **voxel)
    if name == "PointPillar":
        return EDict(NAME=name, VFE={"NAME": "DynPillarVFE", "NUM_FILTERS": [16]},
                     MAP_TO_BEV={"NAME": "PointPillarScatter"},
                     BACKBONE_2D=dict(BEV, LAYER_NUMS=[1, 2], LAYER_STRIDES=[2, 2],
                                      NUM_FILTERS=[16, 32], NUM_UPSAMPLE_FILTERS=[16, 16]),
                     DENSE_HEAD=dict(anchor_head, FEATURE_MAP_STRIDE=2))
    return EDict(NAME=name, DENSE_HEAD={"NAME": "CenterHead", "FEATURE_MAP_STRIDE": 8},
                 ROI_HEAD={"NAME": "VoxelRCNNHead", "GRID_SIZE": 4, "NMS_POST_MAXSIZE": 16},
                 **voxel)


def loss_key(name):
    return "total_loss" if name == "VoxelRCNN" else "rpn_loss"


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
    gt[1, 2] = [2.5, -2.0, 0.2, 0.8, 0.6, 1.2, 1.1, 2]
    return {"point_bxyz": pts, "point_feat": feat, "gt_boxes": gt}


def torch_batch(b):
    return {**{k: T(v) for k, v in b.items()}, "batch_size": 2}


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def roi_gt(rois):
    """GT boxes that overlap two of each sample's RoIs well (each RoI
    shifted by (0.1, 0.1, 0.05) m, its sizes 5% larger), so that the RoI
    losses have foreground rows and their gradient reaches the dense head
    through the RoIs; the rest of the table pads. The shift keeps every
    CenterHead target off its prediction: an L1 term at an exact tie would
    take its gradient's sign from last-bit differences."""
    gt = np.zeros((rois.shape[0], 5, 8), np.float32)
    for b in range(rois.shape[0]):
        for j, r in enumerate(rois[b, :2]):
            gt[b, j, :7] = r
            gt[b, j, :3] += (0.1, 0.1, 0.05)
            gt[b, j, 3:6] *= 1.05
            gt[b, j, 7] = 1 + j
    return gt


MODELS = ("SECONDNet", "SECONDNetIoU", "PointPillar", "VoxelRCNN")


@pytest.fixture(scope="module", params=MODELS)
def jax_run(request):
    """One JAX model: its variables, a train-mode forward and backward (for
    Voxel R-CNN on GT boxes placed on its first RoIs), and an eval-mode
    predict."""
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
            return out["losses"][loss_key(name)], (out["losses"], mut["batch_stats"],
                                                   out.get("rois", out["voxel_valid"]))
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    run = lambda a: train_fwd_bwd(variables["params"], variables["batch_stats"], a)  # noqa: E731
    (_, (losses, new_stats, rois)), grads = run(arrs)
    if name == "VoxelRCNN":
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
    name, key = jax_run["name"], loss_key(jax_run["name"])
    m = port_model(jax_run)
    m.train()
    out = m(torch_batch(jax_run["batch"]))
    out["losses"][key].backward()
    keys = sorted(jax_run["losses"])
    assert sorted(out["losses"]) == keys
    rel = {k: abs(float(out["losses"][k].detach()) / float(jax_run["losses"][k]) - 1)
           for k in keys if float(jax_run["losses"][k]) != 0}
    ref = detector_params_from_flax({"params": jax_run["grads"]})
    grads = dict(m.named_parameters())
    assert set(grads) == set(ref)
    worst = max(float((p.grad - ref[n]).abs().max() / max(float(ref[n].abs().max()), 1e-30))
                for n, p in grads.items())
    print(name, "losses' relative errors", rel, "worst gradient error of max", worst)
    for k in keys:
        np.testing.assert_allclose(float(out["losses"][k].detach()), float(jax_run["losses"][k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    for n, p in grads.items():
        r = ref[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-12),
                                   err_msg=n)
    stats = detector_params_from_flax({"batch_stats": jax_run["new_stats"]})
    sd = m.state_dict()
    for k, r in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("jax_run", ["VoxelRCNN"], indirect=True)
def test_roi_losses_reach_the_dense_head(jax_run):
    """Voxel R-CNN: the RoI losses alone give the CenterHead's box maps a
    gradient (through the RoIs) well above the 1e-3 of max that the step's
    comparison with JAX resolves, and both RoI losses are positive."""
    m = port_model(jax_run)
    m.train()
    losses = m(torch_batch(jax_run["batch"]))["losses"]
    assert float(losses["rcnn_loss_reg"]) > 0 and float(losses["rcnn_loss_cls"]) > 0
    (losses["rcnn_loss_cls"] + losses["rcnn_loss_reg"]).backward()
    ref = detector_params_from_flax({"params": jax_run["grads"]})
    for conv in ("center", "center_z", "dim", "rot"):
        n = f"dense_head.head.{conv}.weight"
        g = dict(m.named_parameters())[n].grad
        share = float(g.abs().max() / ref[n].abs().max())
        print(conv, "RoI-loss gradient of the total's max", share)
        assert share > 1e-2, (conv, share)


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


# ---------------------------------------------------------------------------
# the YAML configs through build_network
# ---------------------------------------------------------------------------

PORTED = ("second", "second_iou", "pointpillar", "voxel_rcnn", "part_a2", "pv_rcnn",
          "pv_rcnn_plusplus", "pv_rcnn_plusplus_cotrain")
TINY = dict(data_cfg={"POINT_CLOUD_RANGE": [-6.4, -6.4, -1.0, 6.4, 6.4, 2.2],
                      "VOXEL_SIZE": [0.4, 0.4, 0.2]}, voxel_cap=1024)


def _yaml(name):
    return cfg_from_yaml_file(os.path.join(REPO, f"tools/cfgs/waymo_models/{name}.yaml"), EDict())


@pytest.mark.parametrize("name", PORTED)
def test_build_network_yaml(name, monkeypatch):
    """The config's MODEL at full widths on test_all_cfgs.py's tiny
    geometry: one train-mode forward with finite losses (total_loss with a
    ROI_HEAD), and no card means no default build."""
    cfg = _yaml(name)
    runtime = dict(TINY, class_names=list(cfg.CLASS_NAMES))
    m = build_network(cfg.MODEL, runtime, device="cpu")
    rng = np.random.RandomState(0)
    n = 512
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:3] = rng.rand(n, 2) * 12 - 6
    pts[:, 3] = rng.rand(n) * 2.5 - 0.8
    gt = np.zeros((2, 2, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.8, 1.8, 1.2, 0.3, 1]
    m.train()
    losses = m({"point_bxyz": T(pts), "point_feat": T(rng.rand(n, 1).astype(np.float32)),
                "batch_size": 2, "gt_boxes": T(gt)})["losses"]
    assert all(np.isfinite(float(v.detach())) for v in losses.values())
    assert ("total_loss" in losses) == ("ROI_HEAD" in cfg.MODEL)
    assert m.dense_head.head.num_classes == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_network(cfg.MODEL, runtime)


ALL_YAMLS = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(REPO, "tools/cfgs/waymo_models/*.yaml")))
# the last three configs, each with a module of the JAX package's model zoo
# (ROADMAP.md queue 1 item 4.6) in place of its own
SWAPS = {"pointrcnn": ("BACKBONE_3D", "KPConv"), "sst_centerpoint": ("VFE", "DynamicVFE"),
         "caddn": ("VFE", "PlaneFitting")}
LEFT = ([("VFE", n) for n in ("DynamicVFE", "PlaneFitting", "HybridVFE", "RepsurfDynamicVFE")]
        + [("BACKBONE_3D", n) for n in ("KPConv", "KPConvNet", "PointConvNet", "VolumeConvNet",
                                        "PointGroupNet", "PointPlaneNet", "PointNet2RepSurf")])


def _tiny_batch(n=512):
    rng = np.random.RandomState(0)
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:3] = rng.rand(n, 2) * 12 - 6
    pts[:, 3] = rng.rand(n) * 2.5 - 0.8
    gt = np.zeros((2, 2, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.8, 1.8, 1.2, 0.3, 1]
    return {"point_bxyz": pts, "point_feat": rng.rand(n, 1).astype(np.float32), "gt_boxes": gt}


def _builds_as_jax(cfg, section, module):
    """The config's MODEL with ``module`` in ``section`` builds in the port,
    and its state_dict takes the JAX detector's flax variables (traced at
    test_all_cfgs.py's tiny geometry, not run) strictly: the same modules,
    names and shapes."""
    model = EDict(dict(cfg.MODEL, **{section: {"NAME": module}}))
    runtime = dict(TINY, class_names=list(cfg.CLASS_NAMES))
    m = build_network(model, runtime, device="cpu")
    jm = jbuild(model, runtime)
    batch = {k: jnp.asarray(v) for k, v in _tiny_batch().items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), {**batch, "batch_size": 2},
                                            train=True))
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    m.load_state_dict(detector_params_from_flax(zeros), strict=True)
    return m


@pytest.mark.parametrize("name", sorted(SWAPS))
def test_other_detectors_raise_naming_their_item(name):
    """Each of the last three configs builds, and so does it with a module
    of queue 1 item 4.6 (a VFE or 3D backbone that no config names) in
    place of its own, with the JAX detector's modules, names and shapes."""
    cfg = _yaml(name)
    build_network(cfg.MODEL, dict(TINY, class_names=list(cfg.CLASS_NAMES)), device="cpu")
    _builds_as_jax(cfg, *SWAPS[name])


@pytest.mark.parametrize("section,module", LEFT, ids=[m for _, m in LEFT])
def test_model_zoo_modules_raise_naming_item_4_6(section, module):
    """Every module name of the JAX package's model zoo builds with the JAX
    detector's modules, names and shapes: a VFE in centerpoint.yaml's
    place, a point backbone in pointrcnn.yaml's. A point backbone in
    centerpoint.yaml's place builds in both packages and fails in the
    forward, where the BEV compression finds no sparse tensor (KeyError,
    as in JAX); a name that neither package has raises KeyError at build,
    as in JAX."""
    cfg = _yaml("centerpoint" if section == "VFE" else "pointrcnn")
    _builds_as_jax(cfg, section, module)
    cfg = _yaml("centerpoint")
    runtime = dict(TINY, class_names=list(cfg.CLASS_NAMES))
    if section == "BACKBONE_3D":
        m = build_network(EDict(dict(cfg.MODEL, BACKBONE_3D={"NAME": module})), runtime,
                          device="cpu")
        with pytest.raises(KeyError, match="encoded_spconv_tensor"):
            m.train()({**{k: T(v) for k, v in _tiny_batch().items()}, "batch_size": 2})
    with pytest.raises(KeyError):
        build_network(EDict(dict(cfg.MODEL, **{section: {"NAME": module + "Nowhere"}})),
                      runtime, device="cpu")


def test_temporal_vfe_builds_and_fails_where_jax_fails():
    """TemporalVFE is in JAX's VFES, so both packages build centerpoint.yaml
    with it; it writes no voxel table, so the forward raises KeyError
    ('voxel_features') in the 3D backbone, in both."""
    cfg = _yaml("centerpoint")
    model = EDict(dict(cfg.MODEL, VFE={"NAME": "TemporalVFE"}))
    runtime = dict(TINY, class_names=list(cfg.CLASS_NAMES))
    m = build_network(model, runtime, device="cpu")
    batch = _tiny_batch()
    with pytest.raises(KeyError, match="voxel_features"):
        m.train()({**{k: T(v) for k, v in batch.items()}, "batch_size": 2})
    jm = jbuild(model, runtime)
    with pytest.raises(KeyError, match="voxel_features"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), {
            **{k: jnp.asarray(v) for k, v in batch.items()}, "batch_size": 2}, train=True))


def test_seven_detectors_remain():
    """No detector config remains: all twelve YAMLs of tools/cfgs/waymo_models
    build on the CPU at test_all_cfgs.py's tiny geometry, each with the
    detector its MODEL.NAME names."""
    assert len(ALL_YAMLS) == 12
    assert set(ALL_YAMLS) == set(PORTED) | {"centerpoint"} | set(SWAPS)
    for name in ALL_YAMLS:
        cfg = _yaml(name)
        m = build_network(cfg.MODEL, dict(TINY, class_names=list(cfg.CLASS_NAMES)), device="cpu")
        assert type(m).__name__ == "Detector3DTemplate", name
