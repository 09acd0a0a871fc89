"""The port's CenterPoint against the JAX package's, layer by layer and
whole, with the flax weights carried over by
``convert.detector_params_from_flax``.

Geometry and batch are tests/test_detectors.py's toy: range +-3.2 m x
[-1, 2.2] m, 0.2 m voxels, a 1,024-voxel cap, 2 classes, 2 samples of
points drawn from one seeded RandomState (512 points), VoxelResBackBone8x
and narrow BEV widths (LAYER_NUMS [2, 2], NUM_FILTERS [32, 64],
NUM_UPSAMPLE_FILTERS [32, 32]). Every JAX program is compiled once per
file (module-scoped fixtures).

Tolerances: the voxel table and the targets' integer parts are exact. Batch
norms, the BEV backbone and the targets' floats: 1e-5. The whole model in
train mode: losses 1e-4 relative, each parameter's gradient within 1e-3 of
that tensor's max |g|, the new batch statistics 1e-5. Predictions: scores
1e-5, labels and valid exact, the valid rows' boxes 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import backbones_2d as jb2
from pcseqlearning_tpu.models import layers as jl
from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.utils.edict import EDict
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import backbones_2d as tb2
from pcseqlearning_tpu_torch.models import build_network
from pcseqlearning_tpu_torch.models import layers as tl
from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild

# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)
T = torch.as_tensor

RUNTIME = dict(data_cfg={"POINT_CLOUD_RANGE": [-3.2, -3.2, -1.0, 3.2, 3.2, 2.2],
                         "VOXEL_SIZE": [0.2, 0.2, 0.2]},
               class_names=["Vehicle", "Pedestrian"], voxel_cap=1024)
BEV = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2, 2], "LAYER_STRIDES": [1, 2],
       "NUM_FILTERS": [32, 64], "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [32, 32]}


def centerpoint_cfg(backbone="VoxelResBackBone8x"):
    return EDict(NAME="CenterPoint", VFE={"NAME": "DynamicMeanVFE"},
                 BACKBONE_3D={"NAME": backbone}, MAP_TO_BEV={"NAME": "HeightCompression"},
                 BACKBONE_2D=BEV, DENSE_HEAD={"NAME": "CenterHead", "FEATURE_MAP_STRIDE": 8})


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


@pytest.fixture(scope="module")
def jax_run():
    """The JAX CenterPoint: its variables, a train-mode forward and
    backward, and an eval-mode predict with the heatmap kernel scaled up
    (seeded) so that scores spread across the 0.1 threshold."""
    model = jbuild(centerpoint_cfg(), RUNTIME)
    arrs = {k: jnp.asarray(v) for k, v in toy_batch().items()}
    variables = jax.jit(lambda key, a: model.init(key, {**a, "batch_size": 2}, train=True))(
        jax.random.PRNGKey(0), arrs)

    @jax.jit
    def train_fwd_bwd(params, stats, a):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, {**a, "batch_size": 2},
                                   train=True, mutable=["batch_stats"])
            return out["losses"]["center_loss"], (out["losses"], mut["batch_stats"],
                                                  out["voxel_coords"], out["voxel_valid"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (losses, new_stats, vcoords, vvalid)), grads = train_fwd_bwd(
        variables["params"], variables["batch_stats"], arrs)
    params = as_numpy(variables["params"])
    hm = params["dense_head"]["head"]["Conv_1"]
    hm["kernel"] = (hm["kernel"] * 8.0).astype(np.float32)
    pred_vars = {"params": params, "batch_stats": as_numpy(variables["batch_stats"])}
    pred = jax.jit(lambda v, a: model.apply(v, {**a, "batch_size": 2},
                                            method="predict")[1:])(pred_vars, arrs)
    return dict(variables=as_numpy(variables), losses=as_numpy(losses), grads=as_numpy(grads),
                new_stats=as_numpy(new_stats), voxel_coords=np.asarray(vcoords),
                voxel_valid=np.asarray(vvalid), pred_vars=pred_vars, pred=as_numpy(pred))


def port_model(variables, backbone="VoxelResBackBone8x"):
    m = tbuild(centerpoint_cfg(backbone), RUNTIME, device="cpu")
    m.load_state_dict(detector_params_from_flax(variables), strict=True)
    return m


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_masked_batch_norm_equals_jax(rng, train):
    x = (rng.randn(40, 6) * 2 + 1).astype(np.float32)
    valid = rng.rand(40) > 0.3
    stats = {"mean": rng.randn(6).astype(np.float32), "var": rng.rand(6).astype(np.float32) + 0.5}
    params = {"scale": rng.rand(6).astype(np.float32) + 0.5, "bias": rng.randn(6).astype(np.float32)}
    y, mut = jl.MaskedBatchNorm().apply({"params": params, "batch_stats": stats}, x, valid,
                                        train=train, mutable=["batch_stats"])
    bn = tl.MaskedBatchNorm(6)
    bn.load_state_dict(detector_params_from_flax({"params": params, "batch_stats": stats}))
    bn.train(train)
    np.testing.assert_allclose(bn(T(x), T(valid)).detach().numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               atol=1e-6)
    assert not bn(T(x), T(valid))[~T(valid)].any()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_2d_equals_jax(rng, train):
    x = (rng.randn(2, 5, 7, 6) * 2 + 1).astype(np.float32)  # NHWC for flax
    stats = {"mean": rng.randn(6).astype(np.float32), "var": rng.rand(6).astype(np.float32) + 0.5}
    params = {"scale": rng.rand(6).astype(np.float32) + 0.5, "bias": rng.randn(6).astype(np.float32)}
    y, mut = jl.BatchNorm2d().apply({"params": params, "batch_stats": stats}, x, train=train,
                                    mutable=["batch_stats"])
    bn = tl.BatchNorm2d(6)
    bn.load_state_dict(detector_params_from_flax({"params": params, "batch_stats": stats}))
    bn.train(train)
    got = bn(T(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(y), atol=1e-5)
    # the biased batch variance, where torch.nn.BatchNorm2d keeps the unbiased one
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6)


def test_deconv_kernel_mapping(rng):
    """flax's ConvTranspose does not flip its kernel and torch's does: the
    converter flips it, so a 2x2 stride-2 deconv alone gives flax's map."""
    import flax.linen as nn

    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    k = rng.randn(2, 2, 5, 6).astype(np.float32)
    y = nn.ConvTranspose(6, (2, 2), strides=(2, 2), use_bias=False).apply({"params": {"kernel": k}}, x)
    w = detector_params_from_flax({"params": {"deblock1": {"kernel": k}}})["deblock1.weight"]
    de = torch.nn.ConvTranspose2d(5, 6, 2, stride=2, bias=False)
    de.weight.data.copy_(w)
    got = de(T(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(y), atol=1e-5)
    unit = np.zeros((1, 1, 1, 1), np.float32) + 1
    ku = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32).reshape(2, 2, 1, 1)
    wu = detector_params_from_flax({"params": {"deblock1": {"kernel": ku}}})["deblock1.weight"]
    np.testing.assert_array_equal(torch.nn.functional.conv_transpose2d(T(unit), wu, stride=2)[0, 0],
                                  [[4.0, 3.0], [2.0, 1.0]])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bev_backbone_equals_jax(rng, train):
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    mod = jb2.BaseBEVBackbone(layer_nums=(2, 2), layer_strides=(1, 2), num_filters=(32, 64),
                              upsample_strides=(1, 2), num_upsample_filters=(32, 32))
    v = mod.init(jax.random.PRNGKey(1), {"spatial_features": jnp.asarray(x)}, train=True)
    out, mut = mod.apply(v, {"spatial_features": jnp.asarray(x)}, train=train,
                         mutable=["batch_stats"])
    port = tb2.BaseBEVBackbone(16, layer_nums=(2, 2), layer_strides=(1, 2), num_filters=(32, 64),
                               upsample_strides=(1, 2), num_upsample_filters=(32, 32))
    port.load_state_dict(detector_params_from_flax(as_numpy(v)), strict=True)
    port.train(train)
    got = port({"spatial_features": T(x).permute(0, 3, 1, 2)})["spatial_features_2d"]
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(out["spatial_features_2d"]), atol=1e-5)
    ref_stats = detector_params_from_flax({"batch_stats": as_numpy(mut["batch_stats"])})
    for k, ref in ref_stats.items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("backbone", ["VoxelResBackBone8x", "VoxelBackBone8x"])
def test_backbone_3d_equals_jax(backbone):
    """The VFE and the 3D backbone in train mode: the encoded table's
    coords and validity exact, features to 1e-4 of their max."""
    model = jbuild(centerpoint_cfg(backbone), RUNTIME)
    arrs = {k: jnp.asarray(v) for k, v in toy_batch().items()}
    variables = jax.jit(lambda key, a: model.init(key, {**a, "batch_size": 2}, train=True))(
        jax.random.PRNGKey(2), arrs)

    def encode(v, a):
        out, _ = model.apply(v, {**a, "batch_size": 2}, mutable=["batch_stats"],
                             method=lambda m, bd: m.backbone_3d(m.vfe(bd, True), True))
        st = out["encoded_spconv_tensor"]
        return st.features, st.coords, st.valid

    jf, jc, jv = jax.jit(encode)(variables, arrs)
    m = port_model(as_numpy(variables), backbone)
    bd = m.backbone_3d(m.vfe(torch_batch(toy_batch())))
    st = bd["encoded_spconv_tensor"]
    np.testing.assert_array_equal(st.coords.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(jv))
    jf = np.asarray(jf)
    np.testing.assert_allclose(st.features.detach().numpy(), jf, atol=1e-4 * np.abs(jf).max())


# ---------------------------------------------------------------------------
# the head and the whole model
# ---------------------------------------------------------------------------


def test_build_targets_equal_jax(jax_run):
    from pcseqlearning_tpu.models.dense_heads import CenterHead as JHead

    gt = toy_batch()["gt_boxes"]
    gt[0, 3] = [9.0, 9.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1]  # outside the grid: masked
    jh = JHead(num_classes=2, grid_size_xy=(32, 32), point_cloud_range=(-3.2, -3.2, -1.0, 3.2, 3.2, 2.2))
    ref = jax.jit(jh.build_targets)(jnp.asarray(gt))
    head = port_model(jax_run["variables"]).dense_head.head
    got = head.build_targets(T(gt))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)  # heatmap
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)  # reg targets
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))  # inds
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))  # mask
    assert got[3].sum() == 5 and got[0].max() == 1.0


def ref_keys():
    return ("hm_loss", "loc_loss", "center_loss")


def test_centerpoint_train_step_equals_jax(jax_run):
    m = port_model(jax_run["variables"])
    m.train()
    out = m(torch_batch(toy_batch()))
    out["losses"]["center_loss"].backward()
    np.testing.assert_array_equal(out["voxel_coords"].numpy(), jax_run["voxel_coords"])
    np.testing.assert_array_equal(out["voxel_valid"].numpy(), jax_run["voxel_valid"])
    for k in ref_keys():
        np.testing.assert_allclose(float(out["losses"][k].detach()), float(jax_run["losses"][k]),
                                   rtol=1e-4)
    ref = detector_params_from_flax({"params": jax_run["grads"]})
    grads = dict(m.named_parameters())
    assert set(grads) == set(ref)
    print("losses' relative errors", {k: abs(float(out["losses"][k].detach())
                                          / float(jax_run["losses"][k]) - 1) for k in ref_keys()},
          "worst gradient error of max", max(float((p.grad - ref[n]).abs().max()
                                                    / ref[n].abs().max()) for n, p in grads.items()))
    for name, p in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-12),
                                   err_msg=name)
    stats = detector_params_from_flax({"batch_stats": jax_run["new_stats"]})
    sd = m.state_dict()
    for k, r in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


def test_predict_equals_jax(jax_run):
    m = port_model(jax_run["pred_vars"])
    m.train()  # predict runs in eval mode and restores the mode
    _, boxes, scores, labels, valid = m.predict(torch_batch(toy_batch()))
    assert m.training
    jb, js, jl_, jv = jax_run["pred"]
    print("score error", np.abs(scores.numpy() - js).max(), "valid boxes' error",
          np.abs(boxes.numpy()[jv] - jb[jv]).max())
    np.testing.assert_allclose(scores.numpy(), js, atol=1e-5)
    np.testing.assert_array_equal(labels.numpy(), jl_)
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert 0 < jv.sum() < jv.size  # scores on both sides of the threshold
    np.testing.assert_allclose(boxes.numpy()[jv], jb[jv], atol=1e-4)


def test_converter_takes_every_flax_leaf_once(jax_run):
    leaves = jax.tree_util.tree_leaves(jax_run["variables"])
    sd = detector_params_from_flax(jax_run["variables"])
    assert len(sd) == len(leaves)
    m = tbuild(centerpoint_cfg(), RUNTIME, device="cpu")
    assert set(m.state_dict()) == set(sd)  # and load_state_dict(strict) covers the rest
    m.load_state_dict(sd, strict=True)


def test_build_network_centerpoint_yaml(monkeypatch):
    from pathlib import Path

    from pcseqlearning_tpu_torch.config import cfg_from_yaml_file

    repo = Path(__file__).resolve().parents[1]
    cfg = cfg_from_yaml_file(str(repo / "tools/cfgs/waymo_models/centerpoint.yaml"), EDict())
    runtime = dict(RUNTIME, class_names=list(cfg.CLASS_NAMES), voxel_cap=cfg.MODEL.VOXEL_CAP)
    m = build_network(cfg.MODEL, runtime, device="cpu")
    assert m.backbone_2d.num_bev_features == 512 and m.dense_head.head.num_classes == 3
    assert m.backbone_3d.voxel_cap == 150_000
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_network(cfg.MODEL, runtime)  # the card by default
    for name, key in (("SECONDNet", "DENSE_HEAD"), ("PointPillar", "MAP_TO_BEV")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_network(dict(cfg.MODEL, NAME=name), runtime, device="cpu")
    bad = EDict(dict(cfg.MODEL, DENSE_HEAD={"NAME": "AnchorHeadSingle"}))
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        tbuild(bad, runtime, device="cpu")
