"""The port's PointRCNN against the JAX package's, whole (PointNet2MSG,
PointHeadBox, PointRCNNHead), with the flax weights carried over by
``convert.detector_params_from_flax``; its modules alone are in
tests/test_torch_pointrcnn_modules.py.

The whole model runs at tests/test_all_cfgs.py's toy: 2 samples of 512
seeded points (so SALayer's 4,096 FPS picks repeat points and their
distances tie), 16 RoIs a sample, GT boxes next to each sample's first two
RoIs (shifted by 5% of their size and turned by 0.1 rad) and three large
boxes that hold many points. It runs in float64 on both sides (JAX under
``jax.enable_x64``): in float32 the RoI boxes of the two packages differ
by float32 noise (~1e-4 m), which moves points across the boundaries of
the thin RoIs an untrained head gives, and so moves gradients by up to
10% of a tensor's max between two correct float32 runs at 8,192 points.

Tolerances: losses 1e-4 relative; each parameter's gradient within 1e-3 of
that tensor's max |g|; the new batch statistics 1e-5; predict's valid mask
exact, the valid rows' boxes 1e-4 and scores 1e-5.
"""

from pathlib import Path

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
REPO = Path(__file__).resolve().parent.parent

RUNTIME = dict(data_cfg={"POINT_CLOUD_RANGE": [-6.4, -6.4, -1.0, 6.4, 6.4, 2.2],
                         "VOXEL_SIZE": [0.4, 0.4, 0.2]},
               class_names=["Vehicle", "Pedestrian", "Cyclist"], voxel_cap=1024)
CFG = EDict(NAME="PointRCNN", BACKBONE_3D={"NAME": "PointNet2MSG"},
            DENSE_HEAD={"NAME": "PointHeadBox"},
            ROI_HEAD={"NAME": "PointRCNNHead", "NMS_POST_MAXSIZE": 16})


def toy_points(seed=0, n=512):
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:3] = rng.rand(n, 2) * 12 - 6
    pts[:, 3] = rng.rand(n) * 2.5 - 0.8
    return pts, rng.rand(n, 1).astype(np.float32)


def gt_boxes(rois=None):
    """Three large boxes a sample that hold many points (classes 1-3), and,
    given the first run's RoIs, two boxes next to each sample's first two."""
    gt = np.zeros((2, 5, 8), np.float32)
    gt[:, 2] = [-3.0, -3.0, 0.4, 4.0, 4.0, 3.0, 0.2, 1]
    gt[:, 3] = [3.0, -3.0, 0.4, 3.0, 5.0, 3.0, -0.4, 2]
    gt[:, 4] = [-3.0, 3.0, 0.4, 4.0, 3.0, 3.0, 0.7, 3]
    if rois is not None:
        for b in range(2):
            for j, r in enumerate(rois[b, :2].astype(np.float32)):
                gt[b, j, :7] = r
                gt[b, j, :3] += 0.05 * r[3:6]
                gt[b, j, 3:6] *= 1.05
                gt[b, j, 6] += 0.1
                gt[b, j, 7] = 1 + j
    return gt


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model in float64: its variables, a train-mode forward and
    backward of total_loss with GT boxes at its first RoIs, and predict."""
    model = jbuild(CFG, RUNTIME)
    pts, feat = toy_points()
    with jax.enable_x64(True):
        batch = {"point_bxyz": pts.astype(np.float64), "point_feat": feat.astype(np.float64),
                 "gt_boxes": gt_boxes().astype(np.float64)}
        arrs = {k: jnp.asarray(v) for k, v in batch.items()}
        variables = jax.jit(lambda key, a: model.init(key, {**a, "batch_size": 2}, train=True))(
            jax.random.PRNGKey(0), arrs)

        @jax.jit
        def train_fwd_bwd(params, stats, a):
            def loss_fn(p):
                out, mut = model.apply({"params": p, "batch_stats": stats},
                                       {**a, "batch_size": 2}, train=True,
                                       mutable=["batch_stats"])
                return out["losses"]["total_loss"], (out["losses"], mut["batch_stats"],
                                                      out["rois"])
            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        run = lambda a: train_fwd_bwd(variables["params"], variables["batch_stats"], a)  # noqa
        (_, (_, _, rois)), _ = run(arrs)
        batch["gt_boxes"] = gt_boxes(np.asarray(rois)).astype(np.float64)
        arrs["gt_boxes"] = jnp.asarray(batch["gt_boxes"])
        (_, (losses, new_stats, _)), grads = run(arrs)
        pred = jax.jit(lambda v, a: model.apply(v, {**a, "batch_size": 2}, method="predict")[1:])(
            variables, arrs)
        return dict(batch=batch, variables=as_numpy(variables), losses=as_numpy(losses),
                    grads=as_numpy(grads), new_stats=as_numpy(new_stats), pred=as_numpy(pred))


def port_model(run):
    m = tbuild(CFG, RUNTIME, device="cpu").double()
    m.load_state_dict(detector_params_from_flax(run["variables"]), strict=True)
    return m


def torch_batch(b):
    return {**{k: T(v) for k, v in b.items()}, "batch_size": 2}


def test_train_step_equals_jax(jax_run):
    m = port_model(jax_run)
    m.train()
    out = m(torch_batch(jax_run["batch"]))
    out["losses"]["total_loss"].backward()
    keys = sorted(jax_run["losses"])
    assert sorted(out["losses"]) == keys == sorted(
        ["point_loss", "point_loss_box", "point_loss_cls", "rcnn_loss_cls", "rcnn_loss_reg",
         "total_loss"])
    for k in keys:
        assert float(jax_run["losses"][k]) > 0, k  # every term is exercised
        np.testing.assert_allclose(float(out["losses"][k].detach()), float(jax_run["losses"][k]),
                                   rtol=1e-4, err_msg=k)
    ref = detector_params_from_flax({"params": jax_run["grads"]})
    grads = dict(m.named_parameters())
    assert set(grads) == set(ref) and all(p.grad is not None for p in grads.values())
    errs = {n: float((p.grad - ref[n]).abs().max() / max(float(ref[n].abs().max()), 1e-30))
            for n, p in grads.items()}
    print("worst gradient errors of max", sorted(errs.items(), key=lambda kv: -kv[1])[:3])
    for n, p in grads.items():
        r = ref[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-12),
                                   err_msg=n)
    sd = m.state_dict()
    for k, r in detector_params_from_flax({"batch_stats": jax_run["new_stats"]}).items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


def test_predict_equals_jax(jax_run):
    m = port_model(jax_run)
    m.train()
    _, boxes, scores, labels, valid = m.predict(torch_batch(jax_run["batch"]))
    assert m.training
    jb, js, jl, jv = jax_run["pred"]
    assert boxes.shape == jb.shape == (2, 16, 7)
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert jv.any()
    np.testing.assert_allclose(boxes.numpy()[jv], jb[jv], atol=1e-4)
    np.testing.assert_allclose(scores.numpy()[jv], js[jv], atol=1e-5)
    np.testing.assert_array_equal(labels.numpy()[jv], jl[jv])


def test_converter_takes_every_flax_leaf_once(jax_run):
    leaves = jax.tree_util.tree_leaves(jax_run["variables"])
    sd = detector_params_from_flax(jax_run["variables"])
    assert len(sd) == len(leaves)
    assert set(tbuild(CFG, RUNTIME, device="cpu").state_dict()) == set(sd)


def test_pointrcnn_yaml_builds(monkeypatch):
    """pointrcnn.yaml at full widths: no VFE and no BEV path, PointNet2MSG
    with its defaults (32-wide point features), PointHeadBox, PointRCNNHead
    pooling 128 points for each of 100 RoIs a sample; the card by
    default."""
    cfg = cfg_from_yaml_file(str(REPO / "tools/cfgs/waymo_models/pointrcnn.yaml"), EDict())
    runtime = dict(RUNTIME, class_names=list(cfg.CLASS_NAMES))
    m = build_network(cfg.MODEL, runtime, device="cpu")
    assert m.vfe is None and m.map_to_bev is None and m.backbone_2d is None
    assert type(m.backbone_3d).__name__ == "PointNet2MSG" and m.backbone_3d.out_channels == 32
    assert [getattr(m.backbone_3d, f"sa{i}").npoint for i in range(4)] == [4096, 1024, 256, 64]
    assert type(m.dense_head).__name__ == "PointHeadBox"
    assert type(m.roi_head).__name__ == "PointRCNNHead" and m.roi_head.num_sampled == 128
    assert m.num_rois == 100
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_network(cfg.MODEL, runtime)
