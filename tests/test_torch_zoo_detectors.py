"""The model zoo through ``build_network``, whole: one train step of the
port against the JAX package's for centerpoint.yaml with each zoo VFE
(DynamicVFE, PlaneFitting, RepsurfDynamicVFE) and pointrcnn.yaml with
KPConv and with PointConvNet, at tests/test_torch_detectors_anchor.py's
TINY geometry (+-6.4 m, 0.4 m voxels, a 1,024-voxel cap, 2 samples of 512
seeded points), the flax weights carried over by
``convert.detector_params_from_flax``.

Cut for the test's time: centerpoint.yaml's BEV backbone narrowed to
tests/test_torch_detectors_anchor.py's two-block BEV (the VFE, the sparse
backbone and the head keep the YAML's widths), pointrcnn.yaml's RoIs to 16
a sample. Both run in float64 (JAX under ``jax.enable_x64``), as
tests/test_torch_pointrcnn.py does: PlaneFitting's normals and the RoI
boxes of an untrained head move by float32 noise.

Tolerances: losses 1e-4 relative; each parameter's gradient within 1e-3 of
that tensor's max |g|, or within 1e-6 of the network's largest |g| where
that is more (biases before batch norms carry only rounding); voxel tables
exactly. Budget: ~2 min (JAX compiles each model once).
"""

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

torch.set_num_threads(1)
T = torch.as_tensor
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(data_cfg={"POINT_CLOUD_RANGE": [-6.4, -6.4, -1.0, 6.4, 6.4, 2.2],
                      "VOXEL_SIZE": [0.4, 0.4, 0.2]}, voxel_cap=1024)
BEV = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2, 2], "LAYER_STRIDES": [1, 2],
       "NUM_FILTERS": [32, 64], "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [32, 32]}
CASES = [("centerpoint", "VFE", "DynamicVFE"), ("centerpoint", "VFE", "PlaneFitting"),
         ("centerpoint", "VFE", "RepsurfDynamicVFE"), ("pointrcnn", "BACKBONE_3D", "KPConv"),
         ("pointrcnn", "BACKBONE_3D", "PointConvNet")]


def zoo_model(name, section, module):
    cfg = cfg_from_yaml_file(os.path.join(REPO, f"tools/cfgs/waymo_models/{name}.yaml"), EDict())
    model = dict(cfg.MODEL, **{section: {"NAME": module}})
    if name == "centerpoint":
        model["BACKBONE_2D"] = BEV
    else:
        model["ROI_HEAD"] = dict(model["ROI_HEAD"], NMS_POST_MAXSIZE=16)
    return EDict(model), dict(TINY, class_names=list(cfg.CLASS_NAMES))


def toy_batch():
    rng = np.random.RandomState(0)
    n = 512
    pts = np.zeros((n, 4))
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:3] = rng.rand(n, 2) * 12 - 6
    pts[:, 3] = rng.rand(n) * 2.5 - 0.8
    gt = np.zeros((2, 4, 8))
    gt[:, 0] = [1.0, 1.0, 0.5, 1.8, 1.8, 1.2, 0.3, 1]
    gt[:, 1] = [-3.0, -3.0, 0.4, 4.0, 4.0, 3.0, 0.2, 1]
    gt[1, 2] = [3.0, -3.0, 0.4, 3.0, 5.0, 3.0, -0.4, 2]
    return {"point_bxyz": pts.astype(np.float32).astype(np.float64),
            "point_feat": rng.rand(n, 1).astype(np.float32).astype(np.float64), "gt_boxes": gt}


@pytest.mark.parametrize("name,section,module", CASES, ids=[c[2] for c in CASES])
def test_zoo_detector_train_step_equals_jax(name, section, module):
    model, runtime = zoo_model(name, section, module)
    loss_key = "total_loss" if name == "pointrcnn" else "center_loss"
    batch = toy_batch()
    jm = jbuild(model, runtime)
    with jax.enable_x64(True):
        arrs = {**{k: jnp.asarray(v) for k, v in batch.items()}, "batch_size": 2}
        v = jm.init(jax.random.PRNGKey(0), arrs, train=True)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

        @jax.jit
        def step(params):
            def loss_fn(p):
                out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, arrs,
                                  train=True, mutable=["batch_stats"])
                return out["losses"][loss_key], out["losses"]
            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        (_, jlosses), jgrads = step(v["params"])
        jlosses = {k: float(x) for k, x in jlosses.items()}
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    m = build_network(model, runtime, device="cpu").double()
    m.load_state_dict(detector_params_from_flax(jax.tree_util.tree_map(np.asarray, v)),
                      strict=True)
    m.train()
    out = m({**{k: T(x) for k, x in batch.items()}, "batch_size": 2})
    out["losses"][loss_key].backward()
    assert sorted(out["losses"]) == sorted(jlosses)
    for k, want in jlosses.items():
        np.testing.assert_allclose(float(out["losses"][k].detach()), want, rtol=1e-4, err_msg=k)
    assert jlosses[loss_key] > 0
    ref = detector_params_from_flax({"params": jgrads})
    gmax = max(float(r.abs().max()) for r in ref.values())
    for n, p in m.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        tol = max(1e-3 * float(ref[n].abs().max()), 1e-6 * gmax)
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=0, atol=tol, err_msg=n)
