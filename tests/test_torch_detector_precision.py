"""How far float32 gradients (and batch statistics) of the full-width
CenterPoint (and Voxel R-CNN, PartA2 and the PV-RCNN family) are from
float64 ones, in the JAX package and in the port, at ``chip_smoke.py``
phase 7(a)'s cell: centerpoint.yaml's (voxel_rcnn.yaml's, ...) MODEL, +-19.2 m, 2 x 20,000 points from
``scene.bench_detector_batch(seed=1)``, a 30,000-voxel cap, flax's initial
weights (PRNGKey(0)) carried into the port.

The reference is the port's float64 backward (network in float64 on the
float32 voxel table, as in phase 7(a)). The test prints, for every conv
kernel, the largest error of JAX's float32 gradient and of the port's over
the tensor's max |g|, and holds the port's float32 backward to no more
than twice JAX's worst error: at these widths float32 itself is that far
from float64, in both packages. Slow (a full-width JAX compile; ~40 s on
8 cores):

    python -m pytest tests/test_torch_detector_precision.py -m slow -s -q
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.parallel.train_step import _flatten_local as jflatten
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import build_network
from pcseqlearning_tpu_torch.parallel.train_step import _flatten_local
from pcseqlearning_tpu_torch.scene import DETECTOR_CFG, bench_detector_batch
from pcseqlearning_tpu_torch.utils.edict import EDict

pytestmark = pytest.mark.slow
REPO = Path(__file__).resolve().parents[1]


def _jax_cfg(d):
    return JEDict({k: _jax_cfg(v) if isinstance(v, dict) else v for k, v in d.items()})


def _float32_errors(model_yaml, loss_key, loss_rtol=1e-4, point_valid=True):
    """(JAX's worst float32 gradient error, the port's), each the largest
    error over the tensor's max |g| of the port's float64 gradient, at
    phase 7(a)'s cell with flax's initial weights carried into the port;
    the losses of both float32 runs are held to the float64 ones
    (``loss_rtol``). Also prints the new batch statistics' float32 errors
    (over max(1, the buffer's largest value), as phase 10(a) reads them),
    in and outside the RoI head. ``point_valid=False`` drops the points'
    mask from the batch (the co-train's seg head cannot take it)."""
    cfg = cfg_from_yaml_file(str(REPO / model_yaml), EDict())
    runtime = dict(data_cfg={"POINT_CLOUD_RANGE": [-19.2, -19.2, -2.0, 19.2, 19.2, 4.0],
                             "VOXEL_SIZE": [0.1, 0.1, 0.15]},
                   class_names=list(cfg.CLASS_NAMES), voxel_cap=30_000)
    batch = bench_detector_batch(2, 20_000, 18.7, seed=1)

    model = jbuild(_jax_cfg(cfg.MODEL), runtime)
    flat = jflatten(**{k: jnp.asarray(v) for k, v in batch.items()})
    flat.pop("batch_size")  # static: put back inside the jitted functions
    if not point_valid:
        flat.pop("point_valid")
    variables = jax.jit(lambda key, b: model.init(key, {**b, "batch_size": 2}, train=True))(
        jax.random.PRNGKey(0), flat)

    @jax.jit
    def grads_of(params, stats, b):
        def loss_fn(p):
            out, new = model.apply({"params": p, "batch_stats": stats}, {**b, "batch_size": 2},
                                   train=True, mutable=["batch_stats"])
            return out["losses"][loss_key], (out["losses"], new["batch_stats"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (jlosses, jstats)), jgrads = grads_of(variables["params"], variables["batch_stats"], flat)
    jax32 = detector_params_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jgrads, "batch_stats": jstats}))
    state = detector_params_from_flax(jax.tree_util.tree_map(np.asarray, variables))

    def port_grads(dtype):
        m = build_network(cfg.MODEL, runtime, device="cpu")
        m.load_state_dict(state, strict=True)
        m.to(dtype).train()
        tb = _flatten_local(**{k: torch.as_tensor(v) for k, v in batch.items()})
        if not point_valid:
            tb.pop("point_valid")
        bd = m(tb)
        bd["losses"][loss_key].backward()
        return ({k: float(v.detach()) for k, v in bd["losses"].items()},
                {n: p.grad.double() for n, p in m.named_parameters() if p.grad is not None},
                {n: b.double() for n, b in m.named_buffers()})

    losses64, ref, stats64 = port_grads(torch.float64)
    losses32, port32, stats32 = port_grads(torch.float32)
    print("\nfloat32 losses' relative errors against the port's float64 (JAX, port):",
          {k: (abs(float(jlosses[k]) / v - 1), abs(losses32[k] / v - 1)) for k, v in
           losses64.items() if v})
    for k, v in losses64.items():
        np.testing.assert_allclose(float(jlosses[k]), v, rtol=loss_rtol, err_msg=k)
        np.testing.assert_allclose(losses32[k], v, rtol=loss_rtol, err_msg=k)

    def err(g, n):
        return float((torch.as_tensor(np.asarray(g)).double() - ref[n]).abs().max()
                     / ref[n].abs().max())

    errs = {n: (err(jax32[n], n), err(port32[n], n)) for n in ref}
    print("\nfloat32 gradient error of the tensor's max |g| against the port's float64 "
          "(JAX, port), kernels in forward order:")
    for n, (e_jax, e_port) in errs.items():
        if n.endswith("weight") and "bn" not in n and "norm" not in n:
            print(f"{n.rsplit('.', 1)[0]:36s} {e_jax:.3e} {e_port:.3e}")
    worst_jax, worst_port = (max(e[i] for e in errs.values()) for i in (0, 1))
    print(f"worst: JAX {worst_jax:.3e} ({max(errs, key=lambda n: errs[n][0])}), "
          f"port {worst_port:.3e} ({max(errs, key=lambda n: errs[n][1])})")
    outside = [n for n in ref if not n.startswith("roi_head.")]
    print("worst outside the RoI head: JAX {:.3e}, port {:.3e}".format(
        *(max(errs[n][i] for n in outside) for i in (0, 1))))

    def stat_err(v, n):
        return float((torch.as_tensor(np.asarray(v)).double() - stats64[n]).abs().max()
                     / max(1.0, float(stats64[n].abs().max())))

    stat_errs = {n: (stat_err(jax32[n], n), stat_err(stats32[n], n)) for n in stats64
                 if n in jax32}  # not the anchor head's anchors: no flax statistic
    for part, names in (("the RoI head", [n for n in stat_errs if n.startswith("roi_head.")]),
                        ("the rest", [n for n in stat_errs if not n.startswith("roi_head.")])):
        if names:
            print(f"batch statistics' float32 error over max(1, |v|), {part}: JAX "
                  + ", port ".join(f"{max(stat_errs[n][i] for n in names):.3e}" for i in (0, 1)))
    return worst_jax, worst_port


def test_float32_gradients_of_jax_and_port_against_float64():
    worst_jax, worst_port = _float32_errors(DETECTOR_CFG, "center_loss")
    assert worst_port <= 2 * worst_jax


@pytest.mark.parametrize("loss_key", ["center_loss", "total_loss"])
def test_voxel_rcnn_float32_gradients_of_jax_and_port_against_float64(loss_key):
    """The same for voxel_rcnn.yaml's MODEL, differentiating its first
    stage's loss (center_loss) or total_loss (the RoI stage included): its
    RoI losses in float32 are some 3e-4 from float64 (JAX's rcnn_loss_cls
    3.1e-4), so the losses are held to 1e-3 here, and its RoI head's
    float32 gradients are further from float64 than CenterPoint's, in JAX
    as in the port."""
    worst_jax, worst_port = _float32_errors("tools/cfgs/waymo_models/voxel_rcnn.yaml",
                                            loss_key, loss_rtol=1e-3)
    assert worst_port <= 2 * worst_jax


@pytest.mark.parametrize("model", ["part_a2", "pv_rcnn", "pv_rcnn_plusplus",
                                   "pv_rcnn_plusplus_cotrain"])
def test_pv_family_float32_gradients_of_jax_and_port_against_float64(model):
    """The same for PartA2 and the PV-RCNN family, differentiating
    total_loss (the co-train on the batch without ``point_valid``):
    ``chip_smoke.py`` phase 11(a) holds the card's float32 gradients to
    JAX's worst error printed here. Losses held to 5e-3: JAX's float32
    rcnn_loss_cls of PartA2 lies 1.2e-3 from float64 (the port's 1.3e-4)."""
    worst_jax, worst_port = _float32_errors(f"tools/cfgs/waymo_models/{model}.yaml",
                                            "total_loss", loss_rtol=5e-3,
                                            point_valid="cotrain" not in model)
    assert worst_port <= 2 * worst_jax
