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
from pcseqlearning_tpu.ops import sampling as jsampling
from pcseqlearning_tpu.parallel.train_step import _flatten_local as jflatten
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import build_network
from pcseqlearning_tpu_torch.ops import sampling as tsampling
from pcseqlearning_tpu_torch.parallel.train_step import _flatten_local
from pcseqlearning_tpu_torch.scene import (DETECTOR_CFG, bench_detector_batch,
                                           caddn_camera_y, camera_detector_batch)
from pcseqlearning_tpu_torch.utils.edict import EDict

pytestmark = pytest.mark.slow
REPO = Path(__file__).resolve().parents[1]


def _jax_cfg(d):
    return JEDict({k: _jax_cfg(v) if isinstance(v, dict) else v for k, v in d.items()})


def _flax_from_port(variables, state):
    """The flax ``variables`` whose ``detector_params_from_flax`` is the
    port's ``state`` (same tree as ``variables``): the converter only moves
    values, so converting a tree of each value's own flat position says
    where each port value goes."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    offsets = np.cumsum([0] + [np.size(leaf) for leaf in leaves])
    where = detector_params_from_flax(treedef.unflatten(
        [np.arange(o, o + np.size(leaf), dtype=np.float64).reshape(np.shape(leaf))
         for leaf, o in zip(leaves, offsets)]))
    flat = np.zeros(offsets[-1])
    for k, pos in where.items():
        flat[pos.numpy().astype(np.int64).ravel()] = state[k].double().numpy().ravel()
    return treedef.unflatten([flat[o:o + np.size(leaf)].reshape(np.shape(leaf))
                              .astype(np.asarray(leaf).dtype) for leaf, o in zip(leaves, offsets)])


def _float32_errors(model_yaml, loss_key, loss_rtol=1e-4, point_valid=True, extent=19.2,
                    n_points=20_000, image_hw=None, fixed_picks=False, port_weights=False):
    """(JAX's worst float32 gradient error, the port's), each the largest
    error over the tensor's max |g| of the port's float64 gradient, at
    phase 7(a)'s cell with flax's initial weights carried into the port;
    the losses of both float32 runs are held to the float64 ones
    (``loss_rtol``). Also prints the new batch statistics' float32 errors
    (over max(1, the buffer's largest value), as phase 10(a) reads them),
    in and outside the RoI head. ``point_valid=False`` drops the points'
    mask from the batch (the co-train's seg head cannot take it); another
    ``extent`` or ``n_points`` cuts the cell further, and ``image_hw`` adds
    ``camera_detector_batch``'s images and camera (CaDDN). ``fixed_picks``
    gives both float32 runs the FPS picks of the port's float64 run (by the
    number of picks; PointRCNN's four SA layers each ask for another), so
    that a float32 FPS that picks otherwise does not change the network's
    structure. ``port_weights`` starts both packages from the port's seeded
    weights (``build_network``'s seed 0, as chip_smoke.py builds them)
    instead of flax's."""
    cfg = cfg_from_yaml_file(str(REPO / model_yaml), EDict())
    runtime = dict(data_cfg={"POINT_CLOUD_RANGE": [-extent, -extent, -2.0, extent, extent, 4.0],
                             "VOXEL_SIZE": [0.1, 0.1, 0.15]},
                   class_names=list(cfg.CLASS_NAMES), voxel_cap=30_000)
    if image_hw is None:
        batch, camera = bench_detector_batch(2, n_points, extent - 0.5, seed=1), {}
    else:
        batch = camera_detector_batch(2, n_points, extent - 0.5, image_hw,
                                      caddn_camera_y(extent, 0.1, 30_000), seed=1)
        camera = {k: batch.pop(k) for k in ("images", "calib_K", "calib_T")}

    model = jbuild(_jax_cfg(cfg.MODEL), runtime)
    flat = jflatten(**{k: jnp.asarray(v) for k, v in batch.items()})
    flat.pop("batch_size")  # static: put back inside the jitted functions
    flat.update({k: jnp.asarray(v) for k, v in camera.items()})
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

    if port_weights:
        state = build_network(cfg.MODEL, runtime, device="cpu").state_dict()
        variables = _flax_from_port(jax.tree_util.tree_map(np.asarray, variables), state)
    state = detector_params_from_flax(jax.tree_util.tree_map(np.asarray, variables))

    def port_grads(dtype):
        m = build_network(cfg.MODEL, runtime, device="cpu")
        m.load_state_dict(state, strict=True)
        m.to(dtype).train()
        tb = _flatten_local(**{k: torch.as_tensor(v) for k, v in batch.items()})
        tb.update({k: torch.as_tensor(v) for k, v in camera.items()})
        if not point_valid:
            tb.pop("point_valid")
        bd = m(tb)
        bd["losses"][loss_key].backward()
        return ({k: float(v.detach()) for k, v in bd["losses"].items()},
                {n: p.grad.double() for n, p in m.named_parameters() if p.grad is not None},
                {n: b.double() for n, b in m.named_buffers()})

    picks = {}
    fps = (jsampling.farthest_point_sample, tsampling.farthest_point_sample)
    if fixed_picks:
        def keep(xyz, num_samples, valid=None):
            picks[num_samples] = fps[1](xyz, num_samples, valid=valid)
            return picks[num_samples]
        tsampling.farthest_point_sample = keep
    try:
        losses64, ref, stats64 = port_grads(torch.float64)
        if fixed_picks:
            jsampling.farthest_point_sample = (
                lambda xyz, num_samples, valid=None: jnp.asarray(picks[num_samples].numpy(),
                                                                 jnp.int32))
            tsampling.farthest_point_sample = (
                lambda xyz, num_samples, valid=None: picks[num_samples])
        (_, (jlosses, jstats)), jgrads = grads_of(variables["params"], variables["batch_stats"],
                                                  flat)
        losses32, port32, stats32 = port_grads(torch.float32)
    finally:
        jsampling.farthest_point_sample, tsampling.farthest_point_sample = fps
    jax32 = detector_params_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jgrads, "batch_stats": jstats}))
    print("\nfloat32 losses' relative errors against the port's float64 (JAX, port):",
          {k: (abs(float(jlosses[k]) / v - 1), abs(losses32[k] / v - 1)) for k, v in
           losses64.items() if v})
    for k, v in losses64.items():
        np.testing.assert_allclose(float(jlosses[k]), v, rtol=loss_rtol, err_msg=k)
        np.testing.assert_allclose(losses32[k], v, rtol=loss_rtol, err_msg=k)

    def err(g, n):
        """The error over the tensor's max |g| (0 where both are zero); an
        attention key bias, whose gradient is zero in exact arithmetic, over
        its block's query-bias max."""
        d = float((torch.as_tensor(np.asarray(g)).double() - ref[n]).abs().max())
        scale = float(ref[n.replace("attn.key.bias", "attn.query.bias")].abs().max())
        return d / scale if scale else (0.0 if d == 0 else float("inf"))

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


# chip_smoke.py phase 12(a)'s cell: +-6.4 m and 2 x 2,500 points (CaDDN with
# 2 x 320 x 480 images), where JAX's attention tables over 4,096 x 144
# windows and its frustum sampler over every voxel of the dense grid fit a
# CPU's memory. PointRCNN also with the float64 run's FPS picks (its float32
# FPS picks otherwise, in JAX as on the card, and every tensor downstream
# differs) from the port's seeded weights: phase 12(a)'s float32 step
_POINTRCNN = dict(loss_key="total_loss", loss_rtol=5e-3, extent=6.4, n_points=2_500)
LAST_CELLS = {"pointrcnn": ("pointrcnn", _POINTRCNN),
              "pointrcnn-fixed-picks": ("pointrcnn", dict(fixed_picks=True, port_weights=True,
                                                          **_POINTRCNN)),
              "pointrcnn-fixed-picks-point_loss": ("pointrcnn", dict(
                  _POINTRCNN, loss_key="point_loss", fixed_picks=True, port_weights=True)),
              "sst_centerpoint": ("sst_centerpoint", dict(loss_key="center_loss", extent=6.4,
                                                          n_points=2_500)),
              "caddn": ("caddn", dict(loss_key="center_loss", extent=6.4, n_points=2_500,
                                      image_hw=(320, 480)))}


@pytest.mark.parametrize("case", sorted(LAST_CELLS))
def test_last_three_float32_gradients_of_jax_and_port_against_float64(case):
    """The same for PointRCNN (total_loss; also with the float64 run's FPS
    picks), SST-CenterPoint and CaDDN
    (center_loss, its depth loss included) at phase 12(a)'s cells:
    ``chip_smoke.py`` phase 12(a) holds the card's float32 gradients to
    twice JAX's worst error printed here."""
    model, kwargs = LAST_CELLS[case]
    worst_jax, worst_port = _float32_errors(f"tools/cfgs/waymo_models/{model}.yaml", **kwargs)
    assert worst_port <= 2 * worst_jax
