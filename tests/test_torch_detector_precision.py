"""How far float32 gradients of the full-width CenterPoint are from float64
ones, in the JAX package and in the port, at ``chip_smoke.py`` phase
7(a)'s cell: centerpoint.yaml's MODEL, +-19.2 m, 2 x 20,000 points from
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


def test_float32_gradients_of_jax_and_port_against_float64():
    cfg = cfg_from_yaml_file(str(REPO / DETECTOR_CFG), EDict())
    runtime = dict(data_cfg={"POINT_CLOUD_RANGE": [-19.2, -19.2, -2.0, 19.2, 19.2, 4.0],
                             "VOXEL_SIZE": [0.1, 0.1, 0.15]},
                   class_names=list(cfg.CLASS_NAMES), voxel_cap=30_000)
    batch = bench_detector_batch(2, 20_000, 18.7, seed=1)

    model = jbuild(_jax_cfg(cfg.MODEL), runtime)
    flat = jflatten(**{k: jnp.asarray(v) for k, v in batch.items()})
    flat.pop("batch_size")  # static: put back inside the jitted functions
    variables = jax.jit(lambda key, b: model.init(key, {**b, "batch_size": 2}, train=True))(
        jax.random.PRNGKey(0), flat)

    @jax.jit
    def grads_of(params, stats, b):
        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, {**b, "batch_size": 2},
                                 train=True, mutable=["batch_stats"])
            return out["losses"]["center_loss"], out["losses"]
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, jlosses), jgrads = grads_of(variables["params"], variables["batch_stats"], flat)
    jax32 = detector_params_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    state = detector_params_from_flax(jax.tree_util.tree_map(np.asarray, variables))

    def port_grads(dtype):
        m = build_network(cfg.MODEL, runtime, device="cpu")
        m.load_state_dict(state, strict=True)
        m.to(dtype).train()
        bd = m.vfe(_flatten_local(**{k: torch.as_tensor(v) for k, v in batch.items()}))
        bd = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
              for k, v in bd.items()}
        for module in (m.backbone_3d, m.map_to_bev, m.backbone_2d, m.dense_head):
            bd = module(bd)
        losses = m.dense_head.loss(bd)
        losses["center_loss"].backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: p.grad.double() for n, p in m.named_parameters()})

    losses64, ref = port_grads(torch.float64)
    losses32, port32 = port_grads(torch.float32)
    for k, v in losses64.items():
        np.testing.assert_allclose(float(jlosses[k]), v, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(losses32[k], v, rtol=1e-4, err_msg=k)

    def err(g, n):
        return float((torch.as_tensor(np.asarray(g)).double() - ref[n]).abs().max()
                     / ref[n].abs().max())

    errs = {n: (err(jax32[n], n), err(port32[n], n)) for n in ref}
    print("\nfloat32 gradient error of the tensor's max |g| against the port's float64 "
          "(JAX, port), conv kernels in forward order:")
    for n, (e_jax, e_port) in errs.items():
        if n.endswith("weight") and "bn" not in n:
            print(f"{n.rsplit('.', 1)[0]:36s} {e_jax:.3e} {e_port:.3e}")
    worst_jax, worst_port = (max(e[i] for e in errs.values()) for i in (0, 1))
    print(f"worst: JAX {worst_jax:.3e} ({max(errs, key=lambda n: errs[n][0])}), "
          f"port {worst_port:.3e} ({max(errs, key=lambda n: errs[n][1])})")
    assert worst_port <= 2 * worst_jax
