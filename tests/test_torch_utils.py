"""The port's utilities against the JAX package's: the ``common_utils``
dict and rotation helpers on NumPy arrays and on tensors (JAX arrays
there), ``profiler``'s spans and trace, and ``flops.analytic_flops``
(counted at dispatch) against JAX's jaxpr walk: tests/test_flops.py's five
cases (JAX's scan as a Python loop here), convolutions at stride 1 and 2
with their gradients, a transposed convolution, and CenterPoint's train
step at tests/test_torch_detector.py's toy cell with the flax weights
carried over by ``convert.py``.

Tolerances: none for the counts and the dict helpers; 1e-6 for the
rotations (float32; JAX's HIGHEST-precision matmul against torch's).
"""

import json
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcseqlearning_tpu.utils import common_utils as jcu
from pcseqlearning_tpu.utils.flops import analytic_flops as jflops
from pcseqlearning_tpu_torch.utils import common_utils as tcu
from pcseqlearning_tpu_torch.utils import profiler
from pcseqlearning_tpu_torch.utils.flops import AnalyticFlopCounter, analytic_flops

torch.set_num_threads(1)
T = torch.as_tensor


def _dict(rng):
    return {"a": rng.rand(6, 3).astype(np.float32), "b": rng.randint(0, 9, 6),
            "s": rng.rand(), "name": "x", "m": rng.rand(6, 2, 2).astype(np.float32)}


def _as_numpy(d):
    return {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in d.items()}


def _assert_dicts_equal(a, b, dtypes=True):
    """Equal keys and values; equal dtypes too where both hold NumPy arrays
    (JAX keeps 32-bit integers where torch keeps 64-bit ones)."""
    assert a.keys() == b.keys()
    for k in a:
        if hasattr(a[k], "shape"):
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert (x.dtype == y.dtype or not dtypes) and np.array_equal(x, y), k
        else:
            assert a[k] == b[k], k


def test_dict_helpers_equal_jax():
    rng = np.random.RandomState(0)
    d1, d2 = _dict(rng), _dict(rng)
    mask, idx = rng.rand(6) > 0.4, np.array([4, 0, 2])
    cases = [
        (jcu.apply_to_dict(d1, lambda v: v * 2), tcu.apply_to_dict(d1, lambda v: v * 2)),
        (jcu.filter_dict(d1, mask), tcu.filter_dict(d1, mask)),
        (jcu.filter_dict(d1, idx), tcu.filter_dict(d1, idx)),
        (jcu.concat_dicts([d1, d2]), tcu.concat_dicts([d1, d2])),
        (jcu.stack_dicts([d1, d2], axis=1), tcu.stack_dicts([d1, d2], axis=1)),
    ]
    for ref, got in cases:
        _assert_dicts_equal(ref, got)
    assert jcu.concat_dicts([]) == tcu.concat_dicts([]) == {}
    cfg = {"A": [1, 2, 3], "B": "keep", "C": [[0], [1]]}
    assert tcu.indexing_list_elements(cfg, 1) == jcu.indexing_list_elements(cfg, 1)

    # tensors where JAX takes its arrays: the joins come back as tensors
    jd = [{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in d.items()}
          for d in (d1, d2)]
    td = [{k: T(v) if isinstance(v, np.ndarray) else v for k, v in d.items()}
          for d in (d1, d2)]
    for jfn, tfn in ((jcu.concat_dicts, tcu.concat_dicts), (jcu.stack_dicts, tcu.stack_dicts)):
        ref, got = jfn(jd), tfn(td)
        assert all(torch.is_tensor(got[k]) for k in ("a", "b", "m"))
        _assert_dicts_equal(_as_numpy(ref), _as_numpy({k: v.numpy() if torch.is_tensor(v)
                                                       else v for k, v in got.items()}), False)
    _assert_dicts_equal(_as_numpy(jcu.filter_dict(jd[0], jnp.asarray(mask))),
                        _as_numpy({k: v.numpy() if torch.is_tensor(v) else v
                                   for k, v in tcu.filter_dict(td[0], T(mask)).items()}), False)


def test_rotate_points_along_z_equals_jax():
    rng = np.random.RandomState(1)
    pts = rng.randn(3, 50, 5).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 3).astype(np.float32)
    np.testing.assert_array_equal(tcu.rotate_points_along_z(pts, ang),
                                  jcu.rotate_points_along_z(pts, ang))
    np.testing.assert_array_equal(tcu.rotate_points_along_z(pts[0], 0.4),
                                  jcu.rotate_points_along_z(pts[0], 0.4))
    got = tcu.rotate_points_along_z(T(pts), T(ang))
    ref = jcu.rotate_points_along_z(jnp.asarray(pts), jnp.asarray(ang))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    got1 = tcu.rotate_points_along_z(T(pts[1]), float(ang[1]))
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref)[1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got1[:, 2:].numpy(), pts[1][:, 2:])


def test_stage_timer_timer_and_trace(tmp_path):
    """The spans' own timing (a nested span's time counts in its parent's
    duration, not in its parent's self time) and the trace, which shows the
    spans."""
    profiler.reset()
    with profiler.span("off"):
        pass
    assert profiler.read() == {}
    was = profiler.enable(True)
    try:
        for _ in range(2):
            with profiler.span("stage"):
                with profiler.span("stage.inner"):
                    time.sleep(0.002)
    finally:
        profiler.enable(was)
    table = profiler.read(reset=True)
    outer, inner = table["stage"], table["stage.inner"]
    assert outer["calls"] == inner["calls"] == 2 and inner["host_ms"] >= 4.0
    assert outer["parent"] is None and inner["parent"] == "stage"
    assert outer["self_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"])
    assert profiler.read() == {}
    with profiler.device_trace(tmp_path / "trace") as prof:
        with profiler.span("port.region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "port.region" for e in events)
    profiler.reset()
    with profiler.device_trace(tmp_path / "off", enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def _flax_params(kernel_shape):
    """A flax conv's variables (tracing the count needs no init)."""
    return {"params": {"kernel": jnp.zeros(kernel_shape), "bias": jnp.zeros(kernel_shape[-1])}}


def test_flops_cases_of_test_flops_equal_jax():
    # matmul
    assert analytic_flops(torch.matmul, torch.zeros(32, 64), torch.zeros(64, 16)) == jflops(
        jnp.matmul, jnp.zeros((32, 64)), jnp.zeros((64, 16))) == 2 * 32 * 64 * 16
    # batched dot
    assert analytic_flops(torch.bmm, torch.zeros(4, 8, 16), torch.zeros(4, 16, 32)) == jflops(
        lambda x, y: jax.lax.batch_matmul(x, y), jnp.zeros((4, 8, 16)),
        jnp.zeros((4, 16, 32))) == 2 * 4 * 8 * 16 * 32
    # a 3x3 SAME convolution with bias (the bias add is not counted)
    x = jnp.zeros((2, 10, 10, 8))
    m = nn.Conv(12, (3, 3), padding="SAME")
    params = _flax_params((3, 3, 8, 12))
    conv = torch.nn.Conv2d(8, 12, 3, padding=1)
    assert analytic_flops(conv, torch.zeros(2, 8, 10, 10)) == jflops(
        lambda p, x: m.apply(p, x), params, x) == 2 * (2 * 10 * 10 * 12) * 8 * 9

    # scan over 27 weights: a Python loop here
    def scan_f(x):
        def body(c, wk):
            return c + x @ wk, None
        return jax.lax.scan(body, jnp.zeros((5, 16)), jnp.zeros((27, 8, 16)))[0]

    def loop_f(x, w):
        out = torch.zeros(5, 16)
        for k in range(27):
            out = out + x @ w[k]
        return out

    assert analytic_flops(loop_f, torch.zeros(5, 8), torch.zeros(27, 8, 16)) == jflops(
        scan_f, jnp.zeros((5, 8))) == 27 * 2 * 5 * 8 * 16

    # a gradient counts the backward's two products
    def loss(a, b):
        return jnp.sum((a @ b) ** 2)

    a, b = torch.zeros(16, 24, requires_grad=True), torch.zeros(24, 8, requires_grad=True)
    got = analytic_flops(lambda: ((a @ b) ** 2).sum().backward())
    ref = jflops(lambda a, b: jax.grad(loss, argnums=(0, 1))(a, b), jnp.zeros((16, 24)),
                 jnp.zeros((24, 8)))
    assert got == ref == 3 * 2 * 16 * 24 * 8


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("input_grad", [True, False])
def test_conv_gradient_flops_equal_jax(stride, input_grad):
    """XLA counts a convolution's input gradient as the lhs-dilated
    convolution at the input's resolution: at stride 2, 4x the forward,
    where torch's FlopCounterMode counts the forward again."""
    from torch.utils.flop_counter import FlopCounterMode

    x = jnp.zeros((2, 16, 16, 8))
    m = nn.Conv(12, (3, 3), strides=stride, padding="SAME")
    params = _flax_params((3, 3, 8, 12))
    argnums = (0, 1) if input_grad else 0
    ref = jflops(lambda p, x: jax.grad(lambda p, x: jnp.sum(m.apply(p, x) ** 2),
                                       argnums=argnums)(p, x), params, x)
    conv = torch.nn.Conv2d(8, 12, 3, stride=stride, padding=1)
    xt = torch.zeros(2, 8, 16, 16, requires_grad=input_grad)

    def step():
        (conv(xt) ** 2).sum().backward()

    fwd = 2 * (2 * (16 // stride) ** 2 * 12) * 8 * 9
    assert analytic_flops(step) == ref == fwd * (2 + stride ** 2 * input_grad)
    with FlopCounterMode(display=False) as counter:
        step()
    assert counter.get_total_flops() == fwd * (2 + input_grad)


def test_transposed_conv_flops_equal_jax():
    x = jnp.zeros((2, 8, 8, 8))
    m = nn.ConvTranspose(12, (2, 2), strides=(2, 2), padding="VALID")
    params = _flax_params((2, 2, 8, 12))
    ref = jflops(lambda p, x: jax.grad(lambda p, x: jnp.sum(m.apply(p, x) ** 2),
                                       argnums=(0, 1))(p, x), params, x)
    deconv = torch.nn.ConvTranspose2d(8, 12, 2, stride=2)
    xt = torch.zeros(2, 8, 8, 8, requires_grad=True)
    assert analytic_flops(lambda: (deconv(xt) ** 2).sum().backward()) == ref


def test_centerpoint_train_step_flops_equal_jax():
    """The port's count of one train step equals JAX's jaxpr count of its
    step but for one product: JAX's custom VJP of the first sparse conv
    (4 -> 16 channels, 27 offsets, the 1,024-row voxel table) also computes
    the input features' gradient, which nothing uses (the VFE has no
    parameters); the port's backward computes only the gradients autograd
    asks for. No loop of the step holds a product, so JAX's one-body charge
    of a while loop does not enter."""
    from pcseqlearning_tpu.models.detectors import build_detector as jbuild
    from pcseqlearning_tpu.parallel import train_step as jts
    from pcseqlearning_tpu.parallel.mesh import make_mesh
    from pcseqlearning_tpu_torch.convert import detector_params_from_flax
    from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild
    from pcseqlearning_tpu_torch.parallel import train_step as tts
    from test_torch_detector import RUNTIME, centerpoint_cfg
    from test_torch_train_step import dense_batch

    model = jbuild(centerpoint_cfg(), RUNTIME)
    tx = optax.adam(1e-3)
    batch = dense_batch()
    state = jts.init_train_state(model, tx, batch)
    step = jts.make_train_step(model, tx, make_mesh(jax.devices()[:1], dp=1),
                               loss_key="center_loss")
    ref = jflops(step, state, {k: jnp.asarray(v) for k, v in batch.items()})

    init = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                               "batch_stats": state.batch_stats})
    port = tbuild(centerpoint_cfg(), RUNTIME, device="cpu")
    port.load_state_dict(detector_params_from_flax(init), strict=True)
    with AnalyticFlopCounter() as counter:
        tts.make_train_step(loss_key="center_loss", device="cpu")(
            tts.init_train_state(port, device="cpu"), batch)
    unused_input_grad = 2 * RUNTIME["voxel_cap"] * 27 * 16 * 4
    assert counter.total == ref - unused_input_grad
    assert counter.by_op["convolution"] > 0 and counter.by_op["convolution_backward"] > 0
