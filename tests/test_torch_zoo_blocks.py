"""The graph blocks of ``models/blocks.py`` against the JAX package's, as
tests/test_blocks.py runs them (64 points, 16 features, 8 random
neighbours, 56 valid; random edge lists), in train mode with the gradients
of a seeded weighted sum; the kernel assigners and kernel positions on
that file's inputs; the flax weights carried over by
``convert.detector_params_from_flax``.

Tolerances: outputs 1e-5 (1e-4 for the attention's and the kernel message
passing's einsums over sums of 16-point products); each parameter's
gradient within 1e-4 of that tensor's max |g|, or within 1e-6 of the
largest |g| of the block where that is more (the attention's key bias and
a bias before a batch norm have an analytic gradient of 0 and carry only
rounding); assigner indices, kernel positions and the FPS picks of
``compute_ball_positions`` exactly. Budget: ~20 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import blocks as jb
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import blocks as tb

torch.set_num_threads(1)
T = torch.as_tensor


def _graph(rng, n=64, k=8):
    feats = rng.randn(n, 16).astype(np.float32)
    xyz = rng.rand(n, 3).astype(np.float32)
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3
    mask[3] = False  # a point with no neighbour
    valid = np.arange(n) < 56
    return feats, xyz, idx, mask, valid


def _state(variables):
    sd = detector_params_from_flax({coll: {"head": jax.tree_util.tree_map(np.asarray, tree)}
                                    for coll, tree in variables.items()})
    return {k.split(".", 1)[1]: t for k, t in sd.items()}


def _check(jm, tm, args, targs, atol=1e-5, train=False):
    """Forward (``train``: train mode, for a block with a batch norm) and
    the gradients of sum(out * w) against JAX."""
    kw = {"train": True} if train else {}
    v = jm.init(jax.random.PRNGKey(0), *args, **kw)
    out_shape = jax.eval_shape(lambda: jm.apply(v, *args, **kw, mutable=["batch_stats"])[0])
    w = np.random.RandomState(7).randn(*out_shape.shape).astype(np.float32)

    def f(p):
        out, _ = jm.apply({**v, "params": p}, *args, **kw, mutable=["batch_stats"])
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(f, has_aux=True)(v["params"])
    tm.load_state_dict(_state(v), strict=True)
    tm.train(train)
    out = tm(*targs)
    (out * T(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=atol)
    ref = _state({"params": jg})
    gmax = max(float(r.abs().max()) for r in ref.values())
    for name, p in tm.named_parameters():
        tol = max(1e-4 * float(ref[name].abs().max()), 1e-6 * gmax)
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=0, atol=tol,
                                   err_msg=name)
    return out


def test_edge_conv_equals_jax(rng):
    feats, xyz, idx, mask, valid = _graph(rng)
    out = _check(jb.EdgeConvBlock(out_channels=32, mlp=(16,)), tb.EdgeConvBlock(16, 32, mlp=(16,)),
                 [jnp.asarray(a) for a in (feats, idx, mask, valid)],
                 [T(a) for a in (feats, idx, mask, valid)], train=True)
    assert np.abs(out.detach().numpy()[~valid]).max() == 0 and not out[3].any()


@pytest.mark.parametrize("aggregate", ["mean", "sum", "max"])
def test_message_passing_equals_jax(rng, aggregate):
    feats, xyz, _, _, _ = _graph(rng)
    e_src = rng.randint(0, 64, 256).astype(np.int32)
    e_dst = rng.randint(0, 64, 256).astype(np.int32)
    e_mask = rng.rand(256) > 0.2
    args = (feats, feats, xyz, xyz, e_src, e_dst, e_mask)
    _check(jb.MessagePassingBlock(out_channels=24, aggregate=aggregate),
           tb.MessagePassingBlock(16, 16, 24, aggregate=aggregate),
           [jnp.asarray(a) for a in args], [T(a) for a in args], train=True)


def test_graph_attention_equals_jax(rng):
    feats, xyz, idx, mask, valid = _graph(rng)
    out = _check(jb.GraphAttentionBlock(out_channels=32, num_heads=4),
                 tb.GraphAttentionBlock(16, 32, num_heads=4),
                 [jnp.asarray(a) for a in (feats, idx, mask, valid)],
                 [T(a) for a in (feats, idx, mask, valid)], atol=1e-4, train=True)
    assert not out[3].any()


def test_kpconv_block_equals_jax(rng):
    feats, xyz, idx, mask, valid = _graph(rng)
    args = (feats, xyz, idx, mask, valid)
    _check(jb.KPConvBlock(out_channels=32, num_kernel_points=9, sigma=0.5),
           tb.KPConvBlock(16, 32, num_kernel_points=9, sigma=0.5),
           [jnp.asarray(a) for a in args], [T(a) for a in args], train=True)


def test_kernel_message_passing_and_grid_conv_equal_jax(rng):
    """KernelMessagePassing against JAX and the per-edge oracle of
    tests/test_blocks.py; GridConvBlock over grid_assigner's kernels."""
    N, M, E, K, cin, cout = 40, 24, 300, 9, 8, 12
    feats = rng.randn(N, cin).astype(np.float32)
    e_ref = rng.randint(0, N, E).astype(np.int32)
    e_query = rng.randint(0, M, E).astype(np.int32)
    e_kernel = rng.randint(0, K, E).astype(np.int32)
    e_mask = rng.rand(E) > 0.25
    e_weight = rng.rand(E).astype(np.float32)
    jargs = [jnp.asarray(feats), jnp.asarray(e_kernel), jnp.asarray(e_ref), jnp.asarray(e_query),
             M, jnp.asarray(e_mask), jnp.asarray(e_weight)]
    targs = [T(feats), T(e_kernel).long(), T(e_ref).long(), T(e_query).long(), M, T(e_mask),
             T(e_weight)]
    tm = tb.KernelMessagePassing(cin, cout, num_kernels=K)
    out = _check(jb.KernelMessagePassing(out_channels=cout, num_kernels=K), tm, jargs, targs,
                 atol=1e-4)
    w = tm.kernel_weights.detach().numpy()
    want = np.zeros((M, cout), np.float32)
    for e in range(E):
        if e_mask[e]:
            want[e_query[e]] += (feats[e_ref[e]] * e_weight[e]) @ w[e_kernel[e]]
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4)

    rel = rng.randint(-1, 2, (E, 3)).astype(np.int32)
    kern = tb.grid_assigner(T(rel))
    q_valid = np.arange(M) < 20
    jargs = [jnp.asarray(feats), jb.grid_assigner(jnp.asarray(rel)), jnp.asarray(e_ref),
             jnp.asarray(e_query), M, jnp.asarray(e_mask), jnp.asarray(q_valid)]
    targs = [T(feats), kern, T(e_ref).long(), T(e_query).long(), M, T(e_mask), T(q_valid)]
    out = _check(jb.GridConvBlock(out_channels=16), tb.GridConvBlock(cin, 16), jargs, targs,
                 atol=1e-4, train=True)
    assert np.abs(out.detach().numpy()[20:]).max() == 0


def test_assigners_and_positions_equal_jax(rng):
    E = 200
    rel_c = rng.randint(-1, 2, (E, 3)).astype(np.int32)
    rel_x = ((rng.rand(E, 3) - 0.5) * 0.4).astype(np.float32)
    rel_x[:5, 0] = 0.1  # exactly at the half-voxel band's edge
    hv = np.asarray([0.1, 0.1, 0.05], np.float32)
    np.testing.assert_array_equal(tb.grid_assigner(T(rel_c)).numpy(),
                                  np.asarray(jb.grid_assigner(jnp.asarray(rel_c))))
    np.testing.assert_array_equal(tb.grid3x3_assigner(T(rel_x), hv).numpy(),
                                  np.asarray(jb.grid3x3_assigner(jnp.asarray(rel_x), hv)))
    kp = jb.compute_conv3d_positions([0.2, 0.2, 0.1])
    np.testing.assert_array_equal(tb.compute_conv3d_positions([0.2, 0.2, 0.1]).numpy(),
                                  np.asarray(kp))
    np.testing.assert_array_equal(tb.geometric_assigner(T(rel_x), T(np.array(kp))).numpy(),
                                  np.asarray(jb.geometric_assigner(jnp.asarray(rel_x), kp)))
    vm = rng.rand(64) > 0.5
    e_q = rng.randint(0, 64, E).astype(np.int32)
    got = tb.grid_volume_assigner(T(rel_c), T(vm), T(e_q).long()).numpy()
    np.testing.assert_array_equal(got, np.asarray(jb.grid_volume_assigner(
        jnp.asarray(rel_c), jnp.asarray(vm), jnp.asarray(e_q))))
    assert got.max() < 54 and set(tb.ASSIGNERS) == set(jb.ASSIGNERS)
    for k in (9, 15):
        np.testing.assert_array_equal(tb.compute_ball_positions(k, radius=0.9).numpy(),
                                      np.asarray(jb.compute_ball_positions(k, radius=0.9)))
    blk = jb.KPConvBlock(out_channels=4, num_kernel_points=15, sigma=0.3)
    pts = blk.bind({}).kernel_pts if hasattr(blk, "bind") else None
    np.testing.assert_allclose(tb.kernel_points(15, 0.3).numpy(), np.asarray(pts), atol=0)
