"""The port's inverse sparse conv, sparse max pooling, UNetV2 and
PointSegHead against the JAX package's, on the same seeded NumPy inputs,
the flax weights carried over by ``convert.detector_params_from_flax``.

Tolerances: coordinate tables and masks exact; the inverse conv's features
1e-5 absolute on O(1) values and its gradients 1e-4 of each tensor's max
|g| (float32 GEMMs in another order); the max pool's output exact and its
gradient at ties equal to JAX's (each tie halves it, offset by offset);
UNetV2's and PointSegHead's outputs 1e-4 of max |value|, their gradients 1e-3
of max |g| and the new batch statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import backbones_unet as jbu
from pcseqlearning_tpu.ops import sparse_conv as jsc
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import backbones_unet as tbu
from pcseqlearning_tpu_torch.ops import sparse_conv as tsc

torch.set_num_threads(1)
T = torch.as_tensor


def _coords(rng, n_active, shape, batch):
    coords = set()
    while len(coords) < n_active:
        coords.add((rng.randint(0, batch),) + tuple(rng.randint(0, s) for s in shape))
    return np.array(sorted(coords), np.int32)


def _pair(rng, n_active=60, shape=(9, 10, 11), cin=4, batch=2, cap=80, feats=None):
    """The same padded sparse tensor for both packages."""
    coords = _coords(rng, n_active, shape, batch)
    f = rng.randn(len(coords), cin).astype(np.float32) if feats is None else feats(len(coords))
    cp = np.concatenate([coords, -np.ones((cap - len(coords), 4), np.int32)])
    fp = np.concatenate([f, np.zeros((cap - len(coords), cin), np.float32)])
    valid = np.arange(cap) < len(coords)
    return (jsc.SparseTensor(jnp.asarray(fp), jnp.asarray(cp), jnp.asarray(valid), shape, batch),
            tsc.SparseTensor(T(fp), T(cp), T(valid), shape, batch))


def _close_of_max(got, want, frac, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=frac * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


@pytest.mark.parametrize("ks,stride,pad", [(3, 2, 1), (2, 2, 0), ((3, 3, 1), (2, 2, 1), (1, 1, 0))])
def test_inverse_conv_equals_jax(rng, ks, stride, pad):
    """A strided conv down (JAX's output coords, fed to both), then the
    inverse conv back onto the fine coords: features, and the gradients of
    <out, dy> for the coarse features and the weights (the port's through
    its reverse rulebook, JAX's through its custom VJP)."""
    jfine, tfine = _pair(rng)
    K = int(np.prod((ks,) * 3 if isinstance(ks, int) else ks))
    jcoarse = jsc.sparse_conv3d(jfine, jnp.asarray(rng.randn(K, 4, 5).astype(np.float32)),
                                kernel_size=ks, stride=stride, padding=pad, out_cap=64)
    tcoarse = tsc.SparseTensor(T(np.array(jcoarse.features)), T(np.array(jcoarse.coords)),
                               T(np.array(jcoarse.valid)), jcoarse.spatial_shape, 2)
    w = rng.randn(K, 5, 3).astype(np.float32)
    dy = rng.randn(80, 3).astype(np.float32)

    def jloss(f, w):
        o = jsc.sparse_inverse_conv3d(jcoarse._replace(features=f), jfine, w, kernel_size=ks,
                                      stride=stride, padding=pad)
        return jnp.sum(o.features * dy), o

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jcoarse.features, jnp.asarray(w))
    f = tcoarse.features.clone().requires_grad_(True)
    wt = T(w).clone().requires_grad_(True)
    out = tsc.sparse_inverse_conv3d(tcoarse._replace(features=f), tfine, wt, kernel_size=ks,
                                    stride=stride, padding=pad)
    (out.features * T(dy)).sum().backward()
    np.testing.assert_array_equal(out.coords.numpy(), np.asarray(jout.coords))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
    assert np.abs(out.features.detach().numpy()).max() > 0
    np.testing.assert_allclose(out.features.detach().numpy(), np.asarray(jout.features),
                               atol=1e-5)
    _close_of_max(f.grad.numpy(), jgrads[0], 1e-4, "dfeats")
    _close_of_max(wt.grad.numpy(), jgrads[1], 1e-4, "dweights")


def test_inverse_conv_floor_division_on_negative_offsets():
    """A coarse voxel at 0 with padding 1 reaches the fine coords -1 .. 1;
    the fine voxel at 0 reads offsets where (0 + 1 - k) is -1, 0, 1: only
    k = 1 divides (floor remainder), so only offset 1 contributes, as in
    JAX."""
    shape = (4, 4, 4)
    jf = jsc.SparseTensor(jnp.zeros((1, 1)), jnp.asarray([[0, 0, 0, 0]], jnp.int32),
                          jnp.asarray([True]), shape, 1)
    jc = jsc.SparseTensor(jnp.ones((1, 1)), jnp.asarray([[0, 0, 0, 0]], jnp.int32),
                          jnp.asarray([True]), (2, 2, 2), 1)
    w = np.arange(27, dtype=np.float32).reshape(27, 1, 1)
    want = np.asarray(jsc.sparse_inverse_conv3d(jc, jf, jnp.asarray(w)).features)
    tf = tsc.SparseTensor(torch.zeros(1, 1), T([[0, 0, 0, 0]]), T([True]), shape, 1)
    tc = tsc.SparseTensor(torch.ones(1, 1), T([[0, 0, 0, 0]]), T([True]), (2, 2, 2), 1)
    got = tsc.sparse_inverse_conv3d(tc, tf, T(w)).features.numpy()
    assert got[0, 0] == want[0, 0] == 13.0  # offset (1, 1, 1)


def test_sparse_maxpool_equals_jax_with_ties(rng):
    """Features drawn from {0, 1, 2}, so maxima tie across offsets: the
    output equals JAX's exactly, and so does the gradient of the output's
    sum, which each tie halves in turn along the offsets (so entries that
    are not whole numbers show the ties)."""
    js, ts = _pair(rng, n_active=70, feats=lambda n: rng.randint(0, 3, (n, 4)).astype(np.float32))
    dy = np.ones((80, 4), np.float32)

    def jloss(f):
        o = jsc.sparse_maxpool3d(js._replace(features=f), out_cap=80)
        return jnp.sum(o.features * dy), o

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(js.features)
    f = ts.features.clone().requires_grad_(True)
    out = tsc.sparse_maxpool3d(ts._replace(features=f), out_cap=80)
    (out.features * T(dy)).sum().backward()
    np.testing.assert_array_equal(out.coords.numpy(), np.asarray(jout.coords))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
    np.testing.assert_array_equal(out.features.detach().numpy(), np.asarray(jout.features))
    jg = np.asarray(jg)
    split = int((jg != np.round(jg)).sum())
    print("gradient entries split by ties", split, "of", int((jg != 0).sum()), "nonzero")
    assert split > 0
    np.testing.assert_array_equal(f.grad.numpy(), jg)


def _unet_batch(rng, grid=(16, 14, 10), n=300, cap=400, cin=4):
    """Voxel tables on a (W, H, D) grid: coords (b, z, y, x) with z < D + 1."""
    W, H, D = grid
    coords = _coords(rng, n, (D + 1, H, W), 2)
    feats = rng.randn(n, cin).astype(np.float32)
    cp = np.concatenate([coords, -np.ones((cap - n, 4), np.int32)])
    fp = np.concatenate([feats, np.zeros((cap - n, cin), np.float32)])
    return dict(voxel_features=fp, voxel_coords=cp, voxel_valid=np.arange(cap) < n,
                batch_size=2)


def _under(name, variables):
    """The converter's keys for a module that sits at the top of its own
    flax tree, through the name it has in a detector."""
    sd = detector_params_from_flax({c: {name: v} for c, v in variables.items()})
    return {k[len(name) + 1:]: v for k, v in sd.items()}


def test_unet_v2_equals_jax():
    """UNetV2 (channels (16, 16, 32, 64, 64) as the config's, caps V, V / 2,
    V / 4) in training mode: the decoder's output, x_conv4 (the BEV input),
    the gradients of <decoder out, dy> + <x_conv4, dy4> for every kernel and
    batch-norm parameter and the input features, and the new batch
    statistics of every block, encoder and decoder."""
    rng = np.random.RandomState(1)
    grid, cap = (16, 14, 10), 400
    b = _unet_batch(rng, grid, cap=cap)
    jm = jbu.UNetV2(input_channels=4, grid_size=grid)
    jb = {k: jnp.asarray(v) if k != "batch_size" else v for k, v in b.items()}
    variables = jax.jit(lambda key: jm.init(key, dict(jb), train=True))(jax.random.PRNGKey(0))
    dy = rng.randn(cap, 16).astype(np.float32)
    dy4 = rng.randn(cap // 4, 64).astype(np.float32)

    def jloss(params, feats):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            dict(jb, voxel_features=feats), train=True, mutable=["batch_stats"])
        loss = (jnp.sum(out["voxel_point_features"] * dy)
                + jnp.sum(out["encoded_spconv_tensor"].features * dy4))
        return loss, (out["voxel_point_features"], out["encoded_spconv_tensor"], mut)

    (_, (jfeat, jx4, mut)), (jgp, jgf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables["params"], jb["voxel_features"])
    tm = tbu.UNetV2(4, grid, cap)
    tm.load_state_dict(_under("backbone_3d", variables), strict=True)
    tm.train()
    f = T(b["voxel_features"]).clone().requires_grad_(True)
    out = tm(dict({k: T(v) if k != "batch_size" else v for k, v in b.items()},
                  voxel_features=f))
    ((out["voxel_point_features"] * T(dy)).sum()
     + (out["encoded_spconv_tensor"].features * T(dy4)).sum()).backward()
    assert out["encoded_spconv_tensor_stride"] == 8
    np.testing.assert_array_equal(out["encoded_spconv_tensor"].coords.numpy(),
                                  np.asarray(jx4.coords))
    _close_of_max(out["voxel_point_features"].detach().numpy(), jfeat, 1e-4, "decoder out")
    _close_of_max(out["encoded_spconv_tensor"].features.detach().numpy(), jx4.features, 1e-4,
                  "x_conv4")
    _close_of_max(f.grad.numpy(), jgf, 1e-3, "d input")
    ref = _under("backbone_3d", {"params": jgp})
    for n, p in tm.named_parameters():
        _close_of_max(p.grad.numpy(), ref[n], 1e-3, n)
    stats = _under("backbone_3d", {"batch_stats": mut["batch_stats"]})
    sd = tm.state_dict()
    assert {k for k in stats if k.startswith(("up", "merge"))}  # the decoder's, too
    for k, r in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_point_seg_head_equals_jax(rng, train):
    """PointSegHead over a padded voxel table: logits (train and eval
    mode), and in training the cross-entropy loss (labels -1 ignored,
    labels past the classes clipped) and its gradients."""
    n, c, nc = 50, 16, 5
    x = rng.randn(n, c).astype(np.float32)
    valid = rng.rand(n) > 0.2
    labels = rng.randint(-1, nc + 2, n)
    jm = jbu.PointSegHead(num_classes=nc)
    jb = {"voxel_point_features": jnp.asarray(x), "voxel_valid": jnp.asarray(valid)}
    variables = jm.init(jax.random.PRNGKey(1), dict(jb), train=True)
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda v: v + 0.3, variables["batch_stats"])}  # eval mode reads these

    def jloss(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, dict(jb),
                          train=train, mutable=["batch_stats"])
        return jbu.PointSegHead.loss(out, jnp.asarray(labels), jnp.asarray(valid)), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    tm = tbu.PointSegHead(c, nc)
    tm.load_state_dict(_under("seg_head", variables), strict=True)
    tm.train(train)
    out = tm({"voxel_point_features": T(x), "voxel_valid": T(valid)})
    loss = tbu.PointSegHead.loss(out, T(labels), T(valid))
    loss.backward()
    _close_of_max(out["seg_logits"].detach().numpy(), jout["seg_logits"], 1e-5, "logits")
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    ref = _under("seg_head", {"params": jg})
    for n_, p in tm.named_parameters():
        _close_of_max(p.grad.numpy(), ref[n_], 1e-3, n_)
