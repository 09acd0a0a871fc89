"""The port's sparse conv ops and dynamic voxelization against the JAX
package's, on the same seeded NumPy inputs, and against the dense-conv
oracle of tests/test_sparse_conv.py.

Tolerances: voxel tables, coordinate tables, validity and rulebooks are
exact. Features of a conv are held at 1e-5 absolute on O(1) values (float32
GEMMs in another summation order); gradients at 1e-4 as in
tests/test_sparse_conv_grad.py; the dense-conv oracle at its 1e-3 relative /
1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import grid_utils as jgu
from pcseqlearning_tpu.ops import sparse_conv as jsc
from pcseqlearning_tpu_torch.ops import grid_utils as tgu
from pcseqlearning_tpu_torch.ops import sparse_conv as tsc

# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)
T = torch.as_tensor
HI = jax.lax.Precision.HIGHEST


def _coords(rng, n_active, shape, batch):
    coords = set()
    while len(coords) < n_active:
        coords.add((rng.randint(0, batch),) + tuple(rng.randint(0, s) for s in shape))
    return np.array(sorted(coords), np.int32)


def _pair(rng, n_active=40, shape=(8, 8, 8), cin=4, batch=2, cap=64):
    """The same padded sparse tensor for both packages, plus its active
    coords and features."""
    coords = _coords(rng, n_active, shape, batch)
    feats = rng.randn(len(coords), cin).astype(np.float32)
    pad = cap - len(coords)
    cp = np.concatenate([coords, -np.ones((pad, 4), np.int32)])
    fp = np.concatenate([feats, np.zeros((pad, cin), np.float32)])
    valid = np.arange(cap) < len(coords)
    js = jsc.SparseTensor(jnp.asarray(fp), jnp.asarray(cp), jnp.asarray(valid), shape, batch)
    ts = tsc.SparseTensor(T(fp), T(cp), T(valid), shape, batch)
    return js, ts, coords, feats


def _dense_from_sparse(coords, feats, shape, batch):
    dense = np.zeros((batch,) + shape + (feats.shape[1],), np.float32)
    for c, f in zip(coords, feats):
        dense[c[0], c[1], c[2], c[3]] += f
    return dense


def _dense_conv3d(dense, w, stride=1, padding=1):
    """Direct dense conv, w [27, cin, cout] in (dz, dy, dx) product order."""
    b, D, H, W, _ = dense.shape
    pd = np.pad(dense, ((0, 0),) + ((padding, padding),) * 3 + ((0, 0),))
    oD, oH, oW = [(s + 2 * padding - 3) // stride + 1 for s in (D, H, W)]
    out = np.zeros((b, oD, oH, oW, w.shape[-1]), np.float32)
    ki = 0
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                out += pd[:, dz:dz + oD * stride:stride, dy:dy + oH * stride:stride,
                          dx:dx + oW * stride:stride] @ w[ki]
                ki += 1
    return out


# ---------------------------------------------------------------------------
# dynamic voxelization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [1024, 150], ids=["under_cap", "over_cap"])
def test_dynamic_voxelize_equals_jax(rng, cap):
    """Same voxel table (coords, valid, inverse) exactly, means to 1e-6;
    over the cap the first voxels in (b, cx, cy, cz) order are kept."""
    n = 600
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:3] = rng.rand(n, 2) * 6.0 - 3.0
    pts[:, 3] = rng.rand(n) * 1.5 - 0.5
    feats = np.concatenate([pts[:, 1:4], rng.rand(n, 1)], 1).astype(np.float32)
    args = ([0.2, 0.2, 0.2], [-3.2, -3.2, -1.0], cap)
    jc, jf, jv, ji = jax.jit(lambda p, f: jgu.dynamic_voxelize(p, f, *args))(pts, feats)
    tc, tf, tv, ti = tgu.dynamic_voxelize(T(pts), T(feats), *args)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    n_vox = int(ti.max()) + 1
    assert (n_vox > cap) == (cap == 150) and int(tv.sum()) == min(n_vox, cap)


# ---------------------------------------------------------------------------
# rulebooks and forward
# ---------------------------------------------------------------------------


def test_subm_conv_equals_jax_and_dense(rng):
    js, ts, coords, feats = _pair(rng)
    w = rng.randn(27, 4, 6).astype(np.float32) * 0.1
    jo = jsc.subm_conv3d(js, jnp.asarray(w), precision=HI)
    to = tsc.subm_conv3d(ts, T(w))
    np.testing.assert_array_equal(to.coords.numpy(), np.asarray(jo.coords))
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_allclose(to.features.numpy(), np.asarray(jo.features), atol=1e-5)
    ref = _dense_conv3d(_dense_from_sparse(coords, feats, ts.spatial_shape, 2), w)
    for i, c in enumerate(coords):
        np.testing.assert_allclose(to.features[i].numpy(), ref[tuple(c)], rtol=1e-3, atol=1e-4)
    assert not to.valid[len(coords):].any()
    np.testing.assert_array_equal(tsc.build_subm_rulebook(ts).numpy(),
                                  np.asarray(jsc.build_subm_rulebook(js)))


@pytest.mark.parametrize("ks,stride,pad,out_cap", [
    (3, 2, 1, 128), (3, 2, 1, 20), (2, 2, 0, 64), ((3, 1, 1), (2, 1, 1), 0, 64)],
    ids=["k3s2", "k3s2_truncated", "k2s2p0", "k311s211"])
def test_strided_conv_equals_jax(rng, ks, stride, pad, out_cap):
    """Coordinate table row for row (order, -1 padding, truncation at
    out_cap), validity exact, features to 1e-5."""
    js, ts, _, _ = _pair(rng)
    K = int(np.prod((ks,) * 3 if isinstance(ks, int) else ks))
    w = rng.randn(K, 4, 5).astype(np.float32) * 0.1
    jo = jsc.sparse_conv3d(js, jnp.asarray(w), kernel_size=ks, stride=stride, padding=pad,
                           out_cap=out_cap, precision=HI)
    to = tsc.sparse_conv3d(ts, T(w), kernel_size=ks, stride=stride, padding=pad,
                           out_cap=out_cap)
    assert to.spatial_shape == jo.spatial_shape
    np.testing.assert_array_equal(to.coords.numpy(), np.asarray(jo.coords))
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_allclose(to.features.numpy(), np.asarray(jo.features), atol=1e-5)


def test_strided_conv_matches_dense(rng):
    _, ts, coords, feats = _pair(rng)
    w = rng.randn(27, 4, 6).astype(np.float32) * 0.1
    out = tsc.sparse_conv3d(ts, T(w), stride=2, padding=1, out_cap=128)
    ref = _dense_conv3d(_dense_from_sparse(coords, feats, ts.spatial_shape, 2), w, stride=2)
    oc, ov, got = out.coords.numpy(), out.valid.numpy(), out.features.numpy()
    for i in np.nonzero(ov)[0]:
        np.testing.assert_allclose(got[i], ref[tuple(oc[i])], rtol=1e-3, atol=1e-4)
    active = {tuple(c) for c in oc[ov].tolist()}
    for c in np.argwhere(np.abs(ref).max(-1) > 1e-6):
        assert tuple(c) in active


def test_downsample_branches_agree(rng):
    """The dense-occupancy and the sort (unique) branches give the same
    table, also when truncated."""
    _, ts, _, _ = _pair(rng, n_active=50, shape=(6, 9, 7), batch=3, cap=96)
    for out_cap in (96, 17):
        a = tsc._downsample_coords(ts, 3, 2, 1, out_cap)
        b = tsc._downsample_coords(ts, 3, 2, 1, out_cap, dense_table_cap=0)
        for x, y in zip(a[:2], b[:2]):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_dense_table_matches_hash_lookup(rng):
    """The dense row table and the sorted-hash lookup resolve identical
    rulebooks, and equal JAX's dense lookup."""
    js, ts, _, _ = _pair(rng, n_active=50, shape=(6, 9, 7), batch=3, cap=96)
    offs = np.asarray(jsc.kernel_offsets(3)) - 1
    q = np.asarray(js.coords)[None].repeat(27, 0).astype(np.int32)
    q[..., 1:4] += offs[:, None, :]
    q = q.reshape(-1, 4)
    qv = np.broadcast_to(np.asarray(js.valid)[None], (27, 96)).reshape(-1)
    dense = tsc._lookup_coords(ts, T(q), T(qv))
    hashed = tsc._lookup_coords(ts, T(q), T(qv), dense_table_cap=0)
    np.testing.assert_array_equal(dense.numpy(), hashed.numpy())
    tab = jsc._dense_coord_table(js)
    ref = jsc._dense_lookup(tab, js.spatial_shape, js.batch_size, jnp.asarray(q),
                            jnp.asarray(qv))
    np.testing.assert_array_equal(dense.numpy(), np.asarray(ref))
    rb = tsc.build_subm_rulebook(ts, 3, dense_table_cap=0)
    np.testing.assert_array_equal(rb.numpy(), tsc.build_subm_rulebook(ts, 3).numpy())


def test_shared_rulebook_matches_fresh(rng):
    _, ts, _, _ = _pair(rng)
    w = T(rng.randn(27, 4, 6).astype(np.float32) * 0.1)
    a = tsc.subm_conv3d(ts, w)
    b = tsc.subm_conv3d(ts, w, rulebook=tsc.build_subm_rulebook(ts, 3))
    assert torch.equal(a.features, b.features)


def test_to_dense_equals_jax_and_oracle(rng):
    js, ts, coords, feats = _pair(rng)
    got = tsc.to_dense(ts).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsc.to_dense(js)))
    np.testing.assert_allclose(got, _dense_from_sparse(coords, feats, ts.spatial_shape, 2),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# gather-only backward
# ---------------------------------------------------------------------------


def _grad_pair(rng, v_cap=64, n=48, shape=(6, 7, 8), B=2, C=5):
    coords = np.stack([rng.randint(0, B, n), rng.randint(0, shape[0], n),
                       rng.randint(0, shape[1], n), rng.randint(0, shape[2], n)], 1)
    coords = np.unique(coords, axis=0)
    c_pad = np.full((v_cap, 4), -1, np.int32)
    c_pad[:len(coords)] = coords
    valid = np.arange(v_cap) < len(coords)
    feats = np.where(valid[:, None], rng.randn(v_cap, C), 0).astype(np.float32)
    return (jsc.SparseTensor(jnp.asarray(feats), jnp.asarray(c_pad), jnp.asarray(valid), shape, B),
            tsc.SparseTensor(T(feats), T(c_pad), T(valid), shape, B))


def _torch_grads(fn, feats, w, dy):
    f = feats.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    (fn(f, w) * dy).sum().backward()
    return f.grad.numpy(), w.grad.numpy()


def test_subm_grad_equals_autodiff_and_jax(rng):
    js, ts = _grad_pair(rng)
    w = rng.randn(27, 5, 6).astype(np.float32)
    dy = rng.randn(64, 6).astype(np.float32)
    idx = tsc.build_subm_rulebook(ts, 3)
    rev = tsc._mirror_rulebook(idx, 3)
    custom = _torch_grads(lambda f, w: tsc.rulebook_mm(f, idx, rev, w), ts.features, T(w), T(dy))
    plain = _torch_grads(lambda f, w: tsc._gather_mm(f, idx, w), ts.features, T(w), T(dy))
    jidx = jsc.build_subm_rulebook(js, 3)
    jrev = jsc._mirror_rulebook(jidx, 3)
    ref = jax.grad(lambda f, w: jnp.sum(jsc._rulebook_mm(f, jidx, jrev, w) * dy),
                   argnums=(0, 1))(js.features, jnp.asarray(w))
    for c, p, r in zip(custom, plain, ref):
        np.testing.assert_allclose(c, p, atol=1e-4)
        np.testing.assert_allclose(c, np.asarray(r), atol=1e-4)


@pytest.mark.parametrize("stride,pad,ks", [(2, 1, 3), (2, 0, 2), ((2, 2, 2), 1, 3)])
def test_strided_grad_equals_autodiff_and_jax(rng, stride, pad, ks):
    js, ts = _grad_pair(rng)
    K = int(np.prod((ks,) * 3 if isinstance(ks, int) else ks))
    w = rng.randn(K, 5, 4).astype(np.float32)
    dy = rng.randn(64, 4).astype(np.float32)

    def custom(f, w):
        return tsc.sparse_conv3d(ts._replace(features=f), w, kernel_size=ks, stride=stride,
                                 padding=pad).features

    # the same rulebook through autograd's (scatter) backward
    oc, ov, _ = tsc._downsample_coords(ts, ks, stride, pad, 64)
    offs = tsc.kernel_offsets(ks)
    zyx = oc[None, :, 1:4].long() * T(tsc._triple(stride)) - T(tsc._triple(pad)) + offs[:, None]
    q = torch.cat([oc[None, :, 0:1].long().expand(len(offs), 64, 1), zyx], -1).reshape(-1, 4)
    idx = tsc._lookup_coords(ts, q, ov[None].expand(len(offs), 64).reshape(-1)).reshape(-1, 64)

    def plain(f, w):
        return tsc._mask_features(tsc._gather_mm(tsc._mask_features(f, ts.valid), idx, w), ov)

    np.testing.assert_allclose(custom(ts.features, T(w)).numpy(),
                               plain(ts.features, T(w)).numpy(), atol=1e-5)
    gc = _torch_grads(custom, ts.features, T(w), T(dy))
    gp = _torch_grads(plain, ts.features, T(w), T(dy))

    def jout(f, w):
        return jsc.sparse_conv3d(js._replace(features=f), w, kernel_size=ks, stride=stride,
                                 padding=pad).features

    gj = jax.grad(lambda f, w: jnp.sum(jout(f, w) * dy), argnums=(0, 1))(js.features,
                                                                         jnp.asarray(w))
    for c, p, r in zip(gc, gp, gj):
        np.testing.assert_allclose(c, p, atol=1e-4)
        np.testing.assert_allclose(c, np.asarray(r), atol=1e-4)


def test_grid_densify_grad_equals_autodiff_and_jax(rng):
    V, C, L = 40, 6, 200
    lin = rng.choice(L, V, replace=False).astype(np.int64)
    valid = rng.rand(V) > 0.3
    feats = rng.randn(V, C).astype(np.float32)
    dy = rng.randn(L, C).astype(np.float32)

    def plain(f):
        f = torch.where(T(valid)[:, None], f, torch.zeros(()))
        return torch.zeros((L, C)).index_add(0, T(np.where(valid, lin, L - 1)), f)

    got = tsc.grid_densify(L, T(feats), T(valid), T(lin))
    np.testing.assert_allclose(got.numpy(), plain(T(feats)).numpy(), atol=1e-6)
    ref_fwd = jsc.grid_densify(L, jnp.asarray(feats), jnp.asarray(valid),
                               jnp.asarray(lin.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_fwd))
    grads = []
    for fn in (lambda f: tsc.grid_densify(L, f, T(valid), T(lin)), plain):
        f = T(feats).clone().requires_grad_(True)
        (fn(f) * T(dy)).sum().backward()
        grads.append(f.grad.numpy())
    gj = jax.grad(lambda f: jnp.sum(jsc.grid_densify(
        L, f, jnp.asarray(valid), jnp.asarray(lin.astype(np.int32))) * dy))(jnp.asarray(feats))
    np.testing.assert_allclose(grads[0], grads[1], atol=1e-6)
    np.testing.assert_allclose(grads[0], np.asarray(gj), atol=1e-6)
