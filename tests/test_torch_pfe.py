"""The port's keypoint branch against the JAX package's, on the same seeded
NumPy inputs, the flax weights carried over by
``convert.detector_params_from_flax``: farthest point sampling (also
against a NumPy oracle, in float32 and float64), SAGroup, vector pooling
(also against tests/test_vector_pool.py's NumPy oracle),
VectorPoolAggregation, VoxelSetAbstraction with both aggregations,
PVRCNNHead, and the co-train's PointHeadSimple with its loss.

Tolerances: FPS picks exact; outputs 1e-5 of max |value| (1e-5 absolute
for vector_pool_bin); gradients 1e-3 of each tensor's max |g|; new batch
statistics 1e-5; losses 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import backbones_point as jbp
from pcseqlearning_tpu.models import pfe as jpfe
from pcseqlearning_tpu.models import roi_heads as jrh
from pcseqlearning_tpu.ops import sampling as jsamp
from pcseqlearning_tpu.ops import sparse_conv as jsc
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import backbones_point as tbp
from pcseqlearning_tpu_torch.models import pfe as tpfe
from pcseqlearning_tpu_torch.models import roi_heads as trh
from pcseqlearning_tpu_torch.ops import sampling as tsamp
from pcseqlearning_tpu_torch.ops import sparse_conv as tsc

torch.set_num_threads(1)
T = torch.as_tensor
PCR = (-3.2, -3.2, -1.0, 3.2, 3.2, 2.2)
VOXEL = (0.2, 0.2, 0.2)


def _close_of_max(got, want, frac, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=frac * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _under(name, variables):
    """The converter's keys for a module at the top of its own flax tree,
    through the name it has in a detector."""
    sd = detector_params_from_flax({c: {name: v} for c, v in variables.items()})
    return {k[len(name) + 1:]: v for k, v in sd.items()}


def _shift_stats(variables):
    """Running statistics moved off their initial values (means -0.1,
    variances x 0.8), so that eval mode reads them."""
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: v - 0.1 if p[-1].key == "mean" else v * 0.8, variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _check_module(tm, name, variables, jgrads, jstats, tol_grad=1e-3):
    ref = _under(name, {"params": jgrads})
    for n, p in tm.named_parameters():
        assert p.grad is not None or not ref[n].any(), n
        if p.grad is not None:
            _close_of_max(p.grad.numpy(), ref[n], tol_grad, n)
    if jstats is not None:
        sd = tm.state_dict()
        for k, r in _under(name, {"batch_stats": jstats}).items():
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# farthest point sampling
# ---------------------------------------------------------------------------


def _fps_oracle(xyz, s, valid):
    """The JAX function's loop in NumPy, in xyz's dtype."""
    inf = np.array(np.inf, xyz.dtype)
    dist = np.where(valid, inf, -inf)
    picks = [int(np.argmax(valid))]
    for _ in range(1, s):
        d = xyz - xyz[picks[-1]]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        dist = np.minimum(dist, np.where(valid, d2, -inf))
        picks.append(int(np.argmax(dist)))
    return np.array(picks)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["masked", "fewer_valid", "none_valid", "all_valid"])
def test_fps_picks_exact(rng, dtype, case):
    """Picks equal the NumPy oracle's in the input's dtype, and in float32
    JAX's; with fewer valid points than S they repeat; with none, 0."""
    n, s = 700, 96
    xyz = (rng.rand(n, 3) * [40, 40, 4] - [20, 20, 2]).astype(dtype)
    valid = {"masked": rng.rand(n) > 0.4, "fewer_valid": rng.rand(n) < 0.1,
             "none_valid": np.zeros(n, bool), "all_valid": np.ones(n, bool)}[case]
    got = tsamp.farthest_point_sample(T(xyz), s, T(valid)).numpy()
    np.testing.assert_array_equal(got, _fps_oracle(xyz, s, valid))
    if dtype == np.float32:
        want = np.asarray(jsamp.farthest_point_sample(jnp.asarray(xyz), s,
                                                      valid=jnp.asarray(valid)))
        np.testing.assert_array_equal(got, want)
    if case == "fewer_valid":
        assert len(set(got)) == valid.sum() and valid[got].all()
    if case == "none_valid":
        assert not got.any()


def test_batched_fps_equals_per_row(rng):
    """The batched loop over a [B, N] table (one shared point table, a mask
    a row, as the keypoint branch runs it) equals each row's own FPS and
    JAX's vmap."""
    n, s = 500, 64
    xyz = (rng.rand(n, 3) * 10).astype(np.float32)
    masks = np.stack([rng.rand(n) > 0.5, rng.rand(n) > 0.95, rng.rand(n) > 0.1])
    got = tsamp.batched_farthest_point_sample(T(xyz), s, T(masks)).numpy()
    want = np.asarray(jsamp.batched_farthest_point_sample(
        jnp.broadcast_to(jnp.asarray(xyz), (3, n, 3)), s, valid=jnp.asarray(masks)))
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b], tsamp.farthest_point_sample(T(xyz), s, T(masks[b])).numpy())


# ---------------------------------------------------------------------------
# SA group and vector pooling
# ---------------------------------------------------------------------------


def _group_inputs(rng, nk=40, ns=400, c=5):
    """Keys and sources in two samples over 4 x 4 x 1 m: some sources not
    valid, some keys far from every source."""
    src = (rng.rand(ns, 3) * [4, 4, 1]).astype(np.float32)
    keys = (rng.rand(nk, 3) * [5, 5, 1]).astype(np.float32)
    return dict(key_xyz=keys, key_batch=rng.randint(0, 2, nk).astype(np.int32), src_xyz=src,
                src_batch=rng.randint(0, 2, ns).astype(np.int32),
                src_feats=rng.randn(ns, c).astype(np.float32), src_valid=rng.rand(ns) > 0.2)


def _run_group(jm, tm, name, inputs, train, rng):
    """The module on both sides: outputs, gradients of <out, dy> for the
    parameters and the source features, new batch statistics."""
    names = ("key_xyz", "key_batch", "src_xyz", "src_batch", "src_feats", "src_valid")
    args = [jnp.asarray(inputs[k]) for k in names]
    variables = _shift_stats(jm.init(jax.random.PRNGKey(0), *args, train=True))

    def jloss(params, feats, dy):
        a = list(args)
        a[4] = feats
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, *a,
                            train=train, mutable=["batch_stats"])
        return jnp.sum(out * dy), (out, mut)

    tm.load_state_dict(_under(name, variables), strict=True)
    tm.train(train)
    feats = T(inputs["src_feats"]).clone().requires_grad_(True)
    out = tm(*[T(inputs[k]) for k in names[:4]], feats, T(inputs["src_valid"]))
    dy = rng.randn(*out.shape).astype(np.float32)
    (_, (jout, mut)), (jgp, jgf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(
        variables["params"], args[4], jnp.asarray(dy))
    (out * T(dy)).sum().backward()
    _close_of_max(out.detach().numpy(), jout, 1e-5, "out")
    _close_of_max(feats.grad.numpy(), jgf, 1e-3, "d src_feats")
    _check_module(tm, name, variables, jgp, mut["batch_stats"] if train else None)
    return np.asarray(jout)


@pytest.mark.parametrize("train", [True, False])
def test_sa_group_equals_jax(rng, train):
    inputs = _group_inputs(rng)
    out = _run_group(jpfe.SAGroup(0.8, 16, (16, 8)), tpfe.SAGroup(5, 0.8, 16, (16, 8)), "sa_raw",
                     inputs, train, rng)
    assert (out == 0).all(axis=1).any() and not (out == 0).all()  # keys with no neighbour


def _vector_pool_oracle(rel, feats, mask, nv, d):
    """tests/test_vector_pool.py's NumPy oracle."""
    M, K, C = feats.shape
    nx, ny, nz = nv
    V = nx * ny * nz
    cell_size = 2 * d / np.array([nx, ny, nz])
    pooled, occ = np.zeros((M, V, 3 + C)), np.zeros((M, V), bool)
    for m in range(M):
        sums, cnts = np.zeros((V, 3 + C)), np.zeros(V)
        for k in range(K):
            if not mask[m, k] or np.any(np.abs(rel[m, k]) >= d):
                continue
            cell = np.clip(((rel[m, k] + d) / cell_size).astype(int), 0, [nx - 1, ny - 1, nz - 1])
            v = (cell[0] * ny + cell[1]) * nz + cell[2]
            sums[v] += np.concatenate([rel[m, k], feats[m, k]])
            cnts[v] += 1
        occ[m] = cnts > 0
        pooled[m] = np.where(occ[m][:, None], sums / np.maximum(cnts, 1)[:, None], 0)
    return pooled, occ


@pytest.mark.parametrize("nv", [(3, 3, 3), (2, 3, 4)])
def test_vector_pool_bin_equals_jax_and_oracle(rng, nv):
    M, K, C, d = 6, 24, 4, 1.2
    rel = (rng.rand(M, K, 3) * 3.2 - 1.6).astype(np.float32)
    feats = rng.rand(M, K, C).astype(np.float32)
    mask = rng.rand(M, K) > 0.2
    pooled, occ = tpfe.vector_pool_bin(T(rel), T(feats), T(mask), nv, d)
    jp, jo = jpfe.vector_pool_bin(jnp.asarray(rel), jnp.asarray(feats), jnp.asarray(mask), nv, d)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jp), atol=1e-5)
    op, oo = _vector_pool_oracle(rel, feats, mask, nv, d)
    np.testing.assert_array_equal(occ.numpy(), oo)
    np.testing.assert_allclose(pooled.numpy(), op, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_vector_pool_aggregation_equals_jax(rng, train):
    inputs = _group_inputs(rng)
    jm = jpfe.VectorPoolAggregation(max_neighbor_distance=0.6, neighbor_nsample=16,
                                    post_mlps=(16, 8))
    tm = tpfe.VectorPoolAggregation(5, max_neighbor_distance=0.6, neighbor_nsample=16,
                                    post_mlps=(16, 8))
    out = _run_group(jm, tm, "vp_raw", inputs, train, rng)
    assert not (out == 0).all()


# ---------------------------------------------------------------------------
# VoxelSetAbstraction, PVRCNNHead, PointHeadSimple
# ---------------------------------------------------------------------------


def _sparse(rng, n, shape, c, cap):
    coords = set()
    while len(coords) < n:
        coords.add((rng.randint(0, 2),) + tuple(rng.randint(0, s) for s in shape))
    coords = np.array(sorted(coords), np.int32)
    cp = np.concatenate([coords, -np.ones((cap - n, 4), np.int32)])
    fp = np.concatenate([rng.randn(n, c), np.zeros((cap - n, c))]).astype(np.float32)
    return fp, cp, np.arange(cap) < n, shape


def _vsa_batch(rng, n=600, c3=8, c4=12, cb=6):
    """Points of two samples over the toy range (a tenth not valid), the
    x_conv3 (stride 4) and x_conv4 (stride 8) tables and a 4 x 4 BEV map."""
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:3] = rng.rand(n, 2) * 6.2 - 3.1
    pts[:, 3] = rng.rand(n) * 2 - 0.8
    return dict(point_bxyz=pts, point_feat=rng.rand(n, 1).astype(np.float32),
                point_valid=rng.rand(n) > 0.1, x_conv3=_sparse(rng, 60, (5, 8, 8), c3, 80),
                x_conv4=_sparse(rng, 20, (3, 4, 4), c4, 40),
                bev=rng.randn(2, 4, 4, cb).astype(np.float32))


@pytest.mark.parametrize("aggregation", ["sa", "vector_pool"])
@pytest.mark.parametrize("train", [True, False])
def test_voxel_set_abstraction_equals_jax(rng, aggregation, train):
    """32 FPS keypoints a sample, the three groups and the bilinear BEV
    samples, concatenated, linear, batch norm and ReLU: keypoints exact,
    features, gradients of <features, dy> for the parameters, both voxel
    tables' features and the BEV map, and the new batch statistics."""
    b = _vsa_batch(rng)
    k = 32
    jm = jpfe.VoxelSetAbstraction(voxel_size=VOXEL, point_cloud_range=PCR, num_keypoints=k,
                                  aggregation=aggregation)
    tm = tpfe.VoxelSetAbstraction(VOXEL, PCR, num_keypoints=k,
                                  source_channels={"x_conv3": 8, "x_conv4": 12}, raw_channels=1,
                                  bev_channels=6, aggregation=aggregation)
    dy = rng.randn(2 * k, 128).astype(np.float32)

    def jbatch(f3, f4, bev):
        ms = {name: jsc.SparseTensor(f, jnp.asarray(b[name][1]), jnp.asarray(b[name][2]),
                                     b[name][3], 2)
              for name, f in (("x_conv3", f3), ("x_conv4", f4))}
        return {"point_bxyz": jnp.asarray(b["point_bxyz"]),
                "point_feat": jnp.asarray(b["point_feat"]),
                "point_valid": jnp.asarray(b["point_valid"]), "batch_size": 2,
                "multi_scale_3d_features": ms, "spatial_features": bev,
                "spatial_features_stride": 8}

    jin = (jnp.asarray(b["x_conv3"][0]), jnp.asarray(b["x_conv4"][0]), jnp.asarray(b["bev"]))
    variables = _shift_stats(jax.jit(lambda key: jm.init(key, jbatch(*jin), train=True))(
        jax.random.PRNGKey(0)))

    def jloss(params, f3, f4, bev):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jbatch(f3, f4, bev), train=train, mutable=["batch_stats"])
        return jnp.sum(out["point_features"] * dy), (out["point_features"], out["point_coords"],
                                                     mut)

    (_, (jfeat, jcoords, mut)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(variables["params"], *jin)
    tm.load_state_dict(_under("pfe", variables), strict=True)
    tm.train(train)
    f3, f4 = (T(b[n][0]).clone().requires_grad_(True) for n in ("x_conv3", "x_conv4"))
    bev = T(b["bev"]).permute(0, 3, 1, 2).clone().requires_grad_(True)
    ms = {n: tsc.SparseTensor(f, T(b[n][1]), T(b[n][2]), b[n][3], 2)
          for n, f in (("x_conv3", f3), ("x_conv4", f4))}
    out = tm({"point_bxyz": T(b["point_bxyz"]), "point_feat": T(b["point_feat"]),
              "point_valid": T(b["point_valid"]), "batch_size": 2,
              "multi_scale_3d_features": ms, "spatial_features": bev,
              "spatial_features_stride": 8})
    (out["point_features"] * T(dy)).sum().backward()
    np.testing.assert_array_equal(out["point_coords"].numpy(), np.asarray(jcoords))
    _close_of_max(out["point_features"].detach().numpy(), jfeat, 1e-5, "features")
    for got, want, what in ((f3.grad, jg[1], "d x_conv3"), (f4.grad, jg[2], "d x_conv4"),
                            (bev.grad.permute(0, 2, 3, 1), jg[3], "d bev")):
        assert np.abs(np.asarray(want)).max() > 0, what
        _close_of_max(got.numpy(), want, 1e-3, what)
    _check_module(tm, "pfe", variables, jg[0], mut["batch_stats"] if train else None)


@pytest.mark.parametrize("train", [True, False])
def test_pvrcnn_head_equals_jax(rng, train):
    """PVRCNNHead on a 3^3 grid over 48 keypoints of two samples: class and
    box outputs, gradients of <cls, a> + <reg, c> for the parameters, the
    keypoint features and the RoIs (through the grid points), and the new
    batch statistics."""
    nk, r = 48, 10
    kp = np.concatenate([rng.randint(0, 2, (nk, 1)), rng.rand(nk, 3) * [4, 4, 1]],
                        axis=1).astype(np.float32)
    kf = rng.randn(nk, 16).astype(np.float32)
    rois = np.concatenate([rng.rand(r, 3) * [4, 4, 1], rng.rand(r, 3) + 1.0,
                           rng.rand(r, 1) * 6 - 3], axis=1).astype(np.float32)
    rv, rb = rng.rand(r) > 0.2, rng.randint(0, 2, r).astype(np.int32)
    a, c = rng.randn(r).astype(np.float32), rng.randn(r, 7).astype(np.float32)
    jm = jrh.PVRCNNHead(grid_size=3)

    def jb(f):
        return {"point_coords": jnp.asarray(kp), "point_features": f, "roi_batch": jnp.asarray(rb)}

    variables = _shift_stats(jm.init(jax.random.PRNGKey(0), jb(jnp.asarray(kf)), jnp.asarray(rois),
                                     jnp.asarray(rv), train=True))

    def jloss(params, f, ro):
        (cls, reg), mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jb(f), ro, jnp.asarray(rv), train=train,
                                   mutable=["batch_stats"])
        return jnp.sum(cls * a) + jnp.sum(reg * c), (cls, reg, mut)

    (_, (jcls, jreg, mut)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                            has_aux=True))(
        variables["params"], jnp.asarray(kf), jnp.asarray(rois))
    tm = trh.PVRCNNHead(16, grid_size=3)
    tm.load_state_dict(_under("roi_head", variables), strict=True)
    tm.train(train)
    f, ro = T(kf).clone().requires_grad_(True), T(rois).clone().requires_grad_(True)
    cls, reg = tm({"point_coords": T(kp), "point_features": f, "roi_batch": T(rb).long()}, ro,
                  T(rv))
    ((cls * T(a)).sum() + (reg * T(c)).sum()).backward()
    _close_of_max(cls.detach().numpy(), jcls, 1e-5, "cls")
    _close_of_max(reg.detach().numpy(), jreg, 1e-5, "reg")
    for got, want, what in ((f.grad, jg[1], "d keypoint features"), (ro.grad, jg[2], "d rois")):
        assert np.abs(np.asarray(want)).max() > 0, what
        _close_of_max(got.numpy(), want, 1e-3, what)
    _check_module(tm, "roi_head", variables, jg[0], mut["batch_stats"] if train else None)


@pytest.mark.parametrize("train", [True, False])
def test_point_head_simple_and_loss_equal_jax(rng, train):
    """PointHeadSimple over 64 keypoints of two samples (no ``point_valid``,
    as the co-train's forward needs): logits; the focal loss against
    points-in-boxes targets (GT of class 0 ignored, each keypoint only its
    own sample's boxes) and its gradients; the new batch statistics."""
    m = 64
    coords = np.concatenate([np.repeat([0.0, 1.0], m // 2)[:, None],
                             rng.rand(m, 3) * [6, 6, 2] - [3, 3, 0.5]], axis=1).astype(np.float32)
    x = rng.randn(m, 32).astype(np.float32)
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, 0] = [0, 0, 0.5, 4, 4, 2, 0.3, 1]
    gt[0, 1] = [1, 1, 0.5, 3, 3, 2, 0.0, 2]
    gt[1, 2] = [-1, -1, 0.5, 3, 3, 2, 0.0, 0]
    jm = jbp.PointHeadSimple(num_classes=3)
    jb = {"point_features": jnp.asarray(x), "point_coords": jnp.asarray(coords)}
    variables = _shift_stats(jm.init(jax.random.PRNGKey(0), dict(jb), train=True))

    def jloss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            dict(jb), train=train, mutable=["batch_stats"])
        return jbp.PointHeadSimple.loss(out, jnp.asarray(gt)), (out["point_cls_preds"], mut)

    (jl, (jlogits, mut)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tm = tbp.PointHeadSimple(32, 3)
    tm.load_state_dict(_under("seg_head", variables), strict=True)
    tm.train(train)
    out = tm({"point_features": T(x), "point_coords": T(coords)})
    loss = tbp.PointHeadSimple.loss(out, T(gt))
    loss.backward()
    _close_of_max(out["point_cls_preds"].detach().numpy(), jlogits, 1e-5, "logits")
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _check_module(tm, "seg_head", variables, jg, mut["batch_stats"] if train else None)
