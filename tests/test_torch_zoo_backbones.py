"""The model zoo's point backbones and VFEs against the JAX package's:
KPConvNet and the five GraphConvNet variants at
tests/test_point_backbones.py's small widths (channels (16, 32), base cell
0.4 m, 8 neighbours, 24 output channels, 256 seeded points in two samples,
the last 10 padding), DynamicVFE, PlaneFittingVFE, RepsurfDynamicVFE and
TemporalVFE, and the umbrella geometry against JAX and against that file's
NumPy oracle; the flax weights carried over by
``convert.detector_params_from_flax``.

The networks run in float64 on both sides (JAX under ``jax.enable_x64``):
VolumeConvNet whitens offsets by 1 / sqrt(eigenvalue), and PointPlaneNet
and PlaneFittingVFE take the smallest eigenvector of neighbourhoods with 3
points, whose float32 eigenvectors differ between two correct eigensolvers
by ~2e-4 (measured), amplified up to 1,000-fold by the whitening.

Tolerances: features 1e-5; each parameter's gradient within 1e-4 of that
tensor's max |g|, or within 1e-6 of the largest |g| of the network where
that is more (a bias before a batch norm has an analytic gradient of 0 and
carries only rounding); voxel coords, validity, neighbour
tables and sequence edges exactly. Budget: ~65 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import backbones_graph as jbg
from pcseqlearning_tpu.models import repsurf as jrs
from pcseqlearning_tpu.models import vfe as jvfe
from pcseqlearning_tpu.models.backbones_kpconv import KPConvNet as JKPConvNet
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import backbones_graph as tbg
from pcseqlearning_tpu_torch.models import repsurf as trs
from pcseqlearning_tpu_torch.models import vfe as tvfe
from pcseqlearning_tpu_torch.models.backbones_kpconv import KPConvNet as TKPConvNet

torch.set_num_threads(1)
T = torch.as_tensor
SMALL = dict(channels=(16, 32), base_cell=0.4, nsample=8, out_channels=24)
VFE_GEOM = dict(voxel_size=(0.4, 0.4, 0.4), point_cloud_range=(-4, -4, -1, 4, 4, 1), voxel_cap=512)


def _batch(n=256, c=2, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, 4))
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:4] = rng.rand(n, 3) * np.array([8, 8, 2]) - np.array([4, 4, 1])
    return {"point_bxyz": pts.astype(np.float32).astype(np.float64),
            "point_feat": rng.rand(n, c).astype(np.float32).astype(np.float64),
            "point_valid": np.arange(n) < n - 10}


def _state(variables, parent):
    """Flax variables of a module as the port module's state_dict (the
    converter's names under ``parent``, that prefix dropped)."""
    sd = detector_params_from_flax({coll: {parent: jax.tree_util.tree_map(np.asarray, tree)}
                                    for coll, tree in variables.items()})
    return {k.split(".", 1)[1]: t for k, t in sd.items()}


def _assert_grads(tm, ref):
    gmax = max(float(r.abs().max()) for r in ref.values())
    for name, p in tm.named_parameters():
        tol = max(1e-4 * float(ref[name].abs().max()), 1e-6 * gmax)
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=0, atol=tol,
                                   err_msg=name)


def run_both(jm, tm, batch, out_key, parent, width):
    """One train-mode forward and the gradient of sum(out * w) through both
    packages in float64; returns (port output dict, JAX output dict)."""
    w = np.random.RandomState(5).randn(batch["point_bxyz"].shape[0] if out_key.startswith(
        "point") else jm.voxel_cap, width)
    with jax.enable_x64(True):
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        v = jm.init(jax.random.PRNGKey(0), jb, train=True)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

        def f(p):
            out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jb, train=True,
                              mutable=["batch_stats"])
            return jnp.sum(out[out_key] * w), out

        (_, jout), jg = jax.value_and_grad(f, has_aux=True)(v["params"])
        jout = {k: np.asarray(x) for k, x in jout.items() if hasattr(x, "shape")}
        jg = jax.tree_util.tree_map(np.asarray, jg)
    tm.load_state_dict(_state(v, parent), strict=True)
    tm.double().train()
    out = tm({k: T(x) for k, x in batch.items()})
    (out[out_key] * T(w)).sum().backward()
    _assert_grads(tm, _state({"params": jg}, parent))
    return out, jout


def test_kpconv_net_equals_jax():
    out, jout = run_both(JKPConvNet(**SMALL), TKPConvNet(2, **SMALL), _batch(), "point_features",
                         "backbone_3d", 24)
    np.testing.assert_allclose(out["point_features"].detach().numpy(), jout["point_features"],
                               atol=1e-5)
    np.testing.assert_array_equal(out["point_coords"].numpy(), jout["point_coords"])
    assert np.abs(jout["point_features"]).sum() > 0 and np.abs(jout["point_features"][-5:]).max() == 0


@pytest.mark.parametrize("variant", tbg.VARIANTS)
def test_graph_conv_net_variants_equal_jax(variant):
    out, jout = run_both(jbg.GraphConvNet(variant=variant, **SMALL),
                         tbg.GraphConvNet(2, variant=variant, **SMALL), _batch(seed=1),
                         "point_features", "backbone_3d", 24)
    np.testing.assert_allclose(out["point_features"].detach().numpy(), jout["point_features"],
                               atol=1e-5)


def test_grid_reps_and_level_neighbours_equal_jax():
    """KPConvNet's voxel-mean representatives and each level's radius
    neighbour tables exactly (float32, as the backbones take them)."""
    from pcseqlearning_tpu.models.backbones_kpconv import _grid_reps as jreps
    from pcseqlearning_tpu.ops import hash_graph as jhg
    from pcseqlearning_tpu_torch.models.backbones_kpconv import _grid_reps as treps
    from pcseqlearning_tpu_torch.models.backbones_kpconv import level_neighbours

    b = _batch()
    pts = b["point_bxyz"].astype(np.float32)
    valid = b["point_valid"]
    bxyz = np.concatenate([np.round(pts[:, :1]), pts[:, 1:4]], 1)
    for cell in (0.4, 0.8):
        jx, jv, ji = (np.asarray(a) for a in jreps(jnp.asarray(bxyz), jnp.asarray(valid), cell))
        tx, tv, ti = treps(T(bxyz), T(valid), cell)
        np.testing.assert_allclose(tx.numpy(), jx, atol=1e-6)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(ti.numpy(), ji)
        ref = np.concatenate([bxyz[:, :1], jx], 1)
        grid = jhg.build_hash_grid(jnp.asarray(ref), 2.5 * cell, jnp.asarray(jv))
        jn, _, jm = jhg.radius_neighbors(grid, jnp.asarray(ref), 2.5 * cell, 8,
                                         query_valid=jnp.asarray(jv), cell_cap=24)
        tn, tm = level_neighbours(T(bxyz[:, 0]), T(jx.copy()), T(jv.copy()), 2.5 * cell, 8)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(np.where(tm.numpy(), tn.numpy(), -1),
                                      np.where(np.asarray(jm), np.asarray(jn), -1))


def test_volume_whiten_and_plane_features_equal_jax():
    rng = np.random.RandomState(0)
    rel = rng.randn(6, 12, 3) * np.array([1.0, 2.0, 0.3])
    mask = rng.rand(6, 12) > 0.2
    mask[0, 3:] = False  # three neighbours: a rank-2 covariance
    with jax.enable_x64(True):
        jw = np.asarray(jbg.volume_whiten(jnp.asarray(rel), jnp.asarray(mask)))
        jn, jd = (np.asarray(a) for a in jbg.plane_features(jnp.asarray(rel), jnp.asarray(mask)))
    np.testing.assert_allclose(tbg.volume_whiten(T(rel), T(mask)).numpy(), jw, atol=1e-5)
    tn, td = tbg.plane_features(T(rel), T(mask))
    np.testing.assert_allclose(tn.numpy(), jn, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-5)


@pytest.mark.parametrize("name", ["DynamicVFE", "PlaneFitting", "RepsurfDynamicVFE"])
def test_zoo_vfes_equal_jax(name):
    """The VFE in train mode: voxel coords and validity exactly, features
    1e-5, gradients (where it has parameters) as above."""
    jcls = {"DynamicVFE": jvfe.DynamicVFE, "PlaneFitting": jvfe.PlaneFittingVFE,
            "RepsurfDynamicVFE": jvfe.RepsurfDynamicVFE}[name]
    jm = jcls(**VFE_GEOM, **({"mlp_channels": (16, 24)} if name == "RepsurfDynamicVFE" else {}))
    kw = {"mlp_channels": (16, 24)} if name == "RepsurfDynamicVFE" else {}
    tm = tvfe.ZOO_VFES[name](*VFE_GEOM.values(), num_point_features=5, **kw)
    b = _batch(seed=2)
    b["point_bxyz"][:3, 1] = 9.0  # outside the range
    if name == "PlaneFitting":  # no parameters: the forward alone
        with jax.enable_x64(True):
            jb = {k: jnp.asarray(x) for k, x in b.items()}
            jout = jm.apply(jm.init(jax.random.PRNGKey(0), jb), jb)
            jout = {k: np.asarray(x) for k, x in jout.items() if hasattr(x, "shape")}
        out = tm({k: T(x) for k, x in b.items()})
        # normals up to JAX's own sign convention hold only where the fit is
        # well posed; both packages give the same eigensolver's result here
        for k in ("voxel_normals", "voxel_eigvals"):
            np.testing.assert_allclose(out[k].numpy(), jout[k], atol=1e-5, err_msg=k)
    else:
        out, jout = run_both(jm, tm, b, "voxel_features", "vfe", tm.out_channels)
    np.testing.assert_array_equal(out["voxel_coords"].numpy(), jout["voxel_coords"])
    np.testing.assert_array_equal(out["voxel_valid"].numpy(), jout["voxel_valid"])
    np.testing.assert_allclose(out["voxel_features"].detach().numpy(), jout["voxel_features"],
                               atol=1e-5)
    assert out["voxel_features"].shape[1] == tm.out_channels
    if name == "RepsurfDynamicVFE":
        np.testing.assert_allclose(out["point_repsurf"].detach().numpy(), jout["point_repsurf"],
                                   atol=1e-5)


def test_temporal_vfe_equals_jax():
    """Two sweeps of the same 32 points, the second moved 0.1 m, and a
    third sweep of 8 points; edges exactly JAX's."""
    rng = np.random.RandomState(0)
    base = rng.rand(32, 3).astype(np.float32) * 5
    pts = np.concatenate([np.concatenate([np.zeros((32, 1)), base], 1),
                          np.concatenate([np.ones((32, 1)), base + 0.1], 1),
                          np.concatenate([np.full((8, 1), 2.0), base[:8] + 0.3], 1)]
                         ).astype(np.float32)
    valid = np.ones(72, bool)
    valid[5] = False
    bd = {"point_bxyz": pts, "point_feat": np.zeros((72, 1), np.float32), "point_valid": valid}
    jm = jvfe.TemporalVFE(voxel_size=(0.1,) * 3, point_cloud_range=(0, 0, 0, 5, 5, 5), voxel_cap=64)
    jb = {k: jnp.asarray(x) for k, x in bd.items()}
    jout = jm.apply(jm.init(jax.random.PRNGKey(0), jb), jb)
    out = tvfe.TemporalVFE((0.1,) * 3, (0, 0, 0, 5, 5, 5), 64)({k: T(x) for k, x in bd.items()})
    ok = np.asarray(jout["sequence_edge_valid"])
    np.testing.assert_array_equal(out["sequence_edge_valid"].numpy(), ok)
    np.testing.assert_array_equal(out["sequence_edge_dst"].numpy()[ok],
                                  np.asarray(jout["sequence_edge_dst"])[ok])
    np.testing.assert_array_equal(out["sequence_edge_src"].numpy(),
                                  np.asarray(jout["sequence_edge_src"]))
    np.testing.assert_array_equal(out["point_xyz"].numpy(), np.asarray(jout["point_xyz"]))
    assert ok[:32].sum() == 31 and not ok[5] and (np.asarray(jout["sequence_edge_dst"])[:32][
        ok[:32]] == np.arange(32)[ok[:32]] + 32).mean() > 0.9


def _umbrella_inputs(seed=2, n=48):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(n, 3) * np.array([4, 4, 1])).astype(np.float32)
    bidx = (np.arange(n) >= 40).astype(np.int32)  # a sample of 8 points
    valid = np.arange(n) != 7
    return xyz, bidx, valid


def test_umbrella_triangles_equal_jax():
    xyz, bidx, valid = _umbrella_inputs()
    want = jrs.umbrella_triangles(jnp.asarray(xyz), jnp.asarray(bidx), jnp.asarray(valid), k=6)
    got = trs.umbrella_triangles(T(xyz), T(bidx).long(), T(valid), k=6)
    for name, g, w in zip(("normal", "centroid", "polar", "pos", "pair_ok"), got, want):
        if name == "pair_ok":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_umbrella_surface_features_equal_jax_and_numpy_oracle():
    """The raw umbrella features against JAX (1e-5) and against
    tests/test_point_backbones.py's NumPy umbrella construction (2e-3, as
    there)."""
    xyz, bidx, valid = _umbrella_inputs()
    want = np.asarray(jvfe.umbrella_surface_features(jnp.asarray(xyz), jnp.asarray(bidx),
                                                     jnp.asarray(valid), k=6))
    got = tvfe.umbrella_surface_features(T(xyz), T(bidx).long(), T(valid), k=6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    n, k = 48, 6
    rng = np.random.RandomState(2)
    xyz = rng.rand(n, 3).astype(np.float32) * np.array([4, 4, 1], np.float32)
    got = tvfe.umbrella_surface_features(T(xyz), torch.zeros(n, dtype=torch.long),
                                         torch.ones(n, dtype=torch.bool), k=k).numpy()
    D = np.linalg.norm(xyz[:, None] - xyz[None], axis=-1)
    np.fill_diagonal(D, np.inf)
    for q in range(0, n, 7):
        rel = xyz[np.argsort(D[q])[:k]] - xyz[q]
        rel = rel[np.argsort(np.arctan2(rel[:, 1], rel[:, 0]), kind="stable")]
        v0, v1 = rel, np.roll(rel, -1, axis=0)
        nrm = np.cross(v0, v1)
        unit = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        unit = unit * np.where(unit[:, 2:3] < 0, -1.0, 1.0)
        np.testing.assert_allclose(got[q, :3], unit.mean(0), atol=2e-3)
        np.testing.assert_allclose(got[q, 3:6], ((v0 + v1) / 3.0).mean(0), atol=2e-3)
        np.testing.assert_allclose(got[q, 9], (0.5 * np.linalg.norm(nrm, axis=-1)).mean(),
                                   atol=2e-3)


def test_umbrella_constructor_equals_jax():
    xyz, bidx, valid = _umbrella_inputs()
    xyz = xyz.astype(np.float64)
    jm = jrs.UmbrellaSurfaceConstructor(k=5)
    with jax.enable_x64(True):
        args = (jnp.asarray(xyz), jnp.asarray(bidx), jnp.asarray(valid))
        v = jm.init(jax.random.PRNGKey(0), *args, True)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

        def f(p):
            out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, *args, True,
                              mutable=["batch_stats"])
            return jnp.sum(out ** 2), out

        (_, jout), jg = jax.value_and_grad(f, has_aux=True)(v["params"])
        jout, jg = np.asarray(jout), jax.tree_util.tree_map(np.asarray, jg)
    tm = trs.UmbrellaSurfaceConstructor(k=5)
    tm.load_state_dict(_state(v, "umbrella"), strict=True)
    tm.double().train()
    out = tm(T(xyz), T(bidx).long(), T(valid))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-5)
    assert (out.detach().numpy()[~valid] == 0).all()
    _assert_grads(tm, _state({"params": jg}, "umbrella"))
