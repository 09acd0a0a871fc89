"""The port's CaDDN against the JAX package's: LID depth bins (at the bin
edges, in float32), the lidar depth map, the frustum sampler, ImageVFE
(evaluated only on the voxel table's kept rows, at a grid where the cap
cuts and at one where it pads), the depth loss, ``grid_densify`` with
duplicate cells (CaDDN's dense voxel table puts nz voxels on each BEV
cell), and the whole model (ImageVFE, PointPillarScatter, BaseBEVBackbone,
CenterHead at stride 1) with the flax weights carried over by
``convert.detector_params_from_flax``.

The whole model runs at tests/test_caddn_cotrain.py's toy (2 x 48 x 64
images, a 16 x 16 x 4 grid a sample, cap 2,048) with the camera 3 m behind
the grid (calib_T's z translation), so that every voxel lies beyond the
nearest depth bin. At the toy's identity calibration every voxel is
nearer than that and its LID coordinate is NaN: JAX's gradients of the
image encoder and of its feature and depth heads are then NaN (XLA converts
the NaN bin to int 0, so the depth gather is taken), and so are the
port's, in the same tensors (held below).

Tolerances: losses 1e-4 relative; each parameter's gradient within 1e-3 of
that tensor's max |g|; the new batch statistics 1e-5; predict's valid mask
exact, the valid rows' boxes 1e-4 and scores 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import vfe as jvfe
from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.ops import sparse_conv as jsc
from pcseqlearning_tpu.utils.edict import EDict
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import build_network
from pcseqlearning_tpu_torch.models import vfe as tvfe
from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild
from pcseqlearning_tpu_torch.ops import sparse_conv as tsc

torch.set_num_threads(1)
T = torch.as_tensor
REPO = Path(__file__).resolve().parent.parent

RUNTIME = dict(data_cfg={"POINT_CLOUD_RANGE": [-3.2, -3.2, -0.8, 3.2, 3.2, 0.8],
                         "VOXEL_SIZE": [0.4, 0.4, 0.4]},
               class_names=["Vehicle"], voxel_cap=2048)
CFG = EDict(NAME="CaDDN", VFE={"NAME": "ImageVFE"}, MAP_TO_BEV={"NAME": "PointPillarScatter"},
            BACKBONE_2D={"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                         "NUM_FILTERS": [16], "UPSAMPLE_STRIDES": [1],
                         "NUM_UPSAMPLE_FILTERS": [16]},
            DENSE_HEAD={"NAME": "CenterHead", "FEATURE_MAP_STRIDE": 1})


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def toy_batch(tz=3.0, seed=0):
    rng = np.random.RandomState(seed)
    b = 2
    K = np.broadcast_to(np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]], np.float32),
                        (b, 3, 3)).copy()
    Tm = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy()
    Tm[:, 2, 3] = tz
    pts = np.zeros((64, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, 64)
    pts[:, 1:3] = rng.rand(64, 2) * 4 - 2
    pts[:, 3] = rng.rand(64) * 1.2 - 0.6
    gt = np.zeros((b, 2, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.1, 1.5, 1.5, 0.8, 0.3, 1]
    gt[1, 1] = [-1.2, 0.4, 0.0, 1.8, 0.9, 0.8, -0.5, 1]
    return {"images": rng.rand(b, 48, 64, 3).astype(np.float32), "calib_K": K, "calib_T": Tm,
            "point_bxyz": pts, "point_feat": np.zeros((64, 1), np.float32), "gt_boxes": gt,
            "gt_boxes2d": np.array([[[8.0, 8.0, 30.0, 24.0]], [[20.0, 4.0, 60.0, 40.0]]],
                                   np.float32)}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _lid_numpy(depths, dmin, dmax, d):
    """bin_depths_lid's continuous coordinate in NumPy float32, one rounding
    per operation in the function's order (NumPy's sqrt rounds to
    nearest)."""
    f32 = np.float32
    size = f32(2 * (dmax - dmin) / (d * (1 + d)))
    with np.errstate(invalid="ignore"):
        return f32(-0.5) + f32(0.5) * np.sqrt(f32(1) + (f32(8) * (depths - f32(dmin))) / size)


def test_bin_depths_lid_at_bin_edges_equals_jax():
    """Depths at every bin edge of the config's binning (2-60 m, 16 bins)
    and the float32 neighbours on either side, out of range, 0 and inf: the
    continuous coordinate and the target bin (the floor decides it, so the
    division is by a tensor) bit for bit equal to a NumPy float32 reference
    and to JAX. The square root is rounded to nearest: torch's CPU float32
    sqrt is not on every host (on an AMD EPYC, torch 2.13, it put 8 of
    these 58 coordinates one ulp off JAX's)."""
    dmin, dmax, d = 2.0, 60.0, 16
    size = 2 * (dmax - dmin) / (d * (1 + d))
    edges = (dmin + size * (((2 * np.arange(d + 1) + 1.0) ** 2) - 1) / 8).astype(np.float32)
    depths = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                             np.nextafter(edges, np.float32(100)),
                             np.array([0.0, -1.0, 1.9, 59.99, 60.0, 61.0, np.inf], np.float32)])
    ref = _lid_numpy(depths, dmin, dmax, d)
    bad = (ref < 0) | (ref > d) | ~np.isfinite(ref)
    ref_bin = np.where(bad, d, np.floor(np.where(bad, 0, ref))).astype(np.int32)
    got = tvfe.bin_depths_lid(T(depths), dmin, dmax, d).numpy()
    np.testing.assert_array_equal(got, ref)
    tgt = tvfe.bin_depths_lid(T(depths), dmin, dmax, d, target=True).numpy()
    np.testing.assert_array_equal(tgt, ref_bin)
    assert set(range(d + 1)) <= set(tgt.tolist())  # every bin and the overflow

    for target, port in ((False, got), (True, tgt)):
        want = np.asarray(jvfe.bin_depths_lid(jnp.asarray(depths), dmin, dmax, d, target=target))
        np.testing.assert_array_equal(port, want)


def test_lidar_depth_map_equals_jax():
    rng = np.random.RandomState(1)
    pts = np.stack([rng.rand(500) * 8 - 4, rng.rand(500) * 6 - 3, rng.rand(500) * 20 - 2], 1)
    pts = pts.astype(np.float32)
    valid = rng.rand(500) > 0.1
    K = np.array([[30.0, 0, 24], [0, 30.0, 16], [0, 0, 1]], np.float32)
    Tm = np.eye(4, dtype=np.float32)
    Tm[:3, 3] = [0.1, -0.2, 0.5]
    want = np.asarray(jvfe.lidar_depth_map(jnp.asarray(pts), jnp.asarray(valid), K, Tm, 32, 48))
    got = tvfe.lidar_depth_map(T(pts), T(valid), T(K), T(Tm), 32, 48).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 50


def test_frustum_sampler_equals_jax():
    """Values and the gradients into the features and the depth
    probabilities, voxels in front of, inside and beyond the depth range."""
    rng = np.random.RandomState(3)
    h, w, d, c = 6, 8, 5, 3
    feat = rng.rand(h, w, c).astype(np.float32)
    prob = rng.rand(h, w, d).astype(np.float32)
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    Tm = np.eye(4, dtype=np.float32)
    centers = np.stack([rng.rand(300) * 4 - 2, rng.rand(300) * 3 - 1.5,
                        rng.rand(300) * 40 + 1.95], 1).astype(np.float32)
    args = (K, Tm, centers, (24, 32), 2.0, 40.0, d)
    want = jvfe.frustum_sample_voxels(jnp.asarray(feat), jnp.asarray(prob), *args)
    f, p = T(feat).requires_grad_(True), T(prob).requires_grad_(True)
    got = tvfe.frustum_sample_voxels(f, p, T(K), T(Tm), T(centers), (24, 32), 2.0, 40.0, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    assert (np.asarray(want) != 0).any(axis=1).sum() > 30
    g = rng.randn(300, c).astype(np.float32)
    (got * T(g)).sum().backward()
    jf, jp = jax.grad(lambda a, b: jnp.sum(jvfe.frustum_sample_voxels(a, b, *args) * g),
                      argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(prob))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp), atol=1e-5)


@pytest.mark.parametrize("cap", [1536, 2048 + 256], ids=["cut", "pad"])
def test_image_vfe_samples_only_the_kept_rows_as_jax(cap):
    """ImageVFE in train mode at a cap that cuts the 2 x 1,024-voxel table
    (1,536 rows: all of sample 0, half of sample 1) and one that pads it:
    the voxel table (features, coords, valid), the depth logits, the batch
    statistics, the depth loss and its gradients equal JAX's, which samples
    every voxel and keeps the same rows."""
    batch = toy_batch()
    kw = dict(voxel_size=[0.4, 0.4, 0.4], point_cloud_range=[-3.2, -3.2, -0.8, 3.2, 3.2, 0.8],
              voxel_cap=cap, depth_bins=8, min_depth=0.5, max_depth=8.0)
    jv = jvfe.ImageVFE(**kw)
    arrs = {k: jnp.asarray(v) for k, v in batch.items()}
    arrs["batch_size"] = 2
    v = jv.init(jax.random.PRNGKey(0), arrs, train=True)

    def jloss(params):
        out, mut = jv.apply({"params": params, "batch_stats": v["batch_stats"]}, dict(arrs),
                            train=True, mutable=["batch_stats"])
        return jv.depth_loss(out), (out, mut)

    (jl, (jout, jmut)), jg = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    m = tvfe.ImageVFE(**kw)
    sd = {k[len("vfe."):]: t for k, t in detector_params_from_flax(
        {"params": {"vfe": as_numpy(v["params"])},
         "batch_stats": {"vfe": as_numpy(v["batch_stats"])}}).items()}
    m.load_state_dict(sd, strict=True)
    m.train()
    out = m({k: T(x) for k, x in batch.items()})
    loss = m.depth_loss(out)
    for key in ("voxel_coords", "voxel_valid"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]), err_msg=key)
    want = np.asarray(jout["voxel_features"])
    np.testing.assert_allclose(out["voxel_features"].detach().numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(out["depth_logits"].detach().numpy(),
                               np.asarray(jout["depth_logits"]), atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    ref = {k[len("vfe."):]: t for k, t in detector_params_from_flax(
        {"params": {"vfe": as_numpy(jg)}}).items()}
    for n, p in m.named_parameters():
        r = ref[n].numpy()
        if p.grad is None:  # the feature head does not reach the depth loss
            assert n.startswith("feat.") and not r.any(), n
            continue
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * np.abs(r).max(), err_msg=n)
    stats = {k[len("vfe."):]: t for k, t in detector_params_from_flax(
        {"batch_stats": {"vfe": as_numpy(jmut["batch_stats"])}}).items()}
    sdn = m.state_dict()
    for k, r in stats.items():
        np.testing.assert_allclose(sdn[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)
    assert int(out["voxel_valid"].sum()) == min(cap, 2048)


def test_grid_densify_with_duplicate_cells_equals_jax():
    """Rows that share a cell: the largest row id owns it, as the JAX
    scatter on the CPU keeps its last writer; rows not valid and cells out
    of range write nothing; the gradient is a gather for every valid row
    (the custom VJP), owner or not. Cells that no two rows share are as
    before."""
    rng = np.random.RandomState(5)
    v, c, cells = 200, 4, 64
    lin = rng.randint(0, cells, v).astype(np.int32)  # ~3 rows a cell
    lin[:5] = [cells, cells + 3, -1, 10, 10]
    valid = rng.rand(v) > 0.2
    valid[:3] = True  # out of range but valid
    feats = rng.randn(v, c).astype(np.float32)
    f = T(feats).requires_grad_(True)
    got = tsc.grid_densify(cells, f, T(valid), T(lin))
    want = jsc.grid_densify(cells, jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(lin))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = rng.randn(cells, c).astype(np.float32)
    (got * T(g)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jsc.grid_densify(cells, x, jnp.asarray(valid),
                                                     jnp.asarray(lin)) * g))(jnp.asarray(feats))
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(jg))
    owner = {}
    for r in np.nonzero(valid)[0]:
        if 0 <= lin[r] < cells:
            owner[lin[r]] = r
    for cell, r in owner.items():
        np.testing.assert_array_equal(got.detach().numpy()[cell], feats[r])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _jax_step(model, variables, arrs):
    @jax.jit
    def train_fwd_bwd(params, stats, a):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, {**a, "batch_size": 2},
                                   train=True, mutable=["batch_stats"])
            return out["losses"]["center_loss"], (out["losses"], mut["batch_stats"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)
    return train_fwd_bwd(variables["params"], variables["batch_stats"], arrs)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model: its variables, a train-mode forward and backward of
    center_loss (depth loss included), and predict; then the same step at
    the identity calibration."""
    model = jbuild(CFG, RUNTIME)
    batch = toy_batch()
    arrs = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda key, a: model.init(key, {**a, "batch_size": 2}, train=True))(
        jax.random.PRNGKey(0), arrs)
    (_, (losses, new_stats)), grads = _jax_step(model, variables, arrs)
    pred = jax.jit(lambda v, a: model.apply(v, {**a, "batch_size": 2}, method="predict")[1:])(
        variables, arrs)
    near = toy_batch(tz=0.0)
    (_, (near_losses, _)), near_grads = _jax_step(model, variables,
                                                  {k: jnp.asarray(v) for k, v in near.items()})
    return dict(batch=batch, variables=as_numpy(variables), losses=as_numpy(losses),
                grads=as_numpy(grads), new_stats=as_numpy(new_stats), pred=as_numpy(pred),
                near=near, near_losses=as_numpy(near_losses), near_grads=as_numpy(near_grads))


def port_model(run):
    m = tbuild(CFG, RUNTIME, device="cpu")
    m.load_state_dict(detector_params_from_flax(run["variables"]), strict=True)
    return m


def torch_batch(b):
    return {**{k: T(v) for k, v in b.items()}, "batch_size": 2}


def test_train_step_equals_jax(jax_run):
    m = port_model(jax_run)
    m.train()
    out = m(torch_batch(jax_run["batch"]))
    out["losses"]["center_loss"].backward()
    keys = sorted(jax_run["losses"])
    assert sorted(out["losses"]) == keys and "depth_loss" in keys
    for k in keys:
        np.testing.assert_allclose(float(out["losses"][k].detach()), float(jax_run["losses"][k]),
                                   rtol=1e-4, err_msg=k)
    ref = detector_params_from_flax({"params": jax_run["grads"]})
    grads = dict(m.named_parameters())
    assert set(grads) == set(ref) and all(p.grad is not None for p in grads.values())
    for n, p in grads.items():
        r = ref[n].numpy()
        assert np.isfinite(r).all(), n
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(np.abs(r).max(), 1e-12),
                                   err_msg=n)
    sd = m.state_dict()
    for k, r in detector_params_from_flax({"batch_stats": jax_run["new_stats"]}).items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


def test_voxels_nearer_than_the_first_bin_give_nan_gradients_as_in_jax(jax_run):
    """At the identity calibration the voxels' LID coordinates are NaN: the
    losses are finite, and the image encoder's and its heads' gradients are
    NaN in both packages, in the same tensors; the other gradients agree."""
    m = port_model(jax_run)
    m.train()
    out = m(torch_batch(jax_run["near"]))
    out["losses"]["center_loss"].backward()
    for k, v in jax_run["near_losses"].items():
        assert np.isfinite(float(v))
        np.testing.assert_allclose(float(out["losses"][k].detach()), float(v), rtol=1e-4)
    ref = detector_params_from_flax({"params": jax_run["near_grads"]})
    nan_jax = sorted(n for n, r in ref.items() if not np.isfinite(r.numpy()).all())
    nan_port = sorted(n for n, p in m.named_parameters() if not torch.isfinite(p.grad).all())
    assert nan_port == nan_jax and all(n.startswith("vfe.") for n in nan_jax) and nan_jax
    for n, p in m.named_parameters():
        if n not in nan_jax:
            r = ref[n].numpy()
            np.testing.assert_allclose(p.grad.numpy(), r,
                                       atol=1e-3 * max(np.abs(r).max(), 1e-12), err_msg=n)


def test_predict_equals_jax(jax_run):
    m = port_model(jax_run)
    _, boxes, scores, labels, valid = m.predict(torch_batch(jax_run["batch"]))
    jb, js, jl, jv = jax_run["pred"]
    assert boxes.shape == jb.shape
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert jv.any()
    np.testing.assert_allclose(boxes.numpy()[jv], jb[jv], atol=1e-4)
    np.testing.assert_allclose(scores.numpy()[jv], js[jv], atol=1e-5)
    np.testing.assert_array_equal(labels.numpy()[jv], jl[jv])


def test_converter_takes_every_flax_leaf_once(jax_run):
    leaves = jax.tree_util.tree_leaves(jax_run["variables"])
    sd = detector_params_from_flax(jax_run["variables"])
    assert len(sd) == len(leaves)
    assert set(tbuild(CFG, RUNTIME, device="cpu").state_dict()) == set(sd)


def test_caddn_yaml_builds(monkeypatch):
    """caddn.yaml at full widths: ImageVFE with its defaults (32 channels,
    16 LID bins over 2-60 m), the pillar scatter to 32 BEV channels, the
    config's [5, 5] BEV backbone, CenterHead at stride 1; the card by
    default."""
    cfg = cfg_from_yaml_file(str(REPO / "tools/cfgs/waymo_models/caddn.yaml"), EDict())
    runtime = dict(RUNTIME, class_names=list(cfg.CLASS_NAMES))
    m = build_network(cfg.MODEL, runtime, device="cpu")
    assert type(m.vfe).__name__ == "ImageVFE" and m.backbone_3d is None
    assert (m.vfe.out_channels, m.vfe.depth_bins, m.vfe.min_depth, m.vfe.max_depth) == (
        32, 16, 2.0, 60.0)
    assert m.backbone_2d.block0_down.in_channels == 32
    assert m.dense_head.head.feature_stride == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_network(cfg.MODEL, runtime)
