"""The port's SST-CenterPoint against the JAX package's: the window
regrouping (``flat2window`` / ``window2flat``) with windows and slots past
their caps, ``WindowMSA`` against flax's attention, layer norm and GELU
(with fully masked rows), and the whole model (DynPillarVFE, SST,
PointPillarScatter, BaseBEVBackbone, CenterHead at stride 1) with the flax
weights carried over by ``convert.detector_params_from_flax``.

The whole model runs at tests/test_all_cfgs.py's toy with its
``_TEST_CAP_CLAMPS`` (DIM 32, WINDOW_SIZE 4, NUM_WINDOWS_CAP 128,
WINDOW_CAP 16) and 2 blocks, in float32; the shifted block's window cap
drops pillars there.

Tolerances: losses 1e-4 relative; each parameter's gradient within 1e-3 of
that tensor's max |g| (an attention block's key bias has no gradient in
exact arithmetic, since a bias on the keys adds the same logit to a whole
row: its float32 noise is held to 1e-3 of the block's query-bias
gradient); the new batch statistics 1e-5; predict's valid mask exact,
the valid rows' boxes 1e-4 and scores 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models import backbones_sst as jsst
from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.utils.edict import EDict
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models import backbones_sst as tsst
from pcseqlearning_tpu_torch.models import build_network
from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild

torch.set_num_threads(1)
T = torch.as_tensor
REPO = Path(__file__).resolve().parent.parent

RUNTIME = dict(data_cfg={"POINT_CLOUD_RANGE": [-6.4, -6.4, -1.0, 6.4, 6.4, 2.2],
                         "VOXEL_SIZE": [0.4, 0.4, 0.2]},
               class_names=["Vehicle", "Pedestrian", "Cyclist"], voxel_cap=1024)
CFG = EDict(NAME="CenterPoint", VFE={"NAME": "DynPillarVFE", "NUM_FILTERS": [32]},
            BACKBONE_3D={"NAME": "SST", "DIM": 32, "NUM_BLOCKS": 2, "WINDOW_SIZE": 4,
                         "NUM_WINDOWS_CAP": 128, "WINDOW_CAP": 16},
            MAP_TO_BEV={"NAME": "PointPillarScatter"},
            BACKBONE_2D={"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1, 1],
                         "LAYER_STRIDES": [1, 2], "NUM_FILTERS": [16, 32],
                         "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [16, 16]},
            DENSE_HEAD={"NAME": "CenterHead", "FEATURE_MAP_STRIDE": 1})


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def block_params(tree, coll="params"):
    """A flax WindowMSA's leaves as the port's block state (the converter
    names its layers under a ``block_<i>`` parent)."""
    sd = detector_params_from_flax({coll: {"block_0": as_numpy(tree)}})
    return {k[len("block_0."):]: v for k, v in sd.items()}


def _pillars(seed=0, p=300):
    """Pillar coords (x, y) on a 40 x 40 grid, two samples folded into y as
    the backbone folds them, a tenth not valid, many per window."""
    rng = np.random.RandomState(seed)
    xy = np.stack([rng.randint(0, 40, p), rng.randint(0, 40, p)], 1)
    b = rng.randint(0, 2, p)
    xy[:, 1] += b * (40 + 2 * 6)
    valid = rng.rand(p) > 0.1
    return xy.astype(np.int32), valid, rng.randn(p, 8).astype(np.float32)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("caps", [(160, 40), (20, 6)], ids=["loose", "cut"])
def test_flat2window_and_back_equal_jax(shift, caps):
    """Window ids (``unique_rows`` order), slots by index within a window,
    the kept mask, the dense windows and their mask exactly JAX's; with caps
    that cut, the pillars past either cap come back as zeros; the gradient
    of both directions equals JAX's."""
    xy, valid, feats = _pillars()
    nwc, wc = caps
    jw, jm, jmap = jsst.flat2window(jnp.asarray(feats), jnp.asarray(xy), jnp.asarray(valid), 6,
                                    nwc, wc, shift=shift)
    mapping = tsst.window_mapping(T(xy), T(valid), 6, nwc, wc, shift=shift)
    for a, b in zip(mapping, jmap):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    f = T(feats).clone().requires_grad_(True)
    tw, tm = tsst.flat2window(f, mapping, nwc, wc)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tw.detach().numpy(), np.asarray(jw))
    back = tsst.window2flat(tw, mapping)
    jback = jsst.window2flat(jw, jmap, len(feats))
    np.testing.assert_array_equal(back.detach().numpy(), np.asarray(jback))
    ok = mapping[2].numpy()
    dropped = valid & ~ok
    assert (dropped.any() if caps == (20, 6) else not dropped.any())
    assert not back.detach().numpy()[~ok].any()
    w = np.random.RandomState(1).randn(*feats.shape).astype(np.float32)
    (back * T(w)).sum().backward()

    def jf(x):
        win, _, mp = jsst.flat2window(x, jnp.asarray(xy), jnp.asarray(valid), 6, nwc, wc, shift)
        return jnp.sum(jsst.window2flat(win, mp, len(feats)) * w)
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(jax.grad(jf)(jnp.asarray(feats))))


def test_window_msa_equals_flax_with_fully_masked_rows():
    """One block against the flax module (MultiHeadDotProductAttention, its
    LayerNorms with epsilon 1e-6, the tanh GELU), on windows with a few
    valid slots, and on a window with none (whose rows are all masked: flax
    gives them uniform weights, not NaN): output and gradients within
    1e-5."""
    rng = np.random.RandomState(2)
    w, length, dim = 6, 10, 32
    x = rng.randn(w, length, dim).astype(np.float32)
    pe = rng.randn(w, length, dim).astype(np.float32) * 0.1
    mask = rng.rand(w, length) > 0.4
    mask[0] = False  # a window with every slot masked
    mask[1] = True
    block = jsst.WindowMSA(dim, 8)
    v = block.init(jax.random.PRNGKey(3), x, mask, pe)
    m = tsst.WindowMSA(dim, 8)
    m.load_state_dict(block_params(v["params"]), strict=True)
    xt = T(x).clone().requires_grad_(True)
    got = m(xt, T(mask), T(pe))
    want, vjp = jax.vjp(lambda p, a: block.apply({"params": p}, a, mask, pe), v["params"], x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    assert np.isfinite(got.detach().numpy()).all() and not got.detach().numpy()[0].any()
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    (got * T(g)).sum().backward()
    gp, gx = vjp(jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    ref = block_params(gp)
    for n, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(), atol=1e-4, err_msg=n)
    # the masked logits are the dtype's most negative finite value: an
    # all-masked row softmaxes to uniform weights
    attn = tsst.MultiHeadAttention(dim, 8)
    out = attn(T(x[:1]), torch.zeros(1, length, dtype=torch.bool))
    assert torch.isfinite(out).all()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model: its variables, a train-mode forward and backward of
    center_loss, and predict (each one jitted program)."""
    model = jbuild(CFG, RUNTIME)
    rng = np.random.RandomState(0)
    n = 512
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, n)
    pts[:, 1:3] = rng.rand(n, 2) * 12 - 6
    pts[:, 3] = rng.rand(n) * 2.5 - 0.8
    gt = np.zeros((2, 3, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.8, 1.8, 1.2, 0.3, 1]
    gt[:, 1] = [-2.0, 3.0, 0.4, 0.8, 0.7, 1.7, -0.6, 2]
    gt[1, 2] = [3.0, -2.5, 0.4, 1.7, 0.6, 1.7, 1.2, 3]
    batch = {"point_bxyz": pts, "point_feat": rng.rand(n, 1).astype(np.float32),
             "gt_boxes": gt}
    arrs = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda key, a: model.init(key, {**a, "batch_size": 2}, train=True))(
        jax.random.PRNGKey(0), arrs)

    @jax.jit
    def train_fwd_bwd(params, stats, a):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, {**a, "batch_size": 2},
                                   train=True, mutable=["batch_stats"])
            return out["losses"]["center_loss"], (out["losses"], mut["batch_stats"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (losses, new_stats)), grads = train_fwd_bwd(variables["params"],
                                                    variables["batch_stats"], arrs)
    pred = jax.jit(lambda v, a: model.apply(v, {**a, "batch_size": 2}, method="predict")[1:])(
        variables, arrs)
    return dict(batch=batch, variables=as_numpy(variables), losses=as_numpy(losses),
                grads=as_numpy(grads), new_stats=as_numpy(new_stats), pred=as_numpy(pred))


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
    assert sorted(out["losses"]) == keys
    for k in keys:
        np.testing.assert_allclose(float(out["losses"][k].detach()), float(jax_run["losses"][k]),
                                   rtol=1e-4, err_msg=k)
    dropped = [int((out["voxel_valid"] & ~mp[2]).sum()) for mp in out["window_mappings"]]
    print("pillars the window cap drops, by block", dropped)
    assert any(dropped)
    ref = detector_params_from_flax({"params": jax_run["grads"]})
    grads = dict(m.named_parameters())
    assert set(grads) == set(ref) and all(p.grad is not None for p in grads.values())
    for n, p in grads.items():
        r = ref[n].numpy()
        scale = np.abs(r).max()
        if n.endswith("attn.key.bias"):  # zero in exact arithmetic
            scale = np.abs(ref[n.replace("key", "query")].numpy()).max()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-3 * max(scale, 1e-12), err_msg=n)
    sd = m.state_dict()
    for k, r in detector_params_from_flax({"batch_stats": jax_run["new_stats"]}).items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


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


def test_sst_yaml_builds(monkeypatch):
    """sst_centerpoint.yaml at full widths: DynPillarVFE (128 filters), SST
    (DIM 128, 6 blocks, window 12, caps 4,096 x 144), the pillar scatter to
    128 BEV channels, CenterHead at stride 1; the card by default."""
    cfg = cfg_from_yaml_file(str(REPO / "tools/cfgs/waymo_models/sst_centerpoint.yaml"), EDict())
    runtime = dict(RUNTIME, class_names=list(cfg.CLASS_NAMES))
    m = build_network(cfg.MODEL, runtime, device="cpu")
    sst = m.backbone_3d
    assert type(sst).__name__ == "SSTBackbone" and m.vfe.out_channels == 128
    assert (sst.dim, sst.num_blocks, sst.window_size, sst.num_windows_cap, sst.window_cap) == (
        128, 6, 12, 4096, 144)
    assert m.backbone_2d.block0_down.in_channels == 128
    assert m.dense_head.head.feature_stride == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_network(cfg.MODEL, runtime)
