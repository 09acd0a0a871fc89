"""The data-parallel train step (``parallel.train_step`` over a gloo
process group, with ``models.layers.bn_cross_replica``) against the JAX
package's dp test (tests/test_multichip.py): CenterPoint with
DynamicMeanVFE -> PointPillarScatter -> BaseBEVBackbone -> CenterHead, 8
samples of 64 points in +-3 m with one box each, the JAX weights carried by
``convert.detector_params_from_flax``. Ranks are spawned processes joined
through a FileStore under the test's tmp_path.

Tolerances: PointPillarScatter exact. The port at dp = 1 equals JAX at
dp = 1 to 1e-5 relative (losses and grad_norm); at 4 ranks it equals JAX's
dp = 8 and its own dp = 1 to 1e-4 (JAX's own bound between its dp = 8 and
dp = 1). In float64 the reduced gradients at 2 ranks equal dp = 1's to
1e-9 of each tensor's max |g|: the gradient flows through the
cross-replica moments (without the moments' backward all-reduce they miss
by orders more). After two steps every rank holds the same parameters and
buffers, bit for bit. Every shard of this batch holds one positive and no
invalid point, and no cap is filled (``dp_equivalence_issues``), which is
when dp = K and dp = 1 compute the same function.

The spawned ranks import this module, so JAX is imported only inside the
fixtures.
"""

import numpy as np
import pytest
import torch

from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models.backbones_2d import PointPillarScatter
from pcseqlearning_tpu_torch.models.detectors import build_detector
from pcseqlearning_tpu_torch.parallel import train_step as ts
from pcseqlearning_tpu_torch.utils import dist_utils
from pcseqlearning_tpu_torch.utils.edict import EDict

torch.set_num_threads(1)

CFG = EDict(
    NAME="CenterPoint", VFE={"NAME": "DynamicMeanVFE"}, MAP_TO_BEV={"NAME": "PointPillarScatter"},
    BACKBONE_2D={"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                 "NUM_FILTERS": [16], "UPSAMPLE_STRIDES": [1], "NUM_UPSAMPLE_FILTERS": [16]},
    DENSE_HEAD={"NAME": "CenterHead", "FEATURE_MAP_STRIDE": 1},
)
RUNTIME = dict(data_cfg={"POINT_CLOUD_RANGE": [-3.2, -3.2, -1.0, 3.2, 3.2, 2.2],
                         "VOXEL_SIZE": [0.4, 0.4, 3.2]},
               class_names=["Vehicle"], voxel_cap=4096)
KEYS = ("hm_loss", "loc_loss", "center_loss", "grad_norm")


def dp_batch(B=8, n=64):
    """tests/test_multichip.py's batch, drawn in its order from RandomState(0)."""
    rng = np.random.RandomState(0)
    pts = np.zeros((B, n, 4), np.float32)
    pts[:, :, 1:3] = rng.rand(B, n, 2) * 6 - 3
    pts[:, :, 3] = rng.rand(B, n) * 1.5 - 0.5
    gt = np.zeros((B, 2, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.5, 1.5, 1.0, 0.3, 1]
    return dict(points=pts, feats=rng.rand(B, n, 1).astype(np.float32),
                valid=np.ones((B, n), bool), gt_boxes=gt)


def run_steps(weights, group, dtype=torch.float32, steps=2, freeze=()):
    """``steps`` steps from ``weights`` (the port's state_dict, NumPy):
    (losses per step, gradients after the first, final state_dict)."""
    model = build_detector(CFG, RUNTIME, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()}, strict=True)
    model = model.to(dtype)
    state = ts.init_train_state(model, device="cpu", group=group)
    step = ts.make_train_step(loss_key="center_loss", device="cpu", group=group,
                              freeze_regexes=freeze, freeze_until=10)
    batch = {k: (v.astype(np.float64) if dtype == torch.float64 and v.dtype == np.float32 else v)
             for k, v in dp_batch().items()}
    losses, grads = [], None
    for i in range(steps):
        state, ls = step(state, batch)
        losses.append({k: float(v) for k, v in ls.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return losses, grads, {k: v.clone() for k, v in state.model.state_dict().items()}


def _rank(rank, world, weights, dtype, steps, freeze):
    import torch.distributed as dist

    torch.set_num_threads(1)
    return run_steps(weights, dist.group.WORLD, dtype, steps, freeze)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's initial weights (as the port's state_dict) and its first-step
    losses at dp = 1 and dp = 8."""
    import jax
    import jax.numpy as jnp

    from pcseqlearning_tpu.models.detectors import build_detector as jbuild
    from pcseqlearning_tpu.parallel import make_mesh, make_train_step
    from pcseqlearning_tpu.parallel.train_step import init_train_state
    from pcseqlearning_tpu.runtime.optimization import build_optimizer

    model = jbuild(CFG, RUNTIME)
    tx, _ = build_optimizer({"OPTIMIZER": "adam", "LR": 1e-3}, 10, 1)
    batch = {k: jnp.asarray(v) for k, v in dp_batch().items()}
    state = init_train_state(model, tx, {k: v[:1] for k, v in batch.items()})
    out = {}
    for dp in (1, 8):
        step = make_train_step(model, tx, make_mesh(devices=jax.devices()[:dp], dp=dp, mp=1),
                               loss_key="center_loss")
        out[dp] = {k: float(v) for k, v in step(state, batch)[1].items()}
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    weights = {k: v.numpy() for k, v in detector_params_from_flax(variables).items()}
    return weights, out


@pytest.fixture(scope="module")
def port_dp1(jax_ref):
    return run_steps(jax_ref[0], None)


@pytest.fixture(scope="module")
def port_dp4(jax_ref, tmp_path_factory):
    return dist_utils.launch_ranks(_rank, 4, str(tmp_path_factory.mktemp("dp4") / "store"),
                                   args=(jax_ref[0], torch.float32, 2, ()), timeout=120)


def test_batch_meets_the_equivalence_conditions(jax_ref):
    model = build_detector(CFG, RUNTIME, device="cpu")
    issues, fills = ts.dp_equivalence_issues(model, dp_batch(), 8)
    assert issues == [] and fills[0][0] < RUNTIME["voxel_cap"]
    # the check sees each way a batch breaks the equivalence
    bad = dp_batch()
    bad["valid"][3, :5] = False
    bad["gt_boxes"][2, 1] = [-1.0, -1.0, 0.5, 1.5, 1.5, 1.0, 0.3, 1]
    issues, _ = ts.dp_equivalence_issues(model, bad, 8)
    assert len(issues) == 2 and "padding" in issues[0] and "positives" in issues[1]
    assert ts.dp_equivalence_issues(model, dp_batch(), 3)[0]


def test_point_pillar_scatter_equals_jax():
    import jax.numpy as jnp

    from pcseqlearning_tpu.models.backbones_2d import PointPillarScatter as JScatter

    rng = np.random.RandomState(3)
    P, C, B, W, H = 50, 5, 2, 16, 12
    cells = rng.choice(B * H * W, P, replace=False)
    coords = np.stack([cells // (H * W), np.zeros(P, np.int64), cells // W % H, cells % W],
                      1).astype(np.int32)
    valid = rng.rand(P) > 0.2
    coords[~valid] = -1
    feats = rng.randn(P, C).astype(np.float32)
    bd = dict(voxel_features=feats, voxel_coords=coords, voxel_valid=valid, batch_size=B)
    scatter = JScatter(grid_size=(W, H, 1))
    jbd = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in bd.items()}
    want = np.asarray(scatter.apply({}, jbd)["spatial_features"])  # NHWC
    got = PointPillarScatter((W, H, 1))({k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                                             else v) for k, v in bd.items()})
    np.testing.assert_array_equal(got["spatial_features"].permute(0, 2, 3, 1).numpy(), want)
    assert got["spatial_features_stride"] == 1


def test_port_dp1_equals_jax_dp1(jax_ref, port_dp1):
    for k in KEYS:
        print(f"dp=1 {k}: relative error {abs(port_dp1[0][0][k] / jax_ref[1][1][k] - 1):.2e}")
        np.testing.assert_allclose(port_dp1[0][0][k], jax_ref[1][1][k], rtol=1e-5, err_msg=k)


def test_port_four_ranks_equal_jax_dp8_and_port_dp1(jax_ref, port_dp4, port_dp1):
    for k in KEYS:
        got = port_dp4[0][0][0][k]
        print(f"4 ranks {k}: relative error {abs(got / jax_ref[1][8][k] - 1):.2e} from JAX dp=8, "
              f"{abs(got / port_dp1[0][0][k] - 1):.2e} from the port's dp=1")
        assert abs(got - jax_ref[1][8][k]) / max(abs(jax_ref[1][8][k]), 1e-3) < 1e-4, k
        assert abs(got - port_dp1[0][0][k]) / max(abs(port_dp1[0][0][k]), 1e-3) < 1e-4, k
        assert all(r[0][0][k] == got for r in port_dp4)  # every rank logs the same mean


def test_ranks_hold_equal_state_after_two_steps(port_dp4):
    for r in port_dp4[1:]:
        assert r[0] == port_dp4[0][0]
        for k, v in port_dp4[0][2].items():
            assert torch.equal(r[2][k], v), k


@pytest.fixture(scope="module")
def float64_dp2(jax_ref, tmp_path_factory):
    return dist_utils.launch_ranks(_rank, 2, str(tmp_path_factory.mktemp("dp2") / "store"),
                                   args=(jax_ref[0], torch.float64, 1, ()), timeout=120)


def test_float64_reduced_gradients_equal_dp1(jax_ref, float64_dp2):
    _, ref, _ = run_steps(jax_ref[0], None, torch.float64, steps=1)
    for r in float64_dp2:
        for n, g in ref.items():
            err = float((r[1][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
            assert err < 1e-9, (n, err)
        assert all(torch.equal(r[1][n], float64_dp2[0][1][n]) for n in ref)


def test_freeze_under_two_ranks(jax_ref, tmp_path):
    """Frozen parameters keep their values at dp = 2 (the zeroing acts on
    the reduced gradients), the rest move as at dp = 1."""
    freeze = ("backbone_2d/block0_conv0",)
    ranks = dist_utils.launch_ranks(_rank, 2, str(tmp_path / "store"),
                                    args=(jax_ref[0], torch.float64, 1, freeze), timeout=120)
    one = run_steps(jax_ref[0], None, torch.float64, steps=1, freeze=freeze)
    w0 = jax_ref[0]["backbone_2d.block0_conv0.weight"]
    for _, grads, final in ranks:
        assert torch.equal(final["backbone_2d.block0_conv0.weight"],
                           torch.as_tensor(w0, dtype=torch.float64))
        assert float(grads["backbone_2d.block0_conv0.weight"].abs().max()) == 0.0
        for k, v in one[2].items():
            assert float((final[k] - v).abs().max()) < 1e-9, k
