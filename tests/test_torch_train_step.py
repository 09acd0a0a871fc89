"""The port's single-card train step against the JAX package's
``make_train_step`` on a one-device mesh, from the same carried state, on
the toy CenterPoint of tests/test_torch_detector.py (dense batch: 2 x 256
points).

Tolerances: each of steps 1, 2 and 3, taken from JAX's state before it,
gives JAX's losses and grad_norm to 1e-4 relative (measured: 1e-6). Run on
from its own updates, the port drifts from JAX by a decision that float32
noise takes: Adam's first update is about lr * sign(g) for every entry, so
an entry whose gradient is rounding noise around zero moves by +-lr in
either package at random. After the first update 12 of the 2.9M entries
moved differently (all in the sparse backbone's deepest convolutions,
res3-res4 and conv4_down, whose few active voxels give near-zero
gradients); the second update then moved ~179k entries of those layers
differently (their normalized updates are also ~lr * sign(g)), which took
hm_loss from 7.6e-6 (step 2) to 5.8e-3 (step 3) relative on an AMD EPYC,
a distance that rests on the host's order of adds. So the free run is held
only to its own step count and to a falling loss, and
``test_first_update_equals_jax`` holds every entry of the first update but
at most 20 to 1e-5. One Adam update on fixed gradients against optax.adam:
1e-6. dense_batch_from_collated: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.parallel import train_step as jts
from pcseqlearning_tpu.parallel.mesh import make_mesh
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild
from pcseqlearning_tpu_torch.parallel import train_step as tts
from test_torch_detector import RUNTIME, centerpoint_cfg

# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)
T = torch.as_tensor
STEPS = 3


def dense_batch(seed=0, n=256, batch=2):
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch, n, 4), np.float32)
    pts[..., 1:3] = rng.rand(batch, n, 2) * 6.0 - 3.0
    pts[..., 3] = rng.rand(batch, n) * 1.5 - 0.5
    feats = rng.rand(batch, n, 1).astype(np.float32)
    gt = np.zeros((batch, 4, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.5, 1.5, 1.0, 0.3, 1]
    gt[:, 1] = [-1.0, -1.0, 0.5, 1.0, 1.0, 1.0, -0.3, 2]
    return dict(points=pts, feats=feats, valid=np.ones((batch, n), bool), gt_boxes=gt)


@pytest.fixture(scope="module")
def jax_steps():
    """The initial state and STEPS steps of the JAX train step."""
    model = jbuild(centerpoint_cfg(), RUNTIME)
    tx = optax.adam(1e-3)
    batch = dense_batch()
    state = jts.init_train_state(model, tx, batch)
    init = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                               "batch_stats": state.batch_stats})
    step = jts.make_train_step(model, tx, make_mesh(jax.devices()[:1], dp=1),
                               loss_key="center_loss")
    dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, params, stats = [], [], []
    for _ in range(STEPS):
        state, ls = step(state, dev_batch)
        losses.append({k: float(v) for k, v in ls.items()})
        params.append(jax.tree_util.tree_map(np.asarray, state.params))
        stats.append(jax.tree_util.tree_map(np.asarray, state.batch_stats))
    return init, losses, params, stats


def port_state(init):
    model = tbuild(centerpoint_cfg(), RUNTIME, device="cpu")
    model.load_state_dict(detector_params_from_flax(init), strict=True)
    return tts.init_train_state(model, device="cpu")


def test_three_steps_equal_jax(jax_steps):
    init, ref, params, stats = jax_steps
    step = tts.make_train_step(loss_key="center_loss", device="cpu")
    batch = dense_batch()
    carried = [init] + [{"params": p, "batch_stats": s} for p, s in zip(params, stats)]
    for i in range(STEPS):
        _, losses = step(port_state(carried[i]), batch)
        for k in ("center_loss", "hm_loss", "loc_loss", "grad_norm"):
            print(f"step {i} {k}: relative error {abs(float(losses[k]) / ref[i][k] - 1):.2e}")
            np.testing.assert_allclose(float(losses[k]), ref[i][k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    state, own = port_state(init), []
    for _ in range(STEPS):
        state, losses = step(state, batch)
        own.append(float(losses["center_loss"]))
    assert state.step == STEPS
    assert ref[-1]["center_loss"] < ref[0]["center_loss"]
    assert own[-1] < own[0]


def test_first_update_equals_jax(jax_steps):
    """After one step every parameter entry equals JAX's to 1e-5, but for
    at most 20 whose update went another way (at most 2 lr apart)."""
    init, _, params, _ = jax_steps
    state, _ = tts.make_train_step(loss_key="center_loss", device="cpu")(port_state(init),
                                                                         dense_batch())
    ref = detector_params_from_flax({"params": params[0]})
    flipped = 0
    for name, p in state.model.named_parameters():
        d = (p.detach() - ref[name]).abs()
        assert float(d.max()) < 2.1e-3, name
        flipped += int((d > 1e-5).sum())
    print(f"entries that moved differently: {flipped}")
    assert flipped <= 20


def test_adam_update_equals_optax(rng):
    """init_train_state's default optimizer and optax.adam(1e-3): three
    updates on fixed gradients."""
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    tx = optax.adam(1e-3)
    p, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(T(p0).clone())
    holder = torch.nn.Module()
    holder.w = w
    opt = tts.init_train_state(holder, device="cpu").optimizer
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, p)
        p = optax.apply_updates(p, upd)
        w.grad = T(g).clone()
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(p), atol=1e-6)


def test_freeze_regexes_zero_gradients(jax_steps):
    """Parameters whose '/'-joined name matches stay put while the step is
    below freeze_until (their gradients are zeroed, so Adam's first update
    is zero); the rest move; from freeze_until on, all move."""
    state = port_state(jax_steps[0])
    step = tts.make_train_step(loss_key="center_loss", freeze_regexes=("backbone_3d/res1",),
                               freeze_until=1, device="cpu")
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, _ = step(state, dense_batch())
    frozen = [n for n in before if tts.param_path(n).startswith("backbone_3d/res1")]
    assert len(frozen) == 12  # res1_a and res1_b: two convs, each a kernel and a BN
    for n, p in state.model.named_parameters():
        assert torch.equal(p, before[n]) == (n in frozen), n
    mid = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, _ = step(state, dense_batch())
    assert all(not torch.equal(p, mid[n]) for n, p in state.model.named_parameters())


def test_dense_batch_from_collated_equals_jax(rng):
    counts = (7, 12, 3)
    bxyz = np.concatenate([np.concatenate([np.full((c, 1), b, np.float32),
                                           rng.randn(c, 3).astype(np.float32)], 1)
                           for b, c in enumerate(counts)])
    batch = dict(point_bxyz=bxyz, point_feat=rng.rand(len(bxyz), 2).astype(np.float32),
                 batch_size=3, gt_boxes=rng.randn(3, 5, 8).astype(np.float32))
    for n_cap, max_gt in ((10, 4), (16, 8)):  # truncating and padding
        got = tts.dense_batch_from_collated(batch, n_cap, max_gt)
        ref = jts.dense_batch_from_collated(batch, n_cap, max_gt)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    flat = tts._flatten_local(*(T(got[k]) for k in ("points", "feats", "valid", "gt_boxes")))
    ref = jts._flatten_local(*(jnp.asarray(got[k]) for k in ("points", "feats", "valid",
                                                             "gt_boxes")))
    for k in ("point_bxyz", "point_feat", "point_valid"):
        np.testing.assert_array_equal(flat[k].numpy(), np.asarray(ref[k]))
    assert flat["batch_size"] == ref["batch_size"] == 3


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tts.make_train_step(loss_key="center_loss")
    with pytest.raises(RuntimeError, match="cuda"):
        tts.init_train_state(torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        tbuild(centerpoint_cfg(), RUNTIME)
