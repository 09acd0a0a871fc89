"""The port's train loop, checkpoints, parameter loading and EMA against the
JAX package's ``runtime.train_utils``.

Checkpoints: a loaded state equals the saved one bit for bit (parameters,
batch-norm buffers, optimizer moments and count, step); rotation keeps the
newest ``max_keep``. ``load_params_from_file`` on the JAX test's three
cases (same count reshaped, mismatch kept, missing kept) gives JAX's
arrays exactly. ``ema_update``: 1e-7 absolute (XLA may fuse the
multiply-add).

The loop: two epochs of ``train_model`` in both packages on the toy
CenterPoint of tests/test_torch_detector.py with the same flax weights
(``convert.detector_params_from_flax``), onecycle_centerpoint.yaml's
one-cycle AdamW with its clip, unchanged (LR 3e-3), fed one list of
collated batches through a loader with ``set_epoch``. Each step is held at
a bound set from the readings on the CPU (relative error of the losses;
of grad_norm):

    step  losses: reading  bound    grad_norm: reading  bound
    1     1.0e-6           1e-5     2.1e-6              1e-5
    2     2.2e-5           1e-4     1.7e-3              4e-3
    3     1.1e-2           2.5e-2   4.7e-2              1e-1

Steps 1 and 2 meet tests/test_torch_train_step.py's 1e-4 and 1e-3 on the
losses; step 3 does not meet its 5e-3, nor step 2's grad_norm its 1e-3,
because the drift grows with the rate (that test's Adam runs at 1e-3). Adam's
first update moves every entry by about lr * sign(g), so an entry whose
gradient is float32 noise around zero moves by +-lr in either package at
random: after the first update 37 of the 2.9M entries moved differently
(the test allows 100 and holds the rest to 1e-5), and each step compounds
those differences through the network; step 4 (9e-2 to 1.9e-1) is only
printed. Then the eval-mode forward with the running statistics of JAX's
two epochs, carried into the port: predict's top-k boxes and scores to
1e-4 (5.4e-7 measured), labels and validity equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.models.detectors import build_detector as jbuild
from pcseqlearning_tpu.parallel import train_step as jts
from pcseqlearning_tpu.parallel.mesh import make_mesh
from pcseqlearning_tpu.runtime import optimization as jopt
from pcseqlearning_tpu.runtime import train_utils as jtu
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.convert import detector_params_from_flax
from pcseqlearning_tpu_torch.models.detectors import build_detector as tbuild
from pcseqlearning_tpu_torch.parallel import train_step as tts
from pcseqlearning_tpu_torch.runtime import optimization as topt
from pcseqlearning_tpu_torch.runtime import train_utils as ttu
from pcseqlearning_tpu_torch.utils.edict import EDict
from test_torch_detector import RUNTIME, centerpoint_cfg, toy_batch

torch.set_num_threads(1)
OPTIM = "tools/cfgs/optimizers/onecycle_centerpoint.yaml"
N_CAP = 512


def loop_cfg():
    """onecycle_centerpoint.yaml's OPTIMIZATION."""
    return cfg_from_yaml_file(OPTIM, EDict()).OPTIMIZATION


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)
        self.bn = torch.nn.BatchNorm1d(3)

    def forward(self, x):
        return self.bn(self.lin(x))


def tiny_state(seed=0, updates=3):
    """A Tiny model and its clipped AdamW after ``updates`` updates."""
    torch.manual_seed(seed)
    model = Tiny()
    make_opt, _ = topt.build_optimizer(cfg_from_yaml_file(OPTIM, EDict()).OPTIMIZATION, 2, 3)
    state = tts.init_train_state(model, make_opt, device="cpu")
    for i in range(updates):
        model(torch.randn(8, 4)).pow(2).sum().backward()
        state.optimizer.step()
        state.optimizer.zero_grad()
        state.step += 1
    return state


def assert_states_equal(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"] and a.step == b.step
    for k in sa["moments"]:
        assert all(torch.equal(x, y) for x, y in zip(sa["moments"][k], sb["moments"][k]))


def test_checkpoint_roundtrip_rotation_and_latest(tmp_path):
    state = tiny_state()
    assert ttu.latest_checkpoint(str(tmp_path)) is None
    paths = [ttu.save_checkpoint(state, str(tmp_path), e, max_keep=2) for e in (1, 2, 10)]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint_epoch_10",
                                                          "checkpoint_epoch_2"]
    assert ttu.latest_checkpoint(str(tmp_path)) == paths[-1]  # by epoch, not by name
    fresh = tiny_state(seed=1, updates=0)
    loaded = ttu.load_checkpoint(paths[-1], fresh)
    assert loaded.optimizer.count == 3 and loaded.step == 3
    assert_states_equal(loaded, state)
    # evaluation loads the model alone
    other = tiny_state(seed=2, updates=1)
    ttu.load_checkpoint(paths[-1], other, with_optimizer=False)
    assert other.optimizer.count == 1
    assert all(torch.equal(v, state.model.state_dict()[k])
               for k, v in other.model.state_dict().items())


class ABC(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.zeros(4, 3))  # same count, new layout
        self.b = torch.nn.Parameter(torch.zeros(5, 5))  # mismatch: keep init
        self.c = torch.nn.Parameter(torch.full((2,), 7.0))  # missing: keep init


def test_load_params_from_file_equals_jax(tmp_path):
    import orbax.checkpoint as ocp

    src = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones((2, 2), np.float32)}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "jax"), src)
    ckptr.wait_until_finished()
    tgt = {"a": np.zeros((4, 3), np.float32), "b": np.zeros((5, 5), np.float32),
           "c": np.full((2,), 7.0, np.float32)}
    want = jtu.load_params_from_file(str(tmp_path / "jax"), tgt)
    torch.save({"model": {k: torch.as_tensor(v) for k, v in src.items()}}, tmp_path / "port")
    state = tts.TrainState(ABC(), None, 0)
    got = ttu.load_params_from_file(str(tmp_path / "port"), state).model.state_dict()
    for k in tgt:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="shape mismatch at b"):
        ttu.load_params_from_file(str(tmp_path / "port"), tts.TrainState(ABC(), None, 0),
                                  strict=True)


def test_ema_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    ema = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    params = {k: rng.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
    for decay in (0.999, 0.5):
        want = jtu.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                              {k: jnp.asarray(v) for k, v in params.items()}, decay)
        got = ttu.ema_update({k: torch.as_tensor(v) for k, v in ema.items()},
                             {k: torch.as_tensor(v) for k, v in params.items()}, decay)
        for k in ema:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-7)
    # the mean of several checkpoints' parameters; buffers from the last
    states = [tiny_state(seed=s) for s in range(3)]
    paths = [ttu.save_checkpoint(s, str(tmp_path), i + 1) for i, s in enumerate(states)]
    out = ttu.load_ema_params_from_files(paths, tiny_state(seed=9, updates=0))
    for n, p in out.model.named_parameters():
        want = sum(dict(s.model.named_parameters())[n].detach() for s in states) / 3.0
        assert torch.equal(p.detach(), want), n
    for n, b in out.model.named_buffers():
        assert torch.equal(b, dict(states[-1].model.named_buffers())[n]), n
    assert out.optimizer.count == states[-1].optimizer.count


class ListLoader:
    """A fixed list of collated batches; records its set_epoch calls."""

    def __init__(self, batches):
        self.batches = batches
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def collated(seed):
    return {**toy_batch(seed=seed), "batch_size": 2}


@pytest.fixture(scope="module")
def jax_loop(tmp_path_factory):
    """The JAX train_model over two epochs of two batches; its initial
    variables and per-step losses."""
    cfg = loop_cfg()
    batches = [collated(0), collated(1)]
    model = jbuild(centerpoint_cfg(), RUNTIME)
    tx, _ = jopt.build_optimizer(dict(cfg), len(batches), 2)
    state = jts.init_train_state(model, tx, jts.dense_batch_from_collated(batches[0], N_CAP))
    init = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                               "batch_stats": state.batch_stats})
    step = jts.make_train_step(model, tx, make_mesh(jax.devices()[:1], dp=1),
                               loss_key="center_loss")
    losses, first = [], []

    def recorded(state, batch):
        state, ls = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append({k: float(v) for k, v in ls.items()})
        if not first:
            first.append(jax.tree_util.tree_map(np.asarray, state.params))
        return state, ls

    loader = ListLoader(batches)
    state = jtu.train_model(recorded, state, loader,
                            lambda b: jts.dense_batch_from_collated(b, N_CAP), 2,
                            str(tmp_path_factory.mktemp("jax_ckpt")))
    final = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                "batch_stats": state.batch_stats})
    return init, losses, loader.epochs, first[0], final


def test_two_epochs_of_train_model_equal_jax(jax_loop, tmp_path):
    init, ref, jax_epochs, jax_first, _ = jax_loop
    cfg = loop_cfg()
    loader = ListLoader([collated(0), collated(1)])
    model = tbuild(centerpoint_cfg(), RUNTIME, device="cpu")
    model.load_state_dict(detector_params_from_flax(init), strict=True)
    make_opt, sched = topt.build_optimizer(cfg, len(loader), 2)
    state = tts.init_train_state(model, make_opt, device="cpu")
    history = []

    def first_update_check(state, batch):
        """After the first update every entry equals JAX's to 1e-5 but for
        at most 100 that Adam moved the other way (at most 2 lr apart)."""
        state, losses = step(state, batch)
        if state.step == 1:
            ref = detector_params_from_flax({"params": jax_first})
            lr, flipped = float(sched(0)), 0
            for name, p in state.model.named_parameters():
                d = (p.detach() - ref[name]).abs()
                assert float(d.max()) <= 2.1 * lr, name
                flipped += int((d > 1e-5).sum())
            print(f"entries that moved differently in the first update: {flipped}")
            assert flipped <= 100
        return state, losses

    step = tts.make_train_step(loss_key="center_loss", device="cpu")
    state = ttu.train_model(first_update_check, state,
                            loader, lambda b: tts.dense_batch_from_collated(b, N_CAP), 2,
                            str(tmp_path), history=history)
    assert loader.epochs == jax_epochs == [0, 1]
    assert [h["epoch"] for h in history] == [0, 0, 1, 1] and state.step == 4
    assert [h["lr"] for h in history] == [float(sched(i)) for i in range(4)]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint_epoch_1",
                                                          "checkpoint_epoch_2"]
    bounds = [(1e-5, 1e-5), (1e-4, 4e-3), (2.5e-2, 1e-1)]  # (losses, grad_norm) a step
    for i, (h, r) in enumerate(zip(history, ref)):
        errs = {k: abs(h["losses"][k] / r[k] - 1) for k in ("center_loss", "hm_loss", "loc_loss",
                                                            "grad_norm")}
        print(f"step {i + 1}: relative errors {errs}")
        if i < len(bounds):
            loss_bound, norm_bound = bounds[i]
            assert errs.pop("grad_norm") <= norm_bound, (i, h, r)
            assert max(errs.values()) <= loss_bound, (i, errs)
    assert max(r["grad_norm"] for r in ref) > float(cfg.GRAD_NORM_CLIP)  # the clip acted


def test_predict_after_train_model_equals_jax(jax_loop):
    """The eval-mode forward with the running statistics that two epochs
    left (JAX's final parameters and batch_stats carried into the port):
    predict on a third batch gives JAX's top-k boxes, scores and labels."""
    final = jax_loop[4]
    dense = jts.dense_batch_from_collated(collated(2), N_CAP)
    model = jbuild(centerpoint_cfg(), RUNTIME)
    jflat = jts._flatten_local(*(jnp.asarray(dense[k]) for k in ("points", "feats", "valid",
                                                                  "gt_boxes")))
    bs = jflat.pop("batch_size")
    want = jax.jit(lambda v, a: model.apply(v, {**a, "batch_size": bs}, method="predict")[1:])(
        final, jflat)
    tmodel = tbuild(centerpoint_cfg(), RUNTIME, device="cpu")
    tmodel.load_state_dict(detector_params_from_flax(final), strict=True)
    got = tmodel.predict(tts._flatten_local(**tts._to_device(dense, torch.device("cpu"))))[1:]
    boxes, scores, labels, valid = (np.asarray(x) for x in want)
    print(f"boxes: max |JAX| {np.abs(boxes).max():.3g}, max error "
          f"{np.abs(got[0].numpy() - boxes).max():.3g}; {valid.sum()} valid")
    np.testing.assert_array_equal(got[2].numpy(), labels)
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), boxes, rtol=1e-4, atol=1e-4)
