"""The port's schedules and clipped optimizers against the JAX package's
``runtime.optimization`` (optax).

Schedules: for each of the 17 files under tools/cfgs/optimizers/, the
port's rate equals optax's schedule (run as the train step runs it: jitted,
on an int32 count) at every count of 10 iterations x NUM_EPOCHS (capped at
60 epochs), step boundaries included, to 2.5e-7 relative: the warmup and
step parts bit for bit, the cosine part within XLA's own rounding of its
float32 cosine, which the port cannot reproduce (at most 2.38e-7 measured,
two float32 roundings; XLA's eager and jitted evaluations of one optax
schedule differ by up to 3e-7 among themselves). Updates: 20 updates of
the port's optimizer on a fixed sequence of random gradients, some with
global norms above GRAD_NORM_CLIP (the test prints which), equal
``tx.update`` + ``optax.apply_updates`` to 1e-6 absolute after every
update.
"""

import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcseqlearning_tpu.runtime.optimization import build_optimizer as j_build
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.runtime.optimization import build_optimizer as t_build
from pcseqlearning_tpu_torch.runtime.optimization import global_norm
from pcseqlearning_tpu_torch.utils.edict import EDict

torch.set_num_threads(1)
OPTIMIZERS = sorted(glob.glob("tools/cfgs/optimizers/*.yaml"))
ITERS = 10


def optim_cfg(path):
    return cfg_from_yaml_file(path, EDict()).OPTIMIZATION


def test_all_seventeen_files_are_covered():
    assert len(OPTIMIZERS) == 17


@pytest.mark.parametrize("path", OPTIMIZERS, ids=lambda p: Path(p).stem)
def test_schedule_equals_optax(path):
    cfg = optim_cfg(path)
    epochs = min(int(cfg.NUM_EPOCHS), 60)
    _, jsched = j_build(dict(cfg), ITERS, epochs)
    _, tsched = t_build(cfg, ITERS, epochs)
    counts = np.arange(ITERS * epochs + 1, dtype=np.int32)
    if isinstance(jsched(0), float):  # the constant schedule
        want = np.full(len(counts), jsched(0), np.float32)
    else:
        want = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(counts)))
    got = np.asarray([tsched(int(c)) for c in counts], np.float32)
    rel = np.abs(got - want) / np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    print(f"{Path(path).stem}: {int((got != want).sum())} of {len(got)} rates not bit-equal, "
          f"largest relative error {float(rel.max()):.3g}")
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert got[0] == want[0]  # the first update's rate
    for b in [int(s * ITERS) for s in cfg.get("DECAY_STEP_LIST", [])]:
        if b <= counts[-1]:  # the rate scales at the boundary, not after it
            assert got[b] == np.float32(got[b - 1] * np.float32(cfg.LR_DECAY))


CASES = {
    "onecycle_centerpoint": "tools/cfgs/optimizers/onecycle_centerpoint.yaml",
    "adam_onecycle": "tools/cfgs/optimizers/adam_onecycle.yaml",
    "adamW_stepwise": "tools/cfgs/optimizers/adamW_stepwise.yaml",
    "sgd": None,
}
# gradient scales of the 20 updates: the norms of the scaled gradients
# straddle GRAD_NORM_CLIP (10)
SCALES = [0.5, 8.0, 20.0, 0.1, 3.0, 50.0, 1.0, 2.0, 0.01, 15.0] * 2


def make_grads(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * sc).astype(np.float32) for k, s in shapes.items()}
             for sc in SCALES]
    return params, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_equal_optax(case):
    cfg = (optim_cfg(CASES[case]) if CASES[case] else
           EDict(OPTIMIZER="sgd", LR=0.01, MOMENTUM=0.9, DECAY_STEP_LIST=[1], LR_DECAY=0.5,
                 GRAD_NORM_CLIP=10))
    params, grads = make_grads()
    tx, _ = j_build(dict(cfg), 10, 2)
    make_opt, tsched = t_build(cfg, 10, 2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v).clone()) for k, v in params.items()}
    opt = make_opt(list(tp.values()))
    clipped = []
    for i, g in enumerate(grads):
        norm = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())))
        clipped.append(norm >= float(cfg.GRAD_NORM_CLIP))
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k]).clone()
        opt.step()
        assert opt.last_lr == float(tsched(i)) and opt.count == i + 1
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=f"update {i} {k}")
    print(f"{case}: updates whose gradient norm reached the clip: "
          f"{[i for i, c in enumerate(clipped) if c]}")
    assert any(clipped) and not all(clipped)


def test_clip_is_optax_not_torch():
    """Above the limit the gradients become g / norm * limit (optax), which
    differs from torch.nn.utils.clip_grad_norm_'s g * (limit / (norm +
    1e-6)); below it they are kept as they are."""
    g = torch.tensor([3.0, 4.0, 12.0])  # norm 13
    w = torch.nn.Parameter(torch.zeros(3))
    make_opt, _ = t_build(EDict(OPTIMIZER="sgd", LR=1.0, MOMENTUM=0.0, GRAD_NORM_CLIP=10), 1, 1)
    opt = make_opt([w])
    w.grad = g.clone()
    opt.step()
    assert torch.equal(w.detach(), -(g / global_norm([g]) * 10.0))
    w2 = torch.nn.Parameter(torch.zeros(3))
    w2.grad = g * 0.5  # norm 6.5: kept
    opt2 = make_opt([w2])
    opt2.step()
    assert torch.equal(w2.detach(), -(g * 0.5))


def test_count_starts_at_zero_and_resumes():
    """The first update uses sched(0); a state_dict carries the count, so a
    fresh optimizer loaded from it goes on at sched(count)."""
    cfg = optim_cfg("tools/cfgs/optimizers/onecycle_centerpoint.yaml")
    make_opt, sched = t_build(cfg, 4, 3)
    params, grads = make_grads(1)
    tp = [torch.nn.Parameter(torch.as_tensor(v).clone()) for v in params.values()]
    opt = make_opt(tp)
    assert opt.lr() == float(sched(0))
    for g in grads[:5]:
        for p, v in zip(tp, g.values()):
            p.grad = torch.as_tensor(v).clone()
        opt.step()
    assert opt.count == 5 and opt.last_lr == float(sched(4))
    again = make_opt([torch.nn.Parameter(p.detach().clone()) for p in tp])
    again.load_state_dict(opt.state_dict())
    assert again.count == 5 and again.lr() == float(sched(5))
    for k, ts in opt.moments.items():
        assert all(torch.equal(a, b) for a, b in zip(ts, again.moments[k]))
    with pytest.raises(ValueError, match="adamw"):
        t_build(EDict(OPTIMIZER="adam"), 1, 1)[0](tp).load_state_dict(opt.state_dict())
    with pytest.raises(KeyError):
        t_build(EDict(OPTIMIZER="lamb"), 1, 1)
