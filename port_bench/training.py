"""The training side of a cell: the program's train state and step, built as
``pcseqlearning_tpu_torch.train`` builds them from the benchmark's weights;
the readings of its first steps; the plain reference's readings of the same
steps; and ``compare``, which turns the two into the numbers a cell holds
to its limits.

A training cell's set-up drives the program's one state through its first
``CHECK_STEPS`` steps on the pool's first batches. Those steps warm up every
shape the window uses, and their readings (each step's loss, the first
gradient as the optimizer got it, the parameters' and batch-norm
statistics' change after the last) are kept. Once the window has closed
and the program's state is freed, the reference (``reference/``) runs the
same steps from the same weights in float64.
"""

from __future__ import annotations

import math
import statistics

import torch

from . import harness
from . import reference as ref

CHECK_STEPS = 3
# a run's faults, for the check that a broken program reads not correct
FAULTS = ("frozen_state", "half_batch")
BN_STATS = ("running_mean", "running_var")


def batch_of(pool, i):
    i %= pool["points"].shape[0]
    return {k: pool[k][i] for k in ("points", "feats", "valid", "gt_boxes")}


# ---------------------------------------------------------------- readings

class Readings:
    """What the first steps of one side give: each step's loss, the first
    gradient's norm by leaf as the optimizer got it, and after the last
    step the change's norm by leaf of the parameters and of the batch
    norms' running statistics."""

    def __init__(self, net, opt, key):
        self.net, self.opt, self.key = net, opt, key
        self.losses, self.grad, self.change, self.bn, self.first = [], {}, {}, {}, {}
        self.p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
        self.b0 = {n: b.detach().clone() for n, b in net.named_buffers()
                   if n.rsplit(".", 1)[-1] in BN_STATS}

    def after_step(self, losses):
        """``losses``: the step's losses by name, read to the host."""
        self.losses.append(float(losses[self.key]))
        if len(self.losses) == 1:
            self.first = dict(losses)
        names = [n for n, _ in self.net.named_parameters()]
        if len(self.losses) == 1:  # Adam's first moment after one update: (1 - b1) g
            b1 = self.opt.B1
            self.grad = {n: float(m.double().norm()) / (1 - b1)
                         for n, m in zip(names, self.opt.moments["mu"])}
        if len(self.losses) == CHECK_STEPS:
            self.change = {n: float((p.detach().double() - self.p0[n].double()).norm())
                           for n, p in self.net.named_parameters()}
            bufs = dict(self.net.named_buffers())
            self.bn = {n: float((bufs[n].double() - b0.double()).norm())
                       for n, b0 in self.b0.items()}
            self.p0 = self.b0 = self.net = self.opt = None

    def summary(self):
        return dict(losses=self.losses, first=self.first, grad=self.grad, change=self.change,
                    bn=self.bn)


def _gaps(prog, ref_, names):
    """Each leaf's gap of norms, relative to the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    if not names:
        return {}
    med = statistics.median(ref_[n] for n in names)
    return {n: abs(prog[n] - ref_[n]) / max(ref_[n], med) for n in names}


def compare(prog, ref_, detail=False, names=()):
    """The numbers a cell may hold to a limit (its limits file names the
    ones it does): ``loss`` (the worst step's gap relative to the
    reference's loss) and ``loss1`` (the first step's); ``grad`` and
    ``grad_median`` (the worst and the median leaf's gap of first-gradient
    norms); ``change`` and ``change_median`` (the same of the change's norms
    after the last step, over the leaves the reference's first gradient
    moves: at least a thousandth of the median leaf's); ``bn_stats`` and
    ``bn_median`` (the same of the batch norms' running statistics). A name
    ``loss1.<loss>`` in ``names`` is the first step's gap of that one of the
    losses. With ``detail``, also the worst leaf of each under ``worst``
    and the numbers of each top-level module under ``modules``."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref_["losses"])]
    leaves = sorted(ref_["grad"])
    med = statistics.median(ref_["grad"][n] for n in leaves)
    moved = [n for n in leaves if ref_["grad"][n] >= 1e-3 * med]

    def numbers(keep):
        gaps = {"grad": _gaps(prog["grad"], ref_["grad"], [n for n in leaves if keep(n)]),
                "change": _gaps(prog["change"], ref_["change"], [n for n in moved if keep(n)]),
                "bn_stats": _gaps(prog["bn"], ref_["bn"], [n for n in sorted(ref_["bn"])
                                                            if keep(n)])}
        out = {}
        for k, g in gaps.items():
            out[k] = max(g.values(), default=0.0)
            out[k.split("_")[0] + "_median"] = statistics.median(g.values()) if g else 0.0
        return out, gaps

    out, gaps = numbers(lambda n: True)
    out = {"loss": max(loss), "loss1": loss[0], **out}
    for name in names:
        if name.startswith("loss1."):  # one loss of the first step, by its name
            part = name.split(".", 1)[1]
            out[name] = abs(prog["first"][part] - ref_["first"][part]) / abs(ref_["first"][part])
    if detail:
        out["worst"] = {k: max(g, key=g.get) for k, g in gaps.items() if g}
        tops = sorted({n.split(".", 1)[0] for n in leaves})
        out["modules"] = {t: numbers(lambda n, t=t: n.startswith(t + "."))[0] for t in tops}
    return out


# ---------------------------------------------------------------- the program

class Program:
    """The program's training state and step, built as
    ``pcseqlearning_tpu_torch.train`` builds them, from the benchmark's
    weights."""

    def __init__(self, cell, weights_seed, device, fault=None):
        from pcseqlearning_tpu_torch.models import build_network
        from pcseqlearning_tpu_torch.parallel.train_step import init_train_state, make_train_step
        from pcseqlearning_tpu_torch.runtime.optimization import build_optimizer
        from pcseqlearning_tpu_torch.train import loss_key_for, runtime_cfg_of
        from pcseqlearning_tpu_torch.utils.edict import EDict

        cfg = EDict({k: cell.config[k] for k in ("CLASS_NAMES", "MODEL", "DATA_CONFIG",
                                                 "OPTIMIZATION")})
        rt = runtime_cfg_of(cfg)
        rt["num_point_features"] = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
        net = build_network(cfg.MODEL, rt, device=device)
        self.weights = harness.make_weights(net, weights_seed, device)
        harness.load_weights(net, self.weights)
        sched = cell.config["schedule"]
        make_optimizer, _ = build_optimizer(cfg.OPTIMIZATION, int(sched["iters_per_epoch"]),
                                            int(sched["epochs"]))
        self.state = init_train_state(net, make_optimizer, device=device)
        self.loss_key = loss_key_for(cfg.MODEL)
        step = make_train_step(loss_key=self.loss_key, device=device)
        if fault == "frozen_state":  # a step that returns its state unchanged
            inner_frozen = step
            step = lambda state, batch: _unchanged(inner_frozen, state, batch)  # noqa: E731
        elif fault == "half_batch":  # half of the batch left out, the mean over the rest
            half = lambda b: {k: v[: max(v.shape[0] // 2, 1)] for k, v in b.items()}  # noqa: E731
            inner = step
            step = lambda state, batch: inner(state, half(batch))  # noqa: E731
        elif fault is not None:
            raise KeyError(fault)
        self.step = step
        self.nonfinite = 0

    def run_step(self, batch):
        """One step; its losses read to the host, as train_one_epoch does,
        by name."""
        self.state, losses = self.step(self.state, batch)
        losses = {k: float(v) for k, v in losses.items()}
        self.nonfinite += not all(math.isfinite(v) for v in losses.values())
        return losses

    def first_steps(self, pool):
        """The first ``CHECK_STEPS`` steps on the pool's first batches, and
        their readings."""
        r = Readings(self.state.model, self.state.optimizer, self.loss_key)
        for i in range(CHECK_STEPS):
            r.after_step(self.run_step(batch_of(pool, i)))
        return r


def _unchanged(step, state, batch):
    """``step``, with the state it was given put back afterwards: the
    parameters, the batch-norm statistics and the optimizer's moments and
    count."""
    net, opt = state.model, state.optimizer
    keep = [t.detach().clone() for t in list(net.parameters()) + list(net.buffers())]
    moments = {k: [t.clone() for t in v] for k, v in opt.moments.items()}
    count, n = opt.count, state.step
    state, losses = step(state, batch)
    with torch.no_grad():
        for t, k in zip(list(net.parameters()) + list(net.buffers()), keep):
            t.copy_(k)
    opt.moments, opt.count, state.step = moments, count, n
    return state, losses


def reference_readings(cell, weights, pool, device, dtype=torch.float64, tf32=False):
    """The reference's readings over the first steps from ``weights``."""
    harness.set_precision(tf32)
    try:
        net = ref.build(cell.config, dtype, device)
        harness.load_weights(net, weights)
        opt = ref.optimizer(cell.config, list(net.parameters()))
        key = ref.loss_key(cell.config["MODEL"])
        r = Readings(net, opt, key)
        for i in range(CHECK_STEPS):
            r.after_step(ref.train_step(net, opt, batch_of(pool, i), key))
        return r.summary()
    finally:
        harness.set_precision(False)


def control_readings(cell, weights, pool, device):
    """The control in the program's place: the reference in float32 with TF32
    on, the nearest precision below the configuration's."""
    return reference_readings(cell, weights, pool, device, dtype=torch.float32, tf32=True)
