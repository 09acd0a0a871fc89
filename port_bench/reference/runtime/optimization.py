"""Optimizers and learning-rate schedules (counterpart of
pcseqlearning_tpu.runtime.optimization, which builds them from optax).

The schedules are plain functions of the update count that return optax's
values in float32, with the operations in the order in which XLA evaluates
optax's schedules in the jitted step on the CPU (the reference's platform):
constants folded (``count / T`` as ``count * (1 / T)``, ``pi * count / T``
as ``count * (pi * (1 / T))``, ``0.5 * (1 + cos) * (1 - alpha)`` as ``(1 +
cos) * (0.5 * (1 - alpha))``) and a multiply-add fused where XLA fuses one.
The linear and step parts then equal optax's bit for bit; the cosine part
is within XLA's rounding of its float32 cosine (2.4e-7 relative at most
over the repo's optimizer configs). The schedules:

- one-cycle (any OPTIMIZER or SCHEDULER naming "onecycle"): a linear warmup
  from ``LR / DIV_FACTOR`` to ``LR`` over ``int(max(total * PCT_START, 1))``
  updates, then ``optax.cosine_decay_schedule(LR, total - warmup,
  alpha=1e-4)``. The JAX package ignores MOMS and LR_CLIP, and so does the
  port: there is no momentum annealing.
- step: ``LR`` times ``LR_DECAY`` for each DECAY_STEP_LIST epoch boundary
  that the count has reached (``count >= boundary``, as
  ``optax.piecewise_constant_schedule``). An empty list falls through to
  WARMUP_EPOCH (``optax.warmup_cosine_decay_schedule`` from ``LR / 3``),
  else to the constant ``LR``.

``build_optimizer`` returns ``(make_optimizer, schedule)``;
``make_optimizer(params)`` is a ``ClippedOptimizer``, the update of
``optax.chain(optax.clip_by_global_norm(GRAD_NORM_CLIP), core)`` with core
``adam``, ``adamw`` (weight decay on every parameter, no mask) or ``sgd``
(momentum trace) at ``lr = schedule(count)``. Two traps it keeps:

- optax's clip keeps the gradients when their global norm is below the
  limit and otherwise takes ``g / norm * limit``
  (``torch.nn.utils.clip_grad_norm_`` multiplies by ``limit / (norm +
  1e-6)``);
- the count starts at 0: the first update uses ``schedule(0)``. The
  optimizer reads its own count before each update and carries it in its
  ``state_dict``, so a resumed run goes on with the schedule where it
  stopped.

The Adam update is written out with optax's order of operations (as
``ops.optim`` does for the ground and walk loops): the moments, bias
corrections ``1 - b ** count`` in float32, ``m_hat / (sqrt(v_hat) + eps)``,
then ``+ weight_decay * p``, then ``* -lr``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.edict import EDict

F32 = np.float32


def _fma(a, b, c):
    """a * b + c in float32 with one rounding (the product of two float32s
    is exact in float64)."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _linear(init_value, end_value, transition_steps):
    """optax.linear_schedule."""
    if transition_steps <= 0:
        return lambda count: init_value
    recip = F32(1.0 / transition_steps)

    def schedule(count):
        frac = _fma(-F32(min(max(count, 0), transition_steps)), recip, F32(1))
        return _fma(F32(init_value - end_value), frac, F32(end_value))

    return schedule


def _cosine_decay(init_value, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")
    angle = F32(F32(math.pi) * F32(1.0 / float(decay_steps)))
    half = F32(F32(0.5) * F32(1 - alpha))

    def schedule(count):
        cosine = F32(np.cos(np.float64(F32(F32(min(count, decay_steps)) * angle))))
        return F32(_fma(F32(1) + cosine, half, F32(alpha)) * F32(init_value))

    return schedule


def _join(schedules, boundaries):
    """optax.join_schedules."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def build_onecycle_schedule(lr, total_steps, pct_start=0.4, div_factor=10.0):
    """Linear warmup lr / div -> lr over pct_start of the updates, then a
    cosine decay lr -> lr * 1e-4."""
    warm = int(max(total_steps * pct_start, 1))
    return _join([_linear(lr / div_factor, lr, warm),
                  _cosine_decay(lr, max(total_steps - warm, 1), alpha=1e-4)], [warm])


def build_step_schedule(lr, decay_steps, decay=0.1):
    """lr, times ``decay`` at each boundary the count has reached."""
    bounds = sorted({int(s): decay for s in decay_steps}.items())

    def schedule(count):
        v = F32(lr)
        for threshold, scale in bounds:
            if count >= threshold:
                v = F32(scale) * v
        return v

    return schedule


def build_cosine_warmup_schedule(lr, total_steps, warmup_steps):
    """optax.warmup_cosine_decay_schedule from lr / 3 to lr, then down to
    lr * 1e-4."""
    warmup_steps, decay_steps = max(warmup_steps, 1), max(total_steps, 2)
    alpha = 0.0 if lr == 0.0 else lr * 1e-4 / lr
    return _join([_linear(lr / 3.0, lr, warmup_steps),
                  _cosine_decay(lr, decay_steps - warmup_steps, alpha=alpha)], [warmup_steps])


def build_scheduler(optim_cfg, total_iters_each_epoch, total_epochs):
    cfg = EDict(optim_cfg)
    total_steps = max(total_iters_each_epoch * total_epochs, 1)
    lr = float(cfg.get("LR", 1e-3))
    name = cfg.get("SCHEDULER", None) or cfg.get("OPTIMIZER", "adam_onecycle")
    if "onecycle" in str(name).lower() or cfg.get("ONECYCLE", False):
        return build_onecycle_schedule(lr, total_steps,
                                       pct_start=float(cfg.get("PCT_START", 0.4)),
                                       div_factor=float(cfg.get("DIV_FACTOR", 10)))
    if cfg.get("DECAY_STEP_LIST", None):
        steps = [int(s * total_iters_each_epoch) for s in cfg["DECAY_STEP_LIST"]]
        return build_step_schedule(lr, steps, float(cfg.get("LR_DECAY", 0.1)))
    if cfg.get("WARMUP_EPOCH", None):
        return build_cosine_warmup_schedule(
            lr, total_steps, int(cfg["WARMUP_EPOCH"] * total_iters_each_epoch))
    return lambda step: lr


def global_norm(tensors):
    """optax.global_norm: the L2 norm of all entries of ``tensors``."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


class ClippedOptimizer:
    """``optax.chain(clip_by_global_norm(max_norm), core)`` over a fixed list
    of parameters, with ``zero_grad`` / ``step`` / ``state_dict`` /
    ``load_state_dict`` as a torch optimizer has them. ``kind`` is "adam",
    "adamw" or "sgd". A parameter without a gradient takes a zero one, as
    every JAX parameter has a gradient. ``last_lr`` is the rate the last
    update used."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, kind, schedule, max_norm, weight_decay=0.0, momentum=0.9):
        if kind not in ("adam", "adamw", "sgd"):
            raise KeyError(kind)
        self.params = list(params)
        self.kind = kind
        self.schedule = schedule
        self.max_norm = float(max_norm)
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.count = 0
        self.last_lr = None
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format)  # noqa: E731
                         for p in self.params]
        self.moments = {"trace": zeros()} if kind == "sgd" else {"mu": zeros(), "nu": zeros()}

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def lr(self):
        """The rate of the next update: schedule(count)."""
        return float(self.schedule(self.count))

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = global_norm(grads)
        if not bool(norm < self.max_norm):
            grads = [g / norm * self.max_norm for g in grads]
        lr = self.lr()
        if self.kind == "sgd":
            trace = self.moments["trace"]
            updates = torch._foreach_add(grads, torch._foreach_mul(trace, self.momentum))
            self.moments["trace"] = updates
        else:
            b1, b2 = self.B1, self.B2
            mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                    torch._foreach_mul(self.moments["mu"], b1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                    torch._foreach_mul(self.moments["nu"], b2))
            self.moments = {"mu": mu, "nu": nu}
            c = F32(self.count + 1)
            bc1 = float(F32(1) - F32(b1) ** c)
            bc2 = float(F32(1) - F32(b2) ** c)
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.EPS)
            updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if self.kind == "adamw":
                updates = torch._foreach_add(updates,
                                             torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(updates, float(F32(-lr))))
        self.count += 1
        self.last_lr = lr

    def state_dict(self):
        return {"count": self.count, "kind": self.kind,
                "moments": {k: [t.clone() for t in v] for k, v in self.moments.items()}}

    def load_state_dict(self, state):
        if state["kind"] != self.kind or set(state["moments"]) != set(self.moments):
            raise ValueError(f"optimizer state of {state['kind']!r} loaded into {self.kind!r}")
        for k, ts in state["moments"].items():
            if len(ts) != len(self.moments[k]):
                raise ValueError(f"optimizer state holds {len(ts)} {k} tensors, the optimizer "
                                 f"{len(self.moments[k])}")
            self.moments[k] = [t.to(m.device, m.dtype).clone()
                               for t, m in zip(ts, self.moments[k])]
        self.count = int(state["count"])


def build_optimizer(optim_cfg, total_iters_each_epoch=1000, total_epochs=30):
    """(make_optimizer, schedule): ``make_optimizer(params)`` builds the
    clipped optimizer of OPTIMIZER (adam / adam_onecycle, adamW /
    adamW_onecycle, sgd) over ``params``."""
    cfg = EDict(optim_cfg)
    name = cfg.get("OPTIMIZER", "adam_onecycle")
    kinds = {"adam": "adam", "adam_onecycle": "adam", "adamW": "adamw", "adamw": "adamw",
             "adamW_onecycle": "adamw", "adamw_onecycle": "adamw", "sgd": "sgd"}
    if name not in kinds:
        raise KeyError(name)
    sched = build_scheduler(cfg, total_iters_each_epoch, total_epochs)

    def make_optimizer(params):
        return ClippedOptimizer(params, kinds[name], sched, float(cfg.get("GRAD_NORM_CLIP", 10.0)),
                                weight_decay=float(cfg.get("WEIGHT_DECAY", 0.01)),
                                momentum=float(cfg.get("MOMENTUM", 0.9)))

    return make_optimizer, sched
