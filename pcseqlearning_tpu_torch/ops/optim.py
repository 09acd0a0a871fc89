"""The Adam and AdamW steps of ``optax.adam`` / ``optax.adamw`` with their
defaults, written out.

The JAX package runs three optimizer loops: the ground height field and the
tracking velocity smoothing with ``optax.adamw`` inside ``lax.while_loop``,
and the GD registration solver with ``optax.adam`` (constant rate, no weight
decay) inside ``lax.fori_loop``. The port keeps optax's exact update order:
moments, bias correction ``1 - b**t`` in float32,
``m_hat / (sqrt(v_hat + eps_root) + eps)`` (the square root rounded to
nearest, as NumPy's), then (AdamW only)
``+ weight_decay * params``, then ``* -lr(count)`` with the schedule read at
the pre-increment count. It also keeps JAX's gradient of ``|x|``, which is
+1 at 0 (``sign`` would give 0), so the losses' gradients are written by
hand in the callers.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import sqrt_rn

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def abs_grad(x):
    """d|x|/dx as JAX defines it: +1 where x >= 0, else -1."""
    return torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))


def multistep_lr(lr, step, decay_steps):
    """lr * 0.1 ** (number of decay steps <= step), in float32."""
    mult = np.float32(1.0)
    for d in decay_steps:
        if step >= d:
            mult = mult * np.float32(0.1)
    return float(np.float32(lr) * mult)


class AdamW:
    """State of one optax.adamw(learning_rate=schedule) instance."""

    weight_decay = WEIGHT_DECAY

    def __init__(self, params):
        self.mu = torch.zeros_like(params)
        self.nu = torch.zeros_like(params)
        self.count = 0

    def step(self, params, grad, lr):
        """Return the updated params for gradient ``grad`` at rate ``lr``."""
        self.mu = (1 - B1) * grad + B1 * self.mu
        self.nu = (1 - B2) * (grad * grad) + B2 * self.nu
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(B1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(B2) ** c)
        upd = (self.mu / bc1) / (sqrt_rn(self.nu / bc2) + EPS)
        if self.weight_decay:
            upd = upd + self.weight_decay * params
        return params + float(np.float32(-lr)) * upd


class Adam(AdamW):
    """State of one optax.adam(learning_rate) instance: AdamW's step
    without the weight decay."""

    weight_decay = 0.0
