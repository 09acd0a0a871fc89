"""The AdamW step of ``optax.adamw`` with its defaults, written out.

The JAX package runs two optimizer loops (the ground height field and the
tracking velocity smoothing) with ``optax.adamw`` inside ``lax.while_loop``.
The port keeps optax's exact update order: moments, bias correction
``1 - b**t`` in float32, ``m_hat / (sqrt(v_hat + eps_root) + eps)``, then
``+ weight_decay * params``, then ``* -lr(count)`` with the schedule read at
the pre-increment count. It also keeps JAX's gradient of ``|x|``, which is
+1 at 0 (``sign`` would give 0), so the losses' gradients are written by
hand in the callers.
"""

from __future__ import annotations

import numpy as np
import torch

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
        upd = (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + EPS)
        upd = upd + WEIGHT_DECAY * params
        return params + float(np.float32(-lr)) * upd
