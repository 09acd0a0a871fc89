"""Velocity smoothing of the tracking walk (counterpart of
pcseqlearning_tpu.preprocessing.tracking_device; of that module only
``_smooth_velos`` is on the batched walk's path).
"""

from __future__ import annotations

import torch

from ..ops.optim import AdamW, abs_grad, multistep_lr


def _smooth_velos(velos, diffs, active, num_itr=300, stopping=1e-3, weight0=1.0,
                  weight=10.0):
    """AdamW velocity smoothing over the active span: L2 fit of xy velocities
    to the center differences plus an L1 temporal-smoothness term, MultiStep
    decay at 100/200/300 steps, early-stop countdown. Frames outside the
    span keep their values."""
    dev = velos.device
    act = active.to(velos.dtype)[None, :, None]
    pair_act = (active[:-1] & active[1:]).to(velos.dtype)[None, :, None]
    Cn = velos.shape[0]
    n_act = torch.clamp(act.sum() * 2.0, min=1.0) * Cn
    n_pair = torch.clamp(pair_act.sum() * 2.0, min=1.0) * Cn
    v = velos
    opt = AdamW(v)
    stop = torch.tensor(stopping, dtype=torch.float32, device=dev)
    last = torch.tensor(1e10, dtype=velos.dtype, device=dev)
    cd, it = 3, 0
    while cd > 0 and it < num_itr:
        r = (v - diffs)[..., :2] * act
        e = (v[:, :-1, :2] - v[:, 1:, :2]) * pair_act
        loss = (r * r).sum() / n_act * weight0 + e.abs().sum() / n_pair * weight
        g = torch.zeros_like(v)
        g[..., :2] = (2.0 * weight0) * r * act / n_act
        ge = weight * abs_grad(e) * pair_act / n_pair
        g[:, :-1, :2] += ge
        g[:, 1:, :2] -= ge
        v = opt.step(v, g, multistep_lr(1e-2, it, (100, 200, 300)))
        cd = cd - 1 if bool(last - loss < stop) else 3
        last = loss
        it += 1
    return torch.where(active[None, :, None], v, velos)
