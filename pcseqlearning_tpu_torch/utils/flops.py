"""Matmul and convolution FLOPs of one call, counted at dispatch to the JAX
package's definition (pcseqlearning_tpu.utils.flops.analytic_flops, which
walks the jaxpr: 2 * prod(output) * contraction size for every
``dot_general`` and ``conv_general_dilated``, forward, backward and
optimizer alike).

``analytic_flops(fn, *args, **kwargs)`` runs ``fn`` once under
``AnalyticFlopCounter``, a ``TorchDispatchMode`` that charges the products
it sees:

- ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot``:
  2 * M * N * K (times the batch); a bias or beta term is not counted;
- ``convolution``: 2 * output elements * (input channels / groups) *
  kernel elements, the output being a transposed convolution's large one,
  as XLA's lhs-dilated convolution is;
- ``convolution_backward``, each gradient it computes as XLA's transposed
  convolution: the input's as 2 * input elements * (output channels /
  groups) * kernel elements (at stride s that is s^2 times the forward's
  count per spatial axis pair, where torch's own FlopCounterMode charges the
  forward's count again), the weight's as 2 * weight elements * batch *
  output spatial elements / groups (XLA's batch_group_count division).

Two differences from the jaxpr walk remain. The count here sees every trip
of a loop; the jaxpr walk multiplies a ``scan`` by its length but charges
one body of a ``while_loop``. And it counts what ran: a product that JAX
traces but whose value nothing uses is not executed here.
"""

from __future__ import annotations

from collections import Counter
from math import prod

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def _mm(args, kwargs, out):
    return 2 * out.numel() * args[0].shape[-1]


def _addmm(args, kwargs, out):
    return 2 * out.numel() * args[1].shape[-1]


def _dot(args, kwargs, out):
    return 2 * args[0].numel()


def _convolution(args, kwargs, out):
    x, w = args[0], args[1]
    transposed, groups = bool(args[6]), int(args[8])
    cin_per_group = w.shape[0] // groups if transposed else w.shape[1]
    return 2 * out.numel() * cin_per_group * prod(w.shape[2:])


def _convolution_backward(args, kwargs, out):
    grad_out, x, w = args[0], args[1], args[2]
    transposed, groups, mask = bool(args[7]), int(args[9]), args[10]
    k = prod(w.shape[2:])
    total = 0
    if mask[0]:  # the input's gradient: a convolution back to the input's shape
        cout_per_group = w.shape[1] if transposed else w.shape[0] // groups
        total += 2 * x.numel() * cout_per_group * k
    if mask[1]:  # the weight's: contracts over the batch and the output's positions
        total += 2 * w.numel() * grad_out.shape[0] * prod(grad_out.shape[2:]) // groups
    return total


_COUNTERS = {
    aten.mm: _mm, aten.bmm: _mm, aten.mv: _mm,
    aten.addmm: _addmm, aten.baddbmm: _addmm, aten.addmv: _addmm,
    aten.dot: _dot, aten.vdot: _dot,
    aten.convolution: _convolution,
    aten.convolution_backward: _convolution_backward,
}


class AnalyticFlopCounter(TorchDispatchMode):
    """Counts the FLOPs of the products dispatched inside the block:
    ``total``, and by operator name ``by_op``."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = _COUNTERS.get(func.overloadpacket)
        if count is not None:
            n = int(count(args, kwargs, out))
            self.total += n
            self.by_op[func.overloadpacket.__name__] += n
        return out


def analytic_flops(fn, *args, **kwargs):
    """Matmul and convolution FLOPs of one call of ``fn(*args, **kwargs)``
    (a train step: forward, backward and optimizer). The call runs."""
    with AnalyticFlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total
