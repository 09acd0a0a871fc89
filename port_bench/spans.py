"""Per-layer device time of a training step, from CUDA events that the
benchmark's own hooks place at the program's module boundaries; no
synchronize goes between layers.

The forward: a forward pre-hook on each spanned module records an event and
opens that module's layer; the layer stays open until the next spanned
module opens, so the work between modules (the loss after the dense head,
the RoI stage's proposal layer) goes to the layer that came before it.

The backward: a forward hook on each spanned module puts one gradient hook
on each tensor the module returns (those that need a gradient and were not
among its inputs). The engine runs that hook when the gradient of the
module's output is ready, which is where the module's backward begins: it
records an event and opens the module's layer. The backward of a module
ends where the next one begins, since a module's input is the output of
the module before it. The optimizer's update is its own layer
(``optimizer``), and whatever comes before the first spanned module is
``other``.

With the events read after the window, a layer's time is the sum of the
intervals from each of its openings to the next event.
"""

from __future__ import annotations

import torch

OTHER, OPTIMIZER = "other", "optimizer"


def _tensors(obj, depth=4):
    """The tensors in ``obj``: a tensor, or dicts, lists and tuples of them
    (the batch dictionary, a sparse tensor's fields)."""
    if torch.is_tensor(obj):
        yield obj
    elif depth and isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, depth - 1)
    elif depth and isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, depth - 1)


class LayerSpans:
    """Hooks on ``model``'s children named in ``module_layers`` (module
    attribute -> layer), and on ``optimizer.step``. ``begin_step`` /
    ``end_step`` bracket each step; ``read()`` synchronizes and returns the
    mean ms a step of each layer."""

    def __init__(self, model, module_layers, optimizer):
        self.optimizer = optimizer
        self.steps, self.events, self.inputs = [], [], []
        self.open = None
        self.handles = []
        for attr, layer in module_layers.items():
            mod = getattr(model, attr, None)
            if mod is not None:
                self.handles.append(mod.register_forward_pre_hook(self._pre(layer)))
                self.handles.append(mod.register_forward_hook(self._post(layer)))
        self._step = optimizer.step
        optimizer.step = self._optimizer_step

    def _record(self, layer):
        if layer != self.open:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append((layer, ev))
            self.open = layer

    def _pre(self, layer):
        def hook(module, args):
            self._record(layer)
            self.inputs.append(list(_tensors(args)))  # held, so that no id is reused
        return hook

    def _post(self, layer):
        def hook(module, args, out):
            seen = {id(t) for t in self.inputs.pop()}
            for t in _tensors(out):
                if t.requires_grad and id(t) not in seen:
                    seen.add(id(t))
                    t.register_hook(lambda grad: self._record(layer))
        return hook

    def _optimizer_step(self, *a, **k):
        self._record(OPTIMIZER)
        return self._step(*a, **k)

    def begin_step(self):
        self.events, self.inputs, self.open = [], [], None
        self._record(OTHER)

    def end_step(self):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.steps.append(self.events + [(None, end)])
        self.events = []

    def read(self):
        torch.cuda.synchronize()
        total = {}
        for evs in self.steps:
            for (layer, a), (_, b) in zip(evs, evs[1:]):
                total[layer] = total.get(layer, 0.0) + a.elapsed_time(b)
        n = max(len(self.steps), 1)
        return {k: v / n for k, v in total.items()}

    def close(self):
        for h in self.handles:
            h.remove()
        self.optimizer.step = self._step
