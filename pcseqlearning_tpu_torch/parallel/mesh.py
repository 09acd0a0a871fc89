"""A device mesh and batch sharding (counterpart of
pcseqlearning_tpu.parallel.mesh).

The JAX mesh names the devices that one program is split over. Here a
``Mesh`` is a (dp, mp) array of ``torch.device``s that single-controller
code (``parallel.point_shard``) runs one piece of work on each of; a device
may appear several times (one card standing in for several, or CPU slots).
"""

from __future__ import annotations

import numpy as np
import torch

BATCH_AXIS_KEYS = ("point_bxyz", "point_feat", "point_valid", "gt_boxes")


class Mesh:
    """(dp, mp) devices, axis names "dp" and "mp"."""

    axis_names = ("dp", "mp")

    def __init__(self, devices, dp, mp):
        self.devices = np.empty((dp, mp), dtype=object)
        for i, d in enumerate(devices):
            self.devices[i // mp, i % mp] = torch.device(d)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis="dp"):
        """The devices along ``axis`` (index 0 of the other axis)."""
        return list(self.devices[:, 0] if axis == "dp" else self.devices[0, :])


def visible_devices():
    """The visible cards, as ``jax.devices()`` lists the accelerators."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, dp=None, mp=1):
    """A (dp, mp) mesh over ``devices`` (default: the visible cards); dp
    defaults to len(devices) // mp."""
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    if dp is None:
        dp = n // mp
    if dp * mp != n or n == 0:
        raise ValueError(f"a ({dp}, {mp}) mesh needs dp * mp devices, got {n}")
    return Mesh(devices, dp, mp)


def _to(tree, device):
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return torch.as_tensor(tree).to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def replicate(mesh, tree):
    """One copy of ``tree`` (nested dicts of arrays) on each mesh device, in
    the mesh's row-major order."""
    return [_to(tree, d) for d in mesh.devices.flat]


def rows_of(x, index, count):
    """Rows [index * B / count, (index + 1) * B / count) of the leading
    axis of ``x``; raises unless ``count`` divides B."""
    b = x.shape[0]
    if b % count:
        raise ValueError(f"a batch of {b} does not split into {count} equal shards")
    n = b // count
    return x[index * n:(index + 1) * n]


def shard_batch(mesh, batch, batch_axis_keys=BATCH_AXIS_KEYS):
    """The dp shards of ``batch``: shard i holds rows_of(v, i, dp) of every
    array under ``batch_axis_keys`` and the whole of every other array, on
    the mesh device (i, 0); other values pass through."""
    dp = mesh.shape["dp"]
    shards = []
    for i, dev in enumerate(mesh.axis_devices("dp")):
        shards.append({k: (_to(rows_of(v, i, dp), dev) if k in batch_axis_keys
                           and getattr(v, "ndim", 0) >= 1 else _to(v, dev))
                       for k, v in batch.items()})
    return shards
