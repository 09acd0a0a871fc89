"""Capacity bucketing (counterpart of pcseqlearning_tpu.utils.padding).

PyTorch runs eagerly and needs no shape buckets to bound recompiles; the
port keeps the same bucket ladder where a bucketed size changes results
(tile widths, candidate counts, per-frame table heights), so both packages
see identical shapes.
"""

from __future__ import annotations

import math

import numpy as np


def bucket_size(n, base=256, growth=1.5):
    """Smallest capacity >= n from the geometric bucket ladder."""
    if n <= base:
        return base
    k = math.ceil(math.log(n / base) / math.log(growth))
    return int(base * growth ** k + 0.5)


def pad_rows(arr, capacity, fill=0):
    """Pad axis 0 of ``arr`` to ``capacity`` with ``fill``; returns
    (padded, valid_mask)."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"{n} rows exceed capacity {capacity}")
    valid = np.zeros(capacity, dtype=bool)
    valid[:n] = True
    if n == capacity:
        return arr, valid
    pad = np.full((capacity - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0), valid
