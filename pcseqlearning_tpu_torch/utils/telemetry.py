"""Process-wide counters (counterpart of pcseqlearning_tpu.utils.telemetry).

The extraction keys are the ones the benchmark record reads:
``proposal_scan_windows_truncated``, ``proposal_halo_truncated``,
``tracking_claim_windows_truncated`` and ``tracking_claim_overflow``. The
port's CUDA kernels walk whole cell runs, so the scan-window counters are
reported as 0 by construction; the halo counter is the sharded CC's
(``parallel.point_shard``), which also counts the bytes its halo exchange
and pair gather copy (``shard_halo_bytes``, ``shard_gather_bytes``).

A counter given a tensor accumulates on the tensor's device, with no read
to the host, until ``snapshot()``. Counters that need a reduction on the
card are added only while ``utils.profiler`` traces (the VFE's
``vfe.points`` and ``vfe.points_dropped``), so that the untraced step
launches nothing for them.
"""

from __future__ import annotations

from collections import defaultdict

import torch

COUNTERS: dict = defaultdict(int)

BENCH_KEYS = (
    "proposal_scan_windows_truncated",
    "proposal_halo_truncated",
    "tracking_claim_windows_truncated",
    "tracking_claim_overflow",
)


def add(name: str, value) -> None:
    """Accumulate ``value`` into counter ``name`` (0 registers the key): a
    tensor on its own device, with no host read; anything else as an
    int."""
    if torch.is_tensor(value):
        COUNTERS[name] = COUNTERS[name] + value.detach()
    else:
        COUNTERS[name] += int(value)


def snapshot(reset: bool = False) -> dict[str, int]:
    """Plain-dict copy of all counters as ints, every bench key present;
    the tensors among them are read to the host in one copy a device."""
    out = {k: 0 for k in BENCH_KEYS}
    by_device = {}
    for k, v in COUNTERS.items():
        if torch.is_tensor(v):
            by_device.setdefault(v.device, []).append(k)
        else:
            out[k] = v
    for keys in by_device.values():
        vals = torch.stack([COUNTERS[k].reshape(()).to(torch.float64) for k in keys]).tolist()
        out.update((k, int(v)) for k, v in zip(keys, vals))
    if reset:
        COUNTERS.clear()
    return out


def reset() -> None:
    COUNTERS.clear()
