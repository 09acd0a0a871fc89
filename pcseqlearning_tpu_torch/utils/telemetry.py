"""Process-wide truncation/overflow counters (counterpart of
pcseqlearning_tpu.utils.telemetry).

The keys are the ones the benchmark record reads:
``proposal_scan_windows_truncated``, ``proposal_halo_truncated``,
``tracking_claim_windows_truncated`` and ``tracking_claim_overflow``. The
port's CUDA kernels walk whole cell runs, so the scan-window counters are
reported as 0 by construction; the halo counter is the sharded CC's
(``parallel.point_shard``), which also counts the bytes its halo exchange
and pair gather copy (``shard_halo_bytes``, ``shard_gather_bytes``).
"""

from __future__ import annotations

from collections import defaultdict

COUNTERS: dict[str, int] = defaultdict(int)

BENCH_KEYS = (
    "proposal_scan_windows_truncated",
    "proposal_halo_truncated",
    "tracking_claim_windows_truncated",
    "tracking_claim_overflow",
)


def add(name: str, value) -> None:
    """Accumulate ``value`` into counter ``name`` (0 registers the key)."""
    COUNTERS[name] += int(value)


def snapshot(reset: bool = False) -> dict[str, int]:
    """Plain-dict copy of all counters, every bench key present."""
    out = {k: 0 for k in BENCH_KEYS}
    out.update(COUNTERS)
    if reset:
        COUNTERS.clear()
    return out


def reset() -> None:
    COUNTERS.clear()
