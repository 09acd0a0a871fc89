"""The share of the time in which no kernel, copy or set ran on the card:
the device's busy seconds over a few steps profiled with CUDA activity
only (torch.profiler's trace), against the seconds the same pool batches
took with nothing on, so that the profiler's cost to the host does not
count as idle time."""


def read(rec):
    if not rec.get("plain_profiled_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["plain_profiled_s"])
