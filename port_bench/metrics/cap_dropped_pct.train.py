"""The share of the valid points inside the range whose voxel the VFE's
cap drops (``models/vfe.py``'s ``DynamicMeanVFE``): 100 x the program's
counter ``vfe.points_dropped`` over its counter ``vfe.points``, counted on
the device while the program traces. It reads counters, not a span."""

from port_bench import program_trace


def read(rec):
    return program_trace.counter_pct(rec, "vfe.points_dropped", "vfe.points")
