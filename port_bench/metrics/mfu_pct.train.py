"""The training step's model FLOPs (``flops.step_work``: from the
configuration's widths and each batch's geometry, whatever kernel runs
them) over the traced run's steps outside the profiler, as a share of the
card's float32 peak."""


def read(rec):
    return 100.0 * rec["flops_per_s"] / rec["peak_flops"]
