"""Device ms a step of farthest point sampling (``ops/sampling.py``'s
``batched_farthest_point_sample``, PV-RCNN's keypoints), from the program's
own span ``fps``, one a call: its CUDA events, the idle time between the
loop's launches included."""

from port_bench import program_trace

SPANS = ("fps",)


def read(rec):
    return program_trace.span_ms(rec, SPANS)
