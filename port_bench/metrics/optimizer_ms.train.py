"""Device ms a step of the train step's update (``parallel/train_step.py``
over ``runtime/optimization.py``: freezing, ``global_norm``, the clipped
AdamW step), from the program's own span ``train_step.optimizer``: its CUDA
events, idle time inside it included."""

from port_bench import program_trace

SPANS = ("train_step.optimizer",)


def read(rec):
    return program_trace.span_ms(rec, SPANS)
