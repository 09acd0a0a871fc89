"""Device ms a step of the train step's backward (``parallel/train_step.py``:
``zero_grad`` and ``.backward()``), from the program's own span
``train_step.backward``: its CUDA events, idle time inside it included."""

from port_bench import program_trace

SPANS = ("train_step.backward",)


def read(rec):
    return program_trace.span_ms(rec, SPANS)
