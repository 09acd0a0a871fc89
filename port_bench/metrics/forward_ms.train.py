"""Device ms a step of the train step's forward (``parallel/train_step.py``:
the batch to the device, flattening, the model call), from the program's
own span ``train_step.forward``: its CUDA events, idle time inside it
included."""

from port_bench import program_trace

SPANS = ("train_step.forward",)


def read(rec):
    return program_trace.span_ms(rec, SPANS)
