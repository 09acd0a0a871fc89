"""Device ms a step of the sparse convolutions' rulebooks
(``ops/sparse_conv.py``: the output coordinates of the strided convs, the
dense-table scatters and lookups of every forward and reverse rulebook),
summed over the program's own ``sparse_conv.rulebook`` spans of a step."""

from port_bench import program_trace

SPANS = ("sparse_conv.rulebook",)


def read(rec):
    return program_trace.span_ms(rec, SPANS)
