"""Device ms a step of the sparse convolutions' gather-GEMMs
(``ops/sparse_conv.py``'s ``_RulebookMM``), forward and backward, summed
over the program's own ``sparse_conv.gemm`` and ``sparse_conv.gemm_bwd``
spans of a step."""

from port_bench import program_trace

SPANS = ("sparse_conv.gemm", "sparse_conv.gemm_bwd")


def read(rec):
    return program_trace.span_ms(rec, SPANS)
