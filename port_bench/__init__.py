"""The benchmark of pcseqlearning_tpu_torch, the PyTorch and CUDA port:
training cells driven by data (``BENCHMARK.json`` at the checkout's root,
and the files under this folder that it names). Entry point:
``python3 -m port_bench.run``; see README.md."""
