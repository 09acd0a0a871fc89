"""pcseqlearning_tpu_torch — the PyTorch/CUDA port of pcseqlearning_tpu.

This package ports the unsupervised cluster-sequence extraction pipeline
(ground removal -> multi-radius cluster proposal -> batched tracking) to
PyTorch on an NVIDIA H100. The JAX package stays beside it as the
reference; this package imports nothing of it and never imports ``jax``.

Layers:
  ops/            tensor ops and the three hand-written CUDA kernels
                  (csrc/): pair_min (ICP correspondences), cc_round (radius
                  connected components) and radius_scan (k-NN claims)
  preprocessing/  GroundPlaneRemover, ClusterProposal, ClusterTracking
  utils/          EDict, bucketing, frame index, telemetry
  convert.py      JAX-side config + environment -> explicit port config
  scene.py        the synthetic benchmark scene

Entry points run on the card (``device="cuda"``) and raise when CUDA is
absent, unless the caller passes ``device="cpu"``; on CPU tensors every
kernel wrapper runs its plain PyTorch version. Nothing falls back from the
card to the CPU.
"""

import torch

# the JAX package pins Precision.HIGHEST for its geometry; keep float32
# products in full float32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402,F401

__version__ = "0.1.0"
