"""pcseqlearning_tpu_torch — the PyTorch/CUDA port of pcseqlearning_tpu.

This package ports the unsupervised cluster-sequence extraction pipeline
(ground removal -> multi-radius cluster proposal -> cluster tracking by the
batched, host or device walk, with ICP or gradient-descent registration,
driven per sequence by SimpleReg) and the CenterPoint detector with its
training and evaluation runtime to PyTorch on an NVIDIA H100. The JAX
package stays beside it as the reference; this package imports nothing of
it and never imports ``jax``.

Layers:
  ops/            tensor ops, the spatial-hash neighbour search and the
                  three hand-written CUDA kernels (csrc/): pair_min (ICP
                  correspondences of the batched walk), cc_round (radius
                  connected components) and radius_scan (k-NN claims)
  preprocessing/  GroundPlaneRemover, ClusterProposal, ClusterTracking,
                  registration, the GD solver, SimpleReg
  datasets/       the Waymo sequence dataset, augmentor, processors, loader
  models/         build_network (SimpleReg, CenterPoint)
  parallel/       the detector's train step on one card
  runtime/        optimizers and schedules, the train loop and checkpoints,
                  detection metrics
  utils/          EDict, bucketing, frame index, telemetry, the YAML
                  subset reader, logger and seeding
  config.py       YAML configs with _BASE_CONFIG_ includes and overrides
  train.py        the CLI: python -m pcseqlearning_tpu_torch.train
  test.py         the detector evaluation CLI: python -m pcseqlearning_tpu_torch.test
  convert.py      JAX-side config + environment -> explicit port config
  scene.py        the synthetic scenes, and writing one as a Waymo sequence

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
