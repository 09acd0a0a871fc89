"""Parallel training and sharded search (counterpart of
pcseqlearning_tpu.parallel): the device mesh and batch sharding
(``mesh``), the detector's train step, on one card or data-parallel over a
process group (``train_step``), and the x-sharded neighbour search and
connected components over a mesh of devices (``point_shard``)."""

from .mesh import make_mesh, replicate, shard_batch  # noqa: F401
from .train_step import TrainState, make_train_step  # noqa: F401
