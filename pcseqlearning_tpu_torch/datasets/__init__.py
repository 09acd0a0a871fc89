"""Data layer (counterpart of pcseqlearning_tpu.datasets): the dataset
template, the Waymo sequence dataset, the processors, and a loader that
shards, shuffles and collates on the host."""

from __future__ import annotations

import numpy as np

from .dataset import DatasetTemplate, collate_batch
from .waymo_dataset import WaymoDataset

__all__ = ["DatasetTemplate", "WaymoDataset", "collate_batch", "build_dataloader"]

DATASETS = {"WaymoDataset": WaymoDataset}


class SimpleLoader:
    """Single-process loader: shuffles with ``RandomState(seed + epoch)``, as
    the JAX loader does (``set_epoch``, which ``runtime.train_utils.train_model``
    calls before each epoch; epoch 0 until then), shards across ranks (every
    ``world_size``-th item from ``rank``) and collates each batch."""

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0, drop_last=False,
                 rank=0, world_size=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        per_rank = (len(self.dataset) + self.world_size - 1) // self.world_size
        if self.drop_last:
            return per_rank // self.batch_size
        return (per_rank + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        order = order[self.rank::self.world_size]
        nb = (len(order) // self.batch_size if self.drop_last
              else (len(order) + self.batch_size - 1) // self.batch_size)
        for i in range(nb):
            idxs = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield collate_batch([self.dataset[j] for j in idxs])


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None, training=True,
                     seed=0, rank=0, world_size=1, rng=None, **kwargs):
    """(dataset, loader). ``seed`` seeds the loader's shuffle; ``rng``, by
    default ``np.random.RandomState(seed)``, makes the augmentor's and the
    processors' random draws (the JAX package's global ``np.random``)."""
    dataset = DATASETS[dataset_cfg["DATASET"]](
        dataset_cfg=dataset_cfg, class_names=class_names, root_path=root_path,
        training=training, rng=rng if rng is not None else np.random.RandomState(seed))
    loader = SimpleLoader(dataset, batch_size=batch_size, shuffle=training, seed=seed,
                          drop_last=training, rank=rank, world_size=world_size)
    return dataset, loader
