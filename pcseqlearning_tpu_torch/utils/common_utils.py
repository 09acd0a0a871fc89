"""The helpers the CLIs need (counterpart of pieces of
pcseqlearning_tpu.utils.common_utils): a rank-gated logger, the seeding of
every random source and a running mean."""

from __future__ import annotations

import logging
import random

import numpy as np
import torch


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """Console logger, plus ``log_file`` when given; ranks other than 0 log
    errors only. A later call in the same process (a CLI's ``main`` run
    again) logs to its own ``log_file``, in place of the earlier one."""
    logger = logging.getLogger(__name__ + (".r%d" % rank))
    level = log_level if rank == 0 else logging.ERROR
    logger.setLevel(level)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    handlers = [] if logger.handlers else [logging.StreamHandler()]
    if log_file is not None:
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setLevel(level)
        h.setFormatter(formatter)
        logger.addHandler(h)
    return logger


def set_random_seed(seed):
    """Seed Python's, NumPy's and torch's generators (the card's too)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class AverageMeter:
    """The last value, sum, count and mean of a stream of scalars."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
