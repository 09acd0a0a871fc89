"""The two helpers the CLI needs (counterpart of pieces of
pcseqlearning_tpu.utils.common_utils): a rank-gated logger and the seeding
of every random source."""

from __future__ import annotations

import logging
import random

import numpy as np
import torch


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """Console logger, plus ``log_file`` when given; ranks other than 0 log
    errors only."""
    logger = logging.getLogger(__name__ + (".r%d" % rank))
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else logging.ERROR)
        console.setFormatter(formatter)
        logger.addHandler(console)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setLevel(log_level if rank == 0 else logging.ERROR)
            fh.setFormatter(formatter)
            logger.addHandler(fh)
    return logger


def set_random_seed(seed):
    """Seed Python's, NumPy's and torch's generators (the card's too)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
