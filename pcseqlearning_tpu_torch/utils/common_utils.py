"""Dict-of-arrays helpers, logging and seeding (counterpart of
pcseqlearning_tpu.utils.common_utils). Arrays may be NumPy arrays or torch
tensors (on any device); masks and indices follow their indexing rules."""

from __future__ import annotations

import logging
import random

import numpy as np
import torch

_ARRAY_TYPES = (np.ndarray, torch.Tensor)


def _is_array(x):
    return isinstance(x, _ARRAY_TYPES)


def apply_to_dict(d, fn):
    """``fn`` applied to every array entry of dict ``d``."""
    return {k: (fn(v) if _is_array(v) else v) for k, v in d.items()}


def filter_dict(d, mask_or_indices):
    """Every array entry of ``d`` with at least one axis indexed along axis
    0; the other entries as they are."""
    return {k: (v[mask_or_indices] if _is_array(v) and v.ndim >= 1 else v)
            for k, v in d.items()}


def _join_dicts(dicts, np_fn, torch_fn, axis):
    """Key-wise join of a list of dicts: arrays by ``np_fn`` or, when any
    array of the first dict is a tensor, by ``torch_fn`` (on that tensor's
    device) for every key; other values as a list."""
    if len(dicts) == 0:
        return {}
    first = [v for v in dicts[0].values() if torch.is_tensor(v)]
    out = {}
    for k in dicts[0].keys():
        vals = [d[k] for d in dicts]
        if not _is_array(vals[0]):
            out[k] = vals
        elif first:
            out[k] = torch_fn([torch.as_tensor(v, device=first[0].device) for v in vals],
                              dim=axis)
        else:
            out[k] = np_fn(vals, axis=axis)
    return out


def concat_dicts(dicts, axis=0):
    """Concatenate a list of dicts key-wise."""
    return _join_dicts(dicts, np.concatenate, torch.cat, axis)


def stack_dicts(dicts, axis=0):
    """Stack a list of dicts key-wise."""
    return _join_dicts(dicts, np.stack, torch.stack, axis)


def indexing_list_elements(cfg_dict, idx):
    """Element ``idx`` of every list value of ``cfg_dict`` (a config whose
    values may be per-level lists); other values as they are."""
    return {k: (v[idx] if isinstance(v, list) else v) for k, v in cfg_dict.items()}


def rotate_points_along_z(points, angle):
    """Points [B, N, 3 + C] (or [N, 3 + C]) rotated counter-clockwise by
    ``angle`` [B] (or a scalar) radians around z; the other channels as
    they are."""
    is_t = torch.is_tensor(points)
    single = points.ndim == 2
    if is_t:
        angle = torch.as_tensor(angle, dtype=points.dtype, device=points.device)
        cos, sin, stack, cat = torch.cos, torch.sin, torch.stack, torch.cat
    else:
        angle = np.asarray(angle)
        cos, sin, stack, cat = np.cos, np.sin, np.stack, np.concatenate
    if single:
        points = points[None]
        angle = angle.reshape(1)
    cosa, sina = cos(angle), sin(angle)
    zeros, ones = cosa * 0, cosa * 0 + 1
    rot = stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], 1).reshape(-1, 3, 3)
    xyz = points[:, :, :3] @ rot
    out = cat([xyz, points[:, :, 3:]], -1)
    return out[0] if single else out


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
