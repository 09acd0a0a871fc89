"""The train loop, checkpoints and autoresume (counterpart of
pcseqlearning_tpu.runtime.train_utils).

A checkpoint is one ``torch.save`` file named ``checkpoint_epoch_<N>`` (the
CLI reads the epoch from the name's last ``_`` field): the model's
``state_dict`` (parameters and batch-norm buffers), the optimizer's state
(its moments and update count) and the train state's step. Saving rotates
the directory to the ``max_keep`` newest epochs. ``train_model`` runs the
epochs from ``start_epoch``, calling the loader's ``set_epoch`` before each,
and saves every ``ckpt_save_interval`` epochs. ``train_one_epoch`` reads
every loss to the host after each step, as the JAX loop does, and keeps the
data and batch times in ``AverageMeter``s.

Under data parallelism only rank 0 writes checkpoints (``save_checkpoint``
and ``train_model`` take the rank), and ``train_model`` holds every rank
at a barrier after each save, so an autoresume on any rank finds the same
latest checkpoint.

Resuming restores the model, the optimizer and the step, not the host's
random draws (the augmentation and point shuffles): the JAX loop draws them
from the global ``np.random``, which its checkpoint does not hold either,
so a resumed run does not repeat a continuous one.
"""

from __future__ import annotations

import glob
import os
import time

import torch

from ..utils import dist_utils
from ..utils.common_utils import AverageMeter

_PREFIX = "checkpoint_epoch_"


def list_checkpoints(ckpt_dir):
    return sorted(glob.glob(os.path.join(ckpt_dir, _PREFIX + "*")),
                  key=lambda p: int(p.rsplit("_", 1)[-1]))


def save_checkpoint(state, ckpt_dir, step, max_keep=30, rank=0):
    """Write ``state`` as ``<ckpt_dir>/checkpoint_epoch_<step>`` (through a
    temporary file, so a checkpoint is whole or absent) and delete all but
    the ``max_keep`` newest; returns the path. A rank other than 0 writes
    nothing and returns None."""
    if rank != 0:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"{_PREFIX}{step}")
    tmp = os.path.join(os.path.abspath(ckpt_dir), f".{_PREFIX}{step}.tmp")  # not globbed
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, tmp)
    os.replace(tmp, path)
    for old in list_checkpoints(ckpt_dir)[:-max_keep]:
        os.remove(old)
    return path


def latest_checkpoint(ckpt_dir):
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def load_checkpoint(path, target_state, with_optimizer=True):
    """``target_state`` with the model, step and (``with_optimizer``: for
    evaluation, the model alone matters) optimizer of ``path``."""
    ckpt = torch.load(path, map_location=next(target_state.model.parameters()).device,
                      weights_only=True)
    target_state.model.load_state_dict(ckpt["model"])
    if with_optimizer:
        target_state.optimizer.load_state_dict(ckpt["optimizer"])
    target_state.step = int(ckpt["step"])
    return target_state


def load_params_from_file(path, target_state, strict=False, logger=None):
    """Load the model entries of ``path`` into ``target_state.model``,
    non-strictly: an entry missing from the file keeps its initial value;
    one whose shape differs but whose element count matches is reshaped (a
    kernel-layout change); any other mismatch keeps the initial value, or
    raises ValueError when ``strict``. Returns ``target_state``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    loaded = ckpt.get("model", ckpt)
    out, n_adapt, n_skip = {}, 0, 0
    for key, tgt in target_state.model.state_dict().items():
        src = loaded.get(key)
        if src is None:
            out[key] = tgt
        elif src.shape == tgt.shape:
            out[key] = src
        elif src.numel() == tgt.numel():
            out[key] = src.reshape(tgt.shape)
            n_adapt += 1
        elif strict:
            raise ValueError(f"shape mismatch at {key}: {tuple(src.shape)} vs {tuple(tgt.shape)}")
        else:
            out[key] = tgt
            n_skip += 1
    target_state.model.load_state_dict(out)
    if logger is not None:
        logger.info(f"loaded {len(out)} params ({n_adapt} layout-adapted, {n_skip} kept-init)")
    return target_state


def train_one_epoch(train_step, state, loader, batch_converter, epoch, logger=None,
                    tb_writer=None, log_every=50, history=None):
    """One pass over ``loader``; returns (state, mean of each loss). When
    ``history`` is a list, each step appends a record: epoch, step, the
    rate of its update (``lr``, for an optimizer that has ``last_lr``), its
    data and batch seconds, its valid points and its losses."""
    data_meter, batch_meter = AverageMeter(), AverageMeter()
    end = time.time()
    losses_acc = {}
    for it, batch in enumerate(loader):
        dense = batch_converter(batch)
        data_s = time.time() - end
        data_meter.update(data_s)
        state, losses = train_step(state, dense)
        losses = {k: float(v) for k, v in losses.items()}  # a host read each step
        batch_meter.update(time.time() - end)
        end = time.time()
        for k, v in losses.items():
            losses_acc.setdefault(k, AverageMeter()).update(v)
        if history is not None:
            history.append(dict(epoch=epoch, step=int(state.step),
                                lr=getattr(state.optimizer, "last_lr", None), data_s=data_s,
                                batch_s=batch_meter.val, points=int(dense["valid"].sum()),
                                losses=losses))
        if logger and it % log_every == 0:
            msg = " ".join(f"{k}={m.avg:.4f}" for k, m in losses_acc.items())
            logger.info(f"epoch {epoch} it {it}/{len(loader)} {msg} "
                        f"data={data_meter.avg:.3f}s batch={batch_meter.avg:.3f}s")
        if tb_writer is not None:
            for k, v in losses.items():
                tb_writer.add_scalar(f"train/{k}", v, int(state.step))
    return state, {k: m.avg for k, m in losses_acc.items()}


def train_model(train_step, state, loader, batch_converter, total_epochs, ckpt_dir, logger=None,
                tb_writer=None, ckpt_save_interval=1, max_ckpt_save_num=30, start_epoch=0,
                history=None, rank=0):
    """Epochs ``start_epoch`` .. ``total_epochs - 1``; returns the state.
    Rank ``rank`` of the default process group (if any) saves only when it
    is rank 0; every rank waits at a barrier after each save."""
    for epoch in range(start_epoch, total_epochs):
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        state, _ = train_one_epoch(train_step, state, loader, batch_converter, epoch, logger,
                                   tb_writer, history=history)
        if (epoch + 1) % ckpt_save_interval == 0:
            path = save_checkpoint(state, ckpt_dir, epoch + 1, max_ckpt_save_num, rank)
            dist_utils.barrier()
            if logger and path:
                logger.info(f"saved checkpoint: {path}")
    return state


def ema_update(ema_params, params, decay=0.999):
    """Exponential moving average of dicts of tensors: e * decay + p * (1 - decay)."""
    return {k: e * decay + params[k] * (1.0 - decay) for k, e in ema_params.items()}


def load_ema_params_from_files(paths, target_state):
    """``target_state`` loaded from the last of ``paths``, its parameters
    (not the batch-norm buffers) replaced by their mean over all of them."""
    names = [n for n, _ in target_state.model.named_parameters()]
    models = [torch.load(p, map_location="cpu", weights_only=True)["model"] for p in paths]
    target_state = load_checkpoint(paths[-1], target_state)
    mean = {n: sum(m[n] for m in models) / float(len(models)) for n in names}
    target_state.model.load_state_dict(mean, strict=False)
    return target_state
