"""The training CLI (counterpart of ``tools/train.py``):

    python -m pcseqlearning_tpu_torch.train <model.yaml> <data.yaml> <optim.yaml> \\
        [vis.yaml] [--batch_size N] [--epochs E] [--ckpt PATH] [--max_ckpt_save_num K] \\
        [--fix_random_seed] [--extra_tag T] [--set KEY VALUE ...] [--device cuda|cpu]

The configs compose as in ``tools/train.py`` (model, dataset, optimizer,
optional visualizer, then the dotted ``--set`` overrides); TAG and
EXP_GROUP_PATH come from the model config's path, and the log goes to
``<ROOT_DIR>/output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/``. ``--device``
defaults to ``cuda``, which raises without a card.

``MODEL.NAME: SimpleReg`` runs the extraction pipeline over the training
loader, once. Before the overrides, every PREPROCESSORS stage gets the
port's explicit keys (``convert.config_from_jax`` with the JAX package's
defaults: CC_GRAPH "radius", the kernel path; CC_CELL_CAP; tracking
ANGLE_VELO_EXEMPT, FINE_CANDIDATES, CELL_CAP), so ``--set`` can change
them, for example ``--set MODEL.PREPROCESSORS.1.CC_GRAPH knn``. The stages'
DIR, LOG_DIR and SAVE_DIR paths are relative to the working directory, as
in the JAX CLI.

A detector config trains: ``build_network`` (CenterPoint, SECONDNet,
SECONDNetIoU, PointPillar and VoxelRCNN; the other detectors raise, naming
their ROADMAP.md item), the optimizer and schedule of ``build_optimizer(OPTIMIZATION,
len(loader), epochs)``, batches in the dense layout of
``dense_batch_from_collated(batch, MODEL.POINT_CAP)``, and
``runtime.train_utils.train_model`` over the epochs, with checkpoints in
``<output>/ckpt`` rotated to ``--max_ckpt_save_num``. The run resumes from
``--ckpt`` or else the latest checkpoint there, at the epoch its name gives;
the schedule is rebuilt from the loader's length and ``--epochs``, as in
JAX, and the optimizer's restored count picks it up. The host's random
draws (augmentation, point shuffles) come from ``RandomState(666)`` under
``--fix_random_seed`` (the JAX CLI seeds the global ``np.random`` with 666)
and from ``RandomState(0)`` otherwise; a resumed run starts them afresh, as
JAX does. The loss is ``total_loss`` for a model with a ROI_HEAD,
``center_loss`` for a CenterHead, else ``rpn_loss``. Losses go to
tensorboardX when it imports. ``main`` sets
``torch.backends.cudnn.deterministic``: cuDNN's default backward algorithms
add in a run-to-run order, and with the flag a run repeats bit for bit.

Data parallel: ``main`` first joins a process group
(``dist_utils.init_distributed``: torchrun's environment, or a default group
that the caller made; none at world size 1), and a CUDA rank runs on
``cuda:LOCAL_RANK``::

    torchrun --nproc_per_node K -m pcseqlearning_tpu_torch.train <model> <data> <optim> ...

Every rank builds the same loader, so the same global batches arrive in
the same order, and the train step takes the rank's rows of each
(``parallel.train_step``, data-parallel over the default group; K must
divide the batch size). Only rank 0 writes the log file, tensorboard and
the checkpoints; every rank waits after each save, so an autoresume finds
the same checkpoint on every rank.
"""

from __future__ import annotations

import argparse
import datetime
from pathlib import Path

import numpy as np
import torch

from .config import cfg as global_cfg
from .config import cfg_from_list, cfg_from_yaml_file, log_config_to_file
from .convert import config_from_jax
from .datasets import build_dataloader
from .device import resolve_device
from .models import build_network
from .parallel.train_step import dense_batch_from_collated, init_train_state, make_train_step
from .runtime import train_utils
from .runtime.optimization import build_optimizer
from .utils import common_utils, dist_utils
from .utils.edict import EDict

SEED = 666


def parse_config(argv=None):
    """(args, cfg): the parsed arguments and a freshly composed config."""
    parser = argparse.ArgumentParser(prog="python -m pcseqlearning_tpu_torch.train")
    parser.add_argument("cfg_file", type=str, help="model config")
    parser.add_argument("data_cfg_file", type=str, help="dataset config")
    parser.add_argument("optim_cfg_file", type=str, help="optimizer config")
    parser.add_argument("vis_cfg_file", type=str, nargs="?", default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = EDict(ROOT_DIR=global_cfg.ROOT_DIR, LOCAL_RANK=global_cfg.LOCAL_RANK)
    for path in (args.cfg_file, args.data_cfg_file, args.optim_cfg_file, args.vis_cfg_file):
        if path:
            cfg_from_yaml_file(path, cfg)
    if "PREPROCESSORS" in cfg.get("MODEL", {}):
        cfg.MODEL.PREPROCESSORS = [config_from_jax(p, env={}) for p in cfg.MODEL.PREPROCESSORS]
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = "/".join(Path(args.cfg_file).parts[1:-1])
    return args, cfg


def loss_key_for(model_cfg):
    """The loss the step differentiates: two-stage models put both stages'
    losses in total_loss."""
    if "ROI_HEAD" in model_cfg:
        return "total_loss"
    if model_cfg.DENSE_HEAD.NAME == "CenterHead":
        return "center_loss"
    return "rpn_loss"


def runtime_cfg_of(cfg):
    """The geometry a detector is built with (as the JAX CLI passes it)."""
    return dict(data_cfg=cfg.DATA_CONFIG, class_names=list(cfg.CLASS_NAMES),
                voxel_cap=int(cfg.MODEL.get("VOXEL_CAP", 16384)))


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line). Returns the
    SimpleReg model (whose stages hold the last sequence's state), or for a
    detector a dict: the train ``state``, the per-step ``history`` records
    of ``train_utils.train_one_epoch``, ``start_epoch``, ``ckpt_dir`` and
    the ``schedule``."""
    args, cfg = parse_config(argv)
    rank, world = dist_utils.init_distributed(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", dist_utils.local_rank())
    torch.backends.cudnn.deterministic = True
    if args.fix_random_seed:
        common_utils.set_random_seed(SEED)
    output_dir = Path(cfg.ROOT_DIR) / "output" / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    ckpt_dir = output_dir / "ckpt"
    log_file = None
    if rank == 0:
        output_dir.mkdir(parents=True, exist_ok=True)
        log_file = str(output_dir / ("log_train_%s.txt"
                                     % datetime.datetime.now().strftime("%Y%m%d-%H%M%S")))
    logger = common_utils.create_logger(log_file, rank=rank)
    logger.info("**********************Start logging**********************")
    log_config_to_file(cfg, logger=logger)

    batch_size = args.batch_size or int(cfg.OPTIMIZATION.get("BATCH_SIZE_PER_GPU", 2))
    if cfg.MODEL.NAME == "SimpleReg":
        model = build_network(cfg.MODEL, device=device)
        _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, training=True)
        for batch in loader:
            model(batch)
        logger.info("extraction finished")
        return model

    epochs = args.epochs or int(cfg.OPTIMIZATION.get("NUM_EPOCHS", 30))
    rng = np.random.RandomState(SEED if args.fix_random_seed else 0)
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                       training=True, rng=rng)
    model = build_network(cfg.MODEL, runtime_cfg_of(cfg), dataset, device=device)
    make_optimizer, sched = build_optimizer(cfg.OPTIMIZATION, len(loader), epochs)
    n_cap = int(cfg.MODEL.get("POINT_CAP", 32768))

    def converter(batch):
        return dense_batch_from_collated(batch, n_cap)

    group = torch.distributed.group.WORLD if world > 1 else None
    state = init_train_state(model, make_optimizer, device=device, group=group)
    start_epoch = 0
    latest = train_utils.latest_checkpoint(str(ckpt_dir))
    if args.ckpt or latest:
        path = args.ckpt or latest
        state = train_utils.load_checkpoint(path, state)
        start_epoch = int(path.rsplit("_", 1)[-1])
        logger.info(f"resumed from {path} at epoch {start_epoch}")
    step = make_train_step(loss_key=loss_key_for(cfg.MODEL), device=device, group=group)
    tb = None
    if rank == 0:
        try:
            from tensorboardX import SummaryWriter

            tb = SummaryWriter(str(output_dir / "tensorboard"))
        except ImportError:
            pass
    history = []
    state = train_utils.train_model(step, state, loader, converter, epochs, str(ckpt_dir),
                                    logger=logger, tb_writer=tb,
                                    max_ckpt_save_num=args.max_ckpt_save_num,
                                    start_epoch=start_epoch, history=history, rank=rank)
    if tb is not None:
        tb.close()
    logger.info("**********************Training done**********************")
    return dict(state=state, history=history, start_epoch=start_epoch, ckpt_dir=str(ckpt_dir),
                schedule=sched)


if __name__ == "__main__":
    main()
