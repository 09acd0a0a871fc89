"""The extraction CLI (counterpart of ``tools/train.py``'s argument parsing
and its SimpleReg branch):

    python -m pcseqlearning_tpu_torch.train <model.yaml> <data.yaml> <optim.yaml> \\
        [vis.yaml] [--set KEY VALUE ...] [--device cuda|cpu]

The configs compose as in ``tools/train.py`` (model, dataset, optimizer,
optional visualizer, then the dotted ``--set`` overrides); TAG and
EXP_GROUP_PATH come from the model config's path, and the log goes to
``<ROOT_DIR>/output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/``. Before the
overrides, every PREPROCESSORS stage gets the port's explicit keys
(``convert.config_from_jax`` with the JAX package's defaults: CC_GRAPH
"radius", the kernel path; CC_CELL_CAP; tracking ANGLE_VELO_EXEMPT,
FINE_CANDIDATES, CELL_CAP), so ``--set`` can change them, for example
``--set MODEL.PREPROCESSORS.1.CC_GRAPH knn``. The stages' DIR, LOG_DIR and
SAVE_DIR paths are relative to the working directory, as in the JAX CLI.

The run builds the training loader with BATCH_SIZE_PER_GPU and calls the
model on every batch. ``--device`` defaults to ``cuda``, which raises
without a card. Only ``MODEL.NAME: SimpleReg`` runs here; a detector config
raises NotImplementedError before anything is built: the port has the
CenterPoint model and its train step (``models.build_network``,
``parallel.train_step``) but not yet the detector training's data augmentor,
voxel processor, one-cycle schedule and train loop.
"""

from __future__ import annotations

import argparse
import datetime
from pathlib import Path

from .config import cfg as global_cfg
from .config import cfg_from_list, cfg_from_yaml_file, log_config_to_file
from .convert import config_from_jax
from .datasets import build_dataloader
from .device import resolve_device
from .models import build_network
from .utils import common_utils
from .utils.edict import EDict


def parse_config(argv=None):
    """(args, cfg): the parsed arguments and a freshly composed config."""
    parser = argparse.ArgumentParser(prog="python -m pcseqlearning_tpu_torch.train")
    parser.add_argument("cfg_file", type=str, help="model config")
    parser.add_argument("data_cfg_file", type=str, help="dataset config")
    parser.add_argument("optim_cfg_file", type=str, help="optimizer config")
    parser.add_argument("vis_cfg_file", type=str, nargs="?", default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--fix_random_seed", action="store_true")
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


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    model, whose stages hold the last sequence's state."""
    args, cfg = parse_config(argv)
    if cfg.MODEL.NAME != "SimpleReg":
        raise NotImplementedError(
            f"train: detector training ({cfg.MODEL.NAME!r}) needs the data augmentor, the "
            "voxel processor (transform_points_to_voxels), the one-cycle schedule and the "
            "train loop, which are not ported yet (ROADMAP.md, queue 1 item 5)")
    device = resolve_device(args.device)
    if args.fix_random_seed:
        common_utils.set_random_seed(666)
    output_dir = Path(cfg.ROOT_DIR) / "output" / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    output_dir.mkdir(parents=True, exist_ok=True)
    log_file = output_dir / ("log_train_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    logger = common_utils.create_logger(str(log_file))
    logger.info("**********************Start logging**********************")
    log_config_to_file(cfg, logger=logger)

    model = build_network(cfg.MODEL, device=device)
    batch_size = args.batch_size or int(cfg.OPTIMIZATION.get("BATCH_SIZE_PER_GPU", 2))
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, training=True)
    for batch in loader:
        model(batch)
    logger.info("extraction finished")
    return model


if __name__ == "__main__":
    main()
