"""The evaluation CLI (counterpart of ``tools/test.py``):

    python -m pcseqlearning_tpu_torch.test <model.yaml> <data.yaml> [optim.yaml] \\
        (--ckpt PATH | --eval_all --ckpt_dir DIR [--max_waiting_mins M]) \\
        [--batch_size N] [--extra_tag T] [--set KEY VALUE ...] [--device cuda|cpu]

The configs compose as for training (no visualizer); the test loader runs
the dataset with ``training=False`` (no augmentation, no shuffles). For a
checkpoint, ``eval_ckpt`` runs the detector's ``predict`` on every batch in
the dense layout (CenterPoint's top-K decode, the anchor detectors' NMS,
Voxel R-CNN's refined RoIs, labelled 1 as in JAX), keeps each sample's
valid rows, formats them with the
dataset's ``generate_prediction_dicts`` and scores them with its
``evaluation`` (the Waymo-style AP/APH), logged under
``<ROOT_DIR>/output/<TAG>/<extra_tag>/eval/``. ``--ckpt`` evaluates one
checkpoint (none: the initial weights). ``--eval_all`` polls ``--ckpt_dir``
for ``checkpoint_epoch_*`` files and evaluates each new one once, in epoch
order; it stops once ``--max_waiting_mins`` pass with no new checkpoint
(JAX's deadline rule, restarted after every evaluation). The port scans the
directory once before it reads the deadline, so ``--max_waiting_mins 0``
evaluates the checkpoints already there (the JAX loop reads the deadline
first, and at 0 evaluates none). ``--device`` defaults to ``cuda``, which
raises without a card; ``main`` sets ``torch.backends.cudnn.deterministic``
as the training CLI does.
"""

from __future__ import annotations

import argparse
import datetime
import time
from pathlib import Path

import numpy as np
import torch

from .config import cfg as global_cfg
from .config import cfg_from_list, cfg_from_yaml_file
from .datasets import build_dataloader
from .device import resolve_device
from .models import build_network
from .parallel.train_step import _flatten_local, _to_device, dense_batch_from_collated
from .parallel.train_step import init_train_state
from .runtime import train_utils
from .runtime.optimization import build_optimizer
from .train import runtime_cfg_of
from .utils import common_utils, dist_utils
from .utils.edict import EDict

POLL_SECONDS = 30


def parse_config(argv=None):
    """(args, cfg): the parsed arguments and a freshly composed config."""
    parser = argparse.ArgumentParser(prog="python -m pcseqlearning_tpu_torch.test")
    parser.add_argument("cfg_file", type=str)
    parser.add_argument("data_cfg_file", type=str)
    parser.add_argument("optim_cfg_file", type=str, nargs="?", default=None)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true")
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = EDict(ROOT_DIR=global_cfg.ROOT_DIR, LOCAL_RANK=global_cfg.LOCAL_RANK)
    for path in (args.cfg_file, args.data_cfg_file, args.optim_cfg_file):
        if path:
            cfg_from_yaml_file(path, cfg)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    cfg.TAG = Path(args.cfg_file).stem
    return args, cfg


def eval_ckpt(state, loader, dataset, class_names, n_cap, device, logger=None):
    """The detector of ``state`` over ``loader``: (result_str, results)."""
    det_annos, n_boxes, n_finite = [], 0, 0
    for batch in loader:
        dense = dense_batch_from_collated(batch, n_cap)
        _, boxes, scores, labels, valid = state.model.predict(
            _flatten_local(**_to_device(dense, device)))
        boxes, scores, labels, valid = (t.cpu().numpy() for t in (boxes, scores, labels, valid))
        pred_dicts = [dict(pred_boxes=boxes[b][valid[b]], pred_scores=scores[b][valid[b]],
                           pred_labels=labels[b][valid[b]]) for b in range(boxes.shape[0])]
        det_annos += dataset.generate_prediction_dicts(batch, pred_dicts, class_names)
        n_boxes += sum(len(d["pred_boxes"]) for d in pred_dicts)
        n_finite += sum(int(np.isfinite(d["pred_boxes"]).all(1).sum()) for d in pred_dicts)
    if logger is not None:
        logger.info(f"{n_boxes} predicted boxes, {n_boxes - n_finite} of them not finite")
    # with several ranks, each merges its loader shard's annos to rank 0 (as
    # the JAX CLI; its world size, and this CLI's, is 1: no process group)
    det_annos = dist_utils.merge_results_dist(det_annos, len(dataset))
    if det_annos is None:  # a rank other than 0
        return None, None
    # a non-finite box raises in the metric's matching, as in the JAX CLI
    result_str, results = dataset.evaluation(det_annos, class_names)
    if logger is not None:
        logger.info(result_str)
    return result_str, results


def main(argv=None):
    """Run the CLI on ``argv``; returns ``{checkpoint path (or None):
    results}`` for every checkpoint evaluated."""
    args, cfg = parse_config(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.deterministic = True
    output_dir = Path(cfg.ROOT_DIR) / "output" / cfg.TAG / args.extra_tag / "eval"
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = common_utils.create_logger(
        str(output_dir / ("log_eval_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.batch_size,
                                       training=False)
    model = build_network(cfg.MODEL, runtime_cfg_of(cfg), dataset, device=device)
    make_optimizer, _ = build_optimizer(cfg.get("OPTIMIZATION", {}), 1, 1)
    state = init_train_state(model, make_optimizer, device=device)
    n_cap = int(cfg.MODEL.get("POINT_CAP", 32768))
    classes = list(cfg.CLASS_NAMES)

    def evaluate(path):
        nonlocal state
        if path is not None:
            state = train_utils.load_checkpoint(path, state, with_optimizer=False)
        logger.info(f"evaluating {path or 'the initial weights'}")
        return eval_ckpt(state, loader, dataset, classes, n_cap, device, logger)[1]

    if not args.eval_all:
        return {args.ckpt: evaluate(args.ckpt)}
    results, deadline = {}, time.time() + args.max_waiting_mins * 60
    while True:
        todo = [c for c in train_utils.list_checkpoints(args.ckpt_dir) if c not in results]
        for c in todo:
            results[c] = evaluate(c)
        if todo:
            deadline = time.time() + args.max_waiting_mins * 60
        if time.time() >= deadline:
            return results
        time.sleep(POLL_SECONDS)


if __name__ == "__main__":
    main()
