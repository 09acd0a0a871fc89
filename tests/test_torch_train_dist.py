"""The detector-training CLI, ``train.main``, at world size 2 (two gloo
ranks, spawned processes joined through a FileStore under tmp_path, each
calling ``train.main`` in the default group it made) against world size 1
on the CPU: centerpoint.yaml, detection_1sweep.yaml and
onecycle_centerpoint.yaml at test_torch_detector_cli.py's tiny size (4
frames of 2,000 points, batch 2, one epoch: two steps, one sample per
rank), shrunk through ``--set`` only.

The data make dp = 2 and dp = 1 the same function (checked batch by batch
with ``parallel.train_step.dp_equivalence_issues``): the scene's 8 boxes
lie on a 40 m ring (each on its own heatmap cell, none dropped by the
augmentation or the range mask, points' z inside the range), POINT_CAP
(1,500) is below every sample's point count (no padding) and VOXEL_CAP
(16,000) fills no table. The grid is 0.8 m, not the CLI test's 1.6 m: on
the 1.6 m grid's 12 x 12 BEV map the float32 gradients of the small BEV
batch norms are noisy enough (1.4% of a tensor's max |g| between the two
arms, against 6e-15 in float64) that Adam's first update moves the second
step's losses by ~1e-3.

Tolerances: the first step's losses (and grad_norm) within 1e-4 relative,
the second step's losses within 1e-3. The ranks end with equal parameters,
buffers and optimizer state, bit for bit; only rank 0 writes the log and
the checkpoints; a world-size-1 checkpoint resumes at world size 2 at its
epoch. This file imports no JAX (the spawned ranks import it).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pcseqlearning_tpu_torch import train
from pcseqlearning_tpu_torch.datasets import build_dataloader
from pcseqlearning_tpu_torch.models import build_network
from pcseqlearning_tpu_torch.parallel.train_step import (dense_batch_from_collated,
                                                         dp_equivalence_issues)
from pcseqlearning_tpu_torch.runtime import train_utils
from pcseqlearning_tpu_torch.scene import detector_argv, write_detector_sequences
from pcseqlearning_tpu_torch.utils import dist_utils

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
SHRINK = ["DATA_CONFIG.POINT_CLOUD_RANGE", "[-76.8,-76.8,-2,76.8,76.8,4]",
          "DATA_CONFIG.VOXEL_SIZE", "[0.8,0.8,0.2]",
          "DATA_CONFIG.DATA_PROCESSOR.2.VOXEL_SIZE", "[0.8,0.8,0.2]",
          "MODEL.POINT_CAP", "1500", "MODEL.VOXEL_CAP", "16000",
          "MODEL.BACKBONE_2D.LAYER_NUMS", "[1,1]", "MODEL.BACKBONE_2D.NUM_FILTERS", "[16,32]",
          "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16,16]"]
HEAD_LOSSES = ("hm_loss", "loc_loss", "center_loss")


def argv(root, train_path, tag, epochs):
    return detector_argv(REPO, train_path, root, "cpu", "--batch_size", "2", "--epochs",
                         str(epochs), "--fix_random_seed", "--extra_tag", tag, overrides=SHRINK)


def _rank(rank, world, args):
    torch.set_num_threads(1)
    res = train.main(args)
    st = res["state"]
    return dict(history=res["history"], start_epoch=res["start_epoch"], step=st.step,
                model={k: v.clone() for k, v in st.model.state_dict().items()},
                optimizer=st.optimizer.state_dict())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_dist")
    train_path, _ = write_detector_sequences(root, frames=4, points=2000, ring=40.0, n_clusters=8)
    return root, train_path


@pytest.fixture(scope="module")
def world1(data):
    return train.main(argv(*data, "w1", 1))


@pytest.fixture(scope="module")
def world2(data, world1):
    root = data[0]
    return dist_utils.launch_ranks(_rank, 2, str(root / "store_w2"),
                                   args=(argv(*data, "w2", 1),), timeout=180)


def test_batches_meet_the_equivalence_conditions(data):
    _, cfg = train.parse_config(argv(*data, "check", 1))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, training=True,
                                       rng=np.random.RandomState(train.SEED))
    model = build_network(cfg.MODEL, train.runtime_cfg_of(cfg), dataset, device="cpu")
    loader.set_epoch(0)
    n = 0
    for batch in loader:
        issues, fills = dp_equivalence_issues(
            model, dense_batch_from_collated(batch, int(cfg.MODEL.POINT_CAP)), 2)
        assert issues == [], issues
        n += 1
    assert n == 2


def test_first_step_losses_equal(world1, world2):
    ref = world1["history"][0]["losses"]
    for r in world2:
        got = r["history"][0]["losses"]
        for k in HEAD_LOSSES + ("grad_norm",):
            print(f"step 1 {k}: relative error {abs(got[k] / ref[k] - 1):.2e}")
            assert abs(got[k] / ref[k] - 1) < 1e-4, (k, got[k], ref[k])


def test_second_step_losses_equal(world1, world2):
    ref = world1["history"][1]["losses"]
    assert len(world1["history"]) == 2
    for r in world2:
        assert len(r["history"]) == 2
        got = r["history"][1]["losses"]
        for k in HEAD_LOSSES + ("grad_norm",):
            print(f"step 2 {k}: relative error {abs(got[k] / ref[k] - 1):.2e}")
        for k in HEAD_LOSSES:
            assert abs(got[k] / ref[k] - 1) < 1e-3, (k, got[k], ref[k])


def test_ranks_end_equal(world2):
    a, b = world2
    assert a["step"] == b["step"] == 2
    assert all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["count"] == ob["count"]
    for k, ts in oa["moments"].items():
        assert all(torch.equal(x, y) for x, y in zip(ts, ob["moments"][k]))


def test_only_rank0_writes(world1, world2):
    out = Path(world1["ckpt_dir"]).parent.parent / "w2"
    assert len(list(out.glob("log_train_*.txt"))) == 1
    assert sorted(os.listdir(out / "ckpt")) == ["checkpoint_epoch_1"]
    ckpt = torch.load(out / "ckpt" / "checkpoint_epoch_1", map_location="cpu", weights_only=True)
    assert all(torch.equal(v, world2[0]["model"][k]) for k, v in ckpt["model"].items())
    assert train_utils.save_checkpoint(None, str(out / "ckpt"), 9, rank=1) is None
    assert sorted(os.listdir(out / "ckpt")) == ["checkpoint_epoch_1"]


def test_world1_checkpoint_resumes_at_world2(data, world1, world2):
    """Two ranks pick up world 1's checkpoint_epoch_1 and train epoch 1."""
    root = data[0]
    ranks = dist_utils.launch_ranks(_rank, 2, str(root / "store_resume"),
                                    args=(argv(*data, "w1", 2),), timeout=180)
    for r in ranks:
        assert r["start_epoch"] == 1 and len(r["history"]) == 2 and r["step"] == 4
        assert r["optimizer"]["count"] == 4
    assert all(torch.equal(v, ranks[1]["model"][k]) for k, v in ranks[0]["model"].items())
    assert sorted(os.listdir(world1["ckpt_dir"])) == ["checkpoint_epoch_1", "checkpoint_epoch_2"]
