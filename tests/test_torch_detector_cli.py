"""The detector's training and evaluation CLIs, ``python -m
pcseqlearning_tpu_torch.train`` and ``python -m pcseqlearning_tpu_torch.test``,
on the CPU over a tiny written Waymo sequence.

centerpoint.yaml, detection_1sweep.yaml and onecycle_centerpoint.yaml,
shrunk through ``--set`` only (a 1.6 m grid over +-76.8 m, one-block BEV
stages of 16 and 32 filters, caps to fit): two epochs write both
checkpoints, a second fresh run writes the same checkpoints bit for bit,
``--epochs 3`` resumes at epoch 2 with the schedule's count, rotation keeps
``--max_ckpt_save_num``; the test CLI returns finite AP/APH for one
checkpoint and visits each checkpoint once under ``--eval_all
--max_waiting_mins 0``. Without a card, ``--device cuda`` (the default)
raises in both.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pcseqlearning_tpu_torch import test as test_cli
from pcseqlearning_tpu_torch import train
from pcseqlearning_tpu_torch.scene import detector_argv, write_detector_sequences

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
SHRINK = ["DATA_CONFIG.POINT_CLOUD_RANGE", "[-76.8,-76.8,-2,76.8,76.8,4]",
          "DATA_CONFIG.VOXEL_SIZE", "[1.6,1.6,0.2]",
          "DATA_CONFIG.DATA_PROCESSOR.2.VOXEL_SIZE", "[1.6,1.6,0.2]",
          "MODEL.POINT_CAP", "2000", "MODEL.VOXEL_CAP", "1024",
          "MODEL.BACKBONE_2D.LAYER_NUMS", "[1,1]", "MODEL.BACKBONE_2D.NUM_FILTERS", "[16,32]",
          "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16,16]"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    train_path, val_path = write_detector_sequences(root, frames=4, points=2000, val_frames=2)
    return root, train_path, val_path


def train_argv(data, tag, epochs, *extra):
    root, train_path, _ = data
    return detector_argv(REPO, train_path, root, "cpu", "--batch_size", "2", "--epochs",
                         str(epochs), "--fix_random_seed", "--extra_tag", tag, *extra,
                         overrides=SHRINK)


def load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def trained(data):
    """Two epochs under tag "a": (result, checkpoint_epoch_2's contents)."""
    res = train.main(train_argv(data, "a", 2))
    return res, load(Path(res["ckpt_dir"]) / "checkpoint_epoch_2")


def test_two_epochs_write_both_checkpoints(trained):
    res, ckpt = trained
    hist = res["history"]
    assert res["start_epoch"] == 0 and len(hist) == 4  # 4 frames, batch 2, 2 epochs
    assert sorted(os.listdir(res["ckpt_dir"])) == ["checkpoint_epoch_1", "checkpoint_epoch_2"]
    assert all(math.isfinite(v) for h in hist for v in h["losses"].values())
    assert [h["lr"] for h in hist] == [float(res["schedule"](i)) for i in range(4)]
    assert hist[0]["lr"] == pytest.approx(0.003 / 10, rel=1e-6)  # LR / DIV_FACTOR
    assert ckpt["step"] == ckpt["optimizer"]["count"] == 4
    # the VFE takes x, y, z and detection_1sweep's two point features
    assert ckpt["model"]["backbone_3d.conv_input.weight"].shape[-2] == 5


def test_a_second_fresh_run_repeats_bit_for_bit(data, trained):
    res = train.main(train_argv(data, "b", 2))
    other, (_, ckpt) = load(Path(res["ckpt_dir"]) / "checkpoint_epoch_2"), trained
    assert set(other["model"]) == set(ckpt["model"])
    assert all(torch.equal(v, other["model"][k]) for k, v in ckpt["model"].items())
    for k, ts in ckpt["optimizer"]["moments"].items():
        assert all(torch.equal(a, b) for a, b in zip(ts, other["optimizer"]["moments"][k]))


def test_resume_at_epoch_two_with_rotation(data, trained):
    """``--epochs 3`` picks up checkpoint_epoch_2: one epoch, its first
    update at sched(4) of the 6-update schedule, in a subprocess as a user
    runs it."""
    res, _ = trained
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "pcseqlearning_tpu_torch.train",
                          *train_argv(data, "a", 3, "--max_ckpt_save_num", "2")],
                         cwd=data[0], env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    log = out.stdout + out.stderr
    assert "checkpoint_epoch_2 at epoch 2" in log and "epoch 2 it 0/2" in log
    assert "epoch 0 it" not in log
    assert sorted(os.listdir(res["ckpt_dir"])) == ["checkpoint_epoch_2", "checkpoint_epoch_3"]
    ckpt3 = load(Path(res["ckpt_dir"]) / "checkpoint_epoch_3")
    assert ckpt3["optimizer"]["count"] == 6 and ckpt3["step"] == 6


def test_evaluation_cli(data, trained):
    root, _, val_path = data
    res, _ = trained
    argv = detector_argv(REPO, val_path, root, "cpu", "--extra_tag", "a", overrides=SHRINK)
    ckpt = str(Path(res["ckpt_dir"]) / "checkpoint_epoch_2")
    one = test_cli.main(argv[:3] + ["--ckpt", ckpt] + argv[3:])
    assert list(one) == [ckpt]
    table = one[ckpt]
    assert {"Vehicle/L1/AP", "Vehicle/L2/APH", "Cyclist/RANGE_[50,INF)/APH"} <= set(table)
    assert all(math.isfinite(v) for v in table.values())
    assert list((Path(root) / "output" / "centerpoint" / "a" / "eval").glob("log_eval_*.txt"))
    every = test_cli.main(argv[:3] + ["--eval_all", "--ckpt_dir", res["ckpt_dir"],
                                      "--max_waiting_mins", "0"] + argv[3:])
    assert [Path(p).name for p in every] == sorted(os.listdir(res["ckpt_dir"]),
                                                   key=lambda n: int(n.rsplit("_", 1)[-1]))
    assert all(math.isfinite(v) for r in every.values() for v in r.values())
    assert every[ckpt] == table  # the same checkpoint scores the same


def test_clis_need_a_card_unless_cpu(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, train_path, val_path = data
    argv = detector_argv(REPO, train_path, root, "cuda", overrides=SHRINK)
    assert train.parse_config(argv[:3])[0].device == "cuda"  # the default
    assert test_cli.parse_config(argv[:2])[0].device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        test_cli.main(detector_argv(REPO, val_path, root, "cuda", overrides=SHRINK))


@pytest.mark.parametrize("model", ["second", "voxel_rcnn"])
def test_anchor_and_two_stage_detectors_through_both_clis(data, model):
    """second.yaml and voxel_rcnn.yaml with detection_1sweep.yaml and
    adam_onecycle.yaml, shrunk as above (Voxel R-CNN also to 32 RoIs a
    sample): one epoch writes its checkpoint with finite losses (rpn_loss;
    total_loss with the RoI losses), and the test CLI scores it with every
    predicted box and every AP/APH value finite."""
    root, train_path, val_path = data
    cfgs = (f"tools/cfgs/waymo_models/{model}.yaml",
            "tools/cfgs/dataset_configs/waymo/detection_1sweep.yaml",
            "tools/cfgs/optimizers/adam_onecycle.yaml")
    shrink = SHRINK + (["MODEL.ROI_HEAD.NMS_POST_MAXSIZE", "32"] if model == "voxel_rcnn" else [])
    res = train.main(detector_argv(REPO, train_path, root, "cpu", "--batch_size", "2", "--epochs",
                                   "1", "--fix_random_seed", "--extra_tag", "cli", cfgs=cfgs,
                                   overrides=shrink))
    hist = res["history"]
    key = "total_loss" if model == "voxel_rcnn" else "rpn_loss"
    assert len(hist) == 2 and all(math.isfinite(h["losses"][key]) for h in hist)
    if model == "voxel_rcnn":
        assert {"rcnn_loss_cls", "rcnn_loss_reg", "center_loss"} <= set(hist[0]["losses"])
    assert os.listdir(res["ckpt_dir"]) == ["checkpoint_epoch_1"]
    argv = detector_argv(REPO, val_path, root, "cpu", "--extra_tag", "cli", cfgs=cfgs,
                         overrides=shrink)
    ckpt = str(Path(res["ckpt_dir"]) / "checkpoint_epoch_1")
    table = test_cli.main(argv[:3] + ["--ckpt", ckpt] + argv[3:])[ckpt]
    assert {"Vehicle/L1/AP", "Vehicle/L2/APH"} <= set(table)
    assert all(math.isfinite(v) for v in table.values())
