"""The port's offline tools against the JAX package's: the segmentation-label
propagation (``tools/propagate_segmentation_labels.py``) on a converted
sequence, the feature-leakage evaluation (``tools/waymo_fl_eval.py``) on
perfect, jittered, empty and missing-frame predictions, and the three CLIs'
device rule (the card by default; without one they raise unless given
``--device cpu``), the converter's spawn pool included.

Tolerances: the ``_propseg.npy`` files and write counts are equal; the
leakage statistics agree to 1e-6 (both are float32 IoUs of the same
arithmetic).
"""

import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from pcseqlearning_tpu_torch.scene import WAYMO_LIDARS, write_waymo_tfrecord
from pcseqlearning_tpu_torch.tools import create_waymo_infos as tcw
from pcseqlearning_tpu_torch.tools import propagate_segmentation_labels as tps
from pcseqlearning_tpu_torch.tools import waymo_fl_eval as tfl

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LIDARS = [(n, 16 if n == "TOP" else 4, 128 if n == "TOP" else 16, *rest)
          for n, _, _, *rest in WAYMO_LIDARS]
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]


def _converted(tmp_path, name="seg-prop", frames=6, seg_frames=(0, 3), seed=8):
    """A synthetic sequence converted by the port on the CPU: its
    directory and infos."""
    raw = tmp_path / "raw"
    raw.mkdir(exist_ok=True)
    write_waymo_tfrecord(raw / f"{name}.tfrecord", frames, seed=seed, lidars=LIDARS,
                         labels=12, seg_frames=seg_frames)
    infos = tcw.process_single_sequence(str(raw / f"{name}.tfrecord"),
                                        str(tmp_path / "data" / "waymo_processed_data"),
                                        device="cpu")
    return tmp_path / "data" / "waymo_processed_data" / name, infos


def test_propagation_equals_jax(tmp_path):
    from propagate_segmentation_labels import process_sequence as jprocess

    seq, infos = _converted(tmp_path)
    shutil.copytree(seq, tmp_path / "jax_seq")
    n_port = tps.process_sequence(seq, infos, device="cpu")
    n_jax = jprocess(tmp_path / "jax_seq", infos)
    assert n_port == n_jax == 4
    labeled = 0
    for info in infos:
        idx = info["point_cloud"]["sample_idx"]
        f = f"{idx:04d}_propseg.npy"
        assert (seq / f).exists() == (tmp_path / "jax_seq" / f).exists() == (idx not in (0, 3))
        if (seq / f).exists():
            a, b = np.load(seq / f), np.load(tmp_path / "jax_seq" / f)
            assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
            labeled += int((a[:, 1] > 0).sum())
            assert set(np.unique(a[:, 0])) <= set(range(13))  # box index + 1
    assert labeled > 0


def _gt_infos(rng, frames=3):
    """GT annos of three classes (and a Sign) with tracking difficulties."""
    infos = []
    for f in range(frames):
        names = np.array(["Vehicle", "Pedestrian", "Cyclist"] * 3 + ["Sign"])
        boxes = np.zeros((len(names), 7), np.float32)
        boxes[:, :2] = rng.uniform(-30, 30, (len(names), 2))
        boxes[:, 2] = rng.uniform(-1, 1, len(names))
        boxes[:, 3:6] = rng.uniform(0.6, 4.5, (len(names), 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, len(names))
        infos.append(dict(frame_id=f"seq_{f:03d}", name=names, gt_boxes_lidar=boxes,
                          tracking_difficulty=rng.randint(0, 3, len(names))))
    return infos


def _predictions(rng, gt, kind):
    preds = []
    for info in gt:
        b = info["gt_boxes_lidar"].copy()
        names = info["name"].copy()
        if kind == "jittered":
            b[:, :3] += rng.normal(0, 0.15, (len(b), 3)).astype(np.float32)
            b[:, 3:6] *= (1 + rng.normal(0, 0.08, (len(b), 3))).astype(np.float32)
            b[:, 6] += rng.normal(0, 0.1, len(b)).astype(np.float32)
        elif kind == "empty":
            b, names = np.zeros((0, 7), np.float32), np.zeros(0, "<U10")
        preds.append(dict(frame_id=info["frame_id"], name=names, boxes_lidar=b,
                          score=np.ones(len(b), np.float32)))
    if kind == "missing_frame":
        preds[1]["frame_id"] = "seq_999"
    return preds


@pytest.mark.parametrize("kind", ["perfect", "jittered", "empty", "missing_frame"])
def test_feature_leakage_equals_jax(kind, capsys):
    from waymo_fl_eval import eval_feature_leakage as jeval

    rng = np.random.RandomState(5)
    gt = _gt_infos(rng)
    preds = _predictions(rng, gt, kind)
    ref = jeval(gt, preds, CLASSES)
    got = tfl.eval_feature_leakage(gt, preds, CLASSES, device="cpu")
    assert got.keys() == ref.keys()
    for cls in CLASSES:
        assert got[cls].keys() == ref[cls].keys()
        for lvl, s in ref[cls].items():
            assert got[cls][lvl]["n"] == s["n"]
            for k in ("mean_iou", "p50", "p90", "recall_0_7"):
                assert abs(got[cls][lvl][k] - s[k]) <= 1e-6, (cls, lvl, k)
    if kind == "perfect":
        assert all(s["recall_0_7"] == 1.0 for c in CLASSES for s in got[c].values())
    if kind == "missing_frame":
        assert capsys.readouterr().out.count("WARNING: 1/3 gt frames") == 2


def test_clis_raise_without_a_card_unless_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    seq, infos = _converted(tmp_path, frames=2, seg_frames=(0,))
    cfg = tmp_path / "data.yaml"
    data_path = tmp_path / "data"
    cfg.write_text((REPO / "tools/cfgs/dataset_configs/waymo/detection_1sweep.yaml").read_text()
                   .replace("    DATA_PATH: data/waymo\n", f"    DATA_PATH: '{data_path}'\n")
                   .replace("PROCESSED_DATA_TAG: waymo_processed_data_v0_5_0",
                            "PROCESSED_DATA_TAG: waymo_processed_data"))
    gt_pkl, pred_pkl = tmp_path / "gt.pkl", tmp_path / "pred.pkl"
    gt_pkl.write_bytes(pickle.dumps(infos))
    pred_pkl.write_bytes(pickle.dumps([dict(frame_id=i["frame_id"], name=i["annos"]["name"],
                                            boxes_lidar=i["annos"]["gt_boxes_lidar"])
                                       for i in infos]))
    argvs = {
        tcw.main: ["--raw_dir", str(tmp_path / "raw"), "--out_dir", str(tmp_path / "again"),
                   "--workers", "1"],
        tps.main: [str(cfg)],
        tfl.main: ["--pred_infos", str(pred_pkl), "--gt_infos", str(gt_pkl)],
    }
    for main, argv in argvs.items():
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    for fn, args in ((tcw.process_single_sequence, (str(tmp_path / "raw" / "seg-prop.tfrecord"),
                                                    str(tmp_path / "x"))),
                     (tps.process_sequence, (seq, infos)),
                     (tfl.eval_feature_leakage, ([], [], CLASSES))):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(*args)
    (_, timings), = tcw.main(argvs[tcw.main] + ["--device", "cpu"])
    assert timings["frames"] == 2
    assert tps.main(argvs[tps.main] + ["--device", "cpu"]) == {"seg-prop": 1}
    stats = tfl.main(argvs[tfl.main] + ["--device", "cpu"])
    assert stats["Vehicle"][0]["recall_0_7"] == 1.0
    out = capsys.readouterr().out
    assert "seg-prop: wrote 1 propseg frames" in out and "Vehicle tracking_difficulty=0" in out


def test_converter_spawn_pool_equals_one_process(tmp_path):
    """--workers 2 over two sequences (a spawn pool, a sequence a worker)
    writes what one process writes."""
    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(2):
        write_waymo_tfrecord(raw / f"seg-{i}.tfrecord", 2, seed=i, lidars=LIDARS, labels=5)
    runs = {}
    for workers in ("1", "2"):
        out = tmp_path / f"out{workers}"
        res = tcw.main(["--raw_dir", str(raw), "--out_dir", str(out), "--workers", workers,
                        "--device", "cpu"])
        assert [name for name, _ in res] == ["seg-0.tfrecord", "seg-1.tfrecord"]
        runs[workers] = {p.relative_to(out): p.read_bytes() for p in sorted(out.rglob("*"))
                         if p.is_file()}
    assert len(runs["1"]) == 2 * (2 + 1 + 1) and runs["1"] == runs["2"]
