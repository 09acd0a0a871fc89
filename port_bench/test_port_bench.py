"""CPU tests of the benchmark (``python -m pytest port_bench -q``): cells,
mixes, modes and metrics found by name, the FLOP counter against hand counts, the
generator's repeatability, the imports, the result line, and the run with
the timed path broken. Tests marked ``cuda`` run on a card and skip
elsewhere."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import flops, harness, spec, training

REPO = Path(__file__).resolve().parent.parent
NUMBERS = ("loss", "loss1", "grad", "grad_median", "change", "change_median", "bn_stats",
           "bn_median")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
# limits for the tiny cells; the real cells' are in limits/
TINY_LIMITS = {"loss": 0.03, "grad": 0.02, "change": 0.1, "bn_stats": 0.1}
# a second mode, added as a file: a closed loop of sums over the pool's points
SUMS_MODE = '''
import time

import torch


def setup(cell, pool, seed, device, fault=None, log=None):
    return dict(points=pool["points"], n=0, sums=[], fault=fault)


def _step(s):
    total = s["points"][s["n"] % s["points"].shape[0]].double().sum()
    s["sums"].append((s["n"], float(total) + (1.0 if s["fault"] else 0.0)))
    s["n"] += 1


def window(s, seconds):
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        _step(s)
    return {"sums_per_s": len(s["sums"]) / (time.perf_counter() - start)}


def traced_window(s, seconds):
    window(s, seconds)
    return dict(steps=s["n"], busy_s=0.5, profiled_s=1.0,
                breakdown={"device_ops": [], "idle_gaps": []})


def check(s, names):
    pts = s["points"].double()
    gap = max(abs(v - float(pts[i % pts.shape[0]].sum())) for i, v in s["sums"])
    return dict(numbers={"sum_gap": gap}, attempted=s["n"], failed=0)
'''


def _tiny_root(root):
    """A checkout with the benchmark, a tiny mix, tiny configurations and a
    metric, each added as files and entries only."""
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "port_bench"
    traffic = json.loads((pb / "traffic" / "waymo_1sweep_b2.json").read_text())
    traffic["pool"] = 3
    for lidar in traffic["lidars"]:
        lidar["rows"], lidar["cols"] = max(8, lidar["rows"] // 16), max(32, lidar["cols"] // 16)
    traffic["max_range"] = 9.0
    traffic["objects"].update(count=6, r_min=2.0, r_max=6.0, slot=2.5)
    traffic["structures"].update(count=4, r_min=7.0, r_max=9.0)
    (pb / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    for name in ("centerpoint", "pv_rcnn"):
        cfg = json.loads((pb / "configs" / f"{name}.json").read_text())
        cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"] = [-6.4, -6.4, -2, 6.4, 6.4, 4]
        cfg["MODEL"].update(VOXEL_CAP=1500, POINT_CAP=4000)
        if "PFE" in cfg["MODEL"]:
            cfg["MODEL"]["PFE"]["NUM_KEYPOINTS"] = 64
        (pb / "configs" / f"{name}_tiny.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": f"{name}_tiny", "source": "tiny",
                                 "file": f"port_bench/configs/{name}_tiny.json", "reduced": [],
                                 "why": "tiny"})
        cell = f"{name}_tiny.train"
        bench["workloads"].append({"name": cell, "config": f"{name}_tiny", "traffic": "tiny",
                                   "chips": 1, "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:  # as its full-size cell
            if f"{name}.train" in m.get("workloads", ()):
                m["workloads"].append(cell)
        limits = {"numbers": {k: {"limit": v} for k, v in TINY_LIMITS.items()}}
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (pb / "metrics" / "steps_seen.train.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "step",
                               "moves": "train_samples_per_s",
                               "workloads": ["centerpoint_tiny.train"]})
    # a second mode with its own end-to-end and per-layer metrics
    (pb / "modes" / "point_sums.py").write_text(SUMS_MODE)
    (pb / "traffic" / "tiny_sums.json").write_text(json.dumps(dict(traffic, mode="point_sums")))
    (pb / "limits" / "centerpoint_tiny.sums.json").write_text(
        json.dumps({"numbers": {"sum_gap": {"limit": 1e-6}}}))
    bench["workloads"].append({"name": "centerpoint_tiny.sums", "config": "centerpoint_tiny",
                               "traffic": "tiny_sums", "chips": 1, "why": "tiny"})
    bench["end_to_end"].append({"name": "sums_per_s", "unit": "sums/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["centerpoint_tiny.sums"]})
    (pb / "metrics" / "steps_seen.sums.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    bench["per_layer"].append({"name": "steps_seen.sums", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "step", "moves": "sums_per_s",
                               "workloads": ["centerpoint_tiny.sums"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def test_cells_mixes_and_metrics_found_by_name(tiny):
    cell = spec.load_cell(tiny, "centerpoint_tiny.train")
    assert cell.traffic["pool"] == 3 and cell.config["MODEL"]["VOXEL_CAP"] == 1500
    names = [n for n, _, _ in cell.per_layer]
    assert "steps_seen.train" in names and "pfe_ms.train" not in names
    reader = dict((n, r) for n, _, r in cell.per_layer)["steps_seen.train"]
    assert reader.read({"steps": 7}) == 7.0
    pv = spec.load_cell(tiny, "pv_rcnn_tiny.train")
    assert "pfe_ms.train" in [n for n, _, _ in pv.per_layer]
    with pytest.raises(KeyError):
        spec.load_cell(tiny, "no_such.train")


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(REPO, w["name"])
        mode = spec.load_mode(cell.traffic["mode"], REPO)
        for fn in ("setup", "window", "traced_window", "check"):
            assert callable(getattr(mode, fn)), fn
        assert cell.limits["numbers"] and all("limit" in v for v in cell.limits["numbers"].values())
        names = [n for n, _ in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer, w["name"]


def test_a_mode_added_as_a_file_runs_with_its_own_metrics(tiny):
    cell = spec.load_cell(tiny, "centerpoint_tiny.sums")
    assert sorted(n for n, _ in cell.end_to_end) == ["setup_s", "sums_per_s"]
    assert [n for n, _, _ in cell.per_layer] == ["steps_seen.sums"]
    r = harness.run(tiny, "centerpoint_tiny.sums", 2 ** 31 + 5, 0.2, False, device="cpu")
    assert set(r["metrics"]) == {"sums_per_s", "setup_s"} and r["correct"] is True
    assert r["checks"] == {"sum_gap": {"value": 0.0, "limit": 1e-6}}
    r = harness.run(tiny, "centerpoint_tiny.sums", 2 ** 31 + 5, 0.2, True, device="cpu")
    assert set(r["metrics"]) == {"steps_seen.sums"} and r["device"]["busy_s"] == 0.5
    r = harness.run(tiny, "centerpoint_tiny.sums", 2 ** 31 + 5, 0.2, False, device="cpu",
                    fault="wrong_sum")
    assert r["correct"] is False


def test_dense_conv_hand_count():
    # 1 x 2 x 4 x 4 -> 3 channels, 3 x 3 'same': 48 outputs x 18 products x 2
    fl, by = flops._conv2d(1, 2, 3, 4, 4, 3, 4, 4)
    assert fl == 3 * 2 * 48 * 18
    assert by == 3 * 4 * (2 * 16 + 2 * 3 * 9 + 3 * 16)


def test_sparse_conv_hand_count():
    shape = (4, 4, 4)
    line = torch.tensor([[0, 1, 1, 0], [0, 1, 1, 1], [0, 1, 1, 2]])
    # each site with itself, plus the two adjacent pairs both ways
    assert flops.subm_pairs(line, shape) == 3 + 4
    far = torch.tensor([[0, 0, 0, 0], [1, 0, 0, 0]])  # two samples: no cross pairs
    assert flops.subm_pairs(far, shape) == 2
    # kernel 3, stride 2, padding 1: a site at 0 feeds output 0 once; at 1, outputs 0 and 1
    out, oshape, pairs = flops.strided(torch.tensor([[0, 0, 0, 0]]), shape, (3, 3, 3),
                                       (2, 2, 2), (1, 1, 1), 100)
    assert oshape == (2, 2, 2) and pairs == 1 and out.tolist() == [[0, 0, 0, 0]]
    out, _, pairs = flops.strided(torch.tensor([[0, 1, 1, 1]]), shape, (3, 3, 3), (2, 2, 2),
                                  (1, 1, 1), 100)
    assert pairs == 8 and len(out) == 8
    _, _, pairs = flops.strided(torch.tensor([[0, 1, 1, 1]]), shape, (3, 3, 3), (2, 2, 2),
                                (1, 1, 1), 3)  # the cap keeps the first three outputs
    assert pairs == 3


def test_step_work_counts_the_capped_voxels(tiny):
    cell = spec.load_cell(tiny, "centerpoint_tiny.train")
    pool = harness.make_pool(cell, 5, "cpu")
    w = flops.step_work(cell.config, pool["points"][0], pool["valid"][0])
    assert w["voxels_kept"] == min(1500, sum(w["voxels_per_sample"]))
    assert w["flops"] == sum(w["parts"].values()) and w["bev_flops"] == w["parts"]["bev2d"]


def test_generator_repeats_for_a_seed(tiny):
    cell = spec.load_cell(tiny, "centerpoint_tiny.train")
    a, b = (harness.make_pool(cell, 2 ** 31 + 11, "cpu") for _ in range(2))
    c = harness.make_pool(cell, 2 ** 31 + 12, "cpu")
    d = harness.make_pool(cell, 2 ** 32 + 2 ** 31 + 11, "cpu")  # every bit of the seed counts
    for k in ("points", "feats", "valid", "gt_boxes"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["points"], c["points"]) and not torch.equal(a["points"], d["points"])
    assert a["returns"] == b["returns"] and min(a["returns"]) > 0
    gt = a["gt_boxes"][0, 0]
    assert set(gt[gt[:, 7] > 0, 7].tolist()) <= {1.0, 2.0, 3.0}


def _env(checkout):
    """The tiny checkout's benchmark, with the program from this repository."""
    return dict(os.environ, PYTHONPATH=f"{checkout}{os.pathsep}{REPO}")


def _modules_after(code, cwd):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=600, env=_env(cwd))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_imports_jax_or_the_jax_package(tiny):
    code = ("import sys, json, torch; torch.set_num_threads(2)\n"
            "from port_bench import harness, run, controls\n"
            "harness.run('.', 'pv_rcnn_tiny.train', 3, 0.5, False, device='cpu')\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    tops = _modules_after(code, tiny)
    assert not tops & {"jax", "jaxlib", "flax", "pcseqlearning_tpu"}
    assert "pcseqlearning_tpu_torch" in tops


def test_reference_imports_nothing_of_the_program(tiny):
    code = ("import sys, json, torch; torch.set_num_threads(2)\n"
            "from port_bench import reference as ref, spec, harness, training\n"
            "cell = spec.load_cell('.', 'pv_rcnn_tiny.train')\n"
            "pool = harness.make_pool(cell, 3, 'cpu')\n"
            "net = ref.build(cell.config, torch.float64, 'cpu')\n"
            "opt = ref.optimizer(cell.config, list(net.parameters()))\n"
            "ref.train_step(net, opt, training.batch_of(pool, 0), ref.loss_key(cell.config['MODEL']))\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    tops = _modules_after(code, tiny)
    assert not tops & {"jax", "jaxlib", "flax", "pcseqlearning_tpu", "pcseqlearning_tpu_torch"}


def test_the_reference_is_the_program_at_its_precision(tiny):
    cell = spec.load_cell(tiny, "pv_rcnn_tiny.train")
    pool = harness.make_pool(cell, 9, "cpu")
    prog = training.Program(cell, 9, "cpu")
    r = prog.first_steps(pool)
    same = training.reference_readings(cell, prog.weights, pool, "cpu", dtype=torch.float32)
    assert training.compare(r.summary(), same) == dict.fromkeys(NUMBERS, 0.0)


def test_result_line_has_the_contract_keys(tiny):
    r = harness.run(tiny, "centerpoint_tiny.train", 2 ** 33 + 1, 0.5, False, device="cpu")
    assert set(r) == RESULT_KEYS and list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == set(TINY_LIMITS)


@pytest.mark.parametrize("fault", training.FAULTS)
@pytest.mark.parametrize("workload", ["centerpoint_tiny.train", "pv_rcnn_tiny.train"])
def test_a_broken_step_reads_not_correct(tiny, workload, fault):
    r = harness.run(tiny, workload, 77, 0.3, False, device="cpu", fault=fault)
    assert r["correct"] is False, r["checks"]


def test_run_without_a_card_exits_with_no_result(tiny):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          "centerpoint_tiny.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tiny, capture_output=True, text=True, timeout=300,
                         env=_env(tiny))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_control_in_lower_precision_reads_not_correct(tiny, card):
    """The reference in float32 with TF32 on, in the program's place, lies
    further from the float64 reference than the program does, on three
    seeds (at the tiny size; the cells' readings are in PERF.md)."""
    cell = spec.load_cell(tiny, "centerpoint_tiny.train")
    for seed in (1, 2, 3):
        harness.set_precision(False)
        pool = harness.make_pool(cell, seed, card)
        prog = training.Program(cell, seed, card)
        r = prog.first_steps(pool)
        ref = training.reference_readings(cell, prog.weights, pool, card)
        sound = training.compare(r.summary(), ref)
        ctl = training.compare(training.control_readings(cell, prog.weights, pool, card), ref)
        assert ctl["grad"] > 3 * sound["grad"], (sound, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["centerpoint_tiny.train", "pv_rcnn_tiny.train"])
def test_traced_run_reads_every_per_layer_metric(tiny, card, workload):
    """The traced window on a card: every per-layer metric of the cell is
    read, from the CUDA-only trace, the layer spans and the plain steps."""
    cell = spec.load_cell(tiny, workload)
    r = harness.run(tiny, workload, 2 ** 31 + 21, 3.0, True, device=card)
    assert set(r["metrics"]) == {n for n, _, _ in cell.per_layer}
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
