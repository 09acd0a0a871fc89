"""CPU tests of the readers of the program's own spans and counters
(``program_trace.py`` and the ``metrics/`` files that read it): each reader
on a hand-made record, and on a record without the program's keys (a
program without spans); the idle gaps put down to the innermost covering
span on a hand-made event list; a pass of the tiny PV-RCNN cell's program
with its tracing on. The test marked ``cuda`` reads every reader from the
tiny cells' program on a card and skips elsewhere."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from port_bench import harness, program_trace, spec, training
from port_bench.test_port_bench import _tiny_root

SPAN_READERS = {
    "forward_ms.train": 30.0,
    "backward_ms.train": 50.0,
    "optimizer_ms.train": 5.0,
    "rulebook_ms.train": 7.0,
    "sparse_gemm_ms.train": 4.0 + 6.0,
    "fps_ms.train": 11.0,
}
READERS = tuple(SPAN_READERS) + ("cap_dropped_pct.train",)


def _row(ms, parent):
    return {"calls": 1.0, "device_ms": ms, "self_ms": ms, "host_ms": ms, "parent": parent}


RECORD = {
    "program_spans": {
        "train_step": _row(86.0, None),
        "train_step.forward": _row(30.0, "train_step"),
        "train_step.backward": _row(50.0, "train_step"),
        "train_step.optimizer": _row(5.0, "train_step"),
        "sparse_conv.rulebook": _row(7.0, "backbone_3d"),
        "sparse_conv.gemm": _row(4.0, "backbone_3d"),
        "sparse_conv.gemm_bwd": _row(6.0, "train_step.backward"),
        "fps": _row(11.0, "pfe"),
    },
    "program_counters": {"vfe.points": 400, "vfe.points_dropped": 30},
}


def _reader(name):
    return spec.load_reader(name, spec.HERE.parent)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_record(name):
    r = _reader(name)
    want = SPAN_READERS.get(name, 100.0 * 30 / 400)
    assert r.read(RECORD) == pytest.approx(want)
    assert r.read({"spans_ms": {}, "busy_s": 1.0}) is None  # a program without spans


def test_span_readers_without_their_span():
    no_fps = dict(RECORD, program_spans={k: v for k, v in RECORD["program_spans"].items()
                                         if k != "fps"})
    assert _reader("fps_ms.train").read(no_fps) is None
    one = dict(RECORD, program_spans={"sparse_conv.gemm": _row(4.0, "backbone_3d")})
    assert _reader("sparse_gemm_ms.train").read(one) == 4.0
    cpu = dict(RECORD, program_spans={"fps": dict(_row(1.0, "pfe"), device_ms=None)})
    assert _reader("fps_ms.train").read(cpu) is None  # host times are no device ms
    assert _reader("cap_dropped_pct.train").read(
        dict(RECORD, program_counters={"vfe.points": 0})) is None


def _ev(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_idle_gaps_go_to_the_innermost_covering_span():
    cuda = DeviceType.CUDA
    events = [
        _ev("train_step", 0, 100), _ev("train_step.forward", 0, 40),
        _ev("fps", 10, 30), _ev("aten::add", 12, 14),
        _ev("train_step.backward", 40, 90), _ev("sparse_conv.gemm_bwd", 60, 70),
        _ev("fps", 10, 30, cuda),  # the span's annotation on the device: not an operation
        _ev("k0", 0, 10, cuda), _ev("k1", 20, 22, cuda), _ev("k2", 50, 64, cuda),
        _ev("k3", 66, 80, cuda), _ev("k4", 81, 92, cuda), _ev("k5", 96, 98, cuda),
        _ev("k6", 130, 140, cuda),
    ]
    prof = SimpleNamespace(events=lambda: events)
    gaps = program_trace.idle_by_span(prof, ["train_step", "train_step.forward", "fps",
                                             "train_step.backward", "sparse_conv.gemm_bwd"])
    assert gaps == pytest.approx({
        "fps": 10e-6,  # 10-20, middle 15: fps over the aten op and the forward
        "train_step.forward": 28e-6,  # 22-50, middle 36
        "sparse_conv.gemm_bwd": 2e-6,  # 64-66, middle 65
        "train_step.backward": 1e-6,  # 80-81
        "train_step": 4e-6,  # 92-96: after the backward
        program_trace.OUTSIDE: 32e-6,  # 98-130, middle 114: after every span
    })
    with pytest.raises(RuntimeError):
        program_trace.idle_by_span(SimpleNamespace(events=lambda: events[:4]), ["fps"])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny_root(tmp_path_factory.mktemp("checkout"))


def _program(tiny, workload, device):
    cell = spec.load_cell(tiny, workload)
    pool = harness.make_pool(cell, 2 ** 31 + 7, device)
    prog = training.Program(cell, 2 ** 31 + 7, device)
    n = [0]

    def one_step():
        prog.run_step(training.batch_of(pool, n[0]))
        n[0] += 1
    return one_step


def test_phase_reads_the_programs_spans_and_counters(tiny, monkeypatch):
    one_step = _program(tiny, "pv_rcnn_tiny.train", "cpu")
    rec = program_trace.phase(one_step, 2)
    spans = rec["program_spans"]
    assert spans["train_step"]["calls"] == 1.0 and spans["fps"]["parent"] == "pfe"
    assert spans["sparse_conv.gemm_bwd"]["parent"] == "train_step.backward"
    assert rec["program_counters"]["vfe.points"] > 0 and rec["program_spans_step_s"] > 0
    assert _reader("cap_dropped_pct.train").read(rec) is not None
    from pcseqlearning_tpu_torch.utils import profiler

    assert not profiler.enabled()
    monkeypatch.delattr(profiler, "enable")  # a program without spans of its own
    assert program_trace.phase(one_step, 1) == {}
    assert program_trace.idle_profile(one_step, 1) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["centerpoint_tiny.train", "pv_rcnn_tiny.train"])
def test_every_reader_reads_the_programs_pass_on_a_card(tiny, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.set_precision(False)
    one_step = _program(tiny, workload, "cuda")
    one_step()
    rec = program_trace.phase(one_step, 3)
    for name in READERS:
        v = _reader(name).read(rec)
        assert (v is None) == (name == "fps_ms.train" and "centerpoint" in workload), name
    ms = [rec["program_spans"][k]["device_ms"] for k in
          ("train_step.forward", "train_step.backward", "train_step.optimizer")]
    assert sum(ms) == pytest.approx(rec["program_spans"]["train_step"]["device_ms"], rel=0.1)
    gaps = program_trace.idle_profile(one_step, 2)
    assert gaps and sum(gaps.values()) > 0
