"""The port's offline Waymo path against the JAX package's: the TFRecord
CRCs and files, the wire-format reader against protobuf's parser (on frames
protobuf wrote, and on hand-made encodings protobuf reads: negative int32
varints, packed doubles, absent optionals, unknown fields of every wire
type, a closed enum's unknown value, a message given twice), protobuf's
parser on the port writer's frames, and ``create_waymo_infos``'s third tier
(``tools/create_waymo_infos.py``) on the same TFRecord.

The JAX tool runs its third tier here: TensorFlow, where installed, is
hidden from it, since the port converts without it. Tolerances:
none (CRCs, bytes, fields, infos, labels and point counts are equal); xyz
and range to 1e-6 m (both are float64 arithmetic cast to float32).
"""

import pickle
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from pcseqlearning_tpu.datasets import tfrecord_io as jtf
from pcseqlearning_tpu.datasets.waymo_protos import dataset_pb2
from pcseqlearning_tpu_torch.datasets import tfrecord_io as ttf
from pcseqlearning_tpu_torch.datasets import waymo_protos as W
from pcseqlearning_tpu_torch.datasets.waymo_protos import wire
from pcseqlearning_tpu_torch.scene import WAYMO_LIDARS, write_waymo_tfrecord
from pcseqlearning_tpu_torch.tools import create_waymo_infos as tcw
from test_waymo_conversion import _build_frame

# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)

# a small sensor: TOP 8 x 64 with per-beam inclinations, four 4 x 16 lidars
# with an inclination range
SMALL_LIDARS = [(n, 8 if n == "TOP" else 4, 64 if n == "TOP" else 16, *rest[:-1], 0.5)
                for n, _, _, *rest in WAYMO_LIDARS]


def _key(number, wire_type):
    return wire._encode_varint(number << 3 | wire_type)


def _len_field(number, body):
    return _key(number, wire.LEN) + wire._encode_varint(len(body)) + body


# unknown fields of every wire type: varint, fixed64, length-delimited, a
# group holding a varint and a nested group, fixed32
UNKNOWN = (_key(99, wire.VARINT) + wire._encode_varint(-5)
           + _key(98, wire.FIXED64) + b"\x01" * 8
           + _len_field(97, b"ignored bytes")
           + _key(96, wire.START_GROUP) + _key(1, wire.VARINT) + b"\x07"
           + _key(2, wire.START_GROUP) + _key(3, wire.FIXED32) + b"\x00" * 4
           + _key(2, wire.END_GROUP) + _key(96, wire.END_GROUP)
           + _key(95, wire.FIXED32) + b"\xff" * 4)


def assert_same(pb, msg, cls, path="msg"):
    """Every field of the port's schema ``cls`` reads the same in the
    protobuf message ``pb`` and the port's ``msg``."""
    for f in cls.FIELDS:
        a, b = getattr(pb, f.name), getattr(msg, f.name)
        where = f"{path}.{f.name}"
        if f.kind == wire.MESSAGE and f.repeated:
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                assert_same(x, y, f.message, f"{where}[{i}]")
        elif f.kind == wire.MESSAGE:
            assert pb.HasField(f.name) == msg.has(f.name), where
            assert_same(a, b, f.message, where)
        elif f.repeated:
            want = np.asarray(list(a), b.dtype)
            assert b.dtype == wire._DTYPE[f.kind] and np.array_equal(want, b), where
        else:
            assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("n", [0, 1, 7, 100, 4097, 1 << 20])
def test_crc32c_equals_jax(n):
    data = np.random.RandomState(n).bytes(n)
    assert ttf.crc32c(data) == jtf.crc32c(data)
    assert ttf._masked_crc(data) == jtf._masked_crc(data)


def test_tfrecord_files_cross_read(tmp_path):
    payloads = [b"", b"alpha", np.random.RandomState(1).bytes(70_001), b"\x00" * 9]
    ttf.write_tfrecord(tmp_path / "port.tfrecord", payloads)
    jtf.write_tfrecord(tmp_path / "jax.tfrecord", payloads)
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()
    assert list(jtf.read_tfrecord(tmp_path / "port.tfrecord", verify_crc=True)) == payloads
    assert list(ttf.read_tfrecord(tmp_path / "jax.tfrecord", verify_crc=True)) == payloads
    raw = bytearray((tmp_path / "port.tfrecord").read_bytes())
    raw[20] ^= 1  # a byte of the second record's payload
    (tmp_path / "bad.tfrecord").write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        list(ttf.read_tfrecord(tmp_path / "bad.tfrecord", verify_crc=True))


def test_protobuf_frames_decode_to_equal_fields():
    rng = np.random.RandomState(7)
    for i in range(2):
        frame, _ = _build_frame(rng, i)
        frame.laser_labels[0].ClearField("box")  # absent optionals
        frame.laser_labels[1].ClearField("num_lidar_points_in_box")
        data = frame.SerializeToString()
        got = W.Frame.decode(data)
        assert_same(frame, got, W.Frame)
        assert got.encode() == data
        for laser, pb_laser in zip(got.lasers, frame.lasers):
            for name, cls, pb_cls in (("range_image_compressed", W.MatrixFloat,
                                       dataset_pb2.MatrixFloat),
                                      ("segmentation_label_compressed", W.MatrixInt32,
                                       dataset_pb2.MatrixInt32)):
                comp = getattr(laser.ri_return1, name)
                if comp:
                    raw = zlib.decompress(comp)
                    assert_same(pb_cls.FromString(raw), cls.decode(raw), cls, name)


def test_negative_int32_and_enum_edge_cases():
    m = dataset_pb2.MatrixInt32()
    vals = [-1, 0, 1, 127, 128, -2 ** 31, 2 ** 31 - 1, -300, 300]
    m.data.extend(vals * 3)
    m.shape.dims.extend([3, 9])
    got = W.MatrixInt32.decode(m.SerializeToString())
    assert got.data.tolist() == vals * 3 and got.shape.dims.tolist() == [3, 9]
    assert W.MatrixInt32(data=np.asarray(vals * 3, np.int32),
                         shape=W.MatrixShape(dims=[3, 9])).encode() == m.SerializeToString()
    # a label whose type is outside the closed enum, a negative point count,
    # and unknown fields
    data = (_key(3, wire.VARINT) + wire._encode_varint(9) + _key(4, wire.LEN) + b"\x02id"
            + _key(7, wire.VARINT) + wire._encode_varint(-4) + UNKNOWN)
    pb = dataset_pb2.Label.FromString(data)
    got = W.Label.decode(data)
    assert_same(pb, got, W.Label)
    assert (got.type, got.id, got.num_lidar_points_in_box) == (0, "id", -4)


def test_packed_doubles_unknown_fields_and_merged_messages():
    """Packed doubles where proto2 writes them unpacked; unknown fields in
    the frame and in nested messages; a pose given twice (merged: its
    doubles append)."""
    pose = np.arange(16, dtype=np.float64) * 0.5 - 3.0
    incl = np.linspace(-0.3, 0.05, 6)
    cal = (_key(1, wire.VARINT) + b"\x01" + UNKNOWN
           + _len_field(2, incl.astype("<f8").tobytes())  # packed beam_inclinations
           + _key(2, wire.FIXED64) + np.float64(0.07).tobytes()  # one more, unpacked
           + _key(3, wire.FIXED64) + np.float64(-0.31).tobytes())
    label = (_len_field(1, _key(7, wire.FIXED64) + np.float64(0.25).tobytes() + UNKNOWN)
             + _key(3, wire.VARINT) + b"\x04" + _len_field(4, "cyc".encode()))
    data = (UNKNOWN + _len_field(1, _len_field(1, b"ctx") + _len_field(3, cal))
            + _len_field(3, _len_field(1, pose[:8].astype("<f8").tobytes()))
            + _len_field(3, b"".join(_key(1, wire.FIXED64) + np.float64(v).tobytes()
                                     for v in pose[8:]))
            + _len_field(6, label) + UNKNOWN)
    pb = dataset_pb2.Frame.FromString(data)
    got = W.Frame.decode(data)
    assert_same(pb, got, W.Frame)
    assert np.array_equal(got.pose.transform, pose)
    assert np.array_equal(got.context.laser_calibrations[0].beam_inclinations,
                          np.append(incl, 0.07))
    assert got.laser_labels[0].box.heading == 0.25 and got.laser_labels[0].box.center_x == 0.0
    with pytest.raises(W.DecodeError):
        W.Frame.decode(data[:-3])


def test_port_writer_frames_parse_in_protobuf(tmp_path):
    path = tmp_path / "seg-w.tfrecord"
    write_waymo_tfrecord(path, 2, seed=3, lidars=SMALL_LIDARS, labels=9, seg_frames=[1])
    for payload in ttf.read_tfrecord(path, verify_crc=True):
        pb = dataset_pb2.Frame.FromString(payload)
        got = W.Frame.decode(payload)
        assert_same(pb, got, W.Frame)
        assert pb.SerializeToString() == payload
        assert {lb.type for lb in pb.laser_labels} == {1, 2, 3, 4}
        assert len(pb.context.laser_calibrations[0].beam_inclinations) == 8
        assert len(pb.context.laser_calibrations[1].beam_inclinations) == 0


@pytest.fixture
def jax_tier3(monkeypatch):
    """The JAX tool's process_single_sequence on its third tier (no
    TensorFlow, no waymo_open_dataset)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from create_waymo_infos import process_single_sequence

    return process_single_sequence


def _frames_of_both_writers(tmp_path):
    """A 3-frame sequence of protobuf-built frames (TOP with inclinations
    and segmentation labels, FRONT with a range only; a label of an unknown
    type) and a 3-frame one of the port's writer (five lidars, four label
    types, segmentation labels on frame 1)."""
    rng = np.random.RandomState(11)
    frames = []
    for i in range(3):
        frame, _ = _build_frame(rng, i)
        extra = frame.laser_labels.add()
        extra.box.length = 1.0
        extra.id = f"unknown_{i}"  # type 0
        frames.append(frame.SerializeToString())
    jtf.write_tfrecord(tmp_path / "seg-pb.tfrecord", frames)
    write_waymo_tfrecord(tmp_path / "seg-port.tfrecord", 3, seed=4, lidars=SMALL_LIDARS,
                         labels=10, seg_frames=[1])
    return ["seg-pb", "seg-port"]


def test_process_single_sequence_equals_jax(tmp_path, jax_tier3):
    for name in _frames_of_both_writers(tmp_path):
        raw = str(tmp_path / f"{name}.tfrecord")
        ref = jax_tier3(raw, str(tmp_path / "jax"))
        timings = {}
        got = tcw.process_single_sequence(raw, str(tmp_path / "port"), device="cpu",
                                          timings=timings)
        assert timings["frames"] == 3
        with open(tmp_path / "port" / name / f"{name}.pkl", "rb") as f:
            assert pickle.dumps(pickle.load(f)) == pickle.dumps(got)
        assert len(got) == len(ref) == 3
        for a, b in zip(ref, got):
            assert a.keys() == b.keys() and a["annos"].keys() == b["annos"].keys()
            assert a["frame_id"] == b["frame_id"] and a["point_cloud"] == b["point_cloud"]
            assert a["pose"].dtype == b["pose"].dtype and np.array_equal(a["pose"], b["pose"])
            for k, v in a["annos"].items():
                assert v.dtype == b["annos"][k].dtype and np.array_equal(v, b["annos"][k]), k
        names = set(np.concatenate([i["annos"]["name"] for i in got]))
        assert names == ({"Vehicle", "Pedestrian", "Unknown"} if name == "seg-pb"
                         else {"Vehicle", "Pedestrian", "Sign", "Cyclist"})
        jdir, tdir = tmp_path / "jax" / name, tmp_path / "port" / name
        assert sorted(p.name for p in jdir.iterdir()) == sorted(p.name for p in tdir.iterdir())
        for idx in range(3):
            a, b = np.load(jdir / f"{idx:04d}.npy"), np.load(tdir / f"{idx:04d}.npy")
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(b[:, [0, 1, 2, 5]], a[:, [0, 1, 2, 5]], atol=1e-6, rtol=0)
            assert np.array_equal(a[:, [3, 4, 6, 7]], b[:, [3, 4, 6, 7]])
            seg = jdir / f"{idx:04d}_seg.npy"
            if seg.exists():
                sa, sb = np.load(seg), np.load(tdir / seg.name)
                assert sa.dtype == sb.dtype and np.array_equal(sa, sb)


def test_missing_laser_raises_stop_iteration_in_both(tmp_path, jax_tier3):
    rng = np.random.RandomState(2)
    frame, _ = _build_frame(rng, 0)
    del frame.lasers[1]  # FRONT's calibration stays
    jtf.write_tfrecord(tmp_path / "seg-x.tfrecord", [frame.SerializeToString()])
    for fn, kw in ((jax_tier3, {}), (tcw.process_single_sequence, {"device": "cpu"})):
        with pytest.raises(StopIteration):
            fn(str(tmp_path / "seg-x.tfrecord"), str(tmp_path / "out"), **kw)
