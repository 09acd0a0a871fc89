"""The Waymo Open Dataset messages the converter reads
(``waymo_minimal.proto``, the schema of record), decoded and encoded by the
port's own wire-format code: no protobuf, TensorFlow or waymo_open_dataset
package (counterpart of pcseqlearning_tpu.datasets.waymo_protos, which
parses through protobuf)."""

from .dataset import (Box, Context, Frame, Label, Laser, LaserCalibration, LaserName,
                      MatrixFloat, MatrixInt32, MatrixShape, RangeImage, Transform)
from .wire import DecodeError

__all__ = ["Box", "Context", "DecodeError", "Frame", "Label", "Laser", "LaserCalibration",
           "LaserName", "MatrixFloat", "MatrixInt32", "MatrixShape", "RangeImage",
           "Transform"]
