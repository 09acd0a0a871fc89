"""The messages of ``waymo_minimal.proto`` that the Waymo converter touches,
with that file's field numbers (the schema of record), over ``wire.py``.
``Frame.decode(payload)`` reads one TFRecord record; ``frame.encode()``
writes one."""

from __future__ import annotations

from .wire import (BYTES, DOUBLE, ENUM, FLOAT, INT32, INT64, MESSAGE, STRING, Field,
                   Message)


class LaserName:
    UNKNOWN, TOP, FRONT, SIDE_LEFT, SIDE_RIGHT, REAR = range(6)
    VALUES = tuple(range(6))


class MatrixShape(Message):
    FIELDS = (Field(1, "dims", INT32, repeated=True),)


class MatrixFloat(Message):
    FIELDS = (Field(1, "data", FLOAT, repeated=True, packed=True),
              Field(2, "shape", MESSAGE, message=MatrixShape))


class MatrixInt32(Message):
    FIELDS = (Field(1, "data", INT32, repeated=True, packed=True),
              Field(2, "shape", MESSAGE, message=MatrixShape))


class Transform(Message):
    """Row-major 4 x 4."""

    FIELDS = (Field(1, "transform", DOUBLE, repeated=True),)


class LaserCalibration(Message):
    FIELDS = (Field(1, "name", ENUM, enum=LaserName.VALUES),
              Field(2, "beam_inclinations", DOUBLE, repeated=True),
              Field(3, "beam_inclination_min", DOUBLE),
              Field(4, "beam_inclination_max", DOUBLE),
              Field(5, "extrinsic", MESSAGE, message=Transform))


class Context(Message):
    FIELDS = (Field(1, "name", STRING),
              Field(3, "laser_calibrations", MESSAGE, repeated=True, message=LaserCalibration))


class RangeImage(Message):
    FIELDS = (Field(1, "range_image", MESSAGE, message=MatrixFloat),
              Field(2, "range_image_compressed", BYTES),
              Field(3, "camera_projection_compressed", BYTES),
              Field(4, "range_image_pose_compressed", BYTES),
              Field(5, "range_image_flow_compressed", BYTES),
              Field(6, "segmentation_label_compressed", BYTES))


class Laser(Message):
    FIELDS = (Field(1, "name", ENUM, enum=LaserName.VALUES),
              Field(2, "ri_return1", MESSAGE, message=RangeImage),
              Field(3, "ri_return2", MESSAGE, message=RangeImage))


class Box(Message):
    """Label.Box: width is the extent along y, length along x."""

    FIELDS = (Field(1, "center_x", DOUBLE), Field(2, "center_y", DOUBLE),
              Field(3, "center_z", DOUBLE), Field(4, "width", DOUBLE),
              Field(5, "length", DOUBLE), Field(6, "height", DOUBLE),
              Field(7, "heading", DOUBLE))


class Label(Message):
    TYPE_UNKNOWN, TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_SIGN, TYPE_CYCLIST = range(5)
    UNKNOWN, LEVEL_1, LEVEL_2 = range(3)
    Box = Box
    FIELDS = (Field(1, "box", MESSAGE, message=Box),
              Field(3, "type", ENUM, enum=range(5)),
              Field(4, "id", STRING),
              Field(5, "detection_difficulty_level", ENUM, enum=range(3)),
              Field(6, "tracking_difficulty_level", ENUM, enum=range(3)),
              Field(7, "num_lidar_points_in_box", INT32))


class Frame(Message):
    FIELDS = (Field(1, "context", MESSAGE, message=Context),
              Field(2, "timestamp_micros", INT64),
              Field(3, "pose", MESSAGE, message=Transform),
              Field(5, "lasers", MESSAGE, repeated=True, message=Laser),
              Field(6, "laser_labels", MESSAGE, repeated=True, message=Label))
