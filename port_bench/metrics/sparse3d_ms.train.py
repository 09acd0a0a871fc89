"""Forward + backward ms a step of the voxel table and the sparse 3D
backbone (``models/vfe.py`` + ``models/backbones_3d.py`` over
``ops/sparse_conv.py``), from the layer spans' CUDA events."""

MODULES = ("vfe", "backbone_3d")
LAYER = "sparse3d"


def read(rec):
    return rec["spans_ms"].get(LAYER)
