"""Forward + backward ms a step of the BEV path (``models/backbones_2d.py``:
HeightCompression and BaseBEVBackbone), from the layer spans' CUDA
events."""

MODULES = ("map_to_bev", "backbone_2d")
LAYER = "bev2d"


def read(rec):
    return rec["spans_ms"].get(LAYER)
