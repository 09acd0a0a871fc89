"""Forward + backward ms a step of PV-RCNN's keypoint branch
(``models/pfe.py`` over ``ops/sampling.py``'s FPS), from the layer spans'
CUDA events."""

MODULES = ("pfe",)
LAYER = "pfe"


def read(rec):
    return rec["spans_ms"].get(LAYER)
