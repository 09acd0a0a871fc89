"""Forward + targets + loss + backward ms a step of the heads
(``models/dense_heads.py``, and PV-RCNN's RoI stage in
``models/roi_heads.py``), from the layer spans' CUDA events."""

MODULES = ("dense_head", "roi_head")
LAYER = "heads"


def read(rec):
    return rec["spans_ms"].get(LAYER)
