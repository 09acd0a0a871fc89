"""Sorted per-frame row index for sequence point tables (counterpart of
pcseqlearning_tpu.utils.frame_index): sort once, then every "rows of frame
f" lookup is an O(rows) slice instead of an O(n) mask."""

from __future__ import annotations

import numpy as np


class FrameIndex:
    """O(n log n) once, O(rows) per frame lookup.

    rows(fid) returns an int64 row-id array (original order within the
    frame is kept only when the input was frame-sorted)."""

    def __init__(self, frame):
        frame = np.asarray(frame).reshape(-1)
        self.n = len(frame)
        if self.n == 0 or (np.diff(frame) >= 0).all():
            self.order = None
            self.sorted_frame = frame
        else:
            self.order = np.argsort(frame, kind="stable")
            self.sorted_frame = frame[self.order]
        self.frames = np.unique(self.sorted_frame) if self.n else np.empty(0, np.int64)

    def rows(self, fid):
        lo = np.searchsorted(self.sorted_frame, fid, side="left")
        hi = np.searchsorted(self.sorted_frame, fid, side="right")
        if self.order is None:
            return np.arange(lo, hi, dtype=np.int64)
        return self.order[lo:hi]

    def rows_range(self, f0, f1):
        """Row ids of frames in [f0, f1) — one O(rows) slice."""
        lo = np.searchsorted(self.sorted_frame, f0, side="left")
        hi = np.searchsorted(self.sorted_frame, f1, side="left")
        if self.order is None:
            return np.arange(lo, hi, dtype=np.int64)
        return self.order[lo:hi]

    def count(self, fid):
        lo = np.searchsorted(self.sorted_frame, fid, side="left")
        hi = np.searchsorted(self.sorted_frame, fid, side="right")
        return int(hi - lo)

    def max_count(self):
        if self.n == 0:
            return 0
        return int(np.bincount(self.sorted_frame - self.sorted_frame.min()).max())
