"""Visualizers: config-driven registration of point clouds, boxes and curves
with scalar, color and vector quantities, headless first (counterpart of
pcseqlearning_tpu.models.visualizers).

``GeometryVisualizer`` resolves every quantity a config section names from
the batch dict and keeps each registration as a segment dict (geometry and
its quantities), which it pickles to ``<SAVE_DIR>/<frame_id>.geom.pkl``;
``PolyScopeVisualizer`` and ``PlotlyVisualizer`` only render those
segments, and degrade to the headless core when polyscope or plotly is
absent. The segments equal the JAX package's for the same batch: a NumPy
float64 array is stored as float16, anything else with a shape (a torch
tensor, on the card too, as a JAX array there) goes to the host uncast.

Two choices of the JAX module are kept as they are: ``_resolve_quantities``
reads only the ``scalars``, ``colors`` and ``vectors`` keys of a section, so
``tools/cfgs/visualizers/waymo/registration/voxel_visualizer.yaml``'s
``scalar:`` and ``shared_color:`` add no quantity; and a section's
``sample: n`` keeps n points of a random permutation, drawn here from the
visualizer's ``rng`` (a ``np.random.RandomState``, whose draws equal
NumPy's global state's for the same seed) in place of the global state.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..utils.edict import EDict


def _np(a):
    """``a`` as a NumPy array (a tensor goes to the host)."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _boxes_to_corners(boxes):
    """[B, 8, 3] corners of [B, 7] boxes (z-heading)."""
    template = np.array([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ], np.float32) / 2.0
    corners = boxes[:, None, 3:6] * template[None]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    out = np.stack([x, y, corners[..., 2]], axis=-1)
    return out + boxes[:, None, :3]


class GeometryVisualizer:
    """Headless core: quantity resolution and compressed geometry dumps."""

    def __init__(self, model_cfg=None, runtime_cfg=None, rng=None):
        self.model_cfg = EDict(model_cfg or {})
        self.enabled = bool(self.model_cfg.get("ENABLED", True))
        self.point_cloud_vis = self.model_cfg.get("POINT_CLOUD_VIS", None)
        self.sequence_vis = self.model_cfg.get("POINT_CLOUD_SEQUENCE_VIS", None)
        self.box_vis = self.model_cfg.get("BOX_VIS", None)
        self.shared_color = dict(self.model_cfg.get("SHARED_COLOR", {}) or {})
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.segments = []

    # -- low-level registration ----------------------------------------
    @staticmethod
    def _compress(seg):
        out = {}
        for k, v in seg.items():
            if isinstance(v, dict):
                out[k] = GeometryVisualizer._compress(v)
            elif isinstance(v, np.ndarray):
                out[k] = v.astype(np.float16) if v.dtype == np.float64 else v
            elif hasattr(v, "shape"):  # a tensor: to the host, uncast
                out[k] = _np(v)
            else:
                out[k] = v
        return out

    def _push(self, seg):
        if self.enabled:
            self.segments.append(self._compress(dict(seg)))
        return self

    def register_point_cloud(self, segment):
        return self._push(dict(segment, type=segment.get("type", "point_cloud")))

    def register_boxes(self, segment):
        seg = dict(segment, type="boxes")
        if "corners" not in seg and "boxes" in seg:
            seg["corners"] = _boxes_to_corners(_np(seg["boxes"]))
        return self._push(seg)

    def register_curves(self, segment):
        return self._push(dict(segment, type="curves"))

    def register_correspondence(self, name, src, tgt, **kwargs):
        """Curve network pairing src[i] -> tgt[i]."""
        src, tgt = _np(src), _np(tgt)
        nodes = np.concatenate([src, tgt], axis=0)
        edges = np.stack([np.arange(len(src)), np.arange(len(src)) + len(src)], 1)
        return self.register_curves(dict(name=name, nodes=nodes, edges=edges, **kwargs))

    def register_trace(self, name, points, **kwargs):
        """Polyline through consecutive points."""
        points = _np(points)
        edges = np.stack([np.arange(len(points) - 1), np.arange(1, len(points))], 1)
        return self.register_curves(dict(name=name, nodes=points, edges=edges, **kwargs))

    def add_scalar_quantity(self, name, values, **kwargs):
        if self.enabled and self.segments:
            self.segments[-1].setdefault("scalars", {})[name] = dict(values=_np(values), **kwargs)
        return self

    def add_color_quantity(self, name, colors, **kwargs):
        if self.enabled and self.segments:
            self.segments[-1].setdefault("colors", {})[name] = dict(values=_np(colors), **kwargs)
        return self

    def add_vector_quantity(self, name, vectors, **kwargs):
        if self.enabled and self.segments:
            self.segments[-1].setdefault("vectors", {})[name] = dict(values=_np(vectors), **kwargs)
        return self

    # -- config-driven forward ------------------------------------------
    def _resolve_quantities(self, vis_cfg, batch_dict, mask):
        for qname, qkey in dict(vis_cfg.get("scalars", {}) or {}).items():
            if qkey in batch_dict:
                vals = _np(batch_dict[qkey]).reshape(-1)
                self.add_scalar_quantity(qname, vals[mask] if mask is not None else vals)
        for qname, qkey in dict(vis_cfg.get("colors", {}) or {}).items():
            if isinstance(qkey, str) and qkey in self.shared_color:
                self.add_color_quantity(qname, np.asarray(self.shared_color[qkey]))
            elif qkey in batch_dict:
                vals = _np(batch_dict[qkey])
                self.add_color_quantity(qname, vals[mask] if mask is not None else vals)
        for qname, qkey in dict(vis_cfg.get("vectors", {}) or {}).items():
            if qkey in batch_dict:
                vals = _np(batch_dict[qkey])
                self.add_vector_quantity(qname, vals[mask] if mask is not None else vals)

    def __call__(self, batch_dict):
        if not self.enabled:
            return batch_dict
        pc_sections = self.point_cloud_vis or {
            k: {} for k in self.model_cfg.get("POINT_CLOUD_KEYS", ["point_fxyz"])
        }
        for key, vis_cfg in pc_sections.items():
            vis_cfg = dict(vis_cfg or {})
            if key.startswith("_"):
                key = key[1:]
            if key not in batch_dict:
                continue
            arr = _np(batch_dict[key])
            xyz = arr[:, -3:] if arr.shape[-1] >= 3 else arr
            mask = None
            if "sample" in vis_cfg:
                n = int(vis_cfg.pop("sample"))
                mask = self.rng.permutation(len(xyz))[:n]
                xyz = xyz[mask]
            self.register_point_cloud(dict(
                name=vis_cfg.pop("name", key), xyz=xyz,
                radius=vis_cfg.pop("radius", 0.02),
            ))
            self._resolve_quantities(vis_cfg, batch_dict, mask)

        for key, vis_cfg in dict(self.sequence_vis or {}).items():
            if key not in batch_dict:
                continue
            vis_cfg = dict(vis_cfg or {})
            arr = _np(batch_dict[key])
            self.register_point_cloud(dict(
                name=vis_cfg.pop("name", key), xyz=arr[:, 1:4], type="point_cloud",
            ))
            self.add_scalar_quantity("sweep", arr[:, 0])
            self._resolve_quantities(vis_cfg, batch_dict, None)

        for key, vis_cfg in dict(self.box_vis or {}).items():
            if key not in batch_dict:
                continue
            vis_cfg = dict(vis_cfg or {})
            boxes = _np(batch_dict[key]).reshape(-1, _np(batch_dict[key]).shape[-1])
            keep = (boxes[:, 3:6] ** 2).sum(-1) > 1e-1
            boxes = boxes[keep]
            self.register_boxes(dict(name=vis_cfg.pop("name", key), boxes=boxes[:, :7]))
            self._resolve_quantities(vis_cfg, batch_dict, keep)

        out_dir = self.model_cfg.get("SAVE_DIR", None)
        if out_dir:
            sid = str(batch_dict.get("frame_id", "seq"))
            self.save(os.path.join(out_dir, f"{sid}.geom.pkl"))
            self.clear()
        return batch_dict

    def save(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.segments, f)
        return path

    def clear(self):
        self.segments = []


class PolyScopeVisualizer(GeometryVisualizer):
    """Interactive polyscope front rendering the headless segments;
    degrades to headless when polyscope is unavailable."""

    def __init__(self, model_cfg=None, runtime_cfg=None, rng=None):
        super().__init__(model_cfg, runtime_cfg, rng)
        try:
            import polyscope  # noqa: F401

            self._ps = polyscope
            self._ps.init()
            self._ps.set_up_dir(self.model_cfg.get("UP_DIR", "z_up"))
        except Exception:  # no package, or no display to open
            self._ps = None

    def _render(self, seg):
        if self._ps is None:
            return
        kind = seg.get("type", "point_cloud")
        if kind == "point_cloud":
            h = self._ps.register_point_cloud(
                seg.get("name", "pc"), _np(seg["xyz"]), radius=seg.get("radius", 0.02)
            )
        elif kind == "boxes":
            corners = _np(seg["corners"]).reshape(-1, 3)
            hexes = np.arange(len(corners)).reshape(-1, 8)
            h = self._ps.register_volume_mesh(seg.get("name", "boxes"), corners, hexes=hexes)
        elif kind == "curves":
            h = self._ps.register_curve_network(
                seg.get("name", "curves"), _np(seg["nodes"]), _np(seg["edges"])
            )
        else:
            return
        for name, q in seg.get("scalars", {}).items():
            h.add_scalar_quantity(name, _np(q["values"]))
        for name, q in seg.get("colors", {}).items():
            v = _np(q["values"])
            if v.ndim == 1:
                # a shared RGB vector broadcasts to per-node (N, 3), not (N,)
                n_nodes = len(_np(seg.get("xyz", seg.get("nodes"))))
                v = np.broadcast_to(v, (n_nodes, 3))
            h.add_color_quantity(name, v)
        for name, q in seg.get("vectors", {}).items():
            h.add_vector_quantity(name, _np(q["values"]))

    def _push(self, seg):
        super()._push(seg)
        if self.segments:
            self._render(self.segments[-1])
        return self

    def show(self):
        if self._ps is not None:
            self._ps.show()


class PlotlyVisualizer(GeometryVisualizer):
    """Plotly HTML export of the headless segments (point clouds colored by
    their first scalar quantity, boxes as wireframes, curves as lines); a
    ``.pkl`` of the segments when plotly is absent."""

    _BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                  (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]

    def save_html(self, path):
        try:
            import plotly.graph_objects as go
        except ImportError:
            return self.save(path + ".pkl")
        traces = []
        for seg in self.segments:
            kind = seg.get("type", "point_cloud")
            if kind == "point_cloud":
                xyz = _np(seg["xyz"])
                marker = dict(size=1)
                scalars = seg.get("scalars", {})
                if scalars:
                    first = next(iter(scalars.values()))
                    marker = dict(size=1, color=_np(first["values"]), colorscale="Viridis")
                traces.append(go.Scatter3d(
                    x=xyz[:, 0], y=xyz[:, 1], z=xyz[:, 2], mode="markers",
                    marker=marker, name=seg.get("name", "pc"),
                ))
            elif kind in ("boxes", "curves"):
                if kind == "boxes":
                    pairs = [(box[a], box[b]) for box in _np(seg["corners"])
                             for a, b in self._BOX_EDGES]
                else:
                    nodes = _np(seg["nodes"])
                    pairs = [(nodes[a], nodes[b]) for a, b in _np(seg["edges"])]
                xs, ys, zs = [], [], []
                for p, q in pairs:
                    xs += [p[0], q[0], None]
                    ys += [p[1], q[1], None]
                    zs += [p[2], q[2], None]
                traces.append(go.Scatter3d(x=xs, y=ys, z=zs, mode="lines",
                                           name=seg.get("name", kind)))
        go.Figure(traces).write_html(path)
        return path


VISUALIZERS = {
    "GeometryVisualizer": GeometryVisualizer,
    "PolyScopeVisualizer": PolyScopeVisualizer,
    "PlotlyVisualizer": PlotlyVisualizer,
}
