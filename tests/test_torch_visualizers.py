"""The port's visualizers (models/visualizers.py) against the JAX package's:
tests/test_visualizers.py's three cases through both, the repository's
voxel_visualizer.yaml on a batch with ``point_height``, a ``sample``d
section under equal seeds, and arrays of the packages' own kinds (JAX
arrays there, torch tensors here) registered directly.

Tolerance: none. The pickled segments are equal: kinds, names, dtypes
(a segment's float64 NumPy arrays stored as float16 by both, its
quantities as given) and values.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.config import cfg_from_yaml_file as jcfg_from_yaml
from pcseqlearning_tpu.models import visualizers as jvis
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
from pcseqlearning_tpu_torch.models import visualizers as tvis
from pcseqlearning_tpu_torch.utils.edict import EDict

VOXEL_VIS = "tools/cfgs/visualizers/waymo/registration/voxel_visualizer.yaml"


def assert_same(a, b, where="segments"):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _batch(rng, n=40):
    return {
        "frame_id": "viz_000",
        "point_fxyz": rng.rand(n, 4).astype(np.float32),
        "point_err": rng.rand(n),  # float64: a quantity, kept as it is
        "point_color": rng.rand(n, 3).astype(np.float32),
        "seq_fxyz": np.concatenate([np.repeat([0., 1.], 10)[:, None],
                                    rng.rand(20, 3)], 1).astype(np.float32),
        "gt_boxes": np.array([[0, 0, 0, 2, 2, 2, 0.3], [1, 1, 0, 0.1, 0.1, 0.1, 0]],
                             np.float32),
        "box_vec": rng.rand(2, 3),
    }


def _saved(tmp_path, vis):
    files = sorted(tmp_path.glob("*.geom.pkl"))
    assert len(files) == 1
    with open(files[0], "rb") as f:
        return files[0].name, pickle.load(f)


def test_config_driven_geometry_equals_jax(tmp_path):
    cfg = dict(POINT_CLOUD_VIS={"point_fxyz": {"scalars": {"err": "point_err"},
                                               "colors": {"cls": "point_color"}}},
               POINT_CLOUD_SEQUENCE_VIS={"seq_fxyz": {}},
               BOX_VIS={"gt_boxes": {"vectors": {"v": "box_vec"}}})
    out = {}
    for name, mod, edict in (("jax", jvis, JEDict), ("port", tvis, EDict)):
        d = tmp_path / name
        mod.GeometryVisualizer(edict(cfg, SAVE_DIR=str(d)))(_batch(np.random.RandomState(0)))
        out[name] = _saved(d, None)
    assert_same(out["jax"], out["port"])
    segs = out["port"][1]
    assert [s["type"] for s in segs] == ["point_cloud", "point_cloud", "boxes"]
    # a quantity joins its segment after the compression: kept as float64
    assert segs[0]["scalars"]["err"]["values"].dtype == np.float64
    assert segs[2]["corners"].shape == (1, 8, 3)


def test_correspondence_and_trace_channels_equal_jax():
    src = np.random.RandomState(1).rand(5, 3).astype(np.float32)
    segs = {}
    for name, mod in (("jax", jvis), ("port", tvis)):
        vis = mod.GeometryVisualizer()
        vis.register_correspondence("corres", src, src + 1.0)
        vis.register_trace("trace", np.arange(12, dtype=np.float64).reshape(4, 3))
        segs[name] = vis.segments
    assert_same(segs["jax"], segs["port"])
    assert segs["port"][0]["edges"].shape == (5, 2)
    assert segs["port"][1]["nodes"].dtype == np.float16


def test_plotly_falls_back_like_jax(tmp_path):
    rng = np.random.RandomState(2)
    xyz, q = rng.rand(10, 3), rng.rand(10)
    outs = {}
    for name, mod in (("jax", jvis), ("port", tvis)):
        vis = mod.PlotlyVisualizer()
        vis.register_point_cloud(dict(name="pc", xyz=xyz))
        vis.add_scalar_quantity("q", q)
        vis.register_boxes(dict(name="b", boxes=np.array([[0, 0, 0, 1, 1, 1, 0]], np.float32)))
        path = vis.save_html(str(tmp_path / f"{name}.html"))
        outs[name] = (path.endswith(".pkl"), vis.segments)
        assert (tmp_path / path).exists()
    assert_same(outs["jax"], outs["port"])


def test_voxel_visualizer_yaml_equals_jax(tmp_path):
    """The repository's config: its point section writes ``scalar:`` and
    ``shared_color:``, which neither package reads (only ``scalars``,
    ``colors`` and ``vectors``), so no quantity is added."""
    rng = np.random.RandomState(3)
    n = 300
    batch = {"frame_id": "seq_007", "point_fxyz": rng.rand(n, 4).astype(np.float32),
             "point_height": rng.rand(n).astype(np.float32),
             "segmentation_label": rng.randint(0, 23, n),
             "gt_boxes": rng.rand(1, 6, 8).astype(np.float32) * 3,
             "gt_box_cls_label": rng.randint(0, 4, 6)}
    out = {}
    for name, mod, load in (("jax", jvis, lambda p: jcfg_from_yaml(p, JEDict())),
                            ("port", tvis, lambda p: cfg_from_yaml_file(p, EDict()))):
        cfg = load(VOXEL_VIS).VISUALIZER
        cfg.SAVE_DIR = str(tmp_path / name)
        assert cfg.NAME == "PolyScopeVisualizer"
        vis = mod.VISUALIZERS[cfg.NAME](cfg)
        assert vis._ps is None  # no polyscope: headless
        vis(batch)
        out[name] = _saved(tmp_path / name, vis)
    assert_same(out["jax"], out["port"])
    segs = out["port"][1]
    assert [(s["type"], s["name"]) for s in segs] == [("point_cloud", "point_fxyz"),
                                                       ("boxes", "gt_boxes")]
    assert all("scalars" not in s and "colors" not in s for s in segs)


@pytest.mark.parametrize("seed", [0, 13])
def test_sample_picks_the_same_points(seed):
    rng = np.random.RandomState(4)
    batch = {"point_fxyz": rng.rand(500, 4).astype(np.float32), "h": rng.rand(500)}
    cfg = {"POINT_CLOUD_VIS": {"point_fxyz": {"sample": 50, "scalars": {"h": "h"}}}}
    np.random.seed(seed)
    ref = jvis.GeometryVisualizer(JEDict(cfg))
    ref(batch)
    got = tvis.GeometryVisualizer(EDict(cfg), rng=np.random.RandomState(seed))
    got(batch)
    assert_same(ref.segments, got.segments)
    assert got.segments[0]["xyz"].shape == (50, 3)


def test_tensors_pass_uncast_as_jax_arrays_do():
    rng = np.random.RandomState(5)
    xyz, vals = rng.rand(7, 3), rng.rand(7)  # float64
    ref = jvis.GeometryVisualizer()
    ref.register_point_cloud(dict(name="pc", xyz=jnp.asarray(xyz.astype(np.float32)),
                                  extra=xyz))
    got = tvis.GeometryVisualizer()
    got.register_point_cloud(dict(name="pc", xyz=torch.as_tensor(xyz.astype(np.float32)),
                                  extra=xyz))
    ref.add_scalar_quantity("v", jnp.asarray(vals.astype(np.float32)))
    got.add_scalar_quantity("v", torch.as_tensor(vals.astype(np.float32)))
    assert_same(ref.segments, got.segments)
    assert got.segments[0]["xyz"].dtype == np.float32
    assert got.segments[0]["extra"].dtype == np.float16
