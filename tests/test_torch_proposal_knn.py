"""The kNN-graph proposal path: the port's ``ops.connected_components``
and ``ClusterProposal(CC_GRAPH="knn")`` against the JAX package's CPU path
(``pallas_scan.use_pallas_scan() == False``, which this test process is
on), and the config switch that pins both packages to one path.

No tolerance: labels are integers and the propagation's round cap is the
JAX module's, so the labels must be equal, unconverged ones included; the
proposal's component labels per point must be equal too (its neighbour
tables come from the port's hash grid, bit-equal to the JAX one except
that XLA contracts the squared distance into FMAs; on these scenes no
radius-boundary pair differs, so none is exempted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import connected_components as jcc
from pcseqlearning_tpu.ops import pallas_scan
from pcseqlearning_tpu.preprocessing import cluster_proposal as jcp
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch.convert import config_from_jax
from pcseqlearning_tpu_torch.ops import connected_components as tcc
from pcseqlearning_tpu_torch.pipeline import BENCH
from pcseqlearning_tpu_torch.preprocessing import cluster_proposal as tcp
from pcseqlearning_tpu_torch.scene import scene_dict

T = torch.as_tensor
torch.set_num_threads(1)


def _table(rng, n, k, p_mask, local):
    """A random neighbour table: ids near the row (``local``) or anywhere,
    some masked, some -1."""
    base = np.arange(n)[:, None]
    idx = (base + rng.randint(-local, local + 1, (n, k))) % n if local else rng.randint(0, n, (n, k))
    mask = rng.rand(n, k) < p_mask
    idx = np.where(rng.rand(n, k) < 0.05, -1, idx).astype(np.int32)
    return idx, mask & (idx >= 0)


@pytest.mark.parametrize("n, k, p_mask, local, seed", [
    (500, 8, 0.3, 0, 0),
    (2000, 16, 0.15, 6, 1),
    (3000, 4, 0.6, 40, 2),
    (257, 1, 0.9, 3, 3),
])
def test_knn_cc_equals_jax(n, k, p_mask, local, seed):
    idx, mask = _table(np.random.RandomState(seed), n, k, p_mask, local)
    want = np.asarray(jcc.connected_components_knn(jnp.asarray(idx), jnp.asarray(mask)))
    got = tcc.connected_components_knn(T(idx), T(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    valid = np.random.RandomState(seed + 10).rand(n) > 0.1
    wc, wn = jcc.compact_labels(jnp.asarray(want), node_valid=jnp.asarray(valid))
    gc, gn = tcc.compact_labels(T(got), node_valid=T(valid))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert gn == int(wn)


@pytest.mark.parametrize("max_iters", [2, None])  # None: the default cap, 64 rounds
def test_knn_cc_unconverged_labels_equal_jax(max_iters):
    """A 4096-node chain in random id order, listed one way only, needs more
    than 64 rounds: the labels where the cap stops it must be JAX's."""
    n = 4096
    perm = np.random.RandomState(5).permutation(n)
    idx = np.full((n, 2), -1, np.int32)
    idx[perm[:-1], 0] = perm[1:]
    mask = idx >= 0
    kw = {} if max_iters is None else dict(max_iters=max_iters)
    want = np.asarray(jcc.connected_components_knn(jnp.asarray(idx), jnp.asarray(mask), **kw))
    got = tcc.connected_components_knn(T(idx), T(mask), **kw).numpy()
    assert len(np.unique(want)) > 1  # stopped by the cap, not converged
    np.testing.assert_array_equal(got, want)
    full = tcc.connected_components_knn(T(idx), T(mask), max_iters=100_000).numpy()
    assert (full == 0).all()  # one component once the rounds run out


def test_edge_list_cc_equals_jax():
    rng = np.random.RandomState(4)
    n, e = 1500, 1800
    src, dst = rng.randint(-1, n, e).astype(np.int32), rng.randint(0, n, e).astype(np.int32)
    emask = rng.rand(e) > 0.2
    want = np.asarray(jcc.connected_components(jnp.asarray(src), jnp.asarray(dst), n,
                                               e_mask=jnp.asarray(emask)))
    got = tcc.connected_components(T(src), T(dst), n, e_mask=T(emask)).numpy()
    np.testing.assert_array_equal(got, want)


def _proposal_cfg(radii, keys):
    return dict(BENCH["proposal"], GRAPH=dict(BENCH["proposal"]["GRAPH"], RADIUS=radii),
                COMPONENT_KEYS=keys)


@pytest.mark.parametrize("frames, points, radii", [
    (14, 1500, [1.25, 0.75]),   # two chunks: frames 0-9 and 10-13
    (12, 3000, [0.5]),
])
def test_knn_proposal_matches_jax_cpu_path(frames, points, radii):
    assert not pallas_scan.use_pallas_scan()  # the JAX package's CPU path
    keys = [f"component_r{i}" for i in range(len(radii))]
    cfg = _proposal_cfg(radii, keys)
    d = scene_dict(frames, points, seed=frames)
    d["point_fxyz"] = d["point_fxyz"][d["point_fxyz"][:, 3] > 0.3]  # above the ground
    d["point_sweep"] = d["point_fxyz"][:, 0].astype(np.int64)
    dj = jcp.ClusterProposal(JEDict(cfg))(dict(d))
    tcfg = config_from_jax(cfg, env={}, jax_backend="cpu")
    assert (tcfg.CC_GRAPH, tcfg.CC_CELL_CAP) == ("knn", 24)
    prop = tcp.ClusterProposal(tcfg, device="cpu")
    assert (prop.cc_neighbors, prop.cc_cell_cap) == (16, 24)
    dt = prop(dict(d))
    for key in keys:
        np.testing.assert_array_equal(dt[f"point_{key}"], dj[f"point_{key}"], err_msg=key)
        np.testing.assert_allclose(dt[f"best_iou_after_{key}"], np.asarray(dj[f"best_iou_after_{key}"]),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(dt["point_pred_box_id"], dj["point_pred_box_id"])
    # the kernel path labels the same scene (the radius graph is exact there)
    radius = tcp.ClusterProposal(dict(tcfg, CC_GRAPH="radius"), device="cpu")(dict(d))
    assert all(radius[f"point_{k}"].max() >= 0 for k in keys)


def test_config_from_jax_picks_the_jax_path():
    prop = BENCH["proposal"]
    assert config_from_jax(prop, env={}, jax_backend="tpu").CC_GRAPH == "radius"
    assert config_from_jax(prop, env={}, jax_backend="cpu").CC_GRAPH == "knn"
    assert config_from_jax(prop, env={}, jax_backend="gpu").CC_GRAPH == "knn"
    for var in ("PCSEQ_PALLAS", "PCSEQ_PALLAS_SCAN"):
        assert config_from_jax(prop, env={var: "0"}, jax_backend="tpu").CC_GRAPH == "knn"
        assert config_from_jax(prop, env={var: "1"}, jax_backend="tpu").CC_GRAPH == "radius"
    assert config_from_jax(prop, env={}).CC_GRAPH == "radius"  # default: the kernel path
    # an explicit key wins; the cell caps as the JAX module derives them
    assert config_from_jax(dict(prop, CC_GRAPH="knn"), env={}).CC_GRAPH == "knn"
    assert config_from_jax(prop, env={"PCSEQ_CELL_CAP": "96"}).CC_CELL_CAP == 96
    assert config_from_jax(dict(prop, CELL_CAP=16), env={}).CC_CELL_CAP == 16
    assert config_from_jax(dict(prop, CC_CELL_CAP=40), env={}).CC_CELL_CAP == 40
    jp = jcp.ClusterProposal(JEDict(prop))
    assert config_from_jax(prop, jax_backend=jax.default_backend()).CC_CELL_CAP == jp.cc_cell_cap
    assert "CC_GRAPH" not in config_from_jax(BENCH["tracking"], env={})
    with pytest.raises(ValueError):
        tcp.ClusterProposal(dict(prop, CC_GRAPH="grid"), device="cpu")
