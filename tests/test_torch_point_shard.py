"""The x-sharded neighbour search and connected components
(``parallel.point_shard``), the mesh (``parallel.mesh``) and
``ClusterProposal(NUM_SHARDS=...)`` against the JAX package on its 8
virtual CPU devices, with the inputs of tests/test_multichip.py. The port
is single-controller code over a mesh of devices; here the mesh holds 8
CPU slots.

No tolerance where the outputs are ids, counts or partitions: the sharded
neighbour gids, the halo truncation counts, the CC root gids and
``point_cluster`` must equal JAX's exactly (the hash grids are bit-equal,
and no pair sits at the radius where XLA's fused squared distance could
round the other way). The neighbour distances differ by that one rounding
(held to 2e-7). On these sparse inputs the sharded results also equal
the single-table search and CC of the port (id sets, partitions). On a
dense bench-scene frame they do not, in JAX as in the port: there the
neighbour and cell caps bind at the slab boundaries, where a halo copy of
a point lists its k nearest among the points its slab sees; the port's
sharded labels still equal JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import connected_components as jcc  # noqa: F401 (traced below)
from pcseqlearning_tpu.ops import hash_graph as jhg  # noqa: F401 (imported before tracing)
from pcseqlearning_tpu.parallel import make_mesh as jmake_mesh
from pcseqlearning_tpu.parallel import shard_batch as jshard_batch
from pcseqlearning_tpu.parallel import point_shard as jps
from pcseqlearning_tpu.preprocessing.cluster_proposal import ClusterProposal as JProposal
from pcseqlearning_tpu_torch.ops import connected_components as tcc
from pcseqlearning_tpu_torch.ops import hash_graph as thg
from pcseqlearning_tpu_torch.parallel import make_mesh, replicate, shard_batch
from pcseqlearning_tpu_torch.parallel import point_shard as tps
from pcseqlearning_tpu_torch.preprocessing.cluster_proposal import ClusterProposal
from pcseqlearning_tpu_torch.utils import telemetry

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8


def _jmesh(d):
    return jmake_mesh(devices=jax.devices()[:d], dp=d, mp=1)


def test_mesh_and_batch_sharding():
    mesh = make_mesh(devices=CPU8, dp=4, mp=2)
    assert mesh.shape == {"dp": 4, "mp": 2} == dict(jmake_mesh(devices=jax.devices(), dp=4,
                                                               mp=2).shape)
    batch = {"point_bxyz": np.arange(8 * 128 * 4, dtype=np.float32).reshape(8, 128, 4),
             "meta": 3}
    shards = shard_batch(mesh, batch)
    assert len(shards) == 4
    for i, s in enumerate(shards):
        assert torch.equal(s["point_bxyz"], torch.as_tensor(batch["point_bxyz"][2 * i:2 * i + 2]))
        assert s["meta"] == 3
    # JAX places the same rows on its dp shards
    jb = jshard_batch(jmake_mesh(devices=jax.devices(), dp=4, mp=2), batch)["point_bxyz"]
    assert jb.sharding.spec == jax.sharding.PartitionSpec("dp")
    assert len(replicate(mesh, {"w": np.ones(3)})) == 8
    with pytest.raises(ValueError):
        make_mesh(devices=CPU8, dp=3, mp=2)
    with pytest.raises(ValueError):
        shard_batch(make_mesh(devices=["cpu"] * 3, dp=3), batch)


@pytest.mark.parametrize("n, shards, radius", [(2000, 8, None), (1999, 8, 0.7), (7, 8, None),
                                               (500, 3, 0.5)])
def test_shard_points_by_x_equals_jax(rng, n, shards, radius):
    pts = np.zeros((n, 4), np.float32)
    pts[:, 1:] = rng.rand(n, 3) * np.array([40, 8, 3])
    pts[:, 1] = np.round(pts[:, 1], 1)  # ties in x: the sort must be stable
    for a, b in zip(tps.shard_points_by_x(pts, shards, radius),
                    jps.shard_points_by_x(pts, shards, radius)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_shard_points_by_x_refuses_thin_slabs(rng):
    pts = np.zeros((400, 4), np.float32)
    pts[:, 1] = rng.rand(400) * 2.0  # 8 slabs over 2 m: each thinner than 0.7 m
    with pytest.raises(ValueError, match="slab widths"):
        tps.shard_points_by_x(pts, 8, radius=0.7)
    with pytest.raises(ValueError, match="slab widths"):
        jps.shard_points_by_x(pts, 8, radius=0.7)


@pytest.mark.parametrize("devices", [8, 1])
def test_sharded_radius_neighbors_equal_jax_and_single_table(rng, devices):
    n, k, r = 2000, 8, 0.7
    pts = np.zeros((n, 4), np.float32)
    pts[:, 1:] = rng.rand(n, 3) * np.array([40, 8, 3])
    sp, gi, va = jps.shard_points_by_x(pts, devices)
    want = jps.sharded_radius_neighbors(jnp.asarray(sp), jnp.asarray(gi), jnp.asarray(va),
                                        jnp.asarray(r, jnp.float32), mesh=_jmesh(devices), k=k)
    got = tps.sharded_radius_neighbors(sp, gi, va, r, make_mesh(["cpu"] * devices), k=k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    fin = np.isfinite(np.asarray(want[1]))
    np.testing.assert_array_equal(np.isfinite(got[1].numpy()), fin)
    np.testing.assert_allclose(got[1].numpy()[fin], np.asarray(want[1])[fin], rtol=0, atol=2e-7)
    assert int(got[3].sum()) == 0
    # global neighbour id sets equal the port's single-table search
    idx, _, mask = thg.radius_graph(torch.as_tensor(pts), torch.as_tensor(pts), r, k)
    out, omask, gflat = got[0].reshape(-1, k), got[2].reshape(-1, k), gi.reshape(-1)
    for slot in np.nonzero(gflat >= 0)[0]:
        q = gflat[slot]
        assert set(out[slot][omask[slot]].tolist()) == set(idx[q][mask[q]].tolist()), q


def test_halo_cap_truncation_equals_jax(rng):
    """A dense band just right of the slab boundary overflows a 32-point
    halo: the per-slab counts equal JAX's exactly."""
    n = 1024
    pts = np.zeros((n, 4), np.float32)
    pts[: n // 2, 1] = rng.rand(n // 2) * 10.0
    pts[n // 2:, 1] = 10.5 + rng.rand(n // 2) * 0.3
    pts[:, 2] = rng.rand(n) * 2
    sp, gi, va = jps.shard_points_by_x(pts, 2)
    want = jps.sharded_radius_neighbors(jnp.asarray(sp), jnp.asarray(gi), jnp.asarray(va),
                                        jnp.asarray(0.7, jnp.float32), mesh=_jmesh(2), k=4,
                                        halo_cap=32)
    got = tps.sharded_radius_neighbors(sp, gi, va, 0.7, make_mesh(["cpu"] * 2), k=4, halo_cap=32)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[3][1]) >= n // 2 - 32 - 64
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def _blobs_and_chain(rng):
    blobs = []
    for cx in range(12):
        c = np.array([cx * 6.0, rng.rand() * 8, rng.rand()])
        blobs.append(c + rng.randn(40, 3).astype(np.float32) * 0.15)
    chain = np.stack([np.linspace(0, 70, 160), np.full(160, 15.0), np.zeros(160)],
                     1).astype(np.float32)  # spacing 0.44 < r: one component end to end
    xyz = np.concatenate(blobs + [chain]).astype(np.float32)
    return np.concatenate([np.zeros((len(xyz), 1), np.float32), xyz], 1)


@pytest.mark.parametrize("devices, halo_cap", [(8, 256), (4, 4096), (1, 256)])
def test_sharded_cc_equals_jax_and_single_table(rng, devices, halo_cap):
    r, k = 0.7, 16
    pts = _blobs_and_chain(rng)
    n = len(pts)
    sp, gi, va = jps.shard_points_by_x(pts, devices, radius=r)
    want_roots, want_trunc = jps.sharded_connected_components(
        jnp.asarray(sp), jnp.asarray(gi), jnp.asarray(va), jnp.asarray(r, jnp.float32),
        mesh=_jmesh(devices), k=k, halo_cap=halo_cap)
    telemetry.reset()
    roots, trunc = tps.sharded_connected_components(sp, gi, va, r, make_mesh(["cpu"] * devices),
                                                    k=k, halo_cap=halo_cap)
    np.testing.assert_array_equal(roots.numpy(), np.asarray(want_roots))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(want_trunc))
    assert int(trunc.sum()) == 0
    if devices > 1:
        assert telemetry.snapshot()["shard_halo_bytes"] > 0
    gflat = gi.reshape(-1)
    got = np.full(n, -1, np.int64)
    got[gflat[gflat >= 0]] = roots.numpy().reshape(-1)[gflat >= 0]
    idx, _, mask = thg.radius_graph(torch.as_tensor(pts), torch.as_tensor(pts), r, k)
    want = tcc.connected_components_knn(idx, mask).numpy()
    _, got_c = np.unique(got, return_inverse=True)
    _, want_c = np.unique(want, return_inverse=True)
    pairs = set(zip(got_c.tolist(), want_c.tolist()))
    assert len(pairs) == len(set(got_c.tolist())) == len(set(want_c.tolist()))
    assert len(set(got_c[n - 160:].tolist())) == 1  # the chain crosses every slab boundary


def _proposal_seq(rng):
    pts = []
    for f in range(4):
        for cx in range(10):
            c = np.array([cx * 7.0, (cx % 3) * 5.0, 1.0])
            blob = c + rng.randn(30, 3) * 0.2
            pts.append(np.concatenate([np.full((30, 1), f, np.float32),
                                       blob.astype(np.float32)], 1))
    fxyz = np.concatenate(pts)
    return dict(point_fxyz=fxyz, point_sweep=fxyz[:, 0].astype(np.int64))


CFG = dict(COMPONENT_KEYS=["cluster"], GRAPH=dict(RADIUS=[0.7], MAX_NUM_NEIGHBORS=16),
           CHUNK_FRAMES=2)


def test_cluster_proposal_num_shards_equals_jax(rng, capsys):
    seq = _proposal_seq(rng)
    want = JProposal(dict(CFG, NUM_SHARDS=8))(dict(seq))["point_cluster"]
    telemetry.reset()
    got = ClusterProposal(dict(CFG, NUM_SHARDS=8), device="cpu")(dict(seq))["point_cluster"]
    np.testing.assert_array_equal(got, want)
    assert "proposal_halo_truncated" in telemetry.snapshot()
    assert telemetry.snapshot()["proposal_halo_truncated"] == 0
    # the same partition as the port's unsharded kNN proposal
    one = ClusterProposal(dict(CFG, CC_GRAPH="knn"), device="cpu")(dict(seq))["point_cluster"]
    pairs = set(zip(one.tolist(), got.tolist()))
    assert len(pairs) == len(set(one.tolist())) == len(set(got.tolist()))


def test_cluster_proposal_fallbacks(rng, capsys):
    """Fewer devices than shards, and slabs thinner than the radius: both
    print JAX's message and run on one device (the configured CC path)."""
    seq = _proposal_seq(rng)
    plain = ClusterProposal(dict(CFG), device="cpu")(dict(seq))["point_cluster"]
    few = ClusterProposal(dict(CFG, NUM_SHARDS=8), device="cpu", devices=["cpu"] * 4)
    np.testing.assert_array_equal(few(dict(seq))["point_cluster"], plain)
    assert few.num_shards == 1
    assert "NUM_SHARDS=8 but only 4 devices" in capsys.readouterr().out
    thin = dict(seq, point_fxyz=seq["point_fxyz"] * np.array([1, 0.02, 1, 1], np.float32))
    plain_thin = ClusterProposal(dict(CFG), device="cpu")(dict(thin))["point_cluster"]
    np.testing.assert_array_equal(
        ClusterProposal(dict(CFG, NUM_SHARDS=8), device="cpu")(dict(thin))["point_cluster"],
        plain_thin)
    assert "sharded CC fallback" in capsys.readouterr().out


@pytest.mark.parametrize("halo_cap", [1 << 17, 256])
def test_cluster_proposal_sharded_equals_jax_on_a_dense_scene(halo_cap):
    """One bench-scene frame (60,000 points, 1.25 m): the neighbour and
    cell caps bind at the slab boundaries (a halo copy of a point lists its
    k nearest among what its slab sees), so the sharded partition is not
    the unsharded kNN one, in JAX as in the port; the port's sharded labels
    and halo truncation equal JAX's exactly, also at a HALO_CAP of 256,
    where the strips overflow."""
    from pcseqlearning_tpu.utils import telemetry as jtelemetry
    from pcseqlearning_tpu_torch.scene import make_scene

    seq, _ = make_scene(num_frames=1, points_per_frame=60_000, seed=0)
    d = dict(point_fxyz=seq.astype(np.float32), point_sweep=seq[:, 0].astype(np.int64))
    cfg = dict(COMPONENT_KEYS=["c"], GRAPH=dict(RADIUS=[1.25], MAX_NUM_NEIGHBORS=32),
               CHUNK_FRAMES=10, NUM_SHARDS=4, HALO_CAP=halo_cap)
    jtelemetry.reset()
    want = JProposal(dict(cfg))(dict(d))["point_c"]
    telemetry.reset()
    got = ClusterProposal(dict(cfg), device="cpu")(dict(d))["point_c"]
    np.testing.assert_array_equal(got, want)
    trunc = telemetry.snapshot()["proposal_halo_truncated"]
    assert trunc == jtelemetry.snapshot().get("proposal_halo_truncated", 0)
    assert (trunc > 0) == (halo_cap == 256)
    knn = ClusterProposal(dict(cfg, NUM_SHARDS=1, CC_GRAPH="knn"), device="cpu")(dict(d))["point_c"]
    pairs = len(np.unique(np.stack([got, knn], 1), axis=0))
    assert pairs > max(len(np.unique(got)), len(np.unique(knn)))
