"""The batched tracking walk: the port against the JAX package's
tracking_batched on small packed tiles — component packing, voxel dedup,
the ICP level, velocity smoothing, and whole walks (both directions through
``walk_direction``) in windows built so that each stopping rule fires.

The JAX side runs ``pair_min`` by direct differences (the Pallas kernel's
arithmetic, which the port's kernel computes), patched in for these tests.
Tolerances: the ICP level, packing and dedup match to float32 rounding
(1e-4 on transforms). A whole walk does not: each step's velocity
smoothing is Adam with lr 0.01 and a loss-countdown stop, so a last-bit
difference in the loss can end it one iteration earlier or later and move
a velocity by a whole 0.01 m/frame step, which later steps carry along.
Walk transforms and errors are therefore held at 0.05 (a few such steps),
while the decisions — stop, moving and validity flags, reach — must be
equal and the claims must agree on >= 99% of window slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import pallas_tpu
from pcseqlearning_tpu.preprocessing import tracking_batched as jtb
from pcseqlearning_tpu.preprocessing import tracking_device as jtd
from pcseqlearning_tpu_torch.preprocessing import tracking_batched as ttb
from pcseqlearning_tpu_torch.preprocessing import tracking_device as ttd

T = torch.as_tensor
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)


def _direct_pair_min(a, b, a_mask, b_mask):
    d = a[:, :, None, :] - b[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    f = jnp.where(b_mask[:, None, :], d2, jnp.inf)
    w = jnp.where(a_mask[:, :, None], d2, jnp.inf)
    return f.min(2), f.argmin(2).astype(jnp.int32), w.min(1), w.argmin(1).astype(jnp.int32)


@pytest.fixture
def jax_direct_pair_min(monkeypatch):
    monkeypatch.setattr(pallas_tpu, "pair_min", _direct_pair_min)
    jax.clear_caches()  # drop walk programs traced with the XLA pair_min
    yield
    jax.clear_caches()


def test_pack_components_device_matches_jax():
    rng = np.random.RandomState(0)
    K, C, P = 700, 8, 64
    xyz = rng.randn(K, 3).astype(np.float32)
    comp = rng.choice([-1, 0, 1, 2, 5, 7], K, p=[0.05, 0.5, 0.2, 0.1, 0.1, 0.05])
    keep = rng.rand(K) > 0.1
    tj, mj = map(np.asarray, jtb.pack_components_device(
        jnp.asarray(xyz), jnp.asarray(comp.astype(np.int32)), jnp.asarray(keep), C, P))
    tt, mt = ttb.pack_components_device(T(xyz), T(comp), T(keep), C, P)
    np.testing.assert_array_equal(mt.numpy(), mj)
    np.testing.assert_array_equal(tt.numpy(), tj)


def test_voxel_dedup_matches_jax():
    rng = np.random.RandomState(1)
    xyz = (rng.rand(4, 64, 3) * 2).astype(np.float32)
    mask = rng.rand(4, 64) > 0.3
    mask[2] = False
    rj, fj = map(np.asarray, jtb._voxel_dedup(jnp.asarray(xyz), jnp.asarray(mask),
                                              jnp.asarray([0.4, 0.4, 0.6], jnp.float32)))
    rt, ft = (x.numpy() for x in ttb._voxel_dedup(T(xyz), T(mask), (0.4, 0.4, 0.6)))
    np.testing.assert_array_equal(ft.sum(1), fj.sum(1))
    for c in range(4):  # the same voxel means (rows are unordered sets)
        a = np.sort(rt[c][ft[c]], axis=0)
        b = np.sort(rj[c][fj[c]], axis=0)
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_icp_level_matches_jax(jax_direct_pair_min):
    rng = np.random.RandomState(2)
    C, P = 3, 64
    src = (rng.rand(C, P, 3) * [3, 1.5, 1.2]).astype(np.float32)
    ang = np.array([0.06, -0.03, 0.0])
    R = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
                  for a in ang]).astype(np.float32)
    dst = np.einsum("cij,cpj->cpi", R, src) + np.array([[0.3, -0.2, 0.0]], np.float32)[:, None]
    dst = (dst + rng.randn(C, P, 3) * 0.01).astype(np.float32)
    mask = rng.rand(C, P) > 0.1
    rmask = mask.copy()
    rmask[2] = False  # an empty candidate set registers nothing
    T0 = np.broadcast_to(np.eye(4, dtype=np.float32), (C, 4, 4))
    Tj, lj, rj = map(np.asarray, jtb._icp_level(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst), jnp.asarray(rmask),
        jnp.asarray(T0), jnp.asarray(1.0, jnp.float32), jnp.asarray(10.0, jnp.float32), 20,
        jnp.asarray(1e-4, jnp.float32)))
    Tt, lt, rt = (x.numpy() for x in ttb._icp_level(
        T(src), T(mask), T(dst), T(rmask), T(T0), 1.0, 10.0, 20, 1e-4))
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    np.testing.assert_allclose(lt, lj, atol=1e-4)
    np.testing.assert_allclose(rt, rj, atol=1e-6)
    np.testing.assert_array_equal(Tt[2], np.eye(4, dtype=np.float32))


def test_smooth_velos_matches_jax():
    rng = np.random.RandomState(3)
    C, W = 5, 9
    velos = (rng.randn(C, W, 3) * 0.3).astype(np.float32)
    diffs = (velos + rng.randn(C, W, 3) * 0.05).astype(np.float32)
    velos[:, :, 2] = 0
    active = np.zeros(W, bool)
    active[3:8] = True
    vj = np.asarray(jtd._smooth_velos(jnp.asarray(velos), jnp.asarray(diffs), jnp.asarray(active)))
    vt = ttd._smooth_velos(T(velos), T(diffs), T(active)).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_array_equal(vt[:, ~active], velos[:, ~active])


# ---------------------------------------------------------------------------
# whole walks, one window per stopping rule
# ---------------------------------------------------------------------------

INTERVAL = 4
W = 2 * INTERVAL + 1
N_SLOT = 256
LEVELS = ((0.4, 0.4, 0.6, 2.5, 1e-4), (0.1, 0.1, 0.15, 0.5, 1e-4))


def _line(v):
    return [(v * (w - INTERVAL), 0.0, 0.0) for w in range(W)]


def _teleport_after(tw):
    traj = _line(0.2)
    for w in range(tw, W):
        traj[w] = (traj[w][0] + 30.0, 30.0, 0.0)  # out of every search radius
    return traj


def _velocity_jump(tw=INTERVAL + 2):
    return [(0.1 * (w - INTERVAL), 0.0, 0.0) if w <= tw - 1 else
            (0.1 * (tw - 1 - INTERVAL) + 2.2 * (w - (tw - 1)), 0.0, 0.0) for w in range(W)]


def _sustained_turn(speed=1.2, turn=np.pi / 4, tw=INTERVAL + 2):
    pos, heading, xs = np.zeros(2), 0.0, {INTERVAL: np.zeros(2)}
    for w in range(INTERVAL + 1, W):
        heading += turn if w >= tw else 0.0
        pos = pos + speed * np.array([np.cos(heading), np.sin(heading)])
        xs[w] = pos.copy()
    for w in range(INTERVAL - 1, -1, -1):
        xs[w] = xs[w + 1] - np.array([speed, 0.0])
    return [(xs[w][0], xs[w][1], 0.0) for w in range(W)]


TW = INTERVAL + 2
# each window is built so that one stopping rule fires (the scenarios of
# tests/test_stopping_rules.py); ``fires`` checks it on the JAX result
SCENARIOS = {
    "reg_error_stop": dict(blobs=[(96, (1.2, 0.8, 0.5))], trajs=[_teleport_after(TW)],
                           coeff=0.13, fires=lambda o: o["reach_max"][0] == TW - 1),
    "edge_ratio_stop": dict(blobs=[(120, (1.2, 0.8, 0.5)), (60, (1.2, 0.8, 0.5))],
                            trajs=[_line(0.0), [(40.0, 40.0, 0.0)] * W], packed=1,
                            present={0: range(TW)}, mmf=1,
                            fires=lambda o: o["reach_max"][0] == TW - 1),
    "velocity_stop": dict(blobs=[(96, (0.6, 0.5, 0.4))], trajs=[_velocity_jump()], mmf=1,
                          fires=lambda o: o["reach_max"][0] < W - 1),
    "angle_stop": dict(blobs=[(96, (2.5, 2.0, 0.6))], trajs=[_sustained_turn()], angle=10.0,
                       mmf=1, diameter=6.0, fires=lambda o: o["reach_max"][0] < W - 1),
    "min_move_gate": dict(blobs=[(96, (1.2, 0.8, 0.5))] * 2, trajs=[_line(0.4), _line(0.001)],
                          offsets=[(0, 0, 0), (15.0, 0, 0)],
                          fires=lambda o: o["moving"][0] and not o["moving"][1]),
    "final_validity": dict(blobs=[(96, (1.2, 0.8, 0.5))],
                           trajs=[[(0.0, 0.0, 0.0) if w == INTERVAL else
                                   (30.0 + 10.0 * w, 40.0, 0.0) for w in range(W)]],
                           coeff=0.13, fires=lambda o: not o["valid_final"][0]),
}


def _window(rng, spec):
    blobs = [(rng.randn(n, 3) * scale + [0.0, 0.0, 1.0]).astype(np.float32)
             for n, scale in spec["blobs"]]
    offsets = spec.get("offsets", [(0, 0, 0)] * len(blobs))
    wxyz = np.full((W, N_SLOT, 3), 1e8, np.float32)
    wval = np.zeros((W, N_SLOT), bool)
    for w in range(W):
        pts = [blob + np.asarray(tr[w], np.float32) + np.asarray(off, np.float32)
               for i, (blob, tr, off) in enumerate(zip(blobs, spec["trajs"], offsets))
               if w in spec.get("present", {}).get(i, range(W))]
        pts = np.concatenate(pts)
        wxyz[w, :len(pts)] = pts
        wval[w, :len(pts)] = True
    packed = spec.get("packed", len(blobs))
    n = sum(len(b) for b in blobs[:packed])
    comp = np.repeat(np.arange(packed), [len(b) for b in blobs[:packed]])
    return wxyz, wval, wxyz[INTERVAL, :n], comp


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_walk_matches_jax(jax_direct_pair_min, name):
    spec = SCENARIOS[name]
    rng = np.random.RandomState(7)
    wxyz, wval, anchor, comp = _window(rng, spec)
    C = int(comp.max()) + 1
    cx, cm = jtb.pack_components(anchor, comp, np.ones(len(comp), bool), C, 128)
    diam = np.array([spec.get("diameter") or 2 * np.linalg.norm(
        anchor[comp == c, :2] - anchor[comp == c, :2].mean(0), axis=1).max()
        for c in range(C)], np.float32)
    deg = np.bincount(comp).astype(np.float32)
    kw = dict(interval=INTERVAL, levels=LEVELS, num_candidates=128, nn_radius=0.3,
              angle_regularizer=10.0, reg_error_coeff=spec.get("coeff", 1e6),
              angle_threshold_deg=spec.get("angle", 1e6), min_move_frame=spec.get("mmf", 2),
              max_icp_iter=20)
    stat = np.zeros((W, N_SLOT), bool)
    out_j = jtb.track_window_batched(wxyz, wval, stat, cx, cm, np.ones(C, bool), diam, deg,
                                     **kw)
    assert spec["fires"](out_j), "the scenario's stopping rule must fire"
    out_t = ttb.track_window_batched(T(wxyz), T(wval), T(stat), T(cx), T(cm),
                                     T(np.ones(C, bool)), T(diam), T(deg), **kw)
    for k in ("valid_final", "moving", "reach_min", "reach_max"):
        np.testing.assert_array_equal(out_t[k], np.asarray(out_j[k]), err_msg=k)
    for k in ("transforms", "reg_errors", "edge_ratios"):
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), atol=0.05, err_msg=k)
    ec_j = jtb.densify_claims(out_j["extract_comp"])
    assert (out_t["extract_comp"] == ec_j).mean() >= 0.99
