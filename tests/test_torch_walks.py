"""The reference-shaped tracking walks: the port's voxel
samples, device walk (track_window_stepped), host walk (track_frame_host,
with the ICP and the GD solver) and SimpleReg, each against the JAX package
on the same inputs (ClusterTracking end to end in each walk mode is in
tests/test_torch_walk_modes.py).

Tolerances. Voxel samples: equal (means to 1e-6, float sums in another
order). Both walks on the windows of tests/test_torch_tracking.py (one per
stopping rule; the device walk also on a window with an empty frame): the
bounds of the batched walk there, for the same reason (the Adam velocity
smoothing ends on a loss countdown, so a last-bit difference moves a
velocity by whole 0.01 m/frame steps): decisions equal, transforms and
errors 0.05, extractions >= 99% equal.

The host walk on tests/test_walk_parity.py's noisy 12 x 4000 scene is held
looser, because it is chaotic there in both packages: the ICP stop and the
smoothing stop are countdowns on losses summed over every component, so
one component's last-bit difference changes every component's iteration
count, and components with large residuals (0.5 m) then settle in other
local minima, 0.1-1.9 m apart after four steps; and a component whose ICP
iteration has no correspondence solves a near-isotropic Procrustes problem
whose result flips on the last bit. There the decisions (final validity,
moving) must agree on >= 98% of the components, the first step back be
within 0.05, the median transform within 0.05, and >= 95% of the extracted
points be equal. SimpleReg: equal box tables (velocities to 1e-6) and
subsample rows.
"""

import copy

import numpy as np
import pytest
import torch

from pcseqlearning_tpu.preprocessing import cluster_tracking as jct
from pcseqlearning_tpu.preprocessing import tracking_device as jtd
from pcseqlearning_tpu.preprocessing.simple_reg import SimpleReg as JSimpleReg
from pcseqlearning_tpu.utils.edict import EDict as JEDict
from pcseqlearning_tpu_torch import pipeline
from pcseqlearning_tpu_torch.convert import config_from_jax
from pcseqlearning_tpu_torch.preprocessing import SimpleReg
from pcseqlearning_tpu_torch.preprocessing import cluster_tracking as tct
from pcseqlearning_tpu_torch.preprocessing import tracking_device as ttd
from pcseqlearning_tpu_torch.scene import scene_batch, scene_dict
from test_torch_tracking import INTERVAL, LEVELS, N_SLOT, SCENARIOS, W, _line, _window

T = torch.as_tensor
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)
# the JAX package's import-time defaults, written into the port's config
JAX_ENV = {"PCSEQ_FINE_CANDIDATES": "256", "PCSEQ_ANGLE_VELO_EXEMPT": "0.05",
           "PCSEQ_CELL_CAP": "48"}


def _frame(rng, n=3000):
    xyz = (rng.rand(n, 3) * [20, 20, 3]).astype(np.float32)
    xyz[:200] = xyz[200:400] + 0.01  # voxels with several points
    comp = rng.randint(-1, 30, n).astype(np.int32)
    stat = rng.rand(n) > 0.7
    valid = rng.rand(n) > 0.1
    xyz[~valid] = 1e8
    return xyz, comp, stat, valid


def test_sample_frame_kernel_matches_jax():
    xyz, comp, stat, valid = _frame(np.random.RandomState(0))
    fxyz = np.concatenate([np.zeros((len(xyz), 1), np.float32), xyz], axis=1)
    vs = np.asarray([0.4, 0.4, 0.6], np.float32)
    want = [np.asarray(x) for x in jct._sample_frame_kernel(
        fxyz, comp, stat.astype(np.float32), valid, vs)]
    got = [x.numpy() for x in tct._sample_frame_kernel(T(fxyz), T(comp), T(stat), T(valid),
                                                       [0.4, 0.4, 0.6])]
    occ = want[3]
    np.testing.assert_array_equal(got[3], occ)
    np.testing.assert_allclose(got[0][occ], want[0][occ], atol=1e-6)
    np.testing.assert_array_equal(got[1][occ], want[1][occ])
    np.testing.assert_array_equal(got[2][occ], want[2][occ])


def test_grid_sample_masked_matches_jax():
    xyz, comp, stat, valid = _frame(np.random.RandomState(1))
    want = [np.asarray(x) for x in jtd._grid_sample_masked(
        xyz, comp, stat, valid, np.asarray([0.2, 0.2, 0.3], np.float32))]
    got = [x.numpy() for x in ttd._grid_sample_masked(T(xyz), T(comp), T(stat), T(valid),
                                                      (0.2, 0.2, 0.3))]
    ok = want[3]
    np.testing.assert_array_equal(got[3], ok)
    np.testing.assert_allclose(got[0][ok], want[0][ok], atol=1e-6)
    np.testing.assert_array_equal(got[1][ok], want[1][ok])
    np.testing.assert_array_equal(got[2][ok], want[2][ok])


# ---------------------------------------------------------------------------
# the device walk, one window per stopping rule
# ---------------------------------------------------------------------------

# an empty frame two steps ahead: that step is inactive and the walk goes on
EMPTY_FRAME = dict(blobs=[(96, (1.2, 0.8, 0.5))], trajs=[_line(0.2)], mmf=1,
                   empty=INTERVAL + 2,
                   fires=lambda o: (o["reach_max"][0] == W - 1
                                    and np.allclose(o["transforms"][0, INTERVAL + 2], np.eye(4))))
DEVICE_WINDOWS = dict(SCENARIOS, empty_frame=EMPTY_FRAME)


@pytest.mark.parametrize("name", sorted(DEVICE_WINDOWS))
def test_device_walk_matches_jax(name):
    spec = DEVICE_WINDOWS[name]
    wxyz, wval, anchor, comp = _window(np.random.RandomState(7), spec)
    if "empty" in spec:
        wxyz[spec["empty"]], wval[spec["empty"]] = 1e8, False
    C = int(comp.max()) + 1
    anchor_comp = np.full(N_SLOT, -1, np.int32)
    anchor_comp[:len(comp)] = comp
    diam = np.array([spec.get("diameter") or 2 * np.linalg.norm(
        anchor[comp == c, :2] - anchor[comp == c, :2].mean(0), axis=1).max()
        for c in range(C)], np.float32)
    args = (wxyz, wval, anchor_comp, np.zeros(N_SLOT, bool), np.ones(C, bool), diam,
            np.bincount(comp).astype(np.float32))
    kw = dict(num_components=C, interval=INTERVAL, levels=LEVELS, nn_radius=0.3,
              angle_regularizer=10.0, reg_error_coeff=spec.get("coeff", 1e6),
              angle_threshold_deg=spec.get("angle", 1e6), min_move_frame=spec.get("mmf", 2),
              max_icp_iter=20)
    out_j = {k: np.asarray(v) for k, v in jtd.track_window_stepped(*args, **kw).items()}
    assert spec["fires"](out_j), "the window's stopping rule must fire"
    out_t = {k: v.numpy() for k, v in ttd.track_window(*(T(a) for a in args), **kw).items()}
    assert set(out_t) == set(out_j)
    for k in ("valid_final", "moving", "reach_min", "reach_max"):
        np.testing.assert_array_equal(out_t[k], out_j[k], err_msg=k)
    for k in ("transforms", "reg_errors", "edge_ratios", "comp_velos", "comp_centers"):
        np.testing.assert_allclose(out_t[k], out_j[k], atol=0.05, err_msg=k)
    assert (out_t["extract_src"] == out_j["extract_src"]).mean() >= 0.99


# ---------------------------------------------------------------------------
# the host walk
# ---------------------------------------------------------------------------


def _window_sequence(spec):
    """The window of ``spec`` as a sequence: frames 0..W-1, blob i of frame
    w labelled component i + 10 w (each frame's blobs are its own
    components, so the anchor's stay small enough to track)."""
    wxyz, _, _, _ = _window(np.random.RandomState(7), spec)
    sizes = [n for n, _ in spec["blobs"]]
    fxyz, comp = [], []
    for w in range(W):
        lab = np.concatenate([np.full(sizes[i], i + 10 * w) for i in range(len(sizes))
                              if w in spec.get("present", {}).get(i, range(W))])
        fxyz.append(np.concatenate([np.full((len(lab), 1), w, np.float32), wxyz[w, :len(lab)]], 1))
        comp.append(lab)
    fxyz = np.concatenate(fxyz)
    return {"point_fxyz": fxyz, "point_sweep": fxyz[:, 0].astype(np.int64),
            "point_blob": np.concatenate(comp)}


def _host_walks(d, comp_key, cfg, frame_id):
    """track_frame_host of both packages for one anchor frame."""
    tr = tct.ClusterTracking(cfg, device="cpu")
    seq_points, _, seq_dev, seq_index = tr._load_sequence(d)
    tr._set_components(seq_points, seq_dev, np.asarray(d[comp_key]).astype(np.int64))
    fr = tr._anchor_frame(seq_points, seq_index, frame_id)
    et = tr.track_frame_host(seq_points, fr, None, seq_index)
    ej = jct.ClusterTracking(JEDict(cfg)).track_frame_host(JEDict(dict(seq_points)),
                                                           JEDict(dict(fr)), None)
    nc = int(fr.component.max()) + 1

    def flags(e):
        valid, moving = np.zeros(nc, bool), np.zeros(nc, bool)
        valid[e.component] = True
        moving[e.component] = e.moving
        return valid, moving

    rows = [set(zip(e.original_indices.tolist(), e.component.tolist())) for e in (et, ej)]
    agreement = len(rows[0] & rows[1]) / len(rows[0] | rows[1]) if rows[0] | rows[1] else 1.0
    return et, ej, flags(et), flags(ej), agreement


@pytest.mark.parametrize("name,solver", [(n, "ICP") for n in sorted(SCENARIOS)]
                         + [("reg_error_stop", "GD"), ("velocity_stop", "GD")])
def test_host_walk_matches_jax(name, solver):
    spec = SCENARIOS[name]
    cfg = copy.deepcopy(pipeline.PARITY["tracking"])
    cfg.update(WALK_MODE="host", COMPONENT_KEYS=["blob"], MAX_ICP_ITER=20,
               NN_GRAPH=dict(cfg.NN_GRAPH, RADIUS=0.3))
    cfg.REGISTRATION.update(VOXEL_SIZE=[list(lv[:3]) for lv in LEVELS],
                            STOPPING_DELTA=[lv[4] for lv in LEVELS], SOLVER=solver)
    cfg.REGISTRATION.GRAPH.update(RADIUS=[lv[3] for lv in LEVELS])
    cfg.TRACKING_PARAMS.update(
        REGISTRATION_ERROR_COEFFICIENT=spec.get("coeff", 1e6), TRACK_INTERVAL=INTERVAL,
        ANGLE_THRESHOLD=spec.get("angle", 1e6), MIN_MOVE_FRAME=spec.get("mmf", 2))
    et, ej, (vt, mt), (vj, mj), agreement = _host_walks(
        _window_sequence(spec), "point_blob", config_from_jax(cfg, env=JAX_ENV), INTERVAL)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(mt, mj)
    for k in ("transforms", "reg_errors", "comp_edge_ratios"):
        np.testing.assert_allclose(et[k], np.asarray(ej[k]), atol=0.05, err_msg=k)
    assert agreement >= 0.99




def _proposed(num_frames, points, seed):
    d = scene_dict(num_frames, points, seed=seed)
    ground, proposal, _ = pipeline.build_stages(pipeline.PARITY, device="cpu")
    return proposal(ground(d))


@pytest.fixture(scope="module")
def walk_parity_proposed():
    """tests/test_walk_parity.py's scene and stage configs (its ground and
    proposal are pipeline.PARITY's), proposed by the port."""
    return _proposed(12, 4000, 3)


def test_track_frame_host_matches_jax(walk_parity_proposed):
    cfg = copy.deepcopy(pipeline.PARITY["tracking"])
    cfg.update(WALK_MODE="host")
    # two steps each way (four in the full config) keep the CPU run short
    cfg.TRACKING_PARAMS.update(TRACK_INTERVAL=2, MIN_MOVE_FRAME=2)
    et, ej, (vt, mt), (vj, mj), agreement = _host_walks(
        walk_parity_proposed, "point_component_rad1x25", config_from_jax(cfg, env=JAX_ENV), 4)
    assert vt.sum() >= 10
    assert (vt != vj).mean() <= 0.02 and (mt != mj).mean() <= 0.02
    both = vt & vj
    dT = np.abs(et.transforms - np.asarray(ej.transforms))[both]
    dT = dT.reshape(both.sum(), et.transforms.shape[1], -1).max(-1)
    assert dT[:, 1].max() < 0.05  # the first step back (frame 3 is slot 1)
    assert np.median(dT) < 0.05
    assert agreement >= 0.95


# ---------------------------------------------------------------------------
# SimpleReg
# ---------------------------------------------------------------------------


def test_simple_reg_forward_matches_jax(tmp_path, capsys):
    batch = scene_batch(3, 1500, seeds=(0, 1))
    bxyz = batch["point_bxyz"]
    bxyz[1::10, 1:4] = bxyz[0:-1:10, 1:4] + 0.001  # pairs of points in one 8 cm voxel
    batch["gt_box_attr"][0, 5, 3:6] = 0  # empty boxes: per-frame padding
    batch["gt_box_attr"][1, 30:33, 3:6] = 0
    (tmp_path / "seq_001").mkdir()
    (tmp_path / "seq_001" / "all.pkl").write_bytes(b"")  # an already extracted sequence
    cfg = dict(SUBSAMPLE=True, PREPROCESSORS=[], SAVE_DIR=str(tmp_path))
    bt, bj = copy.deepcopy(batch), copy.deepcopy(batch)
    assert SimpleReg(cfg, device="cpu").forward(bt) == JSimpleReg(JEDict(cfg)).forward(bj)
    out = capsys.readouterr().out
    assert "Working on seq_000.npy" in out and "Skipping seq_001.npy" in out
    for b in range(2):
        st, sj = bt[f"seq_{b}"], bj[f"seq_{b}"]
        assert set(st) == set(sj)
        assert len(st["point_fxyz"]) < (batch["point_bxyz"][:, 0] == b).sum()  # subsampled
        assert len(st["gt_box_attr"]) == 3 * 24 - (1 if b == 0 else 3)
        for k, v in sj.items():
            v = np.asarray(v)
            if v.dtype.kind == "f":
                np.testing.assert_allclose(np.asarray(st[k]), v, rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(np.asarray(st[k]), v, err_msg=k)
        assert st["moving"].any() and not st["moving"].all()
