"""Registration: the port's register_to_next_frame (both nearest-neighbour
paths) and GD solver against the JAX package's, and the ICP against the
float64 reference-semantics oracle of tests/test_registration_oracle.py.

Tolerances: the ICP iteration count must be equal; transforms and errors
agree to 1e-4 (float32 sums in another order), edge ratios exactly. The
oracle is held at its own 2e-3. The GD solver runs 800 Adam steps per
solve, so its transforms agree to 1e-3, and its hand-written gradient
equals jax.grad of the same loss to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseqlearning_tpu.ops import hash_graph as jhg
from pcseqlearning_tpu.preprocessing import registration as jreg
from pcseqlearning_tpu.preprocessing import solver_utils as jsol
from pcseqlearning_tpu_torch.preprocessing import registration as treg
from pcseqlearning_tpu_torch.preprocessing import solver_utils as tsol
from pcseqlearning_tpu_torch.scene import make_rigid_scene as port_rigid_scene
from pcseqlearning_tpu_torch.utils import telemetry
from test_registration_oracle import make_rigid_scene, oracle_icp

T = torch.as_tensor
# one intra-op thread: the suite runs several pytest workers on the same cores
torch.set_num_threads(1)


_JAX_ITERATIONS = []
_while_loop = jax.lax.while_loop


def _recording_while_loop(cond, body, init):
    out = _while_loop(cond, body, init)
    jax.debug.callback(lambda it: _JAX_ITERATIONS.append(int(it)), out[-1])
    return out


@pytest.fixture
def jax_icp_iterations(monkeypatch):
    """The iteration count of each jitted JAX ICP loop (the last element of
    its while_loop state), recorded through a debug callback; the caches are
    cleared so that the loop is traced with the recorder."""
    _JAX_ITERATIONS.clear()
    monkeypatch.setattr(jax.lax, "while_loop", _recording_while_loop)
    jax.clear_caches()
    yield _JAX_ITERATIONS
    monkeypatch.undo()
    jax.clear_caches()


def _padded_scene(seed, pad=40):
    moving, comp, ref, gt_T = make_rigid_scene(seed)
    n, nr = len(moving), len(ref)
    mp = np.concatenate([moving, np.full((pad, 3), 1e8, np.float32)])
    cp = np.concatenate([comp, np.full(pad, -1, np.int32)])
    rp = np.concatenate([ref, np.full((pad, 3), 1e8, np.float32)])
    return mp, cp, np.arange(n + pad) < n, rp, np.arange(nr + pad) < nr


def _both(seed, kw):
    m, c, mv, r, rv = _padded_scene(seed)
    out_j = jreg.register_to_next_frame(m, c, mv, r, rv, num_components=5, radius=2.0, **kw)
    telemetry.reset()
    out_t = treg.register_to_next_frame(T(m), T(c), T(mv), T(r), T(rv), 5, 2.0, **kw)
    return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t], telemetry.snapshot()


def _assert_icp_equal(out_t, out_j, iters_t, iters_j):
    assert iters_t == iters_j
    np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-4)  # T
    np.testing.assert_allclose(out_t[1], out_j[1], atol=1e-4)  # l1 error
    np.testing.assert_array_equal(out_t[2], out_j[2])  # edge ratio
    np.testing.assert_allclose(out_t[3][:300], out_j[3][:300], atol=1e-4)  # moved points


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_to_next_frame_matches_jax(jax_icp_iterations, seed):
    kw = dict(angle_regularizer=10.0, max_iter=40, stopping_delta=5e-2)
    out_j, out_t, counters = _both(seed, kw)
    assert counters["registration_nn1_brute"] > 0 and counters.get("registration_nn1_hash", 0) == 0
    _assert_icp_equal(out_t, out_j, counters["registration_icp_iterations"],
                      jax_icp_iterations[-1])
    assert 3 <= jax_icp_iterations[-1] < 40


@pytest.mark.parametrize("seed", [0, 1])
def test_register_to_next_frame_hash_path_matches_jax(jax_icp_iterations, monkeypatch, seed):
    """The hash-grid path, which real tables take above 2^28 (query,
    reference) pairs: both modules' brute-force limit lowered to 0."""
    for mod in (jreg, treg):
        monkeypatch.setattr(mod, "_BRUTE_NN_MAX_ENTRIES", 0)
    kw = dict(angle_regularizer=10.0, max_iter=40, stopping_delta=5e-2)
    out_j, out_t, counters = _both(seed, kw)
    assert counters["registration_nn1_hash"] > 0 and counters.get("registration_nn1_brute", 0) == 0
    _assert_icp_equal(out_t, out_j, counters["registration_icp_iterations"],
                      jax_icp_iterations[-1])


def test_nn1_paths_match_jax_across_the_threshold(monkeypatch):
    """Both _nn1 paths of the port against the JAX package: the brute path
    against JAX's _nn1_brute, the hash path against hash_graph directly."""
    rng = np.random.RandomState(5)
    ref = (rng.rand(3000, 3) * [30, 30, 2]).astype(np.float32)
    q = (rng.rand(2000, 3) * [30, 30, 2]).astype(np.float32)
    q[:100] = ref[:100]  # exact hits
    rv, qv = rng.rand(3000) > 0.1, rng.rand(2000) > 0.1
    bj = [np.asarray(x) for x in jreg._nn1_brute(ref, rv, q, qv, 0.5)]
    bt = [x.numpy() for x in treg._nn1_brute(T(ref), T(rv), T(q), T(qv), 0.5)]
    np.testing.assert_array_equal(bt[2], bj[2])
    np.testing.assert_array_equal(bt[0][bj[2]], bj[0][bj[2]])
    np.testing.assert_allclose(bt[1][bj[2]], bj[1][bj[2]], rtol=3e-7)
    zf = lambda x: np.concatenate([np.zeros((len(x), 1), np.float32), x], 1)  # noqa: E731
    grid = jhg.build_hash_grid(jnp.asarray(zf(ref)), 0.5, jnp.asarray(rv))
    ij, dj, mj = (np.asarray(x)[:, 0] for x in jhg.radius_neighbors(
        grid, jnp.asarray(zf(q)), 0.5, 1, query_valid=jnp.asarray(qv), cell_cap=48))
    monkeypatch.setattr(treg, "_BRUTE_NN_MAX_ENTRIES", 0)  # the port's _nn1 on its hash path
    it, dt, mt = (x.numpy() for x in treg._nn1(T(ref), T(rv), T(q), T(qv), 0.5, 48))
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=3e-7)
    # both paths find the same nearest neighbours here (no ties, cap not hit)
    np.testing.assert_array_equal(mt, bt[2])
    np.testing.assert_array_equal(it[mt], bt[0][mt])


@pytest.mark.parametrize("kw", [{}, dict(per=400, rot_deg=5.0, trans=0.3)])
def test_port_rigid_scene_is_the_oracle_scene(kw):
    """scene.make_rigid_scene (the card runs it without the tests) is the
    oracle module's."""
    for a, b in zip(port_rigid_scene(0, **kw), make_rigid_scene(0, **kw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_icp_matches_the_float64_oracle_per_iteration(seed):
    moving, comp, ref, _ = make_rigid_scene(seed)
    hist = oracle_icp(moving, comp, ref, 5, 2.0)
    n = len(moving)
    for k in (1, 2, 4, len(hist)):
        k = min(k, len(hist))
        T_o, l1_o, _ = hist[k - 1]
        T_r, l1_r, _, _ = treg.register_to_next_frame(
            T(moving), T(comp), T(np.ones(n, bool)), T(ref), T(np.ones(len(ref), bool)), 5, 2.0,
            angle_regularizer=10.0, max_iter=k, stopping_delta=5e-2, trunc_dist=0.3)
        np.testing.assert_allclose(T_r.numpy(), T_o, atol=2e-3, err_msg=f"iter {k} transform")
        np.testing.assert_allclose(l1_r.numpy(), l1_o, atol=2e-3, err_msg=f"iter {k} l1")


@pytest.mark.parametrize("seed", [0, 3])
def test_icp_recovers_ground_truth_motion(seed):
    moving, comp, ref, gt_T = make_rigid_scene(seed, rot_deg=5.0, trans=0.3)
    n = len(moving)
    _, _, ratio, moved = treg.register_to_next_frame(
        T(moving), T(comp), T(np.ones(n, bool)), T(ref), T(np.ones(len(ref), bool)), 5, 2.0,
        angle_regularizer=10.0, max_iter=40, stopping_delta=5e-2)
    gt_moved = np.einsum("nij,nj->ni", gt_T[comp][:, :3, :3], moving) + gt_T[comp][:, :3, 3]
    assert np.median(np.linalg.norm(moved.numpy() - gt_moved, axis=-1)) < 0.08
    assert ratio.numpy().min() > 0.9


def test_gd_gradient_matches_jax_grad():
    rng = np.random.RandomState(7)
    n, k = 200, 8
    m = rng.randn(n, 3).astype(np.float32)
    tgt = (m + rng.randn(n, 3) * 0.1).astype(np.float32)
    ok = rng.rand(n) > 0.2
    nbr = rng.randint(0, n, (n, k))
    nbr_ok = rng.rand(n, k) > 0.3
    v = (rng.randn(n, 3) * 0.05).astype(np.float32)
    w = 1.0

    def loss_fn(v):  # the loss of solver_utils.gd_register, as JAX writes it
        fit = jnp.sum(jnp.where(ok[:, None], (m + v - tgt) ** 2, 0.0))
        rig = jnp.sum(jnp.where(nbr_ok[..., None], (v[:, None, :] - v[nbr]) ** 2, 0.0))
        return fit + w * rig

    gj = np.asarray(jax.grad(loss_fn)(jnp.asarray(v)))
    lt, gt = tsol._gd_loss_grad(T(v), T(m), T(tgt), T(ok), T(nbr), T(nbr_ok), w)
    np.testing.assert_allclose(gt.numpy(), gj, atol=1e-5)
    assert float(lt) == pytest.approx(float(loss_fn(jnp.asarray(v))), rel=1e-5)


def test_gd_register_matches_jax():
    m, c, mv, r, rv = _padded_scene(1)
    vj, lj = jsol.gd_register(m, mv, r, rv, 2.0, num_iters=50)
    vt, lt = tsol.gd_register(T(m), T(mv), T(r), T(rv), 2.0, num_iters=50)
    np.testing.assert_allclose(vt.numpy()[mv], np.asarray(vj)[mv], atol=1e-4)
    assert float(lt) == pytest.approx(float(lj), rel=1e-4)
    Tj, l1j, rj = (np.asarray(x) for x in jsol.gd_register_components(
        m, c, mv, r, rv, 5, jnp.asarray(2.0, jnp.float32)))
    Tt, l1t, rt = (x.numpy() for x in tsol.gd_register_components(
        T(m), T(c), T(mv), T(r), T(rv), 5, 2.0))
    np.testing.assert_allclose(Tt, Tj, atol=1e-3)
    np.testing.assert_allclose(l1t, l1j, atol=1e-3)
    np.testing.assert_array_equal(rt, rj)
