"""The CUDA kernels against their plain PyTorch versions, and the hash-grid
neighbour search and registration on the card against the same code on
the CPU.

Every test here needs an NVIDIA GPU (and nvcc for the kernels); each is
marked ``cuda`` and skips without a card. The file imports neither JAX nor
the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: none for the kernels and the neighbour search. Each kernel
rounds its distances like its plain version (no FMA contraction), and the
search is elementwise PyTorch, so outputs must be equal. Registration on
the card agrees with the CPU to 1e-3 after the same first iterations: its
segment sums add in another order (a segmented reduction over sorted runs
where the CPU adds row by row), and its cross term is a matrix product on
another library. The card's segment sums give the same bits on every call.
The sparse convs and the toy CenterPoint on the card equal the port on the
CPU with TF32 off: features and losses to 1e-5 relative, gradients to 1e-4
of each tensor's max |g| (float32 GEMMs blocked differently). With cuDNN
restricted to its deterministic algorithms, two train steps of the
full-width CenterPoint, SECOND and Voxel R-CNN repeat bit for bit, and so
do two runs of the detector-training CLI's loop (their checkpoints). NMS
on the card keeps exactly what it keeps on the CPU.
"""

import numpy as np
import pytest
import torch

from pcseqlearning_tpu_torch.ops import hash_graph as thg
from pcseqlearning_tpu_torch.ops import pair_min as tpm
from pcseqlearning_tpu_torch.ops import sorted_grid as tsg
from pcseqlearning_tpu_torch.preprocessing import registration as treg
from pcseqlearning_tpu_torch.scene import make_rigid_scene, reconstruction_keys
from pcseqlearning_tpu_torch.utils import telemetry

T = torch.as_tensor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cloud(rng, n, frames, extent):
    return np.concatenate([
        rng.randint(0, frames, (n, 1)).astype(np.float32),
        rng.rand(n, 2).astype(np.float32) * extent - extent / 2,
        rng.randn(n, 1).astype(np.float32) * 0.5,
    ], axis=1)


@pytest.mark.cuda
def test_cuda_pair_min_matches_plain(cuda_device):
    rng = np.random.RandomState(0)
    C, P, Q = 64, 256, 512
    a = T((rng.rand(C, P, 3) * 10 + 1000.0).astype(np.float32)).to(cuda_device)
    b = T((rng.rand(C, Q, 3) * 10 + 1000.0).astype(np.float32)).to(cuda_device)
    am = T(rng.rand(C, P) > 0.2).to(cuda_device)
    bm = T(rng.rand(C, Q) > 0.2).to(cuda_device)
    am[1] = False  # one fully-masked component per side
    bm[C - 1] = False
    n0 = tpm.pair_min.launches
    got = tpm.pair_min(a, b, am, bm)
    want = tpm.pair_min_plain(a, b, am, bm)
    assert tpm.pair_min.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 7, 144, 2048])
@pytest.mark.parametrize("P,Q", [(256, 512), (100, 300)])
def test_cuda_pair_min_bit_equal_across_splits(cuda_device, C, P, Q):
    """Every grid split the wrapper picks, ragged P and Q, fully masked rows
    on each side, duplicated points (ties go to the first index), 1 km from
    the origin."""
    rng = np.random.RandomState(C + P)
    a = rng.rand(C, P, 3).astype(np.float32) * 6 + 1000.0
    a[:, P // 2:P // 2 + 10] = a[:, :10]  # duplicates inside a
    b = rng.rand(C, Q, 3).astype(np.float32) * 6 + 1000.0
    b[:, :20] = a[:, :20]  # exact matches: d2 = 0
    b[:, 40:60] = a[:, :20]  # the same points again, later in b
    am, bm = rng.rand(C, P) > 0.3, rng.rand(C, Q) > 0.3
    am[:, :10] = bm[:, :20] = bm[:, 40:60] = True
    if C > 1:
        am[C // 2] = False  # a component whose backward rows are all empty
        bm[C - 1] = False  # and one whose forward rows are
    args = [T(x).to(cuda_device) for x in (a, b, am, bm)]
    n0 = tpm.pair_min.launches
    got = tpm.pair_min(*args)
    want = tpm.pair_min_plain(*args)
    assert tpm.pair_min.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g, w)
    fi, bi = got[1].cpu().numpy(), got[3].cpu().numpy()
    has_a, has_b = am.any(1), bm.any(1)
    assert (fi[has_b, :10] == np.arange(10)).all()  # first of the tied q's
    assert (bi[has_a, :10] == np.arange(10)).all() and (bi[has_a, 40:50] == np.arange(10)).all()


def _cc_case(case, rng):
    """(fxyz, F, X, radius): 'dense_column' packs a frame's points into a few
    columns, so a block's range outgrows one shared-memory chunk;
    'frames' spreads three frames over many columns (blocks end at column
    and frame boundaries); 'off_grid' leaves a third of the points outside
    the grid, where their runs are empty."""
    if case == "dense_column":
        return _cloud(rng, 12000, frames=1, extent=3.0), 1, 16, 0.8
    if case == "frames":
        return _cloud(rng, 20000, frames=3, extent=40.0), 3, 64, 0.8
    return _cloud(rng, 20000, frames=2, extent=40.0), 2, 36, 0.8


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense_column", "frames", "off_grid"])
def test_cuda_cc_round_bit_equal(cuda_device, case):
    rng = np.random.RandomState(1)
    cloud, F, X, r = _cc_case(case, rng)
    fxyz = T(cloud).to(cuda_device)
    st = tsg.cc_prep(fxyz, None, r, F=F, X=X, Y=X)
    plan = st["plan"]
    span = (plan[:, 5:8] - plan[:, 2:5]).max()
    if case == "dense_column":
        assert span > 1024  # more than one chunk of csrc/cc_round.cu's CC_CHUNK
    if case == "off_grid":
        off = (st["bounds"] == 0).all(0)
        assert 0 < int(off.sum()) < fxyz.shape[0]
    m = fxyz.shape[0]
    for labels in (torch.arange(m, dtype=torch.int32, device=cuda_device),
                   T(rng.permutation(m).astype(np.int32)).to(cuda_device)):
        got = tsg.cc_round(st["sorted_xyz"], labels, st["bounds"], st["r2"], plan)
        assert torch.equal(got, tsg.cc_round_plain(st["sorted_xyz"], labels, st["bounds"],
                                                   st["r2"]))
    comp, num = tsg.connected_components_radius(fxyz, None, r, F=F, X=X, Y=X)
    comp_p, num_p = tsg.connected_components_radius(fxyz.cpu(), None, r, F=F, X=X, Y=X)
    assert num == num_p and torch.equal(comp.cpu(), comp_p)


@pytest.mark.cuda
def test_cuda_cc_and_scan_match_plain(cuda_device):
    rng = np.random.RandomState(0)
    fxyz = T(_cloud(rng, 20000, frames=3, extent=40.0)).to(cuda_device)
    st = tsg.cc_prep(fxyz, None, 0.8, F=3, X=64, Y=64)
    lab = torch.arange(fxyz.shape[0], dtype=torch.int32, device=cuda_device)
    assert torch.equal(tsg.cc_round(st["sorted_xyz"], lab, st["bounds"], st["r2"], st["plan"]),
                       tsg.cc_round_plain(st["sorted_xyz"], lab, st["bounds"], st["r2"]))
    comp, num = tsg.connected_components_radius(fxyz, None, 0.8, F=3, X=64, Y=64)
    comp_p, num_p = tsg.connected_components_radius(fxyz.cpu(), None, 0.8, F=3, X=64, Y=64)
    assert num == num_p and torch.equal(comp.cpu(), comp_p)
    q = fxyz[:5000] + 0.05
    sc = tsg.scan_prep(fxyz, q, 0.8, F=3, X=64, Y=64)
    for k in (1, 4, 8):
        n0 = tsg.radius_scan.launches
        got = tsg.radius_scan(sc["table"], sc["q_xyz"], sc["bounds"], sc["r2"], k, sc["plan"])
        assert tsg.radius_scan.launches == n0 + 1
        want = tsg.radius_scan_plain(sc["table"], sc["q_xyz"], sc["bounds"], sc["r2"], k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _window_case(rng):
    """A tracked window as the claims send it: 11 frames of a dense cloud
    (the queries, in frame order, each frame padded to 24,000 rows with
    zero rows marked invalid) against a sparse set of extracted points (the
    references: one query in five, 300 of them twice, so exact ties), with
    a dense patch whose blocks' ranges outgrow one shared-memory chunk."""
    F, n = 11, 20000
    frames = []
    for f in range(F):
        pts = _cloud(rng, n, frames=1, extent=60.0)
        pts[:6000, 1:3] = pts[:6000, 1:3] * 0.02 + 5.0  # a dense patch
        pts[:, 0] = f
        frames.append(np.concatenate([pts, np.zeros((4000, 4), np.float32)]))
    q = np.concatenate(frames)
    qv = (np.arange(len(q)) % 24000) < n
    ref = q[qv][rng.rand(int(qv.sum())) < 0.2]
    ref = np.concatenate([ref, ref[:300]])
    return ref, q, qv, 0.5, F, 256


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 8])
def test_cuda_radius_scan_window_bit_equal(cuda_device, k):
    """Unsorted window queries with padded rows, exact ties, empty blocks and
    multi-chunk blocks: the kernel equals its plain version, and the public
    entry on the card equals it on the CPU."""
    ref, q, qv, r, F, X = _window_case(np.random.RandomState(k))
    args = (T(ref).to(cuda_device), T(q).to(cuda_device), r)
    sc = tsg.scan_prep(*args, F, X, X, query_valid=T(qv).to(cuda_device))
    plan = sc["plan"]
    span = (plan[:, 5:8] - plan[:, 2:5]).sum(1)
    assert (span == 0).any() and (span > 1024).any()  # csrc/radius_scan.cu's SCAN_CHUNK
    got = tsg.radius_scan(sc["table"], sc["q_xyz"], sc["bounds"], sc["r2"], k, plan)
    want = tsg.radius_scan_plain(sc["table"], sc["q_xyz"], sc["bounds"], sc["r2"], k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if k > 1:
        tie = (want[0][:, 1:] == want[0][:, :-1]) & (want[1][:, 1:] >= 0)
        assert tie.any()
    out = tsg.radius_neighbors_sorted(*args, k, F, X, X, query_valid=T(qv).to(cuda_device))
    out_cpu = tsg.radius_neighbors_sorted(*(a.cpu() if hasattr(a, "cpu") else a for a in args),
                                          k, F, X, X, query_valid=T(qv))
    for g, w in zip(out, out_cpu):
        assert torch.equal(g.cpu(), w)


def _stream_lattice(C, P, Q):
    """Points on a 0.25 m lattice 1 km from the origin (ties across the
    streamed mode's slices and tiles), 20% masked, a third of the last
    component's a side masked, component 0's b side masked when C > 1."""
    rng = np.random.RandomState(P + Q)
    a = rng.randint(0, 40, (C, P, 3)).astype(np.float32) * 0.25 + 1000.0
    b = rng.randint(0, 40, (C, Q, 3)).astype(np.float32) * 0.25 + 1000.0
    am, bm = rng.rand(C, P) > 0.2, rng.rand(C, Q) > 0.2
    am[-1, : P // 3] = False
    if C > 1:
        bm[0] = False  # every forward row of component 0 is empty
    return a, b, am, bm


def _stream_mixed_masks():
    """C = 3, masks mixed on both sides: random halves; a all valid against
    30% of b; a masked in runs of 27 (a head's samples) against all of b."""
    rng = np.random.RandomState(11)
    a = (rng.rand(3, 16_000, 3) * 50 + 1000.0).astype(np.float32)
    b = (rng.rand(3, 5_000, 3) * 50 + 1000.0).astype(np.float32)
    am = np.stack([rng.rand(16_000) > 0.5, np.ones(16_000, bool),
                   np.repeat(rng.rand(16_000 // 27 + 1) > 0.3, 27)[:16_000]])
    bm = np.stack([rng.rand(5_000) > 0.5, rng.rand(5_000) > 0.7, np.ones(5_000, bool)])
    return a, b, am, bm


def _stream_border_ties():
    """A 4-step lattice (64 distinct points, so every distance ties many
    times), rows past two tile borders and columns past two slice borders
    (S_TILE 1024, S_SLICE 4096), the points at the borders duplicated."""
    rng = np.random.RandomState(13)
    a = rng.randint(0, 4, (1, 20_000, 3)).astype(np.float32)
    b = rng.randint(0, 4, (1, 9_000, 3)).astype(np.float32)
    a[0, 1024], a[0, 2048] = a[0, 1023], a[0, 2047]
    b[0, 4096], b[0, 8192] = b[0, 4095], b[0, 8191]
    return a, b, rng.rand(1, 20_000) > 0.1, rng.rand(1, 9_000) > 0.1


_STREAM_CASES = {
    "1x20000x700": lambda: _stream_lattice(1, 20_000, 700),
    "1x900x30000": lambda: _stream_lattice(1, 900, 30_000),
    "2x15000x5000": lambda: _stream_lattice(2, 15_000, 5_000),
    "1x110592x4096": lambda: _stream_lattice(1, 27 * 4096, 4096),
    "3x16000x5000_mixed_masks": _stream_mixed_masks,
    "heads_two_batch_keys": lambda: reconstruction_keys(8192, seed=12, invalid=0.05),
    "lattice_ties_across_borders": _stream_border_ties,
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_STREAM_CASES))
def test_cuda_pair_min_streamed_mode_bit_equal(cuda_device, case):
    """Sides past the tile's 14,464 points take the streamed mode: bit for
    bit the plain version (in tiles), ties across its slices and tiles
    going to the first index, masked and empty rows on both sides, P much
    larger and much smaller than Q, C > 1, the reconstruction head's keys;
    counted in ``stream_launches``."""
    args = [T(x).to(cuda_device) for x in _STREAM_CASES[case]()]
    n0, s0 = tpm.pair_min.launches, tpm.pair_min.stream_launches
    got = tpm.pair_min(*args)
    torch.cuda.synchronize()
    assert tpm.pair_min.launches == n0 + 1 and tpm.pair_min.stream_launches == s0 + 1
    want = tpm.pair_min_plain(*args)
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g, w)
    again = tpm.pair_min(*args)  # the atomics' order of arrival changes nothing
    for g, w in zip(again, got):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_knn_bruteforce_matches_cpu(cuda_device):
    """The chunked kNN (a topk over unique keys) on the card: the CPU's
    indices, distances to 1e-5, on a lattice with two samples."""
    from pcseqlearning_tpu_torch.ops import sampling as tsm

    rng = np.random.RandomState(0)
    ref = T(rng.randint(0, 30, (6000, 3)).astype(np.float32) * 0.3)
    qry = T(rng.rand(3000, 3).astype(np.float32) * 9)
    rb, qb = T(rng.randint(0, 2, 6000)), T(rng.randint(0, 2, 3000))
    rv = T(rng.rand(6000) > 0.1)
    want = tsm.knn_bruteforce(ref, qry, 9, rv, rb, qb, block=1 << 20)
    got = tsm.knn_bruteforce(*(x.to(cuda_device) for x in (ref, qry)), 9,
                             *(x.to(cuda_device) for x in (rv, rb, qb)), block=1 << 20)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.allclose(got[1].cpu(), want[1], atol=1e-5)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs_and_skip_empty_launches(cuda_device):
    a = torch.zeros((2, 8, 3), device=cuda_device)
    b = torch.zeros((2, 16, 3), device=cuda_device)
    am = torch.ones((2, 8), dtype=torch.bool, device=cuda_device)
    bm = torch.ones((2, 16), dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        tpm.pair_min(a.double(), b, am, bm)
    with pytest.raises(ValueError):
        tpm.pair_min(a, b, am.cpu(), bm)
    with pytest.raises(ValueError):
        tpm.pair_min(a.transpose(0, 1).contiguous().transpose(0, 1), b, am, bm)
    n0 = tpm.pair_min.launches
    out = tpm.pair_min(a[:0], b[:0], am[:0], bm[:0])
    assert tpm.pair_min.launches == n0 and out[0].shape == (0, 8)
    n0 = tsg.cc_round.launches
    empty = tsg.cc_round(torch.zeros((0, 3), device=cuda_device),
                         torch.zeros(0, dtype=torch.int32, device=cuda_device),
                         torch.zeros((6, 0), dtype=torch.int32, device=cuda_device), 1.0,
                         torch.zeros((0, 8), dtype=torch.int32, device=cuda_device))
    assert tsg.cc_round.launches == n0 and empty.shape == (0,)
    n0 = tsg.radius_scan.launches
    d2, pos = tsg.radius_scan(torch.zeros((4, 3), device=cuda_device),
                              torch.zeros((0, 3), device=cuda_device),
                              torch.zeros((6, 0), dtype=torch.int32, device=cuda_device), 1.0, 2,
                              torch.zeros((0, 8), dtype=torch.int32, device=cuda_device))
    assert tsg.radius_scan.launches == n0 and d2.shape == (0, 2) and pos.shape == (0, 2)
    with pytest.raises(ValueError):  # the kernel's radius test needs a finite r2
        tsg.radius_scan(torch.zeros((4, 3), device=cuda_device),
                        torch.zeros((1, 3), device=cuda_device),
                        torch.zeros((6, 1), dtype=torch.int32, device=cuda_device),
                        float("inf"), 1, torch.zeros((1, 8), dtype=torch.int32,
                                                     device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_cuda_radius_neighbors_matches_cpu(cuda_device, k):
    """Two query chunks, padded queries, duplicated references (exact ties)
    and a dense patch past the per-probe cell cap."""
    rng = np.random.RandomState(k)
    ref = _cloud(rng, 20000, frames=3, extent=40.0)
    ref[:3000, 1:3] = ref[:3000, 1:3] * 0.02
    ref[12000:14000] = ref[4000:6000]
    q = _cloud(rng, 50000, frames=3, extent=40.0)
    q[:2000] = ref[:2000]
    q[2000:4000] = ref[4000:6000]
    qv = rng.rand(len(q)) > 0.05
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        grid = thg.build_hash_grid(T(ref).to(dev), 0.5)
        assert int(thg.cell_cap_overflow(grid)) > 0
        outs.append([x.cpu() for x in thg.radius_neighbors(grid, T(q).to(dev), 0.5, k,
                                                           query_valid=T(qv).to(dev))])
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    if k > 1:
        d2, mask = outs[1][1], outs[1][2]
        assert ((d2[:, 1:] == d2[:, :-1]) & mask[:, 1:]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("per,path", [(60, "brute"), (4000, "hash")])
def test_cuda_register_to_next_frame_matches_cpu(cuda_device, per, path):
    """The rigid scene of tests/test_registration_oracle.py: 300 points take
    the brute-force correspondences, 20,000 the hash grid. The card equals
    the CPU after 1, 2, 4 and 8 iterations; a full run passes near-tied
    correspondences that last-bit differences (atomic sums, another matrix
    product) resolve the other way, and its loss countdown can stop a few
    iterations apart, so full runs are held to the true motion. Two runs on
    the card give the same bits."""
    m, c, ref, gt = make_rigid_scene(0, per=per, rot_deg=5.0, trans=0.3)
    n = len(m)
    args = (m, c, np.ones(n, bool), ref, np.ones(n, bool))

    def run(dev, max_iter):
        telemetry.reset()
        out = treg.register_to_next_frame(*(T(a).to(dev) for a in args), 5, 2.0,
                                          angle_regularizer=10.0, max_iter=max_iter,
                                          stopping_delta=5e-2)
        assert telemetry.snapshot()[f"registration_nn1_{path}"] > 0
        return [x.cpu().numpy() for x in out]

    gt_moved = np.einsum("nij,nj->ni", gt[c][:, :3, :3], m) + gt[c][:, :3, 3]
    for dev in (cuda_device, torch.device("cpu")):
        assert np.median(np.linalg.norm(run(dev, 40)[3] - gt_moved, axis=-1)) < 0.08
    for k in (1, 2, 4, 8):
        np.testing.assert_allclose(run(cuda_device, k)[0], run(torch.device("cpu"), k)[0],
                                   atol=1e-3, err_msg=f"after {k} iterations")
    for a, b in zip(run(cuda_device, 40), run(cuda_device, 40)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_knn_proposal_matches_cpu(cuda_device):
    """ClusterProposal(CC_GRAPH="knn") on the card: the hash-grid neighbour
    table and the min-label propagation are exact (a scatter-min has no
    rounding), so every point's component label equals the CPU's."""
    from pcseqlearning_tpu_torch.pipeline import BENCH
    from pcseqlearning_tpu_torch.preprocessing import ClusterProposal
    from pcseqlearning_tpu_torch.scene import scene_dict

    d = scene_dict(12, 6000, seed=3)
    d["point_fxyz"] = d["point_fxyz"][d["point_fxyz"][:, 3] > 0.3]
    d["point_sweep"] = d["point_fxyz"][:, 0].astype(np.int64)
    cfg = dict(BENCH["proposal"], CC_GRAPH="knn")
    outs = [ClusterProposal(cfg, device=dev)(dict(d)) for dev in (cuda_device, "cpu")]
    for key in cfg["COMPONENT_KEYS"]:
        np.testing.assert_array_equal(outs[0][f"point_{key}"], outs[1][f"point_{key}"])
    np.testing.assert_array_equal(outs[0]["point_pred_box_id"], outs[1]["point_pred_box_id"])


@pytest.mark.cuda
def test_cuda_ground_warm_start_matches_cpu(cuda_device, tmp_path):
    """The ground stage from a stored height field (DIR) on the card: the
    voxel means are atomic sums on the card, so heights agree to float32
    rounding (1e-5 m) and the horizon flags exactly."""
    from pcseqlearning_tpu_torch.pipeline import PARITY
    from pcseqlearning_tpu_torch.preprocessing import GroundPlaneRemover
    from pcseqlearning_tpu_torch.scene import scene_dict

    d = scene_dict(6, 8000, seed=5, frame_id="segment-2_005")
    cfg = dict(PARITY["ground"], DIR=str(tmp_path))
    GroundPlaneRemover(cfg, device="cpu")(dict(d))  # writes the field
    npz = tmp_path / "segment-2" / "pillar_height.npz"
    with np.load(npz) as f:
        shapes = {k: f[k].shape for k in f.files}
    rng = np.random.RandomState(0)
    np.savez(npz, **{k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in shapes.items()})
    outs = [GroundPlaneRemover(cfg, device=dev)(dict(d)) for dev in (cuda_device, "cpu")]
    np.testing.assert_allclose(outs[0]["full_point_height"], outs[1]["full_point_height"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(outs[0]["full_point_horizon"], outs[1]["full_point_horizon"])
    np.testing.assert_allclose(outs[0]["point_error"], outs[1]["point_error"], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_segment_sum_reproducible(cuda_device):
    """~1M rows into ~1k segments: the same bits over five calls, equal to
    the CPU's index_add_ to float32 summation error."""
    from pcseqlearning_tpu_torch.ops import segment_ops

    rng = np.random.RandomState(0)
    n, m = 1_000_000, 1000
    data = T(rng.rand(n, 3).astype(np.float32))
    ids = T(rng.randint(-5, m + 5, n))  # out-of-range ids are dropped
    ref = segment_ops.segment_sum(data, ids, m)
    outs = [segment_ops.segment_sum(data.to(cuda_device), ids.to(cuda_device), m).cpu()
            for _ in range(5)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), rtol=1e-5)
    mean = segment_ops.segment_mean(data[:, 0].to(cuda_device), ids.to(cuda_device), m)
    assert torch.equal(mean, segment_ops.segment_mean(data[:, 0].to(cuda_device),
                                                      ids.to(cuda_device), m))


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_cuda_sparse_conv_matches_cpu(cuda_device, no_tf32):
    from pcseqlearning_tpu_torch.ops import sparse_conv as tsc

    rng = np.random.RandomState(0)
    coords = np.unique(np.stack([rng.randint(0, 2, 3000), rng.randint(0, 20, 3000),
                                 rng.randint(0, 40, 3000), rng.randint(0, 40, 3000)], 1), axis=0)
    cap = len(coords) + 100
    cp = np.full((cap, 4), -1, np.int32)
    cp[:len(coords)] = coords
    valid = np.arange(cap) < len(coords)
    feats = np.where(valid[:, None], rng.randn(cap, 16), 0).astype(np.float32)
    w1 = rng.randn(27, 16, 32).astype(np.float32) * 0.1
    w2 = rng.randn(27, 32, 8).astype(np.float32) * 0.1

    def run(dev):
        f = T(feats).to(dev).requires_grad_(True)
        ws = [T(w).to(dev).requires_grad_(True) for w in (w1, w2)]
        st = tsc.SparseTensor(f, T(cp).to(dev), T(valid).to(dev), (20, 40, 40), 2)
        st = tsc.subm_conv3d(st, ws[0])
        st = tsc.sparse_conv3d(st, ws[1], out_cap=cap // 2)
        dense = tsc.to_dense(st)
        (dense ** 2).sum().backward()
        return [x.detach().cpu() for x in (st.coords, st.valid, dense, f.grad, *[w.grad for w in ws])]

    card, cpu = run(cuda_device), run(torch.device("cpu"))
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    for a, b in zip(card[2:], cpu[2:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
def test_cuda_centerpoint_matches_cpu(cuda_device, no_tf32):
    """The toy CenterPoint (tests/test_torch_detector.py's geometry, random
    weights from one seed): the card's voxel table exact, its losses and
    gradients equal to the CPU's, and two card runs the same losses."""
    from pcseqlearning_tpu_torch.models.detectors import build_detector
    from pcseqlearning_tpu_torch.utils.edict import EDict

    cfg = EDict(NAME="CenterPoint", VFE={"NAME": "DynamicMeanVFE"},
                BACKBONE_3D={"NAME": "VoxelResBackBone8x"}, MAP_TO_BEV={"NAME": "HeightCompression"},
                BACKBONE_2D={"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2, 2], "LAYER_STRIDES": [1, 2],
                             "NUM_FILTERS": [32, 64], "UPSAMPLE_STRIDES": [1, 2],
                             "NUM_UPSAMPLE_FILTERS": [32, 32]},
                DENSE_HEAD={"NAME": "CenterHead", "FEATURE_MAP_STRIDE": 8})
    runtime = dict(data_cfg={"POINT_CLOUD_RANGE": [-3.2, -3.2, -1.0, 3.2, 3.2, 2.2],
                             "VOXEL_SIZE": [0.2, 0.2, 0.2]},
                   class_names=["Vehicle", "Pedestrian"], voxel_cap=1024)
    rng = np.random.RandomState(0)
    pts = np.zeros((512, 4), np.float32)
    pts[:, 0] = rng.randint(0, 2, 512)
    pts[:, 1:3] = rng.rand(512, 2) * 6.0 - 3.0
    pts[:, 3] = rng.rand(512) * 1.5 - 0.5
    gt = np.zeros((2, 5, 8), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.5, 1.5, 1.5, 1.0, 0.3, 1]
    gt[:, 1] = [-1.0, -1.0, 0.5, 1.0, 1.0, 1.0, -0.3, 2]
    batch = dict(point_bxyz=pts, point_feat=rng.rand(512, 1).astype(np.float32), gt_boxes=gt)

    def run(dev):
        model = build_detector(cfg, runtime, device=dev, seed=3)
        out = model({**{k: T(v).to(dev) for k, v in batch.items()}, "batch_size": 2})
        out["losses"]["center_loss"].backward()
        return (out["voxel_coords"].cpu(), {k: float(v) for k, v in out["losses"].items()},
                {n: p.grad.cpu() for n, p in model.named_parameters()})

    card, again, cpu = run("cuda"), run("cuda"), run("cpu")
    assert torch.equal(card[0], cpu[0])
    assert card[1] == again[1]
    for k, v in cpu[1].items():
        np.testing.assert_allclose(card[1][k], v, rtol=1e-5)
    for n, g in cpu[2].items():
        np.testing.assert_allclose(card[2][n].numpy(), g.numpy(),
                                   atol=1e-4 * float(g.abs().max()), err_msg=n)


@pytest.fixture
def deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


@pytest.mark.cuda
def test_cuda_centerpoint_train_steps_repeat(cuda_device, no_tf32, deterministic_cudnn):
    """Two train steps of the full-width CenterPoint (centerpoint.yaml's
    MODEL at chip_smoke.py phase 7(a)'s cell), twice from the same seed,
    with cuDNN restricted to its deterministic algorithms (its default
    backward algorithms add in an order that changes from run to run):
    each step's losses and gradient norm, the gradients and the parameters
    are the same bits."""
    from pcseqlearning_tpu_torch.scene import DETECTOR_CFG

    _train_steps_repeat(cuda_device, DETECTOR_CFG, "center_loss")


def _train_steps_repeat(device, model_yaml, loss_key):
    """Two train steps of ``model_yaml``'s MODEL at full widths on chip_smoke.py
    phase 7(a)'s cell, twice from the same seed: each step's losses and
    gradient norm, the gradients and the parameters must be the same bits."""
    from pathlib import Path

    from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
    from pcseqlearning_tpu_torch.models import build_network
    from pcseqlearning_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from pcseqlearning_tpu_torch.scene import bench_detector_batch
    from pcseqlearning_tpu_torch.utils.edict import EDict

    cfg = cfg_from_yaml_file(str(Path(__file__).resolve().parents[1] / model_yaml), EDict())
    runtime = dict(data_cfg={"POINT_CLOUD_RANGE": [-19.2, -19.2, -2.0, 19.2, 19.2, 4.0],
                             "VOXEL_SIZE": [0.1, 0.1, 0.15]},
                   class_names=list(cfg.CLASS_NAMES), voxel_cap=30_000)
    batch = bench_detector_batch(2, 20_000, 18.7, seed=1)
    step = make_train_step(loss_key=loss_key, device=device)

    def run():
        state = init_train_state(build_network(cfg.MODEL, runtime, device=device), device=device)
        steps = []
        for _ in range(2):
            state, losses = step(state, batch)
            named = list(state.model.named_parameters())
            steps.append(({k: v.cpu() for k, v in losses.items()},
                          {n: p.grad.cpu() for n, p in named},
                          {n: p.detach().cpu() for n, p in named}))
        return steps

    for (la, ga, pa), (lb, gb, pb) in zip(run(), run()):
        for k in la:
            assert torch.equal(la[k], lb[k]), k
        for n in ga:
            assert torch.equal(ga[n], gb[n]), n
            assert torch.equal(pa[n], pb[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("model,loss_key", [("second", "rpn_loss"),
                                            ("voxel_rcnn", "total_loss")])
def test_cuda_anchor_and_two_stage_train_steps_repeat(cuda_device, no_tf32, deterministic_cudnn,
                                                      model, loss_key):
    """SECOND's and Voxel R-CNN's steps repeat bit for bit as CenterPoint's
    do: the anchor assignment's force-match, the NMS and the RoI stage's
    gathers add nothing in a run-to-run order."""
    _train_steps_repeat(cuda_device, f"tools/cfgs/waymo_models/{model}.yaml", loss_key)


@pytest.mark.cuda
def test_cuda_nms_bev_matches_cpu(cuda_device):
    """nms_bev and nms_normal_bev on the card keep what they keep on the
    CPU (1,024 clustered rotated boxes, tied scores, padded rows), and
    post_process_anchor returns the same rows over 5,120 copies of them.
    The threshold sits in the widest gap between the pairs' IoUs (the CPU's)
    in (0.4, 0.6), so that no rounding of the card's sines can flip a
    decision."""
    from pcseqlearning_tpu_torch.models.detectors import post_process_anchor
    from pcseqlearning_tpu_torch.ops import boxes as tbx

    rng = np.random.RandomState(0)
    n = 1024
    centres = rng.rand(300, 2) * 140 - 70
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = centres[rng.randint(0, 300, n)] + rng.randn(n, 2) * 0.8
    b[:, 3:6] = rng.rand(n, 3) * 3 + 1.0
    b[:, 6] = rng.rand(n) * 2 * np.pi - np.pi
    s = np.round(rng.rand(n), 2).astype(np.float32)
    v = rng.rand(n) > 0.1
    iou = tbx.boxes_iou_bev(T(b), T(b)).numpy()
    vals = np.unique(iou[(iou > 0.4) & (iou < 0.6)])
    gap = int(np.argmax(np.diff(vals)))
    thr = float(vals[gap] + vals[gap + 1]) / 2
    assert vals[gap + 1] - vals[gap] > 1e-5
    for fn in (tbx.nms_bev, tbx.nms_normal_bev):
        cpu = fn(T(b), T(s), thr, valid=T(v))
        card = fn(T(b).to(cuda_device), T(s).to(cuda_device), thr, valid=T(v).to(cuda_device))
        assert card.is_cuda and torch.equal(card.cpu(), cpu), fn.__name__
        assert 0 < int(cpu.sum()) < int(v.sum())
    cls = rng.rand(5 * n, 3).astype(np.float32)
    boxes = np.repeat(b, 5, 0)
    cpu = post_process_anchor(T(boxes), T(cls), nms_thresh=thr)
    card = post_process_anchor(T(boxes).to(cuda_device), T(cls).to(cuda_device), nms_thresh=thr)
    assert torch.equal(card[3].cpu(), cpu[3]) and bool(cpu[3].any())
    for a, c in zip(card[:3], cpu[:3]):
        np.testing.assert_allclose(a.cpu()[cpu[3]].numpy(), c[cpu[3]].numpy(), atol=1e-6)


@pytest.mark.cuda
def test_cuda_detector_cli_train_loop_repeats(cuda_device, tmp_path):
    """Two steps of the detector-training CLI (centerpoint.yaml,
    detection_1sweep.yaml and onecycle_centerpoint.yaml unchanged but for
    the data path, the output root, batch 2 and one epoch, over 4 written
    frames of 40,000 points: the one-cycle AdamW with its clip), run twice
    into two tags: the two checkpoints are the same bits (parameters,
    batch-norm buffers, optimizer moments and count). ``train.main`` sets
    ``cudnn.deterministic`` itself."""
    from pathlib import Path

    from pcseqlearning_tpu_torch import train
    from pcseqlearning_tpu_torch.scene import detector_argv, write_detector_sequences

    repo = Path(__file__).resolve().parents[1]
    data, _ = write_detector_sequences(tmp_path, frames=4, points=40_000)

    def run(tag):
        out = train.main(detector_argv(repo, data, tmp_path, "cuda", "--batch_size", "2",
                                       "--epochs", "1", "--fix_random_seed", "--extra_tag", tag))
        assert len(out["history"]) == 2
        return torch.load(Path(out["ckpt_dir"]) / "checkpoint_epoch_1", map_location="cpu",
                          weights_only=True)

    a, b = run("a"), run("b")
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 2
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, ts in a["optimizer"]["moments"].items():
        for i, (x, y) in enumerate(zip(ts, b["optimizer"]["moments"][k])):
            assert torch.equal(x, y), (k, i)


@pytest.mark.cuda
def test_cuda_sharded_cc_matches_cpu(cuda_device):
    """The x-sharded CC with the card standing for 4 devices equals the
    same code over 4 CPU slots: root ids and truncation counts, also at a
    halo cap small enough to truncate."""
    from pcseqlearning_tpu_torch.parallel import make_mesh
    from pcseqlearning_tpu_torch.parallel import point_shard as tps

    rng = np.random.RandomState(0)
    pts = _cloud(rng, 20_000, 2, 60.0)
    sp, gi, va = tps.shard_points_by_x(pts, 4, radius=0.8)
    for cap in (4096, 64):
        card = tps.sharded_connected_components(sp, gi, va, 0.8, make_mesh([cuda_device] * 4),
                                                k=16, halo_cap=cap, cell_cap=24)
        cpu = tps.sharded_connected_components(sp, gi, va, 0.8, make_mesh(["cpu"] * 4),
                                               k=16, halo_cap=cap, cell_cap=24)
        assert card[0].is_cuda
        assert torch.equal(card[0].cpu(), cpu[0]), cap
        assert torch.equal(card[1].cpu(), cpu[1]), cap


def _card_dp_rank(rank, world, weights):
    import torch.distributed as dist

    return _card_dp_steps(weights, dist.group.WORLD)


def _card_dp_steps(weights, group):
    from test_torch_dp_step import CFG, RUNTIME, dp_batch

    from pcseqlearning_tpu_torch.models.detectors import build_detector
    from pcseqlearning_tpu_torch.parallel import train_step as ts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    model = build_detector(CFG, RUNTIME, device="cpu")
    model.load_state_dict(weights)
    state = ts.init_train_state(model, device=dev, group=group)
    step = ts.make_train_step(loss_key="center_loss", device=dev, group=group)
    losses = []
    for _ in range(2):
        state, ls = step(state, dp_batch())
        losses.append({k: float(v) for k, v in ls.items()})
    return losses, {k: v.cpu() for k, v in state.model.state_dict().items()}


@pytest.mark.cuda
def test_cuda_dp_step_two_ranks_one_card(cuda_device, tmp_path):
    """Two gloo ranks sharing the card (collectives staged through the
    host) against the one-rank step on the card: first-step losses to
    1e-4, the ranks' parameters and buffers equal bit for bit."""
    from test_torch_dp_step import CFG, RUNTIME

    from pcseqlearning_tpu_torch.models.detectors import build_detector
    from pcseqlearning_tpu_torch.utils import dist_utils

    weights = build_detector(CFG, RUNTIME, device="cpu").state_dict()
    ranks = dist_utils.launch_ranks(_card_dp_rank, 2, str(tmp_path / "store"), args=(weights,),
                                    timeout=300, env={"LOCAL_RANK": "0"})
    one = _card_dp_steps(weights, None)
    for k, v in one[0][0].items():
        assert abs(ranks[0][0][0][k] - v) / max(abs(v), 1e-3) < 1e-4, k
    for k, v in ranks[0][1].items():
        assert torch.equal(v, ranks[1][1][k]), k


@pytest.mark.cuda
def test_cuda_gt_databases_equal_cpu(cuda_device, tmp_path):
    """The two database builders on the card write what they write on the
    CPU: create_gt_database's dbinfos pickle and every crop, and
    extract_foreground_instances' records and files."""
    import os
    import pickle

    from pcseqlearning_tpu_torch.scene import make_scene, write_waymo_sequence
    from pcseqlearning_tpu_torch.tools.create_gt_database import create_gt_database
    from pcseqlearning_tpu_torch.tools.extract_foreground_instances import (
        extract_foreground_instances)
    from pcseqlearning_tpu_torch.utils.edict import EDict

    out = {}
    for dev in ("cuda", "cpu"):
        root = tmp_path / dev
        seq, gt = make_scene(num_frames=2, points_per_frame=20_000, seed=3)
        gt["gt_box_attr"][:, 6] = np.linspace(-2.0, 2.5, len(gt["gt_box_attr"]))
        write_waymo_sequence(root, seq, gt, "segment-db")
        cfg = EDict(DATASET="WaymoDataset", DATA_PATH=str(root),
                    PROCESSED_DATA_TAG="waymo_processed_data_v0_5_0")
        infos, path = create_gt_database(cfg, ["Vehicle"], split="val", sampled_interval=1,
                                         device=dev, verbose=False)
        with open(path, "rb") as f:
            assert pickle.dumps(pickle.load(f)) == pickle.dumps(infos)
        crops = {n: (root / "gt_database_val" / n).read_bytes()
                 for n in sorted(os.listdir(root / "gt_database_val"))}
        pts = np.load(root / "waymo_processed_data_v0_5_0" / "segment-db" / "0000.npy")
        seg = np.load(root / "waymo_processed_data_v0_5_0" / "segment-db" / "0000_seg.npy")
        recs = extract_foreground_instances(pts, seg[:, 1], seg[:, 0],
                                            gt["gt_box_attr"][gt["gt_box_frame"] == 0],
                                            "0000", str(root / "fg"), device=dev)
        files = {n: (root / "fg" / n).read_bytes() for n in sorted(os.listdir(root / "fg"))}
        for r in (x for v in recs.values() for x in v):
            r["path"] = os.path.basename(r["path"])
        out[dev] = (pickle.dumps(infos), crops, pickle.dumps(recs), files)
    assert len(out["cpu"][1]) == 48 and len(out["cpu"][3]) > 0
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a == b


@pytest.mark.cuda
def test_cuda_waymo_conversion_and_propagation_equal_cpu(cuda_device, tmp_path):
    """A 2-frame TFRecord (TOP 32 x 512 with per-beam inclinations and
    segmentation labels on frame 0, four 16 x 64 lidars with a range)
    converted on the card and on the CPU: equal infos, _seg.npy files and
    point counts, xyz and range within one float32 ulp; then the
    propagation of the card's conversion on the card and, over a copy, on
    the CPU: equal _propseg.npy files but for points within 1e-5 m of a box
    face (float32 rounding of the membership test)."""
    import pickle
    import shutil

    from pcseqlearning_tpu_torch.scene import WAYMO_LIDARS, write_waymo_tfrecord
    from pcseqlearning_tpu_torch.tools import propagate_segmentation_labels as psl
    from pcseqlearning_tpu_torch.tools.create_waymo_infos import process_single_sequence

    lidars = [(n, 32 if n == "TOP" else 16, 512 if n == "TOP" else 64, *rest)
              for n, _, _, *rest in WAYMO_LIDARS]
    raw = tmp_path / "seg-cuda.tfrecord"
    write_waymo_tfrecord(raw, 2, seed=5, lidars=lidars, labels=20, seg_frames=[0])
    infos = {dev: process_single_sequence(str(raw), str(tmp_path / dev), device=dev)
             for dev in ("cuda", "cpu")}
    assert pickle.dumps(infos["cuda"]) == pickle.dumps(infos["cpu"])
    seq = {dev: tmp_path / dev / "seg-cuda" for dev in ("cuda", "cpu")}
    for idx in range(2):
        a, b = (np.load(seq[d] / f"{idx:04d}.npy") for d in ("cuda", "cpu"))
        assert a.shape == b.shape
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        assert (np.abs(a - b) <= ulp).all()
        assert np.array_equal(a[:, [3, 4]], b[:, [3, 4]])
        assert (seq["cuda"] / f"{idx:04d}_seg.npy").exists() == (idx == 0)
    assert np.array_equal(np.load(seq["cuda"] / "0000_seg.npy"),
                          np.load(seq["cpu"] / "0000_seg.npy"))
    shutil.copytree(seq["cuda"], tmp_path / "prop_cpu")
    assert psl.process_sequence(seq["cuda"], infos["cuda"], device="cuda") == 1
    assert psl.process_sequence(tmp_path / "prop_cpu", infos["cuda"], device="cpu") == 1
    a, b = np.load(seq["cuda"] / "0001_propseg.npy"), np.load(tmp_path / "prop_cpu" /
                                                              "0001_propseg.npy")
    rows = np.flatnonzero((a != b).any(1))
    pts = np.load(seq["cuda"] / "0001.npy")[rows, :3]
    assert (psl.box_face_distance(pts, infos["cuda"][1]["annos"]["gt_boxes_lidar"])
            <= 1e-5).all()
    assert (a[:, 1] > 0).any()
