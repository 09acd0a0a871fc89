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
full-width CenterPoint repeat bit for bit.
"""

import numpy as np
import pytest
import torch

from pcseqlearning_tpu_torch.ops import hash_graph as thg
from pcseqlearning_tpu_torch.ops import pair_min as tpm
from pcseqlearning_tpu_torch.ops import sorted_grid as tsg
from pcseqlearning_tpu_torch.preprocessing import registration as treg
from pcseqlearning_tpu_torch.scene import make_rigid_scene
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
    from pathlib import Path

    from pcseqlearning_tpu_torch.config import cfg_from_yaml_file
    from pcseqlearning_tpu_torch.models import build_network
    from pcseqlearning_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from pcseqlearning_tpu_torch.scene import DETECTOR_CFG, bench_detector_batch
    from pcseqlearning_tpu_torch.utils.edict import EDict

    cfg = cfg_from_yaml_file(str(Path(__file__).resolve().parents[1] / DETECTOR_CFG), EDict())
    runtime = dict(data_cfg={"POINT_CLOUD_RANGE": [-19.2, -19.2, -2.0, 19.2, 19.2, 4.0],
                             "VOXEL_SIZE": [0.1, 0.1, 0.15]},
                   class_names=list(cfg.CLASS_NAMES), voxel_cap=30_000)
    batch = bench_detector_batch(2, 20_000, 18.7, seed=1)
    step = make_train_step(loss_key="center_loss", device=cuda_device)

    def run():
        state = init_train_state(build_network(cfg.MODEL, runtime, device=cuda_device),
                                 device=cuda_device)
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
