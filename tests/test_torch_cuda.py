"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU
mode); each is marked ``cuda`` and skips without a card. The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: none. Each kernel rounds its distances like its plain version
(no FMA contraction), so outputs must be equal.
"""

import numpy as np
import pytest
import torch

from pcseqlearning_tpu_torch.ops import pair_min as tpm
from pcseqlearning_tpu_torch.ops import sorted_grid as tsg

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
def test_cuda_cc_and_scan_match_plain(cuda_device):
    rng = np.random.RandomState(0)
    fxyz = T(_cloud(rng, 20000, frames=3, extent=40.0)).to(cuda_device)
    st = tsg.cc_prep(fxyz, None, 0.8, F=3, X=64, Y=64)
    lab = torch.arange(fxyz.shape[0], dtype=torch.int32, device=cuda_device)
    assert torch.equal(tsg.cc_round(st["sorted_xyz"], lab, st["bounds"], st["r2"]),
                       tsg.cc_round_plain(st["sorted_xyz"], lab, st["bounds"], st["r2"]))
    comp, num = tsg.connected_components_radius(fxyz, None, 0.8, F=3, X=64, Y=64)
    comp_p, num_p = tsg.connected_components_radius(fxyz.cpu(), None, 0.8, F=3, X=64, Y=64)
    assert num == num_p and torch.equal(comp.cpu(), comp_p)
    q = fxyz[:5000] + 0.05
    sc = tsg.scan_prep(fxyz, q, 0.8, F=3, X=64, Y=64)
    for k in (1, 8):
        got = tsg.radius_scan(sc["table"], sc["q_xyz"], sc["bounds"], sc["r2"], k)
        want = tsg.radius_scan_plain(sc["table"], sc["q_xyz"], sc["bounds"], sc["r2"], k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
                         torch.zeros((6, 0), dtype=torch.int32, device=cuda_device), 1.0)
    assert tsg.cc_round.launches == n0 and empty.shape == (0,)
