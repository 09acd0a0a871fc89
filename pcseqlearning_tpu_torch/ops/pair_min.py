"""Batched pairwise distance with bidirectional masked min/argmin — the
ICP correspondence search of the tracking walk.

Counterpart of pcseqlearning_tpu.ops.pallas_tpu.pair_min (its Pallas
kernel ``_kernel``). Semantics, for a [C, P, 3], b [C, Q, 3]:
    d2[c, p, q] = |a[c, p] - b[c, q]|^2 by direct differences
    fwd_d2[c, p] = min over q where b_mask of d2, fwd_idx its first argmin
    bwd_d2[c, q] = min over p where a_mask of d2, bwd_idx its first argmin
An empty row gives +inf and index 0.

On the card ``pair_min`` launches the hand-written kernel in
``csrc/pair_min.cu``; on CPU tensors it runs ``pair_min_plain``, the same
arithmetic in PyTorch. ``pair_min.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_MAX_SMEM = 227 * 1024


def pair_min_plain(a, b, a_mask, b_mask):
    """Plain PyTorch version (components chunked to bound the [C, P, Q]
    temporaries)."""
    C, P, _ = a.shape
    Q = b.shape[1]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=a.device)
    step = max(1, (1 << 24) // max(P * Q, 1))
    fd, fi, bd, bi = [], [], [], []
    for c0 in range(0, C, step):
        aa, bb = a[c0:c0 + step], b[c0:c0 + step]
        dx = aa[:, :, None, 0] - bb[:, None, :, 0]
        dy = aa[:, :, None, 1] - bb[:, None, :, 1]
        dz = aa[:, :, None, 2] - bb[:, None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        f = torch.where(b_mask[c0:c0 + step, None, :], d2, inf).min(dim=2)
        w = torch.where(a_mask[c0:c0 + step, :, None], d2, inf).min(dim=1)
        fd.append(f.values)
        fi.append(f.indices)
        bd.append(w.values)
        bi.append(w.indices)
    if C == 0:
        z = a.new_zeros
        return (z((0, P)), z((0, P), dtype=torch.int32), z((0, Q)),
                z((0, Q), dtype=torch.int32))
    return (torch.cat(fd), torch.cat(fi).to(torch.int32),
            torch.cat(bd), torch.cat(bi).to(torch.int32))


def _launcher():
    fn = cuda_build.load("pair_min.cu").pair_min_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def pair_min(a, b, a_mask, b_mask):
    """a [C, P, 3] f32, b [C, Q, 3] f32, a_mask [C, P] bool, b_mask [C, Q]
    bool -> (fwd_d2 [C, P] f32, fwd_idx [C, P] i32, bwd_d2 [C, Q] f32,
    bwd_idx [C, Q] i32)."""
    if a.device.type == "cpu":
        return pair_min_plain(a, b, a_mask, b_mask)
    if a.device.type != "cuda":
        raise ValueError(f"pair_min: unsupported device {a.device}")
    C, P, Q = a.shape[0], a.shape[1], b.shape[1]
    dev = a.device
    cuda_build.require(a, "a", torch.float32, (C, P, 3), dev)
    cuda_build.require(b, "b", torch.float32, (C, Q, 3), dev)
    cuda_build.require(a_mask, "a_mask", torch.bool, (C, P), dev)
    cuda_build.require(b_mask, "b_mask", torch.bool, (C, Q), dev)
    if (P + Q) * 16 > _MAX_SMEM:
        raise ValueError(f"pair_min: P + Q = {P + Q} exceeds the kernel's "
                         f"shared-memory tile ({_MAX_SMEM // 16} points)")
    fd = torch.empty((C, P), dtype=torch.float32, device=dev)
    fi = torch.empty((C, P), dtype=torch.int32, device=dev)
    bd = torch.empty((C, Q), dtype=torch.float32, device=dev)
    bi = torch.empty((C, Q), dtype=torch.int32, device=dev)
    if C == 0:
        return fd, fi, bd, bi
    fn = _launcher()
    with torch.cuda.device(dev):
        code = fn(a.data_ptr(), b.data_ptr(), a_mask.data_ptr(), b_mask.data_ptr(),
                  C, P, Q, fd.data_ptr(), fi.data_ptr(), bd.data_ptr(), bi.data_ptr(),
                  cuda_build.stream_of(a))
    cuda_build.check(code, "pair_min")
    pair_min.launches += 1
    return fd, fi, bd, bi


pair_min.launches = 0
