"""Batched pairwise distance with bidirectional masked min/argmin — the
ICP correspondence search of the tracking walk.

Counterpart of pcseqlearning_tpu.ops.pallas_tpu.pair_min (its Pallas
kernel ``_kernel``). Semantics, for a [C, P, 3], b [C, Q, 3]:
    d2[c, p, q] = |a[c, p] - b[c, q]|^2 by direct differences
    fwd_d2[c, p] = min over q where b_mask of d2, fwd_idx its first argmin
    bwd_d2[c, q] = min over p where a_mask of d2, bwd_idx its first argmin
An empty row gives +inf and index 0.

On the card ``pair_min`` launches the hand-written kernel in
``csrc/pair_min.cu`` (its tiled mode, or its streamed mode for sides past
the tile); on CPU tensors it runs ``pair_min_plain``, the same arithmetic
in PyTorch. ``pair_min.launches`` counts kernel launches,
``pair_min.stream_launches`` those of the streamed mode.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# the tiled mode's dynamic shared-memory tile (one float4 per staged point);
# its static shared memory takes the rest of the 227 KB a block may use
_MAX_SMEM = 226 * 1024


def _merge(best, arg, d, i):
    """Keep (best, arg) but where the later chunk's (d, i) is strictly
    smaller: ties keep the earlier, lower index."""
    take = d < best
    return torch.where(take, d, best), torch.where(take, i, arg)


def pair_min_plain(a, b, a_mask, b_mask, block=1 << 24):
    """Plain PyTorch version. The [C, P, Q] distances are taken in blocks of
    at most ``block`` entries: components first; where one component's
    [P, Q] is larger, also tiles of P rows by Q columns, whose minima merge
    in index order with a strict < (the first argmin, as one min over the
    whole row gives)."""
    C, P, _ = a.shape
    Q = b.shape[1]
    if C == 0:
        z = a.new_zeros
        return (z((0, P)), z((0, P), dtype=torch.int32), z((0, Q)),
                z((0, Q), dtype=torch.int32))
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=a.device)
    step = max(1, block // max(P * Q, 1))
    tq = min(Q, max(1, block))
    tp = min(P, max(1, block // max(tq, 1)))
    fd, fi, bd, bi = [], [], [], []
    for c0 in range(0, C, step):
        aa, bb = a[c0:c0 + step], b[c0:c0 + step]
        am, bm = a_mask[c0:c0 + step], b_mask[c0:c0 + step]
        c = aa.shape[0]
        f_best = torch.full((c, P), float("inf"), device=a.device)
        f_arg = torch.zeros((c, P), dtype=torch.int64, device=a.device)
        b_best = torch.full((c, Q), float("inf"), device=a.device)
        b_arg = torch.zeros((c, Q), dtype=torch.int64, device=a.device)
        for p0 in range(0, P, tp):
            for q0 in range(0, Q, tq):
                ap, bq = aa[:, p0:p0 + tp], bb[:, q0:q0 + tq]
                dx = ap[:, :, None, 0] - bq[:, None, :, 0]
                dy = ap[:, :, None, 1] - bq[:, None, :, 1]
                dz = ap[:, :, None, 2] - bq[:, None, :, 2]
                d2 = dx * dx + dy * dy + dz * dz
                f = torch.where(bm[:, None, q0:q0 + tq], d2, inf).min(dim=2)
                w = torch.where(am[:, p0:p0 + tp, None], d2, inf).min(dim=1)
                if q0 == 0:
                    f_best[:, p0:p0 + tp], f_arg[:, p0:p0 + tp] = f.values, f.indices
                else:
                    f_best[:, p0:p0 + tp], f_arg[:, p0:p0 + tp] = _merge(
                        f_best[:, p0:p0 + tp], f_arg[:, p0:p0 + tp], f.values, f.indices + q0)
                if p0 == 0:
                    b_best[:, q0:q0 + tq], b_arg[:, q0:q0 + tq] = w.values, w.indices
                else:
                    b_best[:, q0:q0 + tq], b_arg[:, q0:q0 + tq] = _merge(
                        b_best[:, q0:q0 + tq], b_arg[:, q0:q0 + tq], w.values, w.indices + p0)
        fd.append(f_best)
        fi.append(f_arg)
        bd.append(b_best)
        bi.append(b_arg)
    return (torch.cat(fd), torch.cat(fi).to(torch.int32),
            torch.cat(bd), torch.cat(bi).to(torch.int32))


def _launcher():
    fn = cuda_build.load("pair_min.cu").pair_min_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def pair_min(a, b, a_mask, b_mask):
    """a [C, P, 3] f32, b [C, Q, 3] f32, a_mask [C, P] bool, b_mask [C, Q]
    bool -> (fwd_d2 [C, P] f32, fwd_idx [C, P] i32, bwd_d2 [C, Q] f32,
    bwd_idx [C, Q] i32).

    On the card, sides that fit the shared-memory tile (max(P, Q) up to
    14,464 points) take the tiled mode; larger ones the streamed mode, which
    also counts in ``pair_min.stream_launches``."""
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
    fd = torch.empty((C, P), dtype=torch.float32, device=dev)
    fi = torch.empty((C, P), dtype=torch.int32, device=dev)
    bd = torch.empty((C, Q), dtype=torch.float32, device=dev)
    bi = torch.empty((C, Q), dtype=torch.int32, device=dev)
    if C == 0:
        return fd, fi, bd, bi
    streamed = max(P, Q) * 16 > _MAX_SMEM
    keys = torch.empty(C * (P + Q), dtype=torch.int64, device=dev) if streamed else None
    fn = _launcher()
    with torch.cuda.device(dev):
        code = fn(a.data_ptr(), b.data_ptr(), a_mask.data_ptr(), b_mask.data_ptr(),
                  C, P, Q, fd.data_ptr(), fi.data_ptr(), bd.data_ptr(), bi.data_ptr(),
                  None if keys is None else keys.data_ptr(), cuda_build.stream_of(a))
    cuda_build.check(code, "pair_min")
    pair_min.launches += 1
    pair_min.stream_launches += streamed
    return fd, fi, bd, bi


pair_min.launches = 0
pair_min.stream_launches = 0
