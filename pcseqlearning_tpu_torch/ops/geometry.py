"""Batched closed-form 3x3 symmetric eigensolver, Newton-refined Procrustes
rotation and rigid-transform helpers (counterpart of
pcseqlearning_tpu.ops.geometry).

Every product here is 3x3, so it is written out as broadcast sums in full
float32 (no matrix-multiply library call, no TF32).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def sqrt_rn(x):
    """Square root rounded to nearest on every device. The card's float32
    sqrt is; torch's CPU float32 sqrt can be one ulp off (17% of uniform
    inputs in [0, 100) on an AMD EPYC, torch 2.13), so float32 goes through
    float64, whose rounding back to float32 is then exact."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def mm(A, B):
    """Batched [..., i, j] x [..., j, k] -> [..., i, k] by broadcast sums."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def mv(A, v):
    """Batched [..., i, j] x [..., j] -> [..., i]."""
    return (A * v[..., None, :]).sum(-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _normalize(v, eps=_EPS):
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=eps)), n2[..., 0]


def _any_orthonormal(u):
    """A unit vector orthogonal to unit vector u (batched)."""
    m = torch.argmin(u.abs(), dim=-1)
    e = torch.nn.functional.one_hot(m, 3).to(u.dtype)
    v, _ = _normalize(_cross(u, e))
    return v


def _eye_like(A):
    return torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)


def eigh3x3(A):
    """Eigendecomposition of symmetric 3x3 matrices (batched).

    Returns (eigvals [..., 3] ascending, eigvecs [..., 3, 3] with COLUMNS as
    eigenvectors), the torch.linalg.eigh convention."""
    A = 0.5 * (A + A.transpose(-1, -2))
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (a01 * a01 + a02 * a02 + a12 * a12) / 3.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    scale = torch.maximum(q.abs(), p)
    iso = p <= 1e-7 * torch.clamp(scale, min=1e-30)

    p_safe = torch.where(iso, torch.ones_like(p), p)
    c00, c11, c22 = b00 / p_safe, b11 / p_safe, b22 / p_safe
    c01, c02, c12 = a01 / p_safe, a02 / p_safe, a12 / p_safe
    detB = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + two_pi_3)
    lam0 = torch.where(iso, q, lam0)
    lam2 = torch.where(iso, q, lam2)

    eye = _eye_like(A)

    def eigvec_of(lam):
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        cs = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
        ns = (cs * cs).sum(-1)
        best = torch.argmax(ns, dim=-1)
        v = torch.gather(cs, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
        nbest = ns.max(dim=-1).values
        v, _ = _normalize(v)
        m2 = (M * M).sum((-1, -2))
        degen = nbest <= 1e-12 * torch.clamp(m2 * m2, min=1e-30)
        return v, degen

    v2, d2 = eigvec_of(lam2)
    ez = torch.zeros_like(v2)
    ez[..., 2] = 1.0
    v2 = torch.where((iso | d2)[..., None], ez, v2)

    v0, d0 = eigvec_of(lam0)
    v0 = v0 - (v0 * v2).sum(-1, keepdim=True) * v2
    v0n, n0 = _normalize(v0)
    bad0 = iso | d0 | (n0 <= 1e-12)
    v0 = torch.where(bad0[..., None], _any_orthonormal(v2), v0n)

    v1, _ = _normalize(_cross(v2, v0))

    vecs = torch.stack([v0, v1, v2], dim=-1)  # columns
    # Rayleigh-quotient refinement of the Cardano roots
    Av = mm(A, vecs)
    vals = (vecs * Av).sum(-2)
    vals = torch.sort(vals, dim=-1).values
    return vals, vecs


def _solve3x3(A, b, eps=1e-20):
    """Batched 3x3 solve by the adjugate; near-singular systems return 0."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    adjT = torch.stack(
        [
            torch.stack([c00, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11], dim=-1),
            torch.stack([c01, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12], dim=-1),
            torch.stack([c02, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10], dim=-1),
        ],
        dim=-2,
    )
    x = mv(adjT, b)
    safe = det.abs() > eps
    return torch.where(safe[..., None], x / torch.where(safe, det, torch.ones_like(det))[..., None],
                       torch.zeros_like(x))


def _exp_so3(w):
    """Batched Rodrigues: [..., 3] axis-angle -> [..., 3, 3]."""
    th2 = (w * w).sum(-1, keepdim=True)
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    small = th2[..., 0] < 1e-12
    k = w / th
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = torch.zeros_like(kx)
    K = torch.stack(
        [
            torch.stack([zeros, -kz, ky], dim=-1),
            torch.stack([kz, zeros, -kx], dim=-1),
            torch.stack([-ky, kx, zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = _eye_like(K)
    R = eye + torch.sin(th)[..., None] * K + (1.0 - torch.cos(th))[..., None] * mm(K, K)
    return torch.where(small[..., None, None], eye, R)


def _newton_refine_rotation(R, M, steps=2):
    """Newton steps on SO(3) maximizing tr(R^T M)."""
    for _ in range(steps):
        S = mm(R.transpose(-1, -2), M)
        a = torch.stack(
            [S[..., 2, 1] - S[..., 1, 2], S[..., 0, 2] - S[..., 2, 0], S[..., 1, 0] - S[..., 0, 1]],
            dim=-1,
        )
        H = 0.5 * (S + S.transpose(-1, -2))
        tr = H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]
        A = tr[..., None, None] * _eye_like(H) - H
        R = mm(R, _exp_so3(_solve3x3(A, a)))
    return R


def procrustes_rotation(M, eps=1e-9):
    """Proper rotation R maximizing tr(R^T M) (Kabsch/Procrustes), built from
    eigh3x3(M^T M) with rank-deficiency fallbacks and two Newton steps."""
    d, V = eigh3x3(mm(M.transpose(-1, -2), M))
    v1, v2 = V[..., 1], V[..., 2]
    v0, _ = _normalize(_cross(v1, v2))

    u2, s2 = _normalize(mv(M, v2), eps)
    tiny = s2 <= eps

    u1 = mv(M, v1)
    u1 = u1 - (u1 * u2).sum(-1, keepdim=True) * u2
    u1n, s1 = _normalize(u1, eps)
    u1 = torch.where((s1 <= eps)[..., None], _any_orthonormal(u2), u1n)

    u0 = _cross(u1, u2)

    R = (u0[..., :, None] * v0[..., None, :] + u1[..., :, None] * v1[..., None, :]
         + u2[..., :, None] * v2[..., None, :])
    R = _newton_refine_rotation(R, M, steps=2)
    return torch.where(tiny[..., None, None], _eye_like(R), R)


def make_rigid(R, t):
    """[..., 4, 4] homogeneous transforms from R [..., 3, 3] and t [..., 3]."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def apply_rigid(T, xyz):
    """Apply [..., 4, 4] transforms to [..., 3] points."""
    return mv(T[..., :3, :3], xyz) + T[..., :3, 3]
