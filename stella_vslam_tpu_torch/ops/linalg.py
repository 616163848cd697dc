"""Small dense linear algebra as torch ops.

Port of stella_vslam_tpu/ops/linalg.py: `solve_spd_unrolled` (:66) with its
unrolled Cholesky and triangular solves, batched over leading dimensions
(the pose optimizer's 6x6 normal equations; csrc/pose_lm.cu runs the same
factorization on one thread), `solve_spd_blocked` (:72, the plain version
of bundle adjustment's reduced-camera solve), `smallest_eigvec_spd` (:143,
the RANSAC null vector) and `inv3x3` (:174).
"""
from __future__ import annotations

import torch


def cholesky_unrolled(A: torch.Tensor, eps: float = 1e-20):
    """Lower Cholesky factor of SPD [..., D, D] as a list of lists of [...]
    tensors (None above the diagonal)."""
    D = A.shape[-1]
    L = [[None] * D for _ in range(D)]
    for j in range(D):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        s = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = s
        inv = 1.0 / s
        for i in range(j + 1, D):
            v = A[..., i, j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v * inv
    return L


def solve_spd_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve A x = b via the unrolled Cholesky (D <= ~16)."""
    D = A.shape[-1]
    L = cholesky_unrolled(A)
    y = [None] * D
    for i in range(D):
        v = b[..., i]
        for k in range(i):
            v = v - L[i][k] * y[k]
        y[i] = v / L[i][i]
    x = [None] * D
    for i in reversed(range(D)):
        v = y[i]
        for k in range(i + 1, D):
            v = v - L[k][i] * x[k]
        x[i] = v / L[i][i]
    return torch.stack(x, dim=-1)


def solve_lower_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L y = b with lower-triangular L [..., D, D], b [..., D]."""
    D = L.shape[-1]
    y = [None] * D
    for i in range(D):
        v = b[..., i]
        for k in range(i):
            v = v - L[..., i, k] * y[k]
        y[i] = v / L[..., i, i]
    return torch.stack(y, dim=-1)


def solve_upper_from_lower_unrolled(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L^T x = y."""
    D = L.shape[-1]
    x = [None] * D
    for i in reversed(range(D)):
        v = y[..., i]
        for k in range(i + 1, D):
            v = v - L[..., k, i] * x[k]
        x[i] = v / L[..., i, i]
    return torch.stack(x, dim=-1)


def _cholesky_matrix(A: torch.Tensor) -> torch.Tensor:
    """cholesky_unrolled as a dense lower-triangular [..., D, D] tensor."""
    D = A.shape[-1]
    L = cholesky_unrolled(A)
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(D)],
                                    dim=-1) for i in range(D)], dim=-2)


def solve_spd_blocked(S: torch.Tensor, rhs: torch.Tensor, block: int = 8) -> torch.Tensor:
    """SPD solve S x = rhs for one [n,n] system by a blocked right-looking
    Cholesky (port of solve_spd_blocked, stella_vslam_tpu/ops/linalg.py:72):
    n/block steps, each an unrolled block factorization and one trailing
    update. Sizes that are not a multiple of `block` are padded with an
    identity diagonal, which leaves the solution exact. The plain version
    of the reduced-camera solve of bundle adjustment (kernel G)."""
    n0 = S.shape[-1]
    B = block
    pad = (-n0) % B
    if pad:
        S = torch.nn.functional.pad(S, (0, pad, 0, pad))
        idx = torch.arange(n0, n0 + pad, device=S.device)
        S[idx, idx] = 1.0
        rhs = torch.nn.functional.pad(rhs, (0, pad))
    n = n0 + pad
    A = S.clone()
    L = torch.zeros_like(S)
    for r in range(0, n, B):
        Ljj = _cholesky_matrix(A[r:r + B, r:r + B])
        # rows below the block: P = A[:, r:r+B] @ inv(Ljj)^T
        P = solve_lower_unrolled(Ljj, A[r + B:, r:r + B])
        A[r + B:, r + B:] -= P @ P.T
        L[r:r + B, r:r + B] = Ljj
        L[r + B:, r:r + B] = P
    y = torch.zeros_like(rhs)
    for r in range(0, n, B):
        s = L[r:r + B, :r] @ y[:r]
        y[r:r + B] = solve_lower_unrolled(L[r:r + B, r:r + B], rhs[r:r + B] - s)
    x = torch.zeros_like(rhs)
    for r in reversed(range(0, n, B)):
        s = L[r + B:, r:r + B].T @ x[r + B:]
        x[r:r + B] = solve_upper_from_lower_unrolled(L[r:r + B, r:r + B],
                                                     y[r:r + B] - s)
    return x[:n0]


def smallest_eigvec_spd(A: torch.Tensor, num_squarings: int = 18) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of batched symmetric PSD
    [..., D, D] (port of smallest_eigvec_spd, stella_vslam_tpu/ops/linalg.py
    :143): M = (sigma I - A) / sigma with sigma the largest absolute row sum,
    squared num_squarings times with Frobenius renormalisation, then the
    column of largest norm (first on ties), normalised. The RANSAC solvers'
    DLT null vector; kernel E runs the same 18 squarings."""
    D = A.shape[-1]
    sigma = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)[..., None, None]
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    M = (sigma * eye - A) / (sigma + 1e-30)
    for _ in range(num_squarings):
        M = M @ M
        M = M / (torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True)) + 1e-30)
    col = torch.argmax(torch.sum(M * M, dim=-2), dim=-1)
    v = torch.gather(M, -1, col[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant; |det| below
    1e-12 is clamped to 1e-12)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([torch.stack([A11, A12, A13], -1),
                       torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    return adj / det[..., None, None]
