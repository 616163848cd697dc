"""Small dense linear algebra as torch ops.

Port of stella_vslam_tpu/ops/linalg.py: `solve_spd_unrolled` (:66) with its
unrolled Cholesky and triangular solves, batched over leading dimensions
(the pose optimizer's 6x6 normal equations; csrc/pose_lm.cu runs the same
factorization on one thread), `solve_spd_blocked` (:72, the plain version
of bundle adjustment's reduced-camera solve and of `spd_solve`),
`smallest_eigvec_spd` (:143, the RANSAC null vector) and `inv3x3` (:174).
`spd_solve` is the dense SPD solve on the card: kernel G's tiled Cholesky
(csrc/ba_schur.cu svt_spd_solve), the pose graph's 7K x 7K solve.

`sum_in_order`, `sum_windowed`, `dot_in_order`, `matmul_f32` and
`svd3_lapack` round as the JAX version's jitted programs do on the CPU (read
from XLA's optimized HLO and the bits): a short reduction is a loop that
adds in index order from 0, a long one sums windows of 32, then windows of
their partials,
a reduction of a product an FMA chain, a small dot (and a float32 matmul on
the CPU) an FMA chain over k, and jnp.linalg.svd LAPACK's sgesdd, which
jaxlib calls through scipy. Written as explicit chains, they give the same
bits on the CPU and on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import round_sum_f32
from stella_vslam_tpu_torch.kernels import build as kbuild

# kernel G's routes (csrc/ba_schur.cu): up to this n one block or a cluster
# holds the tiles in shared memory; above, a device-memory scratch does
SOLVE_CLUSTER_DIM = 768
_TILE_FLOATS = 32 * 33  # one 32 x 32 tile with its row stride of 33


def solve_scratch_floats(n: int) -> int:
    """Floats of device scratch kernel G needs for an n x n system: the
    lower triangle's tiles of the padded system (the right-hand side as row
    n, so ceil((n + 1) / 32) tiles a side) and the factored diagonal tiles;
    0 where the system stays in shared memory (n <= SOLVE_CLUSTER_DIM)."""
    if n <= SOLVE_CLUSTER_DIM:
        return 0
    nt = (n + 32) // 32
    return (nt * (nt + 1) // 2 + nt) * _TILE_FLOATS


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


def _check_spd_args(A: torch.Tensor, b: torch.Tensor) -> int:
    n = A.shape[-1] if A.dim() else 0
    if A.dim() != 2 or A.shape[0] != n or n < 1 or tuple(b.shape) != (n,) \
            or A.dtype != torch.float32 or b.dtype != torch.float32 \
            or b.device != A.device or not A.is_contiguous() or not b.is_contiguous():
        raise ValueError(f"spd_solve: A must be a contiguous float32 [n, n] tensor and b a "
                         f"contiguous float32 [n] tensor on A's device (A {tuple(A.shape)} "
                         f"{A.dtype} on {A.device}, b {tuple(b.shape)} {b.dtype} on {b.device})")
    return n


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for a symmetric positive definite A [n, n] (its lower
    triangle is read): kernel G's tiled Cholesky on CUDA tensors, with the
    system padded to its 32-wide panels by an identity diagonal on the card;
    solve_spd_blocked, the plain version, on CPU tensors."""
    n = _check_spd_args(A, b)
    if not A.is_cuda:
        return solve_spd_blocked(A, b)
    x = torch.empty(n, dtype=torch.float32, device=A.device)
    floats = solve_scratch_floats(n)
    scratch = torch.empty(floats, dtype=torch.float32, device=A.device) if floats else None
    lib = kbuild.load()
    with torch.cuda.device(A.device):
        kbuild.check(lib.svt_spd_solve(
            n, A.data_ptr(), b.data_ptr(), x.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), floats,
            kbuild.stream_ptr(A.device)), "spd_solve")
    spd_solve.launches += 1
    return x


spd_solve.launches = 0


def sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim` from 0 in index order, each addition rounded
    (XLA's CPU loop for a reduction of a few dozen elements)."""
    x = x.movedim(dim, 0)
    acc = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


XLA_WINDOW = 32


def sum_windowed(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim` as XLA's CPU program splits a long reduction (its
    optimized HLO): while more than 32 values remain, they are padded with
    zeros to a multiple of 32, floor(P / 2) before and ceil(P / 2) after,
    and each window of 32 is summed in order from 0 (a reduce-window); the
    32 or fewer partials left are summed in order from 0."""
    x = x.movedim(dim, 0)
    while x.shape[0] > XLA_WINDOW:
        n = x.shape[0]
        pad = -n % XLA_WINDOW
        lo, hi = pad // 2, pad - pad // 2
        z = lambda k: torch.zeros((k,) + x.shape[1:], dtype=x.dtype, device=x.device)
        x = torch.cat([z(lo), x, z(hi)]).reshape((n + pad) // XLA_WINDOW, XLA_WINDOW,
                                                   *x.shape[1:])
        x = sum_in_order(x, 1)
    return sum_in_order(x, 0)


def dot_in_order(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """sum(a * b) over `dim` of float32 tensors as an FMA chain from 0 in
    index order, each step rounded once (XLA's CPU reduction of a fused
    product)."""
    p = (a.double() * b.double()).movedim(dim, 0)
    acc = torch.zeros(p.shape[1:], dtype=torch.float32, device=p.device)
    for k in range(p.shape[0]):
        acc = round_sum_f32(p[k], acc)
    return acc


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for float32 [..., m, k] and [..., k, n] as XLA's CPU dot of
    small matrices (and a float32 matmul on the CPU) rounds it: each entry
    a_i0 b_0j, then + a_ik b_kj in k order, each step one FMA."""
    A, B = a.double(), b.double()
    acc = (A[..., :, 0, None] * B[..., None, 0, :]).float()
    for k in range(1, a.shape[-1]):
        acc = round_sum_f32(A[..., :, k, None] * B[..., None, k, :], acc)
    return acc


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 root (torch's float32 sqrt on the CPU is
    not, on some inputs)."""
    return torch.sqrt(x.double()).float()


def svd3_lapack(F: torch.Tensor):
    """(U, S, Vt) of float32 [..., 3, 3] as the JAX version's
    jnp.linalg.svd computes them on the CPU: LAPACK's sgesdd (jaxlib binds
    scipy's LAPACK), matrix by matrix on the host; NaN where it fails, as
    jaxlib fills them."""
    from scipy.linalg import lapack

    f = F.detach().cpu().numpy().reshape(-1, 3, 3)
    U = np.full_like(f, np.nan)
    S = np.full(f.shape[:-1], np.nan, np.float32)
    Vt = np.full_like(f, np.nan)
    for b in range(f.shape[0]):
        u, s, vt, info = lapack.sgesdd(f[b], compute_uv=1, full_matrices=1)
        if info == 0:
            U[b], S[b], Vt[b] = u, s, vt
    t = lambda a, shape: torch.from_numpy(a).reshape(shape).to(F.device)
    return t(U, F.shape), t(S, F.shape[:-1]), t(Vt, F.shape)


def smallest_eigvec_spd(A: torch.Tensor, num_squarings: int = 18) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of batched symmetric PSD
    [..., D, D] (port of smallest_eigvec_spd, stella_vslam_tpu/ops/linalg.py
    :143): M = (sigma I - A) / sigma with sigma the largest absolute row sum,
    squared num_squarings times with Frobenius renormalisation, then the
    column of largest norm (first on ties), normalised. PnP's DLT null
    vector, in torch's rounding; the two-view fits take
    smallest_eigvec_spd_in_order."""
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


def smallest_eigvec_spd_in_order(A: torch.Tensor, num_squarings: int = 18) -> torch.Tensor:
    """smallest_eigvec_spd rounded as the JAX version's jitted program: the
    row sums in order, each square an FMA chain (matmul_f32), the squared
    norms FMA chains in order, the roots correctly rounded, the divisions
    true. The two-view RANSAC fits' null vector (their plain versions;
    kernel E runs the same chains); each step is a few torch operations per
    element of a chain, so it is for the CPU and for checks on the card."""
    D = A.shape[-1]
    sigma = torch.amax(sum_in_order(torch.abs(A), -1), dim=-1)[..., None, None]
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    M = (sigma * eye - A) / (sigma + 1e-30)
    for _ in range(num_squarings):
        M = matmul_f32(M, M)
        flat = M.reshape(M.shape[:-2] + (D * D,))
        M = M / (sqrt_f32(dot_in_order(flat, flat, -1)) + 1e-30)[..., None, None]
    col = torch.argmax(dot_in_order(M, M, -2), dim=-1)
    v = torch.gather(M, -1, col[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
    return v / (sqrt_f32(dot_in_order(v, v, -1))[..., None] + 1e-12)


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
