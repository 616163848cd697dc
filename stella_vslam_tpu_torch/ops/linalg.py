"""Small SPD solves unrolled into elementwise torch ops.

Port of `solve_spd_unrolled` (stella_vslam_tpu/ops/linalg.py:66) with its
unrolled Cholesky and triangular solves, batched over leading dimensions.
The 6x6 normal equations of the pose optimizer go through it; the kernel
version (csrc/pose_lm.cu) runs the same factorization on one thread.
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
