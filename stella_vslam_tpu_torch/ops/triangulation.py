"""Two-view triangulation as batched torch ops.

Port of `triangulate_dlt` (stella_vslam_tpu/ops/triangulation.py:15) and
`triangulate_midpoint` (:51; reference solve/triangulator.h): elementwise
over the N matched bearing pairs. The mapping module's DLT runs inside
kernel K on the card (csrc/triangulate.cu); `triangulate_dlt` here is its
plain version, and the initializer's midpoint stays plain torch on every
device.
"""
from __future__ import annotations

import torch

from stella_vslam_tpu_torch.ops.linalg import inv3x3


def triangulate_dlt(b1: torch.Tensor, b2: torch.Tensor, P1: torch.Tensor,
                    P2: torch.Tensor) -> torch.Tensor:
    """World points [..., N, 3] from bearings [..., N, 3] in two cameras
    with poses P = [R | t] ([..., 3, 4], camera <- world): the DLT rows
    x P[2] - z P[0] and y P[2] - z P[1], each normalised, then the
    inhomogeneous 3x3 normal equations B^T B X = -B^T c with a 1e-9 ridge,
    solved by the adjugate inverse. Every sum runs left to right, as
    kernel K's do."""
    def rows(b, P):
        p0, p1, p2 = P[..., None, 0, :], P[..., None, 1, :], P[..., None, 2, :]
        return (b[..., 0:1] * p2 - b[..., 2:3] * p0,
                b[..., 1:2] * p2 - b[..., 2:3] * p1)

    A = [*rows(b1, P1), *rows(b2, P2)]  # 4 rows of [..., N, 4]
    A = [r / (torch.sqrt(r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]
                         + r[..., 2] * r[..., 2] + r[..., 3] * r[..., 3]) + 1e-12)[..., None]
         for r in A]
    dot = lambda i, j: A[0][..., i] * A[0][..., j] + A[1][..., i] * A[1][..., j] \
        + A[2][..., i] * A[2][..., j] + A[3][..., i] * A[3][..., j]
    BtB = torch.stack([torch.stack([dot(i, j) for j in range(3)], -1) for i in range(3)], -2)
    Btc = [dot(i, 3) for i in range(3)]
    inv = inv3x3(BtB + torch.eye(3, dtype=BtB.dtype, device=BtB.device) * 1e-9)
    return -torch.stack([inv[..., i, 0] * Btc[0] + inv[..., i, 1] * Btc[1]
                         + inv[..., i, 2] * Btc[2] for i in range(3)], -1)


def triangulate_midpoint(b1: torch.Tensor, b2: torch.Tensor, R_21: torch.Tensor,
                         t_21: torch.Tensor) -> torch.Tensor:
    """Midpoint of the closest points of the rays p = s1 b1 (cam 1) and
    p = R_12 (s2 b2) + t_12; [..., N, 3] bearings, R_21 / t_21 cam2 <- cam1
    ([..., 3, 3], [..., 3]). Returns points in the cam-1 frame [..., N, 3]."""
    R_12 = R_21.transpose(-1, -2)
    t_12 = -(R_12 @ t_21[..., None])[..., 0]
    d1 = b1
    d2 = b2 @ R_21  # (R_12 b2) as rows
    o2 = t_12[..., None, :]
    a11 = torch.sum(d1 * d1, dim=-1)
    a12 = -torch.sum(d1 * d2, dim=-1)
    a22 = torch.sum(d2 * d2, dim=-1)
    c1 = torch.sum(d1 * o2, dim=-1)
    c2 = -torch.sum(d2 * o2, dim=-1)
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    s1 = (a22 * c1 - a12 * c2) / det
    s2 = (a11 * c2 - a12 * c1) / det
    return 0.5 * (s1[..., None] * d1 + o2 + s2[..., None] * d2)
