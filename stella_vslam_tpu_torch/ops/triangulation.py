"""Two-view triangulation as batched torch ops.

Port of `triangulate_midpoint` (stella_vslam_tpu/ops/triangulation.py:51;
reference solve/triangulator.h midpoint overload): elementwise over the N
matched bearing pairs, so it stays plain torch on every device.
"""
from __future__ import annotations

import torch


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
