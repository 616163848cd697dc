"""Essential matrices: the initializer's decomposition and the mapper's E.

Port of `decompose` (stella_vslam_tpu/ops/solve/essential.py:182), on the
host in float64 numpy: one 3x3 SVD per initialization attempt; and of
`create_E_21` (:198), batched torch on the device, for the mapping
module's epipolar matcher. E-RANSAC and the 5-point solver (the
bearing-vector initializer of the other camera models) come with ROADMAP
Queue 1 item 14.
"""
from __future__ import annotations

import numpy as np
import torch

from stella_vslam_tpu_torch.ops import lie


def create_E_21(R_1w: torch.Tensor, t_1w: torch.Tensor, R_2w: torch.Tensor,
                t_2w: torch.Tensor) -> torch.Tensor:
    """E = [t_21]x R_21 from two camera-from-world poses ([..., 3, 3],
    [..., 3]; reference essential_solver::create_E_21)."""
    R_21 = R_2w @ R_1w.transpose(-1, -2)
    t_21 = -(R_21 @ t_1w[..., None])[..., 0] + t_2w
    return lie.hat(t_21) @ R_21


def decompose(E_21: np.ndarray):
    """4 motion hypotheses (R_21, t_21) from E (reference decompose,
    essential_solver.cc:193-219): (R [4,3,3], t [4,3])."""
    U, _, Vt = np.linalg.svd(np.asarray(E_21, np.float64))
    t = U[:, 2] / (np.linalg.norm(U[:, 2]) + 1e-12)
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R1 = -R1 if np.linalg.det(R1) < 0 else R1
    R2 = U @ W.T @ Vt
    R2 = -R2 if np.linalg.det(R2) < 0 else R2
    return np.stack([R1, R1, R2, R2]), np.stack([t, -t, t, -t])
