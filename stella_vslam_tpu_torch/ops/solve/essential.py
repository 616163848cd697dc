"""Essential matrices: E-RANSAC on bearings, the initializer's
decomposition and the mapper's E.

Port of stella_vslam_tpu/ops/solve/essential.py: `compute_E_21` (:46, the
8-point linear solve on bearing pairs through the 18-squaring null vector),
`_angular_cost` (:65, the sine of each bearing's angle to its epipolar
plane in both views, inlier above cos(1 deg)), `find_via_ransac` (:113),
`find_via_ransac_escalated` (:129) and `find_via_ransac_5pt` (:144), on
kernel E's MODEL 2 (ops/solve/ransac.py) and, for the 5-point sets, kernel
U (ops/solve/essential_5pt.py); `decompose` (:182), on the host in float64
numpy: one 3x3 SVD per initialization attempt; and `create_E_21` (:198),
batched torch on the device, for the mapping module's epipolar matcher.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from stella_vslam_tpu_torch.ops import lie, linalg
from stella_vslam_tpu_torch.ops.solve import essential_5pt, ransac
from stella_vslam_tpu_torch.ops.solve.homography import normal_matrix

COS_ANGLE_THR = math.cos(math.pi / 180.0)


class EssentialResult(NamedTuple):
    E_21: torch.Tensor
    is_inlier: torch.Tensor
    cost: torch.Tensor
    num_inliers: torch.Tensor
    valid: torch.Tensor


def compute_E_21(b1: torch.Tensor, b2: torch.Tensor, valid=None) -> torch.Tensor:
    """8-point linear solve on bearing pairs [..., k, 3] (rows
    [b2.x b1, b2.y b1, b2.z b1], so that b2^T E b1 = 0), batched."""
    A = torch.cat([b2[..., 0:1] * b1, b2[..., 1:2] * b1, b2[..., 2:3] * b1], dim=-1)
    if valid is not None:
        A = A * valid[..., None].to(A.dtype)
    e = linalg.smallest_eigvec_spd_in_order(normal_matrix(A, valid is None))
    return e.reshape(e.shape[:-1] + (3, 3))


def _angular_cost(E_21, b1, b2):
    """[..., N] (inlier, capped cost) of E_21 [..., 3, 3] against bearings
    [..., N, 3]: the sine of the angle between each bearing and its epipolar
    plane, the worse of the two views."""
    ep2 = torch.einsum("...ij,...nj->...ni", E_21, b1)
    ep1 = torch.einsum("...ji,...nj->...ni", E_21, b2)
    cos_in_2 = torch.linalg.norm(torch.linalg.cross(ep2, b2.expand_as(ep2)), dim=-1) / (
        torch.linalg.norm(ep2, dim=-1) + 1e-12)
    cos_in_1 = torch.linalg.norm(torch.linalg.cross(ep1, b1.expand_as(ep1)), dim=-1) / (
        torch.linalg.norm(ep1, dim=-1) + 1e-12)
    worst = torch.minimum(cos_in_1, cos_in_2)
    inlier = worst > COS_ANGLE_THR
    return inlier, torch.where(inlier, 1.0 - worst, torch.full_like(worst, 1.0 - COS_ANGLE_THR))


# kernel E's MODEL 2: 8-point sets (the 5-point candidates' selection gates
# at more than 5 inliers)
MODEL = ransac.TwoViewModel(kind=2, set_size=8, compute=compute_E_21,
                            cost=lambda E, b1, b2, sigma: _angular_cost(E, b1, b2))


def find_via_ransac(seed: int, b1, b2, match_valid, *, num_hypotheses: int = 256,
                    recompute: bool = True) -> EssentialResult:
    """8-point E-RANSAC over `num_hypotheses` hashed sets, one LO refit when
    `recompute`."""
    return EssentialResult(*ransac.find_core(MODEL, seed, b1, b2, match_valid,
                                             num_hypotheses, 1.0, 1 if recompute else 0))


def find_via_ransac_escalated(seeds: Sequence[int], b1, b2, match_valid, *,
                              num_hypotheses: int = 4096,
                              lo_rounds: int = 3) -> EssentialResult:
    """Low-inlier fallback: one chunk of `num_hypotheses` sets per seed,
    each with `lo_rounds` LO refits; the valid result with the most inliers
    (ransac.find_escalated)."""
    return EssentialResult(*ransac.find_escalated(MODEL, seeds, b1, b2, match_valid,
                                                  num_hypotheses, 1.0, lo_rounds))


def find_via_ransac_5pt(seed: int, b1, b2, match_valid, *, num_hypotheses: int = 512,
                        lo_rounds: int = 2) -> EssentialResult:
    """RANSAC over true 5-point sets (kernel U): up to 10 candidates per set,
    all scored on every match (kernel E), the lowest cost among those with
    more than 5 inliers, then `lo_rounds` 8-point LO refits on its
    consensus."""
    _, E, ok = essential_5pt.solve_sampled_sets(seed, b1, b2, match_valid, num_hypotheses)
    Ef = E.reshape(-1, 3, 3)
    cost, count = ransac.score_models(MODEL, Ef, ok.reshape(-1), b1, b2, match_valid,
                                      1.0 - COS_ANGLE_THR)
    return EssentialResult(*ransac.finish_core(MODEL, Ef, cost, count, b1, b2, match_valid,
                                               lo_rounds=lo_rounds, min_inliers=5))


def create_E_21(R_1w: torch.Tensor, t_1w: torch.Tensor, R_2w: torch.Tensor,
                t_2w: torch.Tensor) -> torch.Tensor:
    """E = [t_21]x R_21 from two camera-from-world poses ([..., 3, 3],
    [..., 3]; reference essential_solver::create_E_21)."""
    R_21 = R_2w @ R_1w.transpose(-1, -2)
    t_21 = -(R_21 @ t_1w[..., None])[..., 0] + t_2w
    return lie.hat(t_21) @ R_21


def decompose_f64(E_21: np.ndarray):
    """decompose in float64 numpy, the bearing-vector initializer's: in the
    JAX version's float32 rounding the equirectangular leg's init bundle
    adjustment lands where kernel H's accept decision parts from its plain
    version's (ROADMAP Queue 3)."""
    U, _, Vt = np.linalg.svd(np.asarray(E_21, np.float64))
    t = U[:, 2] / (np.linalg.norm(U[:, 2]) + 1e-12)
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R1 = -R1 if np.linalg.det(R1) < 0 else R1
    R2 = U @ W.T @ Vt
    R2 = -R2 if np.linalg.det(R2) < 0 else R2
    return np.stack([R1, R1, R2, R2]), np.stack([t, -t, t, -t])


def decompose(E_21: torch.Tensor):
    """4 motion hypotheses (R_21, t_21) from a float32 E [3,3] (reference
    decompose, essential_solver.cc:193-219): (R [4,3,3], t [4,3]) float32 on
    the host, rounded as the JAX version's eager ops on the CPU: LAPACK's
    sgesdd, t's norm an FMA chain with a correctly rounded root, U W Vt two
    FMA-chain products."""
    E = torch.as_tensor(E_21, dtype=torch.float32).cpu()
    U, _, Vt = linalg.svd3_lapack(E)
    t = U[:, 2]
    t = t / (linalg.sqrt_f32(linalg.dot_in_order(t, t, 0)) + 1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    Rs = []
    for Wk in (W, W.T):
        R = linalg.matmul_f32(linalg.matmul_f32(U, Wk), Vt)
        Rs.append(-R if float(torch.linalg.det(R.double())) < 0 else R)
    return torch.stack([Rs[0], Rs[0], Rs[1], Rs[1]]), torch.stack([t, -t, t, -t])
