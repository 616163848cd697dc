"""Batched 8-point fundamental-matrix RANSAC.

Port of stella_vslam_tpu/ops/solve/fundamental.py: `compute_F_21` (:32)
with the rank-2 projection, `_epipolar_cost` (:54), and `find_via_ransac`
(:102) / `find_via_ransac_escalated` (:117) on kernel E (ops/solve/
ransac.py).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from stella_vslam_tpu_torch.camera.base import _fma_f32
from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.ops.solve import ransac
from stella_vslam_tpu_torch.ops.solve.homography import _normalize, normal_matrix

CHI_SQ = 5.991


class FundamentalResult(NamedTuple):
    F_21: torch.Tensor
    is_inlier: torch.Tensor
    cost: torch.Tensor
    num_inliers: torch.Tensor
    valid: torch.Tensor


def dlt_rows(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """The 8-point DLT rows [..., k, 9] of normalized pairs [..., k, 2]."""
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], -1)


def null_vector_F(pts1: torch.Tensor, pts2: torch.Tensor, valid=None):
    """The normalized 8-point null vector before the rank-2 step, batched
    over [..., k, 2] pairs: (Fn [..., 3, 3] in normalized coordinates, T1,
    T2), with F = T2^T rank2(Fn) T1."""
    n1, T1 = _normalize(pts1, valid)
    n2, T2 = _normalize(pts2, valid)
    A = dlt_rows(n1, n2)
    if valid is not None:
        A = A * valid[..., None].to(A.dtype)
    f = linalg.smallest_eigvec_spd_in_order(normal_matrix(A, valid is None))
    return f.reshape(f.shape[:-1] + (3, 3)), T1, T2


def compute_F_21(pts1: torch.Tensor, pts2: torch.Tensor, valid=None) -> torch.Tensor:
    """Normalized 8-point algorithm on [..., k, 2] pairs, batched, with the
    rank-2 projection (smallest singular value set to 0) by LAPACK's sgesdd
    and the products as FMA chains, as the JAX version's jitted program
    computes them on the CPU."""
    Fn, T1, T2 = null_vector_F(pts1, pts2, valid)
    U, S, Vt = linalg.svd3_lapack(Fn)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fn = linalg.matmul_f32(U, S[..., :, None] * Vt)
    return linalg.matmul_f32(linalg.matmul_f32(T2.transpose(-1, -2), Fn), T1)


def _epipolar_cost(F_21, pts1, pts2, sigma: float):
    """[..., N] (inlier, capped cost) of the symmetric point-to-epiline
    distance (reference fundamental_solver::check_inliers); F_21
    [..., 3, 3] against points [..., N, 2]. Rounded as the JAX version's
    jitted einsums: each epiline entry fma(F_i1, y, F_i0 x) + F_i2, the
    point's residual fma(y', l_1, x' l_0) + l_2, the denominator fma(l_0,
    l_0, l_1 l_1) + 1e-12."""
    F = lambda i, j: F_21[..., i, j, None]
    fma = _fma_f32
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    # epiline of p1 in image 2 (F p1) and of p2 in image 1 (F^T p2)
    l2 = [fma(F(i, 1), y1, F(i, 0) * x1) + F(i, 2) for i in range(3)]
    l1 = [fma(F(1, j), y2, F(0, j) * x2) + F(2, j) for j in range(3)]

    def dist(x, y, l):
        e = fma(y, l[1], x * l[0]) + l[2]
        return e * e / (fma(l[0], l[0], l[1] * l[1]) + 1e-12)
    dist_sq = torch.maximum(dist(x1, y1, l1), dist(x2, y2, l2))
    thr = CHI_SQ * sigma * sigma
    inlier = dist_sq < thr
    return inlier, torch.where(inlier, dist_sq, torch.full_like(dist_sq, thr))


MODEL = ransac.TwoViewModel(kind=1, set_size=8, compute=compute_F_21,
                            cost=_epipolar_cost)


def find_via_ransac(seed: int, pts1, pts2, match_valid, *,
                    num_hypotheses: int = 256, sigma: float = 1.0,
                    recompute: bool = True) -> FundamentalResult:
    return FundamentalResult(*ransac.find_core(
        MODEL, seed, pts1, pts2, match_valid, num_hypotheses, sigma,
        1 if recompute else 0))


def find_via_ransac_escalated(seeds: Sequence[int], pts1, pts2, match_valid, *,
                              num_hypotheses: int = 4096, sigma: float = 1.0,
                              lo_rounds: int = 3) -> FundamentalResult:
    """Low-inlier fallback: one chunk per seed with LO refits (see
    ransac.find_escalated)."""
    return FundamentalResult(*ransac.find_escalated(
        MODEL, seeds, pts1, pts2, match_valid, num_hypotheses, sigma, lo_rounds))
