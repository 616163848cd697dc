"""Batched 4-point DLT homography RANSAC + Faugeras decomposition.

Port of stella_vslam_tpu/ops/solve/homography.py: `_normalize` (:31),
`compute_H_21` (:60), `_symmetric_transfer_cost` (:87), `find_via_ransac`
(:137) and `find_via_ransac_escalated` (:152) on kernel E (ops/solve/
ransac.py), and `decompose` (:163), which runs on the host in float64 numpy:
it is one 3x3 SVD per initialization attempt.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.ops.solve import ransac

CHI_SQ_2D = 5.991


class HomographyResult(NamedTuple):
    H_21: torch.Tensor  # [3,3]
    is_inlier: torch.Tensor  # [N] bool
    cost: torch.Tensor  # scalar
    num_inliers: torch.Tensor  # scalar
    valid: torch.Tensor  # scalar bool


def _normalize(pts: torch.Tensor, valid=None):
    """Hartley normalization (mean / mean absolute deviation per axis):
    (normed [..., k, 2], T [..., 3, 3]) with normed_h = T @ pt_h."""
    if valid is None:
        mean = torch.mean(pts, dim=-2, keepdim=True)
        dev = torch.mean(torch.abs(pts - mean), dim=-2, keepdim=True) + 1e-12
    else:
        w = valid[..., None].to(pts.dtype)
        cnt = torch.sum(w, dim=-2, keepdim=True) + 1e-12
        mean = torch.sum(pts * w, dim=-2, keepdim=True) / cnt
        dev = torch.sum(torch.abs(pts - mean) * w, dim=-2, keepdim=True) / cnt + 1e-12
    normed = (pts - mean) / dev
    sx = 1.0 / dev[..., 0, 0]
    sy = 1.0 / dev[..., 0, 1]
    tx = -mean[..., 0, 0] * sx
    ty = -mean[..., 0, 1] * sy
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    T = torch.stack([torch.stack([sx, zeros, tx], -1),
                     torch.stack([zeros, sy, ty], -1),
                     torch.stack([zeros, zeros, ones], -1)], -2)
    return normed, T


def compute_H_21(pts1: torch.Tensor, pts2: torch.Tensor, valid=None) -> torch.Tensor:
    """DLT from [..., k, 2] correspondences (k >= 4) with normalization;
    rows where `valid` is false contribute no equation."""
    n1, T1 = _normalize(pts1, valid)
    n2, T2 = _normalize(pts2, valid)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    zeros, ones = torch.zeros_like(x1), torch.ones_like(x1)
    rows_a = torch.stack([zeros, zeros, zeros, -x1, -y1, -ones,
                          y2 * x1, y2 * y1, y2], -1)
    rows_b = torch.stack([x1, y1, ones, zeros, zeros, zeros,
                          -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([rows_a, rows_b], dim=-2)  # [..., 2k, 9]
    if valid is not None:
        A = A * torch.cat([valid, valid], dim=-1)[..., None].to(A.dtype)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    h = linalg.smallest_eigvec_spd(AtA)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    return torch.linalg.inv(T2) @ Hn @ T1


def _adj_inverse(H: torch.Tensor) -> torch.Tensor:
    """3x3 inverse by adjugate / determinant (no clamping: a singular
    hypothesis scores non-finite distances, which count as outliers)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack([torch.stack([A11, A12, A13], -1),
                       torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    return adj / det[..., None, None]


def _transfer(H, p):
    x = H[..., 0, 0, None] * p[..., 0] + H[..., 0, 1, None] * p[..., 1] + H[..., 0, 2, None]
    y = H[..., 1, 0, None] * p[..., 0] + H[..., 1, 1, None] * p[..., 1] + H[..., 1, 2, None]
    w = H[..., 2, 0, None] * p[..., 0] + H[..., 2, 1, None] * p[..., 1] + H[..., 2, 2, None]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return x / w, y / w


def _symmetric_transfer_cost(H_21, pts1, pts2, sigma: float):
    """[..., N] (inlier, capped cost) of the symmetric transfer error
    (reference homography_solver::check_inliers); H_21 [..., 3, 3] against
    points [..., N, 2]."""
    H_12 = _adj_inverse(H_21)
    u, v = _transfer(H_21, pts1)
    d1 = (u - pts2[..., 0]) ** 2 + (v - pts2[..., 1]) ** 2
    u, v = _transfer(H_12, pts2)
    d2 = (u - pts1[..., 0]) ** 2 + (v - pts1[..., 1]) ** 2
    dist_sq = torch.maximum(d1, d2)
    thr = CHI_SQ_2D * sigma * sigma
    inlier = dist_sq < thr
    return inlier, torch.where(inlier, dist_sq, torch.full_like(dist_sq, thr))


MODEL = ransac.TwoViewModel(kind=0, set_size=4, compute=compute_H_21,
                            cost=_symmetric_transfer_cost)


def find_via_ransac(seed: int, pts1, pts2, match_valid, *,
                    num_hypotheses: int = 256, sigma: float = 1.0,
                    recompute: bool = True) -> HomographyResult:
    return HomographyResult(*ransac.find_core(
        MODEL, seed, pts1, pts2, match_valid, num_hypotheses, sigma,
        1 if recompute else 0))


def find_via_ransac_escalated(seeds: Sequence[int], pts1, pts2, match_valid, *,
                              num_hypotheses: int = 4096, sigma: float = 1.0,
                              lo_rounds: int = 3) -> HomographyResult:
    """Low-inlier fallback: one chunk of `num_hypotheses` per seed (8 in the
    JAX version) with LO refits, the chunk with the most inliers kept."""
    return HomographyResult(*ransac.escalate(
        lambda s: ransac.find_core(MODEL, s, pts1, pts2, match_valid,
                                   num_hypotheses, sigma, lo_rounds), seeds))


def decompose(H_21: np.ndarray):
    """Faugeras SVD decomposition into 8 motion hypotheses (reference
    homography_solver::decompose), float64 numpy: (R [8,3,3], t [8,3],
    n [8,3], valid [8])."""
    U, S, Vt = np.linalg.svd(np.asarray(H_21, np.float64))
    d1, d2, d3 = S
    s = np.linalg.det(U) * np.linalg.det(Vt)
    ok = (d1 / max(d2, 1e-12) > 1.0001) and (d2 / max(d3, 1e-12) > 1.0001)
    den13 = max(d1 * d1 - d3 * d3, 1e-12)
    aux1 = np.sqrt(max((d1 * d1 - d2 * d2) / den13, 0.0))
    aux3 = np.sqrt(max((d2 * d2 - d3 * d3) / den13, 0.0))
    prod = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    aux_sin = prod / max((d1 + d3) * d2, 1e-12)
    cos_theta = (d2 * d2 + d1 * d3) / max((d1 + d3) * d2, 1e-12)
    aux_sin_p = prod / max((d1 - d3) * d2, 1e-12)
    cos_phi = (d1 * d3 - d2 * d2) / max((d1 - d3) * d2, 1e-12)
    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e2 in (1.0, -1.0):
            st = e1 * e2 * aux_sin
            Rp = np.array([[cos_theta, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, cos_theta]])
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ (np.array([e1 * aux1, 0.0, -e2 * aux3]) * (d1 - d3)))
            ns.append(Vt.T @ np.array([e1 * aux1, 0.0, e2 * aux3]))
    for e1 in (1.0, -1.0):
        for e2 in (1.0, -1.0):
            sp = e1 * e2 * aux_sin_p
            Rp = np.array([[cos_phi, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cos_phi]])
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ (np.array([e1 * aux1, 0.0, e2 * aux3]) * (d1 + d3)))
            ns.append(Vt.T @ np.array([e1 * aux1, 0.0, e2 * aux3]))
    t = np.stack(ts)
    t = t / (np.linalg.norm(t, axis=-1, keepdims=True) + 1e-12)
    return np.stack(Rs), t, np.stack(ns), np.full(8, ok)
