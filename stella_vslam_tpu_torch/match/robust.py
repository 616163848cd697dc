"""Robust matching: brute force on kernel C, epipolar on kernel J.

Port of `brute_force_match` (stella_vslam_tpu/match/robust.py:92), the
keyframe fallback of the tracking cascade: for each keyframe landmark
observation, the best frame keypoint under the orientation gate, Lowe ratio
and HAMMING_DIST_THR_LOW; and of `match_for_triangulation` (:22), the
mapping module's matcher, batched over the neighbour keyframes.
"""
from __future__ import annotations

import math

import torch

from stella_vslam_tpu_torch.match import hamming as H

# cos(3 deg): epipole proximity rejection (robust.cc:96 cos_dist_thr)
_COS_EPIPOLE_THR = 0.99862953475
# match_for_triangulation's epipolar residual threshold at level 0 and its
# Lowe ratio, the values its only caller, the mapping module, uses
_RESIDUAL_RAD_THR = 0.2 * math.pi / 180.0
_TRI_LOWE_RATIO = 0.75


def cos_30deg() -> float:
    """cos(30 deg) in f32, the orientation gate's threshold (computed on
    the host: a device scalar would cost every caller a read back)."""
    return float(torch.cos(torch.deg2rad(torch.tensor(30.0, dtype=torch.float32))))


def brute_force_match(kp1_angle, kp1_desc, kp1_valid,
                      kp2_angle, kp2_desc, kp2_valid,
                      *, lowe_ratio: float = 0.75, check_orientation: bool = True):
    """Returns (best_idx1 [N2], accepted [N2], best_dist [N2])."""
    N1 = kp1_desc.shape[0]
    orient = None
    if check_orientation:
        orient = H.OrientGate(
            row_c=torch.cos(kp2_angle), row_s=torch.sin(kp2_angle),
            col_c=torch.cos(kp1_angle), col_s=torch.sin(kp1_angle),
            cos_thr=cos_30deg())
    best, best_idx, second, _ = H.hamming_top2(
        kp2_desc, kp1_desc, kp2_valid, kp1_valid, orient=orient)
    accepted = (
        (best <= H.HAMMING_DIST_THR_LOW)
        & (best.to(torch.float32) <= lowe_ratio * second.to(torch.float32))
        & kp2_valid
    )
    accepted = H.resolve_duplicate_targets(best_idx, best, accepted, N1)
    return best_idx, accepted, best


def _rows3(M, v):
    """M @ v for [B,3,3] M and [B,N,3] v, each row summed left to right."""
    return torch.stack([M[:, i, None, 0] * v[..., 0] + M[:, i, None, 1] * v[..., 1]
                        + M[:, i, None, 2] * v[..., 2] for i in range(3)], -1)


def epipolar_gate(kp1_angle, kp1_level, kp1_bearing, kp1_is_stereo, kp2_angle,
                  kp2_bearing, kp2_is_stereo, E_12, epiplane_in_2, *,
                  scale_factors) -> H.EpipolarGate:
    """The per-row and per-target terms of match_for_triangulation's gates
    (robust.py:51-77 of the JAX package), each computed once."""
    epl = _rows3(E_12, kp2_bearing)  # [B,N2,3]
    norm = torch.sqrt(epl[..., 0] * epl[..., 0] + epl[..., 1] * epl[..., 1]
                      + epl[..., 2] * epl[..., 2])
    ep = epiplane_in_2[:, None, :]
    cos_dist = ep[..., 0] * kp2_bearing[..., 0] + ep[..., 1] * kp2_bearing[..., 1] \
        + ep[..., 2] * kp2_bearing[..., 2]
    return H.EpipolarGate(
        row_c=torch.cos(kp1_angle), row_s=torch.sin(kp1_angle), row_bear=kp1_bearing,
        row_thr=torch.sin(_RESIDUAL_RAD_THR * scale_factors[kp1_level.long()]),
        row_stereo=kp1_is_stereo,
        col_c=torch.cos(kp2_angle), col_s=torch.sin(kp2_angle), col_epl=epl,
        col_norm=torch.clamp(norm, min=1e-12),
        col_near=(cos_dist > _COS_EPIPOLE_THR) & ~kp2_is_stereo, E=E_12,
        cos_thr=cos_30deg())


def match_for_triangulation(kp1_angle, kp1_level, kp1_desc, kp1_bearing, kp1_valid,
                            kp1_is_stereo, kp2_angle, kp2_desc, kp2_bearing, kp2_valid,
                            kp2_is_stereo, E_12, epiplane_in_2, *, scale_factors):
    """The new keyframe's keypoints (kp1_*, [N1]) against B neighbour
    keyframes at once: kp2_* carry a leading axis B ([B,N2]), E_12 [B,3,3]
    (kf1 <- kf2 in bearing space) and epiplane_in_2 [B,3] (the bearing of
    kf1's centre in kf2). kp*_valid are the valid and unassociated
    keypoints. Returns (best_idx2 [B,N1], accepted [B,N1], best_dist
    [B,N1]); the orientation check and the epipole rejection are always on,
    as the mapping module calls it."""
    B, N2 = kp2_desc.shape[0], kp2_desc.shape[1]
    N1 = kp1_desc.shape[0]
    gate = epipolar_gate(kp1_angle, kp1_level, kp1_bearing, kp1_is_stereo, kp2_angle,
                         kp2_bearing, kp2_is_stereo, E_12, epiplane_in_2,
                         scale_factors=scale_factors)
    best, best_idx, second, _ = H.epipolar_top2(kp1_desc, kp2_desc, kp1_valid,
                                                kp2_valid, gate)
    accepted = (
        (best <= H.HAMMING_DIST_THR_LOW)
        & (best.to(torch.float32) <= _TRI_LOWE_RATIO * second.to(torch.float32))
        & kp1_valid[None, :]
    )
    # duplicate resolution per neighbour: the B problems as one, with each
    # neighbour's targets offset so they never collide
    offs = torch.arange(B, device=best_idx.device, dtype=torch.int64)[:, None] * N2
    accepted = H.resolve_duplicate_targets(
        (best_idx.to(torch.int64) + offs).reshape(-1), best.reshape(-1),
        accepted.reshape(-1), B * N2).reshape(B, N1)
    return best_idx, accepted, best
