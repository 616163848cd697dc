"""Landmark-duplication detection (fuse), dense masked form.

Port of `detect_duplication` (stella_vslam_tpu/match/fuse.py:26; reference
match/fuse.cc): candidate landmarks reprojected into a keyframe match the
keypoints inside a scale-aware margin window whose octave lies in
[pred-1, pred+1] and which pass a chi-square gate on the reprojection error
(5.99 mono / 7.81 stereo on the octave's sigma^2), at Hamming distance <=
HAMMING_DIST_THR_LOW. This is the plain version of kernel L's scan
(csrc/fuse.cu, wrapped by module/mapping_kernels.fuse_scan, which also
fuses the reprojection prologue); the host decides replace-vs-add.
"""
from __future__ import annotations

import torch

from stella_vslam_tpu_torch.match import hamming as H

CHI_SQ_2D = 5.99146
CHI_SQ_3D = 7.81473
# the search window's half-width in pixels at octave 0: the mapping module
# fuses with 3, the loop closer with 4
MARGIN = 3.0


def candidate_mask(kp_uv, kp_level, kp_valid, kp_x_right, lm_reproj, lm_x_right,
                   lm_pred_scale, lm_valid, *, scale_factors, level_sigma_sq,
                   margin: float = MARGIN):
    """(in_window, candidate), each [M,N] bool: the landmark's margin window
    alone, and every gate of the scan."""
    pred = lm_pred_scale.long()
    radius = margin * scale_factors[pred]
    du = kp_uv[None, :, 0] - lm_reproj[:, None, 0]
    dv = kp_uv[None, :, 1] - lm_reproj[:, None, 1]
    in_window = (torch.abs(du) <= radius[:, None]) & (torch.abs(dv) <= radius[:, None])
    lvl = kp_level.long()
    level_ok = (lvl[None, :] >= pred[:, None] - 1) & (lvl[None, :] <= pred[:, None] + 1)
    err2 = du * du + dv * dv
    dr = lm_x_right[:, None] - kp_x_right[None, :]
    err3 = err2 + dr * dr
    sigma_sq = level_sigma_sq[lvl][None, :]
    has_stereo = (kp_x_right[None, :] > 0) & (lm_x_right[:, None] > 0)
    chi_ok = torch.where(has_stereo, err3 / sigma_sq <= CHI_SQ_3D,
                         err2 / sigma_sq <= CHI_SQ_2D)
    cand = in_window & level_ok & chi_ok & kp_valid[None, :] & lm_valid[:, None]
    return in_window, cand


def duplication_scan(kp_uv, kp_level, kp_desc, kp_valid, kp_x_right, lm_desc,
                     lm_reproj, lm_x_right, lm_pred_scale, lm_valid, *,
                     scale_factors, level_sigma_sq, margin: float = MARGIN):
    """Keypoints [N] of one keyframe against landmarks [M]: (best [M] i32,
    best_idx [M] i32), masked entries at 257, ties to the lowest index."""
    _, cand = candidate_mask(kp_uv, kp_level, kp_valid, kp_x_right, lm_reproj,
                             lm_x_right, lm_pred_scale, lm_valid,
                             scale_factors=scale_factors, level_sigma_sq=level_sigma_sq,
                             margin=margin)
    dist = H.pairwise_hamming(lm_desc, kp_desc)  # [M,N]
    dist = torch.where(cand, dist, torch.full_like(dist, H.MAX_HAMMING_DIST + 1))
    best, best_idx = dist.min(dim=1)
    return best.to(torch.int32), best_idx.to(torch.int32)


def detect_duplication(kp_uv, kp_level, kp_desc, kp_valid, kp_x_right, lm_desc,
                       lm_reproj, lm_x_right, lm_pred_scale, lm_valid, *,
                       scale_factors, level_sigma_sq):
    """Returns (best_idx [M] i32, accepted [M] bool, best_dist [M] i32),
    one keypoint per accepted landmark and one landmark per keypoint."""
    best, best_idx = duplication_scan(
        kp_uv, kp_level, kp_desc, kp_valid, kp_x_right, lm_desc, lm_reproj,
        lm_x_right, lm_pred_scale, lm_valid, scale_factors=scale_factors,
        level_sigma_sq=level_sigma_sq)
    accepted = (best <= H.HAMMING_DIST_THR_LOW) & lm_valid
    accepted = H.resolve_duplicate_targets(best_idx, best, accepted, kp_desc.shape[0])
    return best_idx, accepted, best
