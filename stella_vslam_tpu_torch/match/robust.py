"""Brute-force robust matching on kernel C.

Port of `brute_force_match` (stella_vslam_tpu/match/robust.py:92), the
keyframe fallback of the tracking cascade: for each keyframe landmark
observation, the best frame keypoint under the orientation gate, Lowe ratio
and HAMMING_DIST_THR_LOW.
"""
from __future__ import annotations

import torch

from stella_vslam_tpu_torch.match import hamming as H


def cos_30deg(device) -> float:
    """cos(30 deg) in f32, the orientation gate's threshold."""
    return float(torch.cos(torch.deg2rad(
        torch.tensor(30.0, dtype=torch.float32, device=device))))


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
            cos_thr=cos_30deg(kp1_angle.device))
    best, best_idx, second, _ = H.hamming_top2(
        kp2_desc, kp1_desc, kp2_valid, kp1_valid, orient=orient)
    accepted = (
        (best <= H.HAMMING_DIST_THR_LOW)
        & (best.to(torch.float32) <= lowe_ratio * second.to(torch.float32))
        & kp2_valid
    )
    accepted = H.resolve_duplicate_targets(best_idx, best, accepted, N1)
    return best_idx, accepted, best
