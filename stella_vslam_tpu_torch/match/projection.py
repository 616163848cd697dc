"""Projection-guided 2D-3D matching on kernel C.

Port of `match_frame_and_landmarks` (stella_vslam_tpu/match/projection.py:25),
`match_current_and_last_frames` (:99) and `match_frame_and_keyframe` (:160).
The tracking cascade's two take their query rows' window fields as kernel R
writes them (`camera.base.project_window_rows`, a `WindowRows`); the loop
detector's rematch builds its own. Each calls `hamming.hamming_top2` once
and applies the ratio / orientation tests and the duplicate-target
resolution to the [M] outputs. All return (best_idx [M] i32, accepted [M]
bool, best_dist [M]). `image_size` is the (width, height) of the image the
keypoints lie in (the window's extent).
"""
from __future__ import annotations

import torch

from stella_vslam_tpu_torch.match import hamming as H


def _rows_window(rows, kp_uv, kp_level, kp_x_right, image_size) -> H.WindowGate:
    """Kernel R's window rows against the frame's keypoints."""
    return H.WindowGate(
        row_u=rows.u, row_v=rows.v, row_xr=rows.xr, row_rad=rows.rad, row_lo=rows.lo,
        row_hi=rows.hi, col_u=kp_uv[:, 0].contiguous(), col_v=kp_uv[:, 1].contiguous(),
        col_xr=kp_x_right, col_level=kp_level, extent=image_size)


def match_frame_and_landmarks(
    kp_uv, kp_level, kp_desc, kp_valid, kp_has_lm, kp_x_right, lm_desc, rows,
    *, image_size, lowe_ratio: float = 0.6,
):
    """The local map's landmarks (their window rows from kernel R's table
    mode: radius margin * scale_factor[pred_scale], candidate levels
    [pred-1, pred+1] clamped, the local-map gate as the valid flag) against
    the keypoints that hold no landmark yet; ratio test only when best and
    second share a level; accept at HAMMING_DIST_THR_HIGH."""
    N = kp_desc.shape[0]
    window = _rows_window(rows, kp_uv, kp_level, kp_x_right, image_size)
    best, best_idx, second, second_idx = H.hamming_top2(
        lm_desc, kp_desc, rows.valid, kp_valid & ~kp_has_lm, window=window)
    best_level = kp_level[best_idx.long()]
    second_level = kp_level[second_idx.long()]
    ratio_reject = (best_level == second_level) & (
        best.to(torch.float32) > lowe_ratio * second.to(torch.float32))
    accepted = (best <= H.HAMMING_DIST_THR_HIGH) & ~ratio_reject & rows.valid
    accepted = H.resolve_duplicate_targets(best_idx, best, accepted, N)
    return best_idx, accepted, best


def match_current_and_last_frames(
    kp_uv, kp_level, kp_desc, kp_valid, kp_angle, kp_x_right,
    last_desc, last_angle, rows, *, image_size, check_orientation: bool = True,
):
    """Motion-model matcher: the last frame's chained landmarks (their
    window rows from kernel R's point mode: margin * scale_factor[last
    level], levels [last-1, last+1], valid where associated and in the
    image), orientation consistency."""
    N = kp_desc.shape[0]
    window = _rows_window(rows, kp_uv, kp_level, kp_x_right, image_size)
    best, best_idx, _, _ = H.hamming_top2(
        last_desc, kp_desc, rows.valid, kp_valid, window=window)
    accepted = (best <= H.HAMMING_DIST_THR_HIGH) & rows.valid
    if check_orientation:
        accepted = accepted & H.angle_diff_ok(last_angle, kp_angle[best_idx.long()])
    accepted = H.resolve_duplicate_targets(best_idx, best, accepted, N)
    return best_idx, accepted, best


def match_frame_and_keyframe(
    kp_uv, kp_level, kp_desc, kp_valid, kp_angle, kp_has_lm,
    lm_desc, lm_reproj, lm_pred_scale, lm_angle, lm_valid,
    *, scale_factors: torch.Tensor, num_levels: int, image_size, margin: float,
    hamm_dist_thr: int = H.HAMMING_DIST_THR_LOW, check_orientation: bool = True,
    top2=H.hamming_top2,
):
    """reference projection::match_frame_and_keyframe (projection.cc:202-300),
    the loop detector's rematch: a keyframe's landmarks, reprojected into the
    frame, against the frame's keypoints that hold no landmark yet: window
    margin * scale_factor[pred level], levels [pred-1, pred+1], the best
    distance only (no ratio test), orientation consistency on the winner.
    `top2` is for checks only: kernel C's wrapper (the default, and what
    every caller in the package uses), or its plain version to hold it
    against. Kernel C's wrapper raises `match_frame_and_keyframe.launches`
    at each launch it makes for this matcher."""
    N = kp_desc.shape[0]
    pred = lm_pred_scale.to(torch.int32)
    none = torch.full((lm_desc.shape[0],), -1.0, dtype=torch.float32, device=kp_uv.device)
    window = H.WindowGate(
        row_u=lm_reproj[:, 0].contiguous(), row_v=lm_reproj[:, 1].contiguous(),
        row_xr=none, row_rad=margin * scale_factors[pred.long()],
        row_lo=pred - 1, row_hi=pred + 1,
        col_u=kp_uv[:, 0].contiguous(), col_v=kp_uv[:, 1].contiguous(),
        col_xr=torch.full((N,), -1.0, dtype=torch.float32, device=kp_uv.device),
        col_level=kp_level, extent=image_size)
    best, best_idx, _, _ = top2(
        lm_desc, kp_desc, lm_valid, kp_valid & ~kp_has_lm, window=window,
        counter=match_frame_and_keyframe)
    accepted = (best <= hamm_dist_thr) & lm_valid
    if check_orientation:
        accepted = accepted & H.angle_diff_ok(lm_angle, kp_angle[best_idx.long()])
    accepted = H.resolve_duplicate_targets(best_idx, best, accepted, N)
    return best_idx, accepted, best


match_frame_and_keyframe.launches = 0
