"""Area matcher for monocular initialization, on kernel C.

Port of stella_vslam_tpu/match/area.py match_in_consistent_area (:19;
reference match/area.cc): level-0 keypoints of the init frame against
level-0 keypoints of the current frame inside a +-margin window around the
previously matched positions, with the orientation check, accepted at
HAMMING_DIST_THR_LOW with the Lowe ratio, then one source per target.

The dense [N1,N2] masked matrix of the JAX version becomes one call of
`hamming_top2`: the window is kernel C's WindowGate centred on
`prev_matched` with radius `margin`, level range [0, 0] on the targets and
no x_right (-1); the row-side level 0 test and the validity go into
row_ok; the orientation test is kernel C's angle-gate mode.
"""
from __future__ import annotations

import torch

from stella_vslam_tpu_torch.match import hamming as H

ANGLE_THR = float(torch.deg2rad(torch.tensor(30.0, dtype=torch.float32)))


def match_in_consistent_area(kp1_level, kp1_desc, kp1_angle, kp1_valid,
                             prev_matched, kp2_uv, kp2_level, kp2_desc,
                             kp2_angle, kp2_valid, *, margin: float = 100.0,
                             lowe_ratio: float = 0.9,
                             check_orientation: bool = True, image_size):
    """Returns (best_idx2 [N1] i32, accepted [N1] bool, best_dist [N1] i32).
    image_size: the (width, height) of the current frame's image (the
    window's extent)."""
    args, kw = top2_args(kp1_level, kp1_desc, kp1_angle, kp1_valid, prev_matched, kp2_uv,
                         kp2_level, kp2_desc, kp2_angle, kp2_valid, margin=margin,
                         check_orientation=check_orientation, image_size=image_size)
    best, best_idx, second, _ = H.hamming_top2(*args, **kw)
    accepted = ((best <= H.HAMMING_DIST_THR_LOW)
                & (best.to(torch.float32) <= lowe_ratio * second.to(torch.float32))
                & kp1_valid)
    accepted = H.resolve_duplicate_targets(best_idx, best, accepted, kp2_desc.shape[0])
    return best_idx, accepted, best


def top2_args(kp1_level, kp1_desc, kp1_angle, kp1_valid, prev_matched, kp2_uv, kp2_level,
              kp2_desc, kp2_angle, kp2_valid, *, margin: float = 100.0,
              check_orientation: bool = True, image_size):
    """The arguments (args, kw) of the matcher's one `hamming_top2` call."""
    N1, N2 = kp1_desc.shape[0], kp2_desc.shape[0]
    dev = kp1_desc.device
    f32 = lambda t: t.to(torch.float32).contiguous()
    window = H.WindowGate(
        row_u=f32(prev_matched[:, 0]), row_v=f32(prev_matched[:, 1]),
        row_xr=torch.full((N1,), -1.0, device=dev),
        row_rad=torch.full((N1,), float(margin), device=dev),
        row_lo=torch.zeros(N1, dtype=torch.int32, device=dev),
        row_hi=torch.zeros(N1, dtype=torch.int32, device=dev),
        col_u=f32(kp2_uv[:, 0]), col_v=f32(kp2_uv[:, 1]),
        col_xr=torch.full((N2,), -1.0, device=dev),
        col_level=kp2_level.to(torch.int32).contiguous(), extent=image_size)
    orient = (H.AngleGate(f32(kp1_angle), f32(kp2_angle), ANGLE_THR)
              if check_orientation else None)
    row_ok = (kp1_valid & (kp1_level == 0)).contiguous()
    return ((kp1_desc.contiguous(), kp2_desc.contiguous(), row_ok, kp2_valid.contiguous()),
            dict(window=window, orient=orient))
