"""Rectified stereo keypoint matching: kernel T (K19).

Port of stella_vslam_tpu/match/stereo.py (reference src/stella_vslam/match/
stereo.{h,cc}). Per left keypoint, the right keypoints in its row band
(|dy| <= 2 * the right keypoint's level scale), with a disparity in
[0, focal_x_baseline / true_baseline) and a level within one of its own,
are candidates; the best Hamming distance among them under
(THR_LOW + THR_HIGH) / 2 = 75 is the match. Its subpixel position comes
from an 11x11 SAD window slid +-5 px over the blurred descriptor patches
and a parabola through the best shift's neighbours; a correlation filter
keeps the matches whose SAD is at most twice the mean over the matched
keypoints (the JAX version's declared deviation from the reference's
median).

The patches are the 11x21 strips around the centre of the blurred 39x39
descriptor patches, uint8, as kernel B writes them
(`feature.orb_extractor.orb_describe_strips`): the left patch's
centre 11x11 window and the right patch's 11 shifted windows lie in them.

* on CUDA tensors, kernel T (csrc/stereo_match.cu), one launch: one warp
  per left keypoint walks only the right slots whose cells the row band
  and the disparity range can reach (chip_smoke.py's `band_cells_plain`
  is that walk in torch), with the gates in registers (the [NL, NR] matrix
  is never stored), integer SADs over strips staged in shared memory, and
  the filter in the last block to finish. The right keypoints must be an
  extractor's slots, placed as `layout` (the extractor's `slot_layout`)
  says;
* on CPU tensors, `stereo_match_plain`: the JAX version's dense form, with
  the SADs and the filter's sum in integers (the JAX version's float32 sums
  of integers are exact while they stay under 2^24).

Both return (x_right [NL], depth [NL]) float32, -1 where unmatched.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.feature.orb_extractor import SlotLayout
from stella_vslam_tpu_torch.kernels import build as kbuild
from stella_vslam_tpu_torch.match.hamming import (
    HAMMING_DIST_THR_HIGH, HAMMING_DIST_THR_LOW, MAX_HAMMING_DIST, pairwise_hamming)

STRIP_H, STRIP_W = 11, 21
_WIN = 5  # 11x11 window
_SLIDE = 5  # +-5 px subpixel search


def max_disparity(focal_x_baseline: float, true_baseline: float) -> float:
    """focal_x_baseline / max(true_baseline, 1e-9), rounded as the JAX
    version's float32 division rounds it."""
    f32 = np.float32
    return float(f32(focal_x_baseline) / max(f32(true_baseline), f32(1e-9)))


def stereo_refine_plain(l_xy, l_level, l_desc, l_valid, l_strip,
                        r_xy, r_level, r_desc, r_valid, r_strip, *,
                        scale_factors, focal_x_baseline: float, true_baseline: float):
    """The matching and the subpixel step, before the correlation filter:
    (matched [NL] bool, best SAD [NL] int64, disparity [NL] f32)."""
    max_disp = max_disparity(focal_x_baseline, true_baseline)
    dist = pairwise_hamming(l_desc, r_desc)
    r_scale = scale_factors[r_level.long()]
    row_ok = torch.abs(r_xy[None, :, 1] - l_xy[:, None, 1]) <= 2.0 * r_scale[None, :]
    disp = l_xy[:, None, 0] - r_xy[None, :, 0]
    disp_ok = (disp >= 0.0) & (disp < max_disp)
    lvl_ok = torch.abs(l_level[:, None] - r_level[None, :]) <= 1
    cand = row_ok & disp_ok & lvl_ok & l_valid[:, None] & r_valid[None, :]
    dist = torch.where(cand, dist, torch.full_like(dist, MAX_HAMMING_DIST + 1))
    best_idx = torch.argmin(dist, dim=1)  # the first index of the minimum
    best = dist.gather(1, best_idx[:, None])[:, 0]
    hamm_thr = (HAMMING_DIST_THR_LOW + HAMMING_DIST_THR_HIGH) / 2
    matched = (best < hamm_thr) & l_valid

    lw = l_strip[:, :, _SLIDE:_SLIDE + 2 * _WIN + 1].to(torch.int32)
    rp = r_strip[best_idx].to(torch.int32)
    sad = torch.stack([(lw - rp[:, :, d:d + 2 * _WIN + 1]).abs().sum(dim=(1, 2))
                       for d in range(2 * _SLIDE + 1)], dim=1)  # [NL, 11] int32
    best_d = torch.argmin(sad, dim=1)
    best_sad = sad.gather(1, best_d[:, None])[:, 0]
    ds = torch.clamp(best_d, 1, 2 * _SLIDE - 1)
    take = lambda off: sad.gather(1, (ds + off)[:, None])[:, 0].to(torch.float32)
    s_m, s_0, s_p = take(-1), take(0), take(1)
    denom = s_m + s_p - 2 * s_0
    frac = torch.where(torch.abs(denom) > 1e-6, 0.5 * (s_m - s_p) / denom,
                       torch.zeros_like(denom))
    frac = torch.clamp(frac, -1.0, 1.0)
    at_border = (best_d == 0) | (best_d == 2 * _SLIDE)
    delta = torch.where(at_border, (best_d - _SLIDE).to(torch.float32),
                        (ds - _SLIDE).to(torch.float32) + frac)
    x_right = r_xy[best_idx, 0] + delta
    disparity = l_xy[:, 0] - x_right
    disparity = torch.where(disparity <= 0.0, torch.full_like(disparity, 0.01), disparity)
    matched = matched & (disparity > 0.0) & (disparity < max_disp)
    return matched, best_sad, disparity


def stereo_match_plain(l_xy, l_level, l_desc, l_valid, l_strip,
                       r_xy, r_level, r_desc, r_valid, r_strip, *,
                       scale_factors, focal_x_baseline: float, true_baseline: float):
    """Plain version: l_* / r_* are the two images' keypoints (xy [N,2] f32,
    level [N] i32, desc [N,8] i32, valid [N] bool, strip [N,11,21] u8);
    scale_factors [num_levels] f32 tensor."""
    matched, best_sad, disparity = stereo_refine_plain(
        l_xy, l_level, l_desc, l_valid, l_strip, r_xy, r_level, r_desc, r_valid, r_strip,
        scale_factors=scale_factors, focal_x_baseline=focal_x_baseline,
        true_baseline=true_baseline)
    NL = l_xy.shape[0]
    dev = l_xy.device
    mean = filter_mean(matched, best_sad)
    matched = matched & (best_sad.to(torch.float32) <= 2.0 * mean)
    neg = torch.full((NL,), -1.0, dtype=torch.float32, device=dev)
    # a tensor numerator: `float / tensor` multiplies by the reciprocal
    depth = torch.where(matched, torch.full_like(disparity, focal_x_baseline) / disparity,
                        neg)
    x_right = torch.where(matched, l_xy[:, 0] - disparity, neg)
    return x_right, depth


def filter_mean(matched, best_sad):
    """The correlation filter's mean SAD over the matched rows: an integer
    sum, divided in float32 (the JAX version's float32 sum of integers is
    exact while it stays under 2^24)."""
    total = torch.where(matched, best_sad.to(torch.int64),
                        torch.zeros((), dtype=torch.int64, device=best_sad.device)).sum()
    return total.to(torch.float32) / torch.clamp(matched.sum(), min=1).to(torch.float32)


# the band walk's filter counters, one 16-byte block per (device, stream):
# the kernel's last block leaves them zero for the next launch on its stream
_counters = {}
_counters_lock = threading.Lock()


def _stream_counters(dev, stream: int):
    key = (dev.index, stream)
    with _counters_lock:
        if key not in _counters:
            _counters[key] = torch.zeros(2, dtype=torch.int64, device=dev)
        return _counters[key]


def stereo_match(l_xy, l_level, l_desc, l_valid, l_strip,
                 r_xy, r_level, r_desc, r_valid, r_strip, *,
                 scale_factors, focal_x_baseline: float, true_baseline: float,
                 layout: Optional[SlotLayout] = None):
    """Kernel T on CUDA tensors, the plain version on CPU tensors. On the
    card the right keypoints must be the slots of `layout` (r_level their
    levels), which the plain version does not read."""
    kw = dict(scale_factors=scale_factors, focal_x_baseline=focal_x_baseline,
              true_baseline=true_baseline)
    if not l_xy.is_cuda:
        return stereo_match_plain(l_xy, l_level, l_desc, l_valid, l_strip,
                                  r_xy, r_level, r_desc, r_valid, r_strip, **kw)
    NL, NR = l_xy.shape[0], r_xy.shape[0]
    if NR >= 1 << 16:
        raise ValueError("stereo_match: at most 65535 right keypoints")
    if layout is None or layout.num_slots != NR:
        raise ValueError("stereo_match: the right keypoints must be the slots of `layout`")
    L = layout.level_tab.shape[0]
    if not 1 <= L <= 32 or scale_factors.shape[0] < L:
        raise ValueError("stereo_match: 1-32 levels, a scale factor for each")
    for t, shape, dt in ((layout.level_tab, (L, 8), torch.int32),
                         (layout.level_scale, (L,), torch.float32)):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != l_xy.device \
                or not t.is_contiguous():
            raise ValueError(f"stereo_match: the layout's {dt} {shape} tables on the card")
    for t, shape, dt in ((l_xy, (NL, 2), torch.float32), (l_level, (NL,), torch.int32),
                         (l_desc, (NL, 8), torch.int32), (l_valid, (NL,), torch.bool),
                         (l_strip, (NL, STRIP_H, STRIP_W), torch.uint8),
                         (r_xy, (NR, 2), torch.float32), (r_level, (NR,), torch.int32),
                         (r_desc, (NR, 8), torch.int32), (r_valid, (NR,), torch.bool),
                         (r_strip, (NR, STRIP_H, STRIP_W), torch.uint8),
                         (scale_factors, (scale_factors.shape[0],), torch.float32)):
        if t.dtype != dt or t.shape != shape or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"stereo_match: expects a contiguous {dt} {shape} CUDA tensor")
    if l_desc.data_ptr() % 16 or r_desc.data_ptr() % 16 or r_xy.data_ptr() % 8:
        raise ValueError("stereo_match: descriptors 16-byte and r_xy 8-byte aligned")
    dev = l_xy.device
    # one allocation: x_right, depth, then the kernel's scratch (best SAD,
    # disparity)
    buf = torch.empty((4, NL), dtype=torch.float32, device=dev)
    x_right, depth = buf[0], buf[1]
    if NL == 0:
        return x_right, depth
    lib = kbuild.load()
    base, stream = buf.data_ptr(), kbuild.stream_ptr(dev)
    kbuild.check(lib.svt_stereo_match(
        NL, NR, L, layout.border, layout.level_tab.data_ptr(), layout.level_scale.data_ptr(),
        l_xy.data_ptr(), l_level.data_ptr(), l_desc.data_ptr(), l_valid.data_ptr(),
        l_strip.data_ptr(), r_xy.data_ptr(), r_level.data_ptr(), r_desc.data_ptr(),
        r_valid.data_ptr(), r_strip.data_ptr(), scale_factors.data_ptr(),
        max_disparity(focal_x_baseline, true_baseline), float(focal_x_baseline),
        base + 8 * NL, base + 12 * NL, _stream_counters(dev, stream).data_ptr(),
        base, base + 4 * NL, stream), "stereo_match")
    stereo_match.launches += 1
    return x_right, depth


stereo_match.launches = 0
