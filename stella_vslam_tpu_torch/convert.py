"""Carry state from the JAX package into the port.

Tests feed both implementations identical state: these functions read the
JAX objects' arrays through `np.asarray` only (this module imports no jax)
and return the port's tensors.

* `extractor_tables`: an OrbExtractor's constant tables (resize matrices,
  blur taps, moment masks, steered BRIEF offsets) in the form
  `feature.orb_extractor.OrbExtractor(tables=...)` takes;
* `table_snap`: a TableSnap's packed device landmark table;
* `frame_features`: a frame's FrameFeatures.
"""
from __future__ import annotations

import numpy as np
import torch

from stella_vslam_tpu_torch.feature.orb_extractor import (
    ANGLE_BINS, FrameFeatures, _DESC_R, _DESC_W, _MOM_OFF, _RAW_W)


def extractor_tables(jax_extractor) -> dict:
    ex = jax_extractor
    resize = [(np.array(R, np.float32), np.array(C, np.float32))
              for R, C in ex._resize_mats]
    blur = np.asarray(ex._blur_matrix, np.float32)  # [39*39, 45*45]
    taps = blur[0].reshape(_RAW_W, _RAW_W)[:7, :7].copy()
    mom = np.asarray(ex._moment_vecs, np.float32).reshape(_RAW_W, _RAW_W, 2)
    k10 = mom[_MOM_OFF:_MOM_OFF + 31, _MOM_OFF:_MOM_OFF + 31, 0].copy()
    k01 = mom[_MOM_OFF:_MOM_OFF + 31, _MOM_OFF:_MOM_OFF + 31, 1].copy()
    # each bit-matrix row holds +1 at pair endpoint 1 and -1 at endpoint 0;
    # a pair whose rotated endpoints coincide has an all-zero row and a bit
    # that is always 0, which equal endpoints reproduce
    W = np.asarray(ex._bit_matrix).astype(np.float32).reshape(ANGLE_BINS, 256, -1)
    centre = _DESC_R * _DESC_W + _DESC_R
    i1 = np.where((W == 1).any(-1), np.argmax(W == 1, -1), centre)
    i0 = np.where((W == -1).any(-1), np.argmax(W == -1, -1), centre)
    offsets = np.stack([i0 % _DESC_W, i0 // _DESC_W, i1 % _DESC_W, i1 // _DESC_W],
                       -1).astype(np.int8)
    return {"resize": resize, "taps": taps, "k10": k10, "k01": k01,
            "offsets": offsets}


def table_snap(snap, device="cpu"):
    """-> (tbl_f32 [C,8] f32, tbl_u32 [C,10] int32 with the uint32 bits)."""
    f32 = np.asarray(snap.tbl_f32, np.float32)
    u32 = np.ascontiguousarray(np.asarray(snap.tbl_u32, np.uint32))
    return (torch.from_numpy(f32.copy()).to(device),
            torch.from_numpy(u32.view(np.int32).copy()).to(device))


def frame_features(feats, device="cpu") -> FrameFeatures:
    desc = np.ascontiguousarray(np.asarray(feats.desc, np.uint32)).view(np.int32)
    t = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt)).to(device)
    return FrameFeatures(
        xy=t(feats.xy, np.float32), response=t(feats.response, np.float32),
        angle=t(feats.angle, np.float32), level=t(feats.level, np.int32),
        valid=t(feats.valid, bool), desc=torch.from_numpy(desc.copy()).to(device))
