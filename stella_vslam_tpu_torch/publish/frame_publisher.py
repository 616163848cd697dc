"""Per-frame state publisher for viewers.

Copy of stella_vslam_tpu/publish/frame_publisher.py (reference
src/stella_vslam/publish/frame_publisher.{h,cc}): the latest image,
keypoints, tracking state and per-frame timings. `update` runs on the
tracking hot path, so it stores references only; a viewer that calls
`get_keypoints` or `draw_frame` reads the frame's host mirror at its own
rate, off the tracking thread. `draw_frame` marks keypoints with numpy
(the port does not use cv2): green where tracked, blue where not.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class FramePublisher:
    def __init__(self):
        self._lock = threading.Lock()
        self._frame = None  # data.frame.Frame of the latest update
        self.image: Optional[np.ndarray] = None
        self.tracking_state: str = "Initializing"
        self.extraction_time_ms: float = 0.0
        self.tracking_time_ms: float = 0.0

    def update(self, image, frame, state: str,
               extraction_time_ms: float = 0.0, tracking_time_ms: float = 0.0):
        with self._lock:
            self.image = image  # host uint8 (the caller's input buffer)
            self._frame = frame
            self.tracking_state = state
            self.extraction_time_ms = extraction_time_ms
            self.tracking_time_ms = tracking_time_ms

    def get_state(self) -> str:
        with self._lock:
            return self.tracking_state

    def get_keypoints(self):
        """(keypoints [K,2], tracked_mask [K]) of the latest frame, or None."""
        with self._lock:
            frm = self._frame
        if frm is None:
            return None
        valid = frm.h_valid
        return frm.h_xy[valid], (frm.lm_ids >= 0)[valid]

    def draw_frame(self) -> Optional[np.ndarray]:
        """The latest image as [H,W,3] uint8 (BGR) with its keypoints marked
        by 3x3 squares."""
        with self._lock:
            img = self.image
        if img is None:
            return None
        img = np.asarray(img)
        out = np.repeat(img[..., None], 3, axis=2).astype(np.uint8) if img.ndim == 2 \
            else img.copy()
        kp = self.get_keypoints()
        if kp is not None:
            h, w = out.shape[:2]
            for (x, y), tracked in zip(kp[0], kp[1]):
                xi, yi = int(x), int(y)
                out[max(0, yi - 1):min(h, yi + 2), max(0, xi - 1):min(w, xi + 2)] = \
                    (0, 220, 0) if tracked else (180, 120, 0)
        return out
