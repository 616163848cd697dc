"""Thread-safe map snapshots for viewers.

Copy of stella_vslam_tpu/publish/map_publisher.py (reference
src/stella_vslam/publish/map_publisher.{h,cc}): the current camera pose and
keyframe / landmark snapshots taken under the map lock.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class MapPublisher:
    def __init__(self, map_db):
        self._lock = threading.Lock()
        self.map_db = map_db
        self._current_pose_wc: Optional[np.ndarray] = None

    def set_current_cam_pose(self, pose_cw: np.ndarray):
        with self._lock:
            R = pose_cw[:3, :3]
            t = pose_cw[:3, 3]
            T = np.eye(4)
            T[:3, :3] = R.T
            T[:3, 3] = -R.T @ t
            self._current_pose_wc = T

    def get_current_cam_pose(self) -> Optional[np.ndarray]:
        with self._lock:
            return None if self._current_pose_wc is None else self._current_pose_wc.copy()

    def get_keyframes(self):
        with self.map_db.lock:
            return [
                (kf.id, kf.pose_wc)
                for kf in self.map_db.keyframes.values()
                if not kf.will_be_erased
            ]

    def get_landmarks(self):
        with self.map_db.lock:
            return np.array(
                [
                    lm.pos_w
                    for lm in self.map_db.landmarks.values()
                    if not lm.will_be_erased
                ]
            ).reshape(-1, 3)
