"""Keyframe: immutable observation + mutable pose + graph node.

Reference: src/stella_vslam/data/keyframe.{h,cc} — landmark slots (one per
keypoint), covisibility graph_node, erase protocol, median depth. Copy of
the part of stella_vslam_tpu/data/keyframe.py the tracking, initialization
and mapping slices call; device tensors are the source frame's.
Serialization and the loaded-map stub come with map IO.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.data.frame import Frame
from stella_vslam_tpu_torch.data.graph_node import GraphNode


class Keyframe:
    def __init__(self, frame: Frame, map_db, keyfrm_id: Optional[int] = None):
        self.id = map_db.next_keyframe_id() if keyfrm_id is None else keyfrm_id
        self.src_frm_id = frame.id
        self.timestamp = frame.timestamp
        self.camera = frame.camera
        self.orb_params = frame.orb_params
        self.num_slots = frame.num_slots

        # device tensors shared with the source frame (immutable
        # observation), delegated via properties below
        self._frame_ref = frame
        self.lm_ids = frame.lm_ids.copy()
        self.pose_cw = frame.pose_cw.copy()
        self.graph_node = GraphNode(self, map_db.min_num_shared_lms)
        self.will_be_erased = False
        self._not_to_be_erased = False
        # the pose at creation, in the coordinates of the device table the
        # keyframe was created against (set_pose_cw rebinds, so this stays
        # a snapshot): the tracker's rel-pose anchor for a keyframe created
        # after the table it tracked against was published
        self._pose_at_creation = self.pose_cw

    # device tensors delegate to the source frame
    @property
    def feats(self):
        return self._frame_ref.feats

    @property
    def undist_xy(self):
        return self._frame_ref.undist_xy

    @property
    def bearings(self):
        return self._frame_ref.bearings

    @property
    def x_right(self):
        return self._frame_ref.x_right

    @property
    def depths(self):
        return self._frame_ref.depths

    # host mirrors delegate to the frame cache
    @property
    def h_xy(self):
        return self._frame_ref.h_xy

    @property
    def h_undist_xy(self):
        return self._frame_ref.h_undist_xy

    @property
    def h_bearings(self):
        return self._frame_ref.h_bearings

    @property
    def h_level(self):
        return self._frame_ref.h_level

    @property
    def h_angle(self):
        return self._frame_ref.h_angle

    @property
    def h_valid(self):
        return self._frame_ref.h_valid

    @property
    def h_desc(self):
        return self._frame_ref.h_desc

    @property
    def h_x_right(self):
        return self._frame_ref.h_x_right

    @property
    def h_depths(self):
        return self._frame_ref.h_depths

    # ---- pose ----
    def set_pose_cw(self, pose_cw: np.ndarray):
        # rebinds (never mutates in place): anyone holding the previous
        # array — e.g. a TableSnap's kf_poses — keeps a true snapshot
        self.pose_cw = np.asarray(pose_cw, dtype=np.float64).copy()

    @property
    def rot_cw(self):
        return self.pose_cw[:3, :3]

    @property
    def trans_cw(self):
        return self.pose_cw[:3, 3]

    @property
    def cam_center(self):
        return -self.rot_cw.T @ self.trans_cw

    @property
    def pose_wc(self):
        T = np.eye(4)
        T[:3, :3] = self.rot_cw.T
        T[:3, 3] = self.cam_center
        return T

    def device_tensors(self):
        """The device tensors the keyframe shares with its source frame
        (the threads that read them mark them with record_stream)."""
        f = self._frame_ref
        return [t for t in (*f.feats, f.undist_xy, f.bearings, f.x_right, f.depths)
                if isinstance(t, torch.Tensor)]

    # ---- landmark slots ----
    def add_landmark(self, lm_id: int, idx: int):
        self.lm_ids[idx] = lm_id

    def erase_landmark_with_index(self, idx: int):
        self.lm_ids[idx] = -1

    def num_tracked_landmarks(self, map_db, min_num_obs: int = 1) -> int:
        """Associated landmarks with at least `min_num_obs` observations
        (one native bulk count; erased landmarks count 0)."""
        counts = map_db.assoc_store.num_obs_bulk(self.lm_ids)
        return int((counts >= max(min_num_obs, 1)).sum())

    def compute_median_depth(self, map_db) -> float:
        """Median |camera-frame z| of the associated live landmarks
        (reference keyframe.h:206-211, as the mapping module calls it)."""
        ids = map_db.fields.live(self.lm_ids[self.lm_ids >= 0])
        if len(ids) == 0:
            return 0.0
        z = map_db.fields.pos[ids] @ self.rot_cw[2] + self.trans_cw[2]
        return float(np.median(np.abs(z)))

    # ---- erase protocol (reference keyframe.h:232-250) ----
    def set_not_to_be_erased(self, flag: bool = True):
        self._not_to_be_erased = flag

    def can_be_erased(self) -> bool:
        # keyframes anchoring a loop edge are never culled
        return not self._not_to_be_erased and not self.graph_node.loop_edges
