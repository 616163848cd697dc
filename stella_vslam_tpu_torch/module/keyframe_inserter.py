"""Keyframe insertion policy and creation.

Port of stella_vslam_tpu/module/keyframe_inserter.py (reference
src/stella_vslam/module/keyframe_inserter.{h,cc}): the YAML surface
(`from_yaml`, cc:34-42), the decision `new_keyframe_is_needed` (interval
bounds, landmark coverage against the reference keyframe, the mapping
queue's backpressure veto; cc:51-128), `insert_new_keyframe` (the frame's
associations registered, the keyframe added to the map and the mapper's
queue; cc:218-231) and the depth-seeded landmarks of stereo/RGBD keyframes
(`_seed_depth_landmarks`, cc:160-212), which the RGBD initializer calls.
Markers are not ported: there is no marker hook.
"""
from __future__ import annotations

import numpy as np

from stella_vslam_tpu_torch.camera.base import Setup
from stella_vslam_tpu_torch.data.frame import Frame
from stella_vslam_tpu_torch.data.keyframe import Keyframe
from stella_vslam_tpu_torch.data.landmark import Landmark


class KeyframeInserter:
    def __init__(self, camera, *, max_interval: float = 1.0, min_interval: float = 0.1,
                 max_distance: float = -1.0, min_distance: float = -1.0,
                 lms_ratio_thr_almost_all_lms_are_tracked: float = 0.9,
                 lms_ratio_thr_view_changed: float = 0.5, enough_lms_thr: int = 100):
        self.camera = camera
        self.max_interval = max_interval
        self.min_interval = min_interval
        self.max_distance = max_distance
        self.min_distance = min_distance
        self.ratio_almost_all = lms_ratio_thr_almost_all_lms_are_tracked
        self.ratio_view_changed = lms_ratio_thr_view_changed
        self.enough_lms_thr = enough_lms_thr
        self.mapper = None  # set by System

    @staticmethod
    def from_yaml(camera, node: dict) -> "KeyframeInserter":
        return KeyframeInserter(
            camera,
            max_interval=float(node.get("max_interval", 1.0)),
            min_interval=float(node.get("min_interval", 0.1)),
            max_distance=float(node.get("max_distance", -1.0)),
            min_distance=float(node.get("min_distance", -1.0)),
            lms_ratio_thr_almost_all_lms_are_tracked=float(
                node.get("lms_ratio_thr_almost_all_lms_are_tracked", 0.9)),
            lms_ratio_thr_view_changed=float(node.get("lms_ratio_thr_view_changed", 0.5)),
            enough_lms_thr=int(node.get("enough_lms_thr", 100)),
        )

    def new_keyframe_is_needed(self, map_db, cur_frm: Frame, num_tracked: int,
                               last_inserted_time: float, ref_keyfrm,
                               num_reliable: int) -> bool:
        """(max_interval | max_distance | view_changed | not_enough_lms)
        & (!enough_keyfrms | (min_interval & min_distance))
        & !tracking_is_unstable & !almost_all_lms_are_tracked
        & !mapper_is_skipping_localBA (two keyframes waiting in the mapping
        queue), and never while the mapper pauses; `num_reliable` counts the tracked
        landmarks with >= min_num_obs_thr observations."""
        if self.mapper is None:
            return False
        # backpressure veto (keyframe_inserter.cc:59-62)
        if self.mapper.is_paused() or self.mapper.pause_is_requested():
            return False
        num_keyfrms = map_db.num_keyframes()
        min_obs_thr = 3 if num_keyfrms >= 3 else 2
        num_reliable_in_ref = (
            ref_keyfrm.num_tracked_landmarks(map_db, min_obs_thr) if ref_keyfrm else 0)
        enough_keyfrms = num_keyfrms > 5
        dt = cur_frm.timestamp - last_inserted_time
        max_interval_elapsed = self.max_interval > 0 and dt >= self.max_interval
        min_interval_elapsed = self.min_interval <= 0 or dt >= self.min_interval
        max_distance_traveled = False
        min_distance_traveled = True
        if (self.max_distance > 0 or self.min_distance > 0) and ref_keyfrm is not None:
            last_kf = map_db.last_inserted_keyframe()
            if last_kf is not None:
                d = float(np.linalg.norm(last_kf.cam_center - cur_frm.cam_center))
                if self.max_distance > 0:
                    max_distance_traveled = d > self.max_distance
                if self.min_distance > 0:
                    min_distance_traveled = d > self.min_distance
        view_changed = num_reliable < num_reliable_in_ref * self.ratio_view_changed
        not_enough_lms = num_reliable < self.enough_lms_thr
        tracking_is_unstable = num_tracked < 15
        almost_all_lms_are_tracked = num_reliable > num_reliable_in_ref * self.ratio_almost_all
        return (
            (max_interval_elapsed or max_distance_traveled or view_changed
             or not_enough_lms)
            and (not enough_keyfrms or (min_interval_elapsed and min_distance_traveled))
            and not tracking_is_unstable
            and not almost_all_lms_are_tracked
            and not self.mapper.is_skipping_localBA()
        )

    # ------------------------------------------------------------------
    def insert_new_keyframe(self, map_db, cur_frm: Frame) -> Keyframe:
        """A keyframe from the frame: its live associations registered (one
        slot per landmark), added to the map and the covisibility graph,
        and queued for the mapper."""
        kf = Keyframe(cur_frm, map_db)
        lm_ids = kf.lm_ids
        occ = np.nonzero(lm_ids >= 0)[0]
        alive = map_db.fields.alive[lm_ids[occ]]
        _, first = np.unique(lm_ids[occ], return_index=True)
        keep_mask = np.zeros(len(occ), bool)
        keep_mask[first] = True
        keep_mask &= alive
        lm_ids[occ[~keep_mask]] = -1
        kept = occ[keep_mask]
        kept_ids = lm_ids[kept]
        map_db.assoc_store.add_bulk(kept_ids, np.full(len(kept), kf.id, np.int64), kept)
        for lm_id, idx in zip(kept_ids.tolist(), kept.tolist()):
            map_db.landmarks[lm_id].observations[kf.id] = idx
        map_db.add_keyframe(kf)
        # the new observations' landmark stats ride the mapper event's one
        # refresh (MappingModule._event_start)
        if self.camera.setup != Setup.MONOCULAR:
            self._seed_depth_landmarks(map_db, kf)
        kf.graph_node.update_connections(map_db)
        if self.mapper is not None:
            self.mapper.async_add_keyframe(kf)
        return kf

    def _seed_depth_landmarks(self, map_db, kf: Keyframe):
        depths = kf.h_depths
        valid = kf.h_valid
        order = np.argsort(np.where(depths > 0, depths, np.inf))
        depth_thr = float(self.camera.params.depth_thr)
        created = 0
        seeded = []
        R_wc = kf.rot_cw.T
        t_wc = -R_wc @ kf.trans_cw
        p = self.camera.params
        fx, fy, cx, cy = map(float, (p.fx, p.fy, p.cx, p.cy))
        und = kf.h_undist_xy
        for idx in order:
            z = depths[idx]
            if z <= 0 or not np.isfinite(z):
                break  # sorted: no more positive depths
            if not valid[idx]:
                continue
            if kf.lm_ids[idx] >= 0:
                continue
            if z > depth_thr and created >= 100:
                break
            x = (und[idx, 0] - cx) * z / fx
            y = (und[idx, 1] - cy) * z / fy
            pos_w = R_wc @ np.array([x, y, z]) + t_wc
            lm = Landmark(map_db.next_landmark_id(), pos_w, kf.id)
            lm.add_observation(kf.id, int(idx))
            kf.add_landmark(lm.id, int(idx))
            map_db.add_landmark(lm)
            seeded.append(lm)
            created += 1
        map_db.batch_refresh_landmark_stats(seeded, kf.orb_params.scale_factors)
