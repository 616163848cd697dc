"""Depth-seeded landmark creation for stereo/RGBD keyframes.

Port of `KeyframeInserter._seed_depth_landmarks`
(stella_vslam_tpu/module/keyframe_inserter.py:176), which the RGBD/stereo
initializer calls (reference keyframe_inserter.cc:160-212): landmarks from
the nearest valid depths, every one within depth_thr and at least 100
overall. The keyframe-need policy and insertion wait for the mapping module
(ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np

from stella_vslam_tpu_torch.data.keyframe import Keyframe
from stella_vslam_tpu_torch.data.landmark import Landmark


class KeyframeInserter:
    def __init__(self, camera):
        self.camera = camera

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
