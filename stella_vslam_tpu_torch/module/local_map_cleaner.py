"""Landmark and keyframe culling policies.

Port of stella_vslam_tpu/module/local_map_cleaner.py (reference
src/stella_vslam/module/local_map_cleaner.{h,cc}):
* landmarks: a fresh landmark whose observed ratio drops below 0.3 is
  culled; it graduates once `num_reliable_keyfrms` keyframes have passed
  since its creation (cc:20-67);
* keyframes: culled when over 90% of their valid observations are
  redundant, seen at the same or a finer octave by 3 other keyframes
  (cc:68-123), counted by the native map store.
"""
from __future__ import annotations

from typing import List


class LocalMapCleaner:
    def __init__(self, observed_ratio_thr: float = 0.3,
                 num_reliable_keyfrms: int = 2,
                 redundant_obs_ratio_thr: float = 0.9):
        self.observed_ratio_thr = observed_ratio_thr
        self.num_reliable_keyfrms = num_reliable_keyfrms
        self.redundant_obs_ratio_thr = redundant_obs_ratio_thr
        self.fresh_landmark_ids: List[int] = []

    # ------------------------------------------------------------------
    def remove_invalid_landmarks(self, map_db, cur_keyfrm_id: int) -> int:
        """Cull, graduate or hold each fresh landmark (no observation-count
        rule: stella_vslam removed ORB-SLAM's)."""
        removed = 0
        keep = []
        for lm_id in self.fresh_landmark_ids:
            lm = map_db.landmarks.get(lm_id)
            if lm is None or lm.will_be_erased:
                continue
            if lm.get_observed_ratio() < self.observed_ratio_thr:
                map_db.erase_landmark(lm_id)
                removed += 1
            elif self.num_reliable_keyfrms + lm.first_keyfrm_id < cur_keyfrm_id:
                pass  # graduated
            else:
                keep.append(lm_id)
        self.fresh_landmark_ids = keep
        return removed

    # ------------------------------------------------------------------
    def remove_redundant_keyframes(self, map_db, cur_keyfrm) -> int:
        removed = 0
        for kf_id in cur_keyfrm.graph_node.get_covisibilities():
            kf = map_db.keyframes.get(kf_id)
            if kf is None or kf.will_be_erased or not kf.can_be_erased():
                continue
            if kf.id in map_db.spanning_roots:
                continue
            if kf.id <= map_db.fixed_keyframe_id_threshold:
                continue
            num_valid, num_redundant = self._count_redundant(map_db, kf)
            if num_valid > 0 and num_redundant > self.redundant_obs_ratio_thr * num_valid:
                map_db.erase_keyframe(kf.id)
                removed += 1
        return removed

    def _count_redundant(self, map_db, kf):
        return map_db.assoc_store.count_redundant(kf.id, kf.lm_ids, kf.h_level)
