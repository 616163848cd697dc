"""Landmark: 3D point with observation bookkeeping.

Reference: src/stella_vslam/data/landmark.{h,cc}. Copy of the part of
stella_vslam_tpu/data/landmark.py the RGBD tracking slice calls: the
store-backed geometric fields and observation registration (statistics are
refreshed in bulk by MapDatabase.batch_refresh_landmark_stats).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class Landmark:
    """Geometric/appearance fields (pos_w, descriptor, mean_normal,
    min/max_valid_dist) are write-through PROPERTIES: once the landmark is
    registered in a MapDatabase, they live in its contiguous
    LandmarkFieldStore row (indexed by landmark id) so the mapper's bulk
    consumers — fuse dispatch, BA assembly, device-table publish — read
    whole field arrays with one fancy index instead of a Python loop over
    landmark objects. Before registration they fall back to instance
    attributes (unit tests, deserialization)."""

    def __init__(self, lm_id: int, pos_w: np.ndarray, ref_keyfrm_id: int):
        self._fs = None  # LandmarkFieldStore once registered
        self.id = int(lm_id)
        self.pos_w = np.asarray(pos_w, dtype=np.float64).copy()
        self.ref_keyfrm_id = int(ref_keyfrm_id)
        # keyframe id -> keypoint index (ordered by insertion; python dicts
        # preserve order and keyframe ids are monotone)
        self.observations: Dict[int, int] = {}
        self.descriptor = np.zeros(8, dtype=np.uint32)
        self.mean_normal = np.zeros(3)
        self.min_valid_dist = 0.0
        self.max_valid_dist = 0.0
        self.num_observable = 1
        self.num_observed = 1
        self.will_be_erased = False
        self.replaced_id: Optional[int] = None
        self.first_keyfrm_id = int(ref_keyfrm_id)
        self.num_observations_when_created = 0

    # ---- store-backed field properties ----
    @property
    def pos_w(self):
        fs = self._fs
        return self._pos_w if fs is None else fs.pos[self.id]

    @pos_w.setter
    def pos_w(self, v):
        fs = self._fs
        if fs is None:
            self._pos_w = np.asarray(v, np.float64).copy()
        else:
            fs.pos[self.id] = v

    @property
    def descriptor(self):
        fs = self._fs
        return self._descriptor if fs is None else fs.desc[self.id]

    @descriptor.setter
    def descriptor(self, v):
        fs = self._fs
        if fs is None:
            self._descriptor = np.asarray(v, np.uint32)
        else:
            fs.desc[self.id] = v

    @property
    def mean_normal(self):
        fs = self._fs
        return self._mean_normal if fs is None else fs.normal[self.id]

    @mean_normal.setter
    def mean_normal(self, v):
        fs = self._fs
        if fs is None:
            self._mean_normal = np.asarray(v, np.float64)
        else:
            fs.normal[self.id] = v

    @property
    def min_valid_dist(self):
        fs = self._fs
        return self._min_valid_dist if fs is None else float(fs.dmin[self.id])

    @min_valid_dist.setter
    def min_valid_dist(self, v):
        fs = self._fs
        if fs is None:
            self._min_valid_dist = float(v)
        else:
            fs.dmin[self.id] = v

    @property
    def max_valid_dist(self):
        fs = self._fs
        return self._max_valid_dist if fs is None else float(fs.dmax[self.id])

    @max_valid_dist.setter
    def max_valid_dist(self, v):
        fs = self._fs
        if fs is None:
            self._max_valid_dist = float(v)
        else:
            fs.dmax[self.id] = v

    # ---- observations (mirrored into the native association store) ----
    def add_observation(self, keyfrm_id: int, idx: int):
        self.observations[keyfrm_id] = idx
        store = getattr(self, "_store", None)
        if store is not None:
            store.add(self.id, keyfrm_id, idx)
