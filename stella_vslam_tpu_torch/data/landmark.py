"""Landmark: 3D point with observation bookkeeping.

Reference: src/stella_vslam/data/landmark.{h,cc}. Copy of the part of
stella_vslam_tpu/data/landmark.py the tracking, initialization and mapping
slices call: the store-backed geometric fields, bulk creation
(`create_registered`), observation registration and erasure, the observed
ratio the landmark culler reads, and the per-landmark statistics
`compute_descriptor` (:156) and `update_mean_normal_and_obs_scale_variance`
(:177) (MapDatabase.batch_refresh_landmark_stats refreshes them in bulk).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = np.bitwise_xor(a, b)
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)


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

    @staticmethod
    def create_registered(lm_id: int, ref_keyfrm_id: int, fs) -> "Landmark":
        """Bulk-creation constructor: the caller
        (MapDatabase.bulk_add_landmarks) already wrote the field-store row."""
        lm = Landmark.__new__(Landmark)
        lm._fs = fs
        lm.id = int(lm_id)
        lm.ref_keyfrm_id = int(ref_keyfrm_id)
        lm.observations = {}
        lm.num_observable = 1
        lm.num_observed = 1
        lm.will_be_erased = False
        lm.replaced_id = None
        lm.first_keyfrm_id = int(ref_keyfrm_id)
        lm.num_observations_when_created = 0
        return lm

    # ---- observations (mirrored into the native association store) ----
    def add_observation(self, keyfrm_id: int, idx: int):
        self.observations[keyfrm_id] = idx
        store = getattr(self, "_store", None)
        if store is not None:
            store.add(self.id, keyfrm_id, idx)

    def erase_observation(self, keyfrm_id: int):
        self.observations.pop(keyfrm_id, None)
        store = getattr(self, "_store", None)
        if store is not None:
            store.erase(self.id, keyfrm_id)
        if self.ref_keyfrm_id == keyfrm_id and self.observations:
            self.ref_keyfrm_id = next(iter(self.observations))

    def num_observations(self) -> int:
        return len(self.observations)

    def get_observed_ratio(self) -> float:
        return self.num_observed / max(self.num_observable, 1)

    # ---- statistics (reference landmark.cc) ----
    def compute_descriptor(self, map_db):
        """Representative descriptor: the observation's descriptor with the
        least median Hamming distance to the others."""
        descs = []
        for kf_id, idx in self.observations.items():
            kf = map_db.keyframes.get(kf_id)
            if kf is None or kf.will_be_erased:
                continue
            descs.append(kf.h_desc[idx])
        if not descs:
            return
        D = np.stack(descs)
        if len(D) > 2:
            from stella_vslam_tpu_torch.native.assoc_store import median_hamming_descriptor

            self.descriptor = D[median_hamming_descriptor(D)].copy()
        else:
            medians = np.median(_hamming_np(D[:, None, :], D[None, :, :]), axis=1)
            self.descriptor = D[int(np.argmin(medians))].copy()

    def update_mean_normal_and_obs_scale_variance(self, map_db):
        """Mean viewing direction over the observers, and the valid distance
        range from the reference keyframe's distance and octave."""
        if not self.observations:
            return
        normals = []
        for kf_id in self.observations:
            kf = map_db.keyframes.get(kf_id)
            if kf is None:
                continue
            v = self.pos_w - kf.cam_center
            n = np.linalg.norm(v)
            if n > 1e-9:
                normals.append(v / n)
        if normals:
            m = np.mean(normals, axis=0)
            nm = np.linalg.norm(m)
            self.mean_normal = m / nm if nm > 1e-9 else m
        ref = map_db.keyframes.get(self.ref_keyfrm_id)
        idx = self.observations.get(self.ref_keyfrm_id)
        if ref is None or idx is None:
            return
        dist = float(np.linalg.norm(self.pos_w - ref.cam_center))
        p = ref.orb_params
        self.max_valid_dist = dist * p.scale_factors[int(ref.h_level[idx])]
        self.min_valid_dist = self.max_valid_dist / p.scale_factors[p.num_levels - 1]
