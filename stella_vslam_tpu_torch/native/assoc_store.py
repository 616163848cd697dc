"""Python-facing wrapper over the native association store (see native/mapcore.cpp).

Copy of stella_vslam_tpu/native/assoc_store.py bound to this package's build
of the same source."""
from __future__ import annotations

import ctypes

import numpy as np

from stella_vslam_tpu_torch.native.build import load_mapcore

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)


def _p64(a):
    return a.ctypes.data_as(_i64p)


def _p32(a):
    return a.ctypes.data_as(_i32p)


class AssocStore:
    """Landmark <-> keyframe observation store (native). Holds the
    authoritative (lm_id -> [(kf_id, keypoint idx)]) relation consumed by
    covisibility updates and BA assembly."""

    def __init__(self):
        self._lib = load_mapcore()
        self._h = ctypes.c_void_p(self._lib.store_create())

    def __del__(self):
        try:
            self._lib.store_destroy(self._h)
        except Exception:
            pass

    def clear(self):
        self._lib.store_clear(self._h)

    def add(self, lm_id: int, kf_id: int, idx: int):
        self._lib.store_add_obs(self._h, lm_id, kf_id, idx)

    def add_bulk(self, lm_ids: np.ndarray, kf_ids: np.ndarray,
                 idxs: np.ndarray):
        """One native call for a batch of (landmark, keyframe, keypoint)
        observations — the hot bulk paths (triangulation apply, keyframe
        insert) add hundreds per event."""
        lm_ids = np.ascontiguousarray(lm_ids, np.int64)
        kf_ids = np.ascontiguousarray(kf_ids, np.int64)
        idxs = np.ascontiguousarray(idxs, np.int32)
        self._lib.store_add_obs_bulk(
            self._h, _p64(lm_ids), _p64(kf_ids), _p32(idxs), len(lm_ids))

    def erase(self, lm_id: int, kf_id: int) -> int:
        return int(self._lib.store_erase_obs(self._h, lm_id, kf_id))

    def erase_landmark(self, lm_id: int):
        self._lib.store_erase_landmark(self._h, lm_id)

    def num_obs(self, lm_id: int) -> int:
        return int(self._lib.store_num_obs(self._h, lm_id))

    def num_obs_bulk(self, lm_ids: np.ndarray) -> np.ndarray:
        """Observation counts for a batch of landmark ids (-1 -> 0)."""
        lm_ids = np.ascontiguousarray(lm_ids, np.int64)
        out = np.empty(len(lm_ids), np.int32)
        self._lib.store_num_obs_bulk(self._h, _p64(lm_ids), len(lm_ids),
                                     _p32(out))
        return out

    def get_obs(self, lm_id: int, cap: int = 256):
        kf = np.empty(cap, np.int64)
        idx = np.empty(cap, np.int32)
        n = self._lib.store_get_obs(self._h, lm_id, _p64(kf), _p32(idx), cap)
        return kf[:n], idx[:n]

    def covis_counts(self, lm_ids: np.ndarray, self_kf_id: int, cap: int = 4096):
        lm_ids = np.ascontiguousarray(lm_ids, np.int64)
        out_kf = np.empty(cap, np.int64)
        out_cnt = np.empty(cap, np.int32)
        n = self._lib.store_covis_counts(
            self._h, _p64(lm_ids), len(lm_ids), self_kf_id,
            _p64(out_kf), _p32(out_cnt), cap,
        )
        return out_kf[:n], out_cnt[:n]

    def assemble_ba(self, lm_ids: np.ndarray, kf_ids: np.ndarray,
                    kf_slots: np.ndarray, D: int):
        L = len(lm_ids)
        lm_ids = np.ascontiguousarray(lm_ids, np.int64)
        kf_ids = np.ascontiguousarray(kf_ids, np.int64)
        kf_slots = np.ascontiguousarray(kf_slots, np.int32)
        obs_cam = np.empty((L, D), np.int32)
        obs_idx = np.empty((L, D), np.int32)
        obs_valid = np.empty((L, D), np.uint8)
        self._lib.store_assemble_ba(
            self._h, _p64(lm_ids), L, _p64(kf_ids), _p32(kf_slots),
            len(kf_ids), D, _p32(obs_cam), _p32(obs_idx),
            obs_valid.ctypes.data_as(_u8p),
        )
        return obs_cam, obs_idx, obs_valid.astype(bool)

    # ---- per-keyframe registry + batched landmark statistics ----
    def register_keyframe(self, kf_id: int, desc: np.ndarray,
                          level: np.ndarray):
        """Register a keyframe's immutable descriptors [N,8]u32 and octaves
        [N]i32 for batched landmark-statistics refresh."""
        desc = np.ascontiguousarray(desc, np.uint32)
        level = np.ascontiguousarray(level, np.int32)
        self._lib.store_register_keyframe(
            self._h, kf_id, desc.ctypes.data_as(_u32p), _p32(level),
            desc.shape[0],
        )

    def erase_keyframe_data(self, kf_id: int):
        self._lib.store_erase_keyframe_data(self._h, kf_id)

    def count_redundant(self, kf_id: int, lm_ids: np.ndarray,
                        levels: np.ndarray):
        """(num_valid, num_redundant) for keyframe culling
        (reference local_map_cleaner.cc:68-123)."""
        lm_ids = np.ascontiguousarray(lm_ids, np.int64)
        levels = np.ascontiguousarray(levels, np.int32)
        out = (ctypes.c_int32(0), ctypes.c_int32(0))
        self._lib.store_count_redundant(
            self._h, kf_id, _p64(lm_ids), _p32(levels), len(lm_ids),
            ctypes.byref(out[0]), ctypes.byref(out[1]),
        )
        return out[0].value, out[1].value

    def batch_landmark_refresh(self, lm_ids, lm_pos, ref_kf_ids, kf_ids,
                               kf_centers, scale_factors,
                               compute_desc: bool = True):
        """Batched representative-descriptor + mean-normal + scale-range
        computation (reference landmark.cc compute_descriptor /
        update_mean_normal_and_obs_scale_variance) — releases the GIL.
        compute_desc=False skips the descriptor medians (the reference's
        post-BA refresh is update_mean_normal only,
        local_bundle_adjuster_g2o.cc:408).
        Returns (desc [M,8]u32, normal [M,3], dmin [M], dmax [M],
        flags [M]u8: bit0 desc, bit1 normal, bit2 range valid)."""
        M = len(lm_ids)
        lm_ids = np.ascontiguousarray(lm_ids, np.int64)
        lm_pos = np.ascontiguousarray(lm_pos, np.float64)
        ref_kf_ids = np.ascontiguousarray(ref_kf_ids, np.int64)
        kf_ids = np.ascontiguousarray(kf_ids, np.int64)
        kf_centers = np.ascontiguousarray(kf_centers, np.float64)
        scale_factors = np.ascontiguousarray(scale_factors, np.float64)
        out_desc = np.zeros((M, 8), np.uint32)
        out_normal = np.zeros((M, 3), np.float64)
        out_dmin = np.zeros(M, np.float64)
        out_dmax = np.zeros(M, np.float64)
        out_flags = np.zeros(M, np.uint8)
        _dp = ctypes.POINTER(ctypes.c_double)
        self._lib.store_batch_landmark_refresh(
            self._h, _p64(lm_ids), M, lm_pos.ctypes.data_as(_dp),
            _p64(ref_kf_ids), _p64(kf_ids), kf_centers.ctypes.data_as(_dp),
            len(kf_ids), scale_factors.ctypes.data_as(_dp),
            len(scale_factors), 1 if compute_desc else 0,
            out_desc.ctypes.data_as(_u32p),
            out_normal.ctypes.data_as(_dp), out_dmin.ctypes.data_as(_dp),
            out_dmax.ctypes.data_as(_dp), out_flags.ctypes.data_as(_u8p),
        )
        return out_desc, out_normal, out_dmin, out_dmax, out_flags


def median_hamming_descriptor(descs: np.ndarray) -> int:
    """Index of the descriptor minimizing the median Hamming distance
    (reference landmark.cc compute_descriptor)."""
    lib = load_mapcore()
    descs = np.ascontiguousarray(descs, np.uint32)
    return int(
        lib.median_hamming_descriptor(descs.ctypes.data_as(_u32p), len(descs))
    )
