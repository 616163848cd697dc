"""Host-side map database + device-resident landmark-table mirror.

Reference: src/stella_vslam/data/map_database.{h,cc} — id->keyframe/landmark
maps behind a global mutex, local landmark cache, pose-proximity queries,
JSON serialization, origin/spanning roots, fixed-keyframe threshold for
temporal mapping.

`DeviceLandmarkTable` is a padded SoA mirror of the live landmarks that the
tracking kernels consume directly; it is refreshed after map mutations,
never uploaded per frame.

Copy of the part of stella_vslam_tpu/data/map_database.py the RGBD tracking
slice calls: the host database and field store, and the device table, whose
two packed buffers are torch tensors on the database's device (tbl_f32
[C,8] f32, tbl_u32 [C,10] int32 holding the uint32 bits). Erasure, fusion,
proximity queries, submap roots and serialization come with the mapping,
relocalization and map-IO items.
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.data.keyframe import Keyframe
from stella_vslam_tpu_torch.data.landmark import Landmark

_log = logging.getLogger(__name__)


class LandmarkFieldStore:
    """Contiguous per-landmark field arrays indexed by LANDMARK ID (ids are
    monotone, so id == row; capacity doubles on demand). Landmark objects
    write through their field properties (data/landmark.py); bulk consumers
    — fuse dispatch, BA assembly, device-table publish — read whole id sets
    with ONE fancy index instead of a Python loop over objects."""

    def __init__(self, capacity: int = 1 << 14):
        self._alloc(capacity)

    def _alloc(self, cap: int):
        self.pos = np.zeros((cap, 3), np.float64)
        self.desc = np.zeros((cap, 8), np.uint32)
        self.normal = np.zeros((cap, 3), np.float64)
        self.dmin = np.zeros(cap, np.float64)
        self.dmax = np.zeros(cap, np.float64)
        self.alive = np.zeros(cap, bool)
        self.capacity = cap

    def ensure(self, lm_id: int):
        if lm_id < self.capacity:
            return
        cap = self.capacity
        while cap <= lm_id:
            cap *= 2
        old = (self.pos, self.desc, self.normal, self.dmin, self.dmax,
               self.alive)
        n = old[0].shape[0]
        self._alloc(cap)
        self.pos[:n], self.desc[:n], self.normal[:n] = old[0], old[1], old[2]
        self.dmin[:n], self.dmax[:n], self.alive[:n] = old[3], old[4], old[5]

    def attach(self, lm: Landmark):
        """Move the landmark's fields into its store row (write-through from
        now on via the Landmark properties)."""
        self.ensure(lm.id)
        i = lm.id
        self.pos[i] = lm.pos_w
        self.desc[i] = lm.descriptor
        self.normal[i] = lm.mean_normal
        self.dmin[i] = lm.min_valid_dist
        self.dmax[i] = lm.max_valid_dist
        self.alive[i] = True
        lm._fs = self

    def live(self, lm_ids: np.ndarray) -> np.ndarray:
        """Filter an id array to rows still alive (erased/replaced excluded)."""
        lm_ids = np.asarray(lm_ids, np.int64)
        if len(lm_ids) == 0:
            return lm_ids
        return lm_ids[self.alive[lm_ids]]

    def kill(self, lm_id: int):
        if lm_id < self.capacity:
            self.alive[lm_id] = False

    def clear(self):
        self.alive[:] = False


class TableSnap:
    """One coherent published state of the device landmark table.

    The tracking thread dispatches against whatever snapshot is current at
    the time it reads `DeviceLandmarkTable.snap` — a SINGLE reference read,
    so it can never observe a half-refreshed table even though the mapping
    thread refreshes concurrently without the tracker holding the map lock
    (the reference instead serializes through map_database::mtx_database_,
    map_database.h:268-269; here the tracker is lock-free on the hot path).

    Device state crosses in TWO packed buffers — `tbl_f32` [C,8]
    (pos | normal | min_dist | max_dist) and `tbl_u32` [C,10]
    (desc | ids-as-u32-bits | valid) — unpacked by track_frame.

    `kf_poses`: keyframe poses AS OF this publish (id -> 4x4 pose_cw array
    reference; set_pose_cw rebinds rather than mutating, so these are true
    snapshots), the anchors of the chain rebase that comes with mapping."""

    __slots__ = ("version", "count", "ids", "tbl_f32", "tbl_u32", "kf_poses")

    def __init__(self, version, count, ids, tbl_f32, tbl_u32, kf_poses):
        self.version = version
        self.count = count
        self.ids = ids  # [C] i64 host
        self.tbl_f32 = tbl_f32  # [C,8] f32 device
        self.tbl_u32 = tbl_u32  # [C,10] int32 device (uint32 bits)
        self.kf_poses = kf_poses


class DeviceLandmarkTable:
    """Fixed-capacity device mirror of the live landmark set: one table
    shape for the whole run (the JAX version's compiled programs depend on
    it; the port keeps the same layout), rows beyond capacity truncated."""

    def __init__(self, capacity: Optional[int] = None, device="cpu"):
        self.capacity = 4096 if capacity is None else capacity
        self.device = torch.device(device)
        self.count = 0
        self.version = 0
        # the one published state; swapped atomically by refresh() (see
        # TableSnap). None until the first refresh.
        self.snap: Optional[TableSnap] = None
        # observability counters accumulated by the tracking thread and folded
        # into Landmark objects at refresh. Keyed by LANDMARK ID, not table
        # row: with pipelined tracking, a frame's result can be finalized
        # AFTER the table has been refreshed (rows reordered), so row indices
        # from the frame's dispatch-time layout must be resolved against the
        # dispatch-time ids snapshot the caller passes in.
        # bumps come from the tracker's finalize thread while the mapper
        # thread folds at refresh — guard both sides (an unguarded fold
        # raised "dictionary changed size during iteration" mid-bench and
        # killed the mapper thread)
        self._pend_lock = threading.Lock()
        # flat count arrays indexed by landmark id (grown on demand): the
        # bumps run on every frame finalize as one vectorized fancy-add; the
        # per-id fold loop runs only at refresh
        self._pend_observable = np.zeros(1 << 14, np.int32)
        self._pend_observed = np.zeros(1 << 14, np.int32)

    def _pend_ensure(self, max_id: int):
        if max_id < len(self._pend_observable):
            return
        cap = 1 << int(np.ceil(np.log2(max_id + 1)))
        for name in ("_pend_observable", "_pend_observed"):
            old = getattr(self, name)
            new = np.zeros(cap, np.int32)
            new[: len(old)] = old
            setattr(self, name, new)

    def bump_observable(self, mask: np.ndarray, ids: np.ndarray):
        """`mask` is per-row in the layout described by `ids` (the caller's
        snapshot of self.ids taken when the device program was dispatched).
        Table rows carry unique ids, so a direct fancy-add is exact."""
        n = min(len(mask), len(ids))
        sel = ids[:n][mask[:n]]
        sel = sel[sel >= 0]
        if len(sel) == 0:
            return
        with self._pend_lock:
            self._pend_ensure(int(sel.max()))
            self._pend_observable[sel] += 1

    def bump_observed(self, lm_ids: np.ndarray):
        sel = lm_ids[lm_ids >= 0]
        if len(sel) == 0:
            return
        with self._pend_lock:
            self._pend_ensure(int(sel.max()))
            # finalize dedups slot ids, so indices are unique
            self._pend_observed[sel] += 1

    def _fold_counters(self, landmarks: Dict[int, Landmark]):
        with self._pend_lock:
            pend_able = self._pend_observable
            pend_ed = self._pend_observed
            self._pend_observable = np.zeros_like(pend_able)
            self._pend_observed = np.zeros_like(pend_ed)
        for arr, attr in ((pend_able, "num_observable"),
                          (pend_ed, "num_observed")):
            for lm_id in np.nonzero(arr)[0].tolist():
                lm = landmarks.get(lm_id)
                if lm is not None:
                    setattr(lm, attr, getattr(lm, attr) + int(arr[lm_id]))

    def refresh(self, landmarks: Dict[int, Landmark], map_db):
        """Publish all live landmarks (up to the capacity) as a new snap."""
        self._fold_counters(landmarks)
        fs = map_db.fields
        sel = fs.live(np.fromiter(landmarks.keys(), np.int64, len(landmarks)))
        C = self.capacity
        sel = sel[:C]
        n = len(sel)
        pos = np.zeros((C, 3), np.float32)
        desc = np.zeros((C, 8), np.uint32)
        normal = np.zeros((C, 3), np.float32)
        dmin = np.zeros(C, np.float32)
        dmax = np.zeros(C, np.float32)
        valid = np.zeros(C, bool)
        ids = np.full(C, -1, np.int64)
        # one fancy index per field instead of a Python loop over landmarks
        pos[:n] = fs.pos[sel]
        desc[:n] = fs.desc[sel]
        normal[:n] = fs.normal[sel]
        dmin[:n] = fs.dmin[sel]
        dmax[:n] = fs.dmax[sel]
        valid[:n] = True
        ids[:n] = sel
        self.count = n
        self.version += 1
        # pose snapshot of every live keyframe, coherent with this version
        # (the caller holds map_db.lock; pose arrays are rebound on write so
        # holding references is snapshot-safe)
        kf_poses = {
            kf_id: kf.pose_cw
            for kf_id, kf in map_db.keyframes.items() if not kf.will_be_erased
        }
        # two packed uploads; publication is the single `self.snap = ...`
        f32pack = np.zeros((C, 8), np.float32)
        f32pack[:n, 0:3] = pos[:n]
        f32pack[:n, 3:6] = normal[:n]
        f32pack[:n, 6] = dmin[:n]
        f32pack[:n, 7] = dmax[:n]
        u32pack = np.zeros((C, 10), np.uint32)
        u32pack[:n, :8] = desc[:n]
        u32pack[:, 8] = ids.astype(np.int32).view(np.uint32)
        u32pack[:n, 9] = 1
        self.snap = TableSnap(
            version=self.version,
            count=n,
            ids=ids,
            tbl_f32=torch.from_numpy(f32pack).to(self.device),
            tbl_u32=torch.from_numpy(u32pack.view(np.int32)).to(self.device),
            kf_poses=kf_poses,
        )


class MapDatabase:
    def __init__(self, min_num_shared_lms: int = 15,
                 device_table_capacity: Optional[int] = None, device="cpu"):
        self.lock = threading.RLock()
        self.keyframes: Dict[int, Keyframe] = {}
        self.landmarks: Dict[int, Landmark] = {}
        self._next_keyfrm_id = 0
        self._next_landmark_id = 0
        self.min_num_shared_lms = min_num_shared_lms
        # spanning roots, one per connected map component (reference
        # map_database.h:353 keeps a VECTOR of roots so a loaded map and
        # newly-initialized submaps coexist; graph_node.cc:435
        # get_keyframes_from_root walks one component)
        self.spanning_roots: list = []
        self.device_table = DeviceLandmarkTable(device_table_capacity, device)
        self.fields = LandmarkFieldStore()
        # landmark replacement tombstones: old id -> surviving id (fusion)
        self.replaced_ids: Dict[int, int] = {}
        # native association store (C++ map core, native/mapcore.cpp)
        from stella_vslam_tpu_torch.native.assoc_store import AssocStore

        self.assoc_store = AssocStore()

    # ---- id allocation ----
    def next_keyframe_id(self) -> int:
        i = self._next_keyfrm_id
        self._next_keyfrm_id += 1
        return i

    def next_landmark_id(self) -> int:
        i = self._next_landmark_id
        self._next_landmark_id += 1
        return i

    # ---- mutation ----
    def add_keyframe(self, kf: Keyframe):
        with self.lock:
            self.keyframes[kf.id] = kf
            self.assoc_store.register_keyframe(kf.id, kf.h_desc, kf.h_level)
            if not self.spanning_roots:
                self.spanning_roots.append(kf.id)

    def add_spanning_root(self, kf_id: int):
        """Register a new map component's root (reference
        map_database.cc:102-105)."""
        with self.lock:
            if kf_id not in self.spanning_roots:
                self.spanning_roots.append(kf_id)

    def add_landmark(self, lm: Landmark):
        with self.lock:
            self.landmarks[lm.id] = lm
            lm._store = self.assoc_store
            self.fields.attach(lm)
            for kf_id, idx in lm.observations.items():
                self.assoc_store.add(lm.id, kf_id, idx)

    def batch_refresh_landmark_stats(self, lms, scale_factors,
                                     compute_desc: bool = True):
        """Batched equivalent of per-landmark compute_descriptor +
        update_mean_normal_and_obs_scale_variance, computed in the native
        map core with the GIL released (a keyframe touches thousands of
        landmarks). compute_desc=False refreshes normals/ranges only (the reference's
        post-BA refresh, local_bundle_adjuster_g2o.cc:408)."""
        with self.lock:
            lms = [
                lm for lm in lms
                if lm is not None and not lm.will_be_erased and lm.observations
            ]
            if not lms:
                return
            kfs = [
                kf for kf in self.keyframes.values() if not kf.will_be_erased
            ]
            if not kfs:
                return
            kf_ids = np.array([kf.id for kf in kfs], np.int64)
            centers = np.stack([kf.cam_center for kf in kfs])
            lm_ids = np.array([lm.id for lm in lms], np.int64)
            lm_pos = self.fields.pos[lm_ids]
            ref_ids = np.array([lm.ref_keyfrm_id for lm in lms], np.int64)
            desc, normal, dmin, dmax, flags = \
                self.assoc_store.batch_landmark_refresh(
                    lm_ids, lm_pos, ref_ids, kf_ids, centers, scale_factors,
                    compute_desc=compute_desc)
            # vectorized write-through into the field store (every landmark
            # in self.landmarks is attached)
            fs = self.fields
            m = (flags & 1).astype(bool)
            fs.desc[lm_ids[m]] = desc[m]
            m = (flags & 2).astype(bool)
            fs.normal[lm_ids[m]] = normal[m]
            m = (flags & 4).astype(bool)
            fs.dmin[lm_ids[m]] = dmin[m]
            fs.dmax[lm_ids[m]] = dmax[m]

    def resolve_landmark_id(self, lm_id: int) -> int:
        """Follow the replacement chain to the surviving landmark id;
        returns -1 if the landmark (or its replacement) was erased."""
        seen = 0
        while lm_id in self.replaced_ids and seen < 64:
            lm_id = self.replaced_ids[lm_id]
            seen += 1
        return lm_id if lm_id in self.landmarks else -1

    def resolve_landmark_ids(self, lm_ids: "np.ndarray") -> "np.ndarray":
        """Vectorized resolve for association arrays (-1 passthrough).
        Liveness comes from the field store's alive array, so only the
        (typically handful of) replaced/erased ids walk the chain — this
        runs on every frame finalize."""
        if not self.replaced_ids:
            return lm_ids
        out = lm_ids.copy()
        occ = np.nonzero(lm_ids >= 0)[0]
        if len(occ) == 0:
            return out
        dead = ~self.fields.alive[lm_ids[occ]]
        for i in occ[dead]:
            out[i] = self.resolve_landmark_id(int(lm_ids[i]))
        return out

    def num_keyframes(self) -> int:
        return len(self.keyframes)

    def num_landmarks(self) -> int:
        return len(self.landmarks)

    # ---- device mirror ----
    def refresh_device_table(self):
        """Publish every live landmark to the device table (the JAX version
        can restrict it to a covisibility neighbourhood; that comes with
        the relocalizer and submaps)."""
        with self.lock:
            self.device_table.refresh(self.landmarks, self)

    # ---- reset / serialization ----
    def clear(self):
        with self.lock:
            self.keyframes.clear()
            self.landmarks.clear()
            self.spanning_roots = []
            self.replaced_ids.clear()
            self.assoc_store.clear()
            self.fields.clear()
