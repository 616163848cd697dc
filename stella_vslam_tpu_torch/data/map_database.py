"""Host-side map database + device-resident landmark-table mirror.

Reference: src/stella_vslam/data/map_database.{h,cc} — id->keyframe/landmark
maps behind a global mutex, local landmark cache, pose-proximity queries,
JSON serialization, origin/spanning roots, fixed-keyframe threshold for
temporal mapping.

`DeviceLandmarkTable` is a padded SoA mirror of the live landmarks that the
tracking kernels consume directly; it is refreshed after map mutations,
never uploaded per frame.

Copy of the part of stella_vslam_tpu/data/map_database.py the tracking,
initialization and mapping slices call: the host database and field store,
bulk landmark creation, fusion (`replace_landmark`), landmark and keyframe
erasure (with the trajectory forwarding of culled keyframes), the BA
observation fill (`fill_observation_tables`), and the device table, whose
two packed buffers are torch tensors on the database's device (tbl_f32
[C,8] f32, tbl_u32 [C,10] int32 holding the uint32 bits), published for all
landmarks or for the covisibility neighbourhood of a keyframe. Proximity
queries and serialization come with the relocalization and map-IO items.
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


def fill_observation_tables(map_db, kf_ids, obs_cam, obs_idx, obs_valid,
                            inv_sigma):
    """Per-observation measurements of an [L,D] BA table from the
    keyframes' host keypoint mirrors, one stacked fancy index; returns
    (obs_uv, obs_xr, obs_w). Slots of an erased keyframe, or keyframes with
    different slot counts, take a per-keyframe loop."""
    L, D = obs_cam.shape
    kfs = [map_db.keyframes.get(k) for k in kf_ids]
    slot_counts = {kf.num_slots for kf in kfs if kf is not None}
    if not kfs or any(kf is None for kf in kfs) or len(slot_counts) != 1:
        obs_uv = np.zeros((L, D, 2), np.float32)
        obs_xr = np.full((L, D), -1.0, np.float32)
        obs_w = np.ones((L, D), np.float32)
        for s, kf in enumerate(kfs):
            if kf is None:
                obs_valid[obs_cam == s] = False
                continue
            rows, ds = np.nonzero((obs_cam == s) & obs_valid)
            if len(rows) == 0:
                continue
            idxs = obs_idx[rows, ds]
            obs_uv[rows, ds] = kf.h_undist_xy[idxs]
            obs_xr[rows, ds] = kf.h_x_right[idxs]
            obs_w[rows, ds] = inv_sigma[kf.h_level[idxs]]
        return obs_uv, obs_xr, obs_w
    und = np.stack([kf.h_undist_xy for kf in kfs])
    xr = np.stack([kf.h_x_right for kf in kfs])
    lev = np.stack([kf.h_level for kf in kfs])
    cam = np.clip(obs_cam, 0, len(kfs) - 1)
    idx = np.clip(obs_idx, 0, und.shape[1] - 1)
    v = obs_valid
    obs_uv = np.where(v[..., None], und[cam, idx], 0.0).astype(np.float32)
    obs_xr = np.where(v, xr[cam, idx], -1.0).astype(np.float32)
    lev_safe = np.clip(lev[cam, idx], 0, len(inv_sigma) - 1)
    obs_w = np.where(v, inv_sigma[lev_safe], 1.0).astype(np.float32)
    return obs_uv, obs_xr, obs_w


def stable_unique(arr: np.ndarray) -> np.ndarray:
    """Unique values in first-occurrence order."""
    if len(arr) == 0:
        return arr
    _, first = np.unique(arr, return_index=True)
    return arr[np.sort(first)]


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

    def __init__(self, capacity: Optional[int] = None, device="cuda"):
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

    def refresh(self, landmarks: Dict[int, Landmark], map_db, local_ids=None):
        """Publish the live landmarks (up to the capacity) as a new snap:
        all of them, or `local_ids` in their priority order (rows past the
        capacity are dropped from the back)."""
        self._fold_counters(landmarks)
        fs = map_db.fields
        if local_ids is None:
            sel = np.fromiter(landmarks.keys(), np.int64, len(landmarks))
        else:
            sel = np.asarray(local_ids, np.int64)
        sel = fs.live(sel)
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
                 device_table_capacity: Optional[int] = None, device="cuda"):
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
        # temporal mapping: keyframes with id <= the threshold are frozen
        # (-1: none; set when a loaded map is frozen, which comes with map IO)
        self.fixed_keyframe_id_threshold = -1
        # bumped on clear: a deferred BA writeback carries the epoch it was
        # dispatched under and is dropped on mismatch
        self.epoch = 0
        self.device_table = DeviceLandmarkTable(device_table_capacity, device)
        self.fields = LandmarkFieldStore()
        # erased keyframe id -> (anchor keyframe id, T_erased_from_anchor),
        # captured at erase time: System.frame_poses chains through it, so a
        # frame whose reference keyframe was culled still reconstructs
        self.erased_kf_forward: Dict[int, tuple] = {}
        # landmark replacement tombstones: old id -> surviving id (fusion)
        self.replaced_ids: Dict[int, int] = {}
        # callbacks(kf_id) run when a keyframe is erased (the BoW database)
        self.on_erase_keyframe: list = []
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

    def bulk_add_landmarks(self, ids: np.ndarray, positions: np.ndarray,
                           ref_keyfrm_id: int):
        """Create and register a batch of landmarks with one vectorized
        field-store write (triangulation creates hundreds per event)."""
        with self.lock:
            fs = self.fields
            fs.ensure(int(ids[-1]))
            fs.pos[ids] = positions
            fs.desc[ids] = 0
            fs.normal[ids] = 0.0
            fs.dmin[ids] = 0.0
            fs.dmax[ids] = 0.0
            fs.alive[ids] = True
            out = []
            for i in ids:
                lm = Landmark.create_registered(int(i), ref_keyfrm_id, fs)
                lm._store = self.assoc_store
                self.landmarks[lm.id] = lm
                out.append(lm)
            return out

    def alloc_landmark_ids(self, n: int) -> np.ndarray:
        with self.lock:
            base = self._next_landmark_id
            self._next_landmark_id += n
            return np.arange(base, base + n, dtype=np.int64)

    def replace_landmark(self, old: Landmark, new: Landmark):
        """reference landmark::replace: move `old`'s observations to `new`
        and leave a tombstone old -> new. `new`'s statistics are left to
        the caller's batched refresh."""
        with self.lock:
            if old.id == new.id:
                return
            for kf_id, idx in list(old.observations.items()):
                kf = self.keyframes.get(kf_id)
                if kf is None:
                    continue
                if kf_id not in new.observations:
                    new.add_observation(kf_id, idx)
                    kf.lm_ids[idx] = new.id
                else:
                    kf.lm_ids[idx] = -1
            new.num_observable += old.num_observable
            new.num_observed += old.num_observed
            old.observations = {}
            old.will_be_erased = True
            self.fields.kill(old.id)
            old.replaced_id = new.id
            self.replaced_ids[old.id] = new.id
            self.landmarks.pop(old.id, None)
            self.assoc_store.erase_landmark(old.id)

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

    def erase_landmark(self, lm_id: int):
        with self.lock:
            lm = self.landmarks.pop(lm_id, None)
            if lm is None:
                return
            lm.will_be_erased = True
            self.fields.kill(lm_id)
            for kf_id, idx in lm.observations.items():
                kf = self.keyframes.get(kf_id)
                if kf is not None and kf.lm_ids[idx] == lm_id:
                    kf.lm_ids[idx] = -1
            self.assoc_store.erase_landmark(lm_id)

    def erase_keyframe(self, kf_id: int):
        """Drop a keyframe, its observations and graph edges (a component's
        spanning root cannot be erased), recording its trajectory anchor."""
        with self.lock:
            kf = self.keyframes.get(kf_id)
            if kf is None:
                return
            if kf_id in self.spanning_roots:
                _log.warning("cannot erase spanning root %d", kf_id)
                return
            kf.will_be_erased = True
            # trajectory forwarding to the strongest live covisibility (the
            # culler erases a keyframe because such neighbours cover its
            # view), else the spanning parent
            parent_id = None
            for cand in kf.graph_node.get_covisibilities():
                ckf = self.keyframes.get(cand)
                if ckf is not None and not ckf.will_be_erased:
                    parent_id = cand
                    break
            if parent_id is None:
                parent_id = kf.graph_node.spanning_parent
            if parent_id is not None and parent_id in self.keyframes:
                self.erased_kf_forward[kf_id] = (
                    parent_id, kf.pose_cw @ np.linalg.inv(self.keyframes[parent_id].pose_cw))
            for lm_id in kf.lm_ids[kf.lm_ids >= 0]:
                lm = self.landmarks.get(int(lm_id))
                if lm is not None:
                    lm.erase_observation(kf_id)
            kf.graph_node.erase_all_connections(self)
            kf.graph_node.recompute_spanning_parent_on_erase(self)
            del self.keyframes[kf_id]
            self.assoc_store.erase_keyframe_data(kf_id)
            for cb in self.on_erase_keyframe:
                cb(kf_id)

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

    def last_inserted_keyframe(self):
        with self.lock:
            if not self.keyframes:
                return None
            return self.keyframes[max(self.keyframes.keys())]

    def num_keyframes(self) -> int:
        return len(self.keyframes)

    def num_landmarks(self) -> int:
        return len(self.landmarks)

    # ---- device mirror ----
    def refresh_device_table(self, center_kf_id: Optional[int] = None,
                             max_local_keyframes: int = 60):
        """Publish the device landmark table: every live landmark, or, with
        `center_kf_id`, the covisibility-local map around that keyframe
        (its 1st-order covisibilities, capped, plus their top-10 2nd-order
        neighbours; reference local_map_updater.cc:26-248), nearer
        keyframes' landmarks first."""
        with self.lock:
            local_ids = None
            center = self.keyframes.get(center_kf_id) if center_kf_id is not None else None
            if center is not None:
                kf_ids = [center.id] + center.graph_node.get_covisibilities()[
                    :max_local_keyframes]
                second = []
                for k in kf_ids[1:]:
                    kf = self.keyframes.get(k)
                    if kf is not None:
                        second += kf.graph_node.get_top_n_covisibilities(10)
                arrs = []
                for k in dict.fromkeys(kf_ids + second):
                    kf = self.keyframes.get(k)
                    if kf is None or kf.will_be_erased:
                        continue
                    arrs.append(kf.lm_ids[kf.lm_ids >= 0])
                local_ids = (stable_unique(np.concatenate(arrs)) if arrs
                             else np.zeros(0, np.int64))
            self.device_table.refresh(self.landmarks, self, local_ids=local_ids)

    # ---- reset / serialization ----
    def bump_epoch(self):
        """Invalidate a deferred writeback dispatched before this call."""
        with self.lock:
            self.epoch += 1

    def clear(self):
        with self.lock:
            self.epoch += 1
            self.keyframes.clear()
            self.landmarks.clear()
            self.spanning_roots = []
            self.replaced_ids.clear()
            self.assoc_store.clear()
            self.fields.clear()
            self.erased_kf_forward.clear()
