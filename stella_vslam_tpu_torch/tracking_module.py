"""Tracking module: the per-frame pose state machine, synchronous subset.

Port of stella_vslam_tpu/tracking_module.py with the behaviour of its
`synchronous` (inline_mapping=True) mode: every frame is dispatched to the
tracking cascade (module/tracking_kernels.py) and finalized before
feed_frame returns. States Initializing -> Tracking -> Lost as in the
reference (tracking_module.cc:153-167); stereo/RGBD initialize from depth in
one frame (`_create_map_for_stereo`), monocular from two frames through the
Initializer and the two-keyframe map's bundle adjustment
(`_create_map_for_monocular`, `_init_map_ba`).

With mapping enabled (monocular), a finalized frame may become a keyframe
(KeyframeInserter decides and inserts, the mapper's queue takes it, and the
two init keyframes are handed over at initialization); when the mapper has
published a new landmark table since the chain was built, the next frame
re-anchors its chained pose on its reference keyframe's corrected pose and
rebuilds the chained positions from the map (`_resync_chain_with_map`);
a monocular frame lost within 5 s of initialization resets the map.

Not ported yet, and where they come in (ROADMAP Queue 1): the batched result
fetcher and finalize thread of the pipelined mode, with the on-device chain
rebase that only frames in flight need (item 8), and the relocalizer
(item 13) — a lost frame stays lost.

The device-chained association state (positions, validity, landmark ids of
the last frame's inliers) and the chained poses stay on the device between
frames; the host reads one packed result per frame.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import Setup
from stella_vslam_tpu_torch.data.frame import Frame
from stella_vslam_tpu_torch.data.keyframe import Keyframe
from stella_vslam_tpu_torch.data.landmark import Landmark
from stella_vslam_tpu_torch.module.initializer import Initializer
from stella_vslam_tpu_torch.module.keyframe_inserter import KeyframeInserter
from stella_vslam_tpu_torch.module.tracking_kernels import (
    TrackingKernels, make_cam_scalars)
from stella_vslam_tpu_torch.ops.optim import ba as ba_mod

_log = logging.getLogger(__name__)

STATE_INITIALIZING = "Initializing"
STATE_TRACKING = "Tracking"
STATE_LOST = "Lost"


class TrackingModule:
    def __init__(self, map_db, camera, orb_params, *, device="cuda",
                 use_fixed_seed: bool = False,
                 num_matches_thr: int = 10, min_num_tracked_lms: int = 20,
                 margin_last_frame_projection: float = 20.0,
                 margin_local_map_projection: float = 5.0,
                 max_num_local_keyfrms: int = 60):
        self.map_db = map_db
        self.camera = camera
        self.orb_params = orb_params
        self.device = torch.device(device)
        self.kernels = TrackingKernels(
            camera, orb_params, device=device, num_matches_thr=num_matches_thr,
            margin_last=margin_last_frame_projection,
            margin_local=margin_local_map_projection)
        self.initializer = Initializer(camera, orb_params,
                                       use_fixed_seed=use_fixed_seed)
        self.keyfrm_inserter = KeyframeInserter(camera)
        self.num_matches_thr = num_matches_thr
        self.min_num_tracked_lms = min_num_tracked_lms
        # the covisibility neighbourhood of the tracking-visible table
        # (reference Tracking.max_num_local_keyfrms)
        self.max_num_local_keyfrms = max_num_local_keyfrms
        self.mapper = None  # set by System

        self.state = STATE_INITIALIZING
        self.last_frm: Optional[Frame] = None
        self.ref_keyfrm_id: Optional[int] = None
        self.twist: Optional[np.ndarray] = None
        self.mapping_is_enabled = False
        self.last_keyfrm_time = 0.0
        self.init_time = 0.0
        self.num_tracked_lms = 0
        # map sync: the table version the chain was built against, the last
        # frame's pose relative to its reference keyframe and the host pose
        # of the frame before it (for _resync_chain_with_map)
        self._chain_tbl_version = None
        self._last_rel = None
        self._prev_host_pose = None
        # device-chained association + pose state of the last tracked frame
        self._last_assoc_pos = None  # [N,3]
        self._last_assoc_valid = None  # [N]
        self._last_assoc_id = None  # [N] i32 landmark ids
        self._dev_pose = None  # (R_cw, t_cw) of frame t-1
        self._dev_pose_prev = None  # of frame t-2
        # reference-keyframe association arrays
        self._kf_assoc_pos = None
        self._kf_assoc_valid = None
        self._kf_assoc_id = None
        self._kf_for_assoc = None
        # finalized per-frame results: (frame_id, ts, pose_cw|None,
        # ref_kf_id, rel pose to the ref keyframe|None)
        self.finalized = []

    # ------------------------------------------------------------------
    def feed_frame(self, frm: Frame) -> Optional[np.ndarray]:
        """Track `frm`; returns its pose_cw, or None while initializing or
        lost. Per-frame results accumulate in self.finalized."""
        if self.state == STATE_INITIALIZING:
            ok = self._initialize(frm)
            if ok:
                self.state = STATE_TRACKING
                self.init_time = frm.timestamp
                self._set_chain_from_frame(frm)
                self._dev_pose = None
                self._dev_pose_prev = None
            self.last_frm = frm
            self.finalized.append(
                (frm.id, frm.timestamp, frm.pose_cw.copy() if ok else None,
                 frm.ref_keyfrm_id, self._rel_to_ref(frm) if ok else None))
            return frm.pose_cw if ok else None
        if self.state == STATE_LOST:
            self.last_frm = frm
            self.finalized.append((frm.id, frm.timestamp, None, None, None))
            return None
        out = self._dispatch(frm)
        if out is None:
            self.finalized.append((frm.id, frm.timestamp, None, None, None))
            return None
        self._finalize_one(frm, out)
        return frm.pose_cw

    # ------------------------------------------------------------------
    def _dispatch(self, frm: Frame):
        last = self.last_frm
        k = self.kernels
        if self._dev_pose is None and last is not None and last.pose_cw is not None:
            self._dev_pose = self._pose_to_dev(last.pose_cw)
        if self._dev_pose_prev is None:
            self._dev_pose_prev = self._dev_pose
        use_motion = self.twist is not None and self._last_assoc_pos is not None
        ref_kf = self.map_db.keyframes.get(self.ref_keyfrm_id)
        if ref_kf is None:
            self.state = STATE_LOST
            return None
        if self.map_db.device_table.snap is None:
            self.map_db.refresh_device_table()
        tbl = self.map_db.device_table.snap
        if self._chain_tbl_version is not None and self._chain_tbl_version != tbl.version \
                and last is not None and last.pose_cw is not None:
            # the mapper changed the map since the chain was built
            self._resync_chain_with_map(last)
        self._chain_tbl_version = tbl.version
        # the reference keyframe's pose in this table's coordinates: as
        # published, or its creation pose if it is newer than the table
        anchor_pose = tbl.kf_poses.get(self.ref_keyfrm_id)
        if anchor_pose is None:
            anchor_pose = ref_kf._pose_at_creation
        if self._kf_for_assoc is not ref_kf:
            self._refresh_kf_assoc(ref_kf)
        R_last, t_last = self._dev_pose
        R_prev, t_prev = self._dev_pose_prev
        out = k.track_frame(
            frm.undist_xy, frm.feats.level, frm.feats.desc, frm.feats.valid,
            frm.feats.angle, frm.x_right,
            last.feats.desc, last.feats.level, last.feats.angle,
            self._last_assoc_pos, self._last_assoc_valid, self._last_assoc_id,
            ref_kf.feats.desc, ref_kf.feats.angle,
            self._kf_assoc_pos, self._kf_assoc_valid, self._kf_assoc_id,
            tbl.tbl_f32, tbl.tbl_u32, R_last, t_last, R_prev, t_prev,
            use_motion=use_motion, margin_local=k.margin_local)
        # chain device state for the next dispatch
        self._last_assoc_pos = out.assoc_pos
        self._last_assoc_valid = out.assoc_valid
        self._last_assoc_id = out.assoc_id
        self._dev_pose_prev = self._dev_pose
        self._dev_pose = (out.R_cw, out.t_cw)
        return out, last, tbl, self.ref_keyfrm_id, anchor_pose

    # ------------------------------------------------------------------
    def _finalize_one(self, frm: Frame, dispatched):
        out, last, snap, ref_at_dispatch, anchor_pose = dispatched
        n = frm.num_slots
        packed = out.packed.cpu().numpy()  # the packed result, one copy
        pose12 = packed[:12]
        counts = packed[12:16].astype(np.int64)
        lm_ids = packed[16:16 + n].astype(np.int64)
        flags = packed[16 + n:] > 0.5
        num_final = int(counts[3])
        used_fallback = bool(counts[1])

        # (the JAX tracker halves this, and widens the local-map margin, for
        # two frames after a relocalization; that comes with the relocalizer)
        min_needed = self.min_num_tracked_lms
        tracked_ok = num_final >= min_needed
        if used_fallback:
            tracked_ok = tracked_ok and num_final >= self.num_matches_thr
        if not tracked_ok:
            _log.debug("frame %d lost: stage1=%d fallback=%d candidates=%d "
                       "inliers=%d (needed %d)", frm.id, int(counts[0]),
                       int(counts[1]), int(counts[2]), num_final, min_needed)
            self._on_lost(frm)
            return

        T = np.eye(4)
        T[:3, :3] = pose12[:9].reshape(3, 3)
        T[:3, 3] = pose12[9:12]
        frm.set_pose_cw(T)
        frm.lm_ids[:] = self.map_db.resolve_landmark_ids(lm_ids)
        # associations forwarded through fusion since dispatch: when that is
        # most of them, keep the frame's record on its dispatch anchor
        valid_disp = lm_ids >= 0
        n_forwarded = int(np.sum(valid_disp & (frm.lm_ids != lm_ids)))
        gauge_hazard = n_forwarded > 0.2 * max(1, int(np.sum(valid_disp)))
        ids = frm.lm_ids
        occupied = np.nonzero(ids >= 0)[0]
        if len(occupied) > 1:
            _, first = np.unique(ids[occupied], return_index=True)
            dup = np.setdiff1d(occupied, occupied[first], assume_unique=True)
            ids[dup] = -1
        tbl = self.map_db.device_table
        tbl.bump_observable(flags[n:], snap.ids)
        tbl.bump_observed(frm.lm_ids)
        self.num_tracked_lms = num_final
        prev_pose = last.pose_cw if last is not None else None
        self.twist = frm.pose_cw @ np.linalg.inv(prev_pose) \
            if prev_pose is not None else None

        # reference keyframe: the one sharing the most landmarks with this
        # frame (reference local_map_updater nearest_covisibility)
        valid_lms = frm.lm_ids[frm.lm_ids >= 0]
        if len(valid_lms) and not gauge_hazard:
            obs_kfs, obs_cnts = self.map_db.assoc_store.covis_counts(valid_lms, -1)
            if len(obs_kfs):
                b = int(np.argmax(obs_cnts))
                cur_cnt = obs_cnts[obs_kfs == self.ref_keyfrm_id]
                if int(obs_kfs[b]) != self.ref_keyfrm_id and (
                        len(cur_cnt) == 0 or obs_cnts[b] > int(cur_cnt[0])):
                    kf_new = self.map_db.keyframes.get(int(obs_kfs[b]))
                    if kf_new is not None and not kf_new.will_be_erased:
                        self.ref_keyfrm_id = int(obs_kfs[b])
        insert = False
        if self.mapping_is_enabled:
            ref_kf = self.map_db.keyframes.get(self.ref_keyfrm_id)
            # reliable = tracked landmarks with >= min_num_obs_thr
            # observations (tracking_module.cc:143-144)
            min_obs = 3 if self.map_db.num_keyframes() >= 3 else 2
            num_reliable = int((self.map_db.assoc_store.num_obs_bulk(frm.lm_ids)
                                >= min_obs).sum())
            insert = self.keyfrm_inserter.new_keyframe_is_needed(
                self.map_db, frm, num_final, self.last_keyfrm_time, ref_kf,
                num_reliable=num_reliable)
        frm.ref_keyfrm_id = self.ref_keyfrm_id
        # relative pose to the reference keyframe, anchored to that
        # keyframe's pose in the gauge the frame was tracked in (the
        # dispatch table's snapshot, or the creation pose of a newer
        # keyframe), so later refinements of it propagate exactly
        rel = None
        if gauge_hazard and ref_at_dispatch in self.map_db.keyframes:
            frm.ref_keyfrm_id = ref_at_dispatch
            rel = frm.pose_cw @ np.linalg.inv(anchor_pose)
        else:
            ref_pose = snap.kf_poses.get(self.ref_keyfrm_id)
            ref = self.map_db.keyframes.get(self.ref_keyfrm_id)
            if ref_pose is None and ref is not None:
                ref_pose = ref._pose_at_creation \
                    if ref.id > max(snap.kf_poses, default=-1) else ref.pose_cw
            if ref_pose is not None:
                rel = frm.pose_cw @ np.linalg.inv(ref_pose)
        self.finalized.append((frm.id, frm.timestamp, frm.pose_cw.copy(),
                               frm.ref_keyfrm_id, rel))
        self.last_frm = frm
        self._last_rel = rel
        self._prev_host_pose = prev_pose
        if insert:
            self.last_keyfrm_time = frm.timestamp
            kf = self.keyfrm_inserter.insert_new_keyframe(self.map_db, frm)
            self.ref_keyfrm_id = kf.id

    def _on_lost(self, frm: Frame):
        self.finalized.append((frm.id, frm.timestamp, None, frm.ref_keyfrm_id, None))
        if frm.timestamp - self.init_time < 5.0 and self.mapping_is_enabled \
                and self.camera.setup == Setup.MONOCULAR:
            # a monocular map lost this early is not worth keeping
            self.reset()
            return
        self.state = STATE_LOST
        self.last_frm = frm
        self.twist = None
        self._last_assoc_pos = None
        self._last_assoc_valid = None
        self._last_assoc_id = None
        self._dev_pose = None
        self._dev_pose_prev = None
        self._last_rel = None
        self._prev_host_pose = None

    # ------------------------------------------------------------------
    def _resync_chain_with_map(self, last: Frame):
        """Before a dispatch, when the mapper changed the map since the
        chain was built: re-anchor the last frame as its rel pose times its
        reference keyframe's current pose, move the frame before it by the
        same correction (the motion model keeps its twist), and rebuild the
        chained positions from the map (reference update_last_frame,
        tracking_module.cc:433)."""
        ref = self.map_db.keyframes.get(last.ref_keyfrm_id)
        if ref is not None and self._last_rel is not None and self._dev_pose is not None:
            T_l_old = last.pose_cw
            T_l_new = self._last_rel @ ref.pose_cw
            if not np.allclose(T_l_new, T_l_old, atol=1e-12):
                T_p_old = self._prev_host_pose
                T_p_new = (T_p_old @ np.linalg.inv(T_l_old) @ T_l_new
                           if T_p_old is not None else T_l_new)
                last.set_pose_cw(T_l_new)
                self._prev_host_pose = T_p_new
                self._dev_pose = self._pose_to_dev(T_l_new)
                self._dev_pose_prev = self._pose_to_dev(T_p_new)
        self._set_chain_from_frame(last)
        self._kf_for_assoc = None

    def _pose_to_dev(self, T):
        return (torch.as_tensor(T[:3, :3], dtype=torch.float32, device=self.device),
                torch.as_tensor(T[:3, 3], dtype=torch.float32, device=self.device))

    def _set_chain_from_frame(self, frm: Frame):
        """Device association state from a frame's host lm_ids (after init,
        and at a resync), stamped with the table version it reads."""
        n = frm.num_slots
        pos = np.zeros((n, 3), np.float32)
        has = np.zeros(n, bool)
        ids = np.full(n, -1, np.int32)
        version = self.map_db.device_table.version
        frm.lm_ids[:] = self.map_db.resolve_landmark_ids(frm.lm_ids)
        for i in np.nonzero(frm.lm_ids >= 0)[0]:
            lm = self.map_db.landmarks.get(int(frm.lm_ids[i]))
            if lm is None or lm.will_be_erased:
                continue
            pos[i] = lm.pos_w
            has[i] = True
            ids[i] = lm.id
        dev = self.device
        self._last_assoc_pos = torch.from_numpy(pos).to(dev)
        self._last_assoc_valid = torch.from_numpy(has).to(dev)
        self._last_assoc_id = torch.from_numpy(ids).to(dev)
        self._chain_tbl_version = version

    def _refresh_kf_assoc(self, kf: Keyframe):
        n = kf.num_slots
        pos = np.zeros((n, 3), np.float32)
        has = np.zeros(n, bool)
        ids = np.full(n, -1, np.int32)
        fs = self.map_db.fields
        lm_ids = kf.lm_ids
        occ = lm_ids >= 0
        alive = np.zeros(n, bool)
        alive[occ] = fs.alive[lm_ids[occ]]
        pos[alive] = fs.pos[lm_ids[alive]]
        has[alive] = True
        ids[alive] = lm_ids[alive]
        dev = self.device
        self._kf_assoc_pos = torch.from_numpy(pos).to(dev)
        self._kf_assoc_valid = torch.from_numpy(has).to(dev)
        self._kf_assoc_id = torch.from_numpy(ids).to(dev)
        self._kf_for_assoc = kf

    # ------------------------------------------------------------------
    def reset(self):
        """Clear the map and go back to Initializing; the initializer
        restarts too."""
        self.map_db.clear()
        self.initializer.reset()
        self.state = STATE_INITIALIZING
        self.last_frm = None
        self.twist = None
        self.ref_keyfrm_id = None
        self._last_assoc_pos = None
        self._last_assoc_valid = None
        self._last_assoc_id = None
        self._dev_pose = None
        self._dev_pose_prev = None
        self._kf_for_assoc = None
        self._chain_tbl_version = None
        self._last_rel = None
        self._prev_host_pose = None
        if self.mapper is not None:
            self.mapper.cleaner.fresh_landmark_ids = []

    # ------------------------------------------------------------------
    def _initialize(self, frm: Frame) -> bool:
        if self.camera.setup == Setup.MONOCULAR:
            if not self.initializer.try_initialize_monocular(frm):
                return False
            return self._create_map_for_monocular(frm)
        return self._create_map_for_stereo(frm)

    def _create_map_for_monocular(self, cur_frm: Frame) -> bool:
        """The two-keyframe map of a successful initialization: landmarks
        from the triangulated matches, then the init BA. Fewer than 20
        landmarks undo the attempt."""
        init = self.initializer
        ref_frm = init.init_frame
        map_db = self.map_db
        ref_frm.set_pose_cw(np.eye(4))
        T = np.eye(4)
        T[:3, :3] = init.R_21
        T[:3, 3] = init.t_21
        cur_frm.set_pose_cw(T)
        ref_kf = Keyframe(ref_frm, map_db)
        map_db.add_keyframe(ref_kf)
        cur_kf = Keyframe(cur_frm, map_db)
        map_db.add_keyframe(cur_kf)
        matches = init.init_matches
        pts = init.triangulated_pts
        created = 0
        for ref_idx in np.nonzero(init.triangulated_ok)[0]:
            cur_idx = int(matches[ref_idx])
            if cur_idx < 0:
                continue
            lm = Landmark(map_db.next_landmark_id(), pts[ref_idx], cur_kf.id)
            lm.first_keyfrm_id = ref_kf.id
            lm.add_observation(ref_kf.id, int(ref_idx))
            lm.add_observation(cur_kf.id, cur_idx)
            ref_kf.add_landmark(lm.id, int(ref_idx))
            cur_kf.add_landmark(lm.id, cur_idx)
            cur_frm.add_landmark(lm.id, cur_idx)
            map_db.add_landmark(lm)
            lm.compute_descriptor(map_db)
            lm.update_mean_normal_and_obs_scale_variance(map_db)
            created += 1
        if created < 20:
            map_db.clear()
            init.reset()
            return False
        ref_kf.graph_node.update_connections(map_db)
        cur_kf.graph_node.update_connections(map_db)
        self._init_map_ba(ref_kf, cur_kf)
        cur_frm.set_pose_cw(cur_kf.pose_cw)
        self.ref_keyfrm_id = cur_kf.id
        cur_frm.ref_keyfrm_id = cur_kf.id
        self.last_keyfrm_time = cur_frm.timestamp
        map_db.refresh_device_table()
        if self.mapper is not None and self.mapping_is_enabled:
            # with mapping disabled the init pair stays unmapped (the
            # reference's paused mapper never takes them)
            self.mapper.async_add_keyframe(ref_kf)
            self.mapper.async_add_keyframe(cur_kf)
        self.twist = None
        return True

    @staticmethod
    def _init_ba_capacity(num_slots: int) -> int:
        """Landmark rows of the two-keyframe BA: one fixed shape per feature
        budget (the next power of two, at least 64)."""
        return max(64, 1 << int(np.ceil(np.log2(max(num_slots, 2)))))

    def _init_map_ba(self, kf1: Keyframe, kf2: Keyframe):
        """Global BA of the two init keyframes (kf1 fixed) and their
        landmarks, on kernels F, G, H, I; writes back kf2's pose and the
        landmark positions and statistics."""
        map_db = self.map_db
        lm_ids = sorted({int(i) for i in kf1.lm_ids if i >= 0}
                        | {int(i) for i in kf2.lm_ids if i >= 0})
        L = self._init_ba_capacity(kf1.num_slots)
        lm_ids = lm_ids[:L]
        D = 2
        inv_sigma = np.asarray(self.orb_params.inv_level_sigma_sq, np.float32)
        lm_pos = np.zeros((L, 3), np.float32)
        lm_valid = np.zeros(L, bool)
        obs_cam = np.zeros((L, D), np.int32)
        obs_uv = np.zeros((L, D, 2), np.float32)
        obs_w = np.ones((L, D), np.float32)
        obs_valid = np.zeros((L, D), bool)
        slots = {kf1.id: 0, kf2.id: 1}
        kfs = {kf1.id: kf1, kf2.id: kf2}
        for l, lm_id in enumerate(lm_ids):
            lm = map_db.landmarks[lm_id]
            lm_pos[l] = lm.pos_w
            lm_valid[l] = True
            for d, (kf_id, idx) in enumerate(lm.observations.items()):
                if d >= D:
                    break
                kf = kfs[kf_id]
                obs_cam[l, d] = slots[kf_id]
                obs_uv[l, d] = kf.h_undist_xy[idx]
                obs_w[l, d] = inv_sigma[int(kf.h_level[idx])]
                obs_valid[l, d] = True
        dev = self.device
        t = lambda a: torch.from_numpy(a).to(dev)
        prob = ba_mod.BAProblem(
            cam_R=t(np.stack([kf1.rot_cw, kf2.rot_cw]).astype(np.float32)),
            cam_t=t(np.stack([kf1.trans_cw, kf2.trans_cw]).astype(np.float32)),
            cam_fixed=t(np.array([True, False])), cam_valid=t(np.array([True, True])),
            lm_pos=t(lm_pos), lm_valid=t(lm_valid), obs_cam=t(obs_cam),
            obs_uv=t(obs_uv), obs_x_right=t(np.full((L, D), -1.0, np.float32)),
            obs_inv_sigma_sq=t(obs_w), obs_valid=t(obs_valid))
        res = ba_mod.bundle_adjust(prob, make_cam_scalars(self.camera),
                                   model=self.camera.model.name.lower())
        camR, camt = res.cam_R.cpu().numpy(), res.cam_t.cpu().numpy()
        lm_new = res.lm_pos.cpu().numpy()
        T = np.eye(4)
        T[:3, :3] = camR[1]
        T[:3, 3] = camt[1]
        kf2.set_pose_cw(T)
        for l, lm_id in enumerate(lm_ids):
            lm = map_db.landmarks.get(lm_id)
            if lm is not None:
                lm.pos_w = lm_new[l].astype(np.float64)
                lm.update_mean_normal_and_obs_scale_variance(map_db)

    def _create_map_for_stereo(self, cur_frm: Frame) -> bool:
        depths = cur_frm.h_depths
        if (depths > 0).sum() < 50:
            return False
        cur_frm.set_pose_cw(np.eye(4))
        fresh_map = self.map_db.num_keyframes() == 0
        kf = Keyframe(cur_frm, self.map_db)
        self.map_db.add_keyframe(kf)
        if not fresh_map:
            self.map_db.add_spanning_root(kf.id)
        self.keyfrm_inserter._seed_depth_landmarks(self.map_db, kf)
        cur_frm.lm_ids[:] = kf.lm_ids
        kf.graph_node.update_connections(self.map_db)
        self.ref_keyfrm_id = kf.id
        cur_frm.ref_keyfrm_id = kf.id
        self.last_keyfrm_time = cur_frm.timestamp
        self.map_db.refresh_device_table()
        self.twist = None
        return True

    def _rel_to_ref(self, frm: Frame):
        """Relative pose to the reference keyframe, so the exported
        trajectory follows later keyframe refinements."""
        if frm.ref_keyfrm_id is None or frm.pose_cw is None:
            return None
        kf = self.map_db.keyframes.get(frm.ref_keyfrm_id)
        if kf is None or kf.will_be_erased:
            return None
        return frm.pose_cw @ np.linalg.inv(kf.pose_cw)
