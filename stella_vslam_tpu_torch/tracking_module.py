"""Tracking module: the per-frame pose state machine, synchronous subset.

Port of stella_vslam_tpu/tracking_module.py with the behaviour of its
`synchronous` (inline_mapping=True) mode: every frame is dispatched to the
tracking cascade (module/tracking_kernels.py) and finalized before
feed_frame returns. States Initializing -> Tracking -> Lost as in the
reference (tracking_module.cc:153-167); stereo/RGBD initialize from depth in
one frame (`_create_map_for_stereo`).

Not ported yet, and where they come in (ROADMAP Queue 1): the batched result
fetcher and finalize thread of the pipelined mode (item 8), the chain rebase
at a table publish and keyframe insertion (they follow map updates by the
mapping module, item 9), the monocular initializer (item 7) and the
relocalizer (item 13) — a lost frame stays lost.

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
from stella_vslam_tpu_torch.module.keyframe_inserter import KeyframeInserter
from stella_vslam_tpu_torch.module.tracking_kernels import TrackingKernels

_log = logging.getLogger(__name__)

STATE_INITIALIZING = "Initializing"
STATE_TRACKING = "Tracking"
STATE_LOST = "Lost"


class TrackingModule:
    def __init__(self, map_db, camera, orb_params, *, device="cpu",
                 num_matches_thr: int = 10, min_num_tracked_lms: int = 20,
                 margin_last_frame_projection: float = 20.0,
                 margin_local_map_projection: float = 5.0):
        self.map_db = map_db
        self.camera = camera
        self.orb_params = orb_params
        self.device = torch.device(device)
        self.kernels = TrackingKernels(
            camera, orb_params, device=device, num_matches_thr=num_matches_thr,
            margin_last=margin_last_frame_projection,
            margin_local=margin_local_map_projection)
        self.keyfrm_inserter = KeyframeInserter(camera)
        self.num_matches_thr = num_matches_thr
        self.min_num_tracked_lms = min_num_tracked_lms

        self.state = STATE_INITIALIZING
        self.last_frm: Optional[Frame] = None
        self.ref_keyfrm_id: Optional[int] = None
        self.twist: Optional[np.ndarray] = None
        self.mapping_is_enabled = False
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
        dev = self.device
        if self._dev_pose is None and last is not None and last.pose_cw is not None:
            self._dev_pose = (
                torch.as_tensor(last.pose_cw[:3, :3], dtype=torch.float32, device=dev),
                torch.as_tensor(last.pose_cw[:3, 3], dtype=torch.float32, device=dev))
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
        return out, last, tbl.ids

    # ------------------------------------------------------------------
    def _finalize_one(self, frm: Frame, dispatched):
        out, last, tbl_ids = dispatched
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
        ids = frm.lm_ids
        occupied = np.nonzero(ids >= 0)[0]
        if len(occupied) > 1:
            _, first = np.unique(ids[occupied], return_index=True)
            dup = np.setdiff1d(occupied, occupied[first], assume_unique=True)
            ids[dup] = -1
        tbl = self.map_db.device_table
        tbl.bump_observable(flags[n:], tbl_ids)
        tbl.bump_observed(frm.lm_ids)
        prev_pose = last.pose_cw if last is not None else None
        self.twist = frm.pose_cw @ np.linalg.inv(prev_pose) \
            if prev_pose is not None else None

        # reference keyframe: the one sharing the most landmarks with this
        # frame (reference local_map_updater nearest_covisibility)
        valid_lms = frm.lm_ids[frm.lm_ids >= 0]
        if len(valid_lms):
            obs_kfs, obs_cnts = self.map_db.assoc_store.covis_counts(valid_lms, -1)
            if len(obs_kfs):
                b = int(np.argmax(obs_cnts))
                cur_cnt = obs_cnts[obs_kfs == self.ref_keyfrm_id]
                if int(obs_kfs[b]) != self.ref_keyfrm_id and (
                        len(cur_cnt) == 0 or obs_cnts[b] > int(cur_cnt[0])):
                    kf_new = self.map_db.keyframes.get(int(obs_kfs[b]))
                    if kf_new is not None and not kf_new.will_be_erased:
                        self.ref_keyfrm_id = int(obs_kfs[b])
        frm.ref_keyfrm_id = self.ref_keyfrm_id
        self.finalized.append((frm.id, frm.timestamp, frm.pose_cw.copy(),
                               frm.ref_keyfrm_id, self._rel_to_ref(frm)))
        self.last_frm = frm

    def _on_lost(self, frm: Frame):
        self.finalized.append((frm.id, frm.timestamp, None, frm.ref_keyfrm_id, None))
        self.state = STATE_LOST
        self.last_frm = frm
        self.twist = None
        self._last_assoc_pos = None
        self._last_assoc_valid = None
        self._last_assoc_id = None
        self._dev_pose = None
        self._dev_pose_prev = None

    # ------------------------------------------------------------------
    def _set_chain_from_frame(self, frm: Frame):
        """Device association state from a frame's host lm_ids (after init)."""
        n = frm.num_slots
        pos = np.zeros((n, 3), np.float32)
        has = np.zeros(n, bool)
        ids = np.full(n, -1, np.int32)
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
    def _initialize(self, frm: Frame) -> bool:
        if self.camera.setup == Setup.MONOCULAR:
            raise NotImplementedError(
                "the monocular initializer is not ported yet "
                "(ROADMAP Queue 1 item 7)")
        return self._create_map_for_stereo(frm)

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
