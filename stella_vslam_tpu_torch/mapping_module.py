"""Mapping module: the keyframe consumer that builds and refines the map.

Port of the synchronous (inline) subset of stella_vslam_tpu/mapping_module.py
(reference src/stella_vslam/mapping_module.cc). `mapping_with_new_keyframe`
runs one keyframe event to its end on the caller's thread, with the JAX
version's order of steps:

1. settle the previous event's BA (nothing is pending in this mode), queue
   the new keyframe's landmarks for the event's one stats refresh, cull
   fresh landmarks whose observed ratio fell below 0.3 (local_map_cleaner);
2. triangulate against up to 5 covisible neighbours that pass the baseline
   check, in one call of MappingKernels.triangulate (kernels J and K);
3. collect both fusion directions (the new keyframe's landmarks into its
   first- and second-order covisibilities, theirs into it) in chunks of 16
   keyframes x 2048 landmarks and run MappingKernels.fuse (kernel L) on
   each, all before the triangulation is applied, so fresh landmarks are
   fused one keyframe late, at the next event;
4. apply the triangulation (new landmarks, two observations each) and the
   fusions (add or replace), update the covisibility graph;
5. local BA (more than 2 keyframes): the new keyframe and its strongest
   covisibilities (at most `ba_local_cap`) move, their other observers up
   to 16 cameras anchor the gauge; K = 16, L in {2048, 4096, 8192}, D = 12,
   `ba_iters` LM iterations (3 robust, 6 plain) on kernels F-I; outlier
   observations are erased and landmarks left with one observation culled;
6. cull redundant keyframes (90% of their landmarks seen at the same or a
   finer octave by 3 others), refresh the stats of every touched landmark
   in one native call, and publish the covisibility-local device table
   around the new keyframe (the BA writeback publishes it when BA ran).

Left out (ROADMAP Queue 1): the mapping thread with its event and BA fetch
pools and warm-up (item 10), the BoW transform and the global-optimizer
hook (item 11), `remove_temporal_keyframes` (it acts only on a frozen
loaded map, item 10's map IO) and marker rows. It reads no environment
variable: the JAX version's SVT_BA_ITERS and SVT_BA_LOCAL_CAP defaults are
constructor arguments, and its stride thinning does not apply inline.
"""
from __future__ import annotations

import logging
import time
from collections import deque

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import Setup
from stella_vslam_tpu_torch.data.keyframe import Keyframe
from stella_vslam_tpu_torch.data.map_database import fill_observation_tables, stable_unique
from stella_vslam_tpu_torch.module.local_map_cleaner import LocalMapCleaner
from stella_vslam_tpu_torch.module.mapping_kernels import (
    FuseKeyframes, MappingKernels, TriKeyframe)
from stella_vslam_tpu_torch.module.tracking_kernels import make_cam_scalars
from stella_vslam_tpu_torch.ops.optim import ba as ba_mod

_log = logging.getLogger(__name__)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MappingModule:
    # one fuse call covers KF_CHUNK keyframes x LM_CHUNK landmarks
    FUSE_KF_CHUNK = 16
    FUSE_LM_CHUNK = 2048
    TRI_NEIGHBOURS = 5
    BA_L_BUCKETS = (2048, 4096, 8192)
    # padded camera counts of the local problem; kernel G holds 6K <= 192
    BA_K_BUCKETS = (16, 32)
    BA_D = 12  # observations per landmark row of the local problem
    # queued keyframes at which local BA is skipped (reference
    # mapping_module.cc is_skipping_localBA)
    QUEUE_THRESHOLD = 2

    def __init__(self, map_db, camera, orb_params, *, device="cuda",
                 num_covisibilities_for_triangulation: int = 10,
                 num_covisibilities_for_landmark_fusion: int = 10,
                 max_num_local_keyfrms: int = 60,
                 baseline_dist_thr_ratio: float = 0.01, baseline_dist_thr=None,
                 ba_iters=(3, 6), ba_local_cap: int = 10):
        if camera.setup != Setup.MONOCULAR:
            raise NotImplementedError(
                "mapping of stereo and RGBD keyframes is not ported yet "
                "(ROADMAP Queue 1 item 14)")
        if not 0 < ba_local_cap < self.BA_K_BUCKETS[-1]:
            raise ValueError(f"ba_local_cap must be in [1, {self.BA_K_BUCKETS[-1] - 1}]")
        self.map_db = map_db
        self.camera = camera
        self.orb_params = orb_params
        self.device = torch.device(device)
        self.kernels = MappingKernels(camera, orb_params, device=self.device)
        self.cleaner = LocalMapCleaner()
        self.num_covis_tri = num_covisibilities_for_triangulation
        self.num_covis_fuse = num_covisibilities_for_landmark_fusion
        self.max_num_local_keyfrms = max_num_local_keyfrms
        # mono parallax gate for triangulation neighbours: skip one when
        # baseline / median depth < ratio, or baseline < the absolute
        # threshold when one is configured (mapping_module.cc:36-46, 286-300)
        self.baseline_dist_thr_ratio = baseline_dist_thr_ratio
        self.baseline_dist_thr = baseline_dist_thr
        self.ba_iters = tuple(ba_iters)
        self.ba_local_cap = ba_local_cap
        self.cam_scalars = make_cam_scalars(camera)
        self._queue = deque()
        self._pending_ba = None
        self._fresh_fuse = None
        self._dirty_stats = {}
        # accounting: local BA wall ms (assembly to writeback and publish),
        # and per keyframe event its phases in ms
        self.local_ba_ms = []
        self.event_ms = []

    # ------------------------------------------------------------------ API
    def async_add_keyframe(self, kf: Keyframe):
        self._queue.append(kf)

    def is_skipping_localBA(self) -> bool:
        return len(self._queue) >= self.QUEUE_THRESHOLD

    def drain(self):
        """Run every queued keyframe's event (System calls this after each
        feed)."""
        while self._queue:
            self.mapping_with_new_keyframe(self._queue.popleft())

    # ------------------------------------------------------------------
    def mapping_with_new_keyframe(self, cur: Keyframe):
        """One keyframe event, run to its end."""
        self._event_finish(self._event_start(cur))

    def _event_start(self, cur: Keyframe):
        """Steps 1-3: cull, triangulate, fuse (the device work), each ended
        by the read of its results."""
        map_db = self.map_db
        self.apply_pending_ba()
        self._fresh_fuse = None
        t0 = time.perf_counter()
        for i in cur.lm_ids[cur.lm_ids >= 0].tolist():
            lm = map_db.landmarks.get(i)
            if lm is not None:
                self._dirty_stats[i] = lm
        self.cleaner.remove_invalid_landmarks(map_db, cur.id)
        t1 = time.perf_counter()
        tri = self._dispatch_triangulation(cur)
        if tri is not None:
            res, nbrs = tri
            tri = (nbrs, res.ok.cpu().numpy(), res.pos_w.cpu().numpy(),
                   res.idx2.cpu().numpy())
        t2 = time.perf_counter()
        chunks = self._collect_fuse_chunks(cur)
        chunks = [c[:4] + (c[4].cpu().numpy(), c[5].cpu().numpy()) for c in chunks]
        t3 = time.perf_counter()
        return {"kf": cur, "tri": tri, "fuse_chunks": chunks,
                "ms": {"cull": (t1 - t0) * 1e3, "triangulation": (t2 - t1) * 1e3,
                       "fusion": (t3 - t2) * 1e3}}

    def _event_finish(self, ev):
        """Steps 4-6: apply, local BA, cull keyframes, publish."""
        cur: Keyframe = ev["kf"]
        map_db = self.map_db
        ms = ev["ms"]
        t0 = time.perf_counter()
        if ev["tri"] is not None:
            self._apply_triangulation(cur, *ev["tri"])
        touched = []
        with map_db.lock:
            for lms, kf_chunk, m0, msz, best, acc in ev["fuse_chunks"]:
                self._apply_fuse_chunk(map_db, kf_chunk, lms, m0, msz, best, acc, touched)
            self._dirty_stats.update((lm.id, lm) for lm in touched)
        cur.graph_node.update_connections(map_db)
        t1 = time.perf_counter()
        published = False
        ms["local_ba"] = 0.0
        if map_db.num_keyframes() > 2 and not self.is_skipping_localBA():
            self._dispatch_local_ba(cur)
            published = self.apply_pending_ba()
        t2 = time.perf_counter()
        self.cleaner.remove_redundant_keyframes(map_db, cur)
        self._flush_dirty_stats()
        if not published:
            map_db.refresh_device_table(center_kf_id=cur.id,
                                        max_local_keyframes=self.max_num_local_keyfrms)
        t3 = time.perf_counter()
        ms.update(apply=(t1 - t0) * 1e3, local_ba=(t2 - t1) * 1e3,
                  cull_publish=(t3 - t2) * 1e3)
        ms["total"] = sum(ms.values())
        self.event_ms.append(ms)
        _log.debug("kf %d mapped: %s", cur.id,
                   " ".join(f"{k}={v:.1f}" for k, v in ms.items()))

    # ------------------------------------------------------------------
    def _flush_dirty_stats(self):
        """One landmark-stats refresh for everything the event touched."""
        if not self._dirty_stats:
            return
        dirty, self._dirty_stats = self._dirty_stats, {}
        with self.map_db.lock:
            lms = [lm for lm in dirty.values() if self.map_db.landmarks.get(lm.id) is lm]
            self.map_db.batch_refresh_landmark_stats(lms, self.orb_params.scale_factors)

    # ------------------------------------------------------------------
    def _dispatch_triangulation(self, cur: Keyframe):
        """Kernels J and K against the top covisibilities that pass the
        baseline check (mapping_module.cc:275-341); returns (device result,
        neighbours) or None."""
        map_db = self.map_db
        covis = cur.graph_node.get_top_n_covisibilities(self.num_covis_tri)
        if not covis:
            return None
        median_depth = cur.compute_median_depth(map_db)
        neighbors = []
        for other_id in covis:
            other = map_db.keyframes.get(other_id)
            if other is None or other.will_be_erased:
                continue
            baseline = np.linalg.norm(cur.cam_center - other.cam_center)
            if self.baseline_dist_thr is not None:
                if baseline < self.baseline_dist_thr:
                    continue
            elif median_depth > 0 and baseline / median_depth < self.baseline_dist_thr_ratio:
                continue
            neighbors.append(other)
        if not neighbors:
            return None
        B = self.TRI_NEIGHBOURS
        neighbors = neighbors[:B]
        padded = neighbors + [neighbors[0]] * (B - len(neighbors))
        N = cur.num_slots
        unassoc = np.zeros((B + 1, N), bool)
        stereo = np.zeros((B + 1, N), bool)
        poses = np.zeros((B + 1, 12), np.float32)
        for i, kf in enumerate([cur] + padded):
            unassoc[i] = (kf.lm_ids < 0) & kf.h_valid
            stereo[i] = kf.h_x_right > 0
            poses[i, :9] = kf.rot_cw.reshape(9)
            poses[i, 9:12] = kf.trans_cw
        dev = self.device
        unassoc = torch.from_numpy(unassoc).to(dev)
        stereo = torch.from_numpy(stereo).to(dev)
        poses = torch.from_numpy(poses).to(dev)
        pair_valid = torch.arange(B, device=dev) < len(neighbors)

        def fields(kfs):
            return [torch.stack(x) for x in zip(*[
                (k.undist_xy, k.feats.level, k.feats.desc, k.bearings, k.feats.angle)
                for k in kfs])]

        uv, lvl, desc, bear, ang = fields(padded)
        nbrs = TriKeyframe(uv, lvl, desc, bear, ang, unassoc[1:], stereo[1:])
        c = TriKeyframe(cur.undist_xy, cur.feats.level, cur.feats.desc, cur.bearings,
                        cur.feats.angle, unassoc[0], stereo[0])
        return self.kernels.triangulate(c, nbrs, poses, pair_valid), neighbors

    def _apply_triangulation(self, cur: Keyframe, neighbors, ok_all, pos_all, idx2_all):
        """New landmarks per neighbour, in neighbour order so later
        neighbours see earlier claims (the reference's order)."""
        map_db = self.map_db
        new_lms = []
        with map_db.lock:
            for b, other in enumerate(neighbors):
                ok = ok_all[b]
                if not ok.any():
                    continue
                idx2 = idx2_all[b]
                sel = ok & (cur.lm_ids < 0)
                sel &= other.lm_ids[np.clip(idx2, 0, other.num_slots - 1)] < 0
                idxs = np.nonzero(sel)[0]
                if len(idxs) == 0:
                    continue
                # two slots can match the same neighbour keypoint: keep the first
                _, first = np.unique(idx2[idxs], return_index=True)
                idxs = idxs[np.sort(first)]
                oidx = idx2[idxs]
                ids = map_db.alloc_landmark_ids(len(idxs))
                lms = map_db.bulk_add_landmarks(ids, pos_all[b][idxs], cur.id)
                cur.lm_ids[idxs] = ids
                other.lm_ids[oidx] = ids
                map_db.assoc_store.add_bulk(
                    np.repeat(ids, 2),
                    np.tile(np.array([cur.id, other.id], np.int64), len(ids)),
                    np.stack([idxs, oidx], axis=1).ravel())
                cid, oid = cur.id, other.id
                for lm, fi, oi in zip(lms, idxs.tolist(), oidx.tolist()):
                    lm.observations = {cid: fi, oid: oi}
                self.cleaner.fresh_landmark_ids.extend(ids.tolist())
                new_lms.extend(lms)
            self._dirty_stats.update((lm.id, lm) for lm in new_lms)
        if new_lms:
            self._fresh_fuse = (cur, [lm.id for lm in new_lms])

    def settle_fresh_fuse(self):
        """Fuse the last event's fresh landmarks into that keyframe's
        covisibilities: on the hot path the next event's second fusion
        direction covers them; at shutdown there is no next event."""
        pend, self._fresh_fuse = self._fresh_fuse, None
        if pend is None:
            return
        cur, lm_ids = pend
        map_db = self.map_db
        targets = cur.graph_node.get_top_n_covisibilities(10)
        tgt_kfs = [map_db.keyframes[t] for t in targets if t in map_db.keyframes]
        live = map_db.fields.live(np.asarray(lm_ids, np.int64))
        if not tgt_kfs or not len(live):
            return
        touched = []
        with map_db.lock:
            for lms, kf_chunk, m0, msz, best, acc in self._dispatch_fuse(tgt_kfs, live):
                self._apply_fuse_chunk(map_db, kf_chunk, lms, m0, msz, best.cpu().numpy(),
                                       acc.cpu().numpy(), touched)
            map_db.batch_refresh_landmark_stats(touched, self.orb_params.scale_factors)

    # ------------------------------------------------------------------
    def _collect_fuse_chunks(self, cur: Keyframe):
        """Both fusion directions (mapping_module.cc:417-537); direction 2's
        candidates are collected before direction 1 is applied, and a
        landmark that direction 1 replaces is skipped at apply time."""
        map_db = self.map_db
        targets = cur.graph_node.get_top_n_covisibilities(self.num_covis_fuse)
        seconds = []
        for t in targets:
            kf = map_db.keyframes.get(t)
            if kf:
                seconds.extend(kf.graph_node.get_top_n_covisibilities(5))
        fuse_targets = [t for t in dict.fromkeys(targets + seconds) if t != cur.id]
        tgt_kfs = [map_db.keyframes[t] for t in fuse_targets if t in map_db.keyframes]
        cur_ids = map_db.fields.live(cur.lm_ids[cur.lm_ids >= 0])
        tgt_ids = np.zeros(0, np.int64)
        if tgt_kfs:
            cat = np.concatenate([kf.lm_ids for kf in tgt_kfs])
            tgt_ids = map_db.fields.live(np.unique(cat[cat >= 0]))
        chunks1 = self._dispatch_fuse(tgt_kfs, cur_ids) if len(cur_ids) else []
        chunks2 = self._dispatch_fuse([cur], tgt_ids) if len(tgt_ids) else []
        return chunks1 + chunks2

    def _dispatch_fuse(self, keyframes, lm_ids: np.ndarray):
        """Kernel L over (keyframes x lm_ids) in chunks of 16 x 2048; returns
        records (lm_ids, kf_chunk, m0, msz, best_idx, accepted) with device
        results."""
        lm_ids = np.asarray(lm_ids, np.int64)
        keyframes = [kf for kf in keyframes if kf is not None and not kf.will_be_erased]
        if len(lm_ids) == 0 or not keyframes:
            return []
        KC, MC = self.FUSE_KF_CHUNK, self.FUSE_LM_CHUNK
        fs = self.map_db.fields
        dev = self.device
        M = len(lm_ids)
        n_pad = -M % MC
        lm_f = np.zeros((M + n_pad, 8), np.float32)
        lm_f[:M, 0:3] = fs.pos[lm_ids]
        lm_f[:M, 3] = fs.dmin[lm_ids]
        lm_f[:M, 4] = fs.dmax[lm_ids]
        lm_f[:M, 5:8] = fs.normal[lm_ids]
        lm_desc = np.zeros((M + n_pad, 8), np.uint32)
        lm_desc[:M] = fs.desc[lm_ids]
        lm_f = torch.from_numpy(lm_f).to(dev)
        lm_desc = torch.from_numpy(lm_desc.view(np.int32)).to(dev)
        lm_valid = torch.arange(M + n_pad, device=dev) < M
        chunks = []
        for k0 in range(0, len(keyframes), KC):
            kf_chunk = keyframes[k0:k0 + KC]
            padded = kf_chunk + [kf_chunk[0]] * (KC - len(kf_chunk))
            kfs = FuseKeyframes(*[torch.stack(x) for x in zip(*[
                (k.undist_xy, k.feats.level, k.feats.desc, k.feats.valid, k.x_right)
                for k in padded])])
            poses = np.zeros((KC, 12), np.float32)
            for i, kf in enumerate(padded):
                poses[i, :9] = kf.rot_cw.reshape(9)
                poses[i, 9:12] = kf.trans_cw
            poses = torch.from_numpy(poses).to(dev)
            batch_valid = torch.arange(KC, device=dev) < len(kf_chunk)
            for m0 in range(0, M, MC):
                sl = slice(m0, m0 + MC)
                best, acc = self.kernels.fuse(kfs, poses, batch_valid, lm_f[sl],
                                              lm_desc[sl], lm_valid[sl])
                chunks.append((lm_ids, kf_chunk, m0, min(MC, M - m0), best, acc))
        return chunks

    def _apply_fuse_chunk(self, map_db, keyframes, lm_ids, m0, msz, best_all, acc_all,
                          touched):
        """Accepted matches split into add and replace groups; only those
        run landmark bookkeeping."""
        fs = map_db.fields
        for b, kf in enumerate(keyframes):
            acc = acc_all[b][:msz]
            if not acc.any():
                continue
            rows = np.nonzero(acc)[0]
            cand = np.asarray(lm_ids[m0 + rows], np.int64)
            alive = fs.alive[cand]
            rows, cand = rows[alive], cand[alive]
            if len(rows) == 0:
                continue
            kps = best_all[b][rows].astype(np.int64)
            _, first = np.unique(kps, return_index=True)
            keep = np.sort(first)
            cand, kps = cand[keep], kps[keep]
            existing = kf.lm_ids[kps]
            addm = existing < 0
            repm = (existing >= 0) & (existing != cand)
            add_lm, add_kp = [], []
            for lm_id, kp in zip(cand[addm].tolist(), kps[addm].tolist()):
                lm = map_db.landmarks.get(lm_id)
                if lm is None or lm.will_be_erased or kf.id in lm.observations:
                    # observed in this keyframe at another slot (fuse.cc
                    # is_observed_in_keyframe)
                    continue
                lm.observations[kf.id] = kp
                kf.add_landmark(lm_id, kp)
                touched.append(lm)
                add_lm.append(lm_id)
                add_kp.append(kp)
            if add_lm:
                map_db.assoc_store.add_bulk(
                    np.asarray(add_lm, np.int64), np.full(len(add_lm), kf.id, np.int64),
                    np.asarray(add_kp, np.int32))
            for lm_id, kp, ex in zip(cand[repm].tolist(), kps[repm].tolist(),
                                     existing[repm].tolist()):
                lm = map_db.landmarks.get(lm_id)
                if lm is None or lm.will_be_erased:
                    continue
                other = map_db.landmarks.get(int(ex))
                if other is None or other.will_be_erased:
                    kf.lm_ids[kp] = -1
                elif other.num_observations() >= lm.num_observations():
                    map_db.replace_landmark(lm, other)
                    touched.append(other)
                else:
                    map_db.replace_landmark(other, lm)
                    touched.append(lm)

    # ------------------------------------------------------------------
    def _dispatch_local_ba(self, cur: Keyframe):
        """Assemble the local problem and run bundle_adjust (kernels F-I on
        the card); the writeback is apply_pending_ba."""
        t0 = time.perf_counter()
        prob, lm_ids, kf_slots, host = self._assemble_local_ba(cur)
        if prob is None:
            return
        res = ba_mod.bundle_adjust(prob, self.cam_scalars,
                                   model=self.camera.model.name.lower(),
                                   num_first=self.ba_iters[0], num_second=self.ba_iters[1])
        self._pending_ba = {"res": res, "lm_ids": lm_ids, "kf_slots": kf_slots,
                            "host": host, "center": cur.id, "epoch": self.map_db.epoch,
                            "t0": t0}

    def apply_pending_ba(self) -> bool:
        """Write back the pending local BA (poses of the free keyframes,
        landmark positions, outlier observations erased) and publish the
        device table. Returns True when it did."""
        p, self._pending_ba = self._pending_ba, None
        if p is None or p["epoch"] != self.map_db.epoch:
            return False
        map_db = self.map_db
        res = p["res"]
        camR, camt = res.cam_R.cpu().numpy(), res.cam_t.cpu().numpy()
        lm_new, outlier = res.lm_pos.cpu().numpy(), res.obs_is_outlier.cpu().numpy()
        lm_ids, kf_slots, host = p["lm_ids"], p["kf_slots"], p["host"]
        obs_cam, obs_valid, cam_fixed = host["obs_cam"], host["obs_valid"], host["cam_fixed"]
        with map_db.lock:
            for slot, kf_id in enumerate(kf_slots):
                if kf_id < 0:
                    continue
                kf = map_db.keyframes.get(kf_id)
                if kf is None or bool(cam_fixed[slot]):
                    continue
                T = np.eye(4)
                T[:3, :3] = camR[slot]
                T[:3, 3] = camt[slot]
                kf.set_pose_cw(T)
            ids = np.asarray(lm_ids, np.int64)
            rows = np.nonzero(ids >= 0)[0]
            rows = rows[map_db.fields.alive[ids[rows]]]
            live_ids = ids[rows]
            map_db.fields.pos[live_ids] = lm_new[rows].astype(np.float64)
            # erase the outlier observations (local_bundle_adjuster_g2o.cc:377-399)
            kf_slots_arr = np.asarray(kf_slots, np.int64)
            pruned = set()
            o_rows, o_d = np.nonzero(outlier & obs_valid)
            for l, d in zip(o_rows.tolist(), o_d.tolist()):
                lm_id = int(ids[l])
                lm = map_db.landmarks.get(lm_id)
                if lm is None or lm.will_be_erased:
                    continue
                kf_slot = int(obs_cam[l, d])
                kf_id = int(kf_slots_arr[kf_slot]) if kf_slot < len(kf_slots_arr) else -1
                kf = map_db.keyframes.get(kf_id)
                if kf is None:
                    continue
                idx = lm.observations.get(kf_id)
                if idx is not None:
                    lm.erase_observation(kf_id)
                    kf.erase_landmark_with_index(idx)
                if lm.num_observations() < 2:
                    map_db.erase_landmark(lm_id)
                    pruned.add(lm_id)
            moved = [map_db.landmarks[i] for i in live_ids.tolist()
                     if i not in pruned and i in map_db.landmarks]
            # normals and ranges only (local_bundle_adjuster_g2o.cc:408)
            map_db.batch_refresh_landmark_stats(moved, self.orb_params.scale_factors,
                                                compute_desc=False)
        map_db.refresh_device_table(center_kf_id=p["center"],
                                    max_local_keyframes=self.max_num_local_keyfrms)
        self.local_ba_ms.append((time.perf_counter() - p["t0"]) * 1e3)
        return True

    def _assemble_local_ba(self, cur: Keyframe):
        """The padded local problem on the device, with the host arrays
        the writeback needs."""
        map_db = self.map_db
        local_ids = [cur.id] + cur.graph_node.get_covisibilities()
        # the strongest covisibilities only, so the problem stays K = 16
        local_ids = [i for i in local_ids
                     if i in map_db.keyframes and not map_db.keyframes[i].will_be_erased
                     ][:self.ba_local_cap]
        local_set = set(local_ids)
        cat = np.concatenate([map_db.keyframes[k].lm_ids for k in local_ids])
        cat = cat[cat >= 0]
        lm_ids = map_db.fields.live(stable_unique(cat))
        if len(lm_ids) < 8 or len(local_ids) < 2:
            return None, None, None, None
        L = next((b for b in self.BA_L_BUCKETS if len(lm_ids) <= b), self.BA_L_BUCKETS[-1])
        lm_ids = [int(i) for i in lm_ids[:L]]
        # fixed keyframes: the other observers of the local landmarks,
        # strongest first, filling the smallest bucket above the cap
        obs_kf, cnt = map_db.assoc_store.covis_counts(np.asarray(lm_ids, np.int64), -1)
        target = next(b for b in self.BA_K_BUCKETS if self.ba_local_cap < b)
        budget = target - len(local_ids)
        fixed_ids = []
        for i in np.argsort(-cnt):
            k = int(obs_kf[i])
            if k not in local_set:
                fixed_ids.append(k)
                if len(fixed_ids) >= budget:
                    break
        kf_slots = local_ids + fixed_ids
        K = next(b for b in self.BA_K_BUCKETS if len(kf_slots) <= b)
        D = self.BA_D
        cam_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        cam_t = np.zeros((K, 3), np.float32)
        cam_fixed = np.ones(K, bool)
        cam_valid = np.zeros(K, bool)
        for s, kf_id in enumerate(kf_slots):
            kf = map_db.keyframes[kf_id]
            cam_R[s] = kf.rot_cw
            cam_t[s] = kf.trans_cw
            cam_valid[s] = True
            cam_fixed[s] = (kf_id in fixed_ids or kf_id in map_db.spanning_roots
                            or kf_id <= map_db.fixed_keyframe_id_threshold)
        # gauge: with nothing fixed, the oldest local keyframe is
        if not cam_fixed[:len(kf_slots)].any():
            cam_fixed[int(np.argmin(kf_slots))] = True
        lm_pos = np.zeros((L, 3), np.float32)
        lm_valid = np.zeros(L, bool)
        nl = len(lm_ids)
        lm_pos[:nl] = map_db.fields.pos[np.asarray(lm_ids, np.int64)]
        lm_valid[:nl] = True
        lm_ids_arr = np.asarray(lm_ids + [-1] * (L - nl), np.int64)
        obs_cam, obs_idx, obs_valid = map_db.assoc_store.assemble_ba(
            lm_ids_arr, np.asarray(kf_slots, np.int64),
            np.arange(len(kf_slots), dtype=np.int32), D)
        inv_sigma = np.asarray(self.orb_params.inv_level_sigma_sq, np.float32)
        obs_uv, obs_xr, obs_w = fill_observation_tables(
            map_db, kf_slots, obs_cam, obs_idx, obs_valid, inv_sigma)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        prob = ba_mod.BAProblem(
            cam_R=t(cam_R), cam_t=t(cam_t), cam_fixed=t(cam_fixed), cam_valid=t(cam_valid),
            lm_pos=t(lm_pos), lm_valid=t(lm_valid), obs_cam=t(obs_cam), obs_uv=t(obs_uv),
            obs_x_right=t(obs_xr), obs_inv_sigma_sq=t(obs_w), obs_valid=t(obs_valid))
        host = {"obs_cam": obs_cam, "obs_valid": obs_valid, "cam_fixed": cam_fixed}
        return prob, lm_ids + [-1] * (L - nl), kf_slots + [-1] * (K - len(kf_slots)), host
