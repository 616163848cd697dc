"""Global optimization module: loop detection, correction, pose graph, global BA.

Port of the synchronous subset of stella_vslam_tpu/global_optimization_module.py
(reference src/stella_vslam/global_optimization_module.{h,cc}): for every
keyframe the mapper hands over, `process_keyframe` detects loop candidates,
validates them (module/loop_detector.py), and `correct_loop`
1. propagates the Sim3 correction to the current keyframe's covisibilities
   and the landmarks they see (cc:212-312, 314-398),
2. replaces the current side's duplicates of the matched candidate landmarks
   and fuses the candidate side's landmarks into every corrected keyframe
   (cc:400-491; MappingModule._fuse_into, kernel L at margin 4),
3. collects the connections born of that fusion, adds the loop edge,
4. optimizes the Sim3 pose graph over the essential graph (spanning tree,
   loop edges, covisibilities of weight >= 100; ops/optim/sim3.py, kernel P),
   the old edges measured at the poses before the correction, the loop edge
   and the fusion-born edges at the corrected Sim3s (graph_optimizer.cc),
5. runs a global bundle adjustment (one Huber stage of 16 iterations, no
   reclassification; ops/optim/ba.py, kernels F-I at K = pow2(keyframes),
   L = pow2(landmarks), D = pow2(most observers)) whose writeback carries
   keyframes and landmarks outside the problem along the spanning tree, and
6. merges duplicate landmark layers the revisit may have mapped
   (`_merge_duplicate_layers`), with one more global BA when it linked any.
Inline (the mapper's `synchronous_ba`) `process_keyframe` runs on the
caller's thread after each keyframe event, and the global BA right after
the correction. Threaded (the default), `run` is the loop-closing thread:
it takes the keyframes the mapping thread queues, and `correct_loop` first
pauses the mapper (which settles its staged event and pending BA before it
acknowledges) and resumes it after the pose graph; the global BA and the
merge then run detached on a thread of their own (`_loop_ba_then_merge`),
with mapping live, and their writeback carries the keyframes created
meanwhile along the spanning tree. A newer loop aborts the BA in flight.
Every correction ends in a publish of the device landmark table around the
corrected keyframe (after a `bump_epoch` that drops any deferred local-BA
writeback), which the tracker follows by its rebase or resync. Failures on
either thread are contained and counted in `errors`. `warmup` runs one pose
graph iteration with its library Cholesky and one global-BA step at the
circuit's shapes, so that the first loop pays no set-up.

The global and loop BAs run through parallel/sharded_ba.py
(`sharded_bundle_adjust` over `ba_devices`, as the JAX package routes them
through its mesh): with a device list the landmark rows are sharded and
the cameras replicated (kernels F, H per shard, W across them, G on every
card), and the detached loop BA issues its work on one stream per device.
By default `ba_devices` is None, the one-device BA on the module's device,
also on a host with several cards: no measurement yet shows the cross-card
route gaining at the maps this System builds (PERF.md). Left out (ROADMAP):
marker rows.
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.data.map_database import fill_observation_tables
from stella_vslam_tpu_torch.module.loop_detector import LoopDetector
from stella_vslam_tpu_torch.module.tracking_kernels import make_cam_scalars
from stella_vslam_tpu_torch.ops.optim import ba as ba_mod
from stella_vslam_tpu_torch.ops.optim import sim3 as sim3_opt
from stella_vslam_tpu_torch.parallel import sharded_ba
from stella_vslam_tpu_torch.util import streams

_log = logging.getLogger(__name__)

# the phases `loop_event_ms` splits a closed loop's time into
LOOP_PHASES = ("detect", "validate", "pause", "correct", "pose_graph", "global_ba", "merge")


def _pow2(n: int, least: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, least))))


class GlobalOptimizationModule:
    def __init__(self, map_db, camera, orb_params, bow_db, *, device="cuda",
                 fix_scale: bool = False, use_fixed_seed: bool = False,
                 loop_detector_kwargs: Optional[dict] = None, stream=None):
        """`stream`: the CUDA stream of the loop-closing threads' device work."""
        self.map_db = map_db
        self.camera = camera
        self.orb_params = orb_params
        self.device = torch.device(device)
        self.stream = stream
        # the devices the global and loop BAs shard their landmark rows over
        # (None: the one-device BA); a list may repeat a card
        self.ba_devices = None
        self._ba_streams = {}
        self.loop_detector = LoopDetector(
            camera, orb_params, bow_db, device=device,
            fix_scale_in_Sim3_estimation=fix_scale, use_fixed_seed=use_fixed_seed,
            **(loop_detector_kwargs or {}))
        self.mapper = None  # wired by System
        self.num_loops_closed = 0
        self.loop_ba_running = False
        self._abort_loop_ba = False
        self._loop_ba_thread: Optional[threading.Thread] = None
        # the loop-closing thread: its queue, and whether a popped keyframe
        # is still being processed (shutdown's drain needs both)
        self._queue: "queue.Queue" = queue.Queue()
        self._idle = True
        self._thread: Optional[threading.Thread] = None
        self._terminate = threading.Event()
        # per closed loop, its phases in ms (LOOP_PHASES and "total"), and
        # the keyframe pair; ms of the detection that found nothing are
        # summed in detect_ms; the exceptions the threads contained
        self.loop_event_ms = []
        self.detect_ms = []
        self.errors = []
        self._last_pose_graph_edges = None

    # ------------------------------------------------------------------
    def warmup(self):
        """One pose-graph iteration with its library Cholesky and one
        global-BA step at the circuit's shapes (K = 32, E = 128; K = 32,
        L = 4096, D = 16), on the loop-closing stream: the factorization
        library's set-up otherwise lands in the first loop event. Nothing
        to do on the CPU."""
        if self.device.type != "cuda":
            return
        dev = self.device
        K, E, L, D = 32, 128, 4096, 16
        eye = torch.eye(3, device=dev)
        f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        first = lambda n: torch.arange(n, device=dev) == 0
        with streams.on(self.stream):
            sim3_opt.optimize_pose_graph(
                f32(K) + 1.0, eye.expand(K, 3, 3).contiguous(), f32(K, 3), first(K),
                torch.arange(K, device=dev) < 3, torch.zeros(E, dtype=torch.int32, device=dev),
                torch.ones(E, dtype=torch.int32, device=dev), f32(E) + 1.0,
                eye.expand(E, 3, 3).contiguous(), f32(E, 3), torch.arange(E, device=dev) < 2,
                num_iter=1)
            bl = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
            sharded_ba.sharded_bundle_adjust(ba_mod.BAProblem(
                cam_R=eye.expand(K, 3, 3).contiguous(), cam_t=f32(K, 3), cam_fixed=first(K),
                cam_valid=~bl(K), lm_pos=f32(L, 3), lm_valid=bl(L),
                obs_cam=torch.zeros((L, D), dtype=torch.int32, device=dev),
                obs_uv=f32(L, D, 2), obs_x_right=f32(L, D) - 1.0,
                obs_inv_sigma_sq=f32(L, D) + 1.0, obs_valid=bl(L, D)),
                make_cam_scalars(self.camera), model=self.camera.model.name.lower(),
                num_first=1, num_second=0, devices=self.ba_devices or [self.device])
            torch.cuda.current_stream(dev).synchronize()

    # ------------------------------------------------------------------ thread
    def queue_keyframe(self, kf):
        self._queue.put(kf)

    def start(self):
        self._terminate.clear()
        self._thread = threading.Thread(target=self.run, daemon=True, name="loop-closing")
        self._thread.start()

    def request_terminate(self):
        self._terminate.set()

    def join(self):
        if self._thread is not None:
            self._thread.join(timeout=60)
        if self._loop_ba_thread is not None:
            self._loop_ba_thread.join(timeout=120)

    def is_idle(self) -> bool:
        return self._idle and self._queue.empty()

    def run(self):
        with streams.on(self.stream):
            while not self._terminate.is_set():
                try:
                    kf = self._queue.get(timeout=0.005)
                except queue.Empty:
                    continue
                self._idle = False
                try:
                    self.process_keyframe(kf)
                except Exception:
                    # a dead loop-closing thread would stop all later loop
                    # detection: contained (as the reference's thread
                    # survives a keyframe's failure) and counted
                    self.errors.append(traceback.format_exc())
                    _log.exception("loop processing failed for keyframe %d", kf.id)
                finally:
                    self._idle = True

    # ------------------------------------------------------------------
    def enable_loop_detector(self):
        self.loop_detector.enabled = True

    def disable_loop_detector(self):
        self.loop_detector.enabled = False

    def loop_detector_is_enabled(self) -> bool:
        return self.loop_detector.enabled

    def abort_loop_BA(self):
        """Abandon the loop BA in flight: its results are discarded
        (reference loop_bundle_adjuster abort)."""
        self._abort_loop_ba = True

    def request_loop_closure(self, keyfrm1_id: int, keyfrm2_id: int) -> bool:
        """Manual loop closure between two keyframes (reference
        global_optimization_module.cc:61-120): the Sim3 validation of
        keyfrm1 against keyfrm2 directly (no BoW detection, no continuity),
        and the correction if it holds."""
        with self.map_db.lock:
            kf1 = self.map_db.keyframes.get(keyfrm1_id)
            kf2 = self.map_db.keyframes.get(keyfrm2_id)
            if kf1 is None or kf2 is None or kf1.will_be_erased or kf2.will_be_erased:
                return False
        out = self.loop_detector.select_loop_candidate_via_Sim3(self.map_db, kf1, keyfrm2_id)
        if out is None:
            return False
        cand_id, sim3_cw, src_cand_slot, inl = out[:4]
        self.correct_loop(kf1, cand_id, sim3_cw, src_cand_slot, inl)
        return True

    # ------------------------------------------------------------------
    def process_keyframe(self, kf):
        if kf.will_be_erased:
            return
        # the query and the candidates are protected from the keyframe
        # culler while they are under loop processing
        # (global_optimization_module.cc:164-169)
        kf.set_not_to_be_erased(True)
        cand_kf = None
        t0 = time.perf_counter()
        try:
            cands = self.loop_detector.detect_loop_candidates(self.map_db, kf)
            t1 = time.perf_counter()
            if not cands:
                self.detect_ms.append((t1 - t0) * 1e3)
                return
            with self.map_db.lock:
                protected = [self.map_db.keyframes[c] for c in cands
                             if c in self.map_db.keyframes
                             and not self.map_db.keyframes[c].will_be_erased]
                for c_kf in protected:
                    c_kf.set_not_to_be_erased(True)
            try:
                val = self.loop_detector.validate_candidates(self.map_db, kf, cands)
            finally:
                for c_kf in protected:
                    c_kf.set_not_to_be_erased(False)
            t2 = time.perf_counter()
            if val is None:
                self.detect_ms.append((t2 - t0) * 1e3)
                return
            cand_id, sim3_cw, src_cand_slot, inl = val
            with self.map_db.lock:
                cand_kf = self.map_db.keyframes.get(cand_id)
                if cand_kf is None or cand_kf.will_be_erased:
                    return
                cand_kf.set_not_to_be_erased(True)
            self.correct_loop(kf, cand_id, sim3_cw, src_cand_slot, inl,
                              ms={"detect": (t1 - t0) * 1e3, "validate": (t2 - t1) * 1e3})
        finally:
            kf.set_not_to_be_erased(False)
            if cand_kf is not None:
                # keyframes of a closed loop keep their loop edges, which
                # can_be_erased() treats as permanent protection
                cand_kf.set_not_to_be_erased(False)

    # ------------------------------------------------------------------
    def _mapper_is_threaded(self) -> bool:
        m = self.mapper
        return m is not None and m._thread is not None and m._thread.is_alive()

    def correct_loop(self, cur_kf, cand_id, sim3_cw, src_cand_slot, inl, ms=None):
        map_db = self.map_db
        ms = dict(ms or {"detect": 0.0, "validate": 0.0})
        t0 = time.perf_counter()
        # a newer loop supersedes the BA in flight (reference
        # global_optimization_module.cc:228-235, abort and wait)
        if self._loop_ba_thread is not None and self._loop_ba_thread.is_alive():
            self.abort_loop_BA()
            self._loop_ba_thread.join(timeout=60)
        threaded = self._mapper_is_threaded()
        if threaded:
            # the mapper settles its staged event and pending BA before it
            # acknowledges the pause; a writeback after the correction would
            # undo it
            self.mapper.request_pause()
            t_wait = time.monotonic()
            while not self.mapper.is_paused() and time.monotonic() - t_wait < 5.0 \
                    and self._mapper_is_threaded():
                time.sleep(0.002)
        ms["pause"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        try:
            with map_db.lock:
                # a local-BA writeback dispatched before this point would
                # undo the correction
                map_db.bump_epoch()
                s_cw, R_cw, t_cw = sim3_cw
                R_old, t_old = cur_kf.rot_cw, cur_kf.trans_cw
                # corrected Sim3s of the current keyframe and its
                # covisibilities: S_i_corr = S_i_old o S_cur_old^-1 o S_cur_corr
                covis = [cur_kf.id] + cur_kf.graph_node.get_covisibilities()
                corrections = {}
                # the poses before the correction: the pose graph measures
                # its old edges there, so the loop constraint creates the
                # tension that the optimization spreads over the graph
                # (graph_optimizer.cc:65-104 non_corrected_Sim3s)
                pre_poses = {}
                moved_lms = set()
                for kid in covis:
                    kf = map_db.keyframes.get(kid)
                    if kf is None or kf.will_be_erased:
                        continue
                    R_i, t_i = kf.rot_cw, kf.trans_cw
                    pre_poses[kid] = (R_i.copy(), t_i.copy())
                    R_rel = R_i @ R_old.T
                    t_rel = t_i - R_rel @ t_old
                    corrections[kid] = (s_cw, R_rel @ R_cw, R_rel @ t_cw + t_rel * s_cw)
                # move the landmarks the covisible set sees:
                # X_new = S_i_corr^-1 (S_i_old (X_old))
                for kid in covis:
                    kf = map_db.keyframes.get(kid)
                    if kf is None or kid not in corrections:
                        continue
                    s_i, R_i_new, t_i_new = corrections[kid]
                    R_i, t_i = kf.rot_cw, kf.trans_cw
                    for lm_id in kf.lm_ids[kf.lm_ids >= 0]:
                        lm = map_db.landmarks.get(int(lm_id))
                        if lm is None or lm.will_be_erased or lm.id in moved_lms:
                            continue
                        moved_lms.add(lm.id)
                        Xc = R_i @ lm.pos_w + t_i
                        lm.pos_w = (R_i_new.T @ (Xc - t_i_new)) / s_i
                    # the corrected SE3 pose: the translation over the scale
                    T = np.eye(4)
                    T[:3, :3] = R_i_new
                    T[:3, 3] = t_i_new / s_i
                    kf.set_pose_cw(T)

                # the matched candidate landmarks replace the current side's
                # (cc:400-491)
                cand = map_db.keyframes.get(cand_id)
                if cand is not None:
                    for f_slot in np.nonzero(inl & (src_cand_slot >= 0))[0]:
                        cand_lm_id = cand.lm_ids[src_cand_slot[f_slot]]
                        cur_lm_id = cur_kf.lm_ids[f_slot]
                        if cand_lm_id < 0:
                            continue
                        cand_lm = map_db.landmarks.get(int(cand_lm_id))
                        if cand_lm is None or cand_lm.will_be_erased:
                            continue
                        if cur_lm_id >= 0 and cur_lm_id != cand_lm_id:
                            cur_lm = map_db.landmarks.get(int(cur_lm_id))
                            if cur_lm is not None and not cur_lm.will_be_erased:
                                map_db.replace_landmark(cur_lm, cand_lm)
                                cand_lm.compute_descriptor(map_db)
                                cand_lm.update_mean_normal_and_obs_scale_variance(map_db)
                        elif cur_lm_id < 0 and cur_kf.id not in cand_lm.observations:
                            cand_lm.add_observation(cur_kf.id, int(f_slot))
                            cur_kf.add_landmark(int(cand_lm_id), int(f_slot))

                # the candidate side's landmarks projected into every
                # corrected keyframe and fused (replace_duplicated_landmarks,
                # cc:400-491): the observations across the loop that let the
                # global BA stitch the two sides
                if cand is not None and self.mapper is not None:
                    arrs = []
                    for kid in [cand_id] + cand.graph_node.get_covisibilities():
                        ckf = map_db.keyframes.get(kid)
                        if ckf is None or ckf.will_be_erased:
                            continue
                        arrs.append(ckf.lm_ids[ckf.lm_ids >= 0])
                    cand_side_ids = map_db.fields.live(
                        np.unique(np.concatenate(arrs))) if arrs else []
                    fuse_kfs = [map_db.keyframes[k] for k in covis
                                if k in map_db.keyframes
                                and not map_db.keyframes[k].will_be_erased]
                    if len(cand_side_ids) and fuse_kfs:
                        self.mapper._fuse_into(map_db, fuse_kfs, cand_side_ids, margin=4.0)

                # connections that exist only because of the loop fusion
                # (extract_new_connections, cc:493-517): the pose graph
                # measures them at the corrected Sim3s, like the loop edge
                # (graph_optimizer.cc:128-154), not at the poses before,
                # which for a pair across the seam hold the whole drift
                covis_set = set(covis)
                new_connections = set()
                for kid in covis:
                    kf = map_db.keyframes.get(kid)
                    if kf is None or kf.will_be_erased:
                        continue
                    before = set(kf.graph_node.get_covisibilities())
                    kf.graph_node.update_connections(map_db)
                    after = set(kf.graph_node.get_covisibilities())
                    for nid in after - before - covis_set:
                        w = kf.graph_node.connections.get(nid, 0)
                        if w >= 100 or {kid, nid} == {cur_kf.id, cand_id}:
                            new_connections.add((min(kid, nid), max(kid, nid)))
                cur_kf.graph_node.add_loop_edge(cand_id)
                if cand is not None:
                    cand.graph_node.add_loop_edge(cur_kf.id)
            t1 = time.perf_counter()
            ms["correct"] = (t1 - t0) * 1e3
            self._pose_graph_optimize(corrections, pre_poses, loop_pair=(cur_kf.id, cand_id),
                                      new_connections=new_connections)
            ms["pose_graph"] = (time.perf_counter() - t1) * 1e3
            self.num_loops_closed += 1
        finally:
            if threaded:
                self.mapper.resume()
            # the local map around the corrected keyframe (its
            # covisibilities now include the loop side)
            self.map_db.refresh_device_table(center_kf_id=cur_kf.id)
        ms["keyframes"] = (cur_kf.id, cand_id)
        if threaded:
            # the global BA runs detached with mapping live (reference
            # global_optimization_module.cc:302 -> loop_bundle_adjuster)
            self.loop_ba_running = True
            self._loop_ba_thread = threading.Thread(
                target=self._loop_ba_then_merge, args=(cur_kf.id, ms), daemon=True,
                name="loop-BA")
            self._loop_ba_thread.start()
        else:
            self._loop_ba_then_merge(cur_kf.id, ms)

    def _ba_device_streams(self):
        """Context: the loop-closing stream on the module's device and a
        stream of the loop BA's own on every other device of ba_devices."""
        stack = contextlib.ExitStack()
        stack.enter_context(streams.on(self.stream))
        if self.device.type != "cuda":
            return stack
        own = sharded_ba.card(self.device)
        for d in dict.fromkeys(sharded_ba.card(d) for d in self.ba_devices or ()):
            if d.type == "cuda" and d != own:
                if d not in self._ba_streams:
                    self._ba_streams[d] = streams.new_stream(d)
                stack.enter_context(streams.on(self._ba_streams[d]))
        return stack

    def _loop_ba_then_merge(self, center_kf_id, ms):
        """The global BA and the duplicate-layer merge after a correction;
        the loop event's record is complete when they are."""
        try:
            with self._ba_device_streams():
                t2 = time.perf_counter()
                self.run_global_bundle_adjustment(center_kf_id=center_kf_id)
                t3 = time.perf_counter()
                if not self._abort_loop_ba:
                    self._merge_duplicate_layers(center_kf_id=center_kf_id)
                t4 = time.perf_counter()
        except Exception:
            if threading.current_thread() is not self._loop_ba_thread:
                raise
            self.errors.append(traceback.format_exc())
            _log.exception("loop BA failed")
            self.loop_ba_running = False
            return
        ms.update(global_ba=(t3 - t2) * 1e3, merge=(t4 - t3) * 1e3)
        ms["total"] = sum(ms[k] for k in LOOP_PHASES)
        self.loop_event_ms.append(ms)
        _log.info("loop closed kf %d ~ %d: %s", *ms["keyframes"],
                  " ".join(f"{k}={ms[k]:.1f}" for k in LOOP_PHASES))

    def _merge_duplicate_layers(self, center_kf_id=None, max_pairs: int = 64):
        """Merge of duplicate landmark layers after the loop BA (beyond the
        reference, whose replace_duplicated_landmarks fuses only the loop
        keyframe's covisibility neighbourhood). Where a revisit leg mapped
        a second layer of landmarks over the first, the duplicates lie
        within projection range of each other once the corrected gauges
        agree: keyframe pairs whose view footprints overlap (the centroids
        of their landmarks closer than the footprints' spread) yet share no
        covisibility edge and lie more than 5 s apart get each side's
        landmarks fused into the other, and one more global BA runs if that
        linked any. Nothing is dispatched on a well-coupled map."""
        map_db = self.map_db
        if self.mapper is None:
            return
        with map_db.lock:
            kfs = [kf for kf in map_db.keyframes.values() if not kf.will_be_erased]
            if len(kfs) < 8:
                return
            pos, alive = map_db.fields.pos, map_db.fields.alive
            cent, spread, lm_sets = [], [], []
            for kf in kfs:
                ids = kf.lm_ids[kf.lm_ids >= 0]
                ids = ids[alive[ids]]
                lm_sets.append(ids)
                if len(ids) < 20:
                    cent.append(np.full(3, np.nan))
                    spread.append(0.0)
                    continue
                p = pos[ids]
                c = p.mean(axis=0)
                cent.append(c)
                spread.append(float(np.median(np.linalg.norm(p - c, axis=1))))
            cent = np.stack(cent)
            spread = np.asarray(spread)
            ts = np.asarray([kf.timestamp for kf in kfs])
            covis = {kf.id: set(kf.graph_node.get_covisibilities()) for kf in kfs}
        d = np.linalg.norm(cent[:, None, :] - cent[None, :, :], axis=2)
        overlap = d < 0.5 * (spread[:, None] + spread[None, :])
        ii, jj = np.nonzero(overlap & (np.abs(ts[:, None] - ts[None, :]) > 5.0))
        pairs = []
        for a, b in zip(ii.tolist(), jj.tolist()):
            if a >= b or kfs[b].id in covis.get(kfs[a].id, ()):
                continue
            pairs.append((a, b, d[a, b]))
        if len(pairs) < 4:
            # a few stragglers occur on healthy maps (around the seam before
            # its connections are recounted): no duplicate layer
            return
        pairs.sort(key=lambda p: p[2])
        pairs = pairs[:max_pairs]
        _log.info("duplicate-layer merge: %d disconnected pairs of overlapping views",
                  len(pairs))
        # one fuse call per keyframe over the union of its partners' landmarks
        partner_ids: dict = {}
        touched = set()
        for a, b, _dist in pairs:
            partner_ids.setdefault(a, []).append(lm_sets[b])
            partner_ids.setdefault(b, []).append(lm_sets[a])
            touched.add(kfs[a].id)
            touched.add(kfs[b].id)
        for idx, chunks in partner_ids.items():
            with map_db.lock:
                ids = map_db.fields.live(np.unique(np.concatenate(chunks)))
            if len(ids):
                self.mapper._fuse_into(map_db, [kfs[idx]], ids, margin=4.0)
        with map_db.lock:
            n_new = 0
            for kid in touched:
                kf = map_db.keyframes.get(kid)
                if kf is None or kf.will_be_erased:
                    continue
                before = set(kf.graph_node.get_covisibilities())
                kf.graph_node.update_connections(map_db)
                n_new += len(set(kf.graph_node.get_covisibilities()) - before)
        _log.info("duplicate-layer merge: %d new covisibility links", n_new)
        if n_new and not self._abort_loop_ba:
            self.run_global_bundle_adjustment(center_kf_id=center_kf_id)

    # ------------------------------------------------------------------
    def _pose_graph_optimize(self, corrections, pre_poses=None, loop_pair=None,
                             new_connections=None):
        """Sim3 pose graph over the essential graph (graph_optimizer.cc).
        A vertex starts at its corrected Sim3 (the corrected group) or its
        current pose; an edge that existed before is measured at the poses
        before the correction, the loop edge and the fusion-born
        `new_connections` at the corrected Sim3s (graph_optimizer.cc:65-154)."""
        map_db = self.map_db
        pre_poses = pre_poses or {}
        with map_db.lock:
            kf_ids = sorted(k for k, kf in map_db.keyframes.items() if not kf.will_be_erased)
            if len(kf_ids) < 3:
                return
            idx_of = {k: i for i, k in enumerate(kf_ids)}
            K = len(kf_ids)
            s = np.ones(K, np.float32)
            R = np.zeros((K, 3, 3), np.float32)
            t = np.zeros((K, 3), np.float32)
            before_sim3 = {}
            for k, i in idx_of.items():
                kf = map_db.keyframes[k]
                if k in corrections:
                    s_i, R_i, t_i = corrections[k]
                    s[i], R[i], t[i] = s_i, R_i, t_i
                    before_sim3[k] = (float(s_i), np.array(R_i), np.array(t_i))
                else:
                    R[i] = kf.rot_cw
                    t[i] = kf.trans_cw
                    before_sim3[k] = (1.0, kf.rot_cw.copy(), kf.trans_cw.copy())

            def sim3_noncorr(k):
                if k in pre_poses:
                    R_p, t_p = pre_poses[k]
                    return 1.0, R_p, t_p
                kf = map_db.keyframes[k]
                return 1.0, kf.rot_cw, kf.trans_cw

            # essential graph: spanning tree, loop edges, covisibility >= 100
            edges = set()
            loop_edge_set = set()
            for k in kf_ids:
                gn = map_db.keyframes[k].graph_node
                if gn.spanning_parent is not None and gn.spanning_parent in idx_of:
                    edges.add((min(k, gn.spanning_parent), max(k, gn.spanning_parent)))
                for le in gn.loop_edges:
                    if le in idx_of:
                        edges.add((min(k, le), max(k, le)))
                        loop_edge_set.add((min(k, le), max(k, le)))
                for cid, w in gn.connections.items():
                    if w >= 100 and cid in idx_of:
                        edges.add((min(k, cid), max(k, cid)))
            for (a, b) in (new_connections or ()):
                if a in idx_of and b in idx_of:
                    edges.add((a, b))
                    loop_edge_set.add((a, b))
            if loop_pair is not None:
                a, b = loop_pair
                if a in idx_of and b in idx_of:
                    edges.add((min(a, b), max(a, b)))
                    loop_edge_set.add((min(a, b), max(a, b)))
                else:
                    # an end was erased between validation and here; without
                    # the loop edge the graph would bend toward nothing
                    _log.error("pose graph: loop pair (%d,%d) not alive", a, b)
                    return
            edges = sorted(edges)
            if not edges:
                return
            self._last_pose_graph_edges = {
                "edges": list(edges), "loop_edges": sorted(loop_edge_set),
                "corrected": sorted(corrections.keys())}
            E = len(edges)
            ei = np.array([idx_of[a] for a, b in edges], np.int32)
            ej = np.array([idx_of[b] for a, b in edges], np.int32)
            es = np.ones(E, np.float32)
            eR = np.zeros((E, 3, 3), np.float32)
            et = np.zeros((E, 3), np.float32)
            for n, (a, b) in enumerate(edges):
                if (a, b) in loop_edge_set:
                    sa, Ra, ta = before_sim3[a]
                    sb, Rb, tb = before_sim3[b]
                else:
                    sa, Ra, ta = sim3_noncorr(a)
                    sb, Rb, tb = sim3_noncorr(b)
                # measurement S_ab = S_a o S_b^-1
                es[n] = sa / sb
                eR[n] = Ra @ Rb.T
                et[n] = ta - es[n] * (eR[n] @ tb)

        # pow2 buckets (K, E >= 16), as the JAX version pads
        Kp, Ep = _pow2(K, 16), _pow2(E, 16)
        fixed = np.array([k in map_db.spanning_roots for k in kf_ids])

        def pad(a, n, fill=0.0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[:len(a)] = a
            return out

        R_pad, eR_pad = pad(R, Kp), pad(eR, Ep)
        R_pad[K:] = np.eye(3, dtype=np.float32)
        eR_pad[E:] = np.eye(3, dtype=np.float32)
        dv = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        res = sim3_opt.optimize_pose_graph(
            dv(pad(s, Kp, 1.0)), dv(R_pad), dv(pad(t, Kp)),
            dv(np.concatenate([fixed, np.ones(Kp - K, bool)])), dv(np.arange(Kp) < K),
            dv(pad(ei, Ep)), dv(pad(ej, Ep)), dv(pad(es, Ep, 1.0)), dv(eR_pad),
            dv(pad(et, Ep)), dv(np.arange(Ep) < E))
        s_new, R_new, t_new = (x.cpu().numpy() for x in res)
        with map_db.lock:
            # landmarks ride their reference keyframe: its Sim3 before, the
            # optimized Sim3 after (graph_optimizer.cc tail)
            for lm in map_db.landmarks.values():
                if lm.will_be_erased:
                    continue
                rk = lm.ref_keyfrm_id
                if rk not in idx_of or rk not in before_sim3:
                    continue
                i = idx_of[rk]
                s_b, R_b, t_b = before_sim3[rk]
                Xc = s_b * (R_b @ lm.pos_w) + t_b
                lm.pos_w = R_new[i].T @ (Xc - t_new[i]) / s_new[i]
            for k, i in idx_of.items():
                kf = map_db.keyframes.get(k)
                if kf is None:
                    continue
                T = np.eye(4)
                T[:3, :3] = R_new[i]
                T[:3, 3] = t_new[i] / s_new[i]
                kf.set_pose_cw(T)

    # ------------------------------------------------------------------
    def run_global_bundle_adjustment(self, num_iter: int = 16, center_kf_id=None):
        """Full-map BA (reference loop_bundle_adjuster and
        global_bundle_adjuster): one robust stage with no reclassification,
        since pruning would drop the high-residual observations across the
        loop that stitch the corrected map. Keyframes and landmarks outside
        the problem follow by spanning-tree propagation at the writeback
        (loop_bundle_adjuster.cc:84-116, 139-175)."""
        self.loop_ba_running = True
        self._abort_loop_ba = False
        try:
            prob, lm_ids, kf_slots = self._assemble_global_ba()
            if prob is None:
                return
            res = sharded_ba.sharded_bundle_adjust(
                prob, make_cam_scalars(self.camera), model=self.camera.model.name.lower(),
                num_first=num_iter, num_second=0, devices=self.ba_devices or [self.device])
            camR, camt, lm_new = (x.cpu().numpy() for x in (res.cam_R, res.cam_t, res.lm_pos))
            if self._abort_loop_ba:
                return
            self._apply_global_ba_result(prob, lm_ids, kf_slots, camR, camt, lm_new)
            self.map_db.refresh_device_table(center_kf_id=center_kf_id)
        finally:
            self.loop_ba_running = False

    def _apply_global_ba_result(self, prob, lm_ids, kf_slots, camR, camt, lm_new):
        """The global BA's writeback with spanning-tree propagation."""
        map_db = self.map_db
        with map_db.lock:
            if self._abort_loop_ba:
                return
            map_db.bump_epoch()
            cam_fixed_h = prob.cam_fixed.cpu().numpy()
            before = {k: (kf.rot_cw.copy(), kf.trans_cw.copy())
                      for k, kf in map_db.keyframes.items() if not kf.will_be_erased}
            after = {}
            for slot, kf_id in enumerate(kf_slots):
                if kf_id < 0 or kf_id not in before:
                    continue
                if bool(cam_fixed_h[slot]):
                    after[kf_id] = before[kf_id]
                else:
                    after[kf_id] = (camR[slot].astype(np.float64),
                                    camt[slot].astype(np.float64))
            # parents before children
            stack = [k for k in before
                     if map_db.keyframes[k].graph_node.spanning_parent is None]
            visited = set()
            while stack:
                k = stack.pop()
                if k in visited:
                    continue
                visited.add(k)
                kf = map_db.keyframes.get(k)
                if kf is None:
                    continue
                if k not in after and k in before:
                    parent = kf.graph_node.spanning_parent
                    if parent in after and parent in before:
                        Rp_b, tp_b = before[parent]
                        Rc_b, tc_b = before[k]
                        R_rel = Rc_b @ Rp_b.T
                        t_rel = tc_b - R_rel @ tp_b
                        Rp_a, tp_a = after[parent]
                        after[k] = (R_rel @ Rp_a, R_rel @ tp_a + t_rel)
                stack.extend(kf.graph_node.spanning_children)
            for k, (Ra, ta) in after.items():
                kf = map_db.keyframes.get(k)
                if kf is None or kf.will_be_erased:
                    continue
                T = np.eye(4)
                T[:3, :3] = Ra
                T[:3, 3] = ta
                kf.set_pose_cw(T)
            # landmarks: the optimized rows directly, the rest through their
            # reference keyframe's poses before and after
            row_of = {lm_id: l for l, lm_id in enumerate(lm_ids) if lm_id >= 0}
            for lm_id, lm in map_db.landmarks.items():
                if lm.will_be_erased:
                    continue
                row = row_of.get(lm_id)
                if row is not None:
                    lm.pos_w = lm_new[row].astype(np.float64)
                    continue
                rk = lm.ref_keyfrm_id
                if rk in before and rk in after:
                    Rb, tb = before[rk]
                    Ra, ta = after[rk]
                    lm.pos_w = Ra.T @ (Rb @ lm.pos_w + tb - ta)

    def _assemble_global_ba(self, D: Optional[int] = None):
        """(problem on the device, landmark id per row, keyframe id per
        camera slot), padded to pow2 buckets; D defaults to the pow2 bucket
        of the most observers of any landmark (at least 8), so that every
        observation constrains the solve (global_bundle_adjuster.cc)."""
        map_db = self.map_db
        with map_db.lock:
            kf_ids = sorted(k for k, kf in map_db.keyframes.items() if not kf.will_be_erased)
            lm_ids = sorted(k for k, lm in map_db.landmarks.items() if not lm.will_be_erased)
            if len(kf_ids) < 2 or len(lm_ids) < 8:
                return None, None, None
            K, L = _pow2(len(kf_ids), 2), _pow2(len(lm_ids), 8)
            if D is None:
                counts = map_db.assoc_store.num_obs_bulk(np.asarray(lm_ids, np.int64))
                D = _pow2(int(counts.max()) if len(counts) else 2, 8)
            inv_sigma = np.asarray(self.orb_params.inv_level_sigma_sq, np.float32)
            cam_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
            cam_t = np.zeros((K, 3), np.float32)
            cam_fixed = np.ones(K, bool)
            cam_valid = np.zeros(K, bool)
            for i, k in enumerate(kf_ids):
                kf = map_db.keyframes[k]
                cam_R[i] = kf.rot_cw
                cam_t[i] = kf.trans_cw
                cam_valid[i] = True
                cam_fixed[i] = (k in map_db.spanning_roots
                                or k <= map_db.fixed_keyframe_id_threshold)
            nl = len(lm_ids)
            lm_pos = np.zeros((L, 3), np.float32)
            lm_valid = np.zeros(L, bool)
            lm_pos[:nl] = map_db.fields.pos[np.asarray(lm_ids, np.int64)]
            lm_valid[:nl] = True
            lm_ids_arr = np.asarray(list(lm_ids) + [-1] * (L - nl), np.int64)
            obs_cam, obs_idx, obs_valid = map_db.assoc_store.assemble_ba(
                lm_ids_arr, np.asarray(kf_ids, np.int64),
                np.arange(len(kf_ids), dtype=np.int32), D)
            obs_uv, obs_xr, obs_w = fill_observation_tables(
                map_db, kf_ids, obs_cam, obs_idx, obs_valid, inv_sigma)
        dv = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        prob = ba_mod.BAProblem(
            cam_R=dv(cam_R), cam_t=dv(cam_t), cam_fixed=dv(cam_fixed), cam_valid=dv(cam_valid),
            lm_pos=dv(lm_pos), lm_valid=dv(lm_valid), obs_cam=dv(obs_cam), obs_uv=dv(obs_uv),
            obs_x_right=dv(obs_xr), obs_inv_sigma_sq=dv(obs_w), obs_valid=dv(obs_valid),
            lm_fixed=dv(np.zeros(L, bool)), lm_keep_inlier=dv(np.zeros(L, bool)))
        return prob, list(lm_ids_arr), list(kf_ids) + [-1] * (K - len(kf_ids))
