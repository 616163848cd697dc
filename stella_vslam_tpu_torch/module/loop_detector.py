"""Loop detection: BoW candidates with continuity, and Sim3 validation.

Port of stella_vslam_tpu/module/loop_detector.py (reference
src/stella_vslam/module/loop_detector.{h,cc}), two phases:
(A) candidates: the least BoW score against the current keyframe's own
    covisibilities is the floor (cc:278); BoW acquisition that rejects the
    connected set (cc:72-132) or, with `reject_by_graph_distance`,
    everything within `min_distance_on_graph` hops of the spanning tree and
    loop edges; a continuity check that wants `min_continuity` consecutive
    keyframe sets (cc:140-180);
(B) validation of every candidate (the one with the most inliers after the
    refinement wins): brute-force match (kernel C) of at least 20 -> a pose
    hypothesis by PnP RANSAC (kernel N) -> three rounds of pose optimization
    (kernel D) at inlier thresholds 10 / 25 / `num_final_matches_thr`, the
    second and third after a projection rematch against the candidate's
    landmarks (kernel C's window mode, margins 10 and 3) -> the Sim3 scale
    from the two matched point sets about their centroids -> the transform
    optimizer (kernel O) -> an inlier gate (cc:358-560). The result is the
    Sim3 world -> current keyframe.

Each device result is read where the host decides on it. The PnP seeds are
drawn by a counter from 11 (`use_fixed_seed`) or from a random start.
"""
from __future__ import annotations

import logging
from typing import List, Set, Tuple

import numpy as np
import torch

from stella_vslam_tpu_torch.camera import base as cam_base
from stella_vslam_tpu_torch.match import projection as proj_match
from stella_vslam_tpu_torch.match import robust as robust_match
from stella_vslam_tpu_torch.module.tracking_kernels import make_cam_scalars
from stella_vslam_tpu_torch.ops.optim import pose as pose_opt
from stella_vslam_tpu_torch.ops.optim import sim3 as sim3_opt
from stella_vslam_tpu_torch.ops.solve import pnp as pnp_solve

_log = logging.getLogger(__name__)


class LoopDetector:
    def __init__(self, camera, orb_params, bow_db, *, device="cuda",
                 num_final_matches_thr: int = 40, min_continuity: int = 3,
                 use_fixed_seed: bool = False,
                 fix_scale_in_Sim3_estimation: bool = False,
                 reject_by_graph_distance: bool = False,
                 min_distance_on_graph: int = 50):
        self.camera = camera
        self.orb = orb_params
        self.bow_db = bow_db
        self.device = torch.device(device)
        self.num_final_matches_thr = num_final_matches_thr
        self.min_continuity = min_continuity
        self.fix_scale = fix_scale_in_Sim3_estimation
        self.reject_by_graph_distance = reject_by_graph_distance
        self.min_distance_on_graph = min_distance_on_graph
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        self.scale_factors = f(orb_params.scale_factors)
        self.inv_sigma_sq = f(orb_params.inv_level_sigma_sq)
        self.cam_scalars = make_cam_scalars(camera)
        # the seed of the next PnP RANSAC call
        self.next_seed = 11 if use_fixed_seed else int(np.random.randint(1 << 30))
        # continuity bookkeeping: list of (keyframe id set, count)
        self.cont_sets: List[Tuple[Set[int], int]] = []
        self.enabled = True

    # ------------------------------------------------------------------
    def detect_loop_candidates(self, map_db, cur_kf) -> List[int]:
        if not self.enabled:
            return []
        bow_cur = self.bow_db.bow_vecs.get(cur_kf.id)
        if bow_cur is None:
            return []
        covis = cur_kf.graph_node.get_covisibilities()
        min_score = 1.0
        for kid in covis:
            v = self.bow_db.bow_vecs.get(kid)
            if v is not None:
                min_score = min(min_score, self.bow_db.vocab.score(bow_cur, v))
        if not self.reject_by_graph_distance:
            reject = set(covis) | {cur_kf.id}
        else:
            # everything within min_distance_on_graph hops of the spanning
            # tree and the loop edges is too close to be a loop
            # (loop_detector.cc:93-127)
            reject = {cur_kf.id}
            targets = [(cur_kf.id, 0)]
            while targets:
                kid, dist = targets.pop()
                if dist + 1 >= self.min_distance_on_graph:
                    continue
                kf = map_db.keyframes.get(kid)
                if kf is None:
                    continue
                gn = kf.graph_node
                neighbors = []
                if gn.spanning_parent is not None:
                    neighbors.append(gn.spanning_parent)
                neighbors.extend(gn.loop_edges)
                neighbors.extend(gn.spanning_children)
                for nid in neighbors:
                    if nid not in reject:
                        reject.add(nid)
                        targets.append((nid, dist + 1))
        cands = self.bow_db.acquire_keyframes(
            bow_cur, min_score=min_score, reject=reject, keyframes=map_db.keyframes)
        # continuity: the candidate with its covisibilities must intersect a
        # set of the previous round, min_continuity rounds in a row
        passed = []
        new_sets: List[Tuple[Set[int], int]] = []
        for cand_id in cands:
            kf = map_db.keyframes.get(cand_id)
            if kf is None or kf.will_be_erased:
                continue
            cand_set = set(kf.graph_node.get_covisibilities()) | {cand_id}
            count = 0
            for prev_set, prev_count in self.cont_sets:
                if cand_set & prev_set:
                    count = max(count, prev_count + 1)
            new_sets.append((cand_set, count))
            if count >= self.min_continuity - 1:
                passed.append(cand_id)
        self.cont_sets = new_sets
        if cands:
            _log.debug("loop cands kf %d: %d raw (floor %.4g), %d past continuity (counts %s)",
                       cur_kf.id, len(cands), min_score, len(passed),
                       [c for _, c in new_sets])
        return passed

    # ------------------------------------------------------------------
    def validate_candidates(self, map_db, cur_kf, candidates: List[int]):
        """(candidate id, Sim3 (s, R, t) current <- world, the candidate slot
        matched to each current slot, the inlier slots) or None. Every
        candidate runs the whole validation (loop_detector.cc:207-356)."""
        best, best_score = None, -1
        for cand_id in candidates:
            out = self.select_loop_candidate_via_Sim3(map_db, cur_kf, cand_id)
            if out is not None and out[4] > best_score:
                best, best_score = out[:4], out[4]
        return best

    def _landmark_positions(self, map_db, kf, slots=None):
        """(positions [n,3] f32, has [n] bool) of the live landmarks in the
        keyframe's slots (all, or those given)."""
        n = kf.num_slots
        pos = np.zeros((n, 3), np.float32)
        has = np.zeros(n, bool)
        idx = np.nonzero(kf.lm_ids >= 0)[0] if slots is None else slots
        for i in idx:
            lm_id = kf.lm_ids[i]
            if lm_id < 0:
                continue
            lm = map_db.landmarks.get(int(lm_id))
            if lm is not None and not lm.will_be_erased:
                pos[i] = lm.pos_w
                has[i] = True
        return pos, has

    def select_loop_candidate_via_Sim3(self, map_db, cur_kf, cand_id: int):
        cand = map_db.keyframes.get(cand_id)
        if cand is None or cand.will_be_erased:
            return None
        dev = self.device
        dv = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        # 1. brute-force match: per candidate landmark slot, a current keypoint
        cand_pos, cand_has = self._landmark_positions(map_db, cand)
        b_idx, b_acc, _ = robust_match.brute_force_match(
            cur_kf.feats.angle, cur_kf.feats.desc, cur_kf.feats.valid,
            cand.feats.angle, cand.feats.desc, dv(cand_has), lowe_ratio=0.75)
        acc, idx = b_acc.cpu().numpy(), b_idx.cpu().numpy()
        if acc.sum() < 20:
            _log.debug("validate kf %d~%d: brute match %d < 20", cur_kf.id, cand_id,
                       int(acc.sum()))
            return None

        # per current slot, its candidate landmark
        n = cur_kf.num_slots
        pos = np.zeros((n, 3), np.float32)
        has = np.zeros(n, bool)
        src_cand_slot = np.full(n, -1, np.int64)
        for cand_slot in np.nonzero(acc)[0]:
            f = idx[cand_slot]
            pos[f] = cand_pos[cand_slot]
            has[f] = True
            src_cand_slot[f] = cand_slot

        # 2. pose hypothesis by PnP RANSAC: the current bearings against the
        # candidate side's points
        seed, self.next_seed = self.next_seed, self.next_seed + 1
        res = pnp_solve.find_via_ransac(
            seed, cur_kf.bearings, dv(pos), cur_kf.feats.level, dv(has),
            scale_factors=self.scale_factors, min_num_inliers=15)
        if not bool(res.valid):
            _log.debug("validate kf %d~%d: PnP found no model (%d corrs)", cur_kf.id,
                       cand_id, int(has.sum()))
            return None
        inl = res.is_inlier.cpu().numpy() & has
        if inl.sum() < 15:
            _log.debug("validate kf %d~%d: PnP inliers %d < 15", cur_kf.id, cand_id,
                       int(inl.sum()))
            return None

        # 2b. the reference's validation loop (loop_detector.cc:440-540):
        # pose optimization and a Sim3-guided projection rematch against the
        # candidate's landmarks, three rounds with growing inlier thresholds
        # and shrinking margins
        R_dev, t_dev = res.R_cw, res.t_cw
        matched = inl.copy()
        thresholds = (10, 25, self.num_final_matches_thr)
        margins = (None, 10.0, 3.0)
        cand_pos_dev, cand_has_dev = dv(cand_pos), dv(cand_has)
        isig = self.inv_sigma_sq[cur_kf.feats.level.long()]
        for rnd, (thr, margin) in enumerate(zip(thresholds, margins)):
            if margin is not None:
                uv, _, vis = cam_base.reproject_to_image(
                    self.camera.model, self.camera.params, R_dev, t_dev, cand_pos_dev)
                p_idx, p_acc, _ = proj_match.match_frame_and_keyframe(
                    cur_kf.undist_xy, cur_kf.feats.level, cur_kf.feats.desc,
                    cur_kf.feats.valid, cur_kf.feats.angle, dv(matched),
                    cand.feats.desc, uv, cand.feats.level, cand.feats.angle,
                    cand_has_dev & vis, scale_factors=self.scale_factors,
                    num_levels=self.orb.num_levels,
                    image_size=(self.camera.params.width, self.camera.params.height),
                    margin=margin)
                pa, pi = p_acc.cpu().numpy(), p_idx.cpu().numpy()
                for cand_slot in np.nonzero(pa)[0]:
                    f = pi[cand_slot]
                    if not matched[f]:
                        pos[f] = cand_pos[cand_slot]
                        matched[f] = True
                        src_cand_slot[f] = cand_slot
                if matched.sum() < thr:
                    _log.debug("validate kf %d~%d: round %d rematch %d < %d", cur_kf.id,
                               cand_id, rnd, int(matched.sum()), thr)
                    return None
            opt = pose_opt.optimize_pose(
                R_dev.contiguous(), t_dev.contiguous(), dv(pos), cur_kf.undist_xy,
                cur_kf.x_right, isig, dv(matched), self.cam_scalars,
                model=self.camera.model.name.lower())
            inl_opt = opt.is_inlier.cpu().numpy()
            if int(inl_opt.sum()) < thr:
                _log.debug("validate kf %d~%d: round %d pose-opt %d < %d", cur_kf.id,
                           cand_id, rnd, int(inl_opt.sum()), thr)
                return None
            matched = matched & inl_opt
            R_dev, t_dev = opt.R_cw, opt.t_cw
        # the last optimized pose seeds the Sim3 (reference optimized_pose2)
        R_pnp = R_dev.cpu().numpy()
        t_pnp = t_dev.cpu().numpy()
        inl = matched

        # 3. the matches alive in both maps, and the scale between the two
        # point sets about their centroids (1 with fix_scale or few matches)
        cur_pos, cur_ok = self._landmark_positions(map_db, cur_kf, np.nonzero(inl)[0])
        both = np.nonzero(inl & cur_ok)[0]
        scale = 1.0
        if not self.fix_scale and len(both) >= 8:
            a = cur_pos[both] - cur_pos[both].mean(0)
            b = pos[both] - pos[both].mean(0)
            na = float(np.sqrt((a ** 2).sum()))
            nb = float(np.sqrt((b ** 2).sum()))
            scale = nb / na if na > 1e-9 and nb > 1e-9 else 1.0

        # 4. Sim3 refinement with mutual reprojection between the two camera
        # frames: frame 1 the current keyframe, frame 2 the candidate
        if len(both) < 15:
            _log.debug("validate kf %d~%d: only %d matches live in both maps", cur_kf.id,
                       cand_id, len(both))
            return None
        R_cand, t_cand = cand.rot_cw, cand.trans_cw
        R_cur, t_cur = cur_kf.rot_cw, cur_kf.trans_cw
        pts_in_cand = pos[both] @ R_cand.T + t_cand
        pts_in_cur = cur_pos[both] @ R_cur.T + t_cur
        obs_cur = cur_kf.h_undist_xy[both]
        obs_cand = cand.h_undist_xy[src_cand_slot[both]]
        # initial S_12 (current <- candidate) from the optimized pose
        R12 = R_pnp @ R_cand.T
        t12 = t_pnp - R12 @ t_cand
        p = self.camera.params
        f32 = lambda a: dv(np.asarray(a, np.float32))
        ones = torch.ones(len(both), dtype=torch.float32, device=dev)
        resT = sim3_opt.optimize_transform(
            torch.tensor(scale, dtype=torch.float32, device=dev), f32(R12), f32(t12),
            f32(pts_in_cur), f32(pts_in_cand),
            f32(obs_cur), f32(obs_cand), ones, ones, ones > 0,
            p.fx, p.fy, p.cx, p.cy, fix_scale=self.fix_scale)
        num_inl = int(resT.num_inliers)
        need = min(self.num_final_matches_thr, max(15, len(both) // 2))
        if num_inl < need:
            _log.debug("validate kf %d~%d: Sim3 refine inliers %d < %d", cur_kf.id,
                       cand_id, num_inl, need)
            return None
        _log.debug("validate kf %d~%d: accepted with %d Sim3 inliers", cur_kf.id, cand_id,
                   num_inl)

        # corrected Sim3 current <- world: the refined S_12 after the
        # candidate's pose (scale 1)
        s12 = float(resT.s_12)
        R12r = resT.R_12.cpu().numpy()
        t12r = resT.t_12.cpu().numpy()
        R_cw = R12r @ R_cand
        t_cw = s12 * (R12r @ t_cand) + t12r
        return cand_id, (s12, R_cw, t_cw), src_cand_slot, inl, num_inl
