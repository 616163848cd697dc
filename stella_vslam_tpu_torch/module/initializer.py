"""Monocular map initializer: the perspective and bearing-vector paths.

Port of stella_vslam_tpu/module/initializer.py (reference module/
initializer.cc + initialize/perspective.cc, bearing_vector.cc): area-match
the current frame against the init frame (margin 100, Lowe 0.9,
match/area.py on kernel C). A perspective camera runs H and F RANSAC
(kernel E), picks H when its share of the two costs is below 0.5
(perspective.cc:60-77) and takes its 8 (H) or 4 (F -> E) motion
hypotheses; every other model runs E-RANSAC on the bearings (kernel E's
MODEL 2; its escalation adds the 5-point sets of kernel U and keeps the
result with more inliers) and takes E's 4 hypotheses. The hypotheses are
evaluated by triangulating the inlier matches in one batched torch pass
(positive depth required for the perspective camera only) and the scale
normalised by the median absolute depth. When the standard batch's
consensus is below `escalation_ratio_thr` of the matches, the escalated
sweep (chunks of 4096 hypotheses with LO refits) runs too, and the model
with more inliers is tried first. The decompositions run on the host in
float64 (one 3x3 SVD each).

Randomness is explicit: every attempt takes its RANSAC seeds, plain uint32
integers, from `seed_source()` (an `InitSeeds`). The default source,
`key_seed_source`, derives them as the JAX version does (initializer.py
:118,179): from the key PRNGKey(42) under `use_fixed_seed`, else from a
random one, split five ways per attempt (util/threefry.py, the same
Threefry-2x32 stream without JAX). The E path takes the H seeds (`h`,
`h_esc`), as the JAX version hands E the keys it hands H, and the 5-point
sweep its own (`e5`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import CameraModel
from stella_vslam_tpu_torch.data.frame import Frame
from stella_vslam_tpu_torch.match import area as area_match
from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.ops import triangulation as tri
from stella_vslam_tpu_torch.ops.solve import essential as esolve
from stella_vslam_tpu_torch.ops.solve import fundamental as fsolve
from stella_vslam_tpu_torch.ops.solve import homography as hsolve
from stella_vslam_tpu_torch.util import threefry

ESCALATION_CHUNKS = 8


class InitSeeds(NamedTuple):
    """RANSAC seeds of one initialization attempt (uint32 integers)."""

    h: int  # H, and E on bearings
    f: int
    h_esc: Tuple[int, ...]  # one per escalated chunk (H, and E on bearings)
    f_esc: Tuple[int, ...]
    e5: int  # the 5-point sweep of the escalation on bearings


def key_seed_source(seed: int) -> Callable[[], InitSeeds]:
    """The JAX Initializer's seeds from PRNGKey(seed), attempt by attempt:
    key, k1, k2, k3, k4 = split(key, 5); H from k1, F from k2, the escalated
    chunks from split(k3, 8) and split(k4, 8) (ransac.py:96), the 5-point
    sweep from k4."""
    key = [threefry.prng_key(seed)]
    s = threefry.key_seed

    def draw() -> InitSeeds:
        key[0], k1, k2, k3, k4 = threefry.split(key[0], 5)
        return InitSeeds(s(k1), s(k2),
                         tuple(s(k) for k in threefry.split(k3, ESCALATION_CHUNKS)),
                         tuple(s(k) for k in threefry.split(k4, ESCALATION_CHUNKS)), s(k4))
    return draw


def evaluate_hypotheses(R_h, t_h, hyp_valid, b1, b2, match_valid,
                        parallax_cos_thr: float, reproj_cos_thr: float,
                        min_pts: int = 50, require_positive_z: bool = True):
    """Triangulate every match under every hypothesis [B] in one batched
    pass and count the valid points (positive depth in both views, angular
    reprojection below threshold, enough parallax); the winner needs
    min_pts points and no rival within 70% of its count (reference
    initialize/base.cc find_most_plausible_pose). Returns (best, best_count,
    ok, pts1 [N,3], pt_ok [N], R_21, t_21) as tensors."""
    pts1 = tri.triangulate_midpoint(b1[None], b2[None], R_h, t_h)  # [B,N,3]
    pc2 = pts1 @ R_h.transpose(-1, -2) + t_h[:, None, :]
    n1 = pts1 / torch.clamp(torch.linalg.norm(pts1, dim=-1, keepdim=True), min=1e-12)
    n2 = pc2 / torch.clamp(torch.linalg.norm(pc2, dim=-1, keepdim=True), min=1e-12)
    cos1 = torch.sum(n1 * b1, dim=-1)
    cos2 = torch.sum(n2 * b2, dim=-1)
    cos_par = torch.sum(b1 * (b2 @ R_h), dim=-1)
    ok = (match_valid & (cos1 > reproj_cos_thr) & (cos2 > reproj_cos_thr)
          & (cos_par < parallax_cos_thr))
    if require_positive_z:
        ok = ok & (pts1[..., 2] > 0) & (pc2[..., 2] > 0)
    counts = torch.where(hyp_valid, ok.sum(-1), torch.full_like(hyp_valid, -1,
                                                                 dtype=torch.int64))
    best = torch.argmax(counts)
    best_count = counts[best]
    near = torch.sum(counts > 0.7 * best_count)
    ok_overall = (best_count >= min_pts) & (near <= 1)
    return best, best_count, ok_overall, pts1[best], ok[best], R_h[best], t_h[best]


class Initializer:
    NOT_READY = 0
    INITIALIZING = 1
    SUCCEEDED = 2

    def __init__(self, camera, orb_params, *, num_ransac_iters: int = 1024,
                 min_num_valid_pts: int = 50, min_num_triangulated_pts: int = 50,
                 parallax_deg_thr: float = 1.0, reproj_err_thr: float = 4.0,
                 use_fixed_seed: bool = False, escalation_ratio_thr: float = 0.45,
                 seed_source: Optional[Callable[[], InitSeeds]] = None):
        self.camera = camera
        self.orb_params = orb_params
        self.num_ransac_iters = num_ransac_iters
        self.escalation_ratio_thr = escalation_ratio_thr
        self.min_num_valid_pts = min_num_valid_pts
        self.min_num_triangulated_pts = min_num_triangulated_pts
        self.parallax_cos_thr = float(np.cos(np.deg2rad(parallax_deg_thr)))
        # angular tolerance equivalent of the pixel threshold
        fx = max(float(camera.params.fx), 100.0)
        self.reproj_cos_thr = float(np.cos(reproj_err_thr / fx))
        if seed_source is None:
            seed_source = key_seed_source(
                42 if use_fixed_seed else np.random.randint(1 << 30))
        self.seed_source = seed_source
        self.state = Initializer.NOT_READY
        # attempts that ran the escalated sweep
        self.num_escalations = 0
        self.init_frame: Optional[Frame] = None
        self.prev_matched: Optional[np.ndarray] = None
        self.init_matches: Optional[np.ndarray] = None
        # init products
        self.triangulated_pts: Optional[np.ndarray] = None
        self.triangulated_ok: Optional[np.ndarray] = None
        self.R_21 = None
        self.t_21 = None

    def reset(self):
        self.state = Initializer.NOT_READY
        self.init_frame = None

    def set_initial_frame(self, frm: Frame):
        self.init_frame = frm
        self.prev_matched = frm.h_undist_xy.copy()
        self.state = Initializer.INITIALIZING

    # ------------------------------------------------------------------
    def try_initialize_monocular(self, cur_frm: Frame) -> bool:
        """True when a two-view reconstruction succeeded; the products are
        init_frame (pose I), (R_21, t_21) and triangulated_pts."""
        if self.init_frame is None:
            self.set_initial_frame(cur_frm)
            return False
        ref = self.init_frame
        dev = ref.undist_xy.device
        idx2, accepted, _ = area_match.match_in_consistent_area(
            ref.feats.level, ref.feats.desc, ref.feats.angle, ref.feats.valid,
            torch.from_numpy(self.prev_matched).to(dev),
            cur_frm.undist_xy, cur_frm.feats.level, cur_frm.feats.desc,
            cur_frm.feats.angle, cur_frm.feats.valid, margin=100.0, lowe_ratio=0.9,
            image_size=(self.camera.params.width, self.camera.params.height))
        idx2_h = idx2.cpu().numpy().astype(np.int64)
        acc_h = accepted.cpu().numpy()
        num_matches = int(acc_h.sum())
        if num_matches < self.min_num_valid_pts:
            # restart from the current frame (initializer.cc:155-160)
            self.set_initial_frame(cur_frm)
            return False
        # update the search centres (area.cc tail)
        self.prev_matched[acc_h] = cur_frm.h_undist_xy[idx2_h[acc_h]]
        self.init_matches = np.where(acc_h, idx2_h, -1)
        # per-ref-slot aligned correspondences for the solvers
        sel = torch.clamp(idx2.to(torch.int64), min=0)
        return self._initialize_from_aligned(
            ref, cur_frm.undist_xy[sel].contiguous(), cur_frm.bearings[sel].contiguous(),
            accepted.contiguous(), num_matches)

    def _initialize_from_aligned(self, ref, cur_uv_aligned, cur_bear_aligned,
                                 mvalid, num_matches: int) -> bool:
        """Standard hypothesis batch first; below the consensus threshold
        also the escalated sweep, trying the model with more inliers first."""
        seeds = self.seed_source()
        hyp = self._two_view_hypotheses(ref, cur_uv_aligned, cur_bear_aligned, mvalid, seeds,
                                        escalated=False)
        n_std = float((hyp[3] & mvalid).sum()) if hyp is not None else 0.0
        if n_std / max(num_matches, 1) >= self.escalation_ratio_thr:
            # healthy consensus: a triangulation failure (low parallax) is
            # not retried — more hypotheses cannot make parallax
            return hyp is not None and self._finish_two_view(
                hyp, ref, cur_bear_aligned, mvalid)
        self.num_escalations += 1
        hyp_esc = self._two_view_hypotheses(ref, cur_uv_aligned, cur_bear_aligned, mvalid,
                                            seeds, escalated=True)
        n_esc = float((hyp_esc[3] & mvalid).sum()) if hyp_esc is not None else -1.0
        first, second = (hyp_esc, hyp) if n_esc >= n_std else (hyp, hyp_esc)
        if first is not None and self._finish_two_view(first, ref, cur_bear_aligned,
                                                       mvalid):
            return True
        return second is not None and self._finish_two_view(
            second, ref, cur_bear_aligned, mvalid)

    def _two_view_hypotheses(self, ref, cur_uv_aligned, cur_bear_aligned, mvalid,
                             seeds: InitSeeds, *, escalated: bool):
        """Candidate motions (R_h, t_h, hyp_valid, model inliers) from the
        H / F model selection (perspective) or the bearing-vector E solver
        (every other model); None when no solver produced a valid model."""
        dev = mvalid.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        if self.camera.model != CameraModel.PERSPECTIVE:
            b1, b2 = ref.bearings.contiguous(), cur_bear_aligned
            if escalated:
                eres = esolve.find_via_ransac_escalated(seeds.h_esc, b1, b2, mvalid)
                # the true 5-point sets: the better per-sample odds at low
                # inlier ratios
                eres5 = esolve.find_via_ransac_5pt(seeds.e5, b1, b2, mvalid,
                                                   num_hypotheses=1024)
                if bool(eres5.valid) and (not bool(eres.valid)
                                          or int(eres5.num_inliers) > int(eres.num_inliers)):
                    eres = eres5
            else:
                eres = esolve.find_via_ransac(seeds.h, b1, b2, mvalid,
                                              num_hypotheses=self.num_ransac_iters)
            if not bool(eres.valid):
                return None
            R4, t4 = esolve.decompose_f64(eres.E_21.cpu().numpy())
            return f32(R4), f32(t4), torch.ones(4, dtype=torch.bool, device=dev), \
                eres.is_inlier
        if escalated:
            hres = hsolve.find_via_ransac_escalated(seeds.h_esc, ref.undist_xy,
                                                    cur_uv_aligned, mvalid)
            fres = fsolve.find_via_ransac_escalated(seeds.f_esc, ref.undist_xy,
                                                    cur_uv_aligned, mvalid)
        else:
            hres = hsolve.find_via_ransac(seeds.h, ref.undist_xy, cur_uv_aligned, mvalid,
                                          num_hypotheses=self.num_ransac_iters,
                                          recompute=False)
            fres = fsolve.find_via_ransac(seeds.f, ref.undist_xy, cur_uv_aligned, mvalid,
                                          num_hypotheses=self.num_ransac_iters,
                                          recompute=False)
        cost_h, cost_f = float(hres.cost), float(fres.cost)
        use_h = (cost_h / max(cost_h + cost_f, 1e-9) < 0.5) and bool(hres.valid)
        p = self.camera.params
        K = np.array([[float(p.fx), 0, float(p.cx)], [0, float(p.fy), float(p.cy)],
                      [0, 0, 1]], dtype=np.float32).astype(np.float64)
        if use_h:
            Hn = np.linalg.inv(K) @ hres.H_21.cpu().numpy().astype(np.float64) @ K
            R8, t8, _, okh = hsolve.decompose(Hn)
            return f32(R8), f32(t8), torch.as_tensor(okh, device=dev), hres.is_inlier
        if bool(fres.valid):
            # E = K^T F K in float32, each product an FMA chain (the JAX
            # version's eager dots)
            Kt = torch.from_numpy(K.astype(np.float32))
            E = linalg.matmul_f32(linalg.matmul_f32(Kt.T.contiguous(), fres.F_21.cpu()), Kt)
            R4, t4 = esolve.decompose(E)
            return f32(R4), f32(t4), torch.ones(4, dtype=torch.bool, device=dev), \
                fres.is_inlier
        return None

    def _finish_two_view(self, hyp, ref, cur_bear_aligned, mvalid) -> bool:
        """Evaluate the motion hypotheses by triangulation and, on success,
        keep the scale-normalized reconstruction."""
        R_h, t_h, hyp_valid, inl = hyp
        _, _, ok, pts1, pt_ok, R21, t21 = evaluate_hypotheses(
            R_h, t_h, hyp_valid, ref.bearings, cur_bear_aligned, inl & mvalid,
            self.parallax_cos_thr, self.reproj_cos_thr,
            min_pts=self.min_num_triangulated_pts,
            require_positive_z=self.camera.model == CameraModel.PERSPECTIVE)
        if not bool(ok):
            return False
        pts1_h = pts1.cpu().numpy()
        pt_ok_h = pt_ok.cpu().numpy()
        # scale normalization by the median depth (initializer.h:104-108)
        med = float(np.median(np.abs(pts1_h[pt_ok_h][:, 2])))
        if med <= 0:
            return False
        scale = 1.0 / med
        self.triangulated_pts = pts1_h * scale
        self.triangulated_ok = pt_ok_h
        self.R_21 = R21.cpu().numpy()
        self.t_21 = t21.cpu().numpy() * scale
        self.state = Initializer.SUCCEEDED
        return True
