"""The per-frame tracking cascade on the card.

Port of stella_vslam_tpu/module/tracking_kernels.py `track_frame` (:164):

  1. motion-model stage: project last-frame associations with the predicted
     pose, match (kernel C), optimize the pose (kernel D);
  2. keyframe fallback when stage 1 keeps fewer than `num_matches_thr`
     inliers: brute-force match against the reference keyframe's
     associated slots (kernel C) + pose optimization from the last pose;
  3. local-map stage: visibility-gate the device landmark table, match it
     against the still-unassociated slots (kernel C), final pose
     optimization (kernel D), one slot per landmark.

The JAX version runs the fallback under lax.cond inside one program; here it
is a Python branch on stage 1's inlier count, which costs one device-to-host
read of that count per frame. Per-slot re-indexing and the landmark dedup
are scatter/index ops instead of the TPU's one-hot forms.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stella_vslam_tpu_torch.camera import base as cam_base
from stella_vslam_tpu_torch.match import projection as proj_match
from stella_vslam_tpu_torch.match import robust as robust_match
from stella_vslam_tpu_torch.ops import lie
from stella_vslam_tpu_torch.ops.optim import pose as pose_opt
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars


class FullTrackOut(NamedTuple):
    """packed: pose R(9) t(3) | counts(4) | lm_id(N) | inlier(N) |
    observable(C), f32 (ids exact below 2^24) — the host reads it with one
    device-to-host copy. The other fields stay on the device, chained into
    the next frame."""

    packed: torch.Tensor  # [16 + 2N + C] f32
    assoc_pos: torch.Tensor  # [N,3]
    assoc_valid: torch.Tensor  # [N] bool
    assoc_id: torch.Tensor  # [N] i32 (-1 = none)
    R_cw: torch.Tensor  # [3,3]
    t_cw: torch.Tensor  # [3]


def _scatter_matches_to_current(best_idx, accepted, src_pos, src_id, N):
    """Matcher output is per SOURCE (best current slot, accepted); re-index
    it per CURRENT slot with the source's landmark position and id. A slot
    picked by several accepted sources is ambiguous and dropped."""
    tgt = best_idx.long()[accepted]
    count = torch.bincount(tgt, minlength=N)
    keep = count[best_idx.long()] == 1
    sel = accepted & keep
    idx = best_idx.long()[sel]
    pos_cur = torch.zeros((N, 3), dtype=src_pos.dtype, device=src_pos.device)
    pos_cur[idx] = src_pos[sel]
    id_cur = torch.full((N,), -1, dtype=torch.int32, device=src_pos.device)
    id_cur[idx] = src_id[sel].to(torch.int32)
    return pos_cur, id_cur, count == 1


def _dedup_by_landmark_id(has, ids, score):
    """One slot per landmark: among slots sharing an id keep the lowest
    score (ties to the lowest slot index), after the pose optimization."""
    N = has.shape[0]
    dev = has.device
    slots = torch.nonzero(has).flatten()
    keep = torch.zeros(N, dtype=torch.bool, device=dev)
    if slots.numel():
        grp = torch.unique(ids[slots], return_inverse=True)[1]
        s = score[slots]
        min_s = torch.full((int(grp.max()) + 1,), float("inf"), device=dev)
        min_s = min_s.scatter_reduce(0, grp, s, reduce="amin")
        at_min = s == min_s[grp]
        first = torch.full_like(min_s, N, dtype=torch.int64)
        first = first.scatter_reduce(0, grp[at_min], slots[at_min], reduce="amin")
        keep[slots[at_min & (slots == first[grp])]] = True
    ids = torch.where(keep, ids, torch.full_like(ids, -1))
    return keep, ids


def make_cam_scalars(camera) -> CamScalars:
    p = camera.params
    return CamScalars(fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, width=p.width,
                      height=p.height, focal_x_baseline=p.focal_x_baseline)


class TrackingKernels:
    """The cascade, specialised to (camera, orb_params) on one device."""

    def __init__(self, camera, orb_params, device="cuda", margin_last: float = 20.0,
                 margin_local: float = 5.0, num_matches_thr: int = 10):
        self.camera = camera
        self.orb = orb_params
        self.device = torch.device(device)
        self.cam_scalars = make_cam_scalars(camera)
        self.scale_factors = torch.tensor(orb_params.scale_factors,
                                          dtype=torch.float32, device=self.device)
        self.inv_sigma_sq = torch.tensor(orb_params.inv_level_sigma_sq,
                                         dtype=torch.float32, device=self.device)
        # f32 log of the scale factor, as the JAX version takes it
        self.log_scale = float(np.log(np.float32(orb_params.scale_factor)))
        self.margin_last = margin_last
        self.margin_local = margin_local
        self.num_matches_thr = num_matches_thr

    def _pose_opt(self, R0, t0, pos, uv, xr, level, has):
        return pose_opt.optimize_pose(
            R0, t0, pos, uv, xr, self.inv_sigma_sq[level.long()], has,
            self.cam_scalars)

    def _reproject(self, R, t, pos):
        uv, depth, vis = cam_base.reproject_to_image(
            self.camera.model, self.camera.params, R, t, pos)
        xr = torch.where(
            depth > 1e-6,
            uv[:, 0] - self.cam_scalars.focal_x_baseline / torch.clamp(depth, min=1e-6),
            torch.full_like(depth, -1.0))
        return uv, depth, vis, xr

    def track_frame(
        self,
        cur_undist, cur_level, cur_desc, cur_valid, cur_angle, cur_xr,
        last_desc, last_level, last_angle,
        last_assoc_pos, last_assoc_valid, last_assoc_id,
        kf_desc, kf_angle, kf_assoc_pos, kf_assoc_valid, kf_assoc_id,
        tbl_f32, tbl_u32,
        R_last, t_last, R_prev, t_prev,
        use_motion: bool = True, margin_local: float = 5.0,
    ) -> FullTrackOut:
        tbl_pos = tbl_f32[:, 0:3]
        tbl_normal = tbl_f32[:, 3:6]
        tbl_min_dist = tbl_f32[:, 6]
        tbl_max_dist = tbl_f32[:, 7]
        tbl_desc = tbl_u32[:, :8].contiguous()
        tbl_ids = tbl_u32[:, 8]
        tbl_valid = tbl_u32[:, 9] > 0
        N = cur_desc.shape[0]
        L = self.orb.num_levels
        # chained f32 rotations are re-projected onto SO(3) before R^T is
        # used as the inverse (the error otherwise grows ~3x per frame)
        R_last = lie.so3_project(R_last)
        R_prev = lie.so3_project(R_prev)
        # prediction = twist o T_last, twist = T_last o T_prev^-1
        Rp_inv = R_prev.T
        tp_inv = -Rp_inv @ t_prev
        R_tw = R_last @ Rp_inv
        t_tw = R_last @ tp_inv + t_last
        R_pred = R_tw @ R_last
        t_pred = R_tw @ t_last + t_tw

        # ---------- stage 1: motion-model tracking ----------
        n1 = 0
        if use_motion:
            uv_l, _, vis_l, lm_xr = self._reproject(R_pred, t_pred, last_assoc_pos)
            m_idx, m_acc, _ = proj_match.match_current_and_last_frames(
                cur_undist, cur_level, cur_desc, cur_valid, cur_angle, cur_xr,
                last_desc, last_level, last_angle, uv_l, lm_xr,
                last_assoc_valid & vis_l,
                scale_factors=self.scale_factors, num_levels=L,
                margin=self.margin_last)
            pos1, id1, has1 = _scatter_matches_to_current(
                m_idx, m_acc, last_assoc_pos, last_assoc_id, N)
            res1 = self._pose_opt(R_pred, t_pred, pos1, cur_undist, cur_xr,
                                  cur_level, has1)
            inl1 = res1.is_inlier & has1
            # host read of the stage-1 inlier count: picks the branch below
            n1 = int(inl1.sum())

        # ---------- stage 2: keyframe fallback ----------
        if use_motion and n1 >= self.num_matches_thr:
            R_s1, t_s1, pos_s1, has_s1 = res1.R_cw, res1.t_cw, pos1, inl1
            id_s1 = torch.where(inl1, id1, torch.full_like(id1, -1))
            used_fb = 0
        else:
            b_idx, b_acc, _ = robust_match.brute_force_match(
                cur_angle, cur_desc, cur_valid, kf_angle, kf_desc, kf_assoc_valid,
                lowe_ratio=0.75)
            pos_s1, id2, has2 = _scatter_matches_to_current(
                b_idx, b_acc, kf_assoc_pos, kf_assoc_id, N)
            res2 = self._pose_opt(R_last, t_last, pos_s1, cur_undist, cur_xr,
                                  cur_level, has2)
            has_s1 = res2.is_inlier & has2
            R_s1, t_s1 = res2.R_cw, res2.t_cw
            id_s1 = torch.where(has_s1, id2, torch.full_like(id2, -1))
            used_fb = 1

        # ---------- stage 3: local-map tracking over the table ----------
        uv_t, depth_t, in_img, lm_xr_t = self._reproject(R_s1, t_s1, tbl_pos)
        cam_center = -R_s1.T @ t_s1
        ray = tbl_pos - cam_center
        dist = torch.linalg.norm(ray, dim=-1)
        dist_ok = (dist >= 0.8 * tbl_min_dist) & (dist <= 1.3 * tbl_max_dist)
        cosang = torch.sum(ray * tbl_normal, dim=-1) / torch.clamp(dist, min=1e-9)
        observable = tbl_valid & in_img & dist_ok & (cosang > 0.5) & (depth_t > 0)
        ratio = torch.clamp(tbl_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
        pred_scale = torch.clamp(
            torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / self.log_scale),
            0, L - 1).to(torch.int32)
        t_idx, t_acc, _ = proj_match.match_frame_and_landmarks(
            cur_undist, cur_level, cur_desc, cur_valid, has_s1, cur_xr,
            tbl_desc, uv_t, lm_xr_t, pred_scale, observable,
            scale_factors=self.scale_factors, num_levels=L,
            margin=margin_local, lowe_ratio=0.6)
        pos_new, id_new, has_new = _scatter_matches_to_current(
            t_idx, t_acc, tbl_pos, tbl_ids, N)
        # a chained association keeps its slot; a fresh table match fills any
        # other slot (a duplicate landmark is resolved after the optimization)
        pos_all = torch.where(has_s1[:, None], pos_s1, pos_new)
        ids_all = torch.where(has_s1, id_s1, id_new)
        has_all = has_s1 | has_new

        res3 = self._pose_opt(R_s1, t_s1, pos_all, cur_undist, cur_xr,
                              cur_level, has_all)
        inlier = res3.is_inlier & has_all
        inlier, ids_all = _dedup_by_landmark_id(
            inlier, ids_all,
            torch.where(inlier, res3.chi_sq, torch.full_like(res3.chi_sq, math.inf)))
        dev = cur_desc.device
        counts = torch.tensor([n1, used_fb], dtype=torch.float32, device=dev)
        counts = torch.cat([counts, has_all.sum().to(torch.float32)[None],
                            inlier.sum().to(torch.float32)[None]])
        out_ids = torch.where(inlier, ids_all, torch.full_like(ids_all, -1))
        packed = torch.cat([res3.R_cw.reshape(-1), res3.t_cw, counts,
                            out_ids.to(torch.float32), inlier.to(torch.float32),
                            observable.to(torch.float32)])
        return FullTrackOut(
            packed=packed,
            assoc_pos=torch.where(inlier[:, None], pos_all, torch.zeros_like(pos_all)),
            assoc_valid=inlier, assoc_id=out_ids,
            R_cw=res3.R_cw, t_cw=res3.t_cw)
