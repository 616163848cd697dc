"""The per-frame tracking cascade on the card.

Port of stella_vslam_tpu/module/tracking_kernels.py `track_frame` (:164):

  1. motion-model stage: project last-frame associations with the predicted
     pose (kernel R), match (kernel C), optimize the pose (kernel D);
  2. keyframe fallback: brute-force match against the reference keyframe's
     associated slots (kernel C) + pose optimization from the last pose;
  3. local-map stage: visibility-gate the device landmark table (kernel R),
     match it against the still-unassociated slots (kernel C), final pose
     optimization (kernel D), one slot per landmark.

The JAX version runs the fallback under lax.cond when stage 1 keeps fewer
than `num_matches_thr` inliers; here both run and `torch.where` on a device
predicate picks one, so a dispatch reads nothing back from the device.
Since both inlier counts are at hand, stage 1 is kept only when it also has
at least a quarter of the fallback's: a motion model that misses a jump
(bench.py's stereo and RGBD legs jump 0.8 m at their turnaround) can leave
`num_matches_thr` chance matches that the pose optimization fits with a
wrong pose, 8-18 degrees off, while the keyframe fallback finds hundreds. The per-slot re-indexing, the landmark dedup and the chain rebase
of the pipelined tracker are kernel Q (csrc/track_assoc.cu) on CUDA
tensors, their plain versions on CPU tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stella_vslam_tpu_torch.camera import base as cam_base
from stella_vslam_tpu_torch.kernels import build as kbuild
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


# ---------------------------------------------------------------------------
# kernel Q and its plain versions
# ---------------------------------------------------------------------------


def scatter_to_current_plain(best_idx, accepted, src_pos, src_id, N):
    """Matcher output is per SOURCE (best current slot, accepted); re-index
    it per CURRENT slot with the source's landmark position and id. A slot
    picked by several accepted sources is ambiguous and dropped. Returns
    (pos [N,3], id [N] i32, held [N] bool)."""
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


def dedup_by_id_plain(has, ids, score):
    """One slot per landmark: among held slots sharing an id keep the lowest
    score (ties to the lowest slot index). Returns (keep [N] bool, ids [N]
    i32 with -1 where not kept)."""
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


def rebase_chain_plain(la_pos, la_valid, la_id, tbl_f32, tbl_u32, A_R, A_t,
                       R_last, t_last, R_prev, t_prev):
    """Re-gather the chained positions from a published table by landmark id
    (the lowest row where an id repeats; ids absent from it are
    invalidated) and re-anchor the chained poses, T_new = T_old @ A.
    Returns (pos, valid, id, R_l, t_l, R_p, t_p)."""
    tbl_ids = tbl_u32[:, 8]
    eq = la_id[:, None] == tbl_ids[None, :]  # [N, C]
    found = eq.any(dim=1) & (la_id >= 0)
    row = torch.argmax(eq.to(torch.int8), dim=1)
    new_pos = torch.where(found[:, None], tbl_f32[row, 0:3], la_pos)
    new_valid = la_valid & found
    new_id = torch.where(found, la_id, torch.full_like(la_id, -1))
    return (new_pos, new_valid, new_id, R_last @ A_R, R_last @ A_t + t_last,
            R_prev @ A_R, R_prev @ A_t + t_prev)


def _check(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA {dtype} tensor of shape {tuple(shape)}")


def _rows(name, t, width):
    """A CUDA f32 [M, >= width] tensor whose rows are contiguous: its row
    stride in elements."""
    if t.dim() != 2 or t.shape[1] < width or t.dtype != torch.float32 or not t.is_cuda \
            or t.stride(1) != 1:
        raise ValueError(f"{name}: expected a CUDA float32 [M, {width}] tensor with "
                         "contiguous rows")
    return t.stride(0)


def scatter_to_current(best_idx, accepted, src_pos, src_id, N):
    """Kernel Q's scatter on CUDA tensors, the plain version on CPU tensors.
    best_idx [M] i32 and src_id [M] i32 may be strided, src_pos [M, >=3]
    f32 rows (the packed table's first three columns as they are)."""
    if not src_pos.is_cuda:
        return scatter_to_current_plain(best_idx, accepted, src_pos, src_id, N)
    M = best_idx.shape[0]
    _check("scatter_to_current: best_idx", best_idx, (M,), torch.int32)
    _check("scatter_to_current: accepted", accepted, (M,), torch.bool)
    _check("scatter_to_current: src_id", src_id, (M,), torch.int32)
    if not accepted.is_contiguous() or src_pos.shape[0] != M:
        raise ValueError("scatter_to_current: accepted must be contiguous, src_pos [M, >=3]")
    pos_stride = _rows("scatter_to_current: src_pos", src_pos, 3)
    dev = src_pos.device
    pos = torch.empty((N, 3), dtype=torch.float32, device=dev)
    ids = torch.empty(N, dtype=torch.int32, device=dev)
    has = torch.empty(N, dtype=torch.bool, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_scatter_to_current(
        M, N, best_idx.data_ptr(), best_idx.stride(0), accepted.data_ptr(),
        src_pos.data_ptr(), pos_stride, src_id.data_ptr(), src_id.stride(0),
        pos.data_ptr(), ids.data_ptr(), has.data_ptr(), kbuild.stream_ptr(dev)),
        "scatter_to_current")
    scatter_to_current.launches += 1
    return pos, ids, has


MAX_DEDUP_SLOTS = 4096  # the id table of 2 x 8192 x 8 bytes fits one block


def dedup_by_id(has, ids, score):
    """Kernel Q's dedup on CUDA tensors, the plain version on CPU tensors."""
    if not has.is_cuda:
        return dedup_by_id_plain(has, ids, score)
    N = has.shape[0]
    if N > MAX_DEDUP_SLOTS:
        raise ValueError(f"dedup_by_id: at most {MAX_DEDUP_SLOTS} slots (N={N})")
    _check("dedup_by_id: has", has, (N,), torch.bool)
    _check("dedup_by_id: ids", ids, (N,), torch.int32)
    _check("dedup_by_id: score", score, (N,), torch.float32)
    has, ids, score = has.contiguous(), ids.contiguous(), score.contiguous()
    keep = torch.empty(N, dtype=torch.bool, device=has.device)
    out = torch.empty(N, dtype=torch.int32, device=has.device)
    lib = kbuild.load()
    kbuild.check(lib.svt_dedup_by_id(
        N, has.data_ptr(), ids.data_ptr(), score.data_ptr(), keep.data_ptr(),
        out.data_ptr(), kbuild.stream_ptr(has.device)), "dedup_by_id")
    dedup_by_id.launches += 1
    return keep, out


def rebase_chain(la_pos, la_valid, la_id, tbl_f32, tbl_u32, A_R, A_t,
                 R_last, t_last, R_prev, t_prev):
    """Kernel Q's chain rebase on CUDA tensors, the plain version on CPU
    tensors (tracking_module._rebase_chain of the JAX package)."""
    if not la_pos.is_cuda:
        return rebase_chain_plain(la_pos, la_valid, la_id, tbl_f32, tbl_u32, A_R, A_t,
                                  R_last, t_last, R_prev, t_prev)
    N, C = la_pos.shape[0], tbl_f32.shape[0]
    f32 = torch.float32
    for name, t, shape, dt in (
            ("la_pos", la_pos, (N, 3), f32), ("la_valid", la_valid, (N,), torch.bool),
            ("la_id", la_id, (N,), torch.int32), ("tbl_f32", tbl_f32, (C, 8), f32),
            ("tbl_u32", tbl_u32, (C, 10), torch.int32), ("A_R", A_R, (3, 3), f32),
            ("A_t", A_t, (3,), f32), ("R_last", R_last, (3, 3), f32),
            ("t_last", t_last, (3,), f32), ("R_prev", R_prev, (3, 3), f32),
            ("t_prev", t_prev, (3,), f32)):
        _check("rebase_chain: " + name, t, shape, dt)
        if not t.is_contiguous():
            raise ValueError(f"rebase_chain: {name} must be contiguous")
    dev = la_pos.device
    pos = torch.empty((N, 3), dtype=f32, device=dev)
    valid = torch.empty(N, dtype=torch.bool, device=dev)
    ids = torch.empty(N, dtype=torch.int32, device=dev)
    poses = torch.empty(24, dtype=f32, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_rebase_chain(
        N, C, *[t.data_ptr() for t in (la_pos, la_valid, la_id, tbl_f32, tbl_u32, A_R, A_t,
                                       R_last, t_last, R_prev, t_prev)],
        pos.data_ptr(), valid.data_ptr(), ids.data_ptr(), poses.data_ptr(),
        kbuild.stream_ptr(dev)), "rebase_chain")
    rebase_chain.launches += 1
    return (pos, valid, ids, poses[0:9].view(3, 3), poses[9:12], poses[12:21].view(3, 3),
            poses[21:24])


scatter_to_current.launches = 0
dedup_by_id.launches = 0
rebase_chain.launches = 0


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
        tbl_desc = tbl_u32[:, :8].contiguous()
        tbl_ids = tbl_u32[:, 8]
        N = cur_desc.shape[0]
        L = self.orb.num_levels
        p = self.camera.params
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

        # ---------- stage 2: keyframe fallback (the lax.cond's other arm) ----
        b_idx, b_acc, _ = robust_match.brute_force_match(
            cur_angle, cur_desc, cur_valid, kf_angle, kf_desc, kf_assoc_valid,
            lowe_ratio=0.75)
        pos2, id2, has2 = scatter_to_current(b_idx, b_acc, kf_assoc_pos, kf_assoc_id, N)
        res2 = self._pose_opt(R_last, t_last, pos2, cur_undist, cur_xr, cur_level, has2)
        inl2 = res2.is_inlier & has2
        id2 = torch.where(inl2, id2, torch.full_like(id2, -1))

        # ---------- stage 1: motion-model tracking ----------
        if use_motion:
            uv_l, _, vis_l, lm_xr, _ = cam_base.reproject_gate(
                p, R_pred, t_pred, last_assoc_pos)
            m_idx, m_acc, _ = proj_match.match_current_and_last_frames(
                cur_undist, cur_level, cur_desc, cur_valid, cur_angle, cur_xr,
                last_desc, last_level, last_angle, uv_l, lm_xr,
                last_assoc_valid & vis_l,
                scale_factors=self.scale_factors, num_levels=L,
                margin=self.margin_last)
            pos1, id1, has1 = scatter_to_current(
                m_idx, m_acc, last_assoc_pos, last_assoc_id, N)
            res1 = self._pose_opt(R_pred, t_pred, pos1, cur_undist, cur_xr,
                                  cur_level, has1)
            inl1 = res1.is_inlier & has1
            n1 = inl1.sum()
            # the stage-1 result when it kept enough inliers and at least a
            # quarter of the fallback's, else the fallback's, picked on the
            # device
            take1 = (n1 >= self.num_matches_thr) & (4 * n1 >= inl2.sum())
            R_s1 = torch.where(take1, res1.R_cw, res2.R_cw)
            t_s1 = torch.where(take1, res1.t_cw, res2.t_cw)
            pos_s1 = torch.where(take1, pos1, pos2)
            has_s1 = torch.where(take1, inl1, inl2)
            id_s1 = torch.where(take1, torch.where(inl1, id1, torch.full_like(id1, -1)), id2)
            used_fb = ~take1
        else:
            n1 = torch.zeros((), dtype=torch.int64, device=cur_desc.device)
            R_s1, t_s1, pos_s1, has_s1, id_s1 = res2.R_cw, res2.t_cw, pos2, inl2, id2
            used_fb = torch.ones((), dtype=torch.bool, device=cur_desc.device)

        # ---------- stage 3: local-map tracking over the table ----------
        uv_t, _, observable, lm_xr_t, pred_scale = cam_base.reproject_gate(
            p, R_s1, t_s1, tbl_f32, tbl_u32, log_scale=self.log_scale, num_levels=L)
        t_idx, t_acc, _ = proj_match.match_frame_and_landmarks(
            cur_undist, cur_level, cur_desc, cur_valid, has_s1, cur_xr,
            tbl_desc, uv_t, lm_xr_t, pred_scale, observable,
            scale_factors=self.scale_factors, num_levels=L,
            margin=margin_local, lowe_ratio=0.6)
        pos_new, id_new, has_new = scatter_to_current(t_idx, t_acc, tbl_pos, tbl_ids, N)
        # a chained association keeps its slot; a fresh table match fills any
        # other slot (a duplicate landmark is resolved after the optimization)
        pos_all = torch.where(has_s1[:, None], pos_s1, pos_new)
        ids_all = torch.where(has_s1, id_s1, id_new)
        has_all = has_s1 | has_new

        res3 = self._pose_opt(R_s1, t_s1, pos_all, cur_undist, cur_xr,
                              cur_level, has_all)
        inlier = res3.is_inlier & has_all
        inlier, ids_all = dedup_by_id(
            inlier, ids_all,
            torch.where(inlier, res3.chi_sq, torch.full_like(res3.chi_sq, math.inf)))
        f32 = torch.float32
        counts = torch.stack([n1.to(f32), used_fb.to(f32), has_all.sum().to(f32),
                              inlier.sum().to(f32)])
        out_ids = torch.where(inlier, ids_all, torch.full_like(ids_all, -1))
        packed = torch.cat([res3.R_cw.reshape(-1), res3.t_cw, counts,
                            out_ids.to(f32), inlier.to(f32), observable.to(f32)])
        return FullTrackOut(
            packed=packed,
            assoc_pos=torch.where(inlier[:, None], pos_all, torch.zeros_like(pos_all)),
            assoc_valid=inlier, assoc_id=out_ids,
            R_cw=res3.R_cw, t_cw=res3.t_cw)
