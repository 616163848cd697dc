"""Motion-only pose optimization: kernel D (`optimize_pose`).

Port of stella_vslam_tpu/ops/optim/pose.py optimize_pose (:39):
`num_rounds` rounds x (1 + `num_each_iter`) deferred-acceptance LM
evaluations of a 6-DoF pose, Huber weights (delta = sqrt(chi2)) in the first
`num_robust_rounds` rounds, chi-square reclassification at 5.991 (2 dof) /
7.815 (3 dof) after each round (reference pose_optimizer_g2o.cc:23-178).

`optimize_pose_batch` solves B problems on the same N slots in ONE launch
of kernel D (csrc/pose_lm.cu) on CUDA tensors, one cluster of blocks a
problem (the tracking cascade's keyframe fallback and motion model
together); `optimize_pose` is its batch of one. On CPU tensors
`optimize_pose_plain` runs the same schedule as batched torch ops, one
problem after another. `model` names the residual
(ops/optim/residuals.RESIDUAL_FNS): perspective or equirectangular.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild
from stella_vslam_tpu_torch.ops import lie
from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.camera.base import projection_family
from stella_vslam_tpu_torch.ops.optim.residuals import RESIDUAL_FNS, CamScalars

CHI_SQ_2D = 5.991
CHI_SQ_3D = 7.815


class PoseOptResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    is_inlier: torch.Tensor  # [N] bool (final chi-square classification)
    chi_sq: torch.Tensor  # [N] final per-obs chi-square


def optimize_pose_plain(R_init, t_init, pos_w, obs_uv, obs_x_right,
                        inv_sigma_sq, valid, cam: CamScalars, *,
                        model: str = "perspective", num_rounds: int = 4,
                        num_robust_rounds: int = 2,
                        num_each_iter: int = 10) -> PoseOptResult:
    res_fn = RESIDUAL_FNS[model]
    is_stereo = obs_x_right > 0
    chi_thr = torch.where(is_stereo, torch.full_like(obs_x_right, CHI_SQ_3D),
                          torch.full_like(obs_x_right, CHI_SQ_2D))
    sqrt_chi = torch.sqrt(chi_thr)
    eye6 = torch.eye(6, dtype=torch.float32, device=pos_w.device)

    def chi2_of(R, t):
        r, _, dof, depth_ok = res_fn(R, t, pos_w, obs_uv, obs_x_right, cam)
        return torch.sum(r * r * dof, dim=-1) * inv_sigma_sq, depth_ok

    def eval_state(R, t, inlier, use_huber):
        r, J, dof, depth_ok = res_fn(R, t, pos_w, obs_uv, obs_x_right, cam)
        w_obs = (valid & inlier & depth_ok).to(torch.float32) * inv_sigma_sq
        e2 = torch.sum(r * r * dof, dim=-1)
        chi = torch.sqrt(torch.clamp(e2 * inv_sigma_sq, min=1e-12))
        huber = torch.where(use_huber & (chi > sqrt_chi), sqrt_chi / chi,
                            torch.ones_like(chi))
        w = w_obs * huber
        Jw = J * (dof * w[:, None])[:, :, None]
        Hm = torch.einsum("nki,nkj->ij", Jw, J)
        b = torch.einsum("nki,nk->i", Jw, r)
        return torch.sum(w * e2), Hm, b

    def step(Hm, b, lam, R, t):
        Hd = Hm + lam * torch.diag(torch.diag(Hm)) + 1e-9 * eye6
        return lie.se3_update_left(R, t, -linalg.solve_spd_unrolled(Hd, b))

    R, t, inlier = R_init, t_init, valid
    for rnd in range(num_rounds):
        use_huber = torch.tensor(rnd < num_robust_rounds, device=pos_w.device)
        cost_b, H_b, b_b = eval_state(R, t, inlier, use_huber)
        R_b, t_b = R, t
        R_try, t_try = step(H_b, b_b, 1e-4, R, t)
        lam = torch.tensor(1e-4, dtype=torch.float32, device=pos_w.device)
        for _ in range(num_each_iter):
            cost_t, H_t, b_t = eval_state(R_try, t_try, inlier, use_huber)
            accept = cost_t < cost_b
            R_b = torch.where(accept, R_try, R_b)
            t_b = torch.where(accept, t_try, t_b)
            H_b = torch.where(accept, H_t, H_b)
            b_b = torch.where(accept, b_t, b_b)
            cost_b = torch.where(accept, cost_t, cost_b)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            R_try, t_try = step(H_b, b_b, lam, R_b, t_b)
        R, t = R_b, t_b
        chi2, depth_ok = chi2_of(R, t)
        inlier = valid & depth_ok & (chi2 <= chi_thr)
    chi2, _ = chi2_of(R, t)
    return PoseOptResult(R_cw=R, t_cw=t, is_inlier=inlier, chi_sq=chi2)


# the blocks of the cluster that solves one problem and the slots a block
# holds in shared memory (kCluster and kMaxSlotsPerBlock in csrc/pose_lm.cu):
# the kernel takes N <= MAX_SLOTS_PER_BLOCK * CLUSTER
CLUSTER = 8
MAX_SLOTS_PER_BLOCK = 6400
_SLOT_INPUTS = (("pos_w", 3, torch.float32), ("obs_uv", 2, torch.float32),
                ("obs_x_right", 0, torch.float32), ("inv_sigma_sq", 0, torch.float32),
                ("valid", 0, torch.bool))


def optimize_pose_batch_plain(R_init, t_init, pos_w, obs_uv, obs_x_right,
                              inv_sigma_sq, valid, cam: CamScalars, **kw) -> PoseOptResult:
    """`optimize_pose_plain` on each of the B problems in turn (the
    arguments as `optimize_pose_batch` takes them)."""
    slot = (pos_w, obs_uv, obs_x_right, inv_sigma_sq, valid)
    batched = [a.dim() == (3 if w else 2) for a, (_, w, _) in zip(slot, _SLOT_INPUTS)]
    res = [optimize_pose_plain(R_init[b], t_init[b],
                               *[a[b] if bt else a for a, bt in zip(slot, batched)], cam, **kw)
           for b in range(R_init.shape[0])]
    return PoseOptResult(*[torch.stack(f) for f in zip(*res)])


def optimize_pose_batch(R_init, t_init, pos_w, obs_uv, obs_x_right, inv_sigma_sq,
                        valid, cam: CamScalars, *, model: str = "perspective",
                        num_rounds: int = 4, num_robust_rounds: int = 2,
                        num_each_iter: int = 10) -> PoseOptResult:
    """B problems on the same N slots: R_init [B,3,3], t_init [B,3],
    pos_w [B,N,3] and valid [B,N]; obs_uv [N,2] or [B,N,2], obs_x_right and
    inv_sigma_sq [N] or [B,N] (a tensor without the leading B is shared).
    Kernel D on CUDA tensors (one launch, a cluster of CLUSTER blocks a
    problem), the plain version on CPU tensors. Returns a PoseOptResult
    with a leading B."""
    kw = dict(model=model, num_rounds=num_rounds, num_robust_rounds=num_robust_rounds,
              num_each_iter=num_each_iter)
    if not pos_w.is_cuda:
        return optimize_pose_batch_plain(R_init, t_init, pos_w, obs_uv, obs_x_right,
                                         inv_sigma_sq, valid, cam, **kw)
    kind = projection_family(model)
    B, N = pos_w.shape[0], pos_w.shape[1]
    dev = pos_w.device
    if N > MAX_SLOTS_PER_BLOCK * CLUSTER:
        raise ValueError(f"optimize_pose_batch: at most {MAX_SLOTS_PER_BLOCK * CLUSTER} slots "
                         f"(N={N})")
    for t, shape in ((R_init, (B, 3, 3)), (t_init, (B, 3))):
        if t.shape != shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"optimize_pose_batch: expected float32 {shape} on {dev}")
    ptrs = []
    keep = []  # the contiguous copies, referenced until the launch is enqueued
    for (name, w, dt), t in zip(_SLOT_INPUTS, (pos_w, obs_uv, obs_x_right, inv_sigma_sq,
                                               valid)):
        tail = (N, w) if w else (N,)
        if t.dtype != dt or t.device != dev or tuple(t.shape) not in (tail, (B,) + tail):
            raise ValueError(f"optimize_pose_batch: {name} must be {dt} {tail} or "
                             f"{(B,) + tail} on {dev}")
        t = t.contiguous()
        keep.append(t)
        ptrs += [t.data_ptr(), t[0].numel() if t.dim() > len(tail) else 0]
    R0, t0 = R_init.contiguous(), t_init.contiguous()
    R_out = torch.empty((B, 3, 3), dtype=torch.float32, device=dev)
    t_out = torch.empty((B, 3), dtype=torch.float32, device=dev)
    inlier = torch.empty((B, N), dtype=torch.bool, device=dev)
    chi2 = torch.empty((B, N), dtype=torch.float32, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_pose_lm(
        kind, B, N, *ptrs, R0.data_ptr(), t0.data_ptr(), cam.fx, cam.fy, cam.cx, cam.cy,
        cam.focal_x_baseline, cam.width, cam.height, num_rounds, num_robust_rounds,
        num_each_iter, R_out.data_ptr(), t_out.data_ptr(), inlier.data_ptr(), chi2.data_ptr(),
        kbuild.stream_ptr(dev)), "pose_lm")
    optimize_pose_batch.launches += 1
    return PoseOptResult(R_cw=R_out, t_cw=t_out, is_inlier=inlier, chi_sq=chi2)


optimize_pose_batch.launches = 0


def optimize_pose(R_init, t_init, pos_w, obs_uv, obs_x_right, inv_sigma_sq,
                  valid, cam: CamScalars, *, model: str = "perspective",
                  num_rounds: int = 4, num_robust_rounds: int = 2,
                  num_each_iter: int = 10) -> PoseOptResult:
    """One problem: `optimize_pose_batch`'s batch of one (kernel D on CUDA
    tensors, the plain version on CPU tensors)."""
    kw = dict(model=model, num_rounds=num_rounds, num_robust_rounds=num_robust_rounds,
              num_each_iter=num_each_iter)
    if not pos_w.is_cuda:
        return optimize_pose_plain(R_init, t_init, pos_w, obs_uv, obs_x_right, inv_sigma_sq,
                                   valid, cam, **kw)
    r = optimize_pose_batch(R_init[None], t_init[None], pos_w[None], obs_uv, obs_x_right,
                            inv_sigma_sq, valid[None], cam, **kw)
    return PoseOptResult(*[f[0] for f in r])
