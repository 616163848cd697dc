"""Motion-only pose optimization: kernel D (`optimize_pose`).

Port of stella_vslam_tpu/ops/optim/pose.py optimize_pose (:39):
`num_rounds` rounds x (1 + `num_each_iter`) deferred-acceptance LM
evaluations of a 6-DoF pose, Huber weights (delta = sqrt(chi2)) in the first
`num_robust_rounds` rounds, chi-square reclassification at 5.991 (2 dof) /
7.815 (3 dof) after each round (reference pose_optimizer_g2o.cc:23-178).

On CUDA tensors the whole schedule is ONE launch of kernel D
(csrc/pose_lm.cu); on CPU tensors `optimize_pose_plain` runs the same
schedule as batched torch ops. `model` names the residual
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


def optimize_pose(R_init, t_init, pos_w, obs_uv, obs_x_right, inv_sigma_sq,
                  valid, cam: CamScalars, *, model: str = "perspective",
                  num_rounds: int = 4, num_robust_rounds: int = 2,
                  num_each_iter: int = 10) -> PoseOptResult:
    """Kernel D on CUDA tensors, the plain version on CPU tensors."""
    if not pos_w.is_cuda:
        return optimize_pose_plain(
            R_init, t_init, pos_w, obs_uv, obs_x_right, inv_sigma_sq, valid,
            cam, model=model, num_rounds=num_rounds,
            num_robust_rounds=num_robust_rounds, num_each_iter=num_each_iter)
    kind = projection_family(model)
    N = pos_w.shape[0]
    dev = pos_w.device
    args = [(pos_w, (N, 3), torch.float32), (obs_uv, (N, 2), torch.float32),
            (obs_x_right, (N,), torch.float32), (inv_sigma_sq, (N,), torch.float32),
            (valid, (N,), torch.bool), (R_init, (3, 3), torch.float32),
            (t_init, (3,), torch.float32)]
    ins = []
    for t, shape, dt in args:
        if t.shape != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"optimize_pose: expected {dt} {shape} on {dev}")
        ins.append(t.contiguous())
    R_out = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t_out = torch.empty(3, dtype=torch.float32, device=dev)
    inlier = torch.empty(N, dtype=torch.bool, device=dev)
    chi2 = torch.empty(N, dtype=torch.float32, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_pose_lm(
        kind, N, *[t.data_ptr() for t in ins], cam.fx, cam.fy, cam.cx, cam.cy,
        cam.focal_x_baseline, cam.width, cam.height, num_rounds, num_robust_rounds, num_each_iter,
        R_out.data_ptr(), t_out.data_ptr(), inlier.data_ptr(), chi2.data_ptr(),
        kbuild.stream_ptr(dev)), "pose_lm")
    optimize_pose.launches += 1
    return PoseOptResult(R_cw=R_out, t_cw=t_out, is_inlier=inlier, chi_sq=chi2)


optimize_pose.launches = 0
