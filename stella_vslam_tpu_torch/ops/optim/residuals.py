"""Reprojection residuals + analytic pose Jacobians of the pose optimizer.

Port of `perspective_residual` (stella_vslam_tpu/ops/optim/residuals.py:46),
`equirectangular_residual` (:92), `RESIDUAL_FNS` (:136) and `CamScalars`:
perspective mono r = [u, v] (2 dof), stereo/RGBD adds
u_right = u - fx*baseline/z (3 dof), also for fisheye and radial division
on their undistorted keypoints; equirectangular r = [du, dv] in its
pixels, du wrapped into [-w/2, w/2) by a floor modulo (torch.remainder, as
jnp.mod), the third row with dof 0. The pose tangent is xi = [rho, phi]
with left-multiplicative updates (ops/lie.se3_update_left).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stella_vslam_tpu_torch.ops import lie


class CamScalars(NamedTuple):
    """Camera scalars the residuals use (f32-rounded Python floats)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: float
    height: float
    focal_x_baseline: float


def perspective_residual(R_cw, t_cw, pos_w, obs_uv, obs_x_right, cam: CamScalars):
    """Returns (r [N,3], J_pose [N,3,6], dof_mask [N,3], depth_ok [N])."""
    Xc = pos_w @ R_cw.T + t_cw
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    u_r = u - cam.focal_x_baseline * iz
    has_stereo = obs_x_right > 0
    zero = torch.zeros_like(x)
    r = torch.stack([u - obs_uv[:, 0], v - obs_uv[:, 1],
                     torch.where(has_stereo, u_r - obs_x_right, zero)], dim=-1)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    row_r = torch.stack(
        [cam.fx * iz, zero, -cam.fx * x * iz2 + cam.focal_x_baseline * iz2], dim=-1)
    dpi = torch.stack([row_u, row_v, row_r], dim=-2)  # [N,3,3]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    J_pose = dpi @ torch.cat([eye, -lie.hat(Xc)], dim=-1)  # [N,3,6]
    dof = torch.stack([torch.ones_like(z), torch.ones_like(z),
                       has_stereo.to(z.dtype)], dim=-1)
    return r, J_pose, dof, z > 1e-4


def equirect_scales(cam: CamScalars):
    """(ku, kv) = (width / 2 pi, height / pi), divided in float32 as the JAX
    version divides its float32 scalars."""
    f32 = np.float32
    return (float(f32(cam.width) / f32(2.0 * math.pi)),
            float(f32(cam.height) / f32(math.pi)))


def equirectangular_residual(R_cw, t_cw, pos_w, obs_uv, obs_x_right, cam: CamScalars):
    """Returns (r [N,3], J_pose [N,3,6], dof_mask [N,3], depth_ok [N]);
    obs_x_right is ignored (monocular only)."""
    Xc = pos_w @ R_cw.T + t_cw
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    L = torch.linalg.norm(Xc, dim=-1)
    L = torch.where(L < 1e-8, torch.full_like(L, 1e-8), L)
    xz2 = x * x + z * z
    xz2 = torch.where(xz2 < 1e-12, torch.full_like(xz2, 1e-12), xz2)
    ku, kv = equirect_scales(cam)
    u = cam.cx + ku * torch.atan2(x, z)
    v = cam.cy + kv * torch.asin(torch.clamp(y / L, -1.0, 1.0))
    du = torch.remainder(u - obs_uv[:, 0] + cam.width / 2.0, cam.width) - cam.width / 2.0
    dv = v - obs_uv[:, 1]
    zero = torch.zeros_like(x)
    r = torch.stack([du, dv, zero], dim=-1)
    row_u = torch.stack([ku * z / xz2, zero, -ku * x / xz2], dim=-1)
    L2 = L * L
    denom = L2 * torch.sqrt(xz2)
    row_v = torch.stack([-kv * x * y / denom, kv * torch.sqrt(xz2) / L2,
                         -kv * z * y / denom], dim=-1)
    dpi = torch.stack([row_u, row_v, torch.zeros_like(row_u)], dim=-2)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    J_pose = dpi @ torch.cat([eye, -lie.hat(Xc)], dim=-1)
    dof = torch.stack([torch.ones_like(z), torch.ones_like(z), zero], dim=-1)
    return r, J_pose, dof, L > 1e-6


RESIDUAL_FNS = {
    "perspective": perspective_residual,
    # fisheye and radial division on undistorted keypoints, as in the
    # reference (se3/reproj_edge_wrapper.h)
    "fisheye": perspective_residual,
    "radial_division": perspective_residual,
    "equirectangular": equirectangular_residual,
}
