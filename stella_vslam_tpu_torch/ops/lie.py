"""SO(3) / SE(3) operations on torch tensors (f32, batched over leading dims).

Port of the SE(3) part of stella_vslam_tpu/ops/lie.py used by tracking and
bundle adjustment: `hat`, `so3_project`, `so3_exp`, `se3_exp`,
`se3_compose`, `se3_update_left`, with the
same Taylor switches (torch.where on a safe denominator) and conventions:
camera-from-world poses, tangent xi = [rho(3), phi(3)], left Jacobian.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def so3_project(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a near-rotation onto SO(3) by Gram-Schmidt on the
    rows (chained f32 rotations drift off the manifold otherwise)."""
    r0 = R[..., 0, :]
    r0 = r0 / torch.clamp(torch.linalg.norm(r0, dim=-1, keepdim=True), min=1e-12)
    r1 = R[..., 1, :]
    r1 = r1 - torch.sum(r0 * r1, dim=-1, keepdim=True) * r0
    r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def _theta_terms(phi: torch.Tensor):
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    return theta2, theta, theta2 < _EPS


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    theta2, theta, small = _theta_terms(phi)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2, theta, small = _theta_terms(phi)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + b * K + c * (K @ K)


def se3_exp(xi: torch.Tensor):
    """[..., 6] (rho, phi) -> (R [...,3,3], t [...,3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_update_left(R, t, xi):
    """Left-multiplicative update Exp(xi) * (R, t) — the GN/LM retraction."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta
