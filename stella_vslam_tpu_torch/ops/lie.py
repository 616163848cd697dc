"""SO(3) / SE(3) / Sim(3) operations on torch tensors (batched over leading dims).

Port of stella_vslam_tpu/ops/lie.py: `hat`, `so3_project`, `so3_exp`,
`so3_log`, the left Jacobian and its inverse, `se3_exp`, `se3_compose`,
`se3_inverse`, `se3_apply`, `se3_update_left`, the Sim(3) group
(`sim3_apply`, `sim3_compose`, `sim3_inverse`, `sim3_exp`, `sim3_log` with
the translation Jacobian `_sim3_W`) and `rotation_project_fast`, with the
same Taylor switches (torch.where on a safe denominator) and conventions:
camera-from-world poses, se3 tangent xi = [rho(3), phi(3)], sim3 tangent
[rho(3), phi(3), sigma] with scale s = exp(sigma), left Jacobian; a Sim(3)
element (s, R, t) acts as p -> s R p + t.
"""
from __future__ import annotations

import torch

from stella_vslam_tpu_torch.ops import linalg

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


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, p):
    """Transform points p [..., 3]."""
    return (R @ p[..., None])[..., 0] + t


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]. Stable up to theta < pi - eps."""
    # (a trailing axis of 1 from the start: arithmetic of a 0-d forward-mode
    # dual with Python scalars turns its tangent to float64)
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.acos(cos_theta)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    factor = torch.where(theta < 1e-4, 0.5 + theta ** 2 / 12.0,
                         theta / (2.0 * torch.sin(theta)))
    return factor * w


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2, theta, small = _theta_terms(phi)
    half = theta * 0.5
    cot_term = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                           (1.0 - half * torch.cos(half) / torch.sin(half)) / theta2)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye - 0.5 * K + cot_term * (K @ K)


# ---------------------------------------------------------------------------
# Sim(3): (s, R, t); action p -> s R p + t (g2o::Sim3, used for loop correction)
# ---------------------------------------------------------------------------


def sim3_apply(s, R, t, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa, Ra, ta) * (sb, Rb, tb)."""
    return sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = torch.reciprocal(s)  # (1.0 / s turns a 0-d forward-mode tangent to float64)
    return s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0]


def _sim3_W(sigma: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The Sim(3) translation Jacobian W with exp([[sigma I + hat(phi), rho],
    [0, 0]]) = [[e^sigma R, W rho], [0, 1]]: W = A I + B hat(phi) + C
    hat(phi)^2 (Strasdat's thesis), with Taylor switches near sigma = 0 and
    theta = 0."""
    # a trailing axis of 1: torch.where on 0-d operands would promote a
    # forward-mode tangent to float64
    sigma = sigma[..., None]
    one = torch.ones_like(sigma)
    s = torch.exp(sigma)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    sig2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-4
    small_th = theta2 < 1e-8
    safe_sig = torch.where(small_sig, one, sigma)
    safe_sig2 = torch.where(small_sig, one, sig2)
    safe_th2 = torch.where(small_th, one, theta2)
    c = theta2 + sig2
    safe_c = torch.where(c < _EPS, one, c)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / safe_sig)
    B_gen = (sigma * s * sin_t + (1.0 - s * cos_t) * theta) / (theta * safe_c)
    B_th0 = torch.where(small_sig, 0.5 + sigma / 3.0, ((sigma - 1.0) * s + 1.0) / safe_sig2)
    B_sig0 = (1.0 - cos_t) / safe_th2
    B = torch.where(small_th, B_th0, torch.where(small_sig, B_sig0, B_gen))
    C_gen = (A - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / safe_c) / safe_th2
    C_th0 = torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0,
                        (s * (0.5 * sig2 - sigma + 1.0) - 1.0) / (safe_sig2 * safe_sig))
    C_sig0 = (theta - sin_t) / (safe_th2 * torch.where(small_th, one, theta))
    C = torch.where(small_th, C_th0, torch.where(small_sig, C_sig0, C_gen))

    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return A[..., None] * eye + B[..., None] * K + C[..., None] * (K @ K)


def sim3_exp(xi: torch.Tensor):
    """[..., 7] (rho, phi, sigma) -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_W(sigma, phi) @ rho[..., None])[..., 0]
    return torch.exp(sigma), so3_exp(phi), t


def sim3_log(s, R, t) -> torch.Tensor:
    """Inverse of sim3_exp: solves W rho = t by the closed-form 3x3 inverse
    (the batched LAPACK solve returns NaN tangents under vmap of a
    forward-mode derivative)."""
    phi = so3_log(R)
    sigma = torch.log(s[..., None])
    rho = (linalg.inv3x3(_sim3_W(sigma[..., 0], phi)) @ t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma], dim=-1)


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors (no factorization library)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def rotation_project_fast(R: torch.Tensor, num_iter: int = 8) -> torch.Tensor:
    """Nearest rotation by the Newton-Schulz polar iteration (matmuls only;
    converges for inputs within about unit distance of O(3)); the sign is
    corrected to det = +1 first."""
    R = R * torch.sign(det3(R))[..., None, None]
    norm = torch.sqrt(torch.sum(R * R, dim=(-2, -1), keepdim=True) / 3.0 + 1e-12)
    X = R / norm
    for _ in range(num_iter):
        X = 1.5 * X - 0.5 * X @ X.transpose(-1, -2) @ X
    return X
