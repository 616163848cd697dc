"""Sim(3) optimizers: two-view transform refinement (kernel O) and
pose-graph optimization (kernel P).

Port of stella_vslam_tpu/ops/optim/sim3.py:
* `optimize_transform` (:56; reference optimize/transform_optimizer.cc): the
  Sim3 (SE3 with `fix_scale`) between two keyframes from mutual forward and
  backward reprojection of N matched landmarks: 10 accept-if-better
  Gauss-Newton steps on the 7-vector of a left perturbation, rows weighted
  by sqrt(inv_sigma * inlier) with the previous step's inliers, H + 1e-6 I,
  and a chi-square inlier reset after every step;
* `optimize_pose_graph` (:165; reference optimize/graph_optimizer.cc): 20
  Gauss-Newton steps over K Sim3 vertices and E edges with residual
  log(S_meas^-1 S_i S_j^-1) in R^7, both ends perturbed on the left, the
  dense [7K,7K] normal equations with gauge rows for fixed and invalid
  vertices.

The JAX version takes both Jacobians by `jax.jacfwd`; the plain versions
here use `torch.func.jacfwd` (and `vmap` over the edges) on the same
residual programs. On CUDA tensors:
* kernel O (csrc/sim3_transform.cu) runs all 10 steps in one block with the
  closed-form Jacobian (`transform_jacobian`, the same formula in torch, is
  held against jacfwd by the tests): for the forward point q = s R x + t the
  perturbation gives rho + phi x q + sigma q, rows [I, -hat(q), q] through
  the projection; for the backward point p = S^-1 y the rows are
  -(1/s) R^T [I, -hat(y), y]; the sigma column is zero with `fix_scale`;
* kernel P (csrc/pose_graph.cu): per iteration `pose_graph_linearize` (one
  thread per edge: the residual and its [7,14] Jacobian by forward-mode dual
  numbers through the same sim3_exp / sim3_log program, the blocks added
  into the dense system by atomics, then the gauge rows), the dense solve,
  and `pose_graph_update` (Exp(dx) composed on the left of every vertex).
  The dense solve is a library call on the card (`torch.linalg.cholesky` +
  `cholesky_solve`), as the JAX version leaves it to a chain of plain matmuls
  and small Choleskys (linalg.solve_spd_blocked, the plain version's solver).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild
from stella_vslam_tpu_torch.ops import lie
from stella_vslam_tpu_torch.ops import linalg

CHI_SQ_SIM3 = 9.966  # the loop detector's chi-square for Sim3 edges


# ---------------------------------------------------------------------------
# Sim3 transform optimizer (two keyframes)
# ---------------------------------------------------------------------------


class TransformResult(NamedTuple):
    s_12: torch.Tensor
    R_12: torch.Tensor
    t_12: torch.Tensor
    is_inlier: torch.Tensor  # [N] bool
    num_inliers: torch.Tensor


class TransformProblem(NamedTuple):
    pts_in_1: torch.Tensor  # [N,3] landmark positions in keyframe 1's camera frame
    pts_in_2: torch.Tensor  # [N,3] the matched landmarks in keyframe 2's camera frame
    obs_1: torch.Tensor  # [N,2] undistorted observation in keyframe 1
    obs_2: torch.Tensor  # [N,2]
    inv_sigma_sq_1: torch.Tensor  # [N]
    inv_sigma_sq_2: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool


def _project_pixel(Xc, fx, fy, cx, cy):
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-6, torch.full_like(Xc[..., 2], 1e-6),
                    Xc[..., 2])
    return torch.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy], dim=-1)


def _unpack(xi, s, R, t, fix_scale: bool):
    ds, dR, dt = lie.sim3_exp(xi)
    if fix_scale:
        ds = torch.ones_like(ds)
    return lie.sim3_compose(ds, dR, dt, s, R, t)


def _transform_residuals(p: TransformProblem, s, R, t, cam):
    """(r1 [N,2], r2 [N,2], ok1 [N], ok2 [N]): forward (a point of frame 2
    brought into frame 1 by S_12 and projected there) and backward."""
    p1 = lie.sim3_apply(s[None], R, t, p.pts_in_2)
    r1 = _project_pixel(p1, *cam) - p.obs_1
    si, Ri, ti = lie.sim3_inverse(s, R, t)
    p2 = lie.sim3_apply(si[None], Ri, ti, p.pts_in_1)
    r2 = _project_pixel(p2, *cam) - p.obs_2
    return r1, r2, p1[..., 2] > 1e-4, p2[..., 2] > 1e-4


def _cost_vec(p: TransformProblem, xi, s, R, t, inlier, cam, fix_scale: bool):
    s2, R2, t2 = _unpack(xi, s, R, t, fix_scale)
    r1, r2, _, _ = _transform_residuals(p, s2, R2, t2, cam)
    w1 = torch.sqrt(p.inv_sigma_sq_1 * inlier)
    w2 = torch.sqrt(p.inv_sigma_sq_2 * inlier)
    return torch.cat([(r1 * w1[:, None]).reshape(-1), (r2 * w2[:, None]).reshape(-1)])


def transform_jacobian(p: TransformProblem, s, R, t, inlier, cam, fix_scale: bool):
    """Closed form of d cost_vec / d xi at xi = 0 ([4N,7], kernel O's
    Jacobian)."""
    fx, fy = cam[0], cam[1]

    def dproj(X):
        z = X[:, 2]
        live = (torch.abs(z) >= 1e-6).to(z.dtype)  # the guard freezes z
        z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        zero = torch.zeros_like(z)
        return torch.stack([
            torch.stack([fx / z, zero, -fx * X[:, 0] / (z * z) * live], -1),
            torch.stack([zero, fy / z, -fy * X[:, 1] / (z * z) * live], -1)], -2)  # [N,2,3]

    def point_rows(q):  # [N,3,7]: rho + phi x q + sigma q
        eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
        sig = torch.zeros_like(q) if fix_scale else q
        return torch.cat([eye, -lie.hat(q), sig[..., None]], dim=-1)

    q = lie.sim3_apply(s[None], R, t, p.pts_in_2)
    J1 = dproj(q) @ point_rows(q)
    si, Ri, ti = lie.sim3_inverse(s, R, t)
    p2 = lie.sim3_apply(si[None], Ri, ti, p.pts_in_1)
    J2 = dproj(p2) @ (-(si * Ri) @ point_rows(p.pts_in_1))
    w1 = torch.sqrt(p.inv_sigma_sq_1 * inlier)
    w2 = torch.sqrt(p.inv_sigma_sq_2 * inlier)
    return torch.cat([(J1 * w1[:, None, None]).reshape(-1, 7),
                      (J2 * w2[:, None, None]).reshape(-1, 7)])


def optimize_transform_plain(s12_init, R12_init, t12_init, pts_in_1, pts_in_2, obs_1,
                             obs_2, inv_sigma_sq_1, inv_sigma_sq_2, valid, fx, fy, cx,
                             cy, *, chi_sq: float = CHI_SQ_SIM3, fix_scale: bool = False,
                             num_iter: int = 10) -> TransformResult:
    p = TransformProblem(pts_in_1, pts_in_2, obs_1, obs_2, inv_sigma_sq_1,
                         inv_sigma_sq_2, valid)
    cam = (fx, fy, cx, cy)
    s, R, t = s12_init, R12_init, t12_init
    inlier = valid.to(torch.float32)
    xi0 = torch.zeros(7, dtype=torch.float32, device=R.device)
    eye7 = torch.eye(7, dtype=torch.float32, device=R.device)
    for _ in range(num_iter):
        f = lambda xi: _cost_vec(p, xi, s, R, t, inlier, cam, fix_scale)
        J = torch.func.jacfwd(f)(xi0)  # [4N,7]
        r = f(xi0)
        H = J.T @ J + 1e-6 * eye7
        dx = -linalg.solve_spd_unrolled(H, J.T @ r)
        s2, R2, t2 = _unpack(dx, s, R, t, fix_scale)
        better = torch.sum(f(dx) ** 2) <= torch.sum(r * r)
        s, R, t = torch.where(better, s2, s), torch.where(better, R2, R), \
            torch.where(better, t2, t)
        r1, r2, ok1, ok2 = _transform_residuals(p, s, R, t, cam)
        c1 = torch.sum(r1 * r1, dim=-1) * inv_sigma_sq_1
        c2 = torch.sum(r2 * r2, dim=-1) * inv_sigma_sq_2
        inlier = valid.to(torch.float32) * (
            (c1 <= chi_sq) & (c2 <= chi_sq) & ok1 & ok2).to(torch.float32)
    is_in = inlier > 0.5
    return TransformResult(s, R, t, is_in, is_in.sum())


def optimize_transform(s12_init, R12_init, t12_init, pts_in_1, pts_in_2, obs_1, obs_2,
                       inv_sigma_sq_1, inv_sigma_sq_2, valid, fx, fy, cx, cy, *,
                       chi_sq: float = CHI_SQ_SIM3, fix_scale: bool = False,
                       num_iter: int = 10) -> TransformResult:
    """Kernel O on CUDA tensors, the plain version on CPU tensors. s12_init
    is a 0-d tensor."""
    fn = sim3_transform if pts_in_1.is_cuda else optimize_transform_plain
    return fn(s12_init, R12_init, t12_init, pts_in_1, pts_in_2, obs_1, obs_2,
              inv_sigma_sq_1, inv_sigma_sq_2, valid, fx, fy, cx, cy, chi_sq=chi_sq,
              fix_scale=fix_scale, num_iter=num_iter)


def sim3_transform(s12_init, R12_init, t12_init, pts_in_1, pts_in_2, obs_1, obs_2,
                   inv_sigma_sq_1, inv_sigma_sq_2, valid, fx, fy, cx, cy, *,
                   chi_sq: float = CHI_SQ_SIM3, fix_scale: bool = False,
                   num_iter: int = 10) -> TransformResult:
    """Kernel O's wrapper: CUDA tensors, any N >= 1, one launch."""
    dev, N = pts_in_1.device, pts_in_1.shape[0]
    f32 = torch.float32
    ins = []
    for t, shape, dt, name in (
            (pts_in_1, (N, 3), f32, "pts_in_1"), (pts_in_2, (N, 3), f32, "pts_in_2"),
            (obs_1, (N, 2), f32, "obs_1"), (obs_2, (N, 2), f32, "obs_2"),
            (inv_sigma_sq_1, (N,), f32, "inv_sigma_sq_1"),
            (inv_sigma_sq_2, (N,), f32, "inv_sigma_sq_2"), (valid, (N,), torch.bool, "valid"),
            (R12_init, (3, 3), f32, "R12_init"), (t12_init, (3,), f32, "t12_init"),
            (s12_init, (), f32, "s12_init")):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"sim3_transform: {name} must be a {dt} tensor of "
                             f"shape {shape} on {dev}")
        ins.append(t.contiguous())
    if N == 0:
        raise ValueError("sim3_transform: no correspondences")
    out = torch.empty(13, dtype=f32, device=dev)  # s | R | t
    inlier = torch.empty(N, dtype=torch.bool, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_sim3_transform(
        N, *[t.data_ptr() for t in ins], float(fx), float(fy), float(cx), float(cy),
        float(chi_sq), int(fix_scale), int(num_iter), out.data_ptr(), inlier.data_ptr(),
        kbuild.stream_ptr(dev)), "sim3_transform")
    sim3_transform.launches += 1
    return TransformResult(out[0], out[1:10].reshape(3, 3), out[10:13], inlier, inlier.sum())


sim3_transform.launches = 0


# ---------------------------------------------------------------------------
# Sim3 pose-graph optimizer
# ---------------------------------------------------------------------------


class PoseGraphResult(NamedTuple):
    s_cw: torch.Tensor  # [K]
    R_cw: torch.Tensor  # [K,3,3]
    t_cw: torch.Tensor  # [K,3]


class PoseGraph(NamedTuple):
    """The constant part of a pose-graph problem."""

    fixed: torch.Tensor  # [K] bool (the gauge: a component's root)
    valid: torch.Tensor  # [K] bool
    edge_i: torch.Tensor  # [E] i32
    edge_j: torch.Tensor  # [E] i32
    edge_s: torch.Tensor  # [E] measured S_ij = S_i_cw o S_j_cw^-1: scale
    edge_R: torch.Tensor  # [E,3,3]
    edge_t: torch.Tensor  # [E,3]
    edge_valid: torch.Tensor  # [E] bool


def _edge_residual(xi_ij, s_i, R_i, t_i, s_j, R_j, t_j, sm, Rm, tm):
    """r = log(S_meas^-1 o S_i o S_j^-1) with S_k <- Exp(xi_k) S_k."""
    si, Ri, ti = lie.sim3_compose(*lie.sim3_exp(xi_ij[:7]), s_i, R_i, t_i)
    sj, Rj, tj = lie.sim3_compose(*lie.sim3_exp(xi_ij[7:]), s_j, R_j, t_j)
    sij, Rij, tij = lie.sim3_compose(si, Ri, ti, *lie.sim3_inverse(sj, Rj, tj))
    return lie.sim3_log(*lie.sim3_compose(*lie.sim3_inverse(sm, Rm, tm), sij, Rij, tij))


def edge_residuals_plain(g: PoseGraph, s, R, t):
    """(r [E,7], J [E,7,14]) of every edge at the state, unweighted."""
    i, j = g.edge_i.long(), g.edge_j.long()
    xi0 = torch.zeros(14, dtype=s.dtype, device=s.device)

    def res_and_jac(*a):
        f = lambda xi: _edge_residual(xi, *a)
        return f(xi0), torch.func.jacfwd(f)(xi0)

    return torch.func.vmap(res_and_jac)(s[i], R[i], t[i], s[j], R[j], t[j], g.edge_s,
                                        g.edge_R, g.edge_t)


def _free(g: PoseGraph):
    return (g.valid & ~g.fixed).to(torch.float32)


def pose_graph_linearize_plain(g: PoseGraph, s, R, t):
    """Plain version of kernel P's linearization: (Hd [7K,7K], b [7K], sum of
    squared residuals) with the gauge rows applied."""
    K, E = s.shape[0], g.edge_i.shape[0]
    r, J = edge_residuals_plain(g, s, R, t)
    w = g.edge_valid.to(torch.float32)
    r = r * w[:, None]
    J = J * w[:, None, None]
    J_i, J_j = J[:, :, :7], J[:, :, 7:]
    i, j = g.edge_i.long(), g.edge_j.long()
    H = torch.zeros((K * K, 7, 7), dtype=s.dtype, device=s.device)
    H.index_add_(0, i * K + i, torch.einsum("epi,epj->eij", J_i, J_i))
    H.index_add_(0, i * K + j, torch.einsum("epi,epj->eij", J_i, J_j))
    H.index_add_(0, j * K + j, torch.einsum("epi,epj->eij", J_j, J_j))
    H = H.reshape(K, K, 7, 7)
    # (i,i), (i,j), (j,j) were summed; mirror (i,j) to (j,i) without counting
    # the diagonal blocks twice
    eyeK = torch.eye(K, dtype=s.dtype, device=s.device)[:, :, None, None]
    H = H + H.permute(1, 0, 3, 2) - H * eyeK
    b = torch.zeros((K, 7), dtype=s.dtype, device=s.device)
    b.index_add_(0, i, torch.einsum("epi,ep->ei", J_i, r))
    b.index_add_(0, j, torch.einsum("epi,ep->ei", J_j, r))
    free = _free(g)
    eye7 = torch.eye(7, dtype=s.dtype, device=s.device)[None, None]
    H = H * free[:, None, None, None] * free[None, :, None, None]
    H = H + eyeK * ((1.0 - free)[:, None, None, None] * eye7)
    H = H + eyeK * (1e-6 * eye7)
    b = b * free[:, None]
    return H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K), b.reshape(-1), torch.sum(r * r)


def pose_graph_update_plain(g: PoseGraph, s, R, t, x):
    """Plain version of kernel P's update: S_k <- Exp(-x_k free_k) S_k."""
    dx = -x.reshape(-1, 7) * _free(g)[:, None]
    return lie.sim3_compose(*lie.sim3_exp(dx), s, R, t)


def cholesky_solve(Hd, b):
    """The dense SPD solve on the device, one library factorization."""
    L = torch.linalg.cholesky(Hd)
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def _check_graph(g: PoseGraph, s, R, t):
    K, E, dev = s.shape[0], g.edge_i.shape[0], s.device
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    for x, shape, dt, name in (
            (s, (K,), f32, "s_cw"), (R, (K, 3, 3), f32, "R_cw"), (t, (K, 3), f32, "t_cw"),
            (g.fixed, (K,), bl, "fixed"), (g.valid, (K,), bl, "valid"),
            (g.edge_i, (E,), i32, "edge_i"), (g.edge_j, (E,), i32, "edge_j"),
            (g.edge_s, (E,), f32, "edge_s"), (g.edge_R, (E, 3, 3), f32, "edge_R"),
            (g.edge_t, (E, 3), f32, "edge_t"), (g.edge_valid, (E,), bl, "edge_valid")):
        if tuple(x.shape) != shape or x.dtype != dt or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"optimize_pose_graph: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}")
    return K, E, dev


def pose_graph_linearize(g: PoseGraph, s, R, t):
    """Kernel P, first half, on CUDA tensors: (Hd [7K,7K], b [7K], sum of
    squared residuals)."""
    if not s.is_cuda:
        return pose_graph_linearize_plain(g, s, R, t)
    K, E, dev = _check_graph(g, s, R, t)
    Hd = torch.zeros((7 * K, 7 * K), dtype=torch.float32, device=dev)
    b = torch.zeros(7 * K, dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_pose_graph_linearize(
        K, E, s.data_ptr(), R.data_ptr(), t.data_ptr(), g.fixed.data_ptr(),
        g.valid.data_ptr(), g.edge_i.data_ptr(), g.edge_j.data_ptr(), g.edge_s.data_ptr(),
        g.edge_R.data_ptr(), g.edge_t.data_ptr(), g.edge_valid.data_ptr(), Hd.data_ptr(),
        b.data_ptr(), cost.data_ptr(), kbuild.stream_ptr(dev)), "pose_graph_linearize")
    pose_graph_linearize.launches += 1
    return Hd, b, cost


def pose_graph_update(g: PoseGraph, s, R, t, x):
    """Kernel P, second half, on CUDA tensors: the updated (s, R, t)."""
    if not s.is_cuda:
        return pose_graph_update_plain(g, s, R, t, x)
    K, _, dev = _check_graph(g, s, R, t)
    x = x.to(torch.float32).contiguous()
    if tuple(x.shape) != (7 * K,) or x.device != dev:
        raise ValueError(f"pose_graph_update: x must have shape ({7 * K},) on {dev}")
    s2, R2, t2 = torch.empty_like(s), torch.empty_like(R), torch.empty_like(t)
    lib = kbuild.load()
    kbuild.check(lib.svt_pose_graph_update(
        K, s.data_ptr(), R.data_ptr(), t.data_ptr(), g.fixed.data_ptr(), g.valid.data_ptr(),
        x.data_ptr(), s2.data_ptr(), R2.data_ptr(), t2.data_ptr(), kbuild.stream_ptr(dev)),
        "pose_graph_update")
    pose_graph_linearize.launches += 1
    return s2, R2, t2


# one count for kernel P, whichever of its two entry points launched
pose_graph_linearize.launches = 0


def optimize_pose_graph_plain(s_cw, R_cw, t_cw, fixed, valid, edge_i, edge_j, edge_s,
                              edge_R, edge_t, edge_valid, *, num_iter: int = 20,
                              solve=linalg.solve_spd_blocked) -> PoseGraphResult:
    g = PoseGraph(fixed, valid, edge_i, edge_j, edge_s, edge_R, edge_t, edge_valid)
    s, R, t = s_cw, R_cw, t_cw
    for _ in range(num_iter):
        Hd, b, _ = pose_graph_linearize_plain(g, s, R, t)
        s, R, t = pose_graph_update_plain(g, s, R, t, solve(Hd, b))
    return PoseGraphResult(s, R, t)


def optimize_pose_graph(s_cw, R_cw, t_cw, fixed, valid, edge_i, edge_j, edge_s, edge_R,
                        edge_t, edge_valid, *, num_iter: int = 20) -> PoseGraphResult:
    """Gauss-Newton over the essential graph. Measurement convention: S_ij =
    S_i_cw o S_j_cw^-1 at the input estimates the edge was measured at, so
    that r = log(S_ij^-1 o S_i o S_j^-1) -> 0. Kernel P and one library
    Cholesky per iteration on CUDA tensors, the plain version on CPU
    tensors."""
    if not s_cw.is_cuda:
        return optimize_pose_graph_plain(s_cw, R_cw, t_cw, fixed, valid, edge_i, edge_j,
                                         edge_s, edge_R, edge_t, edge_valid,
                                         num_iter=num_iter)
    g = PoseGraph(fixed, valid, edge_i, edge_j, edge_s, edge_R, edge_t, edge_valid)
    s, R, t = s_cw, R_cw, t_cw
    for _ in range(num_iter):
        Hd, b, _ = pose_graph_linearize(g, s, R, t)
        s, R, t = pose_graph_update(g, s, R, t, cholesky_solve(Hd, b))
    return PoseGraphResult(s, R, t)
