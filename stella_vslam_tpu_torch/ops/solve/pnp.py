"""Batched PnP RANSAC on bearing vectors: kernel N.

Port of stella_vslam_tpu/ops/solve/pnp.py (reference
src/stella_vslam/solve/pnp_solver.{h,cc}: minimal sets + RANSAC with a
scale-aware angular inlier test of 1 deg * scale_factor[octave], a
nonminimal recompute on the consensus set, a minimum inlier gate).

Minimal hypotheses are P3P (Grunert's three-point depth system): B hashed
3-point sets, for each the quartic's roots by Newton from 8 starts (24
iterations, clamped to [1e-4, 50]), the depths per root, and (R, t) by the
exact alignment of two triads; every one of the B x 8 hypotheses scores all
N correspondences by the cosine between the observed bearing and the
direction of the transformed point. The lowest total cost among hypotheses
with more than 6 inliers wins (`ransac.select_best`), a linear resection
(`compute_pose_dlt`) on its inliers replaces it when its consensus does not
shrink, and the result is valid with at least `min_num_inliers` inliers.

`pnp_hypotheses` is kernel N on CUDA tensors (csrc/pnp_ransac.cu: one block
per set draws it with the bit-exact hash sampler and solves its 8 starts,
then one block per hypothesis scores it) and `pnp_hypotheses_plain` on CPU
tensors. Both follow the JAX version's order of operations with every
product and sum rounded separately, so that a Newton start lands on the same
root in each. The selection, the DLT refit and the final gate are torch ops
in `find_via_ransac`. Seeds are plain uint32 integers (ransac.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild
from stella_vslam_tpu_torch.ops import lie
from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.ops.solve import ransac

MIN_SET_SIZE = 3
# Newton starts for the P3P quartic in v = s3/s1 (a depth ratio), log-spaced
# over the range practical scenes reach; a start that converges to no root
# becomes a hypothesis that scores nothing
P3P_STARTS = (0.2, 0.4, 0.7, 1.0, 1.4, 2.0, 3.2, 5.0)
P3P_NEWTON_ITERS = 24


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm3(a):
    return torch.sqrt(_dot3(a, a))


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _triad(x1, x2, x3):
    """Orthonormal frame (e1, e2, e3), each [..., 3], spanned by three points."""
    e1 = x2 - x1
    e1 = e1 / (_norm3(e1)[..., None] + 1e-12)
    e3 = _cross3(e1, x3 - x1)
    e3 = e3 / (_norm3(e3)[..., None] + 1e-12)
    return e1, _cross3(e3, e1), e3


def p3p_grunert(f: torch.Tensor, P: torch.Tensor):
    """Batched P3P: [..., 3, 3] unit bearings (rows) and world points (rows)
    -> (R [..., S, 3, 3], t [..., S, 3], valid [..., S]) over the S Newton
    starts, with X_cam = R X_world + t.

    Grunert's depth system (s_i the depth along bearing f_i; side lengths a,
    b, c opposite the vertex of the same index): with u = s2/s1, v = s3/s1,
    A = a^2/b^2, C = c^2/b^2, eliminating u gives u = N(v)/D(v) and a quartic
    Q(v) = N^2 - 2 cos(gamma) N D + D^2 (1 - C q), q(v) = 1 + v^2 - 2 v
    cos(beta)."""
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    a2 = _dot3(P2 - P3, P2 - P3)
    b2 = _dot3(P1 - P3, P1 - P3)
    c2 = _dot3(P1 - P2, P1 - P2)
    ca = _dot3(f2, f3)[..., None]
    cb = _dot3(f1, f3)[..., None]
    cg = _dot3(f1, f2)[..., None]
    A = (a2 / (b2 + 1e-20))[..., None]
    C = (c2 / (b2 + 1e-20))[..., None]
    AC = A - C

    def terms(v):
        q = 1.0 + v * v - 2.0 * v * cb
        N = 1.0 - v * v + AC * q
        D = 2.0 * (cg - v * ca)
        E = 1.0 - C * q
        Q = N * N - 2.0 * cg * N * D + D * D * E
        return q, N, D, E, Q

    v = torch.tensor(P3P_STARTS, dtype=f.dtype, device=f.device).expand(
        *a2.shape, len(P3P_STARTS))
    for _ in range(P3P_NEWTON_ITERS):
        q, N, D, E, Q = terms(v)
        qp = 2.0 * v - 2.0 * cb
        Np = -2.0 * v + AC * qp
        Dp = -2.0 * ca
        Ep = -C * qp
        Qp = (2.0 * N * Np - 2.0 * cg * (Np * D + N * Dp)
              + 2.0 * D * Dp * E + D * D * Ep)
        Qp = torch.where(torch.abs(Qp) < 1e-8, torch.full_like(Qp, 1e-8), Qp)
        v = torch.clamp(v - Q / Qp, 1e-4, 50.0)

    q, N, D, E, Q = terms(v)
    u = N / torch.where(torch.abs(D) < 1e-9, torch.full_like(D, 1e-9), D)
    s1 = torch.sqrt(b2[..., None] / torch.clamp(q, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    # valid: positive depths, and the eliminated equation satisfied relative
    # to the depth scale (a start that did not converge leaves a residual)
    res_a = s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * ca - a2[..., None]
    res_scale = s1 * s1 + s2 * s2 + s3 * s3 + a2[..., None] + 1e-20
    valid = (u > 0) & (q > 1e-12) & (torch.abs(res_a) < 1e-3 * res_scale)
    valid = valid & torch.isfinite(s1) & torch.isfinite(s2) & torch.isfinite(s3)

    X1 = s1[..., None] * f1[..., None, :]
    X2 = s2[..., None] * f2[..., None, :]
    X3 = s3[..., None] * f3[..., None, :]
    c1, c2_, c3 = _triad(X1, X2, X3)  # columns of Rc, each [..., S, 3]
    w1, w2, w3 = (e[..., None, :] for e in _triad(P1, P2, P3))  # [..., 1, 3]
    # R = Rc Rw^T: R[i][j] = sum_k Rc[i][k] Rw[j][k]
    R = c1[..., :, None] * w1[..., None, :] + c2_[..., :, None] * w2[..., None, :] \
        + c3[..., :, None] * w3[..., None, :]
    P1b = P1[..., None, :]
    t = X1 - (R[..., 0] * P1b[..., 0:1] + R[..., 1] * P1b[..., 1:2] + R[..., 2] * P1b[..., 2:3])
    eye = torch.eye(3, dtype=f.dtype, device=f.device)
    R = torch.where(valid[..., None, None], R, eye)
    t = torch.where(valid[..., None], t, torch.zeros_like(t))
    return R, t, valid


class PnPResult(NamedTuple):
    R_cw: torch.Tensor  # [3,3]
    t_cw: torch.Tensor  # [3]
    is_inlier: torch.Tensor  # [N]
    num_inliers: torch.Tensor
    valid: torch.Tensor


def compute_pose_dlt(bearings: torch.Tensor, pos_w: torch.Tensor, valid=None):
    """[k,3] bearings and world points -> (R_cw, t_cw) by linear resection:
    bearing x (R p + t) = 0 gives 3 equations per point (2 independent) in
    the 12 unknowns [R00 .. R22, t0 t1 t2]; the null vector of A^T A by
    linalg.smallest_eigvec_spd, rescaled by the cube root of |det|, projected
    to a rotation, and flipped so the points lie in front."""
    bx = lie.hat(bearings)  # [k,3,3]
    ph = torch.cat([pos_w, torch.ones_like(pos_w[..., :1])], dim=-1)  # [k,4]
    A = torch.einsum("kcd,ke->kcde", bx, ph)  # [k,3,3,4]
    AR = A[..., :3].reshape(*A.shape[:-2], 9)
    Afull = torch.cat([AR, A[..., 3]], dim=-1)  # [k,3,12]
    if valid is not None:
        Afull = Afull * valid[..., None, None].to(Afull.dtype)
    Aflat = Afull.reshape(-1, 12)
    v = linalg.smallest_eigvec_spd(Aflat.T @ Aflat)
    Rraw, traw = v[:9].reshape(3, 3), v[9:]
    s = torch.pow(torch.abs(lie.det3(Rraw)) + 1e-20, 1.0 / 3.0)
    Rproj = lie.rotation_project_fast(Rraw / s)
    tn = traw / s
    pc = pos_w @ Rproj.T + tn
    flip = torch.sum(pc * bearings) < 0
    Rproj = lie.rotation_project_fast(torch.where(flip, -Rproj, Rproj))
    return Rproj, torch.where(flip, -tn, tn)


def check_inliers(R_cw, t_cw, bearings, pos_w, max_cos_errors):
    """reference pnp_solver::check_inliers: the cosine between the observed
    bearing and the direction of the transformed point, per hypothesis
    ([..., 3, 3], [..., 3]) and point ([N,3]): (inlier, cost), each [..., N]."""
    R, p = R_cw[..., None, :, :], pos_w
    pc = [R[..., i, 0] * p[:, 0] + R[..., i, 1] * p[:, 1] + R[..., i, 2] * p[:, 2]
          + t_cw[..., None, i] for i in range(3)]
    dot = pc[0] * bearings[:, 0] + pc[1] * bearings[:, 1] + pc[2] * bearings[:, 2]
    cos_angle = dot / (torch.sqrt(pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]) + 1e-12)
    inlier = cos_angle > max_cos_errors
    return inlier, torch.where(inlier, 1.0 - cos_angle, 1.0 - max_cos_errors)


def pnp_hypotheses_plain(seed: int, bearings, pos_w, max_cos, match_valid,
                         num_sets: int):
    """Plain version of kernel N: (R [B*S,3,3], t [B*S,3], ok [B*S] bool,
    total cost [B*S] f32, inlier count [B*S] i32)."""
    idx = ransac.sample_minimal_sets(seed, match_valid, num_sets, MIN_SET_SIZE)
    R, t, ok = p3p_grunert(bearings[idx], pos_w[idx])
    R, t, ok = R.reshape(-1, 3, 3), t.reshape(-1, 3), ok.reshape(-1)
    inlier, cost = check_inliers(R, t, bearings, pos_w, max_cos[None])
    inlier = inlier & match_valid[None, :] & ok[:, None]
    cost = torch.where(inlier, cost, (1.0 - max_cos)[None].expand_as(cost))
    cost = torch.where(match_valid[None, :], cost, torch.zeros_like(cost))
    return R, t, ok, cost.sum(-1), inlier.sum(-1).to(torch.int32)


def pnp_hypotheses(seed: int, bearings, pos_w, max_cos, match_valid, num_sets: int):
    """Kernel N on CUDA tensors, the plain version on CPU tensors."""
    if not bearings.is_cuda:
        return pnp_hypotheses_plain(seed, bearings, pos_w, max_cos, match_valid, num_sets)
    dev, N = bearings.device, bearings.shape[0]
    for t, shape, dt, name in ((bearings, (N, 3), torch.float32, "bearings"),
                               (pos_w, (N, 3), torch.float32, "pos_w"),
                               (max_cos, (N,), torch.float32, "max_cos"),
                               (match_valid, (N,), torch.bool, "match_valid")):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"pnp_hypotheses: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}")
    B, S = int(num_sets), len(P3P_STARTS)
    if N == 0 or B * MIN_SET_SIZE * N >= 1 << 32:
        raise ValueError("pnp_hypotheses: needs 0 < B*3*N < 2^32")
    R = torch.empty((B * S, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((B * S, 3), dtype=torch.float32, device=dev)
    ok = torch.empty(B * S, dtype=torch.bool, device=dev)
    cost = torch.empty(B * S, dtype=torch.float32, device=dev)
    count = torch.empty(B * S, dtype=torch.int32, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_pnp_ransac(
        N, bearings.data_ptr(), pos_w.data_ptr(), max_cos.data_ptr(),
        match_valid.data_ptr(), int(seed) & 0xFFFFFFFF, B, R.data_ptr(), t.data_ptr(),
        ok.data_ptr(), cost.data_ptr(), count.data_ptr(), kbuild.stream_ptr(dev)),
        "pnp_ransac")
    pnp_hypotheses.launches += 1
    return R, t, ok, cost, count


pnp_hypotheses.launches = 0


def max_cos_errors(scale_factors: torch.Tensor, octaves: torch.Tensor) -> torch.Tensor:
    """cos(1 deg * scale_factor[octave]) per correspondence."""
    return torch.cos(scale_factors[octaves.long()] * (1.0 * math.pi / 180.0))


def find_via_ransac(seed: int, bearings, pos_w, octaves, match_valid, *,
                    scale_factors: torch.Tensor, num_hypotheses: int = 256,
                    min_num_inliers: int = 10, hypotheses=pnp_hypotheses) -> PnPResult:
    """bearings [N,3], pos_w [N,3], octaves [N] i32, match_valid [N] bool.
    `hypotheses` is for checks only: kernel N's wrapper (the default, and what
    every caller in the package uses), or its plain version to hold it against."""
    max_cos = max_cos_errors(scale_factors, octaves)
    R, t, hyp_ok, total, num_in = hypotheses(seed, bearings, pos_w, max_cos, match_valid,
                                             num_hypotheses)
    best, ok = ransac.select_best(total, num_in, 2 * MIN_SET_SIZE)
    R_b, t_b = R[best], t[best]
    inl = check_inliers(R_b, t_b, bearings, pos_w, max_cos)[0] & match_valid & hyp_ok[best]
    # nonminimal recompute on the inliers
    R_re, t_re = compute_pose_dlt(bearings, pos_w, valid=inl & match_valid)
    in_re = check_inliers(R_re, t_re, bearings, pos_w, max_cos)[0] & match_valid
    better = in_re.sum() >= inl.sum()
    R_b = torch.where(better, R_re, R_b)
    t_b = torch.where(better, t_re, t_b)
    inl = torch.where(better, in_re, inl)
    n = inl.sum()
    return PnPResult(R_b, t_b, inl, n, ok & (n >= min_num_inliers))
