"""Bundle adjustment with the Schur complement: kernels F, G, H, I.

Port of stella_vslam_tpu/ops/optim/ba.py `BAProblem` (:72) and
`bundle_adjust` (:739): landmark-major observations [L, D] (D observers per
landmark, padded slots masked), K camera poses, a two-stage
Levenberg-Marquardt schedule mirroring the reference local BA
(local_bundle_adjuster_g2o.cc:306-348): `num_first` robust (Huber)
iterations, chi-square reclassification, `num_second` plain iterations,
final outlier flags. Each stage stops early when an accepted step gains
less than 1e-3 of the cost (optimize/terminate_action.cc). Fixed and
invalid cameras get a zero update; `lm_fixed` points constrain the cameras
but do not move; `lm_keep_inlier` rows survive the reclassification.

On CUDA tensors every iteration is four launches (csrc/ba_schur.cu):
F `ba_linearize_schur` (linearize, Hpp^-1, Schur terms, each block into its
own partial; then the partials added in block order), G
`ba_reduced_solve` (the 6K x 6K Cholesky solve and the trial poses: in shared
memory up to 6K = 192, in a device-memory scratch above, as the global BA's
K = 32 .. 512 need), H `ba_backsub_cost` (point updates, trial cost, and on the device the
accept / reject, lambda update and stop flag). The stage launches all its
iterations without reading the host; after the stop flag every launch
returns at once. Kernel I `ba_classify` gives the chi-square
reclassification between the stages and the final outlier flags. No sum
on the card depends on the order threads arrive in: the same problem gives
the same bits on every run. On CPU
tensors `bundle_adjust_plain` runs the same schedule as torch ops
(index_add_ where the JAX version uses one-hot matmuls; the reduced system
through linalg.solve_spd_blocked).

The perspective model only; the JAX version's packed and stepped entry
points and its chunked Schur product are not ported (ROADMAP item 9).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild
from stella_vslam_tpu_torch.ops import lie
from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

CHI_SQ_2D = 5.991
CHI_SQ_3D = 7.815
MAX_SOLVE_DIM = 192  # up to here kernel G holds the 6K x 6K system in shared memory
MAX_CAMERAS = 512  # above it G factors in device memory with one block
LM_CHUNK = 128  # landmarks per block of kernels F and H
# device memory for kernel F's per-block partials (33K + 1 + 36K^2 floats
# each): the block count is cut to fit where the system is large
F_PARTIAL_FLOATS = 1 << 23


def f_blocks(K: int, L: int) -> int:
    """Kernel F's block count: one per landmark chunk, at most as many as
    F_PARTIAL_FLOATS holds partials of a K-camera system."""
    chunks = -(-L // LM_CHUNK)
    return max(1, min(chunks, F_PARTIAL_FLOATS // (33 * K + 1 + 36 * K * K)))


class BAProblem(NamedTuple):
    """Padded fixed-shape BA problem. K cameras, L landmarks, D obs/landmark."""

    cam_R: torch.Tensor  # [K,3,3] camera-from-world rotations
    cam_t: torch.Tensor  # [K,3]
    cam_fixed: torch.Tensor  # [K] bool
    cam_valid: torch.Tensor  # [K] bool
    lm_pos: torch.Tensor  # [L,3]
    lm_valid: torch.Tensor  # [L] bool
    obs_cam: torch.Tensor  # [L,D] i32 camera slot of each observation
    obs_uv: torch.Tensor  # [L,D,2] undistorted observation
    obs_x_right: torch.Tensor  # [L,D] stereo x_right (<0 mono)
    obs_inv_sigma_sq: torch.Tensor  # [L,D]
    obs_valid: torch.Tensor  # [L,D] bool
    lm_fixed: Optional[torch.Tensor] = None  # [L] bool: point held constant
    lm_keep_inlier: Optional[torch.Tensor] = None  # [L] bool: never reclassified


class BAResult(NamedTuple):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    lm_pos: torch.Tensor
    obs_is_outlier: torch.Tensor  # [L,D] bool (chi-square gated, final state)
    cost: torch.Tensor  # last trial cost of the last stage


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _pose_rows(prob: BAProblem, cam_R, cam_t, lm_pos, cam: CamScalars):
    """Residual rows r [L,D,3], pose Jacobian Jc [L,D,3,6], point Jacobian
    Jp [L,D,3,3] and depth_ok [L,D]. Row 2 is the stereo row; its weight is
    gated by has_stereo."""
    oc = prob.obs_cam.long()
    R = cam_R[oc]  # [L,D,3,3]
    t = cam_t[oc]
    Xc = (R @ lm_pos[:, None, :, None])[..., 0] + t
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    u_r = u - cam.focal_x_baseline * iz
    r = torch.stack([u - prob.obs_uv[..., 0], v - prob.obs_uv[..., 1],
                     u_r - prob.obs_x_right], -1)
    zero = torch.zeros_like(x)
    dpi = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        torch.stack([cam.fx * iz, zero,
                     -cam.fx * x * iz2 + cam.focal_x_baseline * iz2], -1)], -2)
    Jc = torch.cat([dpi, -(dpi @ lie.hat(Xc))], -1)
    Jp = dpi @ R
    return r, Jc, Jp, z > 1e-4


def _row_weights(prob: BAProblem, r, depth_ok, inlier, use_huber: bool):
    """(row weights wr [L,D,3], w_base [L,D], cost, chi2 [L,D])."""
    w_base = (prob.obs_valid & inlier & depth_ok & prob.lm_valid[:, None]).to(
        r.dtype) * prob.obs_inv_sigma_sq
    hs = (prob.obs_x_right > 0).to(r.dtype)
    sq = r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1] + r[..., 2] * r[..., 2] * hs
    chi2 = sq * prob.obs_inv_sigma_sq
    chi_thr = torch.where(prob.obs_x_right > 0, torch.full_like(sq, CHI_SQ_3D),
                          torch.full_like(sq, CHI_SQ_2D))
    chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
    sqrt_thr = torch.sqrt(chi_thr)
    huber = torch.where(chi > sqrt_thr, sqrt_thr / chi, torch.ones_like(chi)) \
        if use_huber else torch.ones_like(chi)
    w = w_base * huber
    wr = torch.stack([w, w, w * hs], -1)
    return wr, w_base, torch.sum(w * sq), chi2


def _total_cost(prob, cam_R, cam_t, lm_pos, inlier, cam, use_huber):
    r, _, _, depth_ok = _pose_rows(prob, cam_R, cam_t, lm_pos, cam)
    _, _, cost, chi2 = _row_weights(prob, r, depth_ok, inlier, use_huber)
    return cost, chi2, depth_ok


def _linearize(prob, cam_R, cam_t, lm_pos, inlier, cam, use_huber):
    """One evaluation: cost and the lambda-independent blocks."""
    K = cam_R.shape[0]
    r, Jc, Jp, depth_ok = _pose_rows(prob, cam_R, cam_t, lm_pos, cam)
    wr, w_base, cost, _ = _row_weights(prob, r, depth_ok, inlier, use_huber)
    Jcw = Jc * wr[..., None]  # [L,D,3,6]
    Jpw = Jp * wr[..., None]
    hcc_o = torch.einsum("ldri,ldrj->ldij", Jcw, Jc)  # [L,D,6,6]
    bc_o = torch.einsum("ldri,ldr->ldi", Jcw, r)
    oc = prob.obs_cam.reshape(-1).long()
    Hcc = torch.zeros((K, 6, 6), dtype=cam_R.dtype, device=cam_R.device)
    Hcc.index_add_(0, oc, hcc_o.reshape(-1, 6, 6))
    b_c = torch.zeros((K, 6), dtype=cam_R.dtype, device=cam_R.device)
    b_c.index_add_(0, oc, bc_o.reshape(-1, 6))
    Hpp = torch.einsum("ldri,ldrj->lij", Jpw, Jp)  # [L,3,3]
    b_p = torch.einsum("ldri,ldr->li", Jpw, r)  # [L,3]
    W = torch.einsum("ldri,ldra->ldia", Jcw, Jp)  # [L,D,6,3]
    has_obs = torch.sum(w_base, dim=1) > 0
    return cost, (Hpp, b_p, Hcc, b_c, W, has_obs)


def _sym3_inv(H, lam):
    """Damped symmetric 3x3 inverse via the adjugate (0 where |det| <
    1e-18), batched over [L]."""
    tr = H[:, 0, 0] + H[:, 1, 1] + H[:, 2, 2]
    damp = lam * torch.clamp(tr / 3.0, min=1e-6) + 1e-7
    a, b, c = H[:, 0, 0] + damp, H[:, 0, 1], H[:, 0, 2]
    d, e, f = H[:, 1, 1] + damp, H[:, 1, 2], H[:, 2, 2] + damp
    A00, A01, A02 = d * f - e * e, c * e - b * f, b * e - c * d
    A11, A12, A22 = a * f - c * c, b * c - a * e, a * d - b * b
    det = a * A00 + b * A01 + c * A02
    small = torch.abs(det) < 1e-18
    idet = torch.where(small, torch.zeros_like(det),
                       1.0 / torch.where(small, torch.ones_like(det), det))
    return torch.stack([torch.stack([A00, A01, A02], -1),
                        torch.stack([A01, A11, A12], -1),
                        torch.stack([A02, A12, A22], -1)], -2) * idet[:, None, None]


def _free(prob):
    return (prob.cam_valid & ~prob.cam_fixed).to(torch.float32)


def linearize_schur_plain(prob, cam, cam_R, cam_t, lm_pos, inlier, lam,
                          use_huber: bool):
    """Plain version of kernel F: the cost at the state and the reduced
    camera system before damping. Returns (cost, Hcc [K,6,6], b_c [K,6],
    S_red [6K,6K], rhs_red [6K], per-landmark terms (G, b_p, W, has_obs))."""
    K = cam_R.shape[0]
    cost, (Hpp, b_p, Hcc, b_c, W, has_obs) = _linearize(
        prob, cam_R, cam_t, lm_pos, inlier, cam, use_huber)
    G = _sym3_inv(Hpp, lam)  # [L,3,3]
    if prob.lm_fixed is not None:
        G = G * (~prob.lm_fixed).to(G.dtype)[:, None, None]
    A = W @ G[:, None]  # [L,D,6,3]
    oc = prob.obs_cam.long()
    # S_red[k_d, k_e] += A_d W_e^T over every observation pair of a landmark
    pair = (oc[:, :, None] * K + oc[:, None, :]).reshape(-1)  # [L*D*D]
    blk = torch.einsum("ldia,leja->ldeij", A, W).reshape(-1, 6, 6)
    S_red = torch.zeros((K * K, 6, 6), dtype=cam_R.dtype, device=cam_R.device)
    S_red.index_add_(0, pair, blk)
    S_red = S_red.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    rhs_red = torch.zeros((K, 6), dtype=cam_R.dtype, device=cam_R.device)
    rhs_red.index_add_(0, oc.reshape(-1),
                       (A @ b_p[:, None, :, None])[..., 0].reshape(-1, 6))
    return cost, Hcc, b_c, S_red, rhs_red.reshape(-1), (G, b_p, W, has_obs)


def damped_reduced_system(prob, Hcc, b_c, S_red, rhs_red, lam):
    """Kernel G's system before its solve, in the dtype of Hcc: damp Hcc,
    mask fixed and invalid cameras; returns (S [6K,6K], rhs [6K]), dx =
    -S^-1 rhs on the free cameras."""
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    tr = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hcc_d = Hcc + (lam * torch.clamp(tr / 6.0, min=1e-6) + 1e-7)[:, None, None] * eye6
    S = -S_red + torch.block_diag(*Hcc_d)
    free6 = _free(prob).to(Hcc.dtype).repeat_interleave(6)
    S = S * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
    return S, (b_c.reshape(-1) - rhs_red) * free6


def reduced_solve_plain(prob, cam_R, cam_t, Hcc, b_c, S_red, rhs_red, lam):
    """Plain version of kernel G: damp Hcc, mask fixed cameras, solve the
    reduced system; returns (dx [K,6], trial cam_R, trial cam_t)."""
    K = cam_R.shape[0]
    S, rhs = damped_reduced_system(prob, Hcc, b_c, S_red, rhs_red, lam)
    dx = (-linalg.solve_spd_blocked(S, rhs)).reshape(K, 6) * _free(prob)[:, None]
    dR, dt = lie.se3_exp(dx)
    return (dx,) + lie.se3_compose(dR, dt, cam_R, cam_t)


def backsub_cost_plain(prob, cam, lm_pos, lm_terms, dx, cam_Rn, cam_tn, inlier,
                       use_huber: bool):
    """Plain version of kernel H (before its accept / reject): the point
    updates dp = -G (b_p + sum_d W_d^T dx_{k_d}) and the trial cost."""
    G, b_p, W, has_obs = lm_terms
    wtd = torch.einsum("ldia,ldi->la", W, dx[prob.obs_cam.long()])
    upd = (prob.lm_valid & has_obs).to(torch.float32)
    lm_new = lm_pos - (G @ (b_p + wtd)[..., None])[..., 0] * upd[:, None]
    cost, _, _ = _total_cost(prob, cam_Rn, cam_tn, lm_new, inlier, cam, use_huber)
    return lm_new, cost


def _stage_plain(prob, cam, R, t, p, inlier, use_huber: bool, iters: int):
    lam = torch.tensor(1e-4, dtype=torch.float32, device=R.device)
    cost = torch.tensor(math.inf, dtype=torch.float32, device=R.device)
    for _ in range(iters):
        cost0, Hcc, b_c, S_red, rhs_red, lm_terms = linearize_schur_plain(
            prob, cam, R, t, p, inlier, lam, use_huber)
        dx, Rn, tn = reduced_solve_plain(prob, R, t, Hcc, b_c, S_red, rhs_red, lam)
        pn, cost = backsub_cost_plain(prob, cam, p, lm_terms, dx, Rn, tn, inlier,
                                      use_huber)
        improved = cost < cost0
        gain = (cost0 - cost) / torch.clamp(cost0, min=1e-12)
        R = torch.where(improved, Rn, R)
        t = torch.where(improved, tn, t)
        p = torch.where(improved, pn, p)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        if bool(improved & (gain < 1e-3)):
            break
    return R, t, p, cost


def classify_plain(prob, cam, R, t, p, final: bool):
    """Plain version of kernel I: chi-square and depth of every observation
    at a state. final=False: the second stage's inliers (lm_keep_inlier rows
    stay in); final=True: the outlier flags of the valid observations."""
    ones = torch.ones_like(prob.obs_valid)
    _, chi2, depth_ok = _total_cost(prob, R, t, p, ones, cam, False)
    chi_thr = torch.where(prob.obs_x_right > 0, torch.full_like(chi2, CHI_SQ_3D),
                          torch.full_like(chi2, CHI_SQ_2D))
    if final:
        return prob.obs_valid & ((chi2 > chi_thr) | ~depth_ok)
    inlier = (chi2 <= chi_thr) & depth_ok
    if prob.lm_keep_inlier is not None:
        inlier = inlier | prob.lm_keep_inlier[:, None]
    return inlier


def _check_model(model: str):
    if model != "perspective":
        raise NotImplementedError(
            f"bundle adjustment for the {model} model is not ported yet "
            "(ROADMAP Queue 1 item 14b)")


def bundle_adjust_plain(prob: BAProblem, cam: CamScalars, *,
                        model: str = "perspective", num_first: int = 5,
                        num_second: int = 10) -> BAResult:
    _check_model(model)
    ones = torch.ones_like(prob.obs_valid)
    R1, t1, p1, cost1 = _stage_plain(prob, cam, prob.cam_R, prob.cam_t,
                                     prob.lm_pos, ones, True, num_first)
    inlier1 = classify_plain(prob, cam, R1, t1, p1, False)
    if num_second > 0:
        R2, t2, p2, cost = _stage_plain(prob, cam, R1, t1, p1, inlier1, False,
                                        num_second)
    else:
        R2, t2, p2, cost = R1, t1, p1, cost1
    return BAResult(R2, t2, p2, classify_plain(prob, cam, R2, t2, p2, True), cost)


# ---------------------------------------------------------------------------
# kernels F, G, H, I
# ---------------------------------------------------------------------------

# ctrl slots shared with csrc/ba_schur.cu
_COST0, _COST1, _LAM, _DONE, _LAST_COST = 0, 1, 2, 3, 4


class _KernelState:
    """Device buffers of one bundle_adjust call."""

    def __init__(self, prob: BAProblem, cam: CamScalars):
        K, L, D = prob.cam_R.shape[0], prob.obs_cam.shape[0], prob.obs_cam.shape[1]
        dev = prob.cam_R.device
        f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        self.K, self.L, self.D, self.cam = K, L, D, cam
        self.cam_R = prob.cam_R.reshape(K, 9).to(torch.float32).clone()
        self.cam_t = prob.cam_t.to(torch.float32).contiguous().clone()
        self.lm = prob.lm_pos.to(torch.float32).contiguous().clone()
        self.cam_Rn, self.cam_tn, self.lmn = f(K, 9), f(K, 3), f(L, 3)
        self.dx = f(K, 6)
        self.Wg, self.lmblk = f(L, D, 18), f(L, 10)
        self.hc, self.S, self.rhs = f(K, 27), f(6 * K, 6 * K), f(6 * K)
        # kernel G's factorization scratch where 6K x 6K outgrows shared memory
        self.factor = f(6 * K, 6 * K) if 6 * K > MAX_SOLVE_DIM else None
        self.ctrl = f(8)
        self.counter = torch.zeros(1, dtype=torch.int32, device=dev)
        # F's per-block partials and H's per-block trial costs
        self.f_blocks = f_blocks(K, L)
        self.f_part = torch.empty(self.f_blocks * (33 * K + 1 + 36 * K * K),
                                  dtype=torch.float32, device=dev)
        self.h_part = torch.empty(max(1, -(-L // LM_CHUNK)), dtype=torch.float32, device=dev)
        u8 = lambda b: b.to(torch.uint8).contiguous()
        self.keep = None if prob.lm_keep_inlier is None else u8(prob.lm_keep_inlier)
        self.inputs = dict(
            obs_cam=prob.obs_cam.to(torch.int32).contiguous(),
            obs_uv=prob.obs_uv.to(torch.float32).contiguous(),
            obs_xr=prob.obs_x_right.to(torch.float32).contiguous(),
            obs_isig=prob.obs_inv_sigma_sq.to(torch.float32).contiguous(),
            obs_valid=u8(prob.obs_valid), lm_valid=u8(prob.lm_valid),
            lm_fixed=None if prob.lm_fixed is None else u8(prob.lm_fixed),
            cam_free=_free(prob).contiguous())

    def problem_args(self, inlier):
        i = self.inputs
        c = self.cam
        return [self.K, self.L, self.D, i["obs_cam"].data_ptr(), i["obs_uv"].data_ptr(),
                i["obs_xr"].data_ptr(), i["obs_isig"].data_ptr(),
                i["obs_valid"].data_ptr(), inlier.data_ptr(), i["lm_valid"].data_ptr(),
                0 if i["lm_fixed"] is None else i["lm_fixed"].data_ptr(),
                i["cam_free"].data_ptr(), c.fx, c.fy, c.cx, c.cy, c.focal_x_baseline]


def ba_linearize_schur(st: _KernelState, inlier, use_huber: bool):
    """Kernel F: linearize at the current state and accumulate the reduced
    camera system (no-op once the stage's stop flag is set)."""
    lib = kbuild.load()
    kbuild.check(lib.svt_ba_linearize(
        *st.problem_args(inlier), st.cam_R.data_ptr(), st.cam_t.data_ptr(),
        st.lm.data_ptr(), int(use_huber), st.ctrl.data_ptr(), st.Wg.data_ptr(),
        st.lmblk.data_ptr(), st.hc.data_ptr(), st.S.data_ptr(), st.rhs.data_ptr(),
        st.f_blocks, st.f_part.data_ptr(), kbuild.stream_ptr(st.lm.device)), "ba_linearize")
    ba_linearize_schur.launches += 1


def ba_reduced_solve(st: _KernelState):
    """Kernel G: damped reduced solve and trial camera poses."""
    lib = kbuild.load()
    kbuild.check(lib.svt_ba_solve(
        st.K, st.inputs["cam_free"].data_ptr(), st.cam_R.data_ptr(),
        st.cam_t.data_ptr(), st.ctrl.data_ptr(), st.hc.data_ptr(), st.S.data_ptr(),
        st.rhs.data_ptr(), st.dx.data_ptr(), st.cam_Rn.data_ptr(),
        st.cam_tn.data_ptr(), 0 if st.factor is None else st.factor.data_ptr(),
        kbuild.stream_ptr(st.lm.device)), "ba_solve")
    ba_reduced_solve.launches += 1


def ba_backsub_cost(st: _KernelState, inlier, use_huber: bool):
    """Kernel H: point updates, trial cost, accept / reject on the device."""
    lib = kbuild.load()
    kbuild.check(lib.svt_ba_backsub(
        *st.problem_args(inlier), st.cam_R.data_ptr(), st.cam_t.data_ptr(),
        st.lm.data_ptr(), int(use_huber), st.ctrl.data_ptr(), st.counter.data_ptr(),
        st.Wg.data_ptr(), st.lmblk.data_ptr(), st.dx.data_ptr(), st.cam_Rn.data_ptr(),
        st.cam_tn.data_ptr(), st.lmn.data_ptr(), st.h_part.data_ptr(),
        kbuild.stream_ptr(st.lm.device)), "ba_backsub")
    ba_backsub_cost.launches += 1


def ba_classify(st: _KernelState, final: bool) -> torch.Tensor:
    """Kernel I: chi-square classification at the committed state; [L,D]
    bool, the second stage's inliers or (final) the outlier flags."""
    i, c = st.inputs, st.cam
    out = torch.empty((st.L, st.D), dtype=torch.bool, device=st.lm.device)
    lib = kbuild.load()
    kbuild.check(lib.svt_ba_classify(
        st.K, st.L, st.D, i["obs_cam"].data_ptr(), i["obs_uv"].data_ptr(),
        i["obs_xr"].data_ptr(), i["obs_isig"].data_ptr(), i["obs_valid"].data_ptr(),
        c.fx, c.fy, c.cx, c.cy, c.focal_x_baseline, st.cam_R.data_ptr(),
        st.cam_t.data_ptr(), st.lm.data_ptr(),
        0 if st.keep is None else st.keep.data_ptr(), int(final), out.data_ptr(),
        kbuild.stream_ptr(st.lm.device)), "ba_classify")
    ba_classify.launches += 1
    return out


ba_linearize_schur.launches = 0
ba_reduced_solve.launches = 0
ba_backsub_cost.launches = 0
ba_classify.launches = 0


def _check_problem(prob: BAProblem):
    K = prob.cam_R.shape[0]
    L, D = prob.obs_cam.shape
    dev = prob.cam_R.device
    shapes = dict(cam_R=(K, 3, 3), cam_t=(K, 3), cam_fixed=(K,), cam_valid=(K,),
                  lm_pos=(L, 3), lm_valid=(L,), obs_cam=(L, D), obs_uv=(L, D, 2),
                  obs_x_right=(L, D), obs_inv_sigma_sq=(L, D), obs_valid=(L, D),
                  lm_fixed=(L,), lm_keep_inlier=(L,))
    for name, shape in shapes.items():
        t = getattr(prob, name)
        if t is not None and (tuple(t.shape) != shape or t.device != dev):
            raise ValueError(f"bundle_adjust: {name} must have shape {shape} on {dev}")
    if K > MAX_CAMERAS:
        raise ValueError(f"bundle_adjust: at most {MAX_CAMERAS} camera slots (K={K})")


def bundle_adjust(prob: BAProblem, cam: CamScalars, *, model: str = "perspective",
                  num_first: int = 5, num_second: int = 10) -> BAResult:
    """Kernels F, G, H, I on CUDA tensors, the plain version on CPU tensors."""
    _check_model(model)
    if not prob.cam_R.is_cuda:
        return bundle_adjust_plain(prob, cam, model=model, num_first=num_first,
                                   num_second=num_second)
    _check_problem(prob)
    st = _KernelState(prob, cam)

    def stage(inlier, use_huber: bool, iters: int):
        st.ctrl[_LAM] = 1e-4
        st.ctrl[_DONE] = 0.0
        st.ctrl[_LAST_COST] = math.inf
        inl = inlier.to(torch.uint8).contiguous()
        for _ in range(iters):
            ba_linearize_schur(st, inl, use_huber)
            ba_reduced_solve(st)
            ba_backsub_cost(st, inl, use_huber)
        return st.ctrl[_LAST_COST].clone()

    cost1 = stage(torch.ones_like(prob.obs_valid), True, num_first)
    inlier1 = ba_classify(st, False)
    cost = stage(inlier1, False, num_second) if num_second > 0 else cost1
    return BAResult(st.cam_R.reshape(-1, 3, 3).clone(), st.cam_t.clone(),
                    st.lm.clone(), ba_classify(st, True), cost)
