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

On CUDA tensors every iteration is four kernels (csrc/ba_schur.cu):
F `ba_linearize_schur` (a thread per observation linearizes, a thread per
landmark forms Hpp^-1, then the Schur terms, the camera blocks and the cost
summed per 128-landmark chunk over F's pair index, `build_schur_index`,
built once per BA: one writer per entry, each chunk into its own partial;
then the partials added in chunk order), G
`ba_reduced_solve` (the 6K x 6K solve by a Cholesky on 32 x 32 tiles and the
trial poses: in one block's shared memory up to 6K = 192, across a cluster
of blocks up to 768, in a device-memory scratch above, as the global BA's
K = 129 .. 512 need), H `ba_backsub_cost` (point updates, trial cost, and on the device the
accept / reject, lambda update and stop flag). The stage launches all its
iterations without reading the host; after the stop flag every launch
returns at once. Kernel I `ba_classify` gives the chi-square
reclassification between the stages and the final outlier flags. No sum
on the card depends on the order threads arrive in: the same problem gives
the same bits on every run. On CPU
tensors `bundle_adjust_plain` runs the same schedule as torch ops
(index_add_ where the JAX version uses one-hot matmuls; the reduced system
through linalg.solve_spd_blocked).

Across landmark shards (the global BA over several devices,
parallel/sharded_ba.py, K22) each shard keeps its own rows, partials and
replica of the cameras: `shard_iteration` launches F and H per shard
without their reduce and decision, and kernel W (`ba_shard_assemble`, over
a `shard_table` built once per BA) adds every shard's partials, then trial
costs, in (shard, block) order on
every device, so that shards on 128-landmark chunk boundaries give the
unsharded BA's bits; G runs on every replica. The plain version shards the
same way (`iteration_plain`, the sums in shard order).

`model` is a camera model's name: "equirectangular" (ba.py:322-335, 398-403:
longitude / latitude rows, no stereo row) or one of the pinhole family
("perspective", and "fisheye" and "radial_division" on undistorted
keypoints); the kernels take the projection as a template parameter. The JAX
version's packed and stepped entry points and its chunked Schur product are
not ported (ROADMAP item 9).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild
from stella_vslam_tpu_torch.ops import lie
from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.camera.base import projection_family
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars, equirect_scales

CHI_SQ_2D = 5.991
CHI_SQ_3D = 7.815
MAX_CAMERAS = 512  # kernel G's largest system is 6 x 512 rows
LM_CHUNK = 128  # landmarks per block of kernels F and H
MAX_SHARDS = 64  # kernel W's shard table (csrc/ba_schur.cu kMaxShards)
# device memory for kernel F's per-block partials (33K + 1 + 36K^2 floats
# each): the block count is cut to fit where the system is large
F_PARTIAL_FLOATS = 1 << 23


def f_blocks(K: int, L: int) -> int:
    """Kernel F's block count: one per landmark chunk, at most as many as
    F_PARTIAL_FLOATS holds partials of a K-camera system."""
    chunks = -(-L // LM_CHUNK)
    return max(1, min(chunks, F_PARTIAL_FLOATS // (33 * K + 1 + 36 * K * K)))


def schur_index_caps(K: int, D: int):
    """(cap_t, cap_s): the pair terms and pair groups F's index holds per
    chunk at most (every landmark's D^2 ordered pairs; K(K+1)/2 camera
    pairs)."""
    cap_t = LM_CHUNK * D * D
    return cap_t, max(1, min(cap_t, K * (K + 1) // 2))


class SchurIndex(NamedTuple):
    """Kernel F's pair index (csrc/ba_schur.cu SchurIndex), per 128-landmark
    chunk c: the pair terms (l*D + d, l*D + e) of every landmark that is not
    fixed and every two valid observations (obs_valid and lm_valid) with
    cam_d <= cam_e, grouped by (cam_d, cam_e) and in (l, d, e) order within
    a group, at terms[c, :nterm[c]]; the groups (start, end, kd, ke; start
    and end absolute indices into terms.reshape(-1, 2)) at seg[c, :nseg[c]];
    the valid observations l*D + d grouped by camera in (l, d) order at
    cam_obs[c], camera k's run cam_seg[c, k] (absolute indices into
    cam_obs.reshape(-1)). Entries past those counts are not defined."""

    terms: torch.Tensor  # [C, cap_t, 2] int32
    seg: torch.Tensor  # [C, cap_s, 4] int32
    nseg: torch.Tensor  # [C] int32
    nterm: torch.Tensor  # [C] int32
    cam_obs: torch.Tensor  # [C, 128 * D] int32
    cam_seg: torch.Tensor  # [C, K, 2] int32
    cap_t: int
    cap_s: int

    @property
    def n_terms(self) -> int:
        return int(self.nterm.sum())


def schur_index_plain(obs_cam, obs_valid, lm_valid, lm_fixed, K: int) -> SchurIndex:
    """Plain version of F's index kernel: the same index by stable argsorts
    (unused entries -1)."""
    L, D = obs_cam.shape
    dev = obs_cam.device
    C = -(-L // LM_CHUNK)
    nD = LM_CHUNK * D
    cap_t, cap_s = schur_index_caps(K, D)
    i32 = lambda x: x.to(torch.int32)
    valid = obs_valid.bool() & lm_valid.bool()[:, None]
    oc = obs_cam.long()
    # the cameras' runs of valid observations
    od = torch.arange(L * D, device=dev)
    vflat = valid.reshape(-1)
    keys = (od // nD) * K + oc.reshape(-1)
    sel, ks = od[vflat], keys[vflat]
    order = torch.argsort(ks, stable=True)
    s_od = sel[order]
    counts = torch.bincount(ks, minlength=C * K).reshape(C, K)
    in_chunk = counts.sum(1)
    first = torch.cumsum(in_chunk, 0) - in_chunk
    cs = s_od // nD
    cam_obs = torch.full((C, nD), -1, dtype=torch.int32, device=dev)
    cam_obs[cs, torch.arange(s_od.numel(), device=dev) - first[cs]] = i32(s_od)
    start = torch.cumsum(counts, 1) - counts + (torch.arange(C, device=dev) * nD)[:, None]
    cam_seg = i32(torch.stack([start, start + counts], -1))
    # the pair terms, grouped by (kd, ke)
    keep = lm_valid.bool() if lm_fixed is None else lm_valid.bool() & ~lm_fixed.bool()
    m = valid[:, :, None] & valid[:, None, :] & (oc[:, :, None] <= oc[:, None, :]) \
        & keep[:, None, None]
    li, di, ei = m.nonzero(as_tuple=True)
    key = ((li // LM_CHUNK) * K + oc[li, di]) * K + oc[li, ei]
    order = torch.argsort(key, stable=True)
    li, di, ei, key = li[order], di[order], ei[order], key[order]
    tc = li // LM_CHUNK
    nterm = torch.bincount(tc, minlength=C)
    tfirst = torch.cumsum(nterm, 0) - nterm
    terms = torch.full((C, cap_t, 2), -1, dtype=torch.int32, device=dev)
    tpos = torch.arange(key.numel(), device=dev) - tfirst[tc]
    terms[tc, tpos] = i32(torch.stack([li * D + di, li * D + ei], -1))
    ukey, ucnt = torch.unique_consecutive(key, return_counts=True)
    ustart = torch.cumsum(ucnt, 0) - ucnt
    uc = ukey // (K * K)
    nseg = torch.bincount(uc, minlength=C)
    sfirst = torch.cumsum(nseg, 0) - nseg
    seg = torch.full((C, cap_s, 4), -1, dtype=torch.int32, device=dev)
    a = uc * cap_t + ustart - tfirst[uc]
    seg[uc, torch.arange(ukey.numel(), device=dev) - sfirst[uc]] = i32(torch.stack(
        [a, a + ucnt, (ukey // K) % K, ukey % K], -1))
    return SchurIndex(terms, seg, i32(nseg), i32(nterm), cam_obs, cam_seg, cap_t, cap_s)


def schur_index_equal(a: SchurIndex, b: SchurIndex) -> bool:
    """Whether two indexes agree on every defined entry."""
    if (a.cap_t, a.cap_s) != (b.cap_t, b.cap_s) or a.cam_obs.shape != b.cam_obs.shape \
            or a.cam_seg.shape != b.cam_seg.shape:
        return False
    if not (torch.equal(a.nseg, b.nseg) and torch.equal(a.nterm, b.nterm)
            and torch.equal(a.cam_seg, b.cam_seg)):
        return False
    n_obs = (a.cam_seg[..., 1] - a.cam_seg[..., 0]).sum(1)
    rows = lambda x, n: x[torch.arange(x.shape[1], device=x.device)[None] < n[:, None]]
    return all(torch.equal(rows(u, n), rows(v, n))
               for u, v, n in ((a.terms, b.terms, a.nterm), (a.seg, b.seg, a.nseg),
                               (a.cam_obs, b.cam_obs, n_obs)))


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


def _pose_rows(prob: BAProblem, cam_R, cam_t, lm_pos, cam: CamScalars,
               model: str = "perspective"):
    """Residual rows r [L,D,3], pose Jacobian Jc [L,D,3,6], point Jacobian
    Jp [L,D,3,3] and depth_ok [L,D]. Row 2 is the stereo row (zero for the
    equirectangular model); its weight is gated by has_stereo."""
    oc = prob.obs_cam.long()
    R = cam_R[oc]  # [L,D,3,3]
    t = cam_t[oc]
    Xc = (R @ lm_pos[:, None, :, None])[..., 0] + t
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zero = torch.zeros_like(x)
    if model == "equirectangular":
        Ln2 = x * x + y * y + z * z
        Ln = torch.sqrt(torch.clamp(Ln2, min=1e-16))
        xz2 = torch.clamp(x * x + z * z, min=1e-12)
        ku, kv = equirect_scales(cam)
        u = cam.cx + ku * torch.atan2(x, z)
        v = cam.cy + kv * torch.asin(torch.clamp(y / Ln, -1.0, 1.0))
        du = torch.remainder(u - prob.obs_uv[..., 0] + cam.width / 2.0,
                             cam.width) - cam.width / 2.0
        r = torch.stack([du, v - prob.obs_uv[..., 1], zero], -1)
        L2 = torch.clamp(Ln2, min=1e-16)
        denom = L2 * torch.sqrt(xz2)
        dpi = torch.stack([
            torch.stack([ku * z / xz2, zero, -ku * x / xz2], -1),
            torch.stack([-kv * x * y / denom, kv * torch.sqrt(xz2) / L2,
                         -kv * z * y / denom], -1),
            torch.stack([zero, zero, zero], -1)], -2)
        Jc = torch.cat([dpi, -(dpi @ lie.hat(Xc))], -1)
        return r, Jc, dpi @ R, Ln > 1e-6
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    u_r = u - cam.focal_x_baseline * iz
    r = torch.stack([u - prob.obs_uv[..., 0], v - prob.obs_uv[..., 1],
                     u_r - prob.obs_x_right], -1)
    dpi = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        torch.stack([cam.fx * iz, zero,
                     -cam.fx * x * iz2 + cam.focal_x_baseline * iz2], -1)], -2)
    Jc = torch.cat([dpi, -(dpi @ lie.hat(Xc))], -1)
    Jp = dpi @ R
    return r, Jc, Jp, z > 1e-4


def _row_weights(prob: BAProblem, r, depth_ok, inlier, use_huber: bool,
                 model: str = "perspective"):
    """(row weights wr [L,D,3], w_base [L,D], cost, chi2 [L,D])."""
    w_base = (prob.obs_valid & inlier & depth_ok & prob.lm_valid[:, None]).to(
        r.dtype) * prob.obs_inv_sigma_sq
    if model == "equirectangular":
        hs = torch.zeros_like(r[..., 2])
        sq = r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]
    else:
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


def _total_cost(prob, cam_R, cam_t, lm_pos, inlier, cam, use_huber, model="perspective"):
    r, _, _, depth_ok = _pose_rows(prob, cam_R, cam_t, lm_pos, cam, model)
    _, _, cost, chi2 = _row_weights(prob, r, depth_ok, inlier, use_huber, model)
    return cost, chi2, depth_ok


def _linearize(prob, cam_R, cam_t, lm_pos, inlier, cam, use_huber, model="perspective"):
    """One evaluation: cost and the lambda-independent blocks."""
    K = cam_R.shape[0]
    r, Jc, Jp, depth_ok = _pose_rows(prob, cam_R, cam_t, lm_pos, cam, model)
    wr, w_base, cost, _ = _row_weights(prob, r, depth_ok, inlier, use_huber, model)
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
                          use_huber: bool, model: str = "perspective"):
    """Plain version of kernel F: the cost at the state and the reduced
    camera system before damping. Returns (cost, Hcc [K,6,6], b_c [K,6],
    S_red [6K,6K], rhs_red [6K], per-landmark terms (G, b_p, W, has_obs))."""
    K = cam_R.shape[0]
    cost, (Hpp, b_p, Hcc, b_c, W, has_obs) = _linearize(
        prob, cam_R, cam_t, lm_pos, inlier, cam, use_huber, model)
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


def linearize_schur_indexed_plain(prob, cam, cam_R, cam_t, lm_pos, inlier, lam,
                                  use_huber: bool, model: str = "perspective"):
    """Kernel F's structure as torch ops: the camera-side sums of every
    128-landmark chunk over F's pair index (one triangle of S, mirrored),
    the chunks' partials then added in chunk order. Returns what
    linearize_schur_plain returns."""
    K = cam_R.shape[0]
    L, D = prob.obs_cam.shape
    index = schur_index_plain(prob.obs_cam, prob.obs_valid, prob.lm_valid, prob.lm_fixed, K)
    C = index.nterm.shape[0]
    dev, dt = cam_R.device, cam_R.dtype
    r, Jc, Jp, depth_ok = _pose_rows(prob, cam_R, cam_t, lm_pos, cam, model)
    wr, w_base, _, _ = _row_weights(prob, r, depth_ok, inlier, use_huber, model)
    Jcw = Jc * wr[..., None]
    Jpw = Jp * wr[..., None]
    hcc_o = torch.einsum("ldri,ldrj->ldij", Jcw, Jc).reshape(L * D, 6, 6)
    bc_o = torch.einsum("ldri,ldr->ldi", Jcw, r).reshape(L * D, 6)
    Hpp = torch.einsum("ldri,ldrj->lij", Jpw, Jp)
    b_p = torch.einsum("ldri,ldr->li", Jpw, r)
    W = torch.einsum("ldri,ldra->ldia", Jcw, Jp)
    has_obs = torch.sum(w_base, dim=1) > 0
    G = _sym3_inv(Hpp, lam)
    if prob.lm_fixed is not None:
        G = G * (~prob.lm_fixed).to(G.dtype)[:, None, None]
    A = (W @ G[:, None]).reshape(L * D, 6, 3)
    rr = (W @ G[:, None] @ b_p[:, None, :, None])[..., 0].reshape(L * D, 6)
    Wf = W.reshape(L * D, 6, 3)
    sq = r[..., 0] ** 2 + r[..., 1] ** 2
    sq = sq if model == "equirectangular" else sq + r[..., 2] ** 2 * (prob.obs_x_right > 0).to(dt)
    w = wr[..., 0]
    cost_l = torch.zeros(C * LM_CHUNK, dtype=dt, device=dev)
    cost_l[:L] = (w * sq).sum(1)
    # per chunk: the camera runs, the pair groups (and their mirrors), the cost
    part_hc = torch.zeros((C, K, 6, 6), dtype=dt, device=dev)
    part_bc = torch.zeros((C, K, 6), dtype=dt, device=dev)
    part_rhs = torch.zeros((C, K, 6), dtype=dt, device=dev)
    part_S = torch.zeros((C, K * K, 6, 6), dtype=dt, device=dev)
    cs = index.cam_seg.long()
    n_run = cs[..., 1] - cs[..., 0]
    run_key = torch.arange(C * K, device=dev).repeat_interleave(n_run.reshape(-1))
    run_od = index.cam_obs.reshape(-1).long()[
        torch.cat([torch.arange(a, b, device=dev) for a, b in cs.reshape(-1, 2).tolist()])
        if run_key.numel() else torch.zeros(0, dtype=torch.long, device=dev)]
    part_hc.view(C * K, 6, 6).index_add_(0, run_key, hcc_o[run_od])
    part_bc.view(C * K, 6).index_add_(0, run_key, bc_o[run_od])
    part_rhs.view(C * K, 6).index_add_(0, run_key, rr[run_od])
    valid_t = torch.arange(index.cap_t, device=dev)[None] < index.nterm[:, None].long()
    tod = index.terms[valid_t].long()
    tchunk = torch.arange(C, device=dev)[:, None].expand(C, index.cap_t)[valid_t]
    kd = prob.obs_cam.reshape(-1)[tod[:, 0]].long()
    ke = prob.obs_cam.reshape(-1)[tod[:, 1]].long()
    blk = A[tod[:, 0]] @ Wf[tod[:, 1]].transpose(1, 2)
    part_S.view(C * K * K, 6, 6).index_add_(0, (tchunk * K + kd) * K + ke, blk)
    off = kd != ke
    part_S.view(C * K * K, 6, 6).index_add_(0, ((tchunk * K + ke) * K + kd)[off],
                                            blk[off].transpose(1, 2))
    cost_c = cost_l.reshape(C, LM_CHUNK).sum(1)
    Hcc, b_c, rhs, S, cost = (_sum_shards([x[c] for c in range(C)]) for x in (
        part_hc, part_bc, part_rhs, part_S, cost_c))
    S_red = S.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    return cost, Hcc, b_c, S_red, rhs.reshape(-1), (G, b_p, W, has_obs)


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
                       use_huber: bool, model: str = "perspective"):
    """Plain version of kernel H (before its accept / reject): the point
    updates dp = -G (b_p + sum_d W_d^T dx_{k_d}) and the trial cost."""
    G, b_p, W, has_obs = lm_terms
    wtd = torch.einsum("ldia,ldi->la", W, dx[prob.obs_cam.long()])
    upd = (prob.lm_valid & has_obs).to(torch.float32)
    lm_new = lm_pos - (G @ (b_p + wtd)[..., None])[..., 0] * upd[:, None]
    cost, _, _ = _total_cost(prob, cam_Rn, cam_tn, lm_new, inlier, cam, use_huber, model)
    return lm_new, cost


def _sum_shards(terms):
    """The shards' terms added in shard order (one shard: its own term)."""
    out = terms[0]
    for x in terms[1:]:
        out = out + x
    return out


def iteration_plain(shards, cam, R, t, ps, inliers, lam, use_huber: bool,
                    model: str = "perspective"):
    """One LM iteration over landmark shards (each a BAProblem with the
    cameras and its own rows; one shard is the unsharded BA): F on each
    shard, the camera-side terms and costs added in shard order (kernel W's
    reduce mode), G once, H on each shard, the trial costs in shard order.
    Returns (cost0, trial cam_R, trial cam_t, trial points per shard, trial
    cost)."""
    lin = [linearize_schur_plain(p, cam, R, t, pi, inl, lam, use_huber, model)
           for p, pi, inl in zip(shards, ps, inliers)]
    cost0, Hcc, b_c, S_red, rhs_red = (_sum_shards([x[i] for x in lin]) for i in range(5))
    dx, Rn, tn = reduced_solve_plain(shards[0], R, t, Hcc, b_c, S_red, rhs_red, lam)
    back = [backsub_cost_plain(p, cam, pi, x[5], dx, Rn, tn, inl, use_huber, model)
            for p, pi, x, inl in zip(shards, ps, lin, inliers)]
    return cost0, Rn, tn, [b[0] for b in back], _sum_shards([b[1] for b in back])


def _stage_plain(shards, cam, R, t, ps, inliers, use_huber: bool, iters: int, model: str):
    lam = torch.tensor(1e-4, dtype=torch.float32, device=R.device)
    cost = torch.tensor(math.inf, dtype=torch.float32, device=R.device)
    for _ in range(iters):
        cost0, Rn, tn, pn, cost = iteration_plain(shards, cam, R, t, ps, inliers, lam,
                                                  use_huber, model)
        improved = cost < cost0
        gain = (cost0 - cost) / torch.clamp(cost0, min=1e-12)
        R = torch.where(improved, Rn, R)
        t = torch.where(improved, tn, t)
        ps = [torch.where(improved, a, b) for a, b in zip(pn, ps)]
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        if bool(improved & (gain < 1e-3)):
            break
    return R, t, ps, cost


def classify_plain(prob, cam, R, t, p, final: bool, model: str = "perspective"):
    """Plain version of kernel I: chi-square and depth of every observation
    at a state. final=False: the second stage's inliers (lm_keep_inlier rows
    stay in); final=True: the outlier flags of the valid observations."""
    ones = torch.ones_like(prob.obs_valid)
    _, chi2, depth_ok = _total_cost(prob, R, t, p, ones, cam, False, model)
    chi_thr = torch.where(prob.obs_x_right > 0, torch.full_like(chi2, CHI_SQ_3D),
                          torch.full_like(chi2, CHI_SQ_2D))
    if final:
        return prob.obs_valid & ((chi2 > chi_thr) | ~depth_ok)
    inlier = (chi2 <= chi_thr) & depth_ok
    if prob.lm_keep_inlier is not None:
        inlier = inlier | prob.lm_keep_inlier[:, None]
    return inlier


def bundle_adjust_shards_plain(shards, cam: CamScalars, *, model: str = "perspective",
                               num_first: int = 5, num_second: int = 10) -> BAResult:
    """The plain BA over landmark shards (iteration_plain); the points and
    outlier flags of the shards concatenated in shard order."""
    ones = [torch.ones_like(p.obs_valid) for p in shards]
    R0, t0 = shards[0].cam_R, shards[0].cam_t
    R1, t1, p1, cost1 = _stage_plain(shards, cam, R0, t0, [p.lm_pos for p in shards], ones,
                                     True, num_first, model)
    inlier1 = [classify_plain(p, cam, R1, t1, pi, False, model) for p, pi in zip(shards, p1)]
    if num_second > 0:
        R2, t2, p2, cost = _stage_plain(shards, cam, R1, t1, p1, inlier1, False,
                                        num_second, model)
    else:
        R2, t2, p2, cost = R1, t1, p1, cost1
    flags = [classify_plain(p, cam, R2, t2, pi, True, model) for p, pi in zip(shards, p2)]
    return BAResult(R2, t2, torch.cat(p2), torch.cat(flags), cost)


def bundle_adjust_plain(prob: BAProblem, cam: CamScalars, *,
                        model: str = "perspective", num_first: int = 5,
                        num_second: int = 10) -> BAResult:
    return bundle_adjust_shards_plain([prob], cam, model=model, num_first=num_first,
                                      num_second=num_second)


# ---------------------------------------------------------------------------
# kernels F, G, H, I
# ---------------------------------------------------------------------------

# ctrl slots shared with csrc/ba_schur.cu
_COST0, _COST1, _LAM, _DONE, _LAST_COST = 0, 1, 2, 3, 4


class _KernelState:
    """Device buffers of one bundle_adjust call, or of one landmark shard of
    a sharded one: the shard's rows and observation tables, its own F
    partials and H trial costs, its replica of the cameras, of the reduced
    system and of ctrl, all on the shard's device."""

    def __init__(self, prob: BAProblem, cam: CamScalars, model: str = "perspective"):
        K, L, D = prob.cam_R.shape[0], prob.obs_cam.shape[0], prob.obs_cam.shape[1]
        dev = prob.cam_R.device
        f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        self.K, self.L, self.D, self.cam = K, L, D, cam
        self.kind = projection_family(model)
        self.cam_R = prob.cam_R.reshape(K, 9).to(torch.float32).clone()
        self.cam_t = prob.cam_t.to(torch.float32).contiguous().clone()
        self.lm = prob.lm_pos.to(torch.float32).contiguous().clone()
        self.cam_Rn, self.cam_tn, self.lmn = f(K, 9), f(K, 3), f(L, 3)
        self.dx = f(K, 6)
        self.Wg, self.lmblk = f(L, D, 18), f(L, 10)
        self.hc, self.S, self.rhs = f(K, 27), f(6 * K, 6 * K), f(6 * K)
        # kernel G's tiles where 6K x 6K outgrows a cluster's shared memory
        floats = linalg.solve_scratch_floats(6 * K)
        self.factor = f(floats) if floats else None
        self.ctrl = f(8)
        # F's per-block partials; H's per-chunk trial costs, its landmarks'
        # costs and its tickets (one a chunk and one for the decision, left
        # at zero by every launch)
        self.f_blocks = f_blocks(K, L) if L else 0
        self.f_part = torch.empty(self.f_blocks * (33 * K + 1 + 36 * K * K),
                                  dtype=torch.float32, device=dev)
        self.h_blocks = -(-L // LM_CHUNK)
        self.h_part = torch.empty(max(1, self.h_blocks), dtype=torch.float32, device=dev)
        self.h_cost = torch.empty(max(1, self.h_blocks) * LM_CHUNK, dtype=torch.float32,
                                  device=dev)
        self.tickets = torch.zeros(self.h_blocks + 1, dtype=torch.int32, device=dev)
        # F's per-observation scratch: A = W G, the camera-side terms, the
        # landmarks' costs
        e = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        self.f_A, self.f_hcr, self.f_cost = e(L * D * 18), e(L * D * 33), e(max(1, L))
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
        self.index, self.f_ptrs = None, None
        if dev.type == "cuda":
            build_schur_index(self)

    def set_index(self, index: SchurIndex):
        """F's pair index and the host array of F's index and scratch
        pointers (csrc/ba_schur.cu unpack_f's order)."""
        self.index = index
        ptrs = [index.terms, index.seg, index.nseg, index.nterm, index.cam_obs, index.cam_seg,
                self.f_A, self.f_hcr, self.f_cost]
        self.f_ptrs = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])

    def problem_args(self, inlier):
        i = self.inputs
        c = self.cam
        return [self.kind, self.K, self.L, self.D, i["obs_cam"].data_ptr(),
                i["obs_uv"].data_ptr(), i["obs_xr"].data_ptr(), i["obs_isig"].data_ptr(),
                i["obs_valid"].data_ptr(), inlier.data_ptr(), i["lm_valid"].data_ptr(),
                0 if i["lm_fixed"] is None else i["lm_fixed"].data_ptr(),
                i["cam_free"].data_ptr(), c.fx, c.fy, c.cx, c.cy, c.focal_x_baseline,
                c.width, c.height]


def ba_linearize_schur(st: _KernelState, inlier, use_huber: bool, reduce: bool = True):
    """Kernel F: linearize at the current state and accumulate the reduced
    camera system (no-op once the stage's stop flag is set). reduce=False,
    on a shard of a sharded BA: the block partials only, for kernel W."""
    lib = kbuild.load()
    head = (*st.problem_args(inlier), st.cam_R.data_ptr(), st.cam_t.data_ptr(),
            st.lm.data_ptr(), int(use_huber), st.ctrl.data_ptr(), st.Wg.data_ptr(),
            st.lmblk.data_ptr())
    tail = (st.f_blocks, st.f_part.data_ptr(), ctypes.addressof(st.f_ptrs), st.index.cap_t,
            st.index.cap_s, kbuild.stream_ptr(st.lm.device))
    if reduce:
        err = lib.svt_ba_linearize(*head, st.hc.data_ptr(), st.S.data_ptr(),
                                   st.rhs.data_ptr(), *tail)
    else:
        err = lib.svt_ba_linearize_part(*head, *tail)
    kbuild.check(err, "ba_linearize")
    ba_linearize_schur.launches += 1


def build_schur_index(st: _KernelState) -> SchurIndex:
    """Kernel F's pair index of st's problem (SchurIndex), built once per BA
    on st's device: one block per 128-landmark chunk, with stable counting
    sorts over the cameras (csrc/ba_schur.cu ba_schur_index_kernel); the
    plain version (schur_index_plain) for CPU tensors. Sets it on st."""
    i = st.inputs
    if not st.lm.is_cuda:
        index = schur_index_plain(i["obs_cam"], i["obs_valid"], i["lm_valid"], i["lm_fixed"],
                                  st.K)
        st.set_index(index)
        return index
    K, L, D = st.K, st.L, st.D
    C = -(-L // LM_CHUNK)
    cap_t, cap_s = schur_index_caps(K, D)
    if C * cap_t >= 2 ** 31:
        raise ValueError(f"build_schur_index: L * D^2 too large ({L} x {D}^2)")
    dev = st.lm.device
    e = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    index = SchurIndex(e(C, cap_t, 2), e(C, cap_s, 4), e(C), e(C), e(C, LM_CHUNK * D),
                       e(C, K, 2), cap_t, cap_s)
    st.set_index(index)
    key0, key1, val1 = e(C * cap_t), e(C * cap_t), e(C * cap_t, 2)
    lib = kbuild.load()
    with torch.cuda.device(dev):
        kbuild.check(lib.svt_ba_schur_index(
            K, L, D, i["obs_cam"].data_ptr(), i["obs_valid"].data_ptr(),
            i["lm_valid"].data_ptr(), 0 if i["lm_fixed"] is None else i["lm_fixed"].data_ptr(),
            ctypes.addressof(st.f_ptrs), cap_t, cap_s, key0.data_ptr(), key1.data_ptr(),
            val1.data_ptr(), kbuild.stream_ptr(dev)), "ba_schur_index")
    build_schur_index.launches += 1
    return index


def ba_reduced_solve(st: _KernelState):
    """Kernel G: damped reduced solve and trial camera poses."""
    lib = kbuild.load()
    kbuild.check(lib.svt_ba_solve(
        st.K, st.inputs["cam_free"].data_ptr(), st.cam_R.data_ptr(),
        st.cam_t.data_ptr(), st.ctrl.data_ptr(), st.hc.data_ptr(), st.S.data_ptr(),
        st.rhs.data_ptr(), st.dx.data_ptr(), st.cam_Rn.data_ptr(),
        st.cam_tn.data_ptr(), 0 if st.factor is None else st.factor.data_ptr(),
        0 if st.factor is None else st.factor.numel(), kbuild.stream_ptr(st.lm.device)),
        "ba_solve")
    ba_reduced_solve.launches += 1


def ba_backsub_cost(st: _KernelState, inlier, use_huber: bool, decide: bool = True):
    """Kernel H: point updates, trial cost, accept / reject on the device.
    decide=False, on a shard of a sharded BA: the trial points and the
    blocks' trial costs only, for kernel W's decide mode."""
    lib = kbuild.load()
    kbuild.check(lib.svt_ba_backsub(
        *st.problem_args(inlier), st.cam_R.data_ptr(), st.cam_t.data_ptr(),
        st.lm.data_ptr(), int(use_huber), st.ctrl.data_ptr(), st.tickets.data_ptr(),
        st.Wg.data_ptr(), st.lmblk.data_ptr(), st.dx.data_ptr(), st.cam_Rn.data_ptr(),
        st.cam_tn.data_ptr(), st.lmn.data_ptr(), st.h_cost.data_ptr(), st.h_part.data_ptr(),
        int(decide),
        kbuild.stream_ptr(st.lm.device)), "ba_backsub")
    ba_backsub_cost.launches += 1


def ba_classify(st: _KernelState, final: bool) -> torch.Tensor:
    """Kernel I: chi-square classification at the committed state; [L,D]
    bool, the second stage's inliers or (final) the outlier flags."""
    i, c = st.inputs, st.cam
    out = torch.empty((st.L, st.D), dtype=torch.bool, device=st.lm.device)
    lib = kbuild.load()
    kbuild.check(lib.svt_ba_classify(
        st.kind, st.K, st.L, st.D, i["obs_cam"].data_ptr(), i["obs_uv"].data_ptr(),
        i["obs_xr"].data_ptr(), i["obs_isig"].data_ptr(), i["obs_valid"].data_ptr(),
        c.fx, c.fy, c.cx, c.cy, c.focal_x_baseline, c.width, c.height, st.cam_R.data_ptr(),
        st.cam_t.data_ptr(), st.lm.data_ptr(),
        0 if st.keep is None else st.keep.data_ptr(), int(final), out.data_ptr(),
        kbuild.stream_ptr(st.lm.device)), "ba_classify")
    ba_classify.launches += 1
    return out


class ShardTable(NamedTuple):
    """Kernel W's view of a sharded BA's states, built once per BA: the
    device pointers of every shard's F partials and H trial costs and their
    counts, as host arrays in shard order (the buffers live as long as the
    states and never move)."""

    count: int
    f_parts: ctypes.Array
    f_blocks: ctypes.Array
    h_parts: ctypes.Array
    h_blocks: ctypes.Array


def shard_table(states) -> ShardTable:
    """The ShardTable of a sharded BA's states (at most MAX_SHARDS)."""
    n = len(states)
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"shard_table: 1 to {MAX_SHARDS} shards ({n})")
    ptrs = lambda xs: (ctypes.c_void_p * n)(*xs)
    ints = lambda xs: (ctypes.c_int * n)(*xs)
    return ShardTable(n, ptrs([st.f_part.data_ptr() for st in states]),
                      ints([st.f_blocks for st in states]),
                      ptrs([st.h_part.data_ptr() for st in states]),
                      ints([st.h_blocks for st in states]))


def ba_shard_assemble(dst: _KernelState, table: ShardTable, decide: bool):
    """Kernel W on dst's device, for dst's replica. Reduce mode: every
    shard's F partials added in (shard, block) order into dst's Hcc / b_c,
    reduced system, right-hand side and cost. Decide mode: every shard's H
    trial costs added in the same order, H's accept / reject on dst's ctrl,
    and on accept dst's cameras and points committed. The shards' partials
    may lie on other devices that dst's device reads by peer access."""
    parts, blocks = (table.h_parts, table.h_blocks) if decide else (table.f_parts,
                                                                   table.f_blocks)
    lib = kbuild.load()
    kbuild.check(lib.svt_ba_shard_assemble(
        int(decide), dst.K, dst.L, table.count, ctypes.addressof(parts),
        ctypes.addressof(blocks), dst.ctrl.data_ptr(), dst.hc.data_ptr(), dst.S.data_ptr(),
        dst.rhs.data_ptr(), dst.cam_R.data_ptr(), dst.cam_t.data_ptr(), dst.lm.data_ptr(),
        dst.cam_Rn.data_ptr(), dst.cam_tn.data_ptr(), dst.lmn.data_ptr(),
        kbuild.stream_ptr(dst.lm.device)), "ba_shard_assemble")
    ba_shard_assemble.launches += 1


ba_linearize_schur.launches = 0
build_schur_index.launches = 0
ba_reduced_solve.launches = 0
ba_backsub_cost.launches = 0
ba_classify.launches = 0
ba_shard_assemble.launches = 0


def shard_reduce_plain(parts, K: int):
    """Plain version of kernel W's reduce mode: the shards' F partials (each
    a flat tensor of whole 33K + 1 + 36K^2 float partials) added one after
    another in (shard, block) order, from zero, as the kernel adds them.
    Returns (hc [K,27], rhs [6K], cost, S [6K,6K])."""
    n = 33 * K + 1 + 36 * K * K
    acc = torch.zeros(n, dtype=torch.float32, device=parts[0].device)
    for part in parts:
        for b in range(part.numel() // n):
            acc = acc + part[b * n:(b + 1) * n]
    return acc[:27 * K].reshape(K, 27), acc[27 * K:33 * K], acc[33 * K], \
        acc[33 * K + 1:].reshape(6 * K, 6 * K)


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
    """Kernels F, G, H, I on CUDA tensors, the plain version on CPU tensors:
    bundle_adjust_shards over the one shard that is the whole problem."""
    return bundle_adjust_shards([prob], cam, model=model, num_first=num_first,
                                num_second=num_second)


# ---------------------------------------------------------------------------
# landmark shards (K22): F and H per shard, W across them, G replicated
# ---------------------------------------------------------------------------


def _shard_barrier(states):
    """Order the shards' devices: each device's current stream waits for
    every other device's work so far (CUDA events, no host wait). Shards on
    one device share its stream and need nothing."""
    devs = list(dict.fromkeys(st.lm.device for st in states))
    if len(devs) < 2:
        return
    evs = {}
    for d in devs:
        evs[d] = torch.cuda.Event()
        evs[d].record(torch.cuda.current_stream(d))
    for d in devs:
        s = torch.cuda.current_stream(d)
        for e, ev in evs.items():
            if e != d:
                s.wait_event(ev)


def shard_iteration(states, inliers, use_huber: bool, decide: bool = True,
                    table: Optional[ShardTable] = None):
    """One LM iteration over shard states: F's first launch on each shard,
    W's reduce mode and G on every shard's device, H without its decision on
    each shard, then (decide) W's decide mode on every shard's device, W
    over `table` (the states' shard_table; None for one shard). One shard
    is the one-device BA: F reduces its own partials and H decides (three
    launches, the same bits as W's one-shard case)."""
    if len(states) == 1:
        st, inl = states[0], inliers[0]
        with torch.cuda.device(st.lm.device):
            ba_linearize_schur(st, inl, use_huber)
            ba_reduced_solve(st)
            ba_backsub_cost(st, inl, use_huber, decide=decide)
        return
    for st, inl in zip(states, inliers):
        with torch.cuda.device(st.lm.device):
            ba_linearize_schur(st, inl, use_huber, reduce=False)
    _shard_barrier(states)
    for st in states:
        with torch.cuda.device(st.lm.device):
            ba_shard_assemble(st, table, decide=False)
            ba_reduced_solve(st)
    for st, inl in zip(states, inliers):
        with torch.cuda.device(st.lm.device):
            ba_backsub_cost(st, inl, use_huber, decide=False)
    _shard_barrier(states)
    if decide:
        for st in states:
            with torch.cuda.device(st.lm.device):
                ba_shard_assemble(st, table, decide=True)


def bundle_adjust_shards(shards: List[BAProblem], cam: CamScalars, *,
                         model: str = "perspective", num_first: int = 5,
                         num_second: int = 10) -> BAResult:
    """bundle_adjust over landmark shards: each BAProblem holds the cameras
    and its own rows, on its device (a device may hold several shards).
    Kernels F, H and I per shard, W across them, G on each replica; the
    plain version (bundle_adjust_shards_plain) on CPU tensors. The kernels
    launch on each shard's card, which need not be the current one (a launch
    goes to the current card's context). The result lies on the first
    shard's device, points and flags in shard order."""
    if not shards[0].cam_R.is_cuda:
        return bundle_adjust_shards_plain(shards, cam, model=model, num_first=num_first,
                                          num_second=num_second)
    for p in shards:
        _check_problem(p)
    states = [_KernelState(p, cam, model) for p in shards]
    table = shard_table(states) if len(states) > 1 else None
    dev0 = states[0].lm.device

    def stage(inliers, use_huber: bool, iters: int):
        for st in states:
            st.ctrl[_LAM] = 1e-4
            st.ctrl[_DONE] = 0.0
            st.ctrl[_LAST_COST] = math.inf
        inls = [i.to(torch.uint8).contiguous() for i in inliers]
        for _ in range(iters):
            shard_iteration(states, inls, use_huber, table=table)
        return states[0].ctrl[_LAST_COST].clone()

    def classify(final: bool):
        out = []
        for st in states:
            with torch.cuda.device(st.lm.device):
                out.append(ba_classify(st, final))
        return out

    cost1 = stage([torch.ones_like(p.obs_valid) for p in shards], True, num_first)
    cost = stage(classify(False), False, num_second) if num_second > 0 else cost1
    flags = classify(True)
    # no device's buffers are reused before every device's reads of them end
    _shard_barrier(states)
    return BAResult(states[0].cam_R.reshape(-1, 3, 3).clone(), states[0].cam_t.clone(),
                    torch.cat([st.lm.to(dev0) for st in states]),
                    torch.cat([f.to(dev0) for f in flags]), cost)


def gn_step_shards(shards: List[BAProblem], cam: CamScalars, model: str = "perspective"):
    """One plain Gauss-Newton step over landmark shards (the JAX package's
    make_sharded_ba_step): lambda 1e-4, no robust weights, every
    observation an inlier, the step always taken; lm_fixed and
    lm_keep_inlier are not read. Kernels F, W, G and H (without its
    decision) on CUDA tensors, iteration_plain on CPU tensors. Returns the
    stepped (cam_R, cam_t) on the first shard's device and each shard's
    stepped points on its own."""
    shards = [p._replace(lm_fixed=None, lm_keep_inlier=None) for p in shards]
    ones = [torch.ones_like(p.obs_valid) for p in shards]
    if not shards[0].cam_R.is_cuda:
        lam = torch.tensor(1e-4, dtype=torch.float32, device=shards[0].cam_R.device)
        _, R, t, ps, _ = iteration_plain(shards, cam, shards[0].cam_R, shards[0].cam_t,
                                         [p.lm_pos for p in shards], ones, lam, False, model)
        return R, t, ps
    for p in shards:
        _check_problem(p)
    states = [_KernelState(p, cam, model) for p in shards]
    for st in states:
        st.ctrl[_LAM] = 1e-4
    shard_iteration(states, [i.to(torch.uint8).contiguous() for i in ones], False,
                    decide=False, table=shard_table(states) if len(states) > 1 else None)
    _shard_barrier(states)
    s0 = states[0]
    return s0.cam_Rn.reshape(-1, 3, 3).clone(), s0.cam_tn.clone(), \
        [st.lmn.clone() for st in states]
