#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (stella_vslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit, which every later number is measured on;
  2. build: compiles the kernels of csrc/ with nvcc for sm_90a, one process
     per source, all at once (timed);
  3. kernels A-D of the RGBD tracking slice against their plain PyTorch
     versions at its shapes (752x480, 8 levels, N=2872 slots, C=4096 table
     rows): A and C exact, B's descriptor bit-mismatch rate <= 5e-5 (the CPU
     test's bound against JAX), D's pose within 1e-4;
  4. the monocular initialization kernels at the mono slice's shapes: C's
     angle-gate mode (the area matcher, 2872x2872) against its plain
     version, with the share of rows that differ (CUDA's and torch's
     sinf/atan2f may differ in the last ulp); E (two-view RANSAC) against
     plain for H and F at 1024 hypotheses x 2872 matches: the same best
     inlier count; its escalated sweep (8 x 4096 with 3 LO refits) once;
     where E's F hypotheses part from plain (the counts of each
     hypothesis on four seeds, against plain and against plain's null
     vector projected to rank 2 in float64, the kernel's route for that
     step); F, G, H, I (bundle adjustment) against the plain BA on an
     init-sized problem (K=2, L=4096, D=2) and a K=8, D=4 problem with
     stereo rows: poses within 1e-4, points seen twice within 1e-3,
     identical outlier flags;
     median times of every kernel and its plain version (CUDA events),
     each beside its bound (the least time the card could take for the
     work: bytes over 3.35 TB/s or operations over 67 T/s, FP32 outside the
     tensor cores, integer operations counted at the same rate) and, where
     one PyTorch call computes the same function, that call's time;
  5. the RGBD slice: System in RGBD mode, mapping disabled, 120 frames of
     the numpy plane world at 0.015 m/frame (the bench's RGBD settings):
     at most 2 frames lost after init, rigid ATE < 0.10 m, scale error
     < 5%, kernels A-D launched;
  6. the mono slice: System in monocular mode, mapping disabled, 120 frames
     of the same world (the bench's mono settings): initialized by frame 10,
     at most 2 frames lost after init, Sim3 ATE < 0.10 m, kernels A-I
     launched; frame time p50/p99 over the steady frames and the init
     frame's time by phase.
Launch counts are set to 0 just before each slice and read just after it;
the kernels line reports the mono slice's. The line before the last is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}. Long
logs go to chiprun_out/.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

DESC_MISMATCH_BOUND = 5e-5  # tests/test_torch_orb.py DESC_BIT_MISMATCH_MAX
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bound(nbytes: float, ops: float) -> dict:
    """The least time for `nbytes` of traffic and `ops` operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_kernels(dev, world):
    """Kernels A-D against their plain versions on the card; returns rows
    of the kernels line (launch counts filled in after the slices)."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.match.robust import cos_30deg
    from stella_vslam_tpu_torch.ops.optim import pose as pose_mod
    from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    rows = []
    params = OrbParams(num_levels=8)
    ex = ox.OrbExtractor(params, 752, 480, min_area=800, device=dev)
    img = torch.from_numpy(world.render(pose_at_xy(0.6, 0.0))).to(dev)
    levels = ex.pyramid(img)
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    pyr_bytes = 4.0 * sum(l.numel() for l in levels)

    # ---- A: FAST + NMS, all levels of a frame ----
    def run_a(fn):
        return [fn(l.contiguous(), g, ex.border, *thr)
                for l, g in zip(levels, ex.levels)]

    ka, pa = run_a(ox.fast_nms), run_a(ox.fast_nms_plain)
    torch.cuda.synchronize()
    err_a = max(int((k - p).abs().max()) for k, p in zip(ka, pa))
    n_kp = int(sum(int((k >= 0).sum()) for k in ka))
    print(f"kernel A fast_nms: {n_kp}/{ex.num_slots} cells with a corner, "
          f"max |key diff| {err_a}")
    assert err_a == 0, "kernel A disagrees with its plain version"
    n_px = sum(l.numel() for l in levels)
    # per pixel: 16 ring differences, then the 9-arc min / max over 16 arcs
    rows.append(dict(
        name="fast_nms", route="cuda",
        source="stella_vslam_tpu_torch/csrc/fast_nms.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:88",
        max_abs_err=float(err_a),
        ms=_median_ms(lambda: run_a(ox.fast_nms)),
        plain_ms=_median_ms(lambda: run_a(ox.fast_nms_plain)),
        library_ms=None, **_bound(pyr_bytes + 4.0 * ex.num_slots, 300.0 * n_px)))

    # ---- B: orientation + blur + steered BRIEF, one frame's slots ----
    pts = [ex.cell_keypoints(k, g) for k, g in zip(ka, ex.levels)]
    px, py, valid, _ = (torch.cat(c) for c in zip(*pts))
    pyr = torch.cat([l.reshape(-1) for l in levels])
    args = (pyr, ex._slot_base, ex._slot_H, ex._slot_W, px.to(torch.int32),
            py.to(torch.int32), valid, ex._tables)
    ang_k, desc_k = ox.orb_describe(*args)
    ang_p, desc_p = ox.orb_describe_plain(*args)
    torch.cuda.synchronize()
    err_b = float((ang_k - ang_p).abs().max())
    x = (desc_k ^ desc_p)[valid].cpu().numpy()
    bit_rate = float(np.unpackbits(x.view(np.uint8)).sum()) / max(1, x.size * 32)
    n_valid = int(valid.sum())
    print(f"kernel B orb_describe: {n_valid} keypoints, descriptor "
          f"bit mismatch {bit_rate:.6f}, max |angle diff| {err_b:.3g} rad")
    assert bit_rate <= DESC_MISMATCH_BOUND, "kernel B descriptors disagree"
    assert err_b < 1e-3, "kernel B angles disagree"
    # per keypoint: IC moments over the 31x31 disc, the 39x39 x 49-tap
    # blur, 256 comparisons
    rows.append(dict(
        name="orb_describe", route="cuda",
        source="stella_vslam_tpu_torch/csrc/orb_describe.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:392",
        max_abs_err=err_b, desc_bit_mismatch=bit_rate,
        ms=_median_ms(lambda: ox.orb_describe(*args)),
        plain_ms=_median_ms(lambda: ox.orb_describe_plain(*args)),
        library_ms=None,
        **_bound(pyr_bytes + 36.0 * ex.num_slots,
                 n_valid * (31 * 31 * 2 + 39 * 39 * 49 * 2 + 256 * 2))))

    # ---- C: gated Hamming top-2 at the local-map shape (C=4096 x N) ----
    g = torch.Generator(device="cpu").manual_seed(7)
    N, C = ex.num_slots, 4096
    kp_desc = desc_k
    kp_uv = torch.stack([px.float(), py.float()], -1) * ex._slot_scale[:, None]
    src = torch.randint(0, N, (C,), generator=g).to(dev)
    flips = torch.randint(0, 2, (C, 8), generator=g, dtype=torch.int32).to(dev) \
        << torch.randint(0, 32, (C, 8), generator=g, dtype=torch.int32).to(dev)
    q_desc = (kp_desc[src] ^ flips).contiguous()
    level = ex._slot_level
    kp_xr = torch.where(torch.rand(N, generator=g).to(dev) < 0.5,
                        kp_uv[:, 0] - 30.0, torch.full((N,), -1.0, device=dev))
    pred = level[src]
    win = H.WindowGate(
        row_u=(kp_uv[src, 0] + torch.randn(C, generator=g).to(dev) * 3).contiguous(),
        row_v=(kp_uv[src, 1] + torch.randn(C, generator=g).to(dev) * 3).contiguous(),
        row_xr=kp_xr[src].contiguous(),
        row_rad=5.0 * torch.tensor(params.scale_factors, device=dev)[pred.long()],
        row_lo=torch.clamp(pred - 1, min=0), row_hi=torch.clamp(pred + 1, max=7),
        col_u=kp_uv[:, 0].contiguous(), col_v=kp_uv[:, 1].contiguous(),
        col_xr=kp_xr.contiguous(), col_level=level)
    row_ok = torch.rand(C, generator=g).to(dev) < 0.9
    col_ok = valid & (torch.rand(N, generator=g).to(dev) < 0.8)
    ori = H.OrientGate(torch.cos(ang_k), torch.sin(ang_k), torch.cos(ang_k),
                       torch.sin(ang_k), cos_30deg(dev))
    cases = [((q_desc, kp_desc, row_ok, col_ok), dict(window=win)),
             ((kp_desc, kp_desc, valid, valid), dict(orient=ori))]
    err_c = 0
    for a, kw in cases:
        outk = H.hamming_top2(*a, **kw)
        outp = H.hamming_top2_plain(*a, **kw)
        err_c = max(err_c, max(int((u - v).abs().max()) for u, v in zip(outk, outp)))
    torch.cuda.synchronize()
    print(f"kernel C hamming_top2: window {C}x{N} and orientation {N}x{N}, "
          f"max |diff| {err_c}")
    assert err_c == 0, "kernel C disagrees with its plain version"
    a, kw = cases[0]
    n_cand = float(H.gate_matrix(row_ok, col_ok, win, None).sum())
    # 8 gate operations per pair, XOR + popcount + add over 8 words per
    # candidate pair
    rows.append(dict(
        name="hamming_top2", route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/hamming.py:31",
        max_abs_err=float(err_c),
        ms=_median_ms(lambda: H.hamming_top2(*a, **kw)),
        plain_ms=_median_ms(lambda: H.hamming_top2_plain(*a, **kw)),
        library_ms=None,
        **_bound(C * (32 + 24 + 16) + N * (32 + 17), 8.0 * C * N + 24.0 * n_cand)))

    # ---- D: motion-only pose optimization, N slots, 20% outliers ----
    rng = np.random.default_rng(3)
    cam = CamScalars(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752.0,
                     height=480.0, focal_x_baseline=float(np.float32(458.0 * 0.12)))
    uv_true = np.stack([rng.uniform(10, 742, N), rng.uniform(10, 470, N)], -1)
    z = rng.uniform(2.0, 6.0, N)
    pc = np.stack([(uv_true[:, 0] - cam.cx) * z / cam.fx,
                   (uv_true[:, 1] - cam.cy) * z / cam.fy, z], -1)
    ang = 0.05
    R_true = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
    t_true = np.array([0.1, -0.05, 0.2])
    pos_w = (pc - t_true) @ R_true  # R^T (pc - t)
    obs = uv_true + rng.normal(0, 1.0, (N, 2))
    out = rng.random(N) < 0.2
    obs[out] += rng.uniform(-40, 40, (int(out.sum()), 2))
    stereo = rng.random(N) < 0.5
    xr = np.where(stereo, obs[:, 0] - cam.focal_x_baseline / z, -1.0)
    lvl = rng.integers(0, 8, N)
    inv_sig = np.asarray(params.inv_level_sigma_sq)[lvl]
    f32 = lambda a_: torch.as_tensor(np.asarray(a_, np.float32), device=dev)
    dargs = (f32(R_true @ np.array([[1, 0, 0], [0, np.cos(0.02), -np.sin(0.02)],
                                      [0, np.sin(0.02), np.cos(0.02)]])),
             f32(t_true + 0.03), f32(pos_w), f32(obs), f32(xr), f32(inv_sig),
             torch.as_tensor(rng.random(N) < 0.95, device=dev), cam)
    rk = pose_mod.optimize_pose(*dargs)
    rp = pose_mod.optimize_pose_plain(*dargs)
    torch.cuda.synchronize()
    err_d = max(float((rk.R_cw - rp.R_cw).abs().max()),
                float((rk.t_cw - rp.t_cw).abs().max()))
    agree = float((rk.is_inlier == rp.is_inlier).float().mean())
    print(f"kernel D pose_lm: N={N}, max |pose diff| {err_d:.3g}, inlier "
          f"agreement {agree:.5f}, pose error vs truth "
          f"{float(np.abs(rk.t_cw.cpu().numpy() - t_true).max()):.3g} m")
    assert err_d < 1e-4, "kernel D disagrees with its plain version"
    # 4 rounds x 11 evaluations + 5 classifications, ~150 flops per slot
    rows.append(dict(
        name="pose_lm", route="cuda",
        source="stella_vslam_tpu_torch/csrc/pose_lm.cu",
        replaces="stella_vslam_tpu/ops/optim/pose.py:39",
        max_abs_err=err_d,
        ms=_median_ms(lambda: pose_mod.optimize_pose(*dargs), reps=10),
        plain_ms=_median_ms(lambda: pose_mod.optimize_pose_plain(*dargs), reps=5,
                            warmup=1),
        library_ms=None, **_bound(N * 34.0, 49.0 * 150.0 * N)))
    return rows


def _two_view(dev, n, planar, seed):
    """n matches of a 752x480 camera pair with 30% outliers, 10% invalid."""
    import torch

    rng = np.random.default_rng(seed)
    fx, cx, cy = 458.0, 376.0, 240.0
    uv1 = np.stack([rng.uniform(10, 742, n), rng.uniform(10, 470, n)], -1)
    z = np.full(n, 4.0) if planar else rng.uniform(2.0, 8.0, n)
    X = np.stack([(uv1[:, 0] - cx) * z / fx, (uv1[:, 1] - cy) * z / fx, z], -1)
    Xc = X + np.array([0.3, 0.02, 0.05])
    uv2 = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    uv2 = uv2 + rng.normal(0, 0.7, uv2.shape)
    out = rng.random(n) < 0.3
    uv2[out] = np.stack([rng.uniform(0, 752, out.sum()), rng.uniform(0, 480, out.sum())], -1)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
    return f(uv1), f(uv2), torch.as_tensor(rng.random(n) < 0.9, device=dev)


def _ba_problem(dev, K, L, D, stereo, seed):
    """A BA problem: K cameras 0.4 m apart, L points 2.5-4.5 m away, D
    observers each, 0.5 px noise, 5% gross outliers, camera 0 fixed."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    rng = np.random.default_rng(seed)
    fx, cx, cy, fxb = 458.0, 376.0, 240.0, float(np.float32(458.0 * 0.12))
    t = np.stack([[-0.4 * k, 0.04 * k, 0.0] for k in range(K)])
    X = np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1, 1, L),
                  rng.uniform(2.5, 4.5, L)], -1)
    oc = np.stack([rng.permutation(K)[:D] for _ in range(L)]).astype(np.int32)
    Xc = X[:, None, :] + t[oc]
    uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fx * Xc[..., 1] / Xc[..., 2] + cy], -1)
    xr = np.where(rng.random((L, D)) < (0.5 if stereo else 0.0),
                  uv[..., 0] - fxb / Xc[..., 2], -1.0)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.random((L, D)) < 0.05
    uv[out] += 25.0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=dev)
    cam_t = t + np.concatenate([[[0, 0, 0]], rng.normal(0, 0.01, (K - 1, 3))])
    prob = ba.BAProblem(
        cam_R=f(np.tile(np.eye(3), (K, 1, 1))), cam_t=f(cam_t),
        cam_fixed=b(np.arange(K) == 0), cam_valid=b(np.ones(K)),
        lm_pos=f(X + rng.normal(0, 0.01, X.shape)), lm_valid=b(np.ones(L)),
        obs_cam=torch.as_tensor(oc, device=dev), obs_uv=f(uv), obs_x_right=f(xr),
        obs_inv_sigma_sq=f(np.ones((L, D))), obs_valid=b(rng.random((L, D)) < 0.95))
    from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

    return prob, CamScalars(fx, fx, cx, cy, 752.0, 480.0, fxb)


def _f_route_readings(dev, seeds, B: int = 1024):
    """Where kernel E's F hypotheses part from the plain version. Plain
    projects each null vector to rank 2 by a float32 SVD, the kernel by a
    float64 Jacobi SVD; "plain64" projects plain's null vector in float64,
    the kernel's route for that step. Per seed (a new match set and sample
    seed each), the shares of the B hypotheses with equal inlier counts:
    kernel vs plain, kernel vs plain64, plain vs plain64; and the distance
    of the kernel's rank-2 matrix from plain64's, back in normalized
    coordinates (unit Frobenius norm, up to sign; median and 99th
    percentile). A distance near 0 means the kernel's null vector equals
    plain's up to its smallest singular component."""
    import torch

    from stella_vslam_tpu_torch.ops.solve import fundamental as Fm
    from stella_vslam_tpu_torch.ops.solve import ransac as R

    out = []
    for s in seeds:
        p1, p2, v = _two_view(dev, 2872, False, s)
        Mk, _, nk = R.minimal_hypotheses(Fm.MODEL, s, p1, p2, v, B)
        _, _, npl = R.minimal_hypotheses_plain(Fm.MODEL, s, p1, p2, v, B, 1.0)
        idx = R.sample_minimal_sets(s, v, B, 8)
        Fn, T1, T2 = Fm.null_vector_F(p1[idx], p2[idx])
        T1, T2 = T1.double(), T2.double()
        U, S, Vt = torch.linalg.svd(Fn.double())
        S[..., 2] = 0.0
        Fn64 = U @ (S[..., :, None] * Vt)
        inl, _ = Fm._epipolar_cost((T2.transpose(-1, -2) @ Fn64 @ T1).float(),
                                   p1[None], p2[None], 1.0)
        n64 = (inl & v[None]).sum(-1).to(torch.int32)
        Fnk = torch.linalg.inv(T2.transpose(-1, -2)) @ Mk.double() @ torch.linalg.inv(T1)
        unit = lambda m: m / m.flatten(1).norm(dim=1)[:, None, None]
        a, b = unit(Fnk), unit(Fn64)
        dist = torch.minimum((a - b).flatten(1).norm(dim=1), (a + b).flatten(1).norm(dim=1))
        same = lambda x, y: float((x == y).float().mean())
        gap = (nk - npl).abs()
        out.append(dict(seed=s, kernel_vs_plain=same(nk, npl), kernel_vs_plain64=same(nk, n64),
                        plain_vs_plain64=same(npl, n64), dist_p50=float(dist.median()),
                        dist_p99=float(torch.quantile(dist.float(), 0.99)),
                        count_diff_max=int(gap.max()),
                        count_diff_mean_where_differ=float(gap[gap > 0].float().mean())
                        if bool((gap > 0).any()) else 0.0))
    return out


def check_init_kernels(dev, world):
    """C's angle gate, E and F-I against their plain versions at the mono
    slice's shapes; returns rows E, F, G, H, I."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import area
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.ops.solve import fundamental as Fm
    from stella_vslam_tpu_torch.ops.solve import homography as Hm
    from stella_vslam_tpu_torch.ops.solve import ransac as R
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    rows = []
    # ---- C, angle-gate mode: the area matcher between two bench frames ----
    ex = ox.OrbExtractor(OrbParams(num_levels=8), 752, 480, min_area=800, device=dev)
    f1 = ex.extract(torch.from_numpy(world.render(pose_at_xy(0.0, 0.0))).to(dev))
    f2 = ex.extract(torch.from_numpy(world.render(pose_at_xy(0.09, 0.0))).to(dev))
    N = ex.num_slots
    ori = H.AngleGate(f1.angle.contiguous(), f2.angle.contiguous(), area.ANGLE_THR)
    ok1 = f1.valid & (f1.level == 0)
    gate = dict(orient=ori)
    k = H.hamming_top2(f1.desc, f2.desc, ok1, f2.valid, **gate)
    p = H.hamming_top2_plain(f1.desc, f2.desc, ok1, f2.valid, **gate)
    differ = torch.zeros(N, dtype=torch.bool, device=dev)
    for u, v in zip(k, p):
        differ |= u != v
    share = float(differ.float().mean())
    idx_k, acc_k, _ = area.match_in_consistent_area(
        f1.level, f1.desc, f1.angle, f1.valid, f1.xy, f2.xy, f2.level, f2.desc,
        f2.angle, f2.valid)
    torch.cuda.synchronize()
    print(f"kernel C angle gate: {N}x{N}, rows differing from plain {share:.6f}; "
          f"area matcher accepted {int(acc_k.sum())} matches")
    assert share <= 1e-3, "kernel C's angle gate disagrees with its plain version"

    # ---- E: H and F RANSAC, 1024 hypotheses x N matches ----
    B = 1024
    pl = _two_view(dev, N, True, 1)
    gen = _two_view(dev, N, False, 2)
    res = {}
    for name, mod, data in (("H", Hm, pl), ("F", Fm, gen)):
        rk = R.find_core(mod.MODEL, 7 + len(name), *data, B, 1.0, 0)
        rp = R.find_core_plain(mod.MODEL, 7 + len(name), *data, B, 1.0, 0)
        n_k, n_plain = int(rk.num_inliers), int(rp.num_inliers)
        res[name] = (n_k, n_plain, abs(float(rk.cost) - float(rp.cost)))
        print(f"kernel E {name}: best inlier count {n_k} (plain {n_plain}), "
              f"cost {float(rk.cost):.6g} (plain {float(rp.cost):.6g})")
        assert bool(rk.valid) and bool(rp.valid) and n_k == n_plain, \
            f"kernel E {name} disagrees with its plain version"
    seeds = list(range(100, 108))
    for name, mod, data in (("H", Hm, pl), ("F", Fm, gen)):
        esc = mod.find_via_ransac_escalated(seeds, *data)
        ref = R.escalate(lambda s: R.find_core_plain(mod.MODEL, s, *data, 4096, 1.0, 3),
                         seeds)
        print(f"kernel E {name} escalated 8x4096 + 3 LO: {int(esc.num_inliers)} "
              f"inliers (plain {int(ref.num_inliers)})")
        assert bool(esc.valid) and abs(int(esc.num_inliers) - int(ref.num_inliers)) \
            <= 0.01 * int(ref.num_inliers), f"escalated {name} disagrees"
    for r in _f_route_readings(dev, (2, 3, 4, 5)):
        print("kernel E F route: " + json.dumps(r))

    def run_e(core):
        for mod, data in ((Hm, pl), (Fm, gen)):
            core(mod.MODEL, data)
    kern = lambda m, d: R.find_core(m, 11, *d, B, 1.0, 0)
    plain = lambda m, d: R.find_core_plain(m, 11, *d, B, 1.0, 0)
    # per attempt: hash B*k*N (~10 integer ops each), score B*N (~40 flops),
    # 18 squarings of 9x9 and A^T A per hypothesis, for H (k=4) and F (k=8)
    e_ops = sum(B * k_ * N * 10.0 + B * N * 40.0 + B * (18 * 729 * 2 + 2 * k_ * 81 * 2)
                for k_ in (4, 8))
    rows.append(dict(
        name="ransac_two_view", route="cuda",
        source="stella_vslam_tpu_torch/csrc/ransac_two_view.cu",
        replaces="stella_vslam_tpu/ops/solve/homography.py:107",
        max_abs_err=max(v[2] for v in res.values()),
        ms=_median_ms(lambda: run_e(kern), reps=10),
        plain_ms=_median_ms(lambda: run_e(plain), reps=5, warmup=1),
        library_ms=None, **_bound(2 * (N * 17.0 + B * 44.0), e_ops)))

    # ---- F, G, H: bundle adjustment ----
    errs = []
    for K, L, D, stereo in ((2, 4096, 2, False), (8, 4096, 4, True)):
        prob, cam = _ba_problem(dev, K, L, D, stereo, K)
        rk = ba.bundle_adjust(prob, cam)
        rp = ba.bundle_adjust_plain(prob, cam)
        torch.cuda.synchronize()
        e_pose = max(float((rk.cam_R - rp.cam_R).abs().max()),
                     float((rk.cam_t - rp.cam_t).abs().max()))
        same = bool(torch.equal(rk.obs_is_outlier, rp.obs_is_outlier))
        good = (prob.obs_valid & ~rp.obs_is_outlier).sum(1) >= 2
        e_pts = float((rk.lm_pos - rp.lm_pos)[good].abs().max())
        print(f"kernels F-I bundle_adjust K={K} L={L} D={D}{' stereo' if stereo else ''}: "
              f"max |pose diff| {e_pose:.3g}, points seen twice {e_pts:.3g}, "
              f"outlier flags identical {same}, cost {float(rk.cost):.6g} "
              f"(plain {float(rp.cost):.6g})")
        assert e_pose < 1e-4 and e_pts < 1e-3 and same, \
            "kernels F-I disagree with the plain BA"
        errs.append(e_pose)
    rows += _time_ba_kernels(dev, max(errs))
    return rows


def _time_ba_kernels(dev, err):
    """One LM iteration of the init-sized BA (K=2, L=4096, D=2), kernel by
    kernel, against the plain version of each, and one classification;
    rows F, G, H, I."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    K, L, D = 2, 4096, 2
    prob, cam = _ba_problem(dev, K, L, D, False, 2)
    inl = torch.ones((L, D), dtype=torch.uint8, device=dev)
    st = ba._KernelState(prob, cam)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    times = {"F": [], "G": [], "H": [], "I": []}
    for rep in range(23):
        st.ctrl.zero_()
        st.ctrl[ba._LAM] = 1e-4
        st.hc.zero_(); st.S.zero_(); st.rhs.zero_()
        e = [ev() for _ in range(5)]
        e[0].record()
        ba.ba_linearize_schur(st, inl, True)
        e[1].record()
        ba.ba_reduced_solve(st)
        e[2].record()
        ba.ba_backsub_cost(st, inl, True)
        e[3].record()
        ba.ba_classify(st, True)
        e[4].record()
        e[4].synchronize()
        if rep >= 3:
            for j, name in enumerate("FGHI"):
                times[name].append(e[j].elapsed_time(e[j + 1]))
    lam = torch.tensor(1e-4, device=dev)
    inlb = torch.ones((L, D), dtype=torch.bool, device=dev)
    R0, t0, p0 = prob.cam_R, prob.cam_t, prob.lm_pos
    lin = lambda: ba.linearize_schur_plain(prob, cam, R0, t0, p0, inlb, lam, True)
    cost0, Hcc, b_c, S_red, rhs_red, terms = lin()
    solve = lambda: ba.reduced_solve_plain(prob, R0, t0, Hcc, b_c, S_red, rhs_red, lam)
    dx, Rn, tn = solve()
    back = lambda: ba.backsub_cost_plain(prob, cam, p0, terms, dx, Rn, tn, inlb, True)
    classify = lambda: ba.classify_plain(prob, cam, R0, t0, p0, True)
    # the damped reduced system, for the one-call library solve
    tr = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hd = Hcc + (1e-4 * torch.clamp(tr / 6, min=1e-6) + 1e-7)[:, None, None] \
        * torch.eye(6, device=dev)
    free6 = ba._free(prob).repeat_interleave(6)
    S = (-S_red + torch.block_diag(*Hd)) * free6[:, None] * free6[None, :] \
        + torch.diag(1.0 - free6)
    rhs = (b_c.reshape(-1) - rhs_red) * free6
    n = 6 * K
    # operations per observation: Jacobians ~60, Hcc + b_c 27x6, Hpp + b_p
    # 9x6, W 18x6; per landmark: its inverse ~40, D x (W G 108 + W G b 36),
    # D^2 Schur blocks x 216. H: D x 108 back-substitution + D x ~60 for the
    # trial residuals. G: n^3/3 + 2 n^2.
    obs_bytes = L * D * 22.0
    rows = []
    for name, fn, plain_fn, lib, nbytes, ops, replaces in (
            ("ba_linearize_schur", "F", lin, None,
             obs_bytes + L * 12 + L * D * 72 + L * 40 + n * n * 4,
             L * D * (60 + 162 + 54 + 108 + 144) + L * (40 + D * D * 216),
             "stella_vslam_tpu/ops/optim/ba.py:416"),
            ("ba_reduced_solve", "G", solve, lambda: torch.linalg.solve(S, rhs),
             n * n * 4.0 + K * 27 * 4 + n * 4 + K * 48, n ** 3 / 3.0 + 2 * n * n,
             "stella_vslam_tpu/ops/optim/ba.py:610"),
            ("ba_backsub_cost", "H", back, None,
             obs_bytes + L * D * 72 + L * 40 + L * 24,
             L * D * (108 + 60) + L * 30, "stella_vslam_tpu/ops/optim/ba.py:731"),
            # I: per observation the projection and chi-square, ~30 flops
            ("ba_classify", "I", classify, None, obs_bytes + L * 12 + L * D,
             L * D * 30.0, "stella_vslam_tpu/ops/optim/ba.py:786")):
        rows.append(dict(
            name=name, route="cuda", source="stella_vslam_tpu_torch/csrc/ba_schur.cu",
            replaces=replaces, max_abs_err=err, ms=float(np.median(times[fn])),
            plain_ms=_median_ms(plain_fn, reps=10),
            library_ms=_median_ms(lib) if lib else None, **_bound(nbytes, ops)))
    return rows


def run_slices(dev, world, wrappers, card):
    """The RGBD slice and the mono slice, each with every launch count at 0
    just before it and read just after it."""
    from stella_vslam_tpu_torch.util import mono_slice, rgbd_slice

    launches = {}
    for w in wrappers.values():
        w.launches = 0
    stats = rgbd_slice.run_slice(dev, world, n_frames=120, step=0.015)
    launches["rgbd"] = {k: w.launches for k, w in wrappers.items()}
    print("rgbd slice: " + json.dumps(dict(stats, card=card)))
    print("rgbd slice launches: " + json.dumps(launches["rgbd"]))
    assert stats["tracked"] > 0 and stats["landmarks"] > 0
    assert stats["lost_after_init"] <= 2, f"{stats['lost_after_init']} frames lost"
    assert stats["ate_m"] < 0.10, f"rigid ATE {stats['ate_m']:.4f} m"
    assert stats["scale_err"] < 0.05, f"scale error {stats['scale_err']:.2%}"
    for name in ("fast_nms", "orb_describe", "hamming_top2", "pose_lm"):
        assert launches["rgbd"][name] > 0, f"{name} was not launched by the RGBD slice"

    for w in wrappers.values():
        w.launches = 0
    mono = mono_slice.run_slice(dev, world, n_frames=120, step=0.015)
    launches["mono"] = {k: w.launches for k, w in wrappers.items()}
    print("mono slice: " + json.dumps(dict(mono, card=card)))
    print("mono slice launches: " + json.dumps(launches["mono"]))
    assert mono["init_frame"] <= 10, f"initialized at frame {mono['init_frame']}"
    assert mono["lost_after_init"] <= 2, f"{mono['lost_after_init']} frames lost"
    assert mono["ate_m"] < 0.10, f"Sim3 ATE {mono['ate_m']:.4f} m"
    for name, n in launches["mono"].items():
        assert n > 0, f"{name} was not launched by the mono slice"
    return stats, mono, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "main path runs on the GPU only", file=sys.stderr)
        return 1
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.kernels import build as kbuild
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.ops.optim import pose as pose_mod
    from stella_vslam_tpu_torch.ops.solve import ransac
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    kbuild.load()
    print(f"build: {time.monotonic() - t0:.2f} s (nvcc {kbuild.build_seconds:.2f} s, "
          f"one process per source) [{card}]")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(kbuild.build_log)
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    world = bench_world()
    rows = check_kernels(dev, world) + check_init_kernels(dev, world)
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}) "
              f"[{card}]")

    wrappers = {"fast_nms": ox.fast_nms, "orb_describe": ox.orb_describe,
                "hamming_top2": H.hamming_top2, "pose_lm": pose_mod.optimize_pose,
                "ransac_two_view": ransac.minimal_hypotheses,
                "ba_linearize_schur": ba.ba_linearize_schur,
                "ba_reduced_solve": ba.ba_reduced_solve,
                "ba_backsub_cost": ba.ba_backsub_cost,
                "ba_classify": ba.ba_classify}
    _, _, launches = run_slices(dev, world, wrappers, card)
    for row in rows:
        row["launches"] = launches["mono"][row["name"]]
        row["launches_rgbd_slice"] = launches["rgbd"][row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
