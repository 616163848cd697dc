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
     frame's time by phase;
  7. the map slice: System in monocular mode with mapping enabled and
     inline, 500 frames of the same world (the bench's whole outbound leg,
     x from 0 to 7.49 m; the first 500 frames of phase 9's run, read before
     the drift is injected): at most 2 frames lost after init, Sim3 ATE
     < 0.10 m, at least 12 local BAs and 5 keyframes kept at the end, kernels
     A-L launched; frame and keyframe-event times by phase
     (util/map_slice.py);
  8. the mapping kernels on the map slice's own inputs: J (epipolar top-2)
     and K (DLT and checks) on its triangulation with the most neighbours,
     L (fuse) on its fuse chunk with the most landmarks, against their plain
     versions (rows or flags differing <= 1e-3, K's positions within 1e-4
     relative where both are ok); F-I at the local-BA shape (K=16, L=4096,
     D=12, 3 + 6 iterations, the local BA's layout of observers) against
     the plain BA with phase 4's bounds, and on every local problem of the
     slice kernel by kernel on the kernels' own state (_lockstep_ba): F's
     camera blocks, reduced system and cost no farther from plain F in
     float64 than 10x plain F's own float32 error plus 1e-4 (each entry
     relative to the sum of its terms' absolute values), G's step with a
     backward error below 1e-3 in float64 (n^2 eps for the 96 x 96 system)
     and its trial poses within 1e-5, H's trial cost within 1e-4 relative
     and each trial point within 1e-3 or, where larger, 1e-4 rad of its ray
     sensitivity (depth^2 / baseline) of H in float64 on the same step
     (plain H's own distance printed), the same accept / stop decisions
     and outlier flags wherever the deciding quantity lies more than 1e-5
     from its threshold; the whole BA of each, kernel against plain and
     each against itself, is printed; times and bounds as in phase 4.
  9. the loop slice (phase 7 is its first 500 frames, read at frame 500):
     the bench's whole 1290-frame circuit with mapping and the loop detector
     enabled and the bench's drift injected after the outbound leg
     (util/loop_slice.py): at least one loop closed, Sim3 ATE over all
     frames < 0.10 m, at most 8 frames lost after init, at least 25 keyframes
     created and 10 kept, a loop edge in the graph, the frame after each
     correction tracked, kernels A-P launched; the loop event's time by phase;
 10. the loop kernels against their plain versions, on synthetic inputs at
     the slice's shapes and on the inputs the loop slice recorded: M (BoW
     descent, 2872 descriptors) equal leaf ids; N (PnP RANSAC, 256 sets x 8
     starts x 2872) hypothesis by hypothesis (ok flags and inlier counts
     equal and (R, t) within 1e-4 on at least 99% of the hypotheses, costs
     within 1e-4 relative), the same winner with the same inlier set and a
     pose within 1e-5; C's keyframe-match call (2872 x 2872, margins 10 and
     3) exact; O (Sim3 refinement) s, R, t within 1e-4 and inlier flags
     differing on at most 1e-3 of the pairs; P (pose graph) per iteration on
     the kernel's own state: the system within 1e-4 and the right-hand side
     within 1e-3 of the largest entry, the update within 1e-5, and the whole 20 iterations
     within 1e-3; F-I at the global shape (K = 32 and K = 64, L = 4096,
     D = 16, and K = 128, L = 1024, D = 16; one Huber stage of 16) and on
     the slice's global BA problems kernel by kernel (_lockstep_ba, G's
     backward error below 1e-3 as at the local shape, H's trial cost within
     1e-3); times and bounds (K = 32 and 64) as in phase 4,
     the library call of P's solve (torch.linalg.cholesky + cholesky_solve)
     and of G's (torch.linalg.solve).
 11. kernels Q (csrc/track_assoc.cu: the per-slot scatter, the landmark
     dedup, the chain rebase) and R (csrc/reproject.cu: the reprojection
     with the local-map gate, the undistortion) against their plain
     versions at the slice's shapes (run with phase 3): Q exact (poses of
     the rebase within 1e-6) on synthetic inputs with slot collisions, tied
     scores, repeated and absent ids; R's uv and x_right within 1e-5
     relative, its flags equal except within 1e-6 of a threshold (counted);
 12. the inline loop slice a second time in the same process on a fresh
     System: whether the frame poses are bit-identical to the first run's,
     both ATEs, and where each run's error sits (legs, frames whose
     reference keyframe was culled, their forward hops);
 13. kernels F-I and P twice on the same inputs (init, local and global
     shapes, the loop slice's global BA and pose graph): bit-identical;
 14. the threaded slice (util/threaded_slice.py): the default System —
     pipelined tracker, mapping and loop-closing threads on their own CUDA
     streams — over the bench's circuit fed as fast as the feed returns:
     at most 8 frames lost after init, a loop closed, Sim3 ATE < 0.10 m,
     local-BA skips at most 20% of the opportunities, at least 25 keyframes
     created and 10 kept, nothing left queued or pending at shutdown, no
     exception contained by a worker thread, every kernel A-R launched;
     frame time, keyframe and loop events by phase, rebases and drain
     fallbacks, the caller's waits, and the synchronising calls per steady
     dispatch (torch's sync debug mode on frames 300-340, by file:line);
     then kernel Q against plain on the slice's recorded inputs (a sample
     of the scatters and dedups, every rebase).
 15. kernel S (csrc/resize.cu: the pyramid resize), B's strip mode and
     kernel T (csrc/stereo_match.cu: the stereo matcher) against their plain
     versions at the stereo leg's shapes (run with phase 3): S against the
     two torch.matmul per level (cuBLAS) with max |diff| <= 1e-4, the pixels
     that differ, the pixels that differ from the CPU's matmul, and kernel
     A's cell keys that move (<= 0.5%); B's strips equal; T on synthetic
     inputs at 2872 x 2872 and on a rendered pair: matched flags equal
     except at a threshold (counted), x_right and depth within 1e-5
     relative; kernel O in its fixed-scale mode against plain;
 16. bench.py's stereo leg and its RGBD leg with mapping (util/
     stereo_slice.py): the default threaded System, 640 frames each (400
     out, 240 back on fresh rows), with the bench's gates (at most 8 frames
     lost after init, scale error < 5%, rigid ATE < 0.10 m), at least one
     keyframe event, nothing left at shutdown, no worker exception, the
     path's kernels launched; frame time, keyframe events by phase; then T
     against plain on every 20th call of the stereo leg.
Launch counts are set to 0 just before each slice and read just after it;
the kernels line's `launches` is the count on the path of the slice that
ported the kernel (the stereo leg for S, B's strip mode and T; the threaded
slice, which runs every earlier kernel, for the rest), with every slice's
count beside it.
The line before the last is {"kernels": [...]}, the one before it
"slices: {...}" with each slice's result in short; the last line is
{"ok": true, "device": {...}}. Long logs go to chiprun_out/.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

DESC_MISMATCH_BOUND = 5e-5  # tests/test_torch_orb.py DESC_BIT_MISMATCH_MAX
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# kernels J, K, L: the mapping module's, which the mono and RGBD slices
# (mapping disabled) never launch
MAPPING_KERNELS = ("epipolar_top2", "triangulate", "fuse")
# kernels M-P: the loop closer's (M runs with the mapper's keyframe events)
LOOP_KERNELS = ("bow_transform", "pnp_ransac", "sim3_transform", "pose_graph")
# the stereo path's own: B's strip mode and T (S runs on every path)
STEREO_KERNELS = ("orb_describe_strips", "stereo_match")
# the kernels line's rows whose launches are the stereo leg's
STEREO_PATH_ROWS = ("resize_level",) + STEREO_KERNELS


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
                       torch.sin(ang_k), cos_30deg())
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


def _ba_problem(dev, K, L, D, stereo, seed, spacing=0.4, ordered=False):
    """A BA problem: K cameras `spacing` m apart, L points 2.5-4.5 m away, D
    observers each, 0.5 px noise, 5% gross outliers, camera 0 fixed.
    `ordered`: the local BA's layout (runs of 64 landmarks share their
    observers in slot order, 10% of the slots padded and pointing at camera
    0), where whole warps of kernel F add into one camera block."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    rng = np.random.default_rng(seed)
    fx, cx, cy, fxb = 458.0, 376.0, 240.0, float(np.float32(458.0 * 0.12))
    t = np.stack([[-spacing * k, 0.1 * spacing * k, 0.0] for k in range(K)])
    X = np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1, 1, L),
                  rng.uniform(2.5, 4.5, L)], -1)
    oc = np.stack([rng.permutation(K)[:D] for _ in range(L)]).astype(np.int32)
    if ordered:
        oc = np.stack([(np.arange(D) + l // 64) % K for l in range(L)]).astype(np.int32)
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
    lm_pos = X + rng.normal(0, 0.01, X.shape)
    valid = rng.random((L, D)) < (0.9 if ordered else 0.95)
    if ordered:
        oc[~valid] = 0
    prob = ba.BAProblem(
        cam_R=f(np.tile(np.eye(3), (K, 1, 1))), cam_t=f(cam_t),
        cam_fixed=b(np.arange(K) == 0), cam_valid=b(np.ones(K)),
        lm_pos=f(lm_pos), lm_valid=b(np.ones(L)),
        obs_cam=torch.as_tensor(oc, device=dev), obs_uv=f(uv), obs_x_right=f(xr),
        obs_inv_sigma_sq=f(np.ones((L, D))), obs_valid=b(valid))
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
        errs.append(_compare_ba(prob, cam, f"K={K} L={L} D={D}"
                                f"{' stereo' if stereo else ''}"))
    prob, cam = _ba_problem(dev, 2, 4096, 2, False, 2)
    rows += _time_ba_kernels(dev, max(errs), prob, cam)
    return rows


def _ray_sensitivity(prob, res, inlier):
    """Per landmark, how far it moves along its rays per radian of pose
    difference: depth^2 / baseline, with the baseline the farthest pair of
    its inlier observers' camera centres and the depth to the nearest."""
    import torch

    C = -(res.cam_R.transpose(1, 2) @ res.cam_t[..., None])[..., 0]  # [K,3]
    Co = C[prob.obs_cam.long().clamp(min=0)]  # [L,D,3]
    pair = inlier[:, :, None] & inlier[:, None, :]
    base = torch.where(pair, torch.linalg.norm(Co[:, :, None] - Co[:, None], dim=-1),
                       torch.zeros((), device=Co.device)).amax((1, 2))
    depth = torch.where(inlier, torch.linalg.norm(res.lm_pos[:, None] - Co, dim=-1),
                        torch.full((), float("inf"), device=Co.device)).amin(1)
    return depth * depth / base


def _compare_ba(prob, cam, label, num_first=5, num_second=10):
    """bundle_adjust (kernels F-I) against bundle_adjust_plain; fails unless
    poses agree within 1e-4, points seen twice within 1e-3 and the outlier
    flags are identical. Returns the max pose difference."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    kw = dict(num_first=num_first, num_second=num_second)
    rk = ba.bundle_adjust(prob, cam, **kw)
    rp = ba.bundle_adjust_plain(prob, cam, **kw)
    torch.cuda.synchronize()
    e_pose = max(float((rk.cam_R - rp.cam_R).abs().max()),
                 float((rk.cam_t - rp.cam_t).abs().max()))
    same = bool(torch.equal(rk.obs_is_outlier, rp.obs_is_outlier))
    good = (prob.obs_valid & ~rp.obs_is_outlier).sum(1) >= 2
    e_pts = float((rk.lm_pos - rp.lm_pos).abs().amax(-1)[good].max()) if bool(good.any()) else 0.0
    n_flag = int((rk.obs_is_outlier != rp.obs_is_outlier).sum())
    print(f"kernels F-I bundle_adjust {label}: max |pose diff| {e_pose:.3g}, points "
          f"seen twice {e_pts:.3g}, outlier flags identical {same} ({n_flag} differ), cost "
          f"{float(rk.cost):.6g} (plain {float(rp.cost):.6g})")
    assert e_pose < 1e-4 and e_pts < 1e-3 and same, \
        f"kernels F-I disagree with the plain BA at {label}"
    return e_pose


def _f_scale(prob, cam, R, t, p, inlier, lam, use_huber):
    """Per entry of kernel F's outputs (Hcc, b_c, S_red, rhs_red), the sum of
    the absolute values of the terms it adds up. Float32 rounding of a sum
    is relative to that, not to the sum itself, which cancels near a
    minimum: the gradient b_c and rhs_red of a converged problem are far
    smaller than their terms."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    K = R.shape[0]
    oc = prob.obs_cam.long()
    r, Jc, Jp, depth_ok = ba._pose_rows(prob, R, t, p, cam)
    wr = ba._row_weights(prob, r, depth_ok, inlier, use_huber)[0].abs()[..., None]
    aJcw, aJpw, aJc, aJp, ar = (Jc.abs() * wr, Jp.abs() * wr, Jc.abs(), Jp.abs(), r.abs())
    _, (Hpp, _, _, _, _, _) = ba._linearize(prob, R, t, p, inlier, cam, use_huber)
    aW = torch.einsum("ldri,ldra->ldia", aJcw, aJp)
    aA = aW @ ba._sym3_inv(Hpp, lam).abs()[:, None]
    abp = torch.einsum("ldri,ldr->li", aJpw, ar)

    def scatter(index, terms, shape):
        out = torch.zeros(shape, dtype=R.dtype, device=R.device)
        return out.index_add_(0, index, terms.reshape((-1,) + tuple(shape[1:])))

    Hcc = scatter(oc.reshape(-1), torch.einsum("ldri,ldrj->ldij", aJcw, aJc), (K, 6, 6))
    b_c = scatter(oc.reshape(-1), torch.einsum("ldri,ldr->ldi", aJcw, ar), (K, 6))
    pair = (oc[:, :, None] * K + oc[:, None, :]).reshape(-1)
    S = scatter(pair, torch.einsum("ldia,leja->ldeij", aA, aW), (K * K, 6, 6))
    rhs = scatter(oc.reshape(-1), (aA @ abp[:, None, :, None])[..., 0], (K, 6))
    return Hcc, b_c, S.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K), \
        rhs.reshape(-1)


def _lockstep_ba(prob, cam, num_first, num_second):
    """Kernels F-I against their plain versions on the same inputs, kernel
    by kernel through bundle_adjust's schedule on the kernels' own state
    (poses, points, lambda, inliers). F: its camera blocks, reduced system
    and cost, and plain F's, each against plain F in float64, entry by entry
    relative to the sum of the absolute values of the entry's terms
    (_f_scale); "f_excess" is the kernel's error over 10x plain's plus 1e-4.
    Plain F's own error there lies far above float32 rounding (the result
    holds it): the float32 inverse of a point's 3x3 block is off by its
    condition number times the rounding, which a point seen from a short
    baseline raises to 1e7 at small damping. G on F's system: the backward error of its step against that
    system in float64 (the step itself differs from plain G's by the
    system's condition number times float32 rounding), and its trial poses
    against Exp(step) composed by plain G. H on G's step: its trial points
    against H in float64 on the same step (a point's float32 3x3 inverse
    carries the same condition-number error as F's, in plain H as in the
    kernel, so plain H is no closer to the truth: "point_share_plain" is
    its own distance), and its trial cost against plain H's. I against
    plain I. The accept /
    stop decisions and the outlier flags count where they differ although
    their deciding quantity lies more than 1e-5 (relative) from its
    threshold. Returns the worst of each over the iterations."""
    import torch

    from stella_vslam_tpu_torch.ops import lie
    from stella_vslam_tpu_torch.ops.optim import ba

    K = prob.cam_R.shape[0]
    st = ba._KernelState(prob, cam)
    prob64 = ba.BAProblem(*[v.double() if v is not None and v.is_floating_point() else v
                            for v in prob])
    parts = ("Hcc", "b_c", "S_red", "rhs_red", "cost")
    out = dict({f"f_{n}{w}": 0.0 for n in parts for w in ("", "_plain")}, f_excess=0.0,
               g_backward=0.0, g_backward_plain=0.0, g_pose=0.0, g_step_diff=0.0,
               point_share=0.0, point_share_plain=0.0, cost_rel=0.0, decisions=0, flags=0,
               iterations=0)
    state = lambda: (st.cam_R.reshape(K, 3, 3).clone(), st.cam_t.clone(), st.lm.clone())
    iu = torch.triu_indices(6, 6, device=prob.cam_R.device)
    worst = lambda key, v: out.__setitem__(key, max(out[key], float(v)))

    def backward_error(S, rhs, dx):
        x = dx.double().reshape(-1)
        return float((S @ x + rhs).abs().max() / (S.abs().sum(1).max() * x.abs().max()
                                                  + rhs.abs().max()))

    def classify(final):
        R, t, p = state()
        fk = ba.ba_classify(st, final)
        fp = ba.classify_plain(prob, cam, R, t, p, final)
        _, chi2, _ = ba._total_cost(prob, R, t, p, torch.ones_like(prob.obs_valid), cam, False)
        thr = torch.where(prob.obs_x_right > 0, torch.full_like(chi2, ba.CHI_SQ_3D),
                          torch.full_like(chi2, ba.CHI_SQ_2D))
        near = (chi2 / thr - 1.0).abs() <= 1e-5
        out["flags"] += int(((fk != fp) & prob.obs_valid & ~near).sum())
        return fk

    def stage(inlier, use_huber, iters):
        st.ctrl[ba._LAM] = 1e-4
        st.ctrl[ba._DONE] = 0.0
        st.ctrl[ba._LAST_COST] = math.inf
        inl = inlier.to(torch.uint8).contiguous()
        seen = inlier & prob.obs_valid
        twice = (seen.sum(1) >= 2) & prob.lm_valid
        for _ in range(iters):
            if float(st.ctrl[ba._DONE]) != 0.0:
                break
            out["iterations"] += 1
            R, t, p = state()
            lam = st.ctrl[ba._LAM].clone()
            # F
            c0, Hcc, b_c, S_red, rhs_red, terms = ba.linearize_schur_plain(
                prob, cam, R, t, p, inlier, lam, use_huber)
            ba.ba_linearize_schur(st, inl, use_huber)
            hc = st.hc.clone()
            Hcc_k = torch.zeros_like(Hcc)
            Hcc_k[:, iu[0], iu[1]] = hc[:, :21]
            Hcc_k[:, iu[1], iu[0]] = hc[:, :21]
            b_c_k, S_k, rhs_k = hc[:, 21:], st.S.clone(), st.rhs.clone()
            c64, *f64, terms64 = ba.linearize_schur_plain(
                prob64, cam, R.double(), t.double(), p.double(), inlier, lam.double(), use_huber)
            scale = _f_scale(prob, cam, R, t, p, inlier, lam, use_huber) + (c0,)
            for name, u, v, e, m in zip(parts, (Hcc_k, b_c_k, S_k, rhs_k, st.ctrl[ba._COST0]),
                                        (Hcc, b_c, S_red, rhs_red, c0), f64 + [c64], scale):
                m = m.double().clamp(min=1e-30)
                ek = float(((u.double() - e).abs() / m).max())
                ep = float(((v.double() - e).abs() / m).max())
                worst(f"f_{name}", ek)
                worst(f"f_{name}_plain", ep)
                worst("f_excess", ek / (10.0 * ep + 1e-4))
            # G on F's system
            ba.ba_reduced_solve(st)
            dx_p, _, _ = ba.reduced_solve_plain(prob, R, t, Hcc_k, b_c_k, S_k, rhs_k, lam)
            S64, rhs64 = ba.damped_reduced_system(prob, Hcc_k.double(), b_c_k.double(),
                                                  S_k.double(), rhs_k.double(), lam.double())
            worst("g_backward", backward_error(S64, rhs64, st.dx))
            worst("g_backward_plain", backward_error(S64, rhs64, dx_p))
            worst("g_step_diff", (st.dx - dx_p).abs().max())
            Rn, tn = lie.se3_compose(*lie.se3_exp(st.dx.clone()), R, t)
            Rn_k, tn_k = st.cam_Rn.reshape(K, 3, 3).clone(), st.cam_tn.clone()
            worst("g_pose", max(float((Rn_k - Rn).abs().max()), float((tn_k - tn).abs().max())))
            # H on G's step
            pn, cost = ba.backsub_cost_plain(prob, cam, p, terms, st.dx.clone(), Rn_k, tn_k,
                                             inlier, use_huber)
            ba.ba_backsub_cost(st, inl, use_huber)
            if bool(twice.any()):
                pn64, _ = ba.backsub_cost_plain(prob64, cam, p.double(), terms64,
                                                st.dx.double(), Rn_k.double(), tn_k.double(),
                                                inlier, use_huber)
                trial = ba.BAResult(Rn_k, tn_k, pn, None, None)
                allow = torch.clamp(1e-4 * _ray_sensitivity(prob, trial, seen), min=1e-3)
                share = lambda q: ((q.double() - pn64).abs().amax(-1) / allow)[twice].max()
                worst("point_share", share(st.lmn))
                worst("point_share_plain", share(pn))
            c0, cost = float(c0), float(cost)
            worst("cost_rel", abs(float(st.ctrl[ba._LAST_COST]) - cost) / max(cost, 1e-12))
            # kernel H halves lambda on an accepted step and multiplies it by 4
            # on a rejected one (clamped to [1e-8, 1e4]; 6 rejections from 1e-4
            # stay below 1e4)
            imp_k = float(st.ctrl[ba._LAM]) <= float(lam)
            imp_p, gain = cost < c0, (c0 - cost) / max(c0, 1e-12)
            done_k, done_p = float(st.ctrl[ba._DONE]) != 0.0, imp_p and gain < 1e-3
            if imp_k != imp_p and abs(gain) > 1e-5:
                out["decisions"] += 1
            elif imp_k == imp_p and done_k != done_p and abs(gain - 1e-3) > 1e-5:
                out["decisions"] += 1

    stage(torch.ones_like(prob.obs_valid), True, num_first)
    inlier1 = classify(False)
    if num_second > 0:
        stage(inlier1, False, num_second)
    classify(True)
    return out


def _time_ba_kernels(dev, err, prob, cam, suffix=""):
    """One LM iteration of `prob`, kernel by kernel, against the plain
    version of each, and one classification; rows F, G, H, I (names with
    `suffix`)."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    K, L, D = prob.cam_R.shape[0], prob.obs_cam.shape[0], prob.obs_cam.shape[1]
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
    S, rhs = ba.damped_reduced_system(prob, Hcc, b_c, S_red, rhs_red, lam)
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
            name=name + suffix, route="cuda",
            source="stella_vslam_tpu_torch/csrc/ba_schur.cu", shape=f"K={K} L={L} D={D}",
            replaces=replaces, max_abs_err=err, ms=float(np.median(times[fn])),
            plain_ms=_median_ms(plain_fn, reps=10),
            library_ms=_median_ms(lib) if lib else None, **_bound(nbytes, ops)))
    return rows


def record_kernel_inputs(mapper):
    """Keep the arguments of every call of the mapper's triangulation and
    fusion entry points and of every bundle_adjust call, by reference only:
    no device work and no host read during the run. Returns (calls, undo)."""
    from stella_vslam_tpu_torch.ops.optim import ba

    calls = {"triangulate": [], "fuse": [], "bundle_adjust": [], "global_ba": []}
    kern = mapper.kernels
    triangulate, fuse, solve = kern.triangulate, kern.fuse, ba.bundle_adjust

    def tri_rec(*args):
        calls["triangulate"].append(args)
        return triangulate(*args)

    def fuse_rec(*args):
        calls["fuse"].append(args)
        return fuse(*args)

    def ba_rec(prob, *args, **kw):
        # the global BA is one Huber stage (num_second = 0)
        calls["global_ba" if kw.get("num_second", 1) == 0 else "bundle_adjust"].append(prob)
        return solve(prob, *args, **kw)

    kern.triangulate, kern.fuse, ba.bundle_adjust = tri_rec, fuse_rec, ba_rec

    def undo():
        del kern.triangulate, kern.fuse
        ba.bundle_adjust = solve

    return calls, undo


def largest_inputs(calls):
    """After the run: the triangulation with the most valid neighbours (then
    unassociated slots), the fuse chunk with the most valid keyframes (then
    landmarks) and every local BA problem (K >= 16; the init BA has K = 2),
    the one with the most landmarks first."""
    tri = max(calls["triangulate"], key=lambda a: (int(a[3].sum()), int(a[0].unassoc.sum())))
    fuse = max((a for a in calls["fuse"] if len(a) < 7 or a[6] == 3.0),
               key=lambda a: (int(a[2].sum()), int(a[5].sum())))[:6]
    local = sorted((p for p in calls["bundle_adjust"] if p.cam_R.shape[0] >= 16),
                   key=lambda p: -int(p.lm_valid.sum()))
    return tri, fuse, local


def check_mapping_kernels(dev, mapper, inputs):
    """Kernels J, K and L against their plain versions on the map slice's
    own inputs (the triangulation with the most neighbours, the fuse chunk
    with the most landmarks), and F-I at the local-BA shape: a K=16, L=4096,
    D=12 problem (checked and timed) and every local problem of the slice
    (kernel by kernel, _lockstep_ba). Returns rows J, K, L and F-I local."""
    import torch

    from stella_vslam_tpu_torch.match import fuse as fuse_match
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.match import robust
    from stella_vslam_tpu_torch.module import mapping_kernels as mk
    from stella_vslam_tpu_torch.ops.optim import ba

    rows = []
    kern = mapper.kernels
    (cur, nbrs, poses, pair_valid), fargs, local = inputs
    B, N2 = nbrs.desc.shape[0], nbrs.desc.shape[1]
    N1 = cur.desc.shape[0]

    # ---- J: epipolar-gated top-2, B neighbours x N1 x N2 ----
    E_12, epl2 = mk.epipolar_terms(poses)
    gate = robust.epipolar_gate(cur.angle, cur.level, cur.bear, cur.stereo, nbrs.angle,
                                nbrs.bear, nbrs.stereo, E_12, epl2,
                                scale_factors=kern.scale_factors)
    jargs = (cur.desc, nbrs.desc, cur.unassoc, nbrs.unassoc, gate)
    outk, outp = H.epipolar_top2(*jargs), H.epipolar_top2_plain(*jargs)
    differ = torch.zeros((B, N1), dtype=torch.bool, device=dev)
    for u, v in zip(outk, outp):
        differ |= u != v
    share_j = float(differ.float().mean())
    # this run's work: per (unassociated row, target) the target's flag;
    # per valid pair the orientation and epipole tests; per pair past them
    # the epipolar residual; per candidate XOR + popcount + add over 8 words
    # and the top-2 update. A row that is not unassociated needs no per-pair
    # work: its output is the constant (257, 0, 257, 0).
    n_rowpairs = n_valid = n_orient = n_cand = 0
    for b in range(B):
        n_rowpairs += int(cur.unassoc.sum()) * N2
        ok = cur.unassoc[:, None] & nbrs.unassoc[b][None, :]
        cosd = gate.row_c[:, None] * gate.col_c[b][None, :] \
            + gate.row_s[:, None] * gate.col_s[b][None, :]
        orient = ok & (cosd >= gate.cos_thr) & ~(gate.col_near[b][None, :]
                                                 & ~gate.row_stereo[:, None])
        n_valid += int(ok.sum())
        n_orient += int(orient.sum())
        n_cand += int(H.epipolar_gate_matrix(b, cur.unassoc, nbrs.unassoc, gate).sum())
    n_acc = int(robust.match_for_triangulation(
        cur.angle, cur.level, cur.desc, cur.bear, cur.unassoc, cur.stereo, nbrs.angle,
        nbrs.desc, nbrs.bear, nbrs.unassoc, nbrs.stereo, E_12, epl2,
        scale_factors=kern.scale_factors)[1].sum())
    torch.cuda.synchronize()
    print(f"kernel J epipolar_top2: {B}x{N1}x{N2}, {int(pair_valid.sum())} valid "
          f"neighbours, {int(cur.unassoc.sum())} unassociated rows, {n_valid} valid, "
          f"{n_orient} past orientation and epipole, {n_cand} candidate pairs, {n_acc} "
          f"accepted; rows differing from plain {share_j:.6f}")
    assert share_j <= 1e-3, "kernel J disagrees with its plain version"
    rows.append(dict(
        name="epipolar_top2", route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/robust.py:22", max_abs_err=share_j,
        ms=_median_ms(lambda: H.epipolar_top2(*jargs)),
        plain_ms=_median_ms(lambda: H.epipolar_top2_plain(*jargs), reps=5, warmup=1),
        library_ms=None,
        **_bound(N1 * (32 + 24 + 1) + B * N2 * (32 + 24 + 1) + B * N1 * 16,
                 1.0 * n_rowpairs + 5.0 * n_valid + 10.0 * n_orient + 30.0 * n_cand)))

    # ---- K: DLT and checks on kernel J's matches ----
    idx2, accepted, _ = robust.match_for_triangulation(
        cur.angle, cur.level, cur.desc, cur.bear, cur.unassoc, cur.stereo, nbrs.angle,
        nbrs.desc, nbrs.bear, nbrs.unassoc, nbrs.stereo, E_12, epl2,
        scale_factors=kern.scale_factors)
    kargs = (cur.uv, cur.level, cur.bear, nbrs.uv, nbrs.level, nbrs.bear, poses.contiguous(),
             idx2.contiguous(), accepted, pair_valid, kern.cam, kern.level_sigma_sq,
             kern.scale_factors)
    rk, rp = mk.triangulate_checks(*kargs), mk.triangulate_checks_plain(*kargs)
    torch.cuda.synchronize()
    share_k = float((rk.ok != rp.ok).float().mean())
    both = rk.ok & rp.ok
    rel = (torch.linalg.norm(rk.pos_w - rp.pos_w, dim=-1)
           / torch.clamp(torch.linalg.norm(rp.pos_w, dim=-1), min=1e-12))[both]
    rel_max = float(rel.max()) if rel.numel() else 0.0
    print(f"kernel K triangulate: {B}x{N1} slots, {int(accepted.sum())} matched, "
          f"{int(rk.ok.sum())} ok (plain {int(rp.ok.sum())}), ok flags differing "
          f"{share_k:.6f}, max relative position difference where both ok {rel_max:.3g}")
    assert share_k <= 1e-3 and rel_max < 1e-4, "kernel K disagrees with its plain version"
    # per slot: DLT rows and normalisation ~100, normal equations ~90, the
    # adjugate solve ~60, depth / parallax / reprojection / scale checks ~150
    rows.append(dict(
        name="triangulate", route="cuda", source="stella_vslam_tpu_torch/csrc/triangulate.cu",
        replaces="stella_vslam_tpu/module/mapping_kernels.py:58", max_abs_err=rel_max,
        ok_flags_differing=share_k,
        ms=_median_ms(lambda: mk.triangulate_checks(*kargs)),
        plain_ms=_median_ms(lambda: mk.triangulate_checks_plain(*kargs), reps=10),
        library_ms=None,
        **_bound(N1 * 24.0 + B * N2 * 24.0 + B * N1 * 5.0 + (B + 1) * 48.0
                 + B * N1 * 17.0, 400.0 * B * N1)))

    # ---- L: fuse reprojection and duplicate scan, one chunk ----
    kfs, kf_poses, batch_valid, lm_f, lm_desc, lm_valid = fargs
    largs = (kfs, kf_poses, batch_valid, lm_f, lm_desc, lm_valid, kern.cam,
             kern.scale_factors, kern.level_sigma_sq, kern.log_scale)
    Bf, N, M = kfs.uv.shape[0], kfs.uv.shape[1], lm_f.shape[0]
    lk, lp = mk.fuse_scan(*largs), mk.fuse_scan_plain(*largs)
    acc_k = mk.accept_fused(*lk, N)
    acc_p = mk.accept_fused(*lp, N)
    share_l = float((acc_k != acc_p).float().mean())
    scan_differ = float(((lk[0] != lp[0]) | (lk[1] != lp[1]) | (lk[2] != lp[2]))
                        .float().mean())
    # this run's work: the prologue per (keyframe, landmark); the window test
    # per gated pair; level, validity and chi-square per pair in the window;
    # the Hamming distance per candidate
    n_gated = n_window = n_cand_l = 0
    for b in range(Bf):
        if not bool(batch_valid[b]):
            continue
        R, t = kf_poses[b, :9].reshape(3, 3), kf_poses[b, 9:12]
        uv, xr, pred, g = mk.reproject_for_fuse(kern.cam, kern.log_scale,
                                                kern.scale_factors.shape[0], R, t,
                                                lm_f, lm_valid)
        win, cand = fuse_match.candidate_mask(
            kfs.uv[b], kfs.level[b], kfs.valid[b], kfs.x_right[b], uv[g], xr[g], pred[g],
            g[g], scale_factors=kern.scale_factors, level_sigma_sq=kern.level_sigma_sq)
        n_gated += int(g.sum())
        n_window += int(win.sum())
        n_cand_l += int(cand.sum())
    torch.cuda.synchronize()
    print(f"kernel L fuse: {int(batch_valid.sum())} keyframes x {int(lm_valid.sum())} "
          f"landmarks (chunk {Bf}x{M}, N={N}), {n_gated} gated, {n_window} pairs in "
          f"window, {n_cand_l} candidates, {int(acc_k.sum())} accepted (plain "
          f"{int(acc_p.sum())}); accepted flags differing {share_l:.6f}, scan outputs "
          f"differing {scan_differ:.6f}")
    assert share_l <= 1e-3, "kernel L disagrees with its plain version"
    rows.append(dict(
        name="fuse", route="cuda", source="stella_vslam_tpu_torch/csrc/fuse.cu",
        replaces="stella_vslam_tpu/module/mapping_kernels.py:228", max_abs_err=share_l,
        ms=_median_ms(lambda: mk.fuse_scan(*largs)),
        plain_ms=_median_ms(lambda: mk.fuse_scan_plain(*largs), reps=5, warmup=1),
        library_ms=None,
        **_bound(Bf * N * 49.0 + Bf * 49.0 + M * 65.0 + Bf * M * 12.0,
                 90.0 * Bf * M + 10.0 * n_gated * N + 12.0 * n_window + 24.0 * n_cand_l)))

    # ---- F-I at the local-BA shape ----
    prob, cam = _ba_problem(dev, 16, 4096, 12, False, 16, spacing=0.1, ordered=True)
    e_pose = _compare_ba(prob, cam, "K=16 L=4096 D=12", num_first=3, num_second=6)
    # Every local problem of the slice, kernel by kernel on the same inputs.
    # A whole BA of such a problem cannot be held to 1e-4: its reduced
    # system is ill-conditioned enough that the order of the atomic sums
    # alone (F's, and index_add_'s in the plain BA on the card) can move its
    # poses by more than 1e-4 between two runs of the plain BA (printed
    # below). So each kernel runs on the same inputs as its plain version:
    # F's system is held against float64, G's step by its backward error,
    # and H's trial points against H in float64 on G's step. A point seen from a short baseline is nearly free along its rays: it
    # moves depth^2 / baseline per radian of pose difference (160 m/rad at
    # 4 m over 0.1 m), so each trial point is held to 1e-3 or, where larger,
    # to 1e-4 rad (the poses' own bound) of that.
    worst = {}
    for p in local:
        for k, v in _lockstep_ba(p, mapper.cam_scalars, 3, 6).items():
            worst[k] = worst.get(k, 0) + v if isinstance(v, int) else max(worst.get(k, 0.0), v)
    print(f"kernels F-I kernel by kernel against plain on the map slice's {len(local)} local "
          f"problems (K={local[0].cam_R.shape[0]}, D={local[0].obs_cam.shape[1]}): "
          + json.dumps(worst))
    assert worst["f_excess"] < 1.0 and worst["g_backward"] < 1e-3 and worst["g_pose"] < 1e-5 \
        and worst["point_share"] < 1.0 and worst["cost_rel"] < 1e-4 \
        and worst["decisions"] == 0 and worst["flags"] == 0, \
        "kernels F-I disagree with the plain BA on the map slice's local problems"
    # the whole BA of each, beside each version's spread against itself
    spread = dict(kernel_vs_plain=0.0, plain_vs_plain=0.0, kernel_vs_kernel=0.0)
    for p in local:
        k1, k2, p1, p2 = (fn(p, mapper.cam_scalars, num_first=3, num_second=6)
                          for fn in (ba.bundle_adjust,) * 2 + (ba.bundle_adjust_plain,) * 2)
        for key, (u, v) in zip(spread, ((k1, p1), (p1, p2), (k1, k2))):
            spread[key] = max(spread[key], float((u.cam_R - v.cam_R).abs().max()),
                              float((u.cam_t - v.cam_t).abs().max()))
    print(f"kernels F-I whole BA on the map slice's {len(local)} local problems, max |pose "
          f"diff| (atomics sum in another order on every run): " + json.dumps(spread))
    rows += _time_ba_kernels(dev, e_pose, prob, cam, suffix="_local")
    rows[-4]["kernel_by_kernel_on_slice"] = worst
    rows[-4]["whole_ba_pose_spread_on_slice"] = spread
    return rows


def record_loop_inputs(slam):
    """Keep, by reference, the arguments of the loop closer's device calls:
    the BoW transform, PnP RANSAC, the keyframe rematch, the Sim3 refinement
    and the pose graph. Returns (calls, undo)."""
    from stella_vslam_tpu_torch.match import projection as proj
    from stella_vslam_tpu_torch.ops.optim import sim3
    from stella_vslam_tpu_torch.ops.solve import pnp

    calls = {"bow": [], "pnp": [], "kf_match": [], "transform": [], "pose_graph": []}
    vocab = slam.bow_vocab
    saved = (vocab.transform, pnp.find_via_ransac, proj.match_frame_and_keyframe,
             sim3.optimize_transform, sim3.optimize_pose_graph)

    def rec(key, fn):
        def wrapped(*args, **kw):
            calls[key].append((args, kw))
            return fn(*args, **kw)
        return wrapped

    vocab.transform = rec("bow", saved[0])
    pnp.find_via_ransac = rec("pnp", saved[1])
    proj.match_frame_and_keyframe = rec("kf_match", saved[2])
    sim3.optimize_transform = rec("transform", saved[3])
    sim3.optimize_pose_graph = rec("pose_graph", saved[4])

    def undo():
        del vocab.transform
        (pnp.find_via_ransac, proj.match_frame_and_keyframe, sim3.optimize_transform,
         sim3.optimize_pose_graph) = saved[1:]

    return calls, undo


def run_loop_slice(dev, world, wrappers, card):
    """The loop slice (mono, mapping and loop detector enabled, inline) over
    the bench's whole circuit, every launch count at 0 just before it and
    read just after it; its first 500 frames are the map slice. Returns
    (statistics, launches, mapper, the mapping kernels' largest inputs, the
    loop closer's recorded inputs)."""
    from stella_vslam_tpu_torch.util import loop_slice

    slam = loop_slice.make_system(world, dev)
    calls, undo = record_kernel_inputs(slam.mapper)
    loop_calls, undo_loop = record_loop_inputs(slam)
    for w in wrappers.values():
        w.launches = 0
    try:
        stats = loop_slice.run_slice(dev, world, slam=slam)
    finally:
        undo_loop()
        undo()
    launches = {k: w.launches for k, w in wrappers.items()}
    inputs = largest_inputs(calls)
    loop_calls["global_ba"] = calls["global_ba"]
    with open(os.path.join(OUT_DIR, "loop_slice.json"), "w") as f:
        json.dump(dict(stats, card=card), f, indent=1)
    ms = stats.pop("map_slice")
    print("map slice: " + json.dumps(dict(ms, card=card)))
    assert ms["lost_after_init"] <= 2, f"{ms['lost_after_init']} frames lost"
    assert ms["ate_m"] < 0.10, f"Sim3 ATE {ms['ate_m']:.4f} m"
    assert ms["local_bas"] >= 12, f"{ms['local_bas']} local BAs"
    assert ms["keyframes_kept"] >= 5, f"{ms['keyframes_kept']} keyframes kept"
    stats["map_slice_ate_m"] = ms["ate_m"]
    print("loop slice: " + json.dumps(dict(stats, card=card)))
    print("loop slice launches: " + json.dumps(launches))
    assert stats["loops_closed"] >= 1, "no loop was closed"
    assert stats["ate_m"] < 0.10, f"Sim3 ATE over the circuit {stats['ate_m']:.4f} m"
    assert stats["lost_after_init"] <= 8, f"{stats['lost_after_init']} frames lost"
    assert stats["keyframes_created"] >= 25, f"{stats['keyframes_created']} keyframes created"
    assert stats["keyframes_kept"] >= 10, f"{stats['keyframes_kept']} keyframes kept"
    assert stats["loop_edges"], "no loop edge in the graph"
    assert all(stats["frame_after_loop_tracked"]), "the frame after a correction was lost"
    for name, n in launches.items():
        assert n > 0 or name in THREADED_KERNELS + STEREO_KERNELS, \
            f"{name} was not launched by the loop slice"
    return stats, launches, slam, inputs, loop_calls


def rerun_loop_slice(dev, world, first, card):
    """The inline loop slice once more in the same process, on a fresh
    System: with every device sum in a fixed order the frame poses are the
    first run's, bit for bit. Prints both runs' ATEs and, for each, where
    the error sits (legs, frames whose reference keyframe was culled)."""
    from stella_vslam_tpu_torch.util import loop_slice, threaded_slice

    slam2 = loop_slice.make_system(world, dev)
    stats2 = loop_slice.run_slice(dev, world, slam=slam2)
    p1, p2 = first.frame_poses, slam2.frame_poses
    same = len(p1) == len(p2) and all(
        (a[1] is None and b[1] is None) or (a[1] is not None and b[1] is not None
                                            and np.array_equal(a[1], b[1]))
        for a, b in zip(p1, p2))
    first_diff = next((i for i, (a, b) in enumerate(zip(p1, p2))
                       if (a[1] is None) != (b[1] is None)
                       or (a[1] is not None and not np.array_equal(a[1], b[1]))), None)
    gt = loop_slice.circuit()
    diag = [threaded_slice.erased_forward_diagnostic(s, gt) for s in (first, slam2)]
    out = dict(poses_bit_identical=same, first_differing_frame=first_diff,
               ate_m=[None, stats2["ate_m"]], loops=[None, stats2["loops_closed"]],
               keyframes_kept=[first.map_db.num_keyframes(), stats2["keyframes_kept"]],
               ate_breakdown=diag, card=card)
    return out, stats2



def _pnp_problem(dev, n, seed):
    """n bearings of a 752x480 camera against points 2-8 m away under a
    known pose, 0.7 px noise, 30% outliers, 10% invalid, levels 0-7."""
    import torch

    rng = np.random.default_rng(seed)
    fx, cx, cy = 458.0, 376.0, 240.0
    uv = np.stack([rng.uniform(10, 742, n), rng.uniform(10, 470, n)], -1)
    z = rng.uniform(2.0, 8.0, n)
    Xc = np.stack([(uv[:, 0] - cx) * z / fx, (uv[:, 1] - cy) * z / fx, z], -1)
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.3, -0.1, 0.2])
    Xw = (Xc - t) @ R  # R^T (Xc - t)
    uv = uv + rng.normal(0, 0.7, uv.shape)
    out = rng.random(n) < 0.3
    uv[out] = np.stack([rng.uniform(0, 752, out.sum()), rng.uniform(0, 480, out.sum())], -1)
    b = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fx, np.ones(n)], -1)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev).contiguous()
    sf = f([1.2 ** i for i in range(8)])
    return (f(b), f(Xw), torch.as_tensor(rng.integers(0, 8, n).astype(np.int32), device=dev),
            torch.as_tensor(rng.random(n) < 0.9, device=dev)), sf


def _transform_problem(dev, n, seed):
    """A Sim3 refinement problem: n pairs, 0.5 px noise, 10% gross outliers,
    5% invalid, from a perturbed start."""
    import torch

    from stella_vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    fx, cx, cy = 458.0, 376.0, 240.0
    pts2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev).contiguous()
    s, R, t = lie.sim3_exp(f([0.3, -0.1, 0.2, 0.05, -0.1, 0.08, 0.1]))
    pts1 = lie.sim3_apply(s[None], R, t, f(pts2)).cpu().numpy()
    proj = lambda p: np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy], -1)
    obs1 = proj(pts1) + rng.normal(0, 0.5, (n, 2))
    obs2 = proj(pts2) + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < 0.1
    obs1[out] += rng.uniform(15, 40, (int(out.sum()), 2))
    s0, R0, t0 = lie.sim3_compose(*lie.sim3_exp(f([0.05, 0.02, -0.04, 0.01, 0.02, -0.02, -0.05])),
                                  s, R, t)
    isig = f(1.0 / 1.2 ** (2 * rng.integers(0, 4, n)))
    return (s0, R0.contiguous(), t0.contiguous(), f(pts1), f(pts2), f(obs1), f(obs2), isig, isig,
            torch.as_tensor(rng.random(n) < 0.95, device=dev), fx, fx, cx, cy)


def _graph_problem(dev, K, Kp, Ep, seed):
    """A pose graph: K keyframes on a line with odometric drift and scale
    creep, odometry and skip edges measured at the estimates, one loop edge
    (first to last) measured at the truth; padded to (Kp, Ep)."""
    import torch

    from stella_vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev).contiguous()
    xi_gt = np.zeros((K, 7))
    xi_gt[:, 0] = -0.3 * np.arange(K)
    xi_gt[:, 4] = 0.01 * np.arange(K)
    xi_est = xi_gt + np.cumsum(rng.normal(0, 0.004, (K, 7)), 0)
    xi_est[0] = xi_gt[0]
    sg, Rg, tg = lie.sim3_exp(f(xi_gt))
    se, Re, te = lie.sim3_exp(f(xi_est))
    edges = [(k, k - 1) for k in range(1, K)] + [(k, k - 2) for k in range(2, K)]
    meas = lambda s, R, t, i, j: lie.sim3_compose(s[i], R[i], t[i],
                                                  *lie.sim3_inverse(s[j], R[j], t[j]))
    i = torch.as_tensor([e[0] for e in edges], device=dev)
    j = torch.as_tensor([e[1] for e in edges], device=dev)
    ms, mR, mt = meas(se, Re, te, i, j)
    ls, lR, lt = meas(sg, Rg, tg, torch.as_tensor([K - 1], device=dev),
                      torch.as_tensor([0], device=dev))
    ms, mR, mt = torch.cat([ms, ls]), torch.cat([mR, lR]), torch.cat([mt, lt])
    ei = torch.cat([i, torch.as_tensor([K - 1], device=dev)]).to(torch.int32)
    ej = torch.cat([j, torch.as_tensor([0], device=dev)]).to(torch.int32)
    E = ei.shape[0]
    eye = torch.eye(3, device=dev)

    def pad(a, n, fill):
        extra = fill.expand((n - a.shape[0],) + a.shape[1:]) if torch.is_tensor(fill) \
            else torch.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype, device=dev)
        return torch.cat([a, extra]).contiguous()

    ar = lambda n: torch.arange(n, device=dev)
    return (pad(se, Kp, 1.0), pad(Re, Kp, eye), pad(te, Kp, 0.0), (ar(Kp) == 0) | (ar(Kp) >= K),
            ar(Kp) < K, pad(ei, Ep, 0), pad(ej, Ep, 0), pad(ms, Ep, 1.0), pad(mR, Ep, eye),
            pad(mt, Ep, 0.0), ar(Ep) < E)


def _check_pnp(args, scale_factors, label, seed):
    """Kernel N against its plain version on one problem; returns the worst
    readings."""
    import torch

    from stella_vslam_tpu_torch.ops.solve import pnp

    bearings, pos_w, octaves, valid = args
    mc = pnp.max_cos_errors(scale_factors, octaves)
    Rk, tk, okk, ck, nk = pnp.pnp_hypotheses(seed, bearings, pos_w, mc, valid, 256)
    Rp, tp, okp, cp, npl = pnp.pnp_hypotheses_plain(seed, bearings, pos_w, mc, valid, 256)
    torch.cuda.synchronize()
    both = okk & okp
    d = torch.maximum((Rk - Rp).abs().flatten(1).amax(1), (tk - tp).abs().amax(1))
    close = float((d[both] <= 1e-4).float().mean()) if bool(both.any()) else 1.0
    same = float(((okk == okp) & (nk == npl)).float().mean())
    cost_rel = float(((ck - cp).abs() / cp.abs().clamp(min=1e-6)).max())
    rk = pnp.find_via_ransac(seed, bearings, pos_w, octaves, valid, scale_factors=scale_factors,
                             min_num_inliers=15)
    rp = pnp.find_via_ransac(seed, bearings, pos_w, octaves, valid, scale_factors=scale_factors,
                             min_num_inliers=15, hypotheses=pnp.pnp_hypotheses_plain)
    e_pose = max(float((rk.R_cw - rp.R_cw).abs().max()), float((rk.t_cw - rp.t_cw).abs().max()))
    inl_same = bool(torch.equal(rk.is_inlier, rp.is_inlier))
    print(f"kernel N pnp_ransac {label}: N={bearings.shape[0]} ({int(valid.sum())} valid), "
          f"{int(okk.sum())} of {okk.numel()} hypotheses ok (plain {int(okp.sum())}), ok flag and "
          f"count equal {same:.4f}, (R, t) within 1e-4 where both ok {close:.4f} (max "
          f"{float(d[both].max()) if bool(both.any()) else 0.0:.3g}), cost relative "
          f"{cost_rel:.3g}; winner: valid {bool(rk.valid)} / {bool(rp.valid)}, "
          f"{int(rk.num_inliers)} / {int(rp.num_inliers)} inliers, sets equal {inl_same}, "
          f"pose diff {e_pose:.3g}")
    assert same >= 0.99 and close >= 0.99 and cost_rel < 1e-4, \
        f"kernel N's hypotheses disagree with plain ({label})"
    assert bool(rk.valid) == bool(rp.valid) and inl_same and e_pose < 1e-5, \
        f"kernel N's winner disagrees with plain ({label})"
    return 1.0 - min(same, close)


def _check_transform(args, kw, label, tol=1e-4):
    import torch

    from stella_vslam_tpu_torch.ops.optim import sim3

    rk = sim3.optimize_transform(*args, **kw)
    rp = sim3.optimize_transform_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(abs(float(rk.s_12) - float(rp.s_12)), float((rk.R_12 - rp.R_12).abs().max()),
              float((rk.t_12 - rp.t_12).abs().max()))
    differ = float((rk.is_inlier != rp.is_inlier).float().mean())
    print(f"kernel O sim3_transform {label}: N={args[3].shape[0]}, s {float(rk.s_12):.6f} "
          f"(plain {float(rp.s_12):.6f}), max |s, R, t diff| {err:.3g}, inliers "
          f"{int(rk.num_inliers)} (plain {int(rp.num_inliers)}), flags differing {differ:.6f}")
    assert err < tol and differ <= 1e-3, f"kernel O disagrees with plain ({label})"
    return err


def _check_pose_graph(args, label, num_iter=20):
    """Kernel P against plain, iteration by iteration on the kernel's own
    state, then the whole optimization."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import sim3

    s, R, t = args[:3]
    g = sim3.PoseGraph(*args[3:])
    worst = dict(H=0.0, b=0.0, cost=0.0, update=0.0)
    for _ in range(num_iter):
        Hk, bk, ck = sim3.pose_graph_linearize(g, s, R, t)
        Hp, bp, cp = sim3.pose_graph_linearize_plain(g, s, R, t)
        worst["H"] = max(worst["H"], float((Hk - Hp).abs().max() / Hp.abs().max()))
        b_scale = bp.abs().max().clamp(min=1e-3 * float(Hp.abs().max()))
        worst["b"] = max(worst["b"], float((bk - bp).abs().max() / b_scale))
        worst["cost"] = max(worst["cost"], abs(float(ck) - float(cp)) / max(float(cp), 1e-12))
        x = sim3.cholesky_solve(Hk, bk)
        sk, Rk, tk = sim3.pose_graph_update(g, s, R, t, x)
        sp, Rp, tp = sim3.pose_graph_update_plain(g, s, R, t, x)
        worst["update"] = max(worst["update"], float((sk - sp).abs().max()),
                              float((Rk - Rp).abs().max()), float((tk - tp).abs().max()))
        s, R, t = sk, Rk, tk
    rk = sim3.optimize_pose_graph(*args, num_iter=num_iter)
    rp = sim3.optimize_pose_graph_plain(*args, num_iter=num_iter, solve=sim3.cholesky_solve)
    torch.cuda.synchronize()
    whole = max(float((a - b).abs().max()) for a, b in zip(rk, rp))
    print(f"kernel P pose_graph {label}: K={args[0].shape[0]} ({int(args[4].sum())} valid), "
          f"E={args[5].shape[0]} ({int(args[10].sum())} valid), per iteration against plain on "
          f"the same state: {json.dumps(worst)}; whole optimization max |diff| {whole:.3g}, "
          f"final squared residual {float(ck):.4g}")
    # (b is a sum that cancels near the minimum: it is held to 1e-3 of the
    # larger of its largest entry and 1e-3 of H's)
    assert worst["H"] < 1e-4 and worst["b"] < 1e-3 and worst["cost"] < 1e-4 \
        and worst["update"] < 1e-5 and whole < 1e-3, f"kernel P disagrees with plain ({label})"
    return max(worst["H"], worst["b"], worst["update"])


def check_loop_kernels(dev, slam, rec):
    """Kernels M, N, C's keyframe-match call, O and P against their plain
    versions on synthetic inputs at the slice's shapes and on the loop
    slice's recorded inputs; F-I at the global shape. Returns their rows."""
    import torch

    from stella_vslam_tpu_torch.data import bow_vocabulary as bow
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.match import projection as proj
    from stella_vslam_tpu_torch.ops.optim import ba, sim3
    from stella_vslam_tpu_torch.ops.solve import pnp

    rows = []
    rng = np.random.default_rng(40)
    N = 2872

    # ---- M: BoW tree descent ----
    packed = slam.bow_vocab.packed_centers()
    rand = torch.from_numpy(rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)
    descs = [("random", rand)] + [(f"keyframe {i}", a[0][0].contiguous())
                                  for i, a in enumerate(rec["bow"][:3])]
    differ_m = 0
    for label, d in descs:
        differ_m += int((bow.bow_transform(d, packed) != bow.bow_transform_plain(d, packed)).sum())
    torch.cuda.synchronize()
    print(f"kernel M bow_transform: {len(descs)} sets of {N} descriptors (random and the loop "
          f"slice's keyframes), leaf ids differing from plain: {differ_m}")
    assert differ_m == 0, "kernel M disagrees with its plain version"
    d_m = descs[-1][1]
    rows.append(dict(
        name="bow_transform", route="cuda",
        source="stella_vslam_tpu_torch/csrc/bow_transform.cu",
        replaces="stella_vslam_tpu/data/bow_vocabulary.py:76", max_abs_err=float(differ_m),
        ms=_median_ms(lambda: bow.bow_transform(d_m, packed)),
        plain_ms=_median_ms(lambda: bow.bow_transform_plain(d_m, packed), reps=10),
        library_ms=None,
        # per descriptor 4 levels x 10 children x 8 words of XOR, popcount, add
        **_bound(N * 36.0 + packed.numel() * 4.0, N * 40 * 24.0)))

    # ---- N: PnP RANSAC ----
    syn, sf = _pnp_problem(dev, N, 41)
    err_n = _check_pnp(syn, sf, "synthetic", 41)
    for i, (a, kw) in enumerate(rec["pnp"][:4]):
        err_n = max(err_n, _check_pnp(tuple(x.contiguous() for x in a[1:5]), kw["scale_factors"],
                                      f"loop slice call {i}", a[0]))
    pa, psf = (tuple(x.contiguous() for x in rec["pnp"][0][0][1:5]),
               rec["pnp"][0][1]["scale_factors"]) if rec["pnp"] else (syn, sf)
    mc = pnp.max_cos_errors(psf, pa[2])
    n_valid = int(pa[3].sum())
    rows.append(dict(
        name="pnp_ransac", route="cuda", source="stella_vslam_tpu_torch/csrc/pnp_ransac.cu",
        replaces="stella_vslam_tpu/ops/solve/pnp.py:187", max_abs_err=err_n,
        ms=_median_ms(lambda: pnp.pnp_hypotheses(7, pa[0], pa[1], mc, pa[3], 256)),
        plain_ms=_median_ms(lambda: pnp.pnp_hypotheses_plain(7, pa[0], pa[1], mc, pa[3], 256),
                            reps=5, warmup=1),
        library_ms=None,
        # the hash of 3 B N draws (~12 integer operations), 2048 Newton solves
        # (~24 x 60), and ~25 operations per (hypothesis, valid correspondence)
        **_bound(N * 29.0 + 2048 * 60.0,
                 256 * 3 * N * 12.0 + 2048 * 24 * 60.0 + 2048 * n_valid * 25.0)))

    # ---- C: the keyframe-match call (window mode, best only) ----
    def kf_match_inputs(margin):
        uv = torch.as_tensor(np.stack([rng.uniform(0, 752, N), rng.uniform(0, 480, N)], -1)
                             .astype(np.float32), device=dev)
        lvl = torch.as_tensor(rng.integers(0, 8, N).astype(np.int32), device=dev)
        perm = torch.as_tensor(rng.permutation(N), device=dev)
        flips = torch.as_tensor((rng.random((N, 8)) < 0.2) * (1 << rng.integers(0, 31, (N, 8))),
                                device=dev).to(torch.int32)
        ang = torch.as_tensor(rng.uniform(0, 6.28, N).astype(np.float32), device=dev)
        reproj = (uv[perm] + torch.as_tensor(rng.normal(0, 2.0, (N, 2)).astype(np.float32),
                                             device=dev)).contiguous()
        mask = lambda p: torch.as_tensor(rng.random(N) < p, device=dev)
        return ((uv, lvl, rand, mask(0.95), ang, mask(0.3), (rand[perm] ^ flips).contiguous(),
                 reproj, lvl[perm].contiguous(), (ang[perm] + 0.1).contiguous(), mask(0.8)),
                dict(scale_factors=sf, num_levels=8, margin=margin))

    cases = [("synthetic margin 10", *kf_match_inputs(10.0)),
             ("synthetic margin 3", *kf_match_inputs(3.0))]
    cases += [(f"loop slice call {i} margin {kw['margin']}", a, kw)
              for i, (a, kw) in enumerate(rec["kf_match"][:4])]
    differ_c = 0
    for label, a, kw in cases:
        a = tuple(x.contiguous() for x in a)
        ok, op = proj.match_frame_and_keyframe(*a, **kw), \
            proj.match_frame_and_keyframe(*a, **kw, top2=H.hamming_top2_plain)
        torch.cuda.synchronize()
        bad = int(((ok[0] != op[0]) | (ok[1] != op[1]) | (ok[2] != op[2])).sum())
        print(f"kernel C match_frame_and_keyframe {label}: {a[6].shape[0]} x {a[2].shape[0]}, "
              f"{int(ok[1].sum())} accepted (plain {int(op[1].sum())}), rows differing {bad}")
        differ_c += bad
    assert differ_c == 0, "kernel C's keyframe-match call disagrees with its plain version"
    label, ca, ckw = cases[-1]
    ca = tuple(x.contiguous() for x in ca)
    M_rows = ca[6].shape[0]
    # this run's work, as phase 3 counts kernel C's: the gates per valid
    # pair, XOR + popcount + add over 8 words per pair inside the window
    pred = ca[8].long()
    radc = ckw["margin"] * ckw["scale_factors"][pred]
    n_pairs = int(ca[10].sum()) * int((ca[3] & ~ca[5]).sum())
    win = ((ca[0][None, :, 0] - ca[7][:, None, 0]).abs() <= radc[:, None]) \
        & ((ca[0][None, :, 1] - ca[7][:, None, 1]).abs() <= radc[:, None])
    n_win = int((win & ca[10][:, None] & (ca[3] & ~ca[5])[None, :]).sum())
    rows.append(dict(
        name="hamming_top2_keyframe", counter="hamming_top2", route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/projection.py:160", max_abs_err=float(differ_c),
        shape=f"{M_rows}x{ca[2].shape[0]} {label}",
        ms=_median_ms(lambda: proj.match_frame_and_keyframe(*ca, **ckw)),
        plain_ms=_median_ms(lambda: proj.match_frame_and_keyframe(
            *ca, **ckw, top2=H.hamming_top2_plain), reps=5, warmup=1),
        library_ms=None,
        **_bound(M_rows * 57.0 + ca[2].shape[0] * 49.0 + M_rows * 16.0,
                 4.0 * n_pairs + 30.0 * n_win)))

    # ---- O: Sim3 refinement ----
    ta = _transform_problem(dev, N, 42)
    err_o = _check_transform(ta, {}, "synthetic")
    for i, (a, kw) in enumerate(rec["transform"][:4]):
        err_o = max(err_o, _check_transform(a, kw, f"loop slice call {i}"))
    oa, okw = rec["transform"][0] if rec["transform"] else (ta, {})
    n_o = oa[3].shape[0]
    rows.append(dict(
        name="sim3_transform", route="cuda",
        source="stella_vslam_tpu_torch/csrc/sim3_transform.cu",
        replaces="stella_vslam_tpu/ops/optim/sim3.py:56", max_abs_err=err_o, shape=f"N={n_o}",
        ms=_median_ms(lambda: sim3.optimize_transform(*oa, **okw)),
        plain_ms=_median_ms(lambda: sim3.optimize_transform_plain(*oa, **okw), reps=5, warmup=1),
        library_ms=None,
        # 10 steps x ~700 operations per pair (two projections, 4 Jacobian
        # rows of 7, 4 x 36 products, the trial and the inlier pass)
        **_bound(n_o * 57.0 + n_o + 52.0, 10 * 700.0 * n_o)))

    # ---- P: pose graph ----
    ga = _graph_problem(dev, 30, 32, 128, 43)
    err_p = _check_pose_graph(ga, "synthetic")
    for i, (a, kw) in enumerate(rec["pose_graph"][:2]):
        err_p = max(err_p, _check_pose_graph(a, f"loop slice call {i}"))
    pga = rec["pose_graph"][0][0] if rec["pose_graph"] else ga
    g = sim3.PoseGraph(*pga[3:])
    Kp, Ep, n_e = pga[0].shape[0], pga[5].shape[0], int(pga[10].sum())
    Hd, b, _ = sim3.pose_graph_linearize(g, *pga[:3])
    x = sim3.cholesky_solve(Hd, b)

    def step_kernel():
        sim3.pose_graph_linearize(g, *pga[:3])
        sim3.pose_graph_update(g, *pga[:3], x)

    def step_plain():
        sim3.pose_graph_linearize_plain(g, *pga[:3])
        sim3.pose_graph_update_plain(g, *pga[:3], x)

    n7 = 7 * Kp
    rows.append(dict(
        name="pose_graph", route="cuda", source="stella_vslam_tpu_torch/csrc/pose_graph.cu",
        replaces="stella_vslam_tpu/ops/optim/sim3.py:165", max_abs_err=err_p,
        shape=f"K={Kp} E={Ep} ({n_e} valid), one iteration without its solve",
        ms=_median_ms(step_kernel), plain_ms=_median_ms(step_plain, reps=5, warmup=1),
        library_ms=_median_ms(lambda: sim3.cholesky_solve(Hd, b)),
        library_call="torch.linalg.cholesky + cholesky_solve, the iteration's dense solve",
        # bytes: vertices and edges read once, the [7K,7K] system and its
        # right-hand side written once, the solve's x read and the vertices
        # written once by the update (the kernel's zero fill and gauge pass
        # over the system are its own traffic, not the function's). Operations:
        # per valid edge 15 passes of ~600 and 14 x 15 x 7 x 2 for its blocks,
        # one gauge select per entry of the system, the update per vertex
        **_bound(Kp * 52.0 + Ep * 61.0 + n7 * n7 * 4.0 + n7 * 4.0 + n7 * 4.0 + Kp * 52.0,
                 n_e * (15 * 600.0 + 2940.0) + 1.0 * n7 * n7 + Kp * 300.0)))

    # ---- F-I at the global shape ----
    cam = slam.mapper.cam_scalars
    probs = [("K=32 L=4096 D=16", *_ba_problem(dev, 32, 4096, 16, False, 44, spacing=0.1,
                                               ordered=True)),
             ("K=64 L=4096 D=16", *_ba_problem(dev, 64, 4096, 16, False, 45, spacing=0.1,
                                               ordered=True)),
             # G's device-memory route at 768 rows and F's direct atomics at
             # the largest K held here; fewer landmarks keep the plain side short
             ("K=128 L=1024 D=16", *_ba_problem(dev, 128, 1024, 16, False, 46, spacing=0.1,
                                                ordered=True))]
    probs += [(f"loop slice global BA {i} K={p.cam_R.shape[0]} L={p.obs_cam.shape[0]} "
               f"D={p.obs_cam.shape[1]}", p, cam) for i, p in enumerate(rec["global_ba"][:2])]
    e_pose = {}
    for label, p, c in probs:
        w = _lockstep_ba(p, c, 16, 0)
        rk = ba.bundle_adjust(p, c, num_first=16, num_second=0)
        rp = ba.bundle_adjust_plain(p, c, num_first=16, num_second=0)
        torch.cuda.synchronize()
        e_pose[label] = max(float((rk.cam_R - rp.cam_R).abs().max()),
                            float((rk.cam_t - rp.cam_t).abs().max()))
        print(f"kernels F-I global BA {label}: kernel by kernel against plain "
              f"{json.dumps(w)}; whole BA max |pose diff| {e_pose[label]:.3g}, cost "
              f"{float(rk.cost):.6g} (plain {float(rp.cost):.6g})")
        # H's trial cost is held to 1e-3 here: on the slice's problem, whose
        # observations across the loop sit on Huber's linear part, the trial
        # points' own differences (within their allowance) move it by 1.5e-4
        assert w["f_excess"] < 1.0 and w["g_backward"] < 1e-3 and w["g_pose"] < 1e-5 \
            and w["point_share"] < 1.0 and w["cost_rel"] < 1e-3 and w["decisions"] == 0 \
            and w["flags"] == 0, f"kernels F-I disagree with the plain BA at {label}"
    for (label, p, c), suffix in zip(probs[:2], ("_global32", "_global64")):
        rows += _time_ba_kernels(dev, e_pose[label], p, c, suffix=suffix)
    return rows


# kernel Q's chain rebase runs only in the pipelined tracker, when a table is
# published while frames are in flight: the inline slices never launch it
THREADED_KERNELS = ("rebase_chain",)


def _assoc_problem(dev, M, N, seed):
    """Matcher-like outputs at the slice's shapes: M sources, their best
    slots (a strided column, a third of them drawn from a third of the
    slots so that slots collide), 70% accepted, and table rows (positions
    in packed [M,8] rows, ids in column 8 of [M,10])."""
    import torch

    g = torch.Generator().manual_seed(seed)
    best = torch.randint(0, N, (M, 4), generator=g, dtype=torch.int32)
    best[: M // 3, 1] = torch.randint(0, max(1, N // 3), (M // 3,), generator=g,
                                      dtype=torch.int32)
    acc = torch.rand(M, generator=g) < 0.7
    tbl = torch.randn(M, 8, generator=g)
    ids = torch.randint(-1, 20000, (M, 10), generator=g, dtype=torch.int32)
    return best.to(dev), acc.to(dev), tbl.to(dev), ids.to(dev)


def _same(a, b) -> bool:
    """Equal outputs (tuples of tensors, None where absent)."""
    import torch

    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def _check_assoc_call(kind, args, pose_tol=1e-6):
    """One call of a kernel Q entry point against its plain version: ints
    and copies exact, the re-anchored poses within pose_tol. Returns the
    largest pose difference."""
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    fn, plain = {"scatter": (tk.scatter_to_current, tk.scatter_to_current_plain),
                 "dedup": (tk.dedup_by_id, tk.dedup_by_id_plain),
                 "rebase": (tk.rebase_chain, tk.rebase_chain_plain)}[kind]
    k, p = fn(*args), plain(*args)
    n_exact = 3 if kind == "rebase" else len(k)
    assert _same(k[:n_exact], p[:n_exact]), f"kernel Q {kind} disagrees with its plain version"
    err = 0.0
    for x, y in zip(k[n_exact:], p[n_exact:]):
        err = max(err, float((x - y).abs().max()))
    assert err <= pose_tol, f"kernel Q {kind}: poses {err:.3g} apart"
    return err


def _gate_near(p, R, t, tbl, tbl_u32, log_scale, eps=1e-6):
    """Rows of a table whose gate or level is decided by a quantity within
    eps (relative) of its threshold, in the plain version's float64 terms:
    there the kernel and the plain version may round to different sides."""
    import torch

    R, t, x = R.double(), t.double(), tbl.double()
    pc = x[:, 0:3] @ R.T + t
    z = pc[:, 2]
    u = p.fx * pc[:, 0] / z + p.cx
    v = p.fy * pc[:, 1] / z + p.cy
    ray = x[:, 0:3] + R.T @ t
    dist = torch.linalg.norm(ray, dim=-1)
    cosang = (ray * x[:, 3:6]).sum(-1) / dist
    lv = torch.log(x[:, 7] / dist) / log_scale
    near = lambda q, thr: (q - thr).abs() <= eps * max(1.0, abs(thr))
    return (near(u, 0.0) | near(u, p.width) | near(v, 0.0) | near(v, p.height) | near(z, 0.0)
            | near(dist / x[:, 6], 0.8) | near(dist / x[:, 7], 1.3) | near(cosang, 0.5)
            | ((lv - lv.round()).abs() <= eps))


def check_track_kernels(dev, world):
    """Kernels Q and R against their plain versions at the slice's shapes
    (N = 2872 slots, M = C = 4096 sources and table rows) on synthetic
    inputs with slot collisions, equal scores, repeated and absent ids;
    rows of the kernels line."""
    import torch

    from stella_vslam_tpu_torch.camera import base as cb
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    rows = []
    N, M, C = 2872, 4096, 4096
    src = "stella_vslam_tpu_torch/csrc/track_assoc.cu"
    # ---- Q: scatter (table sources) ----
    best, acc, tbl, ids = _assoc_problem(dev, M, N, 11)
    sargs = (best[:, 1], acc, tbl[:, 0:3], ids[:, 8], N)
    _check_assoc_call("scatter", sargs)
    held = int(tk.scatter_to_current(*sargs)[2].sum())
    print(f"kernel Q scatter_to_current: {M} sources -> {N} slots, {held} held, exact")
    rows.append(dict(
        name="scatter_to_current", route="cuda", source=src,
        replaces="stella_vslam_tpu/module/tracking_kernels.py:64", max_abs_err=0.0,
        shape=f"M={M} N={N}", ms=_median_ms(lambda: tk.scatter_to_current(*sargs)),
        plain_ms=_median_ms(lambda: tk.scatter_to_current_plain(*sargs)), library_ms=None,
        # read: index, accept flag, 3 floats and an id per source; write: 3
        # floats, an id and a flag per slot; one count and a compare each
        **_bound(M * (4 + 1 + 12 + 4) + N * (12 + 4 + 1), 4.0 * (M + N))))
    # ---- Q: dedup ----
    g = torch.Generator().manual_seed(12)
    has = (torch.rand(N, generator=g) < 0.8).to(dev)
    dids = torch.randint(0, N // 3, (N,), generator=g, dtype=torch.int32).to(dev)
    score = torch.randint(0, 8, (N,), generator=g).to(torch.float32).to(dev)
    dargs = (has, dids, torch.where(has, score, torch.full_like(score, float("inf"))))
    _check_assoc_call("dedup", dargs)
    kept = int(tk.dedup_by_id(*dargs)[0].sum())
    print(f"kernel Q dedup_by_id: {int(has.sum())} held slots over {N // 3} ids with tied "
          f"scores, {kept} kept, exact")
    rows.append(dict(
        name="dedup_by_id", route="cuda", source=src,
        replaces="stella_vslam_tpu/module/tracking_kernels.py:83", max_abs_err=0.0,
        shape=f"N={N}", ms=_median_ms(lambda: tk.dedup_by_id(*dargs)),
        plain_ms=_median_ms(lambda: tk.dedup_by_id_plain(*dargs)), library_ms=None,
        **_bound(N * (1 + 4 + 4) + N * (1 + 4), 10.0 * N)))
    # ---- Q: rebase ----
    g = torch.Generator().manual_seed(13)
    la_id = torch.randint(-1, 3 * C // 2, (N,), generator=g, dtype=torch.int32)
    tbl_u32 = torch.randint(0, 1 << 30, (C, 10), generator=g, dtype=torch.int32)
    tbl_u32[:, 8] = torch.randint(-1, C, (C,), generator=g, dtype=torch.int32)
    rot = lambda: torch.linalg.qr(torch.randn(3, 3, generator=g))[0]
    rargs = [torch.randn(N, 3, generator=g), torch.rand(N, generator=g) < 0.9, la_id,
             torch.randn(C, 8, generator=g), tbl_u32, rot(), torch.randn(3, generator=g),
             rot(), torch.randn(3, generator=g), rot(), torch.randn(3, generator=g)]
    rargs = [a.to(dev).contiguous() for a in rargs]
    err_r = _check_assoc_call("rebase", rargs)
    found = int(tk.rebase_chain(*rargs)[1].sum())
    print(f"kernel Q rebase_chain: {N} chained slots against {C} table ids (repeated, "
          f"absent, -1), {found} kept valid, ints exact, poses {err_r:.3g} apart")
    rows.append(dict(
        name="rebase_chain", route="cuda", source=src,
        replaces="stella_vslam_tpu/tracking_module.py:51", max_abs_err=err_r,
        shape=f"N={N} C={C}", ms=_median_ms(lambda: tk.rebase_chain(*rargs)),
        plain_ms=_median_ms(lambda: tk.rebase_chain_plain(*rargs)), library_ms=None,
        # read: the chain (3 floats, flag, id per slot), ids and positions of
        # the table, 5 small poses; write the chain and 2 poses
        **_bound(N * 17 + C * 16 + 5 * 48 + N * 17 + 96, 12.0 * (N + C))))

    # ---- R: the table's reprojection and gate, the points', undistortion ----
    srcr = "stella_vslam_tpu_torch/csrc/reproject.cu"
    p = cb.make_params(fx=world.fx, fy=world.fy, cx=world.W / 2.0, cy=world.H / 2.0,
                       width=world.W, height=world.H, focal_x_baseline=world.fx * 0.12)
    g = torch.Generator().manual_seed(14)
    R = torch.linalg.qr(torch.eye(3) + 0.05 * torch.randn(3, 3, generator=g))[0]
    R = (R * torch.sign(torch.det(R))).to(dev)
    t = torch.tensor([0.1, -0.2, 0.3], device=dev)
    # depths 1-6 m in front, a tenth of the points 1.5-6 m behind: the camera
    # frame's depth stays clear of 0, where an ulp of z is pixels of u
    z = torch.rand(C, 1, generator=g) * 5.0 + 1.0
    z = torch.where(torch.rand(C, 1, generator=g) < 0.1, -(z + 0.5), z)
    pos = torch.cat([torch.rand(C, 2, generator=g) * 8 - 4, z], 1)
    normal = torch.nn.functional.normalize(torch.randn(C, 3, generator=g), dim=1)
    d = torch.linalg.norm(pos, dim=1, keepdim=True)
    f = torch.rand(C, 2, generator=g)
    tbl = torch.cat([pos, normal, (0.9 + 0.6 * f[:, :1]) * d, (0.8 + 2.0 * f[:, 1:]) * d],
                    1).to(dev).contiguous()
    tu = torch.zeros(C, 10, dtype=torch.int32)
    tu[:, 9] = (torch.rand(C, generator=g) < 0.9).to(torch.int32)
    tu = tu.to(dev)
    log_scale = float(np.log(np.float32(1.2)))
    pts = tbl[:, 0:3].contiguous()
    # relative to the pixel value, at least 100 px: near u = 0 the sum
    # fx x / z + cx cancels, and one ulp of cx is already 3e-5 px
    rel = lambda a, b: float(((a - b).abs() / b.abs().clamp(min=100.0)).max())
    near = _gate_near(p, R, t, tbl, tu, log_scale)
    err_uv, n_diff = 0.0, 0
    for a, kw, mask in (((pts,), {}, near), ((tbl, tu), dict(log_scale=log_scale, num_levels=8),
                                             near)):
        k = cb.reproject_gate(p, R, t, *a, **kw)
        q = cb.reproject_gate_plain(p, R, t, *a, **kw)
        err_uv = max(err_uv, rel(k[0], q[0]), rel(k[3], q[3]))
        diff = (k[2] != q[2]) | ((k[4] != q[4]) if k[4] is not None else False)
        n_diff += int(diff.sum())
        assert not bool((diff & ~mask).any()), "kernel R's gate disagrees away from a threshold"
    torch.cuda.synchronize()
    print(f"kernel R reproject_gate: {C} points and {C} table rows, uv and x_right within "
          f"{err_uv:.3g} relative (of at least 100 px), {n_diff} flags apart, {int(near.sum())} rows within 1e-6 of "
          f"a threshold")
    assert err_uv < 1e-5, "kernel R's projection disagrees with its plain version"
    rows.append(dict(
        name="reproject_gate", route="cuda", source=srcr,
        replaces="stella_vslam_tpu/camera/base.py:232", max_abs_err=err_uv,
        shape=f"C={C} table rows with the local-map gate",
        ms=_median_ms(lambda: cb.reproject_gate(p, R, t, tbl, tu, log_scale=log_scale,
                                                num_levels=8)),
        plain_ms=_median_ms(lambda: cb.reproject_gate_plain(p, R, t, tbl, tu, log_scale=log_scale,
                                                            num_levels=8)),
        library_ms=None,
        # read a packed row (32 bytes) and its valid word, write uv, depth,
        # flag, x_right and level; ~100 operations per row
        **_bound(C * (32 + 4) + C * (8 + 4 + 1 + 4 + 4) + 48, 100.0 * C)))
    pe = cb.make_params(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
                        k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, width=752, height=480)
    kp = (torch.rand(N, 2, generator=g) * torch.tensor([752.0, 480.0])).to(dev)
    err_u = rel(cb.undistort_norm(pe, kp), cb.perspective_undistort(pe, kp))
    print(f"kernel R undistort_norm: {N} keypoints (EuRoC's radtan), within {err_u:.3g} relative")
    assert err_u < 1e-5, "kernel R's undistortion disagrees with its plain version"
    rows.append(dict(
        name="undistort_norm", route="cuda", source=srcr,
        replaces="stella_vslam_tpu/camera/base.py:89", max_abs_err=err_u, shape=f"N={N}",
        ms=_median_ms(lambda: cb.undistort_norm(pe, kp)),
        plain_ms=_median_ms(lambda: cb.perspective_undistort(pe, kp)), library_ms=None,
        # 10 iterations of ~25 operations per keypoint
        **_bound(N * 8.0 + N * 8.0, 260.0 * N)))
    return rows


def check_repeatability(dev, loop_rec, cam):
    """Kernels F-I and P twice on the same inputs: the same bits. F-I as
    whole BAs at the init, local and global shapes and on the loop slice's
    first global BA problem; P as 20-iteration pose graphs, synthetic and
    the loop slice's first."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba, sim3

    cases = [("init K=2 L=4096 D=2", *_ba_problem(dev, 2, 4096, 2, False, 51), (5, 10)),
             ("local K=16 L=4096 D=12",
              *_ba_problem(dev, 16, 4096, 12, False, 52, spacing=0.1, ordered=True), (3, 6)),
             ("global K=32 L=4096 D=16",
              *_ba_problem(dev, 32, 4096, 16, False, 53, spacing=0.1, ordered=True), (16, 0)),
             ("global K=64 L=4096 D=16",
              *_ba_problem(dev, 64, 4096, 16, False, 54, spacing=0.1, ordered=True), (16, 0))]
    for prob in loop_rec.get("global_ba", [])[:1]:
        cases.append((f"loop slice global BA K={prob.cam_R.shape[0]} "
                      f"L={prob.obs_cam.shape[0]} D={prob.obs_cam.shape[1]}", prob, cam,
                      (16, 0)))
    out = {}
    for label, prob, c, (n1, n2) in cases:
        a = ba.bundle_adjust(prob, c, num_first=n1, num_second=n2)
        b = ba.bundle_adjust(prob, c, num_first=n1, num_second=n2)
        torch.cuda.synchronize()
        out[label] = _same(a, b)
    graphs = [("synthetic K=30 E=128", _graph_problem(dev, 30, 32, 128, 61))]
    graphs += [("loop slice pose graph", a) for a, _ in loop_rec.get("pose_graph", [])[:1]]
    for label, args in graphs:
        a = sim3.optimize_pose_graph(*args)
        b = sim3.optimize_pose_graph(*args)
        torch.cuda.synchronize()
        out["P " + label] = _same(a, b)
    print("kernels F-I and P twice on the same inputs, bit-identical: " + json.dumps(out))
    assert all(out.values()), "a kernel F-I or P result changed between two launches"
    return out


def record_assoc_inputs(sample: int = 97):
    """Keep, by reference, the arguments of every `sample`-th call of kernel
    Q's scatter and dedup and of every chain rebase. The recorders replace
    the module names the callers look up; each original counts its launches
    by its own name, so its count lands on the recorder and `undo` moves it
    back. Returns (calls, undo)."""
    from stella_vslam_tpu_torch import tracking_module as tm
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    calls = {"scatter": [], "dedup": [], "rebase": []}
    seen = {"scatter": 0, "dedup": 0}
    orig = {"scatter": tk.scatter_to_current, "dedup": tk.dedup_by_id,
            "rebase": tm.rebase_chain}

    def recorder(kind):
        def rec(*args):
            n = seen.get(kind, 0)
            if kind == "rebase" or n % sample == 0:
                calls[kind].append(args)
            seen[kind] = n + 1
            return orig[kind](*args)
        rec.launches = 0
        return rec

    recs = {k: recorder(k) for k in orig}
    tk.scatter_to_current, tk.dedup_by_id = recs["scatter"], recs["dedup"]
    tm.rebase_chain = recs["rebase"]

    def undo():
        tk.scatter_to_current, tk.dedup_by_id = orig["scatter"], orig["dedup"]
        tm.rebase_chain = orig["rebase"]
        orig["scatter"].launches += recs["scatter"].launches
        orig["dedup"].launches += recs["dedup"].launches

    return calls, undo


class SyncProbe:
    """The synchronising CUDA calls the tracker's dispatch makes on frames
    [start, stop) of a run: torch's sync debug mode warns at each, and the
    warnings raised on the feeding thread inside TrackingModule._dispatch or
    _try_rebase_chain are counted by file:line."""

    def __init__(self, tracker, start: int, stop: int):
        import threading

        self.start, self.stop = start, stop
        self.local = threading.local()
        self.dispatches = 0
        self.sites = {}
        self.active = False
        self._cm = None
        for name in ("_dispatch", "_try_rebase_chain"):
            setattr(tracker, name, self._wrap(getattr(tracker, name), name == "_dispatch"))

    def _wrap(self, fn, counts):
        def probed(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            self.local.inside = True
            try:
                return fn(*args, **kw)
            finally:
                self.local.inside = False
                self.dispatches += counts
        return probed

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if getattr(self.local, "inside", False) and "synchroniz" in str(message):
            site = f"{os.path.relpath(filename, os.path.dirname(os.path.abspath(__file__)))}:{lineno}"
            self.sites[site] = self.sites.get(site, 0) + 1

    def on_frame(self, i: int):
        import warnings

        import torch

        if i == self.start:
            self._cm = warnings.catch_warnings()
            self._cm.__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            torch.cuda.set_sync_debug_mode("warn")
            self.active = True
        elif i == self.stop:
            self.close()

    def close(self):
        import torch

        if self._cm is not None:
            self.active = False
            torch.cuda.set_sync_debug_mode("default")
            self._cm.__exit__(None, None, None)
            self._cm = None

    def result(self) -> dict:
        total = sum(self.sites.values())
        return dict(frames=[self.start, self.stop], dispatches=self.dispatches,
                    syncs=total, per_dispatch=total / max(1, self.dispatches), sites=self.sites)


class _HeldEvent:
    """A frame's CUDA event whose `synchronize` also waits for `gate` (at
    most `hold_s`): the finalize thread sees the frame as still in flight."""

    def __init__(self, event, gate, hold_s: float):
        self.event, self.gate, self.hold_s = event, gate, hold_s

    def synchronize(self):
        self.gate.wait(self.hold_s)
        self.event.synchronize()


class InFlightPublish:
    """Frame `at` of a run stays in flight until the next feed has passed
    its table check (at most `hold_s`), as on a device that runs behind the
    host, and a table is published (the mapper's call) before that feed:
    its dispatch must rebase the chain on the device. On the H100 the
    finalize thread otherwise keeps up with the feed, so a publish of the
    slice rarely lands with a frame in flight."""

    def __init__(self, slam, at: int, hold_s: float = 1.0):
        import threading

        self.slam, self.at, self.hold_s = slam, at, hold_s
        self.in_flight_at_publish = None
        self._frame = -1
        self._gate = threading.Event()
        tr = slam.tracker
        dispatch, try_rebase = tr._dispatch, tr._try_rebase_chain

        def held(frm, snap=None):
            p = dispatch(frm, snap)
            if p is not None and p.event is not None and self._frame == self.at:
                p.event = _HeldEvent(p.event, self._gate, hold_s)
            return p

        def rebase(snap):
            try:
                return try_rebase(snap)
            finally:
                if self._frame == self.at + 1:
                    self._gate.set()

        tr._dispatch, tr._try_rebase_chain = held, rebase

    def on_frame(self, i: int):
        self._frame = i
        if i == self.at + 1:
            tr = self.slam.tracker
            self.in_flight_at_publish = len(tr._pending)
            self.slam.map_db.refresh_device_table(
                center_kf_id=tr.ref_keyfrm_id, max_local_keyframes=tr.max_num_local_keyfrms)
        elif i == self.at + 2:
            self._gate.set()


def run_threaded_slice(dev, world, wrappers, card):
    """The threaded slice (util/threaded_slice.py: the default System,
    pipelined, mapping and loop-closing threads, the bench's circuit fed as
    fast as the feed returns), every launch count at 0 just before it and
    read just after; kernel Q's inputs recorded and the dispatch's
    synchronising calls counted on frames 300-340; at frame 700 one frame is
    held in flight across a publish (InFlightPublish). Returns (statistics,
    launches, System, recorded Q inputs)."""
    from stella_vslam_tpu_torch.util import threaded_slice

    slam = threaded_slice.make_system(world, dev)
    calls, undo = record_assoc_inputs()
    probe = SyncProbe(slam.tracker, 300, 340)
    held = InFlightPublish(slam, 700)

    def on_frame(i):
        probe.on_frame(i)
        held.on_frame(i)

    for w in wrappers.values():
        w.launches = 0
    try:
        stats = threaded_slice.run_slice(dev, world, slam=slam, on_frame=on_frame)
    finally:
        probe.close()
        undo()
    launches = {k: w.launches for k, w in wrappers.items()}
    stats["launches"] = launches
    stats["sync_per_dispatch"] = probe.result()
    stats["forced_in_flight_publish"] = dict(frame=held.at,
                                             frames_in_flight=held.in_flight_at_publish)
    with open(os.path.join(OUT_DIR, "threaded_slice.json"), "w") as f:
        json.dump(dict(stats, card=card), f, indent=1)
    brief = {k: v for k, v in stats.items() if k not in ("loop_event_ms", "launches")}
    print("threaded slice: " + json.dumps(dict(brief, card=card)))
    print("threaded slice launches: " + json.dumps(launches))
    print("threaded slice loop events (ms, by phase, on the loop-closing threads): "
          + json.dumps(stats["loop_event_ms"]))
    sp = stats["sync_per_dispatch"]
    print(f"threaded slice dispatch: {sp['syncs']} synchronising calls in {sp['dispatches']} "
          f"steady dispatches (frames {sp['frames'][0]}-{sp['frames'][1]}), "
          f"{sp['per_dispatch']:.3f} per dispatch, sites {json.dumps(sp['sites'])}")
    print(f"threaded slice: keyframes created {stats['keyframes_created']} (limit 25; bench.py "
          f"asks 50 of the TPU threaded run), kept {stats['keyframes_kept']} (limit 10; bench.py "
          f"20); local-BA skips {stats['local_ba_skips']} of {stats['ba_opportunities']}; "
          f"rebases {stats['rebases']} (of {stats['publishes']} publishes; one forced at frame "
          f"{held.at} with {held.in_flight_at_publish} frame(s) in flight), drain fallbacks "
          f"{stats['drain_fallbacks']}; worker errors "
          f"{stats['worker_errors']}")
    for e in slam.worker_error_log:
        print("worker error:\n" + e)
    assert stats["worker_errors"] == 0, "a worker thread contained an exception"
    assert stats["lost_after_init"] <= 8, f"{stats['lost_after_init']} frames lost"
    assert stats["loops_closed"] >= 1, "no loop was closed"
    assert stats["ate_m"] < 0.10, f"Sim3 ATE over the circuit {stats['ate_m']:.4f} m"
    assert stats["ba_opportunities"] > 0 and \
        stats["local_ba_skips"] <= 0.2 * stats["ba_opportunities"], "sustained local-BA skips"
    assert stats["keyframes_created"] >= 25, f"{stats['keyframes_created']} keyframes created"
    assert stats["keyframes_kept"] >= 10, f"{stats['keyframes_kept']} keyframes kept"
    st = stats["stranded"]
    assert not st["staged_event"] and st["queued"] == 0 and not st["pending_ba"] \
        and st["loop_queue"] == 0, f"work left at shutdown: {st}"
    for name, n in launches.items():
        assert n > 0 or name in STEREO_KERNELS, f"{name} was not launched by the threaded slice"
    return stats, launches, slam, calls


def check_recorded_assoc(calls):
    """Kernel Q against its plain version on the threaded slice's own
    inputs: the sampled scatters and dedups and every rebase."""
    err = 0.0
    for kind in ("scatter", "dedup", "rebase"):
        for args in calls[kind]:
            err = max(err, _check_assoc_call(kind, args))
    n = {k: len(v) for k, v in calls.items()}
    print(f"kernel Q on the threaded slice's inputs: {json.dumps(n)} calls (every rebase that "
          f"ran), ints exact, poses within {err:.3g}")
    return err



def _stereo_inputs(dev, ex, world, x=0.6):
    """A rendered stereo pair of the bench's world through the pair
    extraction: (the matcher's positional arguments, its keywords)."""
    import torch

    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.stereo_slice import BASELINE

    T = pose_at_xy(x, 0.0)
    Tb = np.eye(4)
    Tb[0, 3] = -BASELINE
    left = torch.from_numpy(world.render(T)).to(dev)
    right = torch.from_numpy(world.render(Tb @ T)).to(dev)
    (fl, sl), (fr, sr) = ex.extract_pair_with_patches(left, right)
    fxb = float(np.float32(world.fx * BASELINE))
    kw = dict(scale_factors=torch.tensor(ex.params.scale_factors, dtype=torch.float32,
                                         device=dev),
              focal_x_baseline=fxb, true_baseline=fxb / float(np.float32(world.fx)))
    return (fl.xy, fl.level, fl.desc, fl.valid, sl, fr.xy, fr.level, fr.desc, fr.valid, sr), kw


def _synthetic_stereo(dev, n=2872, seed=5):
    """Matcher inputs at the slice's width: n keypoints per image at the
    bench's size and levels, 80% of the right ones true matches of a left
    one (disparity 0-60 px, a few flipped bits, the strip shifted by -5..5
    px), the rest random; ties, empty rows and border shifts included."""
    import torch

    from stella_vslam_tpu_torch.feature.orb_params import OrbParams

    rng = np.random.default_rng(seed)
    L = 8
    l_xy = np.stack([rng.uniform(20, 732, n), rng.uniform(20, 460, n)], -1)
    l_xy[:50, 1] = 479.5  # a row band with no right keypoint
    l_lvl = rng.integers(0, L, n)
    l_desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    l_strip = rng.integers(0, 256, (n, 11, 21))
    r_xy = np.stack([rng.uniform(0, 752, n), rng.uniform(20, 460, n)], -1)
    r_lvl = rng.integers(0, L, n)
    r_desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    r_strip = rng.integers(0, 256, (n, 11, 21))
    src = rng.permutation(np.arange(50, n))[:int(0.8 * n)]
    for j, i in enumerate(src):
        r_xy[j] = (l_xy[i, 0] - rng.uniform(0, 60), l_xy[i, 1] + rng.uniform(-1.5, 1.5))
        r_lvl[j] = np.clip(l_lvl[i] + rng.integers(-1, 2), 0, L - 1)
        flips = np.bitwise_and.reduce(
            rng.integers(0, 2 ** 32, (3, 8), dtype=np.uint64).astype(np.uint32), axis=0)
        r_desc[j] = l_desc[i] ^ flips
        r_strip[j] = np.clip(np.roll(l_strip[i], int(rng.integers(-5, 6)), axis=1)
                             + rng.integers(-3, 4, (11, 21)), 0, 255)
    dup = slice(int(0.8 * n), int(0.8 * n) + 100)
    r_xy[dup], r_lvl[dup], r_desc[dup] = r_xy[:100], r_lvl[:100], r_desc[:100]
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a).astype(dt), device=dev)
    valid = lambda: t(rng.random(n) < 0.95, bool)
    fxb = float(np.float32(458.0 * 0.12))
    kw = dict(scale_factors=t(OrbParams(num_levels=L).scale_factors, np.float32),
              focal_x_baseline=fxb, true_baseline=fxb / 458.0)
    return (t(l_xy, np.float32), t(l_lvl, np.int32), t(l_desc.view(np.int32), np.int32),
            valid(), t(l_strip, np.uint8), t(r_xy, np.float32), t(r_lvl, np.int32),
            t(r_desc.view(np.int32), np.int32), valid(), t(r_strip, np.uint8)), kw


def _check_stereo_call(args, kw, label, verbose=True):
    """Kernel T against its plain version on one call: matched flags equal
    except where the deciding quantity sits at its threshold (a disparity
    within 1e-3 of 0 or of max_disp, a SAD within 1e-3 of twice the mean;
    counted); x_right and depth within 1e-5 relative. Returns (rows
    differing, the largest relative error, matched rows, candidate pairs)."""
    import torch

    from stella_vslam_tpu_torch.match import stereo as st

    xk, dk = st.stereo_match(*args, **kw)
    xp, dp = st.stereo_match_plain(*args, **kw)
    pre, sad, disp = st.stereo_refine_plain(*args, **kw)
    torch.cuda.synchronize()
    mk, mp = dk > 0, dp > 0
    differ = mk != mp
    max_disp = st.max_disparity(kw["focal_x_baseline"], kw["true_baseline"])
    two_mean = 2.0 * float(st.filter_mean(pre, sad))
    at_thr = differ & (((disp - max_disp).abs() < 1e-3) | (disp.abs() < 1e-3)
                       | ((sad.float() - two_mean).abs() < 1e-3))
    both = mk & mp
    rel = lambda a, b: float(((a - b).abs() / b.abs().clamp(min=1e-6))[both].max()) \
        if bool(both.any()) else 0.0
    err = max(rel(xk, xp), rel(dk, dp))
    l_xy, l_lvl, l_valid, r_xy, r_lvl, r_valid = args[0], args[1], args[3], args[5], \
        args[6], args[8]
    d = l_xy[:, None, 0] - r_xy[None, :, 0]
    cand = ((r_xy[None, :, 1] - l_xy[:, None, 1]).abs()
            <= 2.0 * kw["scale_factors"][r_lvl.long()][None]) \
        & (d >= 0) & (d < max_disp) & ((l_lvl[:, None] - r_lvl[None]).abs() <= 1) \
        & l_valid[:, None] & r_valid[None]
    n_diff, n_thr = int(differ.sum()), int(at_thr.sum())
    if verbose:
        print(f"kernel T stereo_match {label}: {int(mk.sum())} matched (plain {int(mp.sum())}), "
              f"flags differing {n_diff} ({n_thr} at a threshold), x_right / depth max rel "
              f"err {err:.3g}, candidate pairs {int(cand.sum())}")
    assert n_diff == n_thr, f"kernel T disagrees with plain off a threshold ({label})"
    assert err <= 1e-5, f"kernel T x_right / depth disagree ({label})"
    return n_diff, err, int(mk.sum()), int(cand.sum())


def check_stereo_kernels(dev, world):
    """Kernel S (the pyramid resize), B's strip mode and kernel T (the
    stereo matcher) against their plain versions at the stereo leg's
    shapes, and kernel O in its fixed-scale mode (the stereo and RGBD loop
    path). Returns rows of the kernels line."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import stereo as st
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    rows = []
    params = OrbParams(num_levels=8)
    ex = ox.OrbExtractor(params, 752, 480, min_area=800, device=dev)
    ex_cpu = ox.OrbExtractor(params, 752, 480, min_area=800, device="cpu")
    imgs = [torch.from_numpy(world.render(pose_at_xy(x, 0.0))).to(dev) for x in (0.6, 3.0)]
    pair = torch.stack(imgs)

    # ---- S: the pyramid, against the two torch.matmul per level ----
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    n_px = n_diff = n_cpu_diff = keys = keys_moved = 0
    max_diff = 0.0
    for img in imgs:
        pk, pp = ex.pyramid(img), ex.pyramid_plain(img)
        pc = ex_cpu.pyramid_plain(img.cpu())
        for lvl, (a, b, c, g) in enumerate(zip(pk, pp, pc, ex.levels)):
            if lvl:
                n_px += a.numel()
                n_diff += int((a != b).sum())
                n_cpu_diff += int((a.cpu() != c).sum())
                max_diff = max(max_diff, float((a - b).abs().max()))
            ka = ox.fast_nms(a.contiguous(), g, ex.border, *thr)
            kb = ox.fast_nms(b.contiguous(), g, ex.border, *thr)
            keys += ka.numel()
            keys_moved += int((ka != kb).sum())
    torch.cuda.synchronize()
    print(f"kernel S resize_level: levels 1-7 of 2 frames, {n_px} pixels: {n_diff} "
          f"({n_diff / n_px:.4%}) differ from cuBLAS's matmul, max |diff| {max_diff:.3g}; "
          f"{n_cpu_diff} differ from the CPU's matmul; kernel A's cell keys moved "
          f"{keys_moved} of {keys} ({keys_moved / keys:.4%})")
    assert max_diff <= 1e-4, "kernel S disagrees with the matmul pyramid"
    assert keys_moved <= 0.005 * keys, "kernel S moves kernel A's keys"
    lvl_px = [g.H * g.W for g in ex.levels]
    s_bytes = 2 * 4.0 * sum(lvl_px[l - 1] + lvl_px[l] for l in range(1, len(lvl_px)))
    plain_pair = lambda: [ex.pyramid_plain(i) for i in imgs]
    plain_ms = _median_ms(plain_pair)
    rows.append(dict(
        name="resize_level", route="cuda", source="stella_vslam_tpu_torch/csrc/resize.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:118",
        max_abs_err=max_diff, pixels_differing_cublas=n_diff, pixels=n_px,
        pixels_differing_cpu_matmul=n_cpu_diff, fast_keys_moved=keys_moved, fast_keys=keys,
        shape="2 x 752x480, 8 levels (the stereo pair)",
        ms=_median_ms(lambda: ex.pyramid_flat(pair)),
        ms_one_image=_median_ms(lambda: ex.pyramid_flat(pair[:1])),
        plain_ms=plain_ms, library_ms=plain_ms,
        **_bound(s_bytes, 2 * 6.0 * sum(lvl_px[1:]))))

    # ---- B's strip mode: both images of a pair ----
    pyr = ex.pyramid_flat(pair)
    pts = [ex.cell_keypoints(ox.fast_nms(v, g, ex.border, *thr), g)
           for v, g in zip(ex.level_views(pyr), ex.levels)]
    px, py, valid, _ = (torch.cat(c, dim=-1) for c in zip(*pts))
    base, hh, ww = ex._slots(2)
    bargs = (pyr.reshape(-1), base, hh, ww, px.reshape(-1).int().contiguous(),
             py.reshape(-1).int().contiguous(), valid.reshape(-1).contiguous(), ex._tables)
    ak, dk, sk = ox.orb_describe_strips(*bargs)
    ap, dp, sp = ox.orb_describe_plain(*bargs, strips=True)
    torch.cuda.synchronize()
    v = bargs[6]
    strips_equal = bool(torch.equal(sk[v], sp[v]))
    x = (dk ^ dp)[v].cpu().numpy()
    bit_rate = float(np.unpackbits(x.view(np.uint8)).sum()) / max(1, x.size * 32)
    err_b = float((ak - ap).abs().max())
    print(f"kernel B orb_describe_strips: {int(v.sum())} keypoints of a pair, strips equal "
          f"{strips_equal}, descriptor bit mismatch {bit_rate:.6f}, max |angle diff| {err_b:.3g}")
    assert strips_equal, "kernel B's strips disagree with plain"
    assert bit_rate <= DESC_MISMATCH_BOUND and err_b < 1e-3, "kernel B disagrees"
    n_valid = int(v.sum())
    rows.append(dict(
        name="orb_describe_strips", route="cuda",
        source="stella_vslam_tpu_torch/csrc/orb_describe.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:284-296 (extract_with_patches)",
        max_abs_err=err_b, strips_equal=strips_equal, desc_bit_mismatch=bit_rate,
        shape="2 x 2872 slots",
        ms=_median_ms(lambda: ox.orb_describe_strips(*bargs)),
        plain_ms=_median_ms(lambda: ox.orb_describe_plain(*bargs, strips=True), reps=5),
        library_ms=None,
        **_bound(4.0 * pyr.numel() + (36.0 + 231.0) * bargs[1].numel(),
                 n_valid * (31 * 31 * 2 + 39 * 39 * 49 * 2 + 256 * 2))))

    # ---- T: the stereo matcher, synthetic and on a rendered pair ----
    ta, tkw = _synthetic_stereo(dev)
    n_diff_t, err_t, n_match, n_cand = _check_stereo_call(ta, tkw, "synthetic 2872 x 2872")
    ra, rkw = _stereo_inputs(dev, ex, world)
    d2, e2, m2, c2 = _check_stereo_call(ra, rkw, "rendered pair")
    n = ra[0].shape[0]
    rows.append(dict(
        name="stereo_match", route="cuda", source="stella_vslam_tpu_torch/csrc/stereo_match.cu",
        replaces="stella_vslam_tpu/match/stereo.py:32", max_abs_err=max(err_t, e2),
        flags_differing=n_diff_t + d2, shape=f"{n} x {n} (rendered pair)",
        matched=m2, candidate_pairs=c2,
        ms=_median_ms(lambda: st.stereo_match(*ra, **rkw)),
        plain_ms=_median_ms(lambda: st.stereo_match_plain(*ra, **rkw), reps=5),
        library_ms=None,
        # every pair: ~6 gate operations; a candidate: 8 XOR + 8 popc; a
        # matched row: 11 x 121 x 3 SAD operations
        **_bound(2 * n * (8 + 4 + 32 + 1 + 231.0) + 8.0 * n,
                 6.0 * n * n + 16.0 * c2 + m2 * 11 * 121 * 3.0)))

    # ---- O in its fixed-scale mode (stereo and RGBD loop closure) ----
    err_o = _check_transform(_transform_problem(dev, 74, 7), {"fix_scale": True}, "fixed scale")
    print(f"kernel O fixed-scale mode against plain: max |s, R, t diff| {err_o:.3g}")
    return rows


def record_stereo_inputs(sample: int = 20):
    """Keep, by reference, the arguments of every `sample`-th stereo match
    of the System (the name `system.stereo_match` the stereo frame looks
    up); the matcher counts its launches on its own name. Returns (calls,
    undo)."""
    from stella_vslam_tpu_torch import system as system_mod

    calls, seen = [], [0]
    orig = system_mod.stereo_match

    def rec(*args, **kw):
        if seen[0] % sample == 0:
            calls.append((args, kw))
        seen[0] += 1
        return orig(*args, **kw)

    system_mod.stereo_match = rec

    def undo():
        system_mod.stereo_match = orig

    return calls, undo


# what the stereo leg and the RGBD leg with mapping launch
LEG_KERNELS = ("resize_level", "fast_nms", "hamming_top2", "pose_lm", "scatter_to_current",
               "dedup_by_id", "reproject_gate", "undistort_norm", "epipolar_top2", "triangulate",
               "fuse", "ba_linearize_schur", "ba_reduced_solve", "ba_backsub_cost", "ba_classify",
               "bow_transform")


def run_stereo_legs(dev, world, wrappers, card):
    """bench.py's stereo leg and its RGBD leg with mapping (util/
    stereo_slice.py: the default threaded System, 640 frames each), every
    launch count at 0 just before each and read just after, with the bench's
    gates; then kernel T against plain on a sample of the stereo leg's own
    calls. Returns ({leg: stats}, {leg: launches})."""
    import torch

    from stella_vslam_tpu_torch.util import stereo_slice

    stats, launches = {}, {}
    for setup in ("stereo", "RGBD"):
        calls, undo = record_stereo_inputs() if setup == "stereo" else ([], lambda: None)
        slam = stereo_slice.make_system(world, dev, setup)
        for w in wrappers.values():
            w.launches = 0
        try:
            s = stereo_slice.run_leg(dev, world, setup, slam=slam)
        finally:
            undo()
        launches[setup] = {k: w.launches for k, w in wrappers.items()}
        stats[setup] = s
        with open(os.path.join(OUT_DIR, f"{setup.lower()}_leg.json"), "w") as f:
            json.dump(dict(s, card=card), f, indent=1)
        print(f"{setup} leg: " + json.dumps(dict(
            {k: v for k, v in s.items() if k != "launches"}, card=card)))
        print(f"{setup} leg launches: " + json.dumps(launches[setup]))
        for e in slam.worker_error_log:
            print("worker error:\n" + e)
        stereo_slice.check_gates(s)
        own = STEREO_KERNELS if setup == "stereo" else ("orb_describe",)
        for name in LEG_KERNELS + own:
            assert launches[setup][name] > 0, f"{name} was not launched by the {setup} leg"
        if setup == "stereo":
            torch.cuda.synchronize()
            res = [_check_stereo_call(args, kw, "stereo leg call", verbose=False)
                   for args, kw in calls]
            print(f"kernel T on the stereo leg's own inputs: {len(res)} calls, "
                  f"{sum(r[2] for r in res)} rows matched, flags differing "
                  f"{sum(r[0] for r in res)} (all at a threshold), x_right / depth within "
                  f"{max(r[1] for r in res):.3g}")
    return stats, launches


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
    for name in ("fast_nms", "orb_describe", "hamming_top2", "pose_lm", "scatter_to_current",
                 "dedup_by_id", "reproject_gate", "undistort_norm"):
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
        assert n > 0 or name in MAPPING_KERNELS + LOOP_KERNELS + THREADED_KERNELS \
            + STEREO_KERNELS, \
            f"{name} was not launched by the mono slice"
    return stats, mono, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "main path runs on the GPU only", file=sys.stderr)
        return 1
    from stella_vslam_tpu_torch.kernels import build as kbuild
    from stella_vslam_tpu_torch.util import map_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t_run = t0 = time.monotonic()
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
    rows += check_track_kernels(dev, world)
    rows += check_stereo_kernels(dev, world)
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}) "
              f"[{card}]")

    wrappers = map_slice.kernel_wrappers()
    rgbd, mono, launches = run_slices(dev, world, wrappers, card)
    loop, launches["loop"], slam, inputs, loop_rec = run_loop_slice(dev, world, wrappers, card)
    twice, _ = rerun_loop_slice(dev, world, slam, card)
    twice["ate_m"][0], twice["loops"][0] = loop["ate_m"], loop["loops_closed"]
    print("loop slice twice in one process: " + json.dumps(twice))
    assert twice["ate_m"][1] < 0.10, f"second loop slice: Sim3 ATE {twice['ate_m'][1]:.4f} m"
    map_rows = check_mapping_kernels(dev, slam.mapper, inputs)
    map_rows += check_loop_kernels(dev, slam, loop_rec)
    repeat = check_repeatability(dev, loop_rec, slam.mapper.cam_scalars)
    threaded, launches["threaded"], tslam, assoc_rec = run_threaded_slice(
        dev, world, wrappers, card)
    check_recorded_assoc(assoc_rec)
    legs, leg_launches = run_stereo_legs(dev, world, wrappers, card)
    for r in map_rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}) "
              f"[{card}]")
    rows += map_rows
    for row in rows:
        name = row.pop("counter", row["name"])
        for suffix in ("_local", "_global32", "_global64"):
            name = name.removesuffix(suffix)
        # `launches`: on the path of the slice that ported the kernel (the
        # stereo leg for S, B's strip mode and T; the threaded slice for the
        # rest), every slice's beside it
        row["launches"] = (leg_launches["stereo"] if name in STEREO_PATH_ROWS
                           else launches["threaded"])[name]
        row["launches_stereo_leg"] = leg_launches["stereo"][name]
        row["launches_rgbd_mapping_leg"] = leg_launches["RGBD"][name]
        row["launches_threaded_slice"] = launches["threaded"][name]
        row["launches_loop_slice"] = launches["loop"][name]
        row["launches_mono_slice"] = launches["mono"][name]
        row["launches_rgbd_slice"] = launches["rgbd"][name]
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump({"card": card, "kernels": rows}, f, indent=1)
    # the slices in short, near the end of the output
    print("slices: " + json.dumps(dict(
        card=card, rgbd_ate_m=rgbd["ate_m"], mono_ate_m=mono["ate_m"],
        mono_init_frame=mono["init_frame"], map_ate_m=loop["map_slice_ate_m"],
        **{"loop_" + k: loop[k] for k in (
            "ate_m", "tracked", "lost_after_init", "loops_closed", "loop_frames",
            "keyframes_created", "keyframes_kept", "loop_event_ms", "solver_shapes",
            "frame_ms")},
        loop_twice_bit_identical=twice["poses_bit_identical"], loop_twice_ate_m=twice["ate_m"],
        f_p_repeat_bit_identical=all(repeat.values()),
        **{"threaded_" + k: threaded[k] for k in (
            "ate_m", "tracked", "lost_after_init", "loops_closed", "keyframes_created",
            "keyframes_kept", "local_bas", "local_ba_skips", "frame_ms", "keyframe_event_ms",
            "loop_event_phase_ms", "rebases", "drain_fallbacks", "feed_wait_s",
            "worker_errors", "fps", "frames_per_wall_s")},
        threaded_sync_per_dispatch=threaded["sync_per_dispatch"]["per_dispatch"],
        **{f"{leg.lower()}_leg_" + k: legs[leg][k] for leg in legs for k in (
            "ate_m", "scale_err", "tracked", "lost_after_init", "keyframes_created",
            "keyframes_kept", "local_bas", "loops_closed", "frame_ms", "keyframe_event_ms",
            "worker_errors", "fps", "frames_per_wall_s")})))
    print(f"chip_smoke: {time.monotonic() - t_run:.1f} s from the build on [{card}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
