#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (stella_vslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit;
  2. build: compiles the four kernels of csrc/ with nvcc for sm_90a (timed);
  3. kernels: each of A (fast_nms), B (orb_describe), C (hamming_top2) and
     D (pose_lm) against its plain PyTorch version on the card, at the
     slice's shapes (752x480, 8 levels, N=2872 slots, C=4096 table rows):
     A and C exact, B's descriptor bit-mismatch rate <= 5e-5 (the CPU test's
     bound against JAX), D's pose within 1e-4; median times of both;
  4. slice: the port's System in RGBD mode with mapping disabled, 120 frames
     of the numpy plane world at 0.015 m/frame (the bench's RGBD settings,
     uint16 depth at factor 5000): at most 2 frames lost after init, rigid
     ATE < 0.10 m, scale error < 5%, every kernel launched by the main path;
     frame time p50/p99/max over the steady frames (all but the first two).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Long logs go to chiprun_out/.
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


def check_kernels(dev, world):
    """Each kernel against its plain version on the card; returns rows of
    the kernels line (launch counts filled in after the slice)."""
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
    rows.append(dict(
        name="fast_nms", route="cuda",
        source="stella_vslam_tpu_torch/csrc/fast_nms.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:88",
        max_abs_err=float(err_a),
        ms=_median_ms(lambda: run_a(ox.fast_nms)),
        plain_ms=_median_ms(lambda: run_a(ox.fast_nms_plain))))

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
    print(f"kernel B orb_describe: {int(valid.sum())} keypoints, descriptor "
          f"bit mismatch {bit_rate:.6f}, max |angle diff| {err_b:.3g} rad")
    assert bit_rate <= DESC_MISMATCH_BOUND, "kernel B descriptors disagree"
    assert err_b < 1e-3, "kernel B angles disagree"
    rows.append(dict(
        name="orb_describe", route="cuda",
        source="stella_vslam_tpu_torch/csrc/orb_describe.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:392",
        max_abs_err=err_b, desc_bit_mismatch=bit_rate,
        ms=_median_ms(lambda: ox.orb_describe(*args)),
        plain_ms=_median_ms(lambda: ox.orb_describe_plain(*args))))

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
    rows.append(dict(
        name="hamming_top2", route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/hamming.py:31",
        max_abs_err=float(err_c),
        ms=_median_ms(lambda: H.hamming_top2(*a, **kw)),
        plain_ms=_median_ms(lambda: H.hamming_top2_plain(*a, **kw))))

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
    rows.append(dict(
        name="pose_lm", route="cuda",
        source="stella_vslam_tpu_torch/csrc/pose_lm.cu",
        replaces="stella_vslam_tpu/ops/optim/pose.py:39",
        max_abs_err=err_d,
        ms=_median_ms(lambda: pose_mod.optimize_pose(*dargs), reps=10),
        plain_ms=_median_ms(lambda: pose_mod.optimize_pose_plain(*dargs), reps=5,
                            warmup=1)))
    return rows


def run_slice(dev, world):
    """The port's System, RGBD, mapping disabled, 120 frames at the bench's
    settings (stella_vslam_tpu_torch/util/rgbd_slice.py), held to the
    bench's RGBD bounds."""
    from stella_vslam_tpu_torch.util import rgbd_slice

    stats = rgbd_slice.run_slice(dev, world, n_frames=120, step=0.015)
    print("slice: " + json.dumps(stats))
    assert stats["tracked"] > 0 and stats["landmarks"] > 0
    assert stats["lost_after_init"] <= 2, f"{stats['lost_after_init']} frames lost"
    assert stats["ate_m"] < 0.10, f"rigid ATE {stats['ate_m']:.4f} m"
    assert stats["scale_err"] < 0.05, f"scale error {stats['scale_err']:.2%}"
    return stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "main path runs on the GPU only", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.kernels import build as kbuild
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.ops.optim import pose as pose_mod

    t0 = time.monotonic()
    kbuild.load()
    print(f"build: {time.monotonic() - t0:.2f} s (nvcc {kbuild.build_seconds:.2f} s)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(kbuild.build_log)
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    world = bench_world()
    rows = check_kernels(dev, world)

    wrappers = {"fast_nms": ox.fast_nms, "orb_describe": ox.orb_describe,
                "hamming_top2": H.hamming_top2, "pose_lm": pose_mod.optimize_pose}
    for w in wrappers.values():
        w.launches = 0
    run_slice(dev, world)
    for row in rows:
        row["launches"] = wrappers[row["name"]].launches
        assert row["launches"] > 0, f"{row['name']} was not launched by the slice"
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
