"""Drive the RGBD tracking slice on the bench's world and measure it.

The configuration is bench.py's RGBD leg (run_rgbd): the photo-hardened
plane world at EuRoC size (752x480, fx 458, plane at 4 m, pixel noise
sigma 2, +-6% exposure drift), 8 ORB levels, min_size 800 (2872 slots),
exact uint16 depth at TUM's factor 5000, baseline 0.12 m; the camera moves
0.015 m per frame along the outbound path; mapping disabled.

    python -m stella_vslam_tpu_torch.util.rgbd_slice [--frames N] [--profile]

prints the slice's statistics as JSON and, with --profile, a torch.profiler
breakdown of a steady window (CUDA time by kernel, device busy share, host
time per phase). It needs a CUDA GPU; chip_smoke.py runs the same slice and
asserts its bounds.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util.drift import pose_at_xy
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld


def bench_world() -> PlaneWorld:
    return PlaneWorld(width=752, height=480, fx=458.0, fy=458.0, depth=4.0,
                      tex_size=4096, meters_per_px=0.008, noise_sigma=2.0,
                      exposure_amp=0.06)


def make_system(world: PlaneWorld, device) -> System:
    cam = world.camera_yaml()
    cam["setup"] = "RGBD"
    cam["focal_x_baseline"] = world.fx * 0.12
    cfg = Config.from_dict({
        "Camera": cam,
        "Feature": {"num_levels": 8},
        "Preprocessing": {"depthmap_factor": 5000.0},
    })
    slam = System(cfg, device=device, inline_mapping=True)
    slam.disable_mapping_module()
    slam.startup()
    return slam


def trajectory_errors(frame_poses, gt_xy):
    """(tracked, lost after init, rigid ATE m, scale error) with ground
    truth indexed by feed order (frame ids are a process-wide counter)."""
    first = next(i for i, (_, p, _, _) in enumerate(frame_poses) if p is not None)
    lost = sum(1 for (_, p, _, _) in frame_poses[first:] if p is None)
    fid0 = frame_poses[0][3]
    est, gt = [], []
    for (_, pose, _, fid) in frame_poses:
        if pose is not None:
            est.append(-pose[:3, :3].T @ pose[:3, 3])
            gt.append([gt_xy[fid - fid0][0], gt_xy[fid - fid0][1], 0.0])
    est, gt = np.asarray(est), np.asarray(gt)
    if not np.all(np.isfinite(est)):
        raise ValueError("non-finite camera centre")
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e) / len(est))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    aligned = (U @ D @ Vt @ (est - mu_e).T).T + mu_g
    ate = float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, 1))))
    len_est = float(np.linalg.norm(np.diff(est, axis=0), axis=1).sum())
    len_gt = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return len(est), lost, ate, abs(len_est - len_gt) / len_gt


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_slice(device, world: PlaneWorld, n_frames: int = 120,
              step: float = 0.015, profile_window=None):
    """Feed n_frames; returns the statistics dict. `profile_window`
    (start, stop) traces those frames with torch.profiler and adds the
    breakdown under "profile"."""
    slam = make_system(world, device)
    gt_xy = [(i * step, 0.0) for i in range(n_frames)]
    images = [world.render(pose_at_xy(x, y)) for x, y in gt_xy]
    depth_raw = np.full((world.H, world.W), int(4.0 * 5000.0), np.uint16)
    frame_ms, phase = [], {"extract_ms": [], "track_ms": []}
    prof = None
    for i, img in enumerate(images):
        if profile_window and i == profile_window[0]:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        if profile_window:
            # phase split: extraction vs tracking, each ended by a sync
            frm = slam.create_RGBD_frame(img, depth_raw, i * 0.05)
            _sync(device)
            t1 = time.perf_counter()
            slam.tracker.feed_frame(frm)
            _sync(device)
            phase["extract_ms"].append((t1 - t0) * 1e3)
            phase["track_ms"].append((time.perf_counter() - t1) * 1e3)
        else:
            slam.feed_RGBD_frame(img, depth_raw, i * 0.05)
            _sync(device)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if prof is not None and i == profile_window[1] - 1:
            prof.__exit__(None, None, None)
            window_ms = sum(frame_ms[profile_window[0]:])
            prof = _summarize(prof, window_ms, profile_window[1] - profile_window[0])
    slam.shutdown()
    tracked, lost, ate, scale_err = trajectory_errors(slam.frame_poses, gt_xy)
    # frame 0 initializes the map and frame 1 is the first to track: their
    # times include one-time set-up (first launches load CUDA modules), so
    # they are reported apart from the steady frames
    steady = np.asarray(frame_ms[2:])
    stats = dict(frames=n_frames, tracked=tracked, lost_after_init=lost,
                 ate_m=ate, scale_err=scale_err,
                 landmarks=slam.map_db.num_landmarks(),
                 frame_ms_p50=float(np.percentile(steady, 50)),
                 frame_ms_p99=float(np.percentile(steady, 99)),
                 frame_ms_max=float(steady.max()),
                 first_frames_ms=frame_ms[:2])
    if profile_window:
        stats["profile"] = prof
        stats["phase_ms_p50"] = {k: float(np.median(v[2:])) for k, v in phase.items()}
    return stats


def _summarize(prof, window_ms: float, n: int) -> dict:
    """CUDA time per frame by kernel name and the device busy share."""
    rows = []
    total_us = 0.0
    for e in prof.key_averages():
        # device-side events only: the CPU ops that launched them carry the
        # same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((e.key, dev_us / n / 1e3, e.count / n))
            total_us += dev_us
    rows.sort(key=lambda r: -r[1])
    return {"window_frames": n, "wall_ms_per_frame": window_ms / n,
            "device_ms_per_frame": total_us / n / 1e3,
            "device_busy_share": total_us / 1e3 / window_ms,
            "top_kernels_ms_per_frame": [
                {"name": k[:80], "ms": ms, "launches": c} for k, ms, c in rows[:25]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rgbd_slice: needs a CUDA GPU")
    stats = run_slice(torch.device("cuda", 0), bench_world(), args.frames,
                      profile_window=(40, 60) if args.profile else None)
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
