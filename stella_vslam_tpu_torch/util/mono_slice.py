"""Drive the monocular slice on the bench's world and measure it.

The configuration is bench.py's mono leg (main, bench.py:261-444): the
photo-hardened plane world at EuRoC size (752x480, fx 458, plane at 4 m,
pixel noise sigma 2, +-6% exposure drift), 8 ORB levels, min_size 800
(2872 slots), Initializer use_fixed_seed; the camera moves 0.015 m per frame
along the outbound path; mapping disabled (the mapping module is not
ported), so after the two-keyframe initialization every frame tracks
against the initial map.

    python -m stella_vslam_tpu_torch.util.mono_slice [--frames N] [--profile]

prints the slice's statistics as JSON: the init frame, frames tracked and
lost after init, the Sim3 ATE (Umeyama with scale: a monocular map has no
metric scale), p50 / p99 / max frame time over the steady frames (those
after the first tracked frame), the init frame's own time split by phase,
and, with --profile, a torch.profiler breakdown of a steady window (as
rgbd_slice). It needs a CUDA GPU; chip_smoke.py runs the same slice and
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
from stella_vslam_tpu_torch.util.rgbd_slice import _summarize, _sync, bench_world
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld


def make_system(world: PlaneWorld, device) -> System:
    cfg = Config.from_dict({
        "Camera": world.camera_yaml(),
        "Feature": {"num_levels": 8},
        "Initializer": {"use_fixed_seed": True},
    })
    slam = System(cfg, device=device, inline_mapping=True)
    slam.disable_mapping_module()
    slam.startup()
    return slam


def sim3_ate(est: np.ndarray, gt: np.ndarray):
    """(RMS error after the Umeyama similarity alignment est -> gt, scale)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(gc.T @ ec / len(est))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max((ec ** 2).sum() / len(est), 1e-12)
    aligned = s * (R @ ec.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, 1)))), float(s)


def trajectory_stats(frame_poses, gt_xy):
    """(init frame index, tracked, lost after init, Sim3 ATE m, scale) with
    ground truth indexed by feed order."""
    fid0 = frame_poses[0][3]
    first = next(i for i, (_, p, _, _) in enumerate(frame_poses) if p is not None)
    lost = sum(1 for (_, p, _, _) in frame_poses[first:] if p is None)
    est, gt = [], []
    for (_, pose, _, fid) in frame_poses:
        if pose is not None:
            est.append(-pose[:3, :3].T @ pose[:3, 3])
            gt.append([gt_xy[fid - fid0][0], gt_xy[fid - fid0][1], 0.0])
    est = np.asarray(est)
    if not np.all(np.isfinite(est)):
        raise ValueError("non-finite camera centre")
    ate, scale = sim3_ate(est, np.asarray(gt))
    return first, len(est), lost, ate, scale


class _PhaseTimer:
    """Wraps named methods of one object to add their synchronised wall
    time (ms) to `ms[label]` while `on` is set."""

    def __init__(self, device):
        self.device = device
        self.on = False
        self.ms = {}

    def wrap(self, obj, name: str, label: str):
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            _sync(self.device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(self.device)
            self.ms[label] = self.ms.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        setattr(obj, name, timed)


def run_slice(device, world: PlaneWorld, n_frames: int = 120, step: float = 0.015,
              profile_window=None):
    """Feed n_frames; returns the statistics dict. The first frame that
    initializes is timed by phase; `profile_window` (start, stop) traces
    those frames with torch.profiler and adds the breakdown."""
    slam = make_system(world, device)
    tr, init = slam.tracker, slam.tracker.initializer
    timer = _PhaseTimer(device)
    timer.wrap(slam, "create_monocular_frame", "extract")
    timer.wrap(init, "try_initialize_monocular", "initializer")
    timer.wrap(init, "_two_view_hypotheses", "ransac_h_f")
    timer.wrap(init, "_finish_two_view", "hypothesis_eval")
    timer.wrap(tr, "_create_map_for_monocular", "map_creation")
    timer.wrap(tr, "_init_map_ba", "init_ba")
    gt_xy = [(i * step, 0.0) for i in range(n_frames)]
    images = [world.render(pose_at_xy(x, y)) for x, y in gt_xy]
    frame_ms, init_phases, prof = [], None, None
    for i, img in enumerate(images):
        if profile_window and i == profile_window[0]:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        initializing = tr.state == "Initializing"
        timer.on, timer.ms = initializing, {}
        t0 = time.perf_counter()
        slam.feed_monocular_frame(img, i * 0.05)
        _sync(device)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if initializing and tr.state == "Tracking":
            ms = dict(timer.ms)
            # the initializer's own time less its timed parts: the area
            # matcher and its host reads; map creation less the init BA
            ms["area_match"] = ms.pop("initializer") - ms.get("ransac_h_f", 0.0) \
                - ms.get("hypothesis_eval", 0.0)
            ms["map_creation"] -= ms.get("init_ba", 0.0)
            ms["total"] = frame_ms[-1]
            init_phases = ms
        if prof is not None and i == profile_window[1] - 1:
            prof.__exit__(None, None, None)
            window_ms = sum(frame_ms[profile_window[0]:])
            prof = _summarize(prof, window_ms, profile_window[1] - profile_window[0])
    timer.on = False
    slam.shutdown()
    first, tracked, lost, ate, scale = trajectory_stats(slam.frame_poses, gt_xy)
    # the first tracked frame after the init frame loads the tracking
    # kernels; the steady frames start after it
    steady = np.asarray(frame_ms[first + 2:])
    stats = dict(frames=n_frames, init_frame=first, tracked=tracked,
                 lost_after_init=lost, ate_m=ate, sim3_scale=scale,
                 keyframes=slam.map_db.num_keyframes(),
                 landmarks=slam.map_db.num_landmarks(),
                 frame_ms_p50=float(np.percentile(steady, 50)),
                 frame_ms_p99=float(np.percentile(steady, 99)),
                 frame_ms_max=float(steady.max()),
                 pre_init_frame_ms_p50=float(np.median(frame_ms[:first])) if first else None,
                 init_frame_ms=frame_ms[first], first_tracked_frame_ms=frame_ms[first + 1],
                 init_phase_ms=init_phases)
    if profile_window:
        stats["profile"] = prof
    return stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mono_slice: needs a CUDA GPU")
    stats = run_slice(torch.device("cuda", 0), bench_world(), args.frames,
                      profile_window=(40, 60) if args.profile else None)
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
