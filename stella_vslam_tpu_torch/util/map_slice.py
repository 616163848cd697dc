"""Drive the mapping slice on the bench's world and measure it.

The configuration is bench.py's mono leg (main, bench.py:261-444) with
mapping enabled and inline: the photo-hardened plane world at EuRoC size
(752x480, fx 458, plane at 4 m, pixel noise sigma 2, +-6% exposure drift),
8 ORB levels, min_size 800 (2872 slots), Initializer use_fixed_seed, table
capacity 4096; the camera moves 0.015 m per frame along the outbound path
(500 frames, x from 0 to 7.49 m). Every keyframe event runs triangulation
(kernels J, K) against up to 5 neighbours, both fusion directions in chunks
of 16 keyframes x 2048 landmarks (kernel L) and, past two keyframes, local
BA at K = 16, L <= 8192, D = 12 (kernels F-I).

    python -m stella_vslam_tpu_torch.util.map_slice [--frames N] [--profile]

prints the slice's statistics as JSON: the init frame, frames tracked and
lost after init, the Sim3 ATE, keyframes inserted and kept, landmarks,
local BAs run, frame time p50 / p99 / max over every frame after init
(keyframe frames included), keyframe-event time p50 / max with its split
into triangulation, fusion, local BA and host apply (each phase ends in a
host read, so device time lands in the phase that ran it), kernel launches
and, with --profile, a torch.profiler breakdown of frames 100-129, a window
that holds at least one keyframe event (keyframes come at least every
max_interval = 1 s = 20 frames). It needs a CUDA GPU; chip_smoke.py runs
the same slice and asserts its bounds.
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
from stella_vslam_tpu_torch.util.mono_slice import trajectory_stats
from stella_vslam_tpu_torch.util.rgbd_slice import _summarize, _sync, bench_world
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld

# the event phases the statistics split the keyframe-event time into
EVENT_PHASES = ("triangulation", "fusion", "local_ba", "apply", "cull", "cull_publish")


def make_system(world: PlaneWorld, device, loop_detector: bool = False,
                inline_mapping: bool = True) -> System:
    """The bench's mono System (mapping on, as by default) and warm; the loop
    detector off unless asked for (util/loop_slice.py runs the same leg with
    it on); inline unless asked otherwise (util/threaded_slice.py)."""
    cfg = Config.from_dict({
        "Camera": world.camera_yaml(),
        "Feature": {"num_levels": 8},
        "Initializer": {"use_fixed_seed": True},
        "LoopDetector": {"enabled": loop_detector},
    })
    slam = System(cfg, device=device, inline_mapping=inline_mapping)
    slam.startup()
    return slam


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the slice, by kernel name (each counts its
    launches)."""
    from stella_vslam_tpu_torch.camera import base as cam_base
    from stella_vslam_tpu_torch.data import bow_vocabulary as bow
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.match import stereo
    from stella_vslam_tpu_torch.module import mapping_kernels as mk
    from stella_vslam_tpu_torch.module import tracking_kernels as tk
    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.ops.optim import pose as pose_mod
    from stella_vslam_tpu_torch.ops.optim import sim3
    from stella_vslam_tpu_torch.ops.solve import pnp, ransac

    return {"resize_level": ox.resize_level, "fast_nms": ox.fast_nms,
            "orb_describe": ox.orb_describe, "orb_describe_strips": ox.orb_describe_strips,
            "stereo_match": stereo.stereo_match,
            "hamming_top2": H.hamming_top2, "pose_lm": pose_mod.optimize_pose,
            "ransac_two_view": ransac.minimal_hypotheses,
            "ba_linearize_schur": ba.ba_linearize_schur,
            "ba_reduced_solve": ba.ba_reduced_solve,
            "ba_backsub_cost": ba.ba_backsub_cost, "ba_classify": ba.ba_classify,
            "epipolar_top2": H.epipolar_top2, "triangulate": mk.triangulate_checks,
            "fuse": mk.fuse_scan, "bow_transform": bow.bow_transform,
            "pnp_ransac": pnp.pnp_hypotheses, "sim3_transform": sim3.sim3_transform,
            "pose_graph": sim3.pose_graph_linearize,
            "scatter_to_current": tk.scatter_to_current, "dedup_by_id": tk.dedup_by_id,
            "rebase_chain": tk.rebase_chain, "reproject_gate": cam_base.reproject_gate,
            "undistort_norm": cam_base.undistort_norm}


def _pcts(v):
    v = np.asarray(v, np.float64)
    return {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99)),
            "max": float(v.max())} if len(v) else None


def slice_stats(slam: System, gt_xy, frame_ms, launches) -> dict:
    """The statistics of the frames fed so far (ground truth and frame times
    in feed order)."""
    first, tracked, lost, ate, scale = trajectory_stats(slam.frame_poses, gt_xy)
    md, mapper = slam.map_db, slam.mapper
    # the init pair's events have no local BA; the rest are the tracker's
    # keyframes
    events = mapper.event_ms[2:]
    return dict(frames=len(gt_xy), init_frame=first, tracked=tracked, lost_after_init=lost,
                ate_m=ate, sim3_scale=scale, keyframes_inserted=md._next_keyfrm_id,
                keyframes_kept=md.num_keyframes(), landmarks=md.num_landmarks(),
                local_bas=len(slam.local_ba_ms),
                frame_ms=_pcts(frame_ms[first + 1:]),
                keyframe_event_ms=_pcts([e["total"] for e in events]),
                keyframe_event_phase_ms={k: _pcts([e[k] for e in events])
                                         for k in EVENT_PHASES},
                local_ba_ms=_pcts(slam.local_ba_ms), launches=dict(launches))


def run_slice(device, world: PlaneWorld, n_frames: int = 500, step: float = 0.015,
              profile_window=None, slam: System | None = None):
    """Feed n_frames with every launch count at 0 first; returns the
    statistics dict. `profile_window` (start, stop) traces those frames
    with torch.profiler and adds the breakdown under "profile"; `slam` is
    the System to drive (make_system's, fresh, by default)."""
    wrappers = kernel_wrappers()
    if slam is None:
        slam = make_system(world, device)
    for w in wrappers.values():
        w.launches = 0
    gt_xy = [(i * step, 0.0) for i in range(n_frames)]
    frame_ms, event_frames, prof = [], [], None
    mapper = slam.mapper
    for i, (x, y) in enumerate(gt_xy):
        img = world.render(pose_at_xy(x, y))
        if profile_window and i == profile_window[0]:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        n_events = len(mapper.event_ms)
        t0 = time.perf_counter()
        slam.feed_monocular_frame(img, i * 0.05)
        _sync(device)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if len(mapper.event_ms) > n_events:
            event_frames.append(i)
        if prof is not None and i == profile_window[1] - 1:
            prof.__exit__(None, None, None)
            window_ms = sum(frame_ms[profile_window[0]:])
            n = profile_window[1] - profile_window[0]
            prof = _summarize(prof, window_ms, n)
            prof["keyframe_event_frames"] = [f for f in event_frames
                                             if profile_window[0] <= f < profile_window[1]]
            prof["host_event_ms"] = [mapper.event_ms[event_frames.index(f)]
                                     for f in prof["keyframe_event_frames"]]
    slam.shutdown()
    stats = slice_stats(slam, gt_xy, frame_ms, {k: w.launches for k, w in wrappers.items()})
    if profile_window:
        stats["profile"] = prof
    return stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("map_slice: needs a CUDA GPU")
    stats = run_slice(torch.device("cuda", 0), bench_world(), args.frames,
                      profile_window=(100, 130) if args.profile else None)
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
