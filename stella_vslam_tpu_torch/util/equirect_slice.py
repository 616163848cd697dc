"""Drive bench.py's equirectangular leg on the port.

The configuration is bench.py's equirectangular leg (run_equirect,
bench.py:123-183) as the bench runs it: the ray-cast textured box room
(`BoxWorld(width=640, height=320, half=4.0)`, util/synthetic.py), 6 ORB
levels, the default min_size 800, Initializer use_fixed_seed; 250 frames on
a circle of radius 1.8 m yawing 0.01 rad a frame (bench.py:141-150); the
default `System(cfg)` (threaded, mapping and the loop detector on), started
warm and fed as fast as the feed returns. The bearing-vector initializer
(E-RANSAC on kernel E, on escalation the 5-point sets of kernel U) starts
the map; tracking, mapping and bundle adjustment run the equirectangular
modes of kernels R, D, K, L and F-I.

    python -m stella_vslam_tpu_torch.util.equirect_slice [--frames N]

prints the leg's statistics as JSON: frames tracked and lost after init,
the init frame, the Sim3 ATE (Umeyama with scale, as bench.py aligns),
frame time p50 / p99 / max (host clock around each feed, after the first
20 frames as bench.py's FPS takes them) and that FPS, keyframes created
and kept, local BAs, loops closed, whether the initializer escalated,
kernel launches, the worker threads' contained exceptions and what was
left at shutdown. It needs a CUDA GPU; chip_smoke.py and util/bench.py run
the same leg and assert the bench's gates (GATES).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util import map_slice
from stella_vslam_tpu_torch.util.mono_slice import sim3_ate
from stella_vslam_tpu_torch.util.synthetic import BoxWorld, equirect_circle

# bench.py:176-179
GATES = dict(lost_after_init=10, ate_m=0.10)
# bench.py's FPS skips the first frames (bench.py:162)
STEADY_FROM = 20


def bench_world() -> BoxWorld:
    """bench.py's equirectangular world (bench.py:133)."""
    return BoxWorld(width=640, height=320, half=4.0)


def make_system(world: BoxWorld, device, inline_mapping: bool = False,
                num_levels: int = 6, min_size=None) -> System:
    """bench.py's equirectangular System, warm (`min_size` None keeps the
    default, 800)."""
    cfg = {"Camera": world.camera_yaml(), "Feature": {"num_levels": num_levels},
           "Initializer": {"use_fixed_seed": True}}
    if min_size is not None:
        cfg["Preprocessing"] = {"min_size": min_size}
    slam = System(Config.from_dict(cfg), device=device, inline_mapping=inline_mapping)
    slam.startup()
    return slam


def run_leg(device, world: BoxWorld | None = None, poses=None, centres=None,
            slam: System | None = None) -> dict:
    """Feed the leg with every launch count at 0 first; returns the
    statistics dict. `poses` / `centres`: the camera-from-world poses and
    camera centres to feed (bench.py's 250-frame circle by default);
    `slam`: the System to drive (make_system's by default)."""
    wrappers = map_slice.kernel_wrappers()
    world = bench_world() if world is None else world
    if poses is None:
        poses, centres = equirect_circle(250)
    if slam is None:
        slam = make_system(world, device)
    init = slam.tracker.initializer
    esc0 = init.num_escalations
    for w in wrappers.values():
        w.launches = 0
    frame_ms = []
    t_run = time.perf_counter()
    for i, T in enumerate(poses):
        img = world.render(T)  # the render is excluded from the frame time
        t0 = time.perf_counter()
        slam.feed_monocular_frame(img, i * 0.05)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    slam.shutdown()
    wall_s = time.perf_counter() - t_run
    launches = {k: w.launches for k, w in wrappers.items()}
    md, mapper, go = slam.map_db, slam.mapper, slam.global_optimizer
    steady = frame_ms[STEADY_FROM:]
    return dict(
        frames=len(poses), **trajectory_stats(slam.frame_poses, centres),
        keyframes_created=mapper.num_processed,
        keyframes_kept=md.num_keyframes(), landmarks=md.num_landmarks(),
        local_bas=len(mapper.local_ba_ms), local_ba_skips=mapper.num_local_ba_skips,
        loops_closed=go.num_loops_closed,
        init_escalations=init.num_escalations - esc0,
        keyframe_event_ms=map_slice._pcts([e["total"] for e in mapper.event_ms]),
        frame_ms=map_slice._pcts(steady), first_frames_ms=frame_ms[:3],
        # bench.py's FPS (bench.py:162-163): 1 / mean feed time after 20 frames
        fps=1e3 / float(np.mean(steady)) if steady else None, wall_s=wall_s,
        frames_per_wall_s=len(poses) / wall_s, worker_errors=slam.worker_errors,
        stranded=dict(staged_event=mapper._event is not None,
                      queued=mapper._queue.qsize(), pending_ba=mapper._pending_ba is not None,
                      loop_queue=go._queue.qsize()),
        launches=launches)


def trajectory_stats(frame_poses, centres) -> dict:
    """The init frame, frames tracked and lost after init, and the Sim3 ATE
    and scale of a System's `frame_poses` ((stamp, pose or None, _, frame
    id) per frame, the JAX package's form too) against the camera centres."""
    fid0 = frame_poses[0][3]
    first = next(i for i, (_, p, _, _) in enumerate(frame_poses) if p is not None)
    lost = sum(1 for (_, p, _, _) in frame_poses[first:] if p is None)
    est = np.array([-p[:3, :3].T @ p[:3, 3] for (_, p, _, _) in frame_poses if p is not None])
    gt = np.array([centres[fid - fid0] for (_, p, _, fid) in frame_poses if p is not None])
    if not np.all(np.isfinite(est)):
        raise ValueError("non-finite camera centre")
    ate, scale = sim3_ate(est, gt)
    return dict(init_frame=first, tracked=len(est), lost_after_init=lost, ate_m=ate,
                sim3_scale=scale)


def check_gates(stats: dict):
    """bench.py's gates (at most 10 frames lost after init, Sim3 ATE under
    0.10 m), and a clean shutdown with no contained exception."""
    assert stats["worker_errors"] == 0, "equirect: a worker thread contained an exception"
    assert stats["lost_after_init"] <= GATES["lost_after_init"], \
        f"equirect: {stats['lost_after_init']} frames lost after init"
    assert stats["ate_m"] < GATES["ate_m"], f"equirect: Sim3 ATE {stats['ate_m']:.4f} m"
    st = stats["stranded"]
    assert not st["staged_event"] and st["queued"] == 0 and not st["pending_ba"] \
        and st["loop_queue"] == 0, f"equirect: work left at shutdown: {st}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=250)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("equirect_slice: needs a CUDA GPU")
    poses, centres = equirect_circle(250)
    stats = run_leg(torch.device("cuda", 0), poses=poses[:args.frames],
                    centres=centres[:args.frames])
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
