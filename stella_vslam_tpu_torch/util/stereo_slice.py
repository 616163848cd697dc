"""Drive bench.py's stereo leg, or its RGBD leg with mapping, on the port.

The configurations are bench.py's stereo leg (run_stereo, bench.py:32-120)
and RGBD leg (run_rgbd, bench.py:186-258) as the bench runs them: the
photo-hardened plane world at EuRoC size (752x480, fx 458, plane at 4 m,
pixel noise sigma 2, +-6% exposure drift), 8 ORB levels, min_size 800
(2872 slots), Initializer use_fixed_seed, baseline 0.12 m; 640 frames, 400
out along x at 0.015 m per frame and 240 back on fresh rows (y = 0.8 m);
the default `System(cfg)` — threaded, mapping on, the loop detector on —
started warm and fed as fast as the feed returns. Stereo renders the right
image with the camera shifted by the baseline; RGBD feeds exact uint16
depth at TUM's factor 5000.

    python -m stella_vslam_tpu_torch.util.stereo_slice [--setup stereo|RGBD] [--frames N]

prints the leg's statistics as JSON: frames tracked and lost after init,
the rigid ATE and the scale error (stereo and depth fix the gauge: no
similarity fit), keyframe events by phase (as the mapping thread timed
them), local BAs, loops with their events, the rms error of each run of 80
frames after the alignment and the ground-truth place of each loop's
keyframes, frame time p50 / p99 / max (host clock around each feed), the
worker threads' contained exceptions, what was left at shutdown, and kernel
launches. It needs a CUDA GPU; chip_smoke.py and
util/bench.py run the same legs and assert the bench's gates (GATES).
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
from stella_vslam_tpu_torch.util.drift import pose_at_xy
from stella_vslam_tpu_torch.util.rgbd_slice import bench_world, trajectory_errors
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld
from stella_vslam_tpu_torch.util.threaded_slice import EVENT_PHASES

BASELINE = 0.12
DEPTH_FACTOR = 5000.0
# bench.py:114-117 (stereo) and :254-256 (RGBD)
GATES = dict(lost_after_init=8, scale_err=0.05, ate_m=0.10)


def leg_path(n_frames: int = 640):
    """400 frames out, 240 back on fresh rows (bench.py:68-70), cut to n_frames."""
    out_xy = [(i * 0.015, 0.0) for i in range(400)]
    back_xy = [(6.0 - i * 0.015, 0.8) for i in range(1, 241)]
    return (out_xy + back_xy)[:n_frames]


def make_system(world: PlaneWorld, device, setup: str) -> System:
    """The bench's default System for `setup` ("stereo" or "RGBD"), warm."""
    cam = world.camera_yaml()
    cam["setup"] = setup
    cam["focal_x_baseline"] = world.fx * BASELINE
    cfg = {"Camera": cam, "Feature": {"num_levels": 8}, "Initializer": {"use_fixed_seed": True}}
    if setup == "RGBD":
        cfg["Preprocessing"] = {"depthmap_factor": DEPTH_FACTOR}
    slam = System(Config.from_dict(cfg), device=device)
    slam.startup()
    return slam


def run_leg(device, world: PlaneWorld, setup: str = "stereo", n_frames: int = 640,
            slam: System | None = None):
    """Feed the leg with every launch count at 0 first; returns the
    statistics dict. `slam`: the System to drive (make_system's by default)."""
    wrappers = map_slice.kernel_wrappers()
    if slam is None:
        slam = make_system(world, device, setup)
    gt_xy = leg_path(n_frames)
    Tb = np.eye(4)
    Tb[0, 3] = -BASELINE
    depth_raw = np.full((world.H, world.W), int(world.depth * DEPTH_FACTOR), np.uint16)
    for w in wrappers.values():
        w.launches = 0
    frame_ms = []
    t_run = time.perf_counter()
    for i, (x, y) in enumerate(gt_xy):
        T = pose_at_xy(x, y)
        img = world.render(T)
        if setup == "stereo":
            right = world.render(Tb @ T)
            t0 = time.perf_counter()
            slam.feed_stereo_frame(img, right, i * 0.05)
        else:
            t0 = time.perf_counter()
            slam.feed_RGBD_frame(img, depth_raw, i * 0.05)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    slam.shutdown()
    wall_s = time.perf_counter() - t_run
    launches = {k: w.launches for k, w in wrappers.items()}
    tracked, lost, ate, scale_err = trajectory_errors(slam.frame_poses, gt_xy)
    md, mapper, go = slam.map_db, slam.mapper, slam.global_optimizer
    events = mapper.event_ms
    return dict(
        setup=setup, frames=len(gt_xy), tracked=tracked, lost_after_init=lost, ate_m=ate,
        scale_err=scale_err, keyframes_created=mapper.num_processed,
        keyframes_kept=md.num_keyframes(), landmarks=md.num_landmarks(),
        local_bas=len(mapper.local_ba_ms), local_ba_skips=mapper.num_local_ba_skips,
        loops_closed=go.num_loops_closed, loop_event_ms=go.loop_event_ms,
        error_by_section=section_rms(slam, gt_xy),
        keyframe_event_ms=map_slice._pcts([e["total"] for e in events]),
        keyframe_event_phase_ms={k: map_slice._pcts([e.get(k, 0.0) for e in events])
                                 for k in EVENT_PHASES},
        # the first frames carry one-time set-up; bench.py's FPS skips 30
        frame_ms=map_slice._pcts(frame_ms[30:]), first_frames_ms=frame_ms[:3],
        # bench.py's FPS (bench.py:85, :228): 1 / mean feed time after 30 frames
        wall_s=wall_s, fps=1e3 / float(np.mean(frame_ms[30:])),
        frames_per_wall_s=len(gt_xy) / wall_s, worker_errors=slam.worker_errors,
        stranded=dict(staged_event=mapper._event is not None,
                      queued=mapper._queue.qsize(), pending_ba=mapper._pending_ba is not None,
                      loop_queue=go._queue.qsize()),
        launches=launches)


def section_rms(slam: System, gt_xy, n: int = 80):
    """Where the error sits: after the rigid alignment of the whole
    trajectory, the rms error of each run of n frames (feed order), and the
    ground-truth place of each loop's keyframes (None when culled)."""
    poses = slam.frame_poses
    fid0 = poses[0][3]
    idx = np.array([fid - fid0 for (_, p, _, fid) in poses if p is not None])
    est = np.array([-p[:3, :3].T @ p[:3, 3] for (_, p, _, _) in poses if p is not None])
    gt = np.array([[gt_xy[i][0], gt_xy[i][1], 0.0] for i in idx])
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    err = np.linalg.norm((U @ D @ Vt @ (est - mu_e).T).T + mu_g - gt, axis=1)
    rms = [float(np.sqrt(np.mean(err[(idx >= a) & (idx < a + n)] ** 2)))
           for a in range(0, len(gt_xy), n) if ((idx >= a) & (idx < a + n)).any()]
    md = slam.map_db
    place = lambda k: gt_xy[md.keyframes[k].src_frm_id - fid0] if k in md.keyframes else None
    loops = [[place(k) for k in e.get("keyframes", ())]
             for e in slam.global_optimizer.loop_event_ms]
    return dict(rms_m=rms, loop_keyframe_places=loops)


def check_gates(stats: dict):
    """bench.py's gates for the leg, and at least one keyframe event and a
    clean shutdown."""
    name = stats["setup"]
    assert stats["worker_errors"] == 0, f"{name}: a worker thread contained an exception"
    assert stats["lost_after_init"] <= GATES["lost_after_init"], \
        f"{name}: {stats['lost_after_init']} frames lost after init"
    assert stats["scale_err"] < GATES["scale_err"], f"{name}: scale error {stats['scale_err']:.2%}"
    assert stats["ate_m"] < GATES["ate_m"], f"{name}: rigid ATE {stats['ate_m']:.4f} m"
    assert stats["keyframes_created"] >= 1, f"{name}: no keyframe event"
    st = stats["stranded"]
    assert not st["staged_event"] and st["queued"] == 0 and not st["pending_ba"] \
        and st["loop_queue"] == 0, f"{name}: work left at shutdown: {st}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--setup", choices=("stereo", "RGBD"), default="stereo")
    ap.add_argument("--frames", type=int, default=640)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stereo_slice: needs a CUDA GPU")
    stats = run_leg(torch.device("cuda", 0), bench_world(), args.setup, args.frames)
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
