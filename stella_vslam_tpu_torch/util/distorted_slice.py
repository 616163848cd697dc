"""Drive the monocular slice through a fisheye and a radial-division camera.

The configuration is the mono slice's (util/mono_slice.py, bench.py's mono
leg): the photo-hardened plane world at 752x480, fx = fy = 458, 8 ORB
levels, min_size 800 (2872 slots), Initializer use_fixed_seed, the first
120 frames of the outbound path (0.015 m a frame); here through the
default `System(cfg)` (threaded, mapping and the loop detector on), warm,
fed as fast as the feed returns. Each leg renders the world through its
camera (util/synthetic.DistortedPlaneWorld, no cv2): the Kannala-Brandt
fisheye with the JAX package's end-to-end coefficients (FISH_D) and the
division model (RADIAL_K1), and a third leg, the fisheye with a vignette
mask (the pixels beyond MASK_RADIUS of the principal point, the image's
corners, excluded, as fisheye rigs mask theirs). The legs run kernel R's
Kannala-Brandt and division modes on every frame and no
radial-tangential undistortion, kernel A (with the mask on the masked
leg), the bearing-vector initializer (E-RANSAC on kernel E) and the
perspective family of D, F-I, K and L on the undistorted keypoints.
Users: TUM-VI-class fisheye rigs (the reference ships example/tum_vi) and
wide-angle robot cameras calibrated with the division model.

    python -m stella_vslam_tpu_torch.util.distorted_slice [--leg fisheye|radial_division|fisheye_masked]

prints each leg's statistics as JSON: frames tracked and lost after init,
the init frame, the Sim3 ATE, keyframes created and kept, local BAs, frame
time p50 / p99 / max (host clock around each feed, after the init frame),
kernel launches (with A's masked launches), the worker threads' contained
exceptions and what was left at shutdown. It needs a CUDA GPU;
chip_smoke.py runs the same legs and asserts GATES.
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
from stella_vslam_tpu_torch.util.equirect_slice import trajectory_stats
from stella_vslam_tpu_torch.util.rgbd_slice import bench_world
from stella_vslam_tpu_torch.util.synthetic import DistortedPlaneWorld

LEGS = ("fisheye", "radial_division", "fisheye_masked")
# each leg's camera model
MODEL = {"fisheye": "fisheye", "radial_division": "radial_division",
         "fisheye_masked": "fisheye"}
# init by frame 10, at most 2 frames lost after it, Sim3 ATE under 0.10 m
GATES = dict(init_frame=10, lost_after_init=2, ate_m=0.10)
# the masked leg's vignette: pixels farther than this from the principal
# point, the image's corners, are excluded. The 752x480 image's
# half-diagonal is 446 px, and the farthest pixel kernel A scores at level
# 0 (inside the 19 px border) lies 418.5 px from the principal point, so
# the mask removes pixels A would score.
MASK_RADIUS = 400.0
# the gates a leg misses as an open fault (ROADMAP Queue 3); check_gates
# reports these and holds every other gate. None since the Initializer
# draws the JAX package's seed stream: the masked leg then initializes at
# frame 10 with a sound scale, as the JAX package does (with other seeds
# both packages accept a degenerate two-view solution alike).
OPEN_GATES = {}


def leg_world(leg: str, world=None) -> DistortedPlaneWorld:
    return DistortedPlaneWorld(bench_world() if world is None else world, MODEL[leg])


def leg_path(n_frames: int = 120, step: float = 0.015):
    """The mono slice's outbound path: (x, y) of each frame."""
    return [(i * step, 0.0) for i in range(n_frames)]


def leg_mask(leg: str, world) -> np.ndarray | None:
    """The masked leg's vignette mask [H,W] uint8 (0 = excluded); None for
    the other legs."""
    if leg != "fisheye_masked":
        return None
    v, u = np.mgrid[0:world.H, 0:world.W].astype(np.float64)
    return (np.hypot(u - world.cx, v - world.cy) <= MASK_RADIUS).astype(np.uint8)


def make_system(world: DistortedPlaneWorld, device, inline_mapping: bool = False,
                num_levels: int = 8, min_size: int = 800) -> System:
    cfg = Config.from_dict({
        "Camera": world.camera_yaml(),
        "Feature": {"num_levels": num_levels},
        "Preprocessing": {"min_size": min_size},
        "Initializer": {"use_fixed_seed": True},
    })
    slam = System(cfg, device=device, inline_mapping=inline_mapping)
    slam.startup()
    return slam


def run_leg(device, leg: str, world: DistortedPlaneWorld | None = None, path=None,
            slam: System | None = None, mask="leg") -> dict:
    """Feed one leg with every launch count at 0 first; returns the
    statistics dict. `world`: the distorted world (leg_world's by
    default); `path`: (x, y) per frame (leg_path's by default); `slam`: the
    System to drive (make_system's by default); `mask`: the extraction
    mask fed with every frame ("leg": leg_mask's)."""
    from stella_vslam_tpu_torch.feature import orb_extractor as ox

    world = leg_world(leg) if world is None else world
    path = leg_path() if path is None else path
    mask = leg_mask(leg, world) if isinstance(mask, str) else mask
    slam = make_system(world, device) if slam is None else slam
    wrappers = map_slice.kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    ox.fast_nms_pyramid.masked_launches = 0
    frame_ms = []
    t_run = time.perf_counter()
    for i, (x, y) in enumerate(path):
        img = world.render(pose_at_xy(x, y))  # the render is excluded from the frame time
        t0 = time.perf_counter()
        slam.feed_monocular_frame(img, i * 0.05, mask)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    slam.shutdown()
    wall_s = time.perf_counter() - t_run
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["fast_nms_pyramid_masked"] = ox.fast_nms_pyramid.masked_launches
    md, mapper, go = slam.map_db, slam.mapper, slam.global_optimizer
    centres = [(x, y, 0.0) for x, y in path]
    stats = trajectory_stats(slam.frame_poses, centres)
    steady = frame_ms[stats["init_frame"] + 1:]
    return dict(
        leg=leg, model=MODEL[leg], frames=len(path), masked=mask is not None, **stats,
        keyframes_created=mapper.num_processed, keyframes_kept=md.num_keyframes(),
        landmarks=md.num_landmarks(), local_bas=len(mapper.local_ba_ms),
        local_ba_skips=mapper.num_local_ba_skips, loops_closed=go.num_loops_closed,
        init_escalations=slam.tracker.initializer.num_escalations,
        frame_ms=map_slice._pcts(steady), wall_s=wall_s, frames_per_wall_s=len(path) / wall_s,
        fps=1e3 / float(np.mean(steady)) if steady else None,
        worker_errors=slam.worker_errors,
        stranded=dict(staged_event=mapper._event is not None,
                      queued=mapper._queue.qsize(), pending_ba=mapper._pending_ba is not None,
                      loop_queue=go._queue.qsize()),
        launches=launches)


def check_gates(stats: dict) -> list:
    """Initialized by frame 10, at most 2 frames lost after it, Sim3 ATE
    under 0.10 m, a clean shutdown with no contained exception, and kernel
    R in the leg's own mode only (on the card; the CPU counts nothing).
    The leg's OPEN_GATES are not asserted: returns the messages of those
    it misses (it must still initialize)."""
    leg = stats["leg"]
    open_gates = OPEN_GATES.get(leg, ())
    assert stats["worker_errors"] == 0, f"{leg}: a worker thread contained an exception"
    assert stats["init_frame"] is not None, f"{leg}: never initialized"
    missed = []
    for gate, ok, msg in (
            ("init_frame", stats["init_frame"] <= GATES["init_frame"],
             f"{leg}: init at {stats['init_frame']} (gate {GATES['init_frame']})"),
            ("ate_m", stats["ate_m"] < GATES["ate_m"],
             f"{leg}: Sim3 ATE {stats['ate_m']:.4f} m (gate {GATES['ate_m']} m)")):
        if gate in open_gates:
            missed += [] if ok else [msg]
        else:
            assert ok, msg
    assert stats["lost_after_init"] <= GATES["lost_after_init"], \
        f"{leg}: {stats['lost_after_init']} frames lost after init"
    st = stats["stranded"]
    assert not st["staged_event"] and st["queued"] == 0 and not st["pending_ba"] \
        and st["loop_queue"] == 0, f"{leg}: work left at shutdown: {st}"
    return missed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=LEGS, default=None)
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("distorted_slice: needs a CUDA GPU")
    for leg in ([args.leg] if args.leg else LEGS):
        stats = run_leg(torch.device("cuda", 0), leg, path=leg_path(args.frames))
        print(json.dumps(stats, indent=1))
        for msg in check_gates(stats):
            print(f"open fault, gate missed: {msg}")


if __name__ == "__main__":
    main()
