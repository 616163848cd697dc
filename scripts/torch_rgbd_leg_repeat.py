"""Run bench.py's RGBD leg with mapping many times on one card, in parallel
processes, and check the leg's gates on every run.

    python scripts/torch_rgbd_leg_repeat.py

RUNS runs in WORKERS processes. Each run is util/stereo_slice.py's RGBD
leg (640 frames, the default threaded System with mapping and the loop
detector, a fresh System per run) with its gates (stereo_slice.check_gates).
The run's nondeterminism comes from the threads, so one run proves little.
The 640 images are rendered once and shared: each worker's world hands back
the stored image after sleeping the measured mean render time, so the feed
keeps the leg's pace while the workers share the host's cores. Prints one
JSON line per run (rigid ATE, scale error, frames lost, keyframes, loops,
the largest camera-centre error of any frame as it was finalized, and the
frame where it sat) and a last line with the count of runs, of gate
failures, the largest ATE and the card's name and power limit. Exits 1
when any run failed a gate. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from stella_vslam_tpu_torch.util import stereo_slice
from stella_vslam_tpu_torch.util.bench import card
from stella_vslam_tpu_torch.util.drift import pose_at_xy
from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

RUNS = 40
WORKERS = 8


class StoredWorld:
    """The bench world with its images rendered once: render() waits the
    mean render time and returns the stored image of that pose."""

    def __init__(self, world, frames, render_s: float):
        self._world, self._render_s = world, render_s
        self._frames = {pose_at_xy(x, y).tobytes(): frames[i]
                        for i, (x, y) in enumerate(stereo_slice.leg_path(len(frames)))}

    def __getattr__(self, name):
        return getattr(self._world, name)

    def render(self, pose_cw):
        time.sleep(self._render_s)
        return np.array(self._frames[np.asarray(pose_cw, np.float64).tobytes()])


def finalize_errors(slam, gt_xy):
    """Largest camera-centre error (m) of any frame at its finalize, and that
    frame's index in feed order: where the tracking went wrong, with no
    alignment (RGBD fixes the gauge at the first frame, which is at the
    origin)."""
    worst, at = 0.0, -1
    for _, ts, pose, _, _ in slam.tracker.finalized:
        if pose is None:
            continue
        i = int(round(ts / 0.05))
        c = -pose[:3, :3].T @ pose[:3, 3]
        e = float(np.linalg.norm(c - [gt_xy[i][0], gt_xy[i][1], 0.0]))
        if e > worst:
            worst, at = e, i
    return worst, at


def worker(runs: list, frames_path: str, render_s: float, out_path: str) -> None:
    dev = torch.device("cuda", 0)
    world = StoredWorld(bench_world(), np.load(frames_path, mmap_mode="r"), render_s)
    gt_xy = stereo_slice.leg_path(640)
    for run in runs:
        slam = stereo_slice.make_system(world, dev, "RGBD")
        s = stereo_slice.run_leg(dev, world, "RGBD", slam=slam)
        worst, at = finalize_errors(slam, gt_xy)
        try:
            stereo_slice.check_gates(s)
            failed = None
        except AssertionError as e:
            failed = str(e)
        line = json.dumps(dict(
            run=run, ate_m=s["ate_m"], scale_err=s["scale_err"],
            lost_after_init=s["lost_after_init"], keyframes_created=s["keyframes_created"],
            local_bas=s["local_bas"], loops_closed=s["loops_closed"],
            max_finalize_err_m=worst, at_frame=at, fps=s["fps"], failed=failed))
        print(line, flush=True)
        with open(out_path, "a") as f:
            f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker-runs", help=argparse.SUPPRESS)
    ap.add_argument("--frames", help=argparse.SUPPRESS)
    ap.add_argument("--render-s", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_rgbd_leg_repeat: needs a CUDA GPU")
    if args.worker_runs is not None:
        worker([int(r) for r in args.worker_runs.split(",")], args.frames, args.render_s,
               args.out)
        return 0
    world = bench_world()
    t = time.perf_counter()
    frames = np.stack([world.render(pose_at_xy(x, y)) for (x, y) in stereo_slice.leg_path(640)])
    render_s = (time.perf_counter() - t) / len(frames)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        np.save(path, frames)
        # every kernel built once, before the workers look for the library
        stereo_slice.make_system(world, torch.device("cuda", 0), "RGBD").shutdown()
        out = os.path.join(tmp, "runs.jsonl")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--frames", path,
             "--render-s", str(render_s), "--out", out,
             "--worker-runs", ",".join(str(r) for r in range(w, RUNS, WORKERS))])
            for w in range(WORKERS)]
        for p in procs:
            p.wait()
        with open(out) as f:
            lines = [json.loads(ln) for ln in f]
    failed = [r for r in lines if r["failed"]]
    print(json.dumps(dict(runs=len(lines), of=RUNS, failed=len(failed),
                          render_s=render_s, card=card(),
                          max_ate_m=max((r["ate_m"] for r in lines), default=None),
                          median_ate_m=float(np.median([r["ate_m"] for r in lines]))
                          if lines else None)))
    return 1 if failed or len(lines) != RUNS else 0


if __name__ == "__main__":
    sys.exit(main())
