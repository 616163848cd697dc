"""Run one of bench.py's threaded legs many times on one card, in parallel
processes, and check the leg's gates on every run.

    python scripts/torch_rgbd_leg_repeat.py [--leg rgbd|threaded|equirect|fbow] [--runs N]
        [--workers W]

RUNS runs (40 for the RGBD leg, 20 for the mono circuit, 48 for the
equirectangular leg, 16 for the FBoW leg) in WORKERS processes (or W:
fewer leave the host's cores to each run, as chip_smoke.py's one leg at a
time has them), a fresh System per run.
`--leg rgbd`: util/stereo_slice.py's
RGBD leg with mapping (640 frames, the default threaded System with mapping
and the loop detector) with its gates (stereo_slice.check_gates).
`--leg threaded`: util/threaded_slice.py's 1290-frame mono circuit (the
default threaded System, the bench's injected drift) with bench.py's mono
gates (util/bench.check_mono_gates). `--leg fbow`: util/fbow_slice.py's
leg, the same circuit on the fixture .fbow vocabulary, with its gates
(fbow_slice.check_gates); a run also reports its loops' keyframe pairs.
`--leg equirect`:
util/equirect_slice.py's 250-frame leg (the default threaded System) with
its gates (equirect_slice.check_gates). A run's nondeterminism comes from the
threads, so one run proves little. The images are rendered once and
shared: each worker's world hands back the stored image after sleeping the
measured mean render time, so the feed keeps the leg's pace while the
workers share the host's cores. Prints one JSON line per run (ATE, frames
lost, keyframes, loops; RGBD: the scale error and the largest camera-centre
error of any frame as it was finalized, with its frame; mono: the largest
per-frame error after the Sim3 alignment, with its frame, a run failing
when it exceeds OFF_M (the threaded leg), and for every frame beyond it the trace of its
relative pose: tracker.rel_trace and the keyframe frame_poses rebuilt it
on) and a last line
with the count of runs, of gate failures, the largest and median ATE and
the card's name and power limit. Per-frame errors of every mono run go to
{leg}_repeat_frames.json in chip_smoke.py's output directory (OUT_DIR).
Exits 1 when any run failed a gate. Needs a CUDA GPU.
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

from chip_smoke import OUT_DIR
from stella_vslam_tpu_torch.util import equirect_slice, fbow_slice, stereo_slice, threaded_slice
from stella_vslam_tpu_torch.util.bench import card, check_mono_gates
from stella_vslam_tpu_torch.util.drift import pose_at_xy
from stella_vslam_tpu_torch.util.loop_slice import circuit
from stella_vslam_tpu_torch.util.mono_slice import sim3_align
from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

RUNS = {"rgbd": 40, "threaded": 20, "equirect": 48, "fbow": 16}
WORKERS = 8
# a mono frame this far off after the alignment is reported with its trace
OFF_M = 0.10


def leg_path(leg: str):
    return stereo_slice.leg_path(640) if leg == "rgbd" else circuit()


def leg_world(leg: str):
    return equirect_slice.bench_world() if leg == "equirect" else bench_world()


def leg_poses(leg: str) -> list:
    """The camera-from-world poses the leg renders, in feed order."""
    if leg == "equirect":
        return list(equirect_slice.equirect_circle(250)[0])
    return [pose_at_xy(x, y) for (x, y) in leg_path(leg)]


class StoredWorld:
    """The leg's world with its images rendered once: render() waits the
    mean render time and returns the stored image of that pose."""

    def __init__(self, world, frames, render_s: float, poses):
        self._world, self._render_s = world, render_s
        self._frames = {np.asarray(T, np.float64).tobytes(): frames[i]
                        for i, T in enumerate(poses)}

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


def aligned_errors(slam, gt_xy):
    """Per frame in feed order, the camera-centre error (m) after the Sim3
    alignment of the whole trajectory (None where not tracked)."""
    poses = slam.frame_poses
    fid0 = poses[0][3]
    idx = [fid - fid0 for (_, p, _, fid) in poses if p is not None]
    est = np.array([-p[:3, :3].T @ p[:3, 3] for (_, p, _, _) in poses if p is not None])
    gt = np.array([[gt_xy[i][0], gt_xy[i][1], 0.0] for i in idx])
    aligned, _ = sim3_align(est, gt)
    err = [None] * len(gt_xy)
    for i, e in zip(idx, np.linalg.norm(aligned - gt, axis=1)):
        err[i] = float(e)
    return err


def rel_sources(slam) -> dict:
    """How many frames anchored their relative pose on each source."""
    counts = {}
    for src, *_ in slam.tracker.rel_trace.values():
        counts[str(src)] = counts.get(str(src), 0) + 1
    return counts


def watch_gauges(slam) -> list:
    """Record, by the id of the last dispatched frame, the map epoch and the
    table version: each loop correction, global-BA writeback and
    duplicate-layer merge as it starts and ends, and each chain resync and
    rebase (with whether it acted)."""
    tr, go, md = slam.tracker, slam.global_optimizer, slam.map_db
    log = []

    def mark(label, **kw):
        log.append(dict(label=label, frame=tr.last_frm.id if tr.last_frm is not None else -1,
                        epoch=md.epoch, version=md.device_table.version, **kw))

    def around(obj, name):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            mark(name + ":start")
            out = fn(*a, **k)
            mark(name + ":end")
            return out
        setattr(obj, name, wrapped)

    for name in ("correct_loop", "_apply_global_ba_result", "_merge_duplicate_layers"):
        around(go, name)
    resync, rebase = tr._resync_chain_with_map, tr._try_rebase_chain

    def resync_rec(last, snap):
        mark("resync", skipped=md.epoch != snap.epoch, snap_version=snap.version,
             snap_epoch=snap.epoch)
        return resync(last, snap)

    def rebase_rec(snap):
        ok = rebase(snap)
        mark("rebase", ok=ok, snap_version=snap.version)
        return ok

    tr._resync_chain_with_map, tr._try_rebase_chain = resync_rec, rebase_rec
    return log


def centre(T):
    return None if T is None else [float(v) for v in -T[:3, :3].T @ T[:3, 3]]


def rebuilt_on(md, ref):
    """The keyframe System.frame_poses rebuilds a frame with reference
    keyframe `ref` on, following the erased keyframes' forwards (None: the
    tracked pose is kept)."""
    cur, seen = ref, set()
    while (cur is not None and cur not in md.keyframes
           and cur in md.erased_kf_forward and cur not in seen):
        seen.add(cur)
        cur = md.erased_kf_forward[cur][0]
    kf = md.keyframes.get(cur)
    return cur if kf is not None and not kf.will_be_erased else None


def off_frames(slam, err, limit_m: float = OFF_M) -> list:
    """For every frame more than `limit_m` off after the alignment: the
    anchor of its relative pose, the map epoch of its dispatch table and at
    its finalize, its reference keyframe at finalize and at dispatch, and
    the keyframe frame_poses rebuilt it on (None: the tracked pose kept)."""
    fid0 = slam.tracker.finalized[0][0]
    resolved = {fid: (pose, rebuilt_on(slam.map_db, ref) if rel is not None else None)
                for (_, pose, ref, fid), (*_, rel) in zip(slam.frame_poses,
                                                          slam.tracker.finalized)}
    tracked = {fid: pose for (fid, _, pose, _, _) in slam.tracker.finalized}
    md = slam.map_db
    out = []
    for i, e in enumerate(err):
        if e is None or e <= limit_m:
            continue
        near = []
        for j in range(max(0, i - 3), min(len(err), i + 4)):
            src, ep_disp, ep_fin, ref, ref_disp, anchor = slam.tracker.rel_trace.get(
                fid0 + j, (None,) * 6)
            pose, via = resolved.get(fid0 + j, (None, None))
            kf = md.keyframes.get(via) if via is not None else None
            near.append(dict(frame=j, err_m=err[j], source=src, epoch_dispatch=ep_disp,
                             epoch_finalize=ep_fin, ref_kf=ref, ref_kf_dispatch=ref_disp,
                             rebuilt_on=via, tracked_centre=centre(tracked.get(fid0 + j)),
                             reported_centre=centre(pose), anchor_centre=centre(anchor),
                             ref_final_centre=centre(kf.pose_cw) if kf is not None else None))
        out.append(dict(frame=i, err_m=e, near=near))
    return out


def run_once(leg: str, dev, world, gt_xy, run: int) -> dict:
    if leg == "rgbd":
        slam = stereo_slice.make_system(world, dev, "RGBD")
        s = stereo_slice.run_leg(dev, world, "RGBD", slam=slam)
        worst, at = finalize_errors(slam, gt_xy)
        gates = stereo_slice.check_gates
        out = dict(scale_err=s["scale_err"], max_finalize_err_m=worst, at_frame=at)
    elif leg == "equirect":
        s = equirect_slice.run_leg(dev, world)
        gates = equirect_slice.check_gates
        out = dict(init_frame=s["init_frame"], tracked=s["tracked"],
                   keyframes_kept=s["keyframes_kept"], landmarks=s["landmarks"])
    else:
        fbow = leg == "fbow"
        slam = (fbow_slice if fbow else threaded_slice).make_system(world, dev)
        slam.tracker.rel_trace = {}
        gauges = watch_gauges(slam)
        s = (fbow_slice.run_leg if fbow else threaded_slice.run_slice)(dev, world, slam=slam)
        err = aligned_errors(slam, gt_xy)
        at = int(np.nanargmax([np.nan if e is None else e for e in err]))
        gates = fbow_slice.check_gates if fbow else check_mono_gates
        out = dict(keyframes_kept=s["keyframes_kept"], rebases=s["rebases"],
                   loop_pairs=[e.get("keyframes") for e in s["loop_event_ms"]],
                   sim3_scale=s["sim3_scale"], ate_breakdown=s["ate_breakdown"],
                   pose_graph=slam.global_optimizer._last_pose_graph_edges,
                   max_aligned_err_m=err[at], at_frame=at, frame_err_m=err,
                   rel_sources=rel_sources(slam), off_frames=off_frames(slam, err),
                   drain_fallbacks=s["drain_fallbacks"],
                   gauge_events=[g for g in gauges if g["label"] != "resync"
                                 or g["skipped"] or g["epoch"] > 0])
    try:
        gates(s)
        failed = None
    except AssertionError as e:
        failed = str(e)
    if failed is None and leg == "threaded" and out["max_aligned_err_m"] > OFF_M:
        failed = f"frame {at} reads {out['max_aligned_err_m']:.3f} m off"
    return dict(run=run, ate_m=s["ate_m"], lost_after_init=s["lost_after_init"],
                keyframes_created=s["keyframes_created"], local_bas=s["local_bas"],
                loops_closed=s["loops_closed"], fps=s["fps"],
                worker_errors=s["worker_errors"], failed=failed, **out)


def worker(leg: str, runs: list, frames_path: str, render_s: float, out_path: str) -> None:
    dev = torch.device("cuda", 0)
    gt_xy = leg_path(leg)
    world = StoredWorld(leg_world(leg), np.load(frames_path, mmap_mode="r"), render_s,
                        leg_poses(leg))
    for run in runs:
        rec = run_once(leg, dev, world, gt_xy, run)
        line = json.dumps(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "frame_err_m"}), flush=True)
        with open(out_path, "a") as f:
            f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=tuple(RUNS), default="rgbd")
    ap.add_argument("--runs", type=int, default=None)
    ap.add_argument("--workers", type=int, default=WORKERS)
    ap.add_argument("--worker-runs", help=argparse.SUPPRESS)
    ap.add_argument("--frames", help=argparse.SUPPRESS)
    ap.add_argument("--render-s", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_rgbd_leg_repeat: needs a CUDA GPU")
    if args.worker_runs is not None:
        worker(args.leg, [int(r) for r in args.worker_runs.split(",")], args.frames,
               args.render_s, args.out)
        return 0
    runs = args.runs or RUNS[args.leg]
    world = leg_world(args.leg)
    t = time.perf_counter()
    frames = np.stack([world.render(T) for T in leg_poses(args.leg)])
    render_s = (time.perf_counter() - t) / len(frames)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        np.save(path, frames)
        del frames
        # every kernel built once, before the workers look for the library
        stereo_slice.make_system(bench_world(), torch.device("cuda", 0), "RGBD").shutdown()
        out = os.path.join(tmp, "runs.jsonl")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--leg", args.leg, "--frames", path,
             "--render-s", str(render_s), "--out", out,
             "--worker-runs", ",".join(str(r) for r in range(w, runs, args.workers))])
            for w in range(min(args.workers, runs))]
        for p in procs:
            p.wait()
        with open(out) as f:
            lines = [json.loads(ln) for ln in f]
    if args.leg in ("threaded", "fbow"):
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"{args.leg}_repeat_frames.json"), "w") as f:
            json.dump(lines, f)
    failed = [r for r in lines if r["failed"]]
    print(json.dumps(dict(leg=args.leg, runs=len(lines), of=runs, failed=len(failed),
                          workers=args.workers,
                          render_s=render_s, card=card(),
                          max_ate_m=max((r["ate_m"] for r in lines), default=None),
                          max_frame_err_m=max((r.get("max_aligned_err_m", 0.0) for r in lines),
                                              default=None),
                          median_ate_m=float(np.median([r["ate_m"] for r in lines]))
                          if lines else None)))
    return 1 if failed or len(lines) != runs else 0


if __name__ == "__main__":
    sys.exit(main())
