"""Drive the threaded System over the bench's circuit and measure it.

The configuration is the whole of bench.py's mono leg (main, bench.py:261-444)
as the bench runs it: the default `System(cfg)` — pipelined tracker with its
finalize thread, the mapping thread, the loop-closing thread with the loop
BA detached — started warm, fed as fast as `feed_monocular_frame` returns
(no synchronisation between frames). The world, the 1290-frame circuit and
the drift injected after the outbound leg are util/loop_slice.py's; the
mapper is paused for the injection, as the bench does.

    python -m stella_vslam_tpu_torch.util.threaded_slice

prints the statistics as JSON: frames tracked and lost after init, the Sim3
ATE over all 1290 frames, keyframes created and kept, local BAs run and
skipped (backpressure, stride), loops closed with each loop event's phases
as the loop-closing threads timed them, keyframe-event phases as the
mapping thread timed them, frame time p50 / p99 / max (host clock around
each feed), table publishes, on-device chain rebases (a publish that lands
while a frame is in flight) and drain fallbacks, the caller's waits
on the pipeline bounds, the worker threads' contained exceptions, what was
left at shutdown, and kernel launches. It needs a CUDA GPU; chip_smoke.py
runs the same slice and asserts its bounds.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from stella_vslam_tpu_torch.global_optimization_module import LOOP_PHASES
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util import map_slice
from stella_vslam_tpu_torch.util.drift import inject_segment_drift, pose_at_xy
from stella_vslam_tpu_torch.util.loop_slice import DRIFT, N_OUT, circuit
from stella_vslam_tpu_torch.util.mono_slice import sim3_align, trajectory_stats
from stella_vslam_tpu_torch.util.perf import PERF
from stella_vslam_tpu_torch.util.rgbd_slice import bench_world
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld

# the keyframe-event phases the mapping thread times (fetch: the deferred
# reads of the event's device results)
EVENT_PHASES = ("cull", "triangulation", "fusion", "fetch", "apply", "local_ba",
                "cull_publish")


def erased_forward_diagnostic(slam: System, gt_xy) -> dict:
    """Where a circuit's ATE comes from: the per-frame error after the
    Sim3 alignment of the whole trajectory, as rms per leg (out, turn, back,
    approach), and over the frames whose reference keyframe was culled (their
    poses hang off a live keyframe through `erased_kf_forward`) with the
    hops of that chain."""
    md = slam.map_db
    poses = slam.frame_poses
    fid0 = poses[0][3]
    idx, est, gt, hops = [], [], [], []
    for (_, pose, ref, fid) in poses:
        if pose is None:
            continue
        i = fid - fid0
        idx.append(i)
        est.append(-pose[:3, :3].T @ pose[:3, 3])
        gt.append([gt_xy[i][0], gt_xy[i][1], 0.0])
        n, cur, seen = 0, ref, set()
        while cur is not None and cur not in md.keyframes and cur in md.erased_kf_forward \
                and cur not in seen:
            seen.add(cur)
            cur = md.erased_kf_forward[cur][0]
            n += 1
        hops.append(n)
    gt, idx, hops = np.asarray(gt), np.asarray(idx), np.asarray(hops)
    err = np.linalg.norm(sim3_align(np.asarray(est), gt)[0] - gt, axis=1)
    rms = lambda m: float(np.sqrt(np.mean(err[m] ** 2))) if m.any() else None
    legs = dict(out=(0, N_OUT), turn=(N_OUT, N_OUT + 100), back=(N_OUT + 100, N_OUT + 570),
                approach=(N_OUT + 570, len(gt_xy)))
    culled = hops > 0
    return dict(leg_rms_m={k: rms((idx >= a) & (idx < b)) for k, (a, b) in legs.items()},
                culled_ref_frames=int(culled.sum()), culled_ref_rms_m=rms(culled),
                live_ref_rms_m=rms(~culled),
                forward_hops=dict(p50=float(np.median(hops[culled])) if culled.any() else 0.0,
                                  max=int(hops.max())))


def make_system(world: PlaneWorld, device) -> System:
    return map_slice.make_system(world, device, loop_detector=True, inline_mapping=False)


def run_slice(device, world: PlaneWorld, gt_xy=None, n_out: int = N_OUT, drift=None,
              slam: System | None = None, on_frame=None):
    """Feed the circuit with every launch count at 0 first; returns the
    statistics dict. `gt_xy`, `n_out` and `drift` default to the bench's
    circuit, its 500 outbound frames and its drift; `slam` is the System to
    drive (make_system's, fresh, by default); `on_frame(i)` is called before
    frame i is fed."""
    wrappers = map_slice.kernel_wrappers()
    if slam is None:
        slam = make_system(world, device)
    gt_xy = circuit() if gt_xy is None else gt_xy
    drift = DRIFT if drift is None else drift
    for w in wrappers.values():
        w.launches = 0
    PERF.reset()
    frame_ms = []
    t_run = time.perf_counter()
    for i, (x, y) in enumerate(gt_xy):
        if i == n_out:
            # bench scaffolding, not timed: the drift the perfect renderer
            # cannot accumulate, injected with the mapper paused
            slam.pause_other_threads()
            inject_segment_drift(slam, **drift)
            slam.resume_other_threads()
        if on_frame is not None:
            on_frame(i)
        img = world.render(pose_at_xy(x, y))
        t0 = time.perf_counter()
        slam.feed_monocular_frame(img, i * 0.05)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    slam.shutdown()
    wall_s = time.perf_counter() - t_run
    launches = {k: w.launches for k, w in wrappers.items()}
    poses = slam.frame_poses
    first, tracked, lost, ate, scale = trajectory_stats(poses, gt_xy)
    md, mapper, go, tr = slam.map_db, slam.mapper, slam.global_optimizer, slam.tracker
    events = mapper.event_ms[2:]
    perf = PERF.snapshot()
    return dict(
        frames=len(gt_xy), init_frame=first, tracked=tracked, lost_after_init=lost,
        ate_m=ate, sim3_scale=scale, keyframes_created=mapper.num_processed,
        keyframes_kept=md.num_keyframes(), landmarks=md.num_landmarks(),
        local_bas=len(mapper.local_ba_ms), local_ba_skips=mapper.num_local_ba_skips,
        local_ba_stride_skips=mapper.num_local_ba_stride_skips,
        ba_opportunities=len(mapper.local_ba_ms) + mapper.num_local_ba_skips,
        loops_closed=go.num_loops_closed, loop_event_ms=go.loop_event_ms,
        loop_event_phase_ms={k: map_slice._pcts([e[k] for e in go.loop_event_ms])
                             for k in LOOP_PHASES + ("total",)},
        keyframe_event_ms=map_slice._pcts([e["total"] for e in events]),
        keyframe_event_phase_ms={k: map_slice._pcts([e.get(k, 0.0) for e in events])
                                 for k in EVENT_PHASES},
        local_ba_landed_ms=map_slice._pcts(mapper.local_ba_landed_ms),
        frame_ms=map_slice._pcts(frame_ms[first + 1:]),
        # bench.py's FPS (bench.py:352): 1 / mean feed time after 30 frames
        wall_s=wall_s, fps=1e3 / float(np.mean(frame_ms[30:])),
        frames_per_wall_s=len(gt_xy) / wall_s, publishes=md.device_table.version, rebases=tr.num_rebases,
        drain_fallbacks=tr.num_drain_fallbacks,
        feed_wait_s={k: dict(n=v[0], total=v[1], max=v[2])
                     for k, v in perf.items() if k.startswith("feed/wait")},
        worker_errors=slam.worker_errors,
        ate_breakdown=erased_forward_diagnostic(slam, gt_xy),
        stranded=dict(staged_event=mapper._event is not None,
                      queued=mapper._queue.qsize(), pending_ba=mapper._pending_ba is not None,
                      loop_queue=go._queue.qsize()),
        launches=launches)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("threaded_slice: needs a CUDA GPU")
    stats = run_slice(torch.device("cuda", 0), bench_world())
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
