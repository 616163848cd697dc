"""Drive the loop-closing slice on the bench's circuit and measure it.

The configuration is the whole of bench.py's mono leg (main, bench.py:261-444)
with mapping and the loop detector enabled, inline: the photo-hardened plane
world at EuRoC size (752x480, fx 458, plane at 4 m, pixel noise sigma 2, +-6%
exposure drift), 8 ORB levels, min_size 800 (2872 slots), Initializer
use_fixed_seed, table capacity 4096. The circuit (bench.py:301-345): 500
frames out along y = 0 to x = 7.49 m (the map slice), then the odometric
drift the perfect renderer cannot accumulate is injected
(`inject_segment_drift(tx_metric=0.50, yaw_deg=2.5, cutoff_frac=0.2,
gt_span_metric=7.5)`: the start region's segment of the map moves by 0.5 m
and 2.5 degrees of yaw, with the observations across the seam severed), a
100-frame turn up to y = 1.4, the 470-frame return to x = 0.45 and a
220-frame slow diagonal approach through the drifted start region, 1290
frames in all. Only the loop closer can stitch the seam: BoW candidates of
every new keyframe (kernel M), validation (kernels C, N, D, O), correction
and fusion (kernel L), the Sim3 pose graph (kernel P) and a global bundle
adjustment (kernels F-I at the global shape).

    python -m stella_vslam_tpu_torch.util.loop_slice [--profile]

prints the statistics as JSON: under "map_slice" what util/map_slice.py
prints, taken at frame 500 before the drift is injected; for the whole
circuit the frames tracked and lost after init, the Sim3 ATE over all 1290
frames, keyframes created and kept, loops closed with each loop event's time
by phase (detect, validate, correct, pose graph, global BA, merge) and the
keyframe pair, the loop edges in the graph, whether the frame after each
correction tracked, the shapes of the last pose graph and global BA, frame
time p50 / p99 / max, and kernel launches. With --profile, a torch.profiler
breakdown of the frame that closes the first loop is added. It needs a CUDA
GPU; chip_smoke.py runs the same slice and asserts its bounds.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from stella_vslam_tpu_torch.global_optimization_module import LOOP_PHASES
from stella_vslam_tpu_torch.ops.optim import ba as ba_mod
from stella_vslam_tpu_torch.ops.optim import sim3 as sim3_opt
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util import map_slice
from stella_vslam_tpu_torch.util.drift import inject_segment_drift, pose_at_xy
from stella_vslam_tpu_torch.util.mono_slice import trajectory_stats
from stella_vslam_tpu_torch.util.rgbd_slice import _summarize, _sync, bench_world
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld

N_OUT = 500  # the outbound leg: the map slice
DRIFT = dict(tx_metric=0.50, yaw_deg=2.5, cutoff_frac=0.2, gt_span_metric=7.5)


def circuit():
    """The bench's rectangular circuit as (x, y) per frame: out, turn, back,
    slow approach."""
    out_xy = [(i * 0.015, 0.0) for i in range(N_OUT)]  # x: 0 -> 7.49
    turn_xy = [(7.5, i * 0.014) for i in range(1, 101)]  # y: 0 -> 1.4
    back_xy = [(7.5 - i * 0.015, 1.4) for i in range(1, 471)]  # x: -> 0.45
    slow_xy = [(0.44 - i * 0.00625, max(0.0, 1.4 - i * 0.0065)) for i in range(220)]
    return out_xy + turn_xy + back_xy + slow_xy


def make_system(world: PlaneWorld, device) -> System:
    return map_slice.make_system(world, device, loop_detector=True)


def _loop_is_near(go) -> bool:
    """Whether the next keyframe's candidates could pass the continuity
    check: a candidate set of the last round has been seen one round short
    of it. (--profile traces every frame from then on until a loop closes,
    since no frame knows beforehand that it will close one.)"""
    det = go.loop_detector
    return any(c >= det.min_continuity - 2 for _, c in det.cont_sets)


def run_slice(device, world: PlaneWorld, gt_xy=None, n_out: int = N_OUT, drift=None,
              profile_loop: bool = False, slam: System | None = None):
    """Feed the circuit with every launch count at 0 first; returns the
    statistics dict. `gt_xy`, `n_out` and `drift` default to the bench's
    circuit, its 500 outbound frames and its drift; `slam` is the System to
    drive (make_system's, fresh, by default)."""
    wrappers = map_slice.kernel_wrappers()
    if slam is None:
        slam = make_system(world, device)
    gt_xy = circuit() if gt_xy is None else gt_xy
    drift = DRIFT if drift is None else drift
    for w in wrappers.values():
        w.launches = 0
    go = slam.global_optimizer
    frame_ms, loop_frames, shapes, prof = [], [], {}, None

    # the shapes of the pose graph and the global BA, kept by reference
    solve_graph, solve_ba = sim3_opt.optimize_pose_graph, ba_mod.bundle_adjust

    def graph_rec(s, *a, **kw):
        shapes["pose_graph"] = dict(K=int(s.shape[0]), E=int(a[4].shape[0]))
        return solve_graph(s, *a, **kw)

    def ba_rec(prob, *a, **kw):
        if kw.get("num_second", 1) == 0:
            shapes.setdefault("global_ba", []).append(dict(
                K=int(prob.cam_R.shape[0]), L=int(prob.obs_cam.shape[0]),
                D=int(prob.obs_cam.shape[1])))
        return solve_ba(prob, *a, **kw)

    sim3_opt.optimize_pose_graph, ba_mod.bundle_adjust = graph_rec, ba_rec
    map_stats = None
    try:
        for i, (x, y) in enumerate(gt_xy):
            if i == n_out:
                # the map slice ends here; then the drift (scaffolding, not timed)
                slam.pause_other_threads()
                _sync(device)
                map_stats = map_slice.slice_stats(
                    slam, gt_xy[:n_out], frame_ms, {k: w.launches for k, w in wrappers.items()})
                inject_segment_drift(slam, **drift)
                slam.resume_other_threads()
            img = world.render(pose_at_xy(x, y))
            n_loops = go.num_loops_closed
            want_prof = profile_loop and prof is None and i > n_out and _loop_is_near(go)
            if want_prof:
                p = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                p.__enter__()
            t0 = time.perf_counter()
            slam.feed_monocular_frame(img, i * 0.05)
            _sync(device)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if want_prof:
                p.__exit__(None, None, None)
                if go.num_loops_closed > n_loops:
                    prof = _summarize(p, frame_ms[-1], 1)
            if go.num_loops_closed > n_loops:
                loop_frames.append(i)
        slam.shutdown()
    finally:
        sim3_opt.optimize_pose_graph, ba_mod.bundle_adjust = solve_graph, solve_ba
    launches = {k: w.launches for k, w in wrappers.items()}
    poses = slam.frame_poses
    first, tracked, lost, ate, scale = trajectory_stats(poses, gt_xy)
    md = slam.map_db
    loop_edges = sorted({(min(k, e), max(k, e)) for k, kf in md.keyframes.items()
                         for e in kf.graph_node.loop_edges})
    after_ok = [f + 1 < len(poses) and poses[f + 1][1] is not None for f in loop_frames]
    stats = dict(
        frames=len(gt_xy), init_frame=first, tracked=tracked, lost_after_init=lost,
        ate_m=ate, sim3_scale=scale, keyframes_created=slam.mapper.num_processed,
        keyframes_kept=md.num_keyframes(), landmarks=md.num_landmarks(),
        local_bas=len(slam.local_ba_ms), loops_closed=go.num_loops_closed,
        loop_frames=loop_frames, frame_after_loop_tracked=after_ok, loop_edges=loop_edges,
        loop_event_ms=go.loop_event_ms,
        loop_event_phase_ms={k: map_slice._pcts([e[k] for e in go.loop_event_ms])
                             for k in LOOP_PHASES + ("total",)},
        detect_only_ms=map_slice._pcts(go.detect_ms), solver_shapes=shapes,
        frame_ms=map_slice._pcts(frame_ms[first + 1:]),
        keyframe_event_ms=map_slice._pcts([e["total"] for e in slam.mapper.event_ms[2:]]),
        launches=launches, map_slice=map_stats)
    if profile_loop:
        stats["profile_loop_frame"] = prof
    return stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("loop_slice: needs a CUDA GPU")
    stats = run_slice(torch.device("cuda", 0), bench_world(), profile_loop=args.profile)
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
