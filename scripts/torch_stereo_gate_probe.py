#!/usr/bin/env python3
"""Time kernel T (stereo row matching) and kernel R's gate (the tracking
cascade's projections and their window rows) on the card.

    python scripts/torch_stereo_gate_probe.py [--tree DIR] [--frames 120]
        [--only rgbd] [--rgbd-runs N]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the inputs come from this checkout's
chip_smoke.py (rows_case) and util modules, which the tree's package must
accept. A tree whose stereo matcher takes no slot layout is called without
one; a tree without `camera.base.project_window_rows` is timed on its
`reproject_gate` alone and on that gate followed by the eager ops its
matchers ran to build the same window rows (the two `.contiguous()` copies,
the radius, the level bounds and the valid flag). Run it on two trees in
turns in one call to compare them (parent, change, change, parent).
Prints, on one GPU, device time per call (CUDA events around 50
back-to-back calls, chip_smoke._device_ms) beside the one-call time (events
around one synchronised call, the host's launch included,
chip_smoke._median_ms):
  - T on a rendered 752x480 pair of the bench's world (8 levels, 2872
    slots each side) and its device time by CUDA kernel (torch.profiler);
  - T on every call of the stereo System's first `--frames` frames of the
    stereo leg's path (the frames' extraction is deterministic, so both
    trees see the same inputs): the median and largest device time, and
    the extract phase (create_stereo_frame: upload, pair extraction, T,
    undistortion, bearings, the host mirror) per frame, p50 / p99;
  - R's gate: 4096 table rows and 2872 last-frame points (perspective,
    752x480), 4096 and 1199 (equirectangular, 640x320);
  - the RGBD slice's frames (util/rgbd_slice.py's world and System, 120
    frames): the CUDA kernels the tracker launches a frame (torch.profiler
    around `tracker.feed_frame` on frames 40-80, kernels and copies apart),
    its track ms, and frame p50 / p99 over the other steady frames;
    `--rgbd-runs N` runs the slice N times in the process, a line each,
    and `--only rgbd` runs nothing else (many short runs of both trees in
    turns, for the frame time's spread).
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_extract_assoc_probe import by_kernel, load_chip_smoke  # noqa: E402


def stereo_call(st, args, kw, layout):
    """T as the tree's matcher takes it: with the layout where it has one."""
    if "layout" in inspect.signature(st.stereo_match).parameters:
        kw = dict(kw, layout=layout)
    return lambda: st.stereo_match(*args, **kw)


def gate_calls(cb, p, R, t, pos, kw):
    """(R's gate as the tree runs it for the cascade, the same followed by
    the eager window-row ops of its matchers or None)."""
    import torch

    if hasattr(cb, "project_window_rows"):
        return (lambda: cb.project_window_rows(p, R, t, pos, **kw)), None
    sf, margin, model = kw["scale_factors"], kw["margin"], kw["model"]
    if kw.get("tbl_u32") is not None:
        L = kw["num_levels"]
        gate = lambda: cb.reproject_gate(p, R, t, pos, kw["tbl_u32"],
                                         log_scale=kw["log_scale"], num_levels=L, model=model)

        def rows():
            uv, _, obs, xr, pred = gate()
            pred = pred.to(torch.int32)
            return (uv[:, 0].contiguous(), uv[:, 1].contiguous(), xr,
                    margin * sf[pred.long()], torch.clamp(pred - 1, min=0),
                    torch.clamp(pred + 1, max=L - 1), obs)
    else:
        gate = lambda: cb.reproject_gate(p, R, t, pos, model=model)

        def rows():
            uv, _, vis, xr, _ = gate()
            lvl = kw["last_level"].to(torch.int32)
            return (uv[:, 0].contiguous(), uv[:, 1].contiguous(), xr,
                    margin * sf[lvl.long()], lvl - 1, lvl + 1, kw["last_valid"] & vis)
    return gate, rows


def rendered_pair(dev, ex, world, x=0.6):
    """A rendered stereo pair of the bench's world through the pair
    extraction: (the matcher's positional arguments, its keywords)."""
    import torch

    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.stereo_slice import BASELINE

    T = pose_at_xy(x, 0.0)
    Tb = np.eye(4)
    Tb[0, 3] = -BASELINE
    (fl, sl), (fr, sr) = ex.extract_pair_with_patches(
        torch.from_numpy(world.render(T)).to(dev), torch.from_numpy(world.render(Tb @ T)).to(dev))
    fxb = float(np.float32(world.fx * BASELINE))
    kw = dict(scale_factors=torch.tensor(ex.params.scale_factors, dtype=torch.float32,
                                         device=dev),
              focal_x_baseline=fxb, true_baseline=fxb / float(np.float32(world.fx)))
    return (fl.xy, fl.level, fl.desc, fl.valid, sl, fr.xy, fr.level, fr.desc, fr.valid, sr), kw


def stereo_leg_frames(cs, dev, world, frames: int):
    """The stereo System's extract phase on the leg's first `frames` frames
    (ms per frame, each ended by a synchronise) and every stereo match it
    made: (extract ms, [(args, kw)], the System's slot layout or None)."""
    import torch

    from stella_vslam_tpu_torch import system as system_mod
    from stella_vslam_tpu_torch.util import stereo_slice
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    slam = stereo_slice.make_system(world, dev, "stereo")
    Tb = np.eye(4)
    Tb[0, 3] = -stereo_slice.BASELINE
    pairs = [(world.render(pose_at_xy(x, y)), world.render(Tb @ pose_at_xy(x, y)))
             for x, y in stereo_slice.leg_path(frames)]
    calls, orig = [], system_mod.stereo_match

    def rec(*args, **kw):
        calls.append((args, {k: v for k, v in kw.items() if k != "layout"}))
        return orig(*args, **kw)

    system_mod.stereo_match = rec
    ms = []
    try:
        for i, (left, right) in enumerate(pairs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slam.create_stereo_frame(left, right, i * 0.05)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        system_mod.stereo_match = orig
    layout = getattr(slam.extractor, "slot_layout", None)
    slam.shutdown()
    return ms, calls, layout


def rgbd_frames(dev, frames: int, window=(40, 80)):
    """The RGBD slice's frames with the tracker's launches counted by
    torch.profiler on `window`: (statistics dict)."""
    import torch

    from stella_vslam_tpu_torch.util import rgbd_slice
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    world = rgbd_slice.bench_world()
    slam = rgbd_slice.make_system(world, dev)
    images = [world.render(pose_at_xy(i * 0.015, 0.0)) for i in range(frames)]
    depth = np.full((world.H, world.W), int(4.0 * 5000.0), np.uint16)
    frame_ms, track_ms, kernels, copies = [], [], 0, 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for i, img in enumerate(images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frm = slam.create_RGBD_frame(img, depth, i * 0.05)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if window[0] <= i < window[1]:
            with torch.profiler.profile(activities=acts) as prof:
                slam.tracker.feed_frame(frm)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    if e.key.startswith(("Memcpy", "Memset")):
                        copies += e.count
                    else:
                        kernels += e.count
        else:
            slam.tracker.feed_frame(frm)
            torch.cuda.synchronize()
            if i >= 2:
                track_ms.append((time.perf_counter() - t1) * 1e3)
                frame_ms.append((time.perf_counter() - t0) * 1e3)
    tracked = sum(f[1] is not None for f in slam.frame_poses)
    slam.shutdown()
    n = window[1] - window[0]
    return dict(kernel_launches_per_frame=kernels / n, copies_per_frame=copies / n,
                track_ms_p50=float(np.percentile(track_ms, 50)),
                frame_ms_p50=float(np.percentile(frame_ms, 50)),
                frame_ms_p99=float(np.percentile(frame_ms, 99)), tracked=tracked,
                frames=frames)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--only", choices=("all", "rgbd"), default="all")
    ap.add_argument("--rgbd-runs", type=int, default=1)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_stereo_gate_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from stella_vslam_tpu_torch.camera import base as cb
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.kernels import build as kb
    from stella_vslam_tpu_torch.match import stereo as st
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kb.load()
    tree = os.path.relpath(os.path.abspath(a.tree), REPO)
    say = lambda label, out: print(f"tree {tree}: {label}: {json.dumps(out)} [{card}]",
                                   flush=True)
    say("build", dict(seconds=kb.build_seconds))
    dev = torch.device("cuda", 0)
    world = bench_world()
    if a.only == "all":
        probe_kernels(cs, cb, ox, st, say, dev, world, a.frames)
    for r in range(a.rgbd_runs):
        say(f"RGBD slice tracker (launches on frames 40-80), run {r}", rgbd_frames(dev, 120))
    return 0


def probe_kernels(cs, cb, ox, st, say, dev, world, frames: int):
    """T's and R's lines (module docstring)."""
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams

    ex = ox.OrbExtractor(OrbParams(num_levels=8), 752, 480, min_area=800, device=dev)
    layout = getattr(ex, "slot_layout", None)
    args, kw = rendered_pair(dev, ex, world)
    fn = stereo_call(st, args, kw, layout)
    say("T rendered pair 2872 x 2872", dict(device_ms=cs._device_ms(fn),
                                             one_call_ms=cs._median_ms(fn)))
    say("T rendered pair by CUDA kernel, us per call (torch.profiler)",
        by_kernel(fn) or "not measured")

    ext_ms, calls, leg_layout = stereo_leg_frames(cs, dev, world, frames)
    dev_ms = [cs._device_ms(stereo_call(st, c, k, leg_layout), n=20) for c, k in calls]
    say(f"T on the stereo leg's first {len(calls)} calls",
        dict(device_ms_median=float(np.median(dev_ms)), device_ms_max=float(np.max(dev_ms)),
             valid_left_median=float(np.median([int(c[3].sum()) for c, _ in calls]))))
    say(f"stereo leg extract phase ({len(ext_ms)} frames, the first 2 left out)",
        dict(extract_ms_p50=float(np.percentile(ext_ms[2:], 50)),
             extract_ms_p99=float(np.percentile(ext_ms[2:], 99))))

    for label, case in (("perspective 752x480", cs.rows_case(dev, world, 4096, 2872)),
                        ("equirectangular 640x320",
                         cs.rows_case(dev, None, 4096, 1199,
                                      scale_factors=[1.2 ** l for l in range(6)]))):
        p, R, t, tbl, tkw, pts, pkw = case
        for mode, pos, kw in (("table", tbl, tkw), ("points", pts, pkw)):
            gate, rows = gate_calls(cb, p, R, t, pos, kw)
            out = dict(rows=int(pos.shape[0]), device_ms=cs._device_ms(gate),
                       one_call_ms=cs._median_ms(gate))
            if rows is not None:
                out.update(with_rows_device_ms=cs._device_ms(rows),
                           with_rows_one_call_ms=cs._median_ms(rows))
            say(f"R gate {label} {mode}", out)


if __name__ == "__main__":
    sys.exit(main())
