#!/usr/bin/env python3
"""Time kernel A (FAST + cell NMS, the slots of a frame) and kernel Q's
scatter and dedup (the tracking cascade's bookkeeping) on the card.

    python scripts/torch_extract_assoc_probe.py [--tree DIR] [--assoc PATH]
                                                [--assoc-frames 150]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the inputs come from this checkout's
chip_smoke.py (fast_frames, _assoc_problem, dedup_case), which the tree's
package must accept. A tree whose extractor has no `fast_nms_pyramid`
(before kernel A ran once a pyramid) is timed on what its extractor ran
for a frame: one launch of A a level, then the per-level slot arithmetic
(`cell_keypoints`) and the concatenations; its eight launches alone are
timed as well. Run it on two trees in turns in one call to compare them.
Prints, on one GPU, device time per call (CUDA events around 50
back-to-back calls, chip_smoke._device_ms) beside the one-call time (events
around one synchronised call, the host's launch included,
chip_smoke._median_ms):
  - A per frame on chip_smoke.fast_frames: a bench frame (752x480, 8
    levels, 2872 slots), a rendered stereo pair (B = 2), the
    equirectangular leg's frame (640x320, 6 levels, 1199 slots), a masked
    fisheye frame with the leg's vignette, a 1280x720 frame (7984 slots);
  - A's device time by CUDA kernel on the bench frame (torch.profiler);
  - Q's scatter at M = 4096, N = 2872 on chip_smoke._assoc_problem and on
    the scatters the map slice's first `--assoc-frames` frames
    recorded (chip_smoke.record_assoc_inputs; `--assoc PATH` saves them
    there on the first run and loads them on the next, so that two trees
    time the same calls);
  - Q's dedup on chip_smoke.dedup_case at N = 2872 and 1199, and at 7984
    and 12839 where the tree takes them;
  - the RGBD slice's extract ms per frame and frame p50 / p99
    (util/rgbd_slice.py, 120 frames, the phase split of its profile
    window).
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This checkout's chip_smoke.py, whatever the tree holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def a_calls(ox, ex, pyr, mask):
    """(A for a frame as the tree's extractor runs it, its launches alone
    or None where that is the same call)."""
    import torch

    thr = (float(ex.params.ini_fast_thr), float(ex.params.min_fast_thr))
    if hasattr(ox, "fast_nms_pyramid"):
        return (lambda: ox.fast_nms_pyramid(pyr, ex._fast, *thr, mask)), None
    masks = ex.level_masks(mask) if mask is not None else [None] * len(ex.levels)
    views = ex.level_views(pyr)

    def launches():
        return [ox.fast_nms(v, g, ex.border, *thr, m)
                for v, g, m in zip(views, ex.levels, masks)]

    def frame():
        pts = [ex.cell_keypoints(k, g) for k, g in zip(launches(), ex.levels)]
        return [torch.cat(c, dim=-1) for c in zip(*pts)]
    return frame, launches


def by_kernel(fn, n: int = 20) -> dict:
    """Device time per call by CUDA kernel (torch.profiler over n calls):
    {kernel name: microseconds per call}; empty where the profiler saw no
    device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.self_device_time_total
        if t > 0:
            key = re.sub(r"\(.*", "", e.key)[:60]
            out[key] = out.get(key, 0.0) + t / n
    return out


def recorded_scatters(cs, dev, path, frames):
    """The scatter calls of the map slice's first `frames` frames (every
    one), loaded from `path` when it exists, else recorded (and saved there
    when a path is given); on the card, from the same CPU copies either
    way."""
    import torch

    if path and os.path.exists(path):
        saved = torch.load(path, weights_only=False)
    else:
        from stella_vslam_tpu_torch.util import map_slice
        from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

        world = bench_world()
        slam = map_slice.make_system(world, dev)
        calls, undo = cs.record_assoc_inputs(sample=1)
        try:
            map_slice.run_slice(dev, world, n_frames=frames, slam=slam)
        finally:
            undo()
        saved = [tuple(a.cpu() if torch.is_tensor(a) else a for a in c)
                 for c in calls["scatter"]]
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            torch.save(saved, path)
    return [tuple(a.to(dev) if torch.is_tensor(a) else a for a in c) for c in saved]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--assoc", default=None)
    ap.add_argument("--assoc-frames", type=int, default=150)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_extract_assoc_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.kernels import build as kb
    from stella_vslam_tpu_torch.module import tracking_kernels as tk
    from stella_vslam_tpu_torch.util import rgbd_slice

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kb.load()
    tree = os.path.relpath(os.path.abspath(a.tree), REPO)
    say = lambda label, out: print(f"tree {tree}: {label}: {json.dumps(out)} [{card}]",
                                   flush=True)
    say("build", dict(seconds=kb.build_seconds))
    dev = torch.device("cuda", 0)

    frames = cs.fast_frames(dev)
    for label, ex, pyr, mask in frames:
        frame, launches = a_calls(ox, ex, pyr, mask)
        out = dict(device_ms=cs._device_ms(frame), one_call_ms=cs._median_ms(frame),
                   slots=ex.num_slots, images=int(pyr.shape[0]))
        if launches is not None:
            out["launches_only_device_ms"] = cs._device_ms(launches)
            out["launches_only_one_call_ms"] = cs._median_ms(launches)
        out.update(cs.fast_work(ex, pyr, mask))
        say(f"A {label}", out)
    _, ex, pyr, mask = frames[0]
    say("A bench frame by CUDA kernel, us per call (torch.profiler)",
        by_kernel(a_calls(ox, ex, pyr, mask)[0]) or "not measured")

    best, acc, tbl, ids = cs._assoc_problem(dev, 4096, 2872, 11)
    sargs = (best[:, 1], acc, tbl[:, 0:3], ids[:, 8], 2872)
    rec = recorded_scatters(cs, dev, a.assoc, a.assoc_frames)
    fn = lambda: tk.scatter_to_current(*sargs)
    say("Q scatter M=4096 N=2872", dict(device_ms=cs._device_ms(fn),
                                        one_call_ms=cs._median_ms(fn)))
    dev_ms = [cs._device_ms(lambda c=c: tk.scatter_to_current(*c), n=20) for c in rec]
    say(f"Q scatter on the map slice's {len(rec)} recorded scatters",
        dict(device_ms_median=float(np.median(dev_ms)), device_ms_max=float(np.max(dev_ms)),
             sources=sorted({int(c[0].shape[0]) for c in rec}),
             slots=sorted({int(c[4]) for c in rec})))
    for n in (2872, 1199, cs.HD_SLOTS, cs.EQ_HD_SLOTS):
        if n > getattr(tk, "MAX_DEDUP_SLOTS", 1 << 30):
            say(f"Q dedup N={n}", "refused: past MAX_DEDUP_SLOTS")
            continue
        dargs = cs.dedup_case(dev, n, 12)
        fn = lambda: tk.dedup_by_id(*dargs)
        say(f"Q dedup N={n}", dict(device_ms=cs._device_ms(fn), one_call_ms=cs._median_ms(fn)))

    st = rgbd_slice.run_slice(dev, rgbd_slice.bench_world(), 120, profile_window=(40, 60))
    say("RGBD slice (120 frames, frames 40-60 split by phase)",
        dict(extract_ms_p50=st["phase_ms_p50"]["extract_ms"],
             track_ms_p50=st["phase_ms_p50"]["track_ms"], frame_ms_p50=st["frame_ms_p50"],
             frame_ms_p99=st["frame_ms_p99"],
             device_ms_per_frame=st["profile"]["device_ms_per_frame"],
             top25_kernel_launches_per_frame=sum(
                 k["launches"] for k in st["profile"]["top_kernels_ms_per_frame"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
