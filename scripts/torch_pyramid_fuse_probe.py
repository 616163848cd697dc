#!/usr/bin/env python3
"""Time kernel S (the image pyramid) and kernel L (fusion's duplicate scan)
on the card.

    python scripts/torch_pyramid_fuse_probe.py [--tree DIR]
        [--chunk FILE ...] [--frames 500] [--only s|l]
        [--variants]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the inputs come from this checkout's
chip_smoke.py (pyramid_cases, fuse_edge_chunk) and util modules. `--chunk`
names a file holding a fuse chunk of the map slice: when it does not exist,
the map slice (util/map_slice.py's world and System) runs `--frames` frames
with chip_smoke.record_kernel_inputs, and the fuse chunk chip_smoke.py
would check (largest_inputs) is saved there, so that a later run, of this tree or another,
times the same chunk. Run it on two trees in turns in one call to compare
them (parent, change, change, parent). Prints, on one GPU, device time per
call (CUDA events around 50 back-to-back calls, chip_smoke._device_ms)
beside the one-call time (events around one synchronised call, the host's
launch included, chip_smoke._median_ms) and the device time by CUDA kernel
(torch.profiler):
  - S: `OrbExtractor.pyramid_flat` at chip_smoke.pyramid_cases' shapes (a
    752x480 frame, the stereo pair, the pair as f32, 640x320, 1280x720,
    1920x960), with the launches a call makes; with `--variants`, each
    of them at other tiles and block rows of S's plan;
  - L: `fuse_scan` on the recorded chunks (also those chip_smoke.py saved
    because a row differed, `fuse_chunk_*_differing.pt`) and on
    fuse_edge_chunk (perspective and equirectangular), margins 3 and 4,
    with the (keyframe, landmark) rows whose outputs differ from
    fuse_scan_plain's;
  - the RGBD slice's extraction (120 frames): create_RGBD_frame's time a
    frame, p50 / p99, and the CUDA kernels it launches a frame
    (torch.profiler on frames 40-80).
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_extract_assoc_probe import by_kernel, load_chip_smoke  # noqa: E402


def launches_of(counters, fn) -> int:
    """The launches one call of fn adds to the counters (wrapper functions
    with a `launches` attribute)."""
    import torch

    before = sum(c.launches for c in counters)
    fn()
    torch.cuda.synchronize()
    return sum(c.launches for c in counters) - before


def record_chunk(cs, dev, path: str, frames: int):
    """Run the map slice and save its fuse chunk as chip_smoke.py picks it
    (largest_inputs: the most valid keyframes, then landmarks)."""
    import torch

    from stella_vslam_tpu_torch.util import map_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    world = bench_world()
    slam = map_slice.make_system(world, dev)
    calls, undo = cs.record_kernel_inputs(slam.mapper)
    try:
        map_slice.run_slice(dev, world, n_frames=frames, slam=slam)
    finally:
        undo()
    kfs, *rest = cs.largest_inputs(calls)[1]
    torch.save(dict(model="perspective", num_levels=8, kfs=[t.cpu() for t in kfs],
                    rest=[t.cpu() for t in rest]), path)
    slam.shutdown()


def rgbd_extract(dev, frames: int = 120, window=(40, 80)) -> dict:
    """The RGBD slice's create_RGBD_frame: ms a frame and kernels a frame."""
    import torch

    from stella_vslam_tpu_torch.util import rgbd_slice
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    world = rgbd_slice.bench_world()
    slam = rgbd_slice.make_system(world, dev)
    images = [world.render(pose_at_xy(i * 0.015, 0.0)) for i in range(frames)]
    depth = np.full((world.H, world.W), int(4.0 * 5000.0), np.uint16)
    ms, kernels = [], 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for i, img in enumerate(images):
        torch.cuda.synchronize()
        if window[0] <= i < window[1]:
            with torch.profiler.profile(activities=acts) as prof:
                frm = slam.create_RGBD_frame(img, depth, i * 0.05)
                torch.cuda.synchronize()
            kernels += sum(e.count for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and not e.key.startswith(("Memcpy", "Memset")))
        else:
            t0 = time.perf_counter()
            frm = slam.create_RGBD_frame(img, depth, i * 0.05)
            torch.cuda.synchronize()
            if i >= 2:
                ms.append((time.perf_counter() - t0) * 1e3)
        slam.tracker.feed_frame(frm)
        torch.cuda.synchronize()
    slam.shutdown()
    return dict(extract_ms_p50=float(np.percentile(ms, 50)),
                extract_ms_p99=float(np.percentile(ms, 99)),
                kernels_per_frame=kernels / (window[1] - window[0]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--chunk", nargs="*", default=[
        os.path.join(REPO, "_archive", f"fuse_chunk_{m}.pt")
        for m in ("perspective", "equirectangular")])
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--only", choices=("all", "s", "l"), default="all")
    ap.add_argument("--variants", action="store_true",
                    help="also time S's plan at other tiles and block rows")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_pyramid_fuse_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.kernels import build as kb
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.module import mapping_kernels as mk
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
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

    # ---- S ----
    s_counters = [getattr(ox, n) for n in ("resize_pyramid", "resize_level") if hasattr(ox, n)]
    ex = ox.OrbExtractor(OrbParams(num_levels=8), 752, 480, min_area=800, device=dev)
    pair = torch.stack([torch.from_numpy(world.render(pose_at_xy(x, 0.0))).to(dev)
                        for x in (0.6, 3.0)])
    for label, e, images in cs.pyramid_cases(dev, ex, pair) if a.only != "l" else []:
        fn = lambda: e.pyramid_flat(images)
        say(f"S {label}", dict(device_ms=cs._device_ms(fn), one_call_ms=cs._median_ms(fn),
                               launches_per_call=launches_of(s_counters, fn),
                               by_kernel_us=by_kernel(fn) or "not measured"))
    if a.variants and a.only != "l":
        for label, e, images in cs.pyramid_cases(dev, ex, pair):
            B = images.shape[0]
            base = e.pyramid_plan_for(B)
            for tile in (8, 12, 16, 24):
                for rows in (4, 8, 16, 32):
                    plan = e._pyramids[B] = ox.pyramid_plan(
                        e.levels, e._level_off, e._resize, dev, batch=B, tile=tile,
                        block_rows=rows)
                    say(f"S variant {label} tile {tile} block 32x{rows}", dict(
                        device_ms=cs._device_ms(lambda: e.pyramid_flat(images)),
                        smem_bytes=plan.smem_bytes,
                        blocks=B * plan.rows.shape[0] * plan.cols.shape[0],
                        computed_twice=plan.computed - sum(g.H * g.W for g in e.levels[1:])))
            e._pyramids[B] = base
    if a.only == "s":
        return 0

    # ---- L ----
    from stella_vslam_tpu_torch.camera.base import camera_from_yaml

    files = [f for f in a.chunk if os.path.exists(f)]
    if not files:
        files = a.chunk[:1]
        os.makedirs(os.path.dirname(files[0]), exist_ok=True)
        record_chunk(cs, dev, files[0], a.frames)
    chunks = []
    for f in files:
        saved = torch.load(f)
        kk = mk.MappingKernels(camera_from_yaml(cs.fuse_edge_yaml(saved["model"])),
                               OrbParams(num_levels=saved["num_levels"]), device=dev)
        rec = (mk.FuseKeyframes(*[t.to(dev) for t in saved["kfs"]]),
               *[t.to(dev) for t in saved["rest"]])
        chunks.append((f"recorded {os.path.basename(f)}", kk, rec))
    for model in ("perspective", "equirectangular"):
        chunks.append((f"edge {model}",) + cs.fuse_edge_chunk(dev, seed=5, model=model))
    l_counters = [mk.fuse_scan] + ([H.build_cell_index_batch]
                                   if hasattr(H, "build_cell_index_batch") else [])
    for label, kk, fargs in chunks:
        for margin in (3.0, 4.0):
            largs = fargs + (kk.cam, kk.scale_factors, kk.level_sigma_sq, kk.log_scale,
                             margin, kk.camera.model)
            fn = lambda: mk.fuse_scan(*largs)
            k, p = fn(), mk.fuse_scan_plain(*largs)
            rows = torch.nonzero((k[0] != p[0]) | (k[1] != p[1]) | (k[2] != p[2])).tolist()
            say(f"L {label} chunk {fargs[0].uv.shape[0]}x{fargs[3].shape[0]}x"
                f"{fargs[0].uv.shape[1]} margin {margin:g}",
                dict(device_ms=cs._device_ms(fn), one_call_ms=cs._median_ms(fn),
                     launches_per_call=launches_of(l_counters, fn), gated=int(p[2].sum()),
                     outputs_differing_plain=rows,
                     by_kernel_us=by_kernel(fn) or "not measured"))

    if a.only == "all":
        say("RGBD slice extraction", rgbd_extract(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
