#!/usr/bin/env python3
"""Time kernel F (the Schur linearization of the bundle adjustment) and
kernel B (ORB orientation, blur and steered BRIEF) on the card.

    python scripts/torch_schur_describe_probe.py [--tree DIR] [--problems PATH]
                                                 [--map-frames 300] [--kernels FB]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the problems come from this checkout's
chip_smoke.py, so the tree must take the same arguments. Run it on two
trees in turns in one call to compare them. Prints, on one GPU, device time
per launch (CUDA events around 50 back-to-back launches,
chip_smoke._device_ms) beside the one-call time (events around one
synchronised call, the host's launch included, chip_smoke._median_ms):
  - F (its launches and its reduce) on chip_smoke._ba_problem at the init
    shape (K = 2, L = 4096, D = 2), the local shape (K = 16, L = 4096,
    D = 12; the ordered layout chip_smoke.py times, and the same problem with
    random observers, ordered=False), the global shapes (K = 32 and 64,
    L = 4096, D = 16), L = 4096 + 37 at the local shape, and K = 16,
    L = 2048, D = 12 through the equirectangular model (the leg's local
    shape); where the tree builds F's pair index once per BA, the index's
    device time beside it;
  - F on the local problems of the map slice's first `--map-frames` frames
    (util/map_slice.py, recorded by chip_smoke.record_kernel_inputs): the
    real observer layout. `--problems PATH` saves them there on the first
    run and loads them on the next, so that two trees time the same ones;
  - F's device time by CUDA kernel (torch.profiler) at the local shape and
    on the largest map-slice problem;
  - B on a bench frame's 2872 slots (752x480, 8 levels), in strip mode on a
    rendered stereo pair (2 x 2872), and on the equirectangular leg's frame
    (640x320, 6 levels, 1199 slots).
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def f_times(cs, ba, dev, prob, cam, model="perspective"):
    """F's device and one-call time on prob (the accumulators and ctrl reset
    before each run), and its pair index's where the tree has one."""
    import torch

    L, D = prob.obs_cam.shape
    st = ba._KernelState(prob, cam, model)
    inl = torch.ones((L, D), dtype=torch.uint8, device=dev)

    def reset():
        st.ctrl.zero_()
        st.ctrl[ba._LAM] = 1e-4

    run = lambda: ba.ba_linearize_schur(st, inl, True)
    reset()
    out = dict(device_ms=cs._device_ms(run, before_run=reset))
    reset()
    out["one_call_ms"] = cs._median_ms(run)
    index = getattr(ba, "build_schur_index", None)
    if index is not None:
        out["index_device_ms"] = cs._device_ms(lambda: index(st))
        out["index_one_call_ms"] = cs._median_ms(lambda: index(st))
        out["pair_terms"] = int(st.index.n_terms)
    return out


def f_breakdown(ba, dev, prob, cam, n: int = 20) -> dict:
    """F's device time per call by CUDA kernel (torch.profiler over n
    calls): {kernel name: microseconds per call}; empty where the profiler
    saw no device time."""
    import torch

    L, D = prob.obs_cam.shape
    st = ba._KernelState(prob, cam)
    st.ctrl[ba._LAM] = 1e-4
    inl = torch.ones((L, D), dtype=torch.uint8, device=dev)
    ba.ba_linearize_schur(st, inl, True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            ba.ba_linearize_schur(st, inl, True)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        name = re.search(r"(ba_\w+)", e.key)
        if name and t > 0:
            out[name.group(1)] = out.get(name.group(1), 0.0) + t / n
    return out


def b_rows(cs, ox, dev):
    """B's (label, call) pairs at its three shapes."""
    import torch

    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.util import equirect_slice
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world
    from stella_vslam_tpu_torch.util.synthetic import equirect_circle

    out = []
    world = bench_world()
    params = OrbParams(num_levels=8)
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    ex = ox.OrbExtractor(params, 752, 480, min_area=800, device=dev)

    def frame_args(ex, levels, thr):
        keys = [ox.fast_nms(l.contiguous(), g, ex.border, *thr) for l, g in zip(levels, ex.levels)]
        pts = [ox.cell_keypoints(k, g, ex.border) for k, g in zip(keys, ex.levels)]
        px, py, valid, _ = (torch.cat(c) for c in zip(*pts))
        return (torch.cat([l.reshape(-1) for l in levels]), ex._slot_base, ex._slot_H,
                ex._slot_W, px.to(torch.int32), py.to(torch.int32), valid, ex._tables)

    levels = ex.pyramid(torch.from_numpy(world.render(pose_at_xy(0.6, 0.0))).to(dev))
    a = frame_args(ex, levels, thr)
    out.append((f"{ex.num_slots} slots (752x480, 8 levels)", lambda: ox.orb_describe(*a)))
    pair = torch.stack([torch.from_numpy(world.render(pose_at_xy(x, 0.0))).to(dev)
                        for x in (0.6, 3.0)])
    pyr = ex.pyramid_flat(pair)
    pts = [ox.cell_keypoints(ox.fast_nms(v, g, ex.border, *thr), g, ex.border)
           for v, g in zip(ex.level_views(pyr), ex.levels)]
    px, py, valid, _ = (torch.cat(c, dim=-1) for c in zip(*pts))
    base, hh, ww = ex._slots(2)
    s = (pyr.reshape(-1), base, hh, ww, px.reshape(-1).int().contiguous(),
         py.reshape(-1).int().contiguous(), valid.reshape(-1).contiguous(), ex._tables)
    out.append((f"strip mode 2 x {ex.num_slots} slots (a pair)",
                lambda: ox.orb_describe_strips(*s)))
    eworld = equirect_slice.bench_world()
    eparams = OrbParams(num_levels=6)
    ee = ox.OrbExtractor(eparams, 640, 320, min_area=800, device=dev)
    img = torch.from_numpy(eworld.render(equirect_circle(250)[0][0])).to(dev)
    e = frame_args(ee, ee.pyramid(img), (float(eparams.ini_fast_thr),
                                         float(eparams.min_fast_thr)))
    out.append((f"{ee.num_slots} slots (640x320, 6 levels)",
                lambda: ox.orb_describe(*e)))
    return out


def map_problems(cs, dev, path, frames):
    """The map slice's local BA problems (K >= 16), loaded from `path` when
    it exists, else recorded and saved there."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.util import map_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    if path and os.path.exists(path):
        saved = torch.load(path, weights_only=False)
        return [(ba.BAProblem(*[None if v is None else v.to(dev) for v in p]), c)
                for p, c in saved]
    world = bench_world()
    slam = map_slice.make_system(world, dev)
    calls, undo = cs.record_kernel_inputs(slam.mapper)
    try:
        map_slice.run_slice(dev, world, n_frames=frames, slam=slam)
    finally:
        undo()
    cam = slam.mapper.cam_scalars
    local = [p for p in calls["bundle_adjust"] if p.cam_R.shape[0] >= 16]
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save([(tuple(None if v is None else v.cpu() for v in p), cam) for p in local],
                   path)
    return [(p, cam) for p in local]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--problems", default=None)
    ap.add_argument("--map-frames", type=int, default=300)
    ap.add_argument("--kernels", default="FB", help="F, B or FB: the kernels to time")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    sys.path.insert(1, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_schur_describe_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.kernels import build as kb
    from stella_vslam_tpu_torch.ops.optim import ba

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kb.load()
    tree = os.path.relpath(os.path.abspath(a.tree), REPO)
    print(f"tree {tree}: build {kb.build_seconds:.2f} s [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    shapes = [("init K=2 L=4096 D=2", (2, 4096, 2, False, 2), {}, "perspective"),
              ("local K=16 L=4096 D=12", (16, 4096, 12, False, 16), dict(spacing=0.1,
                                                                         ordered=True),
               "perspective"),
              ("local K=16 L=4096 D=12 ordered=False", (16, 4096, 12, False, 16),
               dict(spacing=0.1), "perspective"),
              ("local K=16 L=4133 D=12", (16, 4133, 12, False, 16), dict(spacing=0.1,
                                                                         ordered=True),
               "perspective"),
              ("global K=32 L=4096 D=16", (32, 4096, 16, False, 44), dict(spacing=0.1,
                                                                          ordered=True),
               "perspective"),
              ("global K=64 L=4096 D=16", (64, 4096, 16, False, 45), dict(spacing=0.1,
                                                                          ordered=True),
               "perspective"),
              ("equirect K=16 L=2048 D=12", (16, 2048, 12, False, 17), dict(spacing=0.1,
                                                                            ordered=True),
               "equirectangular")]
    for label, args, kw, model in shapes if "F" in a.kernels else ():
        prob, cam = cs._ba_problem(dev, *args, **kw)
        out = f_times(cs, ba, dev, prob, cam, model)
        print(f"tree {tree}: F {label}: {json.dumps(out)} [{card}]", flush=True)
    maps = map_problems(cs, dev, a.problems, a.map_frames) if "F" in a.kernels else []
    for label, (prob, cam) in (("local K=16 L=4096 D=12", cs._ba_problem(
            dev, 16, 4096, 12, False, 16, spacing=0.1, ordered=True)),
            ("the largest map slice local problem", maps[-1])) if maps else ():
        print(f"tree {tree}: F {label} by kernel, us per call (torch.profiler): "
              f"{json.dumps(f_breakdown(ba, dev, prob, cam)) or 'not measured'} [{card}]",
              flush=True)
    for i, (p, cam) in enumerate(maps):
        K, (L, D) = p.cam_R.shape[0], p.obs_cam.shape
        out = f_times(cs, ba, dev, p, cam)
        out["valid_landmarks"] = int(p.lm_valid.sum())
        out["valid_observations"] = int(p.obs_valid.sum())
        print(f"tree {tree}: F map slice local problem {i} K={K} L={L} D={D}: "
              f"{json.dumps(out)} [{card}]", flush=True)
    for label, fn in b_rows(cs, ox, dev) if "B" in a.kernels else ():
        out = dict(device_ms=cs._device_ms(fn), one_call_ms=cs._median_ms(fn))
        print(f"tree {tree}: B {label}: {json.dumps(out)} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
