#!/usr/bin/env python3
"""Time the tracking cascade's kernels D (motion-only pose LM) and C (gated
Hamming top-2) on the card, at the shapes the cascade gives them.

    python scripts/torch_cascade_probe.py [--tree DIR] [--frames 200]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the problems come from this checkout's
chip_smoke.py, so the tree must take the same arguments. Run it on two
trees in turns in one call to compare them. Prints, on one GPU, device time
per launch (CUDA events around 50 back-to-back launches,
chip_smoke._device_ms) beside the one-call time (events around one
synchronised call, the host's launch included, chip_smoke._median_ms):
  - D on chip_smoke._pose_problem at N = 2872 (perspective) and N = 1199
    (equirectangular), one problem a launch and the cascade's batch of two;
  - C's cell index of a frame's 2872 slots; C at phase 3's window shape
    (chip_smoke.window_case: 4096 table rows x 2872 slots, the index's
    launch and the walk), in brute-force mode with the orientation gate
    (2872 x 2872, the keyframe fallback), and on calls of the threaded
    slice's first `--frames` frames, recorded with their real gates by
    chip_smoke.record_match_inputs (stage 1: the motion model's window;
    stage 2: brute force; stage 3: the local map's window over the
    4096-row table), with the rows that pass row_ok, the dense pair count
    M x N and the pairs the launch visits.
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frame_features(dev):
    """One 752x480 frame of the bench's world through kernels A and B:
    (extractor, slot x, slot y, valid, angles, descriptors)."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    params = OrbParams(num_levels=8)
    ex = ox.OrbExtractor(params, 752, 480, min_area=800, device=dev)
    levels = ex.pyramid(torch.from_numpy(bench_world().render(pose_at_xy(0.6, 0.0))).to(dev))
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    keys = [ox.fast_nms(l.contiguous(), g, ex.border, *thr) for l, g in zip(levels, ex.levels)]
    pts = [ox.cell_keypoints(k, g, ex.border) for k, g in zip(keys, ex.levels)]
    px, py, valid, _ = (torch.cat(c) for c in zip(*pts))
    pyr = torch.cat([l.reshape(-1) for l in levels])
    ang, desc = ox.orb_describe(pyr, ex._slot_base, ex._slot_H, ex._slot_W, px.to(torch.int32),
                                py.to(torch.int32), valid, ex._tables)
    return ex, px, py, valid, ang, desc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--frames", type=int, default=200)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    sys.path.insert(1, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_cascade_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.kernels import build as kb
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.ops.optim import pose as pose_mod
    from stella_vslam_tpu_torch.util import threaded_slice
    from stella_vslam_tpu_torch.util.loop_slice import circuit
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kb.load()
    tree = os.path.relpath(os.path.abspath(a.tree), REPO)
    print(f"tree {tree}: build {kb.build_seconds:.2f} s [{card}]", flush=True)
    dev = torch.device("cuda", 0)

    def times(fn):
        return dict(device_ms=cs._device_ms(fn), one_call_ms=cs._median_ms(fn))

    params = OrbParams(num_levels=8)
    for N, model in ((2872, "perspective"), (1199, "equirectangular")):
        rng = np.random.default_rng(3)
        probs = [cs._pose_problem(dev, rng, N, params, model) for _ in range(2)]
        one, cam = probs[0][:7], probs[0][-1]
        batch = [torch.stack([p[i] for p in probs]) for i in range(7)]
        out = dict(one_problem=times(lambda: pose_mod.optimize_pose(*one, cam, model=model)),
                   batch_of_two=times(lambda: pose_mod.optimize_pose_batch(*batch, cam,
                                                                           model=model)))
        print(f"tree {tree}: D {model} N={N}: {json.dumps(out)} [{card}]", flush=True)

    ex, px, py, valid, ang, desc = frame_features(dev)
    args, kw = cs.window_case(dev, ex, desc, px, py, valid)
    u, v = kw["window"].col_u, kw["window"].col_v
    out = times(lambda: H.build_cell_index(u, v, 752, 480))
    print(f"tree {tree}: C's cell index of {u.shape[0]} slots: {json.dumps(out)} [{card}]",
          flush=True)
    ori = H.OrientGate(torch.cos(ang), torch.sin(ang), torch.cos(ang), torch.sin(ang),
                       float(np.cos(np.float32(np.deg2rad(30.0)))))
    cases = [("phase 3 window 4096 x 2872", args, kw),
             ("brute force 2872 x 2872", (desc, desc, valid, valid), dict(orient=ori))]
    calls, undo = cs.record_match_inputs(sample=7)
    try:
        threaded_slice.run_slice(dev, bench_world(), gt_xy=circuit()[:a.frames])
    finally:
        undo()
    for stage, recs in calls.items():
        cases += [(f"threaded slice {stage} call {i}", r[0], r[1]) for i, r in enumerate(recs[:3])]
    for label, args, kw in cases:
        M, N = args[0].shape[0], args[1].shape[0]
        out = times(lambda: H.hamming_top2(*args, **kw))
        out.update(rows_ok=int(args[2].sum()), dense_pairs=M * N,
                   pairs_visited=int(H.pairs_visited(*args, **kw)))
        print(f"tree {tree}: C {label}: {json.dumps(out)} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
