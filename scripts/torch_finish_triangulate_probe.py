#!/usr/bin/env python3
"""Time kernel R's frame finish (undistortion, bearings, x_right, depths and
the packed host rows of a frame) and kernel K (the mapping module's
triangulation) on the card.

    python scripts/torch_finish_triangulate_probe.py [--tree DIR]
        [--inputs FILE] [--only all|r|k|extract] [--runs 3] [--save FILE]
        [--compare FILE]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the helpers come from this checkout's
chip_smoke.py (finish_camera, finish_case, record_kernel_inputs,
largest_inputs, _device_ms, _median_ms) and scripts (the triangulation
inputs of torch_epipolar_backsub_probe.record_inputs, the RGBD slice's
extraction of torch_pyramid_fuse_probe.rgbd_extract). `--inputs` names a
file of K's inputs: when it does not exist, the threaded slice and the
equirectangular leg run with the mapper's calls recorded and the
triangulation chip_smoke.py picks from each is saved there, so that later
runs, of this tree or another, time the same inputs. Run it on two trees in
turns in one call to compare them (parent, change, change, parent);
`--save` writes this tree's outputs and `--compare` reads another tree's,
and the elements whose bits differ are counted. Prints, on one GPU, device
time per call (CUDA events around 50 back-to-back calls / 50,
chip_smoke._device_ms) beside the one-call time (events around one
synchronised call, chip_smoke._median_ms) and the CUDA kernels a call
launches (torch.profiler, copies not counted):
  - R: a frame's finish at 2872 slots with EuRoC's radial-tangential camera,
    mono, stereo (kernel T's outputs given) and RGBD (a depth map with
    holes): the tree's `data.frame.frame_finish` where it has one, else the
    sequence its System ran (`undistort_and_bearings`, the -1 columns, the
    RGBD depth sampling and x_right, `pack_host_cols`);
  - the CUDA kernels a frame of `System.create_{monocular,stereo,RGBD}_frame`
    launches (the bench world's frames 10-19; the extraction's and the
    finish's);
  - K: `mapping_kernels.triangulate_checks` on the two recorded
    triangulations (the threaded slice's, 752x480, and the equirectangular
    leg's), kernel J's matches as match_for_triangulation makes them, with
    the elements whose bits differ from `triangulate_checks_plain`;
  - extract (`--only extract` or all): the RGBD slice's create_RGBD_frame
    time a frame, p50 and p99 over 120 frames, `--runs` times, with the
    median and spread of the p50s.
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_extract_assoc_probe import load_chip_smoke  # noqa: E402

N = 2872
FEEDS = ("mono", "stereo", "RGBD")


def cuda_kernels(fn, n: int = 10) -> float:
    """CUDA kernels a call of fn launches (torch.profiler over n calls;
    copies and memsets not counted)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))) / n


def tree_finish(cam, feats, kw):
    """The tree's finish of a frame: frame_finish where the tree has it,
    else its System's sequence (the parent's create_*_frame tails)."""
    import torch

    from stella_vslam_tpu_torch.data import frame as fm

    if hasattr(fm, "frame_finish"):
        return lambda: tuple(fm.frame_finish(cam, feats, **kw))

    def seq():
        und, bear = cam.undistort_and_bearings(feats.xy)
        if "depth_map" in kw:
            depth_map = kw["depth_map"]
            h, w = depth_map.shape
            xs = torch.clamp(feats.xy[:, 0].to(torch.int64), 0, w - 1)
            ys = torch.clamp(feats.xy[:, 1].to(torch.int64), 0, h - 1)
            d = depth_map[ys, xs] * kw["inv_depth_factor"]
            neg = torch.full_like(d, -1.0)
            d = torch.where(feats.valid & (d > 0), d, neg)
            xr = torch.where(
                d > 0, und[:, 0] - cam.params.focal_x_baseline / torch.clamp(d, min=1e-6), neg)
        elif "x_right" in kw:
            xr, d = kw["x_right"], kw["depths"]
        else:
            xr = d = torch.full((feats.num_slots,), -1.0, dtype=torch.float32,
                                device=feats.xy.device)
        return und, bear, xr, d, fm.pack_host_cols(
            feats.xy, und, bear, feats.level, feats.angle, feats.valid, feats.response, xr, d,
            feats.desc)
    return seq


def probe_r(cs, dev, say, versus):
    cam = cs.finish_camera("perspective")
    for seed, feed in enumerate(FEEDS):
        feats, kw = cs.finish_case(dev, cam, feed, N, 60 + seed)
        fn = tree_finish(cam, feats, kw)
        say(f"R finish {feed}", dict(
            slots=N, device_ms=cs._device_ms(fn), one_call_ms=cs._median_ms(fn),
            cuda_kernels_a_call=cuda_kernels(fn), bits_apart_from_other_tree=versus(
                f"finish_{feed}", fn())))


def probe_frames(dev, say):
    """The CUDA kernels a frame of each create_*_frame."""
    from stella_vslam_tpu_torch.util import mono_slice, stereo_slice
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    world = bench_world()
    Tb = np.eye(4)
    Tb[0, 3] = -stereo_slice.BASELINE
    depth = np.full((world.H, world.W), int(world.depth * stereo_slice.DEPTH_FACTOR), np.uint16)
    imgs = [world.render(pose_at_xy(i * 0.015, 0.0)) for i in range(10, 20)]
    rights = [world.render(Tb @ pose_at_xy(i * 0.015, 0.0)) for i in range(10, 20)]
    for setup in FEEDS:
        slam = (mono_slice.make_system(world, dev) if setup == "mono"
                else stereo_slice.make_system(world, dev, setup))
        k = [0]

        def one():
            i = k[0] % len(imgs)
            k[0] += 1
            if setup == "mono":
                slam.create_monocular_frame(imgs[i], 0.05 * i)
            elif setup == "stereo":
                slam.create_stereo_frame(imgs[i], rights[i], 0.05 * i)
            else:
                slam.create_RGBD_frame(imgs[i], depth, 0.05 * i)
        say(f"create frame {setup}", dict(cuda_kernels_a_frame=cuda_kernels(one)))
        slam.shutdown()


def probe_k(cs, dev, say, versus, path):
    import torch

    from stella_vslam_tpu_torch.camera.base import camera_from_yaml
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import robust
    from stella_vslam_tpu_torch.module import mapping_kernels as mk
    from stella_vslam_tpu_torch.util import equirect_slice, rgbd_slice
    from torch_epipolar_backsub_probe import record_inputs

    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        record_inputs(cs, dev, path)
    saved = torch.load(path)
    for label, world, levels in (("threaded", rgbd_slice.bench_world(), 8),
                                 ("equirect", equirect_slice.bench_world(), 6)):
        camera = camera_from_yaml(world.camera_yaml())
        model, cam = camera.model, camera.params
        rec = saved[label]
        cur = mk.TriKeyframe(*[t.to(dev) for t in rec["cur"]])
        nbrs = mk.TriKeyframe(*[t.to(dev) for t in rec["nbrs"]])
        poses = rec["poses"].to(dev).contiguous()
        pair_valid = rec["pair_valid"].to(dev)
        orb = OrbParams(num_levels=levels)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        sf, sig = f(orb.scale_factors), f(orb.level_sigma_sq)
        E_12, epl2 = mk.epipolar_terms(poses)
        idx2, accepted, _ = robust.match_for_triangulation(
            cur.angle, cur.level, cur.desc, cur.bear, cur.unassoc, cur.stereo, nbrs.angle,
            nbrs.desc, nbrs.bear, nbrs.unassoc, nbrs.stereo, E_12, epl2, scale_factors=sf)
        kargs = (cur.uv, cur.level, cur.bear, nbrs.uv, nbrs.level, nbrs.bear, poses,
                 idx2.contiguous(), accepted, pair_valid, cam, sig, sf, model)
        fn = lambda: mk.triangulate_checks(*kargs)
        rk, rp = fn(), mk.triangulate_checks_plain(*kargs)
        torch.cuda.synchronize()
        say(f"K {label}", dict(
            shape=f"{nbrs.uv.shape[0]}x{cur.uv.shape[0]}", matched=int(accepted.sum()),
            ok=int(rk.ok.sum()), device_ms=cs._device_ms(fn), one_call_ms=cs._median_ms(fn),
            cuda_kernels_a_call=cuda_kernels(fn), bits_apart_from_plain=cs.tri_bits_apart(rk, rp),
            bits_apart_from_other_tree=versus(f"K_{label}", (rk.pos_w, rk.idx2,
                                                             rk.ok.to(torch.uint8)))))


def probe_extract(dev, say, runs: int):
    from torch_pyramid_fuse_probe import rgbd_extract

    p50 = []
    for r in range(runs):
        out = rgbd_extract(dev)
        p50.append(out["extract_ms_p50"])
        say(f"RGBD slice extraction, run {r}", out)
    say("RGBD slice extraction p50 over runs", dict(
        median=float(np.median(p50)), min=float(np.min(p50)), max=float(np.max(p50))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--inputs", default=os.path.join(REPO, "_archive", "epipolar_inputs.pt"))
    ap.add_argument("--only", choices=("all", "r", "k", "extract"), default="all")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_finish_triangulate_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from stella_vslam_tpu_torch.kernels import build as kb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kb.load()
    tree = os.path.relpath(os.path.abspath(a.tree), REPO)
    say = lambda label, out: print(f"tree {tree}: {label}: {json.dumps(out)} [{card}]",
                                   flush=True)
    say("build", dict(seconds=kb.build_seconds))
    dev = torch.device("cuda", 0)
    outputs = {}
    other = torch.load(a.compare) if a.compare and os.path.exists(a.compare) else None

    def versus(key, tensors):
        """Elements whose bits differ from the other tree's outputs of `key`."""
        outputs[key] = [t.cpu() for t in tensors]
        if other is None or key not in other:
            return "no other tree"
        bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
        return [int((bits(x) != bits(y)).sum()) for x, y in zip(outputs[key], other[key])]

    if a.only in ("all", "r"):
        probe_r(cs, dev, say, versus)
        probe_frames(dev, say)
    if a.only in ("all", "k"):
        probe_k(cs, dev, say, versus, a.inputs)
    if a.only in ("all", "extract"):
        probe_extract(dev, say, a.runs)
    if a.save:
        torch.save(outputs, a.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
