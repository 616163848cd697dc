"""The sharded global BA across the cards of one host (K22, kernel W over peer access).

    python scripts/torch_sharded_ba.py [--frames N]

Needs two or more CUDA cards. Runs the loop slice (util/loop_slice.py, the
bench's 1290-frame circuit, inline) on cuda:0 with `ba_devices` set to
every visible card (the System's default is the one-device BA): its global
and loop BAs shard their
landmark rows over the cards, kernel W on each card reading the other
cards' partials in place. It holds the run to the loop slice's gates and
records each global BA problem. Then, on each recorded problem and on
synthetic ones at the global shapes (K = 32 and 64, L = 4096, D = 16), it
holds to the unsharded BA on cuda:0, bit for bit: the unsharded BA on every
other card, the sharded BA across the cards and the sharded BA on as many
shards of cuda:0 alone. Prints one JSON line of the results, with the
cards' names and power limits.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def same(a, b) -> bool:
    import torch

    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def compare_routes(problems, devices):
    """For each (label, problem, camera): whether the unsharded BA on every
    device, the sharded BA across `devices` and the sharded BA on as many
    shards of devices[0] give the unsharded BA's bits on devices[0]."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.parallel import sharded_ba

    out = {}
    for label, prob, c in problems:
        def run(p, shards=None):
            if shards is None:
                return ba.bundle_adjust(p, c, num_first=16, num_second=0)
            return sharded_ba.sharded_bundle_adjust(p, c, num_first=16, num_second=0,
                                                    devices=shards)

        def moved(d):
            return prob.__class__(*[None if x is None else x.to(d) for x in prob])

        ref = run(moved(devices[0]))
        row = {f"unsharded {d}": same(ref, run(moved(d))) for d in devices[1:]}
        t0 = time.perf_counter()
        row["sharded across the cards"] = same(ref, run(moved(devices[0]), devices))
        row["sharded_s"] = time.perf_counter() - t0
        row[f"sharded on {len(devices)} shards of {devices[0]}"] = same(
            ref, run(moved(devices[0]), [devices[0]] * len(devices)))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out[label] = row
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=None,
                    help="feed only the circuit's first N frames (default: all 1290; "
                         "0: no loop slice, the synthetic problems only)")
    args = ap.parse_args()
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"torch_sharded_ba: needs two or more CUDA cards, found {n}")
    import chip_smoke
    from stella_vslam_tpu_torch.parallel import sharded_ba
    from stella_vslam_tpu_torch.util import loop_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    devices = [torch.device("cuda", i) for i in range(n)]
    dev = devices[0]
    world = bench_world()
    slam = loop_slice.make_system(world, dev, ba_devices=devices)
    recorded = []
    solve = sharded_ba.sharded_bundle_adjust

    def rec(prob, *a, **kw):
        recorded.append(prob)
        return solve(prob, *a, **kw)

    summary = None
    if args.frames != 0:
        sharded_ba.sharded_bundle_adjust = rec
        try:
            gt = loop_slice.circuit()[:args.frames]
            stats = loop_slice.run_slice(dev, world, gt_xy=gt,
                                         n_out=min(loop_slice.N_OUT, len(gt)), slam=slam)
        finally:
            sharded_ba.sharded_bundle_adjust = solve
        summary = {k: stats[k] for k in ("frames", "init_frame", "tracked", "lost_after_init",
                                         "ate_m", "loops_closed", "keyframes_created",
                                         "keyframes_kept", "solver_shapes")}
        summary["w_launches"] = stats["launches"]["ba_shard_assemble"]
    cam = slam.mapper.cam_scalars
    problems = [(f"loop slice global BA {i} K={p.cam_R.shape[0]} L={p.obs_cam.shape[0]} "
                 f"D={p.obs_cam.shape[1]}", p, cam) for i, p in enumerate(recorded)]
    problems += [(f"K={K} L=4096 D=16", *chip_smoke._ba_problem(
        dev, K, 4096, 16, False, seed, spacing=0.1, ordered=True))
        for K, seed in ((32, 81), (64, 82))]
    routes = compare_routes(problems, devices)
    ok = all(v for r in routes.values() for k, v in r.items() if not k.endswith("_s"))
    gates = args.frames is not None or (
        stats["loops_closed"] >= 1 and stats["ate_m"] < 0.10 and stats["lost_after_init"] <= 8)
    print(json.dumps(dict(cards=cards, devices=[str(d) for d in devices],
                          peer_access=[[torch.cuda.can_device_access_peer(a, b) if a != b
                                        else None for b in range(n)] for a in range(n)],
                          loop_slice=summary, routes=routes, bit_identical=ok,
                          loop_gates=gates)))
    if not (ok and gates and (recorded or args.frames == 0)):
        raise SystemExit("torch_sharded_ba: a route differs, the loop slice missed its gates, "
                         "or no global BA ran")


if __name__ == "__main__":
    main()
