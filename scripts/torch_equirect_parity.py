"""bench.py's equirectangular leg in both packages, inline, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_equirect_parity.py [--frames N]

Runs the leg (the 640x320 box room, 6 levels, 250 frames on the 1.8 m
circle, Initializer use_fixed_seed, mapping and the loop detector on) in
the JAX package's System and in the port's, both with inline mapping (the
deterministic mode), and prints one JSON line per package: the init frame,
frames tracked and lost after init, the Sim3 ATE, keyframes kept and loops
closed. A CPU tool for the parity of the two packages (it imports both);
the port's card run of the same leg is util/equirect_slice.py.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=250)
    args = ap.parse_args()
    import torch

    from stella_vslam_tpu.config import Config as JConfig
    from stella_vslam_tpu.system import System as JSystem
    from stella_vslam_tpu_torch.util import equirect_slice
    from stella_vslam_tpu_torch.util.synthetic import equirect_circle

    torch.set_num_threads(4)
    world = equirect_slice.bench_world()
    poses, centres = equirect_circle(250)
    poses, centres = poses[:args.frames], centres[:args.frames]
    cfg = {"Camera": world.camera_yaml(), "Feature": {"num_levels": 6},
           "Initializer": {"use_fixed_seed": True}}
    js = JSystem(JConfig.from_dict(cfg), inline_mapping=True)
    js.startup()
    t0 = time.perf_counter()
    for i, T in enumerate(poses):
        js.feed_monocular_frame(world.render(T), i * 0.05)
    js.shutdown()
    print(json.dumps(dict(
        package="jax", **equirect_slice.trajectory_stats(js.frame_poses, centres),
        keyframes_kept=js.map_db.num_keyframes(),
        loops_closed=js.global_optimizer.num_loops_closed,
        wall_s=time.perf_counter() - t0)), flush=True)
    ts = equirect_slice.run_leg("cpu", world, poses, centres, slam=equirect_slice.make_system(
        world, "cpu", inline_mapping=True))
    print(json.dumps(dict(package="port", **{k: ts[k] for k in (
        "init_frame", "tracked", "lost_after_init", "ate_m", "sim3_scale", "keyframes_kept",
        "loops_closed", "wall_s")})), flush=True)


if __name__ == "__main__":
    main()
