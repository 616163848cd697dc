"""The fisheye and radial-division legs in both packages, inline, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_distorted_parity.py \
        [--leg fisheye|radial_division|fisheye_masked] [--frames N] [--seeds 42,1,...]

Runs each leg of util/distorted_slice.py (the plane world at 752x480
through the leg's camera, 8 levels, min_size 800, the mono slice's first
120 frames, Initializer use_fixed_seed, mapping on; the masked leg with
its vignette mask) in the JAX package's System and in the port's, both
with inline mapping (the deterministic mode), on the same frames (the
port's renderer's), and prints one JSON line per package and leg: the init
frame, frames tracked and lost after init, the Sim3 ATE and scale,
keyframes kept. Each package draws its own RANSAC seeds, as on the card:
by default each Initializer's fixed seed (use_fixed_seed: 42 in both);
with --seeds, one run per seed, the JAX Initializer's key PRNGKey(seed)
and the port's generator seeded with it.
A CPU tool for the parity of the two packages (it imports both); the
port's card run of the same legs is util/distorted_slice.py.
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
    ap.add_argument("--leg", choices=("fisheye", "radial_division", "fisheye_masked"),
                    default=None)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated RANSAC seeds, one run of each package per seed")
    args = ap.parse_args()
    import torch

    from stella_vslam_tpu.config import Config as JConfig
    from stella_vslam_tpu.system import System as JSystem
    import jax

    from stella_vslam_tpu_torch.module.initializer import generator_seed_source
    from stella_vslam_tpu_torch.util import distorted_slice as ds
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.equirect_slice import trajectory_stats

    torch.set_num_threads(4)
    for leg in ([args.leg] if args.leg else ds.LEGS):
        world = ds.leg_world(leg)
        path = ds.leg_path(args.frames)
        mask = ds.leg_mask(leg, world)
        frames = [world.render(pose_at_xy(x, y)) for x, y in path]
        centres = [(x, y, 0.0) for x, y in path]
        cfg = {"Camera": world.camera_yaml(), "Feature": {"num_levels": 8},
               "Preprocessing": {"min_size": 800}, "Initializer": {"use_fixed_seed": True}}
        seeds = [None] if args.seeds is None else [int(v) for v in args.seeds.split(",")]
        for seed in seeds:
            js = JSystem(JConfig.from_dict(cfg), inline_mapping=True)
            js.startup()
            if seed is not None:
                js.tracker.initializer._key = jax.random.PRNGKey(seed)
            ps = ds.make_system(world, "cpu", inline_mapping=True)
            if seed is not None:
                gen = torch.Generator()
                gen.manual_seed(seed)
                ps.tracker.initializer.seed_source = generator_seed_source(gen)
            for package, slam in (("jax", js), ("port", ps)):
                t0 = time.perf_counter()
                for i, img in enumerate(frames):
                    slam.feed_monocular_frame(img, i * 0.05, mask)
                slam.shutdown()
                print(json.dumps(dict(package=package, leg=leg, masked=mask is not None,
                                      seed=seed, **trajectory_stats(slam.frame_poses, centres),
                                      keyframes_kept=slam.map_db.num_keyframes(),
                                      wall_s=time.perf_counter() - t0)), flush=True)

if __name__ == "__main__":
    main()
