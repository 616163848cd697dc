"""The fisheye and radial-division legs in both packages, inline, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_distorted_parity.py \
        [--leg fisheye|radial_division|fisheye_masked|loop_world] [--frames N]
        [--seeds 42,1,...] [--jax-takes-port-inputs]

Runs each leg of util/distorted_slice.py (the plane world at 752x480
through the leg's camera, 8 levels, min_size 800, the mono slice's first
120 frames, Initializer use_fixed_seed, mapping on; the masked leg with
its vignette mask) in the JAX package's System and in the port's, both
with inline mapping (the deterministic mode), on the same frames (the
port's renderer's), and prints one JSON line per package and leg: the init
frame, frames tracked and lost after init, the Sim3 ATE and scale,
keyframes kept. Both packages draw the same RANSAC seeds, as on the card:
by default each Initializer's fixed key (use_fixed_seed: PRNGKey(42) in
both); with --seeds, one run per seed, the JAX Initializer's key
PRNGKey(seed) and the port's key_seed_source(seed), the same stream.

`--leg loop_world` runs tests/test_loop_closure.py's out-and-back instead
(the plane world at 400x300, fx 320, plane at 4 m, 4 levels, min_size 400,
mapping and the loop detector on): 65 frames out to x = 6.4 m, the segment
drift injected (0.55 m, 3 degrees), 104 frames back. Per package and seed
it prints the init frame and rotation, the landmarks after the init pair's
keyframe event, frames tracked and lost, loops closed and the Sim3 ATE;
then, for the F-RANSAC call that initialized each package, both packages'
per-hypothesis costs on their own inputs (the JAX functions jitted, as the
JAX System's find_via_ransac runs them, on JAX's points; the port's plain
version on the port's): the largest difference of
the inputs, each winner and its cost, and the share of hypotheses whose
costs differ by more than 1e-3 relative (an 8-point F of a planar scene is
near-degenerate). With --jax-takes-port-inputs the port runs first and the
JAX package's initializing F-RANSAC calls are handed the port's points
(the same matches, the port's undistortion rounding).

A CPU tool for the parity of the two packages (it imports both); the
port's card run of the distorted legs is util/distorted_slice.py, its own
loop-world run tests/test_torch_loop.py::test_port_loop_closure_end_to_end
(slow).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def distorted_legs(args):
    import jax
    import torch

    from stella_vslam_tpu.config import Config as JConfig
    from stella_vslam_tpu.system import System as JSystem
    from stella_vslam_tpu_torch.module.initializer import key_seed_source
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
                ps.tracker.initializer.seed_source = key_seed_source(seed)
            for package, slam in (("jax", js), ("port", ps)):
                t0 = time.perf_counter()
                for i, img in enumerate(frames):
                    slam.feed_monocular_frame(img, i * 0.05, mask)
                slam.shutdown()
                print(json.dumps(dict(package=package, leg=leg, masked=mask is not None,
                                      seed=seed, **trajectory_stats(slam.frame_poses, centres),
                                      keyframes_kept=slam.map_db.num_keyframes(),
                                      wall_s=time.perf_counter() - t0)), flush=True)


def loop_world(args):
    import tests.conftest  # noqa: F401  (jax on the CPU, as tests/test_loop_closure.py runs)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from stella_vslam_tpu.config import Config as JConfig
    from stella_vslam_tpu.module import initializer as jinit
    from stella_vslam_tpu.ops.solve import fundamental as jfm
    from stella_vslam_tpu.ops.solve import homography as jhm
    from stella_vslam_tpu.ops.solve import ransac as jransac
    from stella_vslam_tpu.system import System as JSystem
    from stella_vslam_tpu.util.drift import inject_segment_drift as jax_drift
    from stella_vslam_tpu_torch.config import Config
    from stella_vslam_tpu_torch.module import initializer as tinit
    from stella_vslam_tpu_torch.module.initializer import key_seed_source
    from stella_vslam_tpu_torch.ops.solve import fundamental as tfm
    from stella_vslam_tpu_torch.ops.solve import homography as thm
    from stella_vslam_tpu_torch.ops.solve import ransac as transac
    from stella_vslam_tpu_torch.system import System
    from stella_vslam_tpu_torch.util.drift import inject_segment_drift, pose_at_x
    from stella_vslam_tpu_torch.util.mono_slice import trajectory_stats
    from tests.synthetic_world import PlaneWorld
    from tests.test_torch_initializer import cfg_dict

    torch.set_num_threads(4)
    world = PlaneWorld(width=400, height=300, fx=320.0, depth=4.0, tex_size=2048,
                       meters_per_px=0.01)
    xs = [i * 0.1 for i in range(65)]
    xs_back = [6.4 - i * 0.1 for i in range(1, 45)] + [2.0 - i * 0.05 for i in range(1, 61)]
    frames = [world.render(pose_at_x(x)) for x in xs + xs_back]
    # each package's F-RANSAC calls in order: (seed or key, p1, p2, mask, B)
    calls = {"jax": [], "port": []}
    # and their results: (F_21 after the LO refit, the inlier mask)
    results = {"jax": [], "port": []}

    def spy(mod, package):
        fn = mod.fsolve.find_via_ransac

        def rec(seed_or_key, p1, p2, mv, **kw):
            log = calls[package]
            if package == "jax" and args.jax_takes_port_inputs:
                _, q1, q2, qv, _ = calls["port"][len(log)]
                if not np.array_equal(np.asarray(mv), qv):
                    raise RuntimeError("loop_world: the packages' F-RANSAC matches differ")
                p1, p2 = jnp.asarray(q1), jnp.asarray(q2)
            log.append((seed_or_key, np.asarray(p1).copy(), np.asarray(p2).copy(),
                        np.asarray(mv).copy(), kw.get("num_hypotheses", 256)))
            out = fn(seed_or_key, p1, p2, mv, **kw)
            results[package].append((np.asarray(out.F_21).copy(), np.asarray(out.is_inlier).copy()))
            return out
        mod.fsolve.find_via_ransac = rec

    spy(jinit, "jax")
    spy(tinit, "port")

    def jax_hypotheses(key, p1, p2, mv, B):
        """Every hypothesis's cost and inlier count as the JAX System's
        jitted find_via_ransac computes them (its _find_core's first half)."""
        idx = jransac.sample_minimal_sets(key, mv, B, 8)
        F = jfm.compute_F_21(jransac.gather_sets(p1, idx), jransac.gather_sets(p2, idx))
        inl, c = jfm._epipolar_cost(F, p1[None], p2[None], 1.0)
        return (jnp.sum(jnp.where(mv[None], c, 0.0), axis=-1),
                jnp.sum(inl & mv[None], axis=-1))

    jax_hypotheses = jax.jit(jax_hypotheses, static_argnames=("B",))

    def f_costs():
        key, p1, p2, mv, B = calls["jax"][-1]
        cj, nj = (np.asarray(a) for a in jax_hypotheses(
            key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mv), B=B))
        seed, q1, q2, qv, _ = calls["port"][-1]
        _, ct, nt = transac.minimal_hypotheses_plain(
            tfm.MODEL, seed, torch.from_numpy(q1), torch.from_numpy(q2), torch.from_numpy(qv),
            B, 1.0)
        ct, nt = ct.numpy(), nt.numpy()
        gj, gt = np.where(nj > 8, cj, np.inf), np.where(nt > 8, ct, np.inf)
        (Fj, inl_j), (Ft, inl_t) = results["jax"][-1], results["port"][-1]
        # the winner's refit: its normalisation over the winner's inliers in
        # both packages (JAX's jitted _normalize), then the refit's model
        wj = jransac.sample_minimal_sets(key, jnp.asarray(mv), B, 8)[int(gj.argmin())]
        Fw = jax.jit(jfm.compute_F_21)(jnp.asarray(p1)[wj], jnp.asarray(p2)[wj])
        win = np.asarray(jax.jit(lambda F, a, b: jfm._epipolar_cost(F, a, b, 1.0)[0])(
            Fw, jnp.asarray(p1), jnp.asarray(p2))) & mv
        norm_j = [np.asarray(a) for p in (p1, p2) for a in jax.jit(jhm._normalize)(
            jnp.asarray(p), jnp.asarray(win))]
        norm_t = [a.numpy() for q in (q1, q2) for a in thm._normalize(
            torch.from_numpy(q), torch.from_numpy(win))]
        bits = lambda a: np.asarray(a, np.float32).view(np.int32)
        refit = dict(
            winner_inliers=int(win.sum()),
            normalize_apart=int(sum((bits(a) != bits(b)).sum() for a, b in zip(norm_j, norm_t))),
            final_F_apart=int((bits(Fj) != bits(Ft)).sum()),
            final_F_max_rel=float(np.abs(Fj / np.linalg.norm(Fj) - Ft / np.linalg.norm(Ft)).max()),
            final_inliers_equal=bool(np.array_equal(inl_j, inl_t)))
        return dict(refit=refit,input_max_diff_px=float(max(np.abs(p1 - q1).max(), np.abs(p2 - q2).max())),
                    matches_equal=bool(np.array_equal(mv, qv)), hypotheses=B,
                    jax_winner=int(gj.argmin()), jax_cost=float(gj.min()),
                    port_winner=int(gt.argmin()), port_cost=float(gt.min()),
                    share_cost_differs_1e3=float(np.mean(
                        np.abs(cj - ct) > 1e-3 * np.maximum(np.abs(cj), 1e-6))))

    seeds = [42] if args.seeds is None else [int(v) for v in args.seeds.split(",")]
    for seed in seeds:
        calls["jax"].clear()
        calls["port"].clear()
        for package in ("port", "jax"):
            if package == "jax":
                slam = JSystem(JConfig.from_dict(cfg_dict(world)), inline_mapping=True)
                slam.tracker.initializer._key = jax.random.PRNGKey(seed)
                drift = jax_drift
            else:
                slam = System(Config.from_dict(cfg_dict(world)), device="cpu",
                              inline_mapping=True)
                slam.enable_mapping_module()
                slam.tracker.initializer.seed_source = key_seed_source(seed)
                drift = inject_segment_drift
            slam.startup()
            t0 = time.perf_counter()
            init_lms = None
            for i, img in enumerate(frames):
                if i == len(xs):
                    if package == "jax":
                        slam.tracker.finalize_pending()
                    drift(slam, tx_metric=0.55, yaw_deg=3.0, cutoff_frac=0.3,
                          gt_span_metric=6.4)
                slam.feed_monocular_frame(img, i * 0.2)
                if init_lms is None and slam.map_db.num_keyframes() >= 2:
                    init_lms = slam.map_db.num_landmarks()
            slam.shutdown()
            first, tracked, lost, ate, scale = trajectory_stats(
                slam.frame_poses, [(x, 0.0) for x in xs + xs_back])
            R = np.asarray(slam.tracker.initializer.R_21, np.float64)
            print(json.dumps(dict(
                package=package, seed=seed,
                f_inputs="port" if package == "jax" and args.jax_takes_port_inputs else package,
                init_frame=first, init_rotation_deg=float(np.degrees(np.arccos(np.clip(
                    (np.trace(R) - 1) / 2, -1, 1)))),
                landmarks_after_init_event=init_lms, tracked=tracked, lost_after_init=lost,
                loops_closed=slam.global_optimizer.num_loops_closed, ate_m=ate,
                sim3_scale=scale, wall_s=time.perf_counter() - t0)), flush=True)
        print(json.dumps(dict(seed=seed, init_f_ransac=f_costs())), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=("fisheye", "radial_division", "fisheye_masked",
                                      "loop_world"), default=None)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated RANSAC seeds, one run of each package per seed")
    ap.add_argument("--jax-takes-port-inputs", action="store_true",
                    help="loop_world: hand the JAX package's F-RANSAC the port's points")
    args = ap.parse_args()
    if args.leg == "loop_world":
        loop_world(args)
    else:
        distorted_legs(args)


if __name__ == "__main__":
    main()
