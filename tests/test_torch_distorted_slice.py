"""The fisheye and radial-division slices in both packages, inline on the
CPU: the JAX package's end-to-end world and gates
(tests/test_fisheye_radial_e2e.py:51-104: the plane world at 560x400, fx
300, 4 levels, min_size 400, 28 frames of lateral_trajectory at 0.03 m a
frame), each frame rendered once by the port's distorted renderer
(util/synthetic.DistortedPlaneWorld, the e2e test's coefficients) and fed
to both Systems; the port's Initializer draws the JAX Initializer's RANSAC
seeds (tests/test_torch_initializer.py). Both pass the e2e test's gates
(>= 18 tracked, ATE under 7% of the path, >= 2 keyframes, > 80 landmarks),
and the port agrees with JAX: the init frame within 1, the tracked counts
within 1, and the Sim3 ATE within 10 mm (1.2% of the 0.81 m path).
Measured on a CPU: fisheye both init at frame 5 (12.7 mm for JAX);
radial division the port at frame 4 (14.7 mm), JAX at frame 5 (10.2 mm):
the two-view geometry of a planar scene is near-degenerate, and the
resized pyramid levels round differently in the two packages
(tests/test_torch_orb.py), so an init attempt at the parallax threshold
can go either way, as for the perspective slice
(tests/test_torch_mono_slice.py).
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util.equirect_slice import trajectory_stats
from stella_vslam_tpu_torch.util.synthetic import (DistortedPlaneWorld, PlaneWorld,
                                                   lateral_trajectory)
from tests.test_torch_initializer import jax_seed_source

torch.set_num_threads(1)

N_FRAMES = 28


def cfg_dict(world):
    return {"Camera": world.camera_yaml(), "Feature": {"num_levels": 4},
            "Preprocessing": {"min_size": 400}, "Initializer": {"use_fixed_seed": True}}


def run(system, frames):
    system.startup()
    for i, img in enumerate(frames):
        system.feed_monocular_frame(img, i * 0.05)
    system.shutdown()
    return system


def check_e2e_gates(slam, stats, traj_len):
    assert stats["tracked"] >= 18, f"only {stats['tracked']}/{N_FRAMES} frames tracked"
    assert stats["ate_m"] / traj_len < 0.07, f"ATE {stats['ate_m']:.3f} m over {traj_len:.2f} m"
    assert slam.map_db.num_keyframes() >= 2
    assert slam.map_db.num_landmarks() > 80


@pytest.mark.parametrize("model", ["fisheye", "radial_division"])
def test_distorted_slice_matches_jax(model):
    world = DistortedPlaneWorld(PlaneWorld(width=560, height=400, fx=300.0, fy=300.0, depth=4.0,
                                           tex_size=2048, meters_per_px=0.01), model)
    poses = lateral_trajectory(N_FRAMES, step=0.03)
    frames = [world.render(T) for T in poses]
    centres = [-T[:3, :3].T @ T[:3, 3] for T in poses]
    traj_len = float(np.linalg.norm(np.diff(np.asarray(centres), axis=0), axis=1).sum())
    js = run(JSystem(JConfig.from_dict(cfg_dict(world)), inline_mapping=True), frames)
    ps = System(Config.from_dict(cfg_dict(world)), device="cpu", inline_mapping=True)
    ps.tracker.initializer.seed_source = jax_seed_source()
    run(ps, frames)
    j, p = trajectory_stats(js.frame_poses, centres), trajectory_stats(ps.frame_poses, centres)
    check_e2e_gates(js, j, traj_len)
    check_e2e_gates(ps, p, traj_len)
    assert abs(p["init_frame"] - j["init_frame"]) <= 1
    assert abs(p["tracked"] - j["tracked"]) <= 1
    assert abs(p["ate_m"] - j["ate_m"]) < 0.010, (p["ate_m"], j["ate_m"])
