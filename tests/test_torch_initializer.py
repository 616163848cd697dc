"""The port's monocular Initializer against the JAX Initializer, on the CPU.

Both get the same two frames of the test plane world (400x300, 4 levels,
min_size 400, frames 0 and 5 of lateral_trajectory at 0.03 m/frame): the
JAX frames from the JAX System's preprocess, the port's built from the same
arrays (convert.frame), so the test holds the initializer alone. The port's
Initializer draws its RANSAC seeds from a seed source that replays the JAX
Initializer's key stream (PRNGKey(42) under use_fixed_seed, split into
k1..k4 per attempt, the escalated chunks from jax.random.split(k, 8)).
Bounds: init_matches equal (the area matcher is exact); R_21 within 1e-4
and the unit-depth-scaled t_21 within 1e-3 (f32 RANSAC models agree to
~1e-4 relative, the decomposition runs in f64 here and f32 in JAX);
triangulated points within 1e-3 where both keep them, and the kept sets
agree on >= 99% of the slots. Measured: R_21 6.5e-6, t_21 1.7e-5, points
8.2e-4 (a far point at unit median depth), kept sets identical (133).
"""
import jax
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.module.initializer import Initializer as JInitializer
from stella_vslam_tpu.ops.solve import ransac as jR
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.module.initializer import InitSeeds, Initializer
from tests.synthetic_world import PlaneWorld, lateral_trajectory

torch.set_num_threads(1)


def jax_seed_source(seed: int = 42):
    """The RANSAC seeds the JAX Initializer derives, attempt by attempt."""
    key = [jax.random.PRNGKey(seed)]
    s = lambda k: int(np.asarray(jR._seed_from_key(k)))

    def draw():
        key[0], k1, k2, k3, k4 = jax.random.split(key[0], 5)
        return InitSeeds(s(k1), s(k2), tuple(s(k) for k in jax.random.split(k3, 8)),
                         tuple(s(k) for k in jax.random.split(k4, 8)))
    return draw


def cfg_dict(world):
    return {"Camera": world.camera_yaml(), "Feature": {"num_levels": 4},
            "Preprocessing": {"min_size": 400}, "Initializer": {"use_fixed_seed": True}}


@pytest.fixture(scope="module")
def runs():
    world = PlaneWorld()
    gt = lateral_trajectory(6, step=0.03)
    jslam = JSystem(JConfig.from_dict(cfg_dict(world)), inline_mapping=True)
    jframes = [jslam.create_monocular_frame(world.render(gt[i]), i * 0.05)
               for i in (0, 5)]
    jinit = JInitializer(jslam.camera, jslam.orb_params, use_fixed_seed=True)
    cam = camera_from_yaml(world.camera_yaml())
    orb = OrbParams(num_levels=4)
    tinit = Initializer(cam, orb, seed_source=jax_seed_source())
    tframes = [convert.frame(f, cam, orb, device="cpu") for f in jframes]
    out = []
    for init, frames in ((jinit, jframes), (tinit, tframes)):
        assert init.try_initialize_monocular(frames[0]) is False
        out.append(init.try_initialize_monocular(frames[1]))
    return out, jinit, tinit


def test_initializer_succeeds_like_jax(runs):
    (ok_j, ok_t), _, _ = runs
    assert ok_j and ok_t


def test_init_matches_exact(runs):
    _, jinit, tinit = runs
    assert (np.asarray(jinit.init_matches) >= 0).sum() >= 50
    np.testing.assert_array_equal(np.asarray(jinit.init_matches), tinit.init_matches)


def test_motion_and_points_match_jax(runs):
    _, jinit, tinit = runs
    assert np.abs(np.asarray(jinit.R_21) - tinit.R_21).max() < 1e-4
    assert np.abs(np.asarray(jinit.t_21) - tinit.t_21).max() < 1e-3
    ok_j, ok_t = np.asarray(jinit.triangulated_ok), tinit.triangulated_ok
    assert np.mean(ok_j == ok_t) >= 0.99
    both = ok_j & ok_t
    assert both.sum() >= 50
    d = np.abs(np.asarray(jinit.triangulated_pts)[both] - tinit.triangulated_pts[both])
    assert d.max() < 1e-3
