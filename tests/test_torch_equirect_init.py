"""The port's bearing-vector initializer (module/initializer.py's E path,
on the plain versions of kernels E and U) against the JAX package's, on the
CPU, on BoxWorld frames of tests/test_equirect_e2e.py's path (512x256, 4
levels, min_size 300).

The JAX System extracts frames 0 and 3 (the pair both packages initialize
from in tests/test_torch_equirect_slice.py); convert.frame hands the same
keypoints, descriptors and bearings to the port; the port's Initializer
draws the JAX Initializer's RANSAC seeds. Twice: as the System runs it,
and with the escalation threshold above 1 in both, so that the escalated
E sweep (8 x 4096) and the 5-point sweep (1024 sets) run and the better of
the two is taken. Bounds (tests/test_torch_initializer.py's): the same
matches; init motion within 1e-4 (rotation) and 1e-3 (translation);
triangulation flags equal on >= 99% of the slots; points within 1e-3 of
their distance (measured 6.8e-4: the 360 camera triangulates points all
around, some 4 units out along the baseline, where the midpoint's float32
rounding grows with the distance).
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.module.initializer import Initializer as JInitializer
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.module.initializer import Initializer
from stella_vslam_tpu_torch.util.synthetic import BoxWorld
from tests.test_torch_equirect_slice import e2e_path
from tests.test_torch_initializer import jax_seed_source

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    world = BoxWorld(width=512, height=256, half=4.0)
    gt, _ = e2e_path(4)
    cfg = {"Camera": world.camera_yaml(), "Feature": {"num_levels": 4},
           "Preprocessing": {"min_size": 300}, "Initializer": {"use_fixed_seed": True}}
    jslam = JSystem(JConfig.from_dict(cfg), inline_mapping=True)
    jframes = [jslam.create_monocular_frame(world.render(gt[i]), i * 0.05) for i in (0, 3)]
    cam = camera_from_yaml(world.camera_yaml())
    orb = OrbParams(num_levels=4)
    tframes = [convert.frame(f, cam, orb, device="cpu") for f in jframes]
    return jslam, jframes, cam, orb, tframes


@pytest.mark.parametrize("escalate", [False, True])
def test_bearing_initializer_matches_jax(frames, escalate):
    jslam, jframes, cam, orb, tframes = frames
    thr = 1.01 if escalate else 0.45
    jinit = JInitializer(jslam.camera, jslam.orb_params, use_fixed_seed=True,
                         escalation_ratio_thr=thr)
    tinit = Initializer(cam, orb, seed_source=jax_seed_source(), escalation_ratio_thr=thr)
    ok = []
    for init, fr in ((jinit, jframes), (tinit, tframes)):
        assert init.try_initialize_monocular(fr[0]) is False
        ok.append(init.try_initialize_monocular(fr[1]))
    assert ok == [True, True]
    assert tinit.num_escalations == int(escalate)
    np.testing.assert_array_equal(np.asarray(jinit.init_matches), tinit.init_matches)
    assert (tinit.init_matches >= 0).sum() >= 50
    np.testing.assert_allclose(tinit.R_21, np.asarray(jinit.R_21), atol=1e-4)
    np.testing.assert_allclose(tinit.t_21, np.asarray(jinit.t_21), atol=1e-3)
    ok_j, ok_t = np.asarray(jinit.triangulated_ok), tinit.triangulated_ok
    assert np.mean(ok_j == ok_t) >= 0.99
    both = ok_j & ok_t
    assert both.sum() >= 50
    pj = np.asarray(jinit.triangulated_pts)[both]
    d = np.linalg.norm(pj - tinit.triangulated_pts[both], axis=1)
    assert (d / np.linalg.norm(pj, axis=1)).max() < 1e-3
    # a 360 camera keeps points behind it: the positive-depth test is off
    assert (tinit.triangulated_pts[ok_t][:, 2] < 0).any()
