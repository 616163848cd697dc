"""Perspective camera and SE(3) helpers of the port against the JAX
package, on identical inputs from a numpy seed (EuRoC-like radial-
tangential distortion). Measured (CPU): undistorted keypoints, bearings
and reprojections bit-identical (max |diff| 0). Bounds: 1e-4 px for pixel
outputs and 1e-5 otherwise (f32 rounding of another summation order is
allowed). The equirectangular camera builds centred (its functions'
parity is tests/test_torch_equirect_camera.py); fisheye and radial
division build as the JAX version's (their functions' parity is
tests/test_torch_distorted_camera.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu.ops import lie as jlie
from stella_vslam_tpu_torch.camera import base as tcam
from stella_vslam_tpu_torch.ops import lie as tlie

torch.set_num_threads(1)

PARAMS = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
              k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, width=752,
              height=480)


def test_perspective_functions_match_jax():
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(0, 752, 500), rng.uniform(0, 480, 500)], -1).astype(np.float32)
    jp, tp = jcam.make_params(**PARAMS), tcam.make_params(**PARAMS)
    M = jcam.CameraModel.PERSPECTIVE
    # the JAX System's preprocessing runs the undistortion jitted (XLA's
    # reciprocal products and FMAs), which the port follows
    und_j = np.asarray(jax.jit(lambda a: jcam.undistort_keypoints(M, jp, a))(jnp.asarray(pts)))
    und_t = tcam.undistort_keypoints(M, tp, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(und_t, und_j, atol=1e-4)
    b_j = np.asarray(jcam.bearings_from_undistorted(M, jp, jnp.asarray(und_j)))
    b_t = tcam.bearings_from_undistorted(M, tp, torch.from_numpy(und_j.copy())).numpy()
    np.testing.assert_allclose(b_t, b_j, atol=1e-5)
    R, t = jlie.se3_exp(jnp.asarray([0.1, -0.2, 0.05, 0.02, -0.03, 0.01], jnp.float32))
    pos = np.concatenate([rng.uniform(-3, 3, (500, 2)), rng.uniform(-1, 8, (500, 1))],
                         -1).astype(np.float32)
    out_j = jcam.reproject_to_image(M, jp, R, t, jnp.asarray(pos))
    out_t = tcam.reproject_to_image(M, tp, torch.from_numpy(np.array(R)),
                                    torch.from_numpy(np.array(t)), torch.from_numpy(pos))
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), atol=1e-5)
    vis_j = np.asarray(out_j[2])
    assert vis_j.any() and not vis_j.all()
    np.testing.assert_array_equal(out_t[2].numpy(), vis_j)


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(6)
    xi = np.concatenate([rng.normal(0, 0.5, (64, 3)), rng.normal(0, 0.7, (64, 3))], -1)
    xi[:8, 3:] *= 1e-6  # the small-angle Taylor branch
    xi = xi.astype(np.float32)
    R_j, t_j = jlie.se3_exp(jnp.asarray(xi))
    R_t, t_t = tlie.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    noisy = (np.array(R_j) + rng.normal(0, 1e-3, (64, 3, 3))).astype(np.float32)
    np.testing.assert_allclose(tlie.so3_project(torch.from_numpy(noisy)).numpy(),
                               np.asarray(jlie.so3_project(jnp.asarray(noisy))), atol=1e-5)
    dR, dt = tlie.se3_update_left(R_t[:4], t_t[:4], torch.from_numpy(xi[4:8]))
    jR, jt = jlie.se3_update_left(R_j[:4], t_j[:4], jnp.asarray(xi[4:8]))
    np.testing.assert_allclose(dR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(jt), atol=1e-5)


@pytest.mark.parametrize("model", ["fisheye", "radial_division"])
def test_unported_models_raise(model):
    """The models that raised before they were ported now build from YAML
    with the JAX version's parameters (its name kept from then)."""
    node = {"model": model, "setup": "monocular", "cols": 640, "rows": 480, "fx": 300.0,
            "fy": 301.0, "cx": 320.5, "cy": 240.5, "k1": -0.12, "k2": 0.01, "k3": 0.002,
            "k4": -0.0005}
    cam = tcam.camera_from_yaml(node)
    ref = jcam.camera_from_yaml(node)
    assert cam.model == ref.model == jcam.CameraModel[model.upper()]
    assert cam.setup == ref.setup and (cam.width, cam.height) == (ref.width, ref.height)
    for name in tcam.CameraParams._fields:
        assert getattr(cam.params, name) == float(getattr(ref.params, name)), name


def test_equirect_camera_builds():
    """The equirectangular camera builds, centred on the image by default
    as the JAX version's (camera/base.py:407-410), and matches JAX's."""
    node = {"model": "equirectangular", "setup": "monocular", "cols": 640, "rows": 320}
    cam = tcam.camera_from_yaml(node)
    jc = jcam.camera_from_yaml(node)
    assert cam.model == tcam.CameraModel.EQUIRECTANGULAR
    assert (cam.params.cx, cam.params.cy) == (320.0, 160.0)
    assert (cam.params.cx, cam.params.cy) == (float(jc.params.cx), float(jc.params.cy))
    explicit = tcam.camera_from_yaml(dict(node, cx=300.0, cy=150.0))
    assert (explicit.params.cx, explicit.params.cy) == (300.0, 150.0)
