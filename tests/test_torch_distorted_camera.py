"""The fisheye (Kannala-Brandt) and radial-division cameras of the port
against the JAX package, on identical inputs from a numpy seed: the six
distortion functions and `undistort_keypoints` within 1e-5 px or 4 float32
ulps of the pixel or of its offset from the principal point, whichever is
larger (the same operations in the same order, but XLA's CPU tan, atan
and division round differently from torch's: measured on a CPU, the
division model's undistortion equal, the Newton inversions and the
fisheye undistortion up to 2 ulps apart (1.2e-4 px at 716 px), the
fisheye distortion (atan, then the polynomial) up to 4; the TUM-VI
fisheye is compared on the interior of its image, as tests/test_cameras.py
does, since near its corners theta nears pi/2 and tan amplifies one ulp to
0.4 px), the round trips
of tests/test_cameras.py, the models' pinhole branch (bearings and
reprojection as the perspective camera's), and the distorted renderer's
float64 inverse against cv2.fisheye.undistortPoints within 1e-6 normalised
(cv2 in this test only: the port does not use it).
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu_torch.camera import base as tcam
from stella_vslam_tpu_torch.util import synthetic

torch.set_num_threads(1)

# tests/test_cameras.py's TUM-VI fisheye, the e2e test's coefficients at
# EuRoC size, and the division model
FISHEYE = dict(fx=190.978, fy=190.973, cx=254.931, cy=256.897, k1=0.003482389402,
               k2=0.000715034845, k3=-0.002053236141, k4=0.000202936736, width=512,
               height=512)
FISHEYE_E2E = dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0, k1=synthetic.FISH_D[0],
                   k2=synthetic.FISH_D[1], k3=synthetic.FISH_D[2], k4=synthetic.FISH_D[3],
                   width=752, height=480)
RADIAL = dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0, k1=synthetic.RADIAL_K1,
              width=752, height=480)
CASES = [("fisheye", FISHEYE), ("fisheye", FISHEYE_E2E), ("radial_division", RADIAL)]


def image_points(params, n=2000, seed=3):
    """Points over the whole image (its interior for the TUM-VI fisheye)
    with the principal point and corners (or interior corners) first."""
    rng = np.random.default_rng(seed)
    w, h = params["width"], params["height"]
    lo, hi = (0.15, 0.85) if params is FISHEYE else (0.0, 1.0)
    pts = np.stack([rng.uniform(w * lo, w * hi, n), rng.uniform(h * lo, h * hi, n)],
                   -1).astype(np.float32)
    pts[:4] = [[params["cx"], params["cy"]], [w * lo, h * lo], [w * hi, h * hi], [w * hi, h * lo]]
    return pts


def assert_within_ulps(t, j, params, ulps=4):
    """|t - j| <= max(1e-5, ulps float32 spacings of max(|j|, |j - c|))."""
    c = np.array([params["cx"], params["cy"]], np.float32)
    mag = np.maximum(np.abs(j), np.abs(j - c)).astype(np.float32)
    tol = np.maximum(1e-5, ulps * np.spacing(mag))
    bad = np.abs(t.astype(np.float64) - j) > tol
    assert not bad.any(), f"{bad.sum()} coordinates apart, worst {np.abs(t - j).max()}"


def interior_points(w, h, n=200, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(w * 0.15, w * 0.85, n), rng.uniform(h * 0.15, h * 0.85, n)],
                    axis=-1).astype(np.float32)


@pytest.mark.parametrize("model,params", CASES)
def test_distortion_functions_match_jax(model, params):
    pts = image_points(params)
    jp, tp = jcam.make_params(**params), tcam.make_params(**params)
    jfn = {"fisheye": (jcam.fisheye_undistort, jcam.fisheye_distort),
           "radial_division": (jcam.radial_division_undistort, jcam.radial_division_distort)}
    tfn = {"fisheye": (tcam.fisheye_undistort, tcam.fisheye_distort),
           "radial_division": (tcam.radial_division_undistort, tcam.radial_division_distort)}
    for jf, tf in zip(jfn[model], tfn[model]):
        j = np.asarray(jf(jp, jnp.asarray(pts)))
        t = tf(tp, torch.from_numpy(pts)).numpy()
        assert np.all(np.isfinite(t))
        assert_within_ulps(t, j, params)
    M = jcam.CameraModel[model.upper()]
    und_j = np.asarray(jcam.undistort_keypoints(M, jp, jnp.asarray(pts)))
    und_t = tcam.undistort_keypoints(tcam.CameraModel[model.upper()], tp,
                                     torch.from_numpy(pts)).numpy()
    assert_within_ulps(und_t, und_j, params)
    if model == "fisheye":
        th = np.linspace(0.0, 1.2, 64, dtype=np.float32)
        np.testing.assert_allclose(
            tcam._kb_distort_theta(tp, torch.from_numpy(th)).numpy(),
            np.asarray(jcam._kb_distort_theta(jp, jnp.asarray(th))), atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            tcam._kb_undistort_theta(tp, torch.from_numpy(th)).numpy(),
            np.asarray(jcam._kb_undistort_theta(jp, jnp.asarray(th))), atol=1e-6, rtol=0)


def test_fisheye_roundtrip():
    p = tcam.make_params(**FISHEYE)
    pts = torch.from_numpy(interior_points(512, 512))
    back = tcam.fisheye_distort(p, tcam.fisheye_undistort(p, pts))
    np.testing.assert_allclose(back.numpy(), pts.numpy(), atol=0.05)


def test_radial_division_roundtrip():
    p = tcam.make_params(fx=400.0, fy=400.0, cx=320.0, cy=240.0, k1=-1e-6, width=640,
                         height=480)
    pts = torch.from_numpy(interior_points(640, 480))
    back = tcam.radial_division_distort(p, tcam.radial_division_undistort(p, pts))
    np.testing.assert_allclose(back.numpy(), pts.numpy(), atol=0.02)


@pytest.mark.parametrize("model,params", CASES)
def test_pinhole_branch_matches_jax(model, params):
    """Bearings, their inverse and the reprojection of both models are the
    pinhole's, in both packages; the kernels take them as perspective."""
    M = jcam.CameraModel[model.upper()]
    TM = tcam.CameraModel[model.upper()]
    assert tcam.projection_family(TM) == tcam.projection_family(model) == 0
    assert tcam.undistortion_mode(TM) == int(M)
    jp, tp = jcam.make_params(**params), tcam.make_params(**params)
    und = interior_points(params["width"], params["height"], seed=7)
    b_j = np.asarray(jcam.bearings_from_undistorted(M, jp, jnp.asarray(und)))
    b_t = tcam.bearings_from_undistorted(TM, tp, torch.from_numpy(und)).numpy()
    np.testing.assert_allclose(b_t, b_j, atol=1e-6)
    np.testing.assert_allclose(
        tcam.undistorted_from_bearings(TM, tp, torch.from_numpy(b_j.copy())).numpy(),
        np.asarray(jcam.undistorted_from_bearings(M, jp, jnp.asarray(b_j))), atol=1e-4)
    rng = np.random.default_rng(9)
    pos = np.concatenate([rng.uniform(-3, 3, (300, 2)), rng.uniform(-1, 8, (300, 1))],
                         -1).astype(np.float32)
    R, t = np.eye(3, dtype=np.float32), np.array([0.1, -0.2, 0.3], np.float32)
    out_j = jcam.reproject_to_image(M, jp, jnp.asarray(R), jnp.asarray(t), jnp.asarray(pos))
    out_t = tcam.reproject_to_image(TM, tp, torch.from_numpy(R), torch.from_numpy(t),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), atol=1e-4, rtol=1e-6)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))


def test_renderer_inverse_matches_cv2_fisheye():
    """The renderer's Kannala-Brandt inverse (float64 Newton) against
    cv2.fisheye.undistortPoints over every pixel of the 752x480 leg."""
    fx, cx, cy = 458.0, 376.0, 240.0
    v, u = np.mgrid[0:480, 0:752].astype(np.float64)
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1.0]])
    ref = cv2.fisheye.undistortPoints(np.stack([u, v], -1).reshape(-1, 1, 2), K,
                                      np.asarray(synthetic.FISH_D).reshape(4, 1)).reshape(-1, 2)
    xu, yu = synthetic.kb_undistort_norm((u - cx) / fx, (v - cy) / fx)
    assert np.abs(ref[:, 0] - xu.ravel()).max() < 1e-6
    assert np.abs(ref[:, 1] - yu.ravel()).max() < 1e-6
    # and the division model's closed form against its forward map
    xr, yr = synthetic.radial_division_undistort_norm((u - cx) / fx, (v - cy) / fx)
    rd2 = ((u - cx) / fx) ** 2 + ((v - cy) / fx) ** 2
    np.testing.assert_allclose(xr * (1 + synthetic.RADIAL_K1 * rd2), (u - cx) / fx, atol=1e-12)
    np.testing.assert_allclose(yr * (1 + synthetic.RADIAL_K1 * rd2), (v - cy) / fx, atol=1e-12)
