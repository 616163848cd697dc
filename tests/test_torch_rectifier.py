"""The port's stereo rectifier (numpy tables, remap in torch) against cv2.

* the remap tables against cv2.initUndistortRectifyMap (radial-tangential
  with 5 coefficients and with the rational 8) and
  cv2.fisheye.initUndistortRectifyMap, at 752x480 with a rotation and a new
  camera matrix: equal (measured bit for bit);
* the remap against cv2.remap INTER_LINEAR on uint8 images, with source
  positions inside, across the border, far outside and non-finite: equal
  on every pixel (measured on 2.25 M random positions);
* twins of tests/test_stereo_rgbd.py's rectifier tests: identity tables
  leave the image as it is away from the border, distortion moves it; and
  an image distorted by a known camera is recovered as the JAX
  StereoRectifier (cv2) recovers it, pixel for pixel.
"""
import cv2
import numpy as np
import pytest
import torch

from stella_vslam_tpu.camera.base import camera_from_yaml as jcamera_from_yaml
from stella_vslam_tpu.util.stereo_rectifier import StereoRectifier as JaxRectifier
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.util.stereo_rectifier import (
    RemapTable, StereoRectifier, undistort_rectify_map)
from tests.synthetic_world import PlaneWorld
from tests.test_stereo_rgbd import _distortion_maps

torch.set_num_threads(1)

K = np.array([[458.0, 0.0, 376.0], [0.0, 457.0, 240.0], [0.0, 0.0, 1.0]])
K_NEW = np.array([[435.0, 0.0, 370.0], [0.0, 435.0, 245.0], [0.0, 0.0, 1.0]])


def _rot(ax, ay):
    cx, sx, cy, sy = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay)
    return np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]) @ \
        np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])


@pytest.mark.parametrize("model,D", [
    ("radtan", [-0.28, 0.07, 2e-4, 1.7e-5, 0.01]),
    ("rational", [-0.28, 0.07, 2e-4, 1.7e-5, 0.01, 0.02, 0.003, 0.001]),
    ("fisheye", [0.01, -0.005, 0.002, -0.0005]),
])
def test_tables_equal_cv2(model, D):
    D = np.array(D)
    R = _rot(0.02, -0.01)
    fisheye = model == "fisheye"
    init = cv2.fisheye.initUndistortRectifyMap if fisheye else cv2.initUndistortRectifyMap
    m1, m2 = init(K, D, R, K_NEW, (752, 480), cv2.CV_32FC1)
    u, v = undistort_rectify_map(K, D, R, K_NEW, (752, 480), fisheye=fisheye)
    np.testing.assert_array_equal(u, m1)
    np.testing.assert_array_equal(v, m2)


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    H, W = 480, 752
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    mx = rng.uniform(-3.0, W + 3.0, (H, W)).astype(np.float32)
    my = rng.uniform(-3.0, H + 3.0, (H, W)).astype(np.float32)
    # positions on a 1/64 grid (sums that land on a half) and odd entries
    mx[:40] = np.floor(mx[:40] * 64) / 64
    mx[0, :4] = [np.inf, -np.inf, np.nan, 1e9]
    my[1, :2] = [-1e20, np.nan]
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    out = RemapTable(mx, my, (W, H), device="cpu")(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, ref)


def _cam():
    node = {"model": "perspective", "setup": "stereo", "fx": 200.0, "fy": 200.0,
            "cx": 160.0, "cy": 120.0, "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
            "k3": 0.0, "cols": 320, "rows": 240, "fps": 30.0, "focal_x_baseline": 20.0}
    return camera_from_yaml(node)


def test_stereo_rectifier_identity_and_distortion():
    Kl = [200.0, 0.0, 160.0, 0.0, 200.0, 120.0, 0.0, 0.0, 1.0]
    R = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    params_id = {"K_left": Kl, "D_left": [0.0] * 5, "R_left": R,
                 "K_right": Kl, "D_right": [0.0] * 5, "R_right": R}
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 255, (240, 320), np.uint8))
    rect = StereoRectifier(_cam(), params_id, device="cpu")
    out_l, out_r = rect.rectify(img, img)
    inner = (slice(40, 200), slice(40, 280))
    assert torch.equal(out_l[inner], img[inner])
    assert torch.equal(out_r[inner], img[inner])
    params_dist = dict(params_id, D_left=[-0.3, 0.1, 0.0, 0.0, 0.0])
    out_l2, _ = StereoRectifier(_cam(), params_dist, device="cpu").rectify(img, img)
    assert not torch.equal(out_l2[inner], img[inner])


def test_distorted_image_recovered_as_jax_recovers_it():
    """An ideal rendering, distorted through a camera with known K, D and a
    mounting rotation (the inverse of the rectification), is rectified by
    the port exactly as the JAX StereoRectifier rectifies it, and close to
    the ideal image away from the border."""
    world = PlaneWorld()
    Kw = np.array([[world.fx, 0, world.cx], [0, world.fy, world.cy], [0, 0, 1.0]])
    D = np.array([-0.28, 0.07, 0.0, 0.0, 0.0])
    a = np.radians(0.8)
    R_l = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    R_r = R_l.T
    ideal = world.render(np.eye(4))
    raw_l = cv2.remap(ideal, *_distortion_maps(Kw, D, R_l, Kw, (world.W, world.H)),
                      cv2.INTER_LINEAR)
    raw_r = cv2.remap(ideal, *_distortion_maps(Kw, D, R_r, Kw, (world.W, world.H)),
                      cv2.INTER_LINEAR)
    cam = dict(world.camera_yaml(), setup="stereo", focal_x_baseline=world.fx * 0.12)
    params = {"model": "perspective",
              "K_left": Kw.reshape(-1).tolist(), "D_left": D.tolist(),
              "R_left": R_l.reshape(-1).tolist(),
              "K_right": Kw.reshape(-1).tolist(), "D_right": D.tolist(),
              "R_right": R_r.reshape(-1).tolist()}
    jl, jr = JaxRectifier(jcamera_from_yaml(cam), params).rectify(raw_l, raw_r)
    tl, tr = StereoRectifier(camera_from_yaml(cam), params, device="cpu").rectify(
        torch.from_numpy(raw_l), torch.from_numpy(raw_r))
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tr.numpy(), jr)
    inner = (slice(30, world.H - 30), slice(30, world.W - 30))
    err = np.abs(tl.numpy()[inner].astype(np.int32) - ideal[inner].astype(np.int32))
    assert np.median(err) <= 3, np.median(err)
