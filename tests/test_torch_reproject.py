"""Kernel R's plain versions against the JAX package, on the CPU.

`reproject_gate` on points against stella_vslam_tpu/camera/base.py
reproject_to_image (:232) with the cascade's x_right
(module/tracking_kernels.py:214-218); on the packed landmark table against
the stage-3 expressions of track_frame (:266-285): the in-image test,
distance in [0.8 min, 1.3 max], cos(ray, normal) > 0.5, depth > 0, the
table's valid flag, and the predicted level; `undistort_norm` against
perspective_undistort (:97, _perspective_undistort_norm's 10 iterations).
Inputs from a numpy seed, EuRoC's radial-tangential distortion. Bounds:
uv, x_right and undistorted keypoints within 1e-5 relative (pixels, at
least 1 px of scale); flags and levels equal except where the deciding
quantity lies within 1e-6 of its threshold (counted; none on these inputs).
"""
import jax.numpy as jnp
import numpy as np
import torch

from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu.ops import lie as jlie
from stella_vslam_tpu_torch.camera import base as tcam

torch.set_num_threads(1)

PARAMS = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
              k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, width=752, height=480,
              focal_x_baseline=458.654 * 0.11)
LOG_SCALE = float(np.log(np.float32(1.2)))
LEVELS = 8


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _scene(seed, C):
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 6.0, C)
    back = rng.random(C) < 0.1
    z[back] = -(z[back] + 0.5)
    pos = np.stack([rng.uniform(-4, 4, C), rng.uniform(-3, 3, C), z], -1).astype(np.float32)
    normal = rng.normal(size=(C, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d = np.linalg.norm(pos, axis=1)
    tbl = np.zeros((C, 8), np.float32)
    tbl[:, 0:3] = pos
    tbl[:, 3:6] = normal
    tbl[:, 6] = d * rng.uniform(0.9, 1.5, C)
    tbl[:, 7] = d * rng.uniform(0.8, 2.8, C)
    u32 = np.zeros((C, 10), np.int32)
    u32[:, 9] = rng.random(C) < 0.9
    R, t = jlie.se3_exp(jnp.asarray([0.1, -0.2, 0.05, 0.02, -0.03, 0.01], jnp.float32))
    return np.array(R), np.array(t), tbl, u32


def _jax_gate(jp, R, t, tbl, u32):
    """track_frame's stage 3 (stella_vslam_tpu/module/tracking_kernels.py:266-285)."""
    R, t, tbl = jnp.asarray(R), jnp.asarray(t), jnp.asarray(tbl)
    pos, normal, dmin, dmax = tbl[:, 0:3], tbl[:, 3:6], tbl[:, 6], tbl[:, 7]
    uv, depth, in_img = jcam.reproject_to_image(jcam.CameraModel.PERSPECTIVE, jp, R, t, pos)
    cam_center = -R.T @ t
    ray = pos - cam_center
    dist = jnp.linalg.norm(ray, axis=-1)
    dist_ok = (dist >= 0.8 * dmin) & (dist <= 1.3 * dmax)
    cosang = jnp.sum(ray * normal, axis=-1) / jnp.maximum(dist, 1e-9)
    observable = (jnp.asarray(u32[:, 9]) > 0) & in_img & dist_ok & (cosang > 0.5) & (depth > 0)
    ratio = jnp.maximum(dmax, 1e-9) / jnp.maximum(dist, 1e-9)
    scale = jnp.clip(jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / LOG_SCALE), 0,
                     LEVELS - 1).astype(jnp.int32)
    xr = jnp.where(depth > 1e-6, uv[:, 0] - jp.focal_x_baseline / jnp.maximum(depth, 1e-6), -1.0)
    return [np.asarray(a) for a in (uv, depth, observable, xr, scale)], \
        np.asarray(dist / dmin), np.asarray(dist / dmax), np.asarray(cosang), \
        np.asarray(jnp.log(ratio) / LOG_SCALE)


def test_reproject_points_match_jax():
    R, t, tbl, _ = _scene(1, 3000)
    jp, tp = jcam.make_params(**PARAMS), tcam.make_params(**PARAMS)
    pos = tbl[:, 0:3].copy()
    uv, depth, vis = (np.asarray(a) for a in jcam.reproject_to_image(
        jcam.CameraModel.PERSPECTIVE, jp, jnp.asarray(R), jnp.asarray(t), jnp.asarray(pos)))
    xr = np.where(depth > 1e-6, uv[:, 0] - np.float32(jp.focal_x_baseline)
                  / np.maximum(depth, 1e-6), -1.0)
    k = tcam.reproject_gate(tp, torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(pos))
    assert _rel(k[0].numpy(), uv) < 1e-5 and _rel(k[3].numpy(), xr) < 1e-5
    assert _rel(k[1].numpy(), depth) < 1e-5
    assert np.array_equal(k[2].numpy(), vis) and k[4] is None
    assert 0 < int(vis.sum()) < len(vis)


def test_reproject_gate_matches_jax():
    R, t, tbl, u32 = _scene(2, 4096)
    jp, tp = jcam.make_params(**PARAMS), tcam.make_params(**PARAMS)
    (uv, depth, obs, xr, scale), r_min, r_max, cosang, lv = _jax_gate(jp, R, t, tbl, u32)
    k = tcam.reproject_gate(tp, torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(tbl),
                            torch.from_numpy(u32), log_scale=LOG_SCALE, num_levels=LEVELS)
    assert _rel(k[0].numpy(), uv) < 1e-5 and _rel(k[3].numpy(), xr) < 1e-5
    near = ((np.abs(r_min - 0.8) <= 1e-6) | (np.abs(r_max - 1.3) <= 1e-6)
            | (np.abs(cosang - 0.5) <= 1e-6) | (np.abs(lv - np.round(lv)) <= 1e-6))
    differ = (k[2].numpy() != obs) | (k[4].numpy() != scale)
    assert not np.any(differ & ~near), int(np.sum(differ & ~near))
    assert int(np.sum(near)) == 0
    assert 0 < int(obs.sum()) < len(obs)


def test_undistort_norm_matches_jax():
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(0, 752, 2872), rng.uniform(0, 480, 2872)], -1).astype(np.float32)
    j = np.asarray(jcam.perspective_undistort(jcam.make_params(**PARAMS), jnp.asarray(pts)))
    t = tcam.undistort_norm(tcam.make_params(**PARAMS), torch.from_numpy(pts)).numpy()
    assert _rel(t, j) < 1e-5
