"""Kernel R's plain versions against the JAX package, on the CPU.

`project_window_rows` (the window rows kernel C reads, kernel R's
projection entry point) in its point mode against
stella_vslam_tpu/camera/base.py reproject_to_image (:232) with the
cascade's x_right (module/tracking_kernels.py:214-218); in its table mode
against the stage-3 expressions of track_frame (:266-285): the in-image
test, distance in [0.8 min, 1.3 max], cos(ray, normal) > 0.5, depth > 0,
the table's valid flag, and the predicted level; in both modes the window
radius and level bounds of match/projection.py (:53 and :64-65 for the
table, :127 and :132 for the last frame's points), perspective and
equirectangular; `undistort_norm` against perspective_undistort (:97,
_perspective_undistort_norm's 10 iterations); the rows' FMA (`_fma_f32`,
the kernel's `__fmaf_rn`) against exact rational arithmetic. Inputs from
a numpy seed, EuRoC's radial-tangential distortion. Bounds: uv, x_right, radius and
undistorted keypoints within 1e-5 relative (pixels, at least 1 px of
scale); flags and levels equal except where the deciding quantity lies
within 1e-6 of its threshold (counted; none on these inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu.match import hamming as jH
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


def _jax_gate(jp, R, t, tbl, u32, model=jcam.CameraModel.PERSPECTIVE):
    """track_frame's stage 3 (stella_vslam_tpu/module/tracking_kernels.py:266-285)."""
    R, t, tbl = jnp.asarray(R), jnp.asarray(t), jnp.asarray(tbl)
    pos, normal, dmin, dmax = tbl[:, 0:3], tbl[:, 3:6], tbl[:, 6], tbl[:, 7]
    uv, depth, in_img = jcam.reproject_to_image(model, jp, R, t, pos)
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


SF = np.asarray([1.2 ** l for l in range(LEVELS)], np.float32)


def _rows(p, R, t, pos, model=tcam.CameraModel.PERSPECTIVE, **kw):
    return tcam.project_window_rows(p, torch.from_numpy(R), torch.from_numpy(t),
                                    torch.from_numpy(pos), scale_factors=torch.from_numpy(SF),
                                    model=model, **kw)


def test_reproject_points_match_jax():
    R, t, tbl, _ = _scene(1, 3000)
    jp, tp = jcam.make_params(**PARAMS), tcam.make_params(**PARAMS)
    pos = tbl[:, 0:3].copy()
    uv, depth, vis = (np.asarray(a) for a in jcam.reproject_to_image(
        jcam.CameraModel.PERSPECTIVE, jp, jnp.asarray(R), jnp.asarray(t), jnp.asarray(pos)))
    xr = np.where(depth > 1e-6, uv[:, 0] - np.float32(jp.focal_x_baseline)
                  / np.maximum(depth, 1e-6), -1.0)
    M = len(pos)
    k = _rows(tp, R, t, pos, margin=20.0, last_level=torch.zeros(M, dtype=torch.int32),
              last_valid=torch.ones(M, dtype=torch.bool))
    assert _rel(np.stack([k.u.numpy(), k.v.numpy()], -1), uv) < 1e-5
    assert _rel(k.xr.numpy(), xr) < 1e-5
    _, tdepth, _ = tcam.reproject_to_image(tcam.CameraModel.PERSPECTIVE, tp,
                                           torch.from_numpy(R), torch.from_numpy(t),
                                           torch.from_numpy(pos))
    assert _rel(tdepth.numpy(), depth) < 1e-5
    assert np.array_equal(k.valid.numpy(), vis) and k.pred_scale is None
    assert 0 < int(vis.sum()) < len(vis)


def test_reproject_gate_matches_jax():
    R, t, tbl, u32 = _scene(2, 4096)
    jp, tp = jcam.make_params(**PARAMS), tcam.make_params(**PARAMS)
    (uv, depth, obs, xr, scale), r_min, r_max, cosang, lv = _jax_gate(jp, R, t, tbl, u32)
    k = _rows(tp, R, t, tbl, margin=5.0, tbl_u32=torch.from_numpy(u32), log_scale=LOG_SCALE,
              num_levels=LEVELS)
    assert _rel(np.stack([k.u.numpy(), k.v.numpy()], -1), uv) < 1e-5
    assert _rel(k.xr.numpy(), xr) < 1e-5
    near = ((np.abs(r_min - 0.8) <= 1e-6) | (np.abs(r_max - 1.3) <= 1e-6)
            | (np.abs(cosang - 0.5) <= 1e-6) | (np.abs(lv - np.round(lv)) <= 1e-6))
    differ = (k.valid.numpy() != obs) | (k.pred_scale.numpy() != scale)
    assert not np.any(differ & ~near), int(np.sum(differ & ~near))
    assert int(np.sum(near)) == 0
    assert 0 < int(obs.sum()) < len(obs)


def _equirect_scene(seed, C):
    """Points and a table all around a camera (0.5-5.5 m), and a pose."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(C, 3))
    pos = (pos / np.linalg.norm(pos, axis=1, keepdims=True) * rng.uniform(0.5, 5.5, (C, 1)))
    normal = rng.normal(size=(C, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d = np.linalg.norm(pos, axis=1)
    tbl = np.zeros((C, 8), np.float32)
    tbl[:, 0:3], tbl[:, 3:6] = pos, normal
    tbl[:, 6] = d * rng.uniform(0.9, 1.5, C)
    tbl[:, 7] = d * rng.uniform(0.8, 2.8, C)
    u32 = np.zeros((C, 10), np.int32)
    u32[:, 9] = rng.random(C) < 0.9
    R, t = jlie.se3_exp(jnp.asarray([0.1, -0.2, 0.05, 0.3, -0.2, 0.4], jnp.float32))
    return np.array(R), np.array(t), tbl, u32


@pytest.mark.parametrize("model", ["perspective", "equirectangular"])
@pytest.mark.parametrize("stage", ["last_frame", "table"])
def test_window_rows_match_jax(model, stage):
    """The rows kernel C reads, from the plain version of kernel R's entry
    point, against JAX's projection, gate, radius and level bounds: floats
    within 1e-5 relative of at least 100 px (u of the equirectangular model
    up to the seam, where atan2 of +-0 lands on either edge), integer rows
    and flags equal away from a threshold."""
    eq = model == "equirectangular"
    jmodel = jcam.CameraModel.EQUIRECTANGULAR if eq else jcam.CameraModel.PERSPECTIVE
    tmodel = tcam.CameraModel.EQUIRECTANGULAR if eq else tcam.CameraModel.PERSPECTIVE
    prm = dict(cx=320.0, cy=160.0, width=640, height=320) if eq else PARAMS
    jp, tp = jcam.make_params(**prm), tcam.make_params(**prm)
    R, t, tbl, u32 = (_equirect_scene if eq else _scene)(3, 4096 if stage == "table" else 2872)
    M = len(tbl)
    rng = np.random.default_rng(4)
    jsf = jnp.asarray(SF)
    if stage == "last_frame":
        pos = tbl[:, 0:3].copy()
        level = rng.integers(0, LEVELS, M).astype(np.int32)
        assoc = rng.random(M) < 0.8
        uv, depth, vis = (np.asarray(a) for a in jcam.reproject_to_image(
            jmodel, jp, jnp.asarray(R), jnp.asarray(t), jnp.asarray(pos)))
        xr = np.where(depth > 1e-6, uv[:, 0] - np.float32(jp.focal_x_baseline)
                      / np.maximum(depth, 1e-6), -1.0)
        valid = assoc & vis  # tracking_kernels.py: the last frame's rows
        # projection.py:127, :132 (match_current_and_last_frames)
        rad = np.asarray(20.0 * jH.take_small_table(jsf, jnp.asarray(level)))
        lo, hi, pred = level - 1, level + 1, None
        near = np.zeros(M, bool)
        k = _rows(tp, R, t, pos, tmodel, margin=20.0, last_level=torch.from_numpy(level),
                  last_valid=torch.from_numpy(assoc))
    else:
        (uv, depth, valid, xr, pred), r_min, r_max, cosang, lv = _jax_gate(
            jp, R, t, tbl, u32, jmodel)
        # projection.py:53, :64-65 (match_frame_and_landmarks)
        rad = np.asarray(5.0 * jH.take_small_table(jsf, jnp.asarray(pred)))
        lo, hi = np.maximum(pred - 1, 0), np.minimum(pred + 1, LEVELS - 1)
        near = ((np.abs(r_min - 0.8) <= 1e-6) | (np.abs(r_max - 1.3) <= 1e-6)
                | (np.abs(cosang - 0.5) <= 1e-6) | (np.abs(lv - np.round(lv)) <= 1e-6))
        k = _rows(tp, R, t, tbl, tmodel, margin=5.0, tbl_u32=torch.from_numpy(u32),
                  log_scale=LOG_SCALE, num_levels=LEVELS)
    du = np.abs(k.u.numpy() - uv[:, 0])
    if eq:
        du = np.minimum(du, np.abs(du - 640.0))
    rel = lambda a, b: float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 100.0)))
    assert float(np.max(du / np.maximum(np.abs(uv[:, 0]), 100.0))) < 1e-5
    assert rel(k.v.numpy(), uv[:, 1]) < 1e-5 and rel(k.xr.numpy(), xr) < 1e-5
    _assert_rows_equal(k, valid, pred, rad, lo, hi, near)
    assert 0 < int(valid.sum()) < M


def _assert_rows_equal(k, valid, pred, rad, lo, hi, near):
    """The integer rows and flags equal JAX's away from a threshold (rows
    within 1e-6 of one counted: none here); where the level agrees, the
    radius too (one f32 product of the same numbers)."""
    differ = k.valid.numpy() != valid
    if pred is not None:
        differ |= k.pred_scale.numpy() != pred
    assert not np.any(differ & ~near), int(np.sum(differ & ~near))
    assert int(np.sum(near)) == 0
    same = ~differ
    assert np.array_equal(k.lo.numpy()[same], lo[same])
    assert np.array_equal(k.hi.numpy()[same], hi[same])
    assert np.array_equal(k.rad.numpy()[same], rad[same])


def test_undistort_norm_matches_jax():
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(0, 752, 2872), rng.uniform(0, 480, 2872)], -1).astype(np.float32)
    # jitted, as the JAX System's preprocessing runs it (the port follows its
    # reciprocal products and FMAs)
    jp = jcam.make_params(**PARAMS)
    j = np.asarray(jax.jit(lambda a: jcam.perspective_undistort(jp, a))(jnp.asarray(pts)))
    t = tcam.undistort_norm(tcam.make_params(**PARAMS), torch.from_numpy(pts)).numpy()
    assert _rel(t, j) < 1e-5


def _round_f32(x):
    """The float32 nearest an exact Fraction x (ties to even)."""
    from fractions import Fraction

    f = np.float32(float(x))
    near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                    int(np.array(c).view(np.int32)) & 1))


@pytest.mark.parametrize("case", ["random", "double_rounding"])
def test_fma_f32_rounds_once(case):
    """The plain rows' FMA (the kernel's `__fmaf_rn`): a b + c rounded once
    to float32, checked against exact rational arithmetic. "double_rounding"
    puts the float64 sum on a float32 midpoint (c's last bit odd, a b half
    an ulp of c less 2^-46 of it), where rounding the float64 sum to
    float32 would round a second time and miss by an ulp."""
    from fractions import Fraction

    rng = np.random.default_rng(21)
    m = 400
    if case == "random":
        a, b = (rng.standard_normal(m).astype(np.float32) for _ in range(2))
        c = (rng.standard_normal(m) * 10.0 ** rng.integers(-6, 3, m)).astype(np.float32)
    else:
        e = rng.integers(-20, 20, m)
        sign = rng.choice([1.0, -1.0], m)
        c = (sign * (1 + (2 * rng.integers(0, 2 ** 22, m) + 1) * 2.0 ** -23) * 2.0 ** e) \
            .astype(np.float32)
        a = (sign * 2.0 ** -12 * (1 + 2.0 ** -23) * 2.0 ** e).astype(np.float32)
        b = np.full(m, 2.0 ** -12 * (1 - 2.0 ** -23), np.float32)
    got = tcam._fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
