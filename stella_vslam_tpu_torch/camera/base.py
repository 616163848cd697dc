"""Camera models as batched torch functions (perspective, fisheye,
equirectangular and radial division).

Port of stella_vslam_tpu/camera/base.py, every model and the MONOCULAR /
STEREO / RGBD setups. Undistortion is the JAX version's fixed-iteration
inversion, written as elementwise ops in the same order: radial-tangential
(perspective, 10 fixed-point steps), Kannala-Brandt (fisheye, 10 Newton
steps on theta) and the division model's closed form; for the
equirectangular model it is the identity. Fisheye and radial division then
take the pinhole branch everywhere, as in the JAX version: bearings,
reprojection and the residuals of the optimizers work on the undistorted
keypoints. The equirectangular bearings are longitude / latitude on the
unit sphere, and a reprojection sees every direction, its depth being the
norm (camera/base.py :190-246).

Kernel R (csrc/reproject.cu) computes the per-point functions of the hot
path on CUDA tensors: `undistort_norm`, `undistort_fisheye` and
`undistort_radial` (every keypoint of every frame, in the camera model's
mode) and `project_window_rows` (the tracking cascade's projections of the
last frame's chained landmarks and, with the local-map gate and predicted
scale, of the landmark table, written as the window rows kernel C reads),
the latter in the model's projection family. On CPU tensors each runs its plain version,
the torch expressions below.
"""
from __future__ import annotations

import enum
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.kernels import build as kbuild


class CameraModel(enum.IntEnum):
    PERSPECTIVE = 0
    FISHEYE = 1
    EQUIRECTANGULAR = 2
    RADIAL_DIVISION = 3


class Setup(enum.IntEnum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class CameraParams(NamedTuple):
    """Union of model parameters as f32-rounded Python floats (zero where
    unused). Python floats multiply an f32 tensor in f32, as the JAX
    version's f32 scalars do."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    k4: float
    width: float
    height: float
    focal_x_baseline: float
    depth_thr: float


def make_params(fx=0.0, fy=0.0, cx=0.0, cy=0.0, k1=0.0, k2=0.0, p1=0.0,
                p2=0.0, k3=0.0, k4=0.0, width=0, height=0,
                focal_x_baseline=0.0, depth_thr=40.0) -> CameraParams:
    f = lambda v: float(np.float32(v))
    return CameraParams(
        fx=f(fx), fy=f(fy), cx=f(cx), cy=f(cy), k1=f(k1), k2=f(k2), p1=f(p1),
        p2=f(p2), k3=f(k3), k4=f(k4), width=f(width), height=f(height),
        focal_x_baseline=f(focal_x_baseline), depth_thr=f(depth_thr))


def _radtan_distort(p: CameraParams, x, y):
    r2 = x * x + y * y
    radial = 1.0 + r2 * (p.k1 + r2 * (p.k2 + r2 * p.k3))
    xd = x * radial + 2.0 * p.p1 * x * y + p.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p.p1 * (r2 + 2.0 * y * y) + 2.0 * p.p2 * x * y
    return xd, yd


def _c32(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 constant v as a 0-d tensor on like's device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _normalise(p: CameraParams, pts: torch.Tensor):
    """(u - cx) / fx and (v - cy) / fy as the JAX version's jitted
    preprocessing rounds them: a division by a constant is a product with
    its float32 reciprocal."""
    return (times_f32(pts[..., 0] - p.cx, f32_reciprocal(p.fx)),
            times_f32(pts[..., 1] - p.cy, f32_reciprocal(p.fy)))


def _to_pixels(p: CameraParams, x, y) -> torch.Tensor:
    """x fx + cx and y fy + cy, each one FMA as XLA contracts them."""
    return torch.stack([_fma_f32(x, _c32(p.fx, x), _c32(p.cx, x)),
                        _fma_f32(y, _c32(p.fy, y), _c32(p.cy, y))], dim=-1)


def _pinhole_bearings(p: CameraParams, x, y) -> torch.Tensor:
    """Unit bearings of normalised undistorted coordinates as the JAX
    version's jitted preprocessing rounds `bearings(undistort(pts))`: XLA
    folds ((x fx + cx) - cx) / fx into x times the float32 fx (1 / fx) (1
    for most focal lengths, 1 - 2^-24 for EuRoC's fx), sums x^2 + y^2 with
    an FMA before adding 1, and divides by the correctly rounded root."""
    xb = times_f32(x, float(np.float32(p.fx) * np.float32(f32_reciprocal(p.fx))))
    yb = times_f32(y, float(np.float32(p.fy) * np.float32(f32_reciprocal(p.fy))))
    n = torch.sqrt((_fma_f32(yb, yb, xb * xb) + 1.0).double()).float()
    return torch.stack([xb / n, yb / n, 1.0 / n], dim=-1)


def _perspective_undistort_norm(p: CameraParams, xd, yd, iters: int = 10):
    """Invert radtan by fixed-point iteration on normalized coords, each
    step x <- xd - (distort(x) - x) rounded as XLA's CPU code for the JAX
    version's jitted loop rounds it (its contractions, read from the bits):
    r^2 = x x + y y with both products rounded, the radial polynomial an
    FMA chain, and each tangential sum an FMA onto the product before it."""
    c = lambda v: _c32(v, xd)
    k1, k2, k3, p1, p2 = c(p.k1), c(p.k2), c(p.k3), c(p.p1), c(p.p2)
    two_p1, two_p2, one = c(2.0 * p.p1), c(2.0 * p.p2), c(1.0)
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = _fma_f32(r2, _fma_f32(r2, _fma_f32(r2, k3, k2), k1), one)
        dx = _fma_f32(_fma_f32(x * 2.0, x, r2), p2, _fma_f32(x * two_p1, y, x * radial))
        dy = _fma_f32(x * two_p2, y, _fma_f32(_fma_f32(y * 2.0, y, r2), p1, y * radial))
        x = xd - (dx - x)
        y = yd - (dy - y)
    return x, y


def perspective_undistort(p: CameraParams, pts: torch.Tensor, bearings: bool = False):
    """Pixel keypoints [N,2] -> undistorted pixel keypoints (same K), and
    with `bearings` their unit bearing vectors [N,3] too, as the JAX
    version's jitted preprocessing gives both."""
    x, y = _perspective_undistort_norm(p, *_normalise(p, pts))
    und = _to_pixels(p, x, y)
    return (und, _pinhole_bearings(p, x, y)) if bearings else und


def _kb_distort_theta(p: CameraParams, theta):
    t2 = theta * theta
    return theta * (1.0 + t2 * (p.k1 + t2 * (p.k2 + t2 * (p.k3 + t2 * p.k4))))


def _kb_undistort_theta(p: CameraParams, theta_d, iters: int = 10):
    """Invert the Kannala-Brandt polynomial by Newton on theta."""
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (p.k1 + t2 * (p.k2 + t2 * (p.k3 + t2 * p.k4)))) - theta_d
        df = 1.0 + t2 * (3.0 * p.k1 + t2 * (5.0 * p.k2 + t2 * (7.0 * p.k3 + t2 * 9.0 * p.k4)))
        theta = theta - f / torch.where(torch.abs(df) < 1e-6, 1.0, df)
    return theta


def fisheye_undistort(p: CameraParams, pts: torch.Tensor, bearings: bool = False):
    """The Kannala-Brandt undistortion in the JAX version's eager rounding
    (a true division by fx, no FMA): XLA's CPU tan differs from torch's by
    ulps, so no contraction brings it to the jitted bits, and the jitted
    normalisation leaves it more than 4 ulps from either form (ROADMAP
    Queue 3's kept differences)."""
    xn = (pts[..., 0] - p.cx) / p.fx
    yn = (pts[..., 1] - p.cy) / p.fy
    theta_d = torch.sqrt(xn * xn + yn * yn)
    theta = _kb_undistort_theta(p, theta_d)
    scale = torch.where(theta_d > 1e-8, torch.tan(theta) / torch.clamp(theta_d, min=1e-8), 1.0)
    x, y = xn * scale, yn * scale
    und = torch.stack([x * p.fx + p.cx, y * p.fy + p.cy], dim=-1)
    return (und, _pinhole_bearings(p, x, y)) if bearings else und


def fisheye_distort(p: CameraParams, pts: torch.Tensor) -> torch.Tensor:
    xn = (pts[..., 0] - p.cx) / p.fx
    yn = (pts[..., 1] - p.cy) / p.fy
    r = torch.sqrt(xn * xn + yn * yn)
    theta_d = _kb_distort_theta(p, torch.atan(r))
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), 1.0)
    return torch.stack([xn * scale * p.fx + p.cx, yn * scale * p.fy + p.cy], dim=-1)


def radial_division_undistort(p: CameraParams, pts: torch.Tensor, bearings: bool = False):
    xn, yn = _normalise(p, pts)
    # the contractions XLA makes in the JAX version's jitted code
    r2 = _fma_f32(xn, xn, yn * yn)
    denom = _fma_f32(r2, _c32(p.k1, r2), _c32(1.0, r2))
    scale = 1.0 / torch.where(torch.abs(denom) < 1e-8, 1e-8, denom)
    x, y = xn * scale, yn * scale
    und = _to_pixels(p, x, y)
    return (und, _pinhole_bearings(p, x, y)) if bearings else und


def radial_division_distort(p: CameraParams, pts: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert the division model by Newton on the radius."""
    xn = (pts[..., 0] - p.cx) / p.fx
    yn = (pts[..., 1] - p.cy) / p.fy
    ru = torch.sqrt(xn * xn + yn * yn)
    rd = ru
    for _ in range(iters):
        # solve rd / (1 + k1 rd^2) = ru
        denom = 1.0 + p.k1 * rd * rd
        f = rd / denom - ru
        df = (1.0 - p.k1 * rd * rd) / (denom * denom)
        rd = rd - f / torch.where(torch.abs(df) < 1e-8, 1e-8, df)
    scale = torch.where(ru > 1e-8, rd / torch.clamp(ru, min=1e-8), 1.0)
    return torch.stack([xn * scale * p.fx + p.cx, yn * scale * p.fy + p.cy], dim=-1)


def _as_model(model) -> CameraModel:
    """A CameraModel, or its lower-case name as the optimizers take it."""
    return CameraModel[model.upper()] if isinstance(model, str) else CameraModel(model)


def projection_family(model) -> int:
    """The kernels' projection of a camera model, csrc/camera.cuh's
    kPerspective (0) or kEquirect (2): fisheye and radial division project
    as the pinhole on undistorted keypoints."""
    m = _as_model(model)
    return int(m) if m == CameraModel.EQUIRECTANGULAR else int(CameraModel.PERSPECTIVE)


def undistortion_mode(model) -> int:
    """Kernel R's undistortion mode of a camera model: 0 radial-tangential,
    1 Kannala-Brandt, 3 division; 2 (equirectangular) is the identity and
    launches nothing."""
    return int(_as_model(model))


def _undistort_launch(mode: int, p: CameraParams, pts: torch.Tensor, name: str,
                      bearings: bool):
    N = pts.shape[0]
    if tuple(pts.shape) != (N, 2) or pts.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 [N,2] pixel keypoints")
    pts = pts.contiguous()
    out = torch.empty_like(pts)
    bear = torch.empty((N, 3), dtype=torch.float32, device=pts.device) if bearings else None
    lib = kbuild.load()
    kbuild.check(lib.svt_undistort(mode, N, p.fx, p.fy, p.cx, p.cy, p.k1, p.k2, p.p1, p.p2,
                                   p.k3, p.k4, pts.data_ptr(), out.data_ptr(),
                                   bear.data_ptr() if bearings else 0,
                                   kbuild.stream_ptr(pts.device)), name)
    return (out, bear) if bearings else out


def undistort_norm(p: CameraParams, pts: torch.Tensor, bearings: bool = False):
    """Kernel R's radial-tangential undistortion on CUDA tensors (normalize,
    the 10 iterations of _perspective_undistort_norm, back to pixels; with
    `bearings` the unit bearings too, from the same launch), the plain
    version `perspective_undistort` on CPU tensors."""
    if not pts.is_cuda:
        return perspective_undistort(p, pts, bearings)
    out = _undistort_launch(0, p, pts, "undistort_norm", bearings)
    undistort_norm.launches += 1
    return out


undistort_norm.launches = 0


def undistort_fisheye(p: CameraParams, pts: torch.Tensor, bearings: bool = False):
    """Kernel R's Kannala-Brandt mode on CUDA tensors (10 Newton steps on
    theta, the tan scale; the bearings with `bearings`), the plain version
    `fisheye_undistort` on CPU tensors."""
    if not pts.is_cuda:
        return fisheye_undistort(p, pts, bearings)
    out = _undistort_launch(1, p, pts, "undistort_fisheye", bearings)
    undistort_fisheye.launches += 1
    return out


undistort_fisheye.launches = 0


def undistort_radial(p: CameraParams, pts: torch.Tensor, bearings: bool = False):
    """Kernel R's division-model mode on CUDA tensors (one division by
    1 + k1 r^2; the bearings with `bearings`), the plain version
    `radial_division_undistort` on CPU tensors."""
    if not pts.is_cuda:
        return radial_division_undistort(p, pts, bearings)
    out = _undistort_launch(3, p, pts, "undistort_radial", bearings)
    undistort_radial.launches += 1
    return out


undistort_radial.launches = 0

_UNDISTORT = {0: undistort_norm, 1: undistort_fisheye, 3: undistort_radial}


def undistort_keypoints(model: CameraModel, p: CameraParams,
                        pts: torch.Tensor) -> torch.Tensor:
    mode = undistortion_mode(model)
    if mode == CameraModel.EQUIRECTANGULAR:
        return pts
    return _UNDISTORT[mode](p, pts)


def undistort_and_bearings(model: CameraModel, p: CameraParams, pts: torch.Tensor):
    """(undistorted keypoints [N,2], unit bearings [N,3]) as the JAX
    version's jitted preprocessing computes `bearings(undistort(pts))` in
    one program: the pinhole models' bearings come from the normalised
    coordinates (kernel R writes both on the card)."""
    mode = undistortion_mode(model)
    if mode == CameraModel.EQUIRECTANGULAR:
        return pts, bearings_from_undistorted(model, p, pts)
    return _UNDISTORT[mode](p, pts, bearings=True)


_PLAIN_UNDISTORT = {0: perspective_undistort, 1: fisheye_undistort, 3: radial_division_undistort}


def undistort_and_bearings_plain(model: CameraModel, p: CameraParams, pts: torch.Tensor):
    """undistort_and_bearings as torch expressions on any device: kernel R's
    plain twin (the frame's finish, data/frame.py frame_finish_plain)."""
    mode = undistortion_mode(model)
    if mode == CameraModel.EQUIRECTANGULAR:
        return pts, bearings_from_undistorted(model, p, pts)
    return _PLAIN_UNDISTORT[mode](p, pts, bearings=True)


def bearings_from_undistorted(model: CameraModel, p: CameraParams,
                              pts: torch.Tensor) -> torch.Tensor:
    """Undistorted keypoints [N,2] -> unit bearing vectors [N,3]; the
    pinhole models as the JAX version's jitted code rounds them (a product
    with the float32 reciprocals, the squared norm's FMA)."""
    if model == CameraModel.EQUIRECTANGULAR:
        lon = (pts[..., 0] - p.cx) * (2.0 * math.pi) / p.width
        lat = -(pts[..., 1] - p.cy) * math.pi / p.height
        return torch.stack([torch.cos(lat) * torch.sin(lon), -torch.sin(lat),
                            torch.cos(lat) * torch.cos(lon)], dim=-1)
    xn, yn = _normalise(p, pts)
    n = torch.sqrt((_fma_f32(yn, yn, xn * xn) + 1.0).double()).float()
    return torch.stack([xn / n, yn / n, 1.0 / n], dim=-1)


def undistorted_from_bearings(model: CameraModel, p: CameraParams,
                              bearings: torch.Tensor) -> torch.Tensor:
    """Unit bearing vectors [N,3] -> undistorted keypoints [N,2]."""
    x, y, z = bearings[..., 0], bearings[..., 1], bearings[..., 2]
    if model == CameraModel.EQUIRECTANGULAR:
        lat = -torch.asin(torch.clamp(y, -1.0, 1.0))
        lon = torch.atan2(x, z)
        return torch.stack([p.cx + lon * p.width / (2.0 * math.pi),
                            p.cy - lat * p.height / math.pi], dim=-1)
    zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    return torch.stack([p.fx * x / zs + p.cx, p.fy * y / zs + p.cy], dim=-1)


def reproject_to_image(model: CameraModel, p: CameraParams, R_cw: torch.Tensor,
                       t_cw: torch.Tensor, pos_w: torch.Tensor):
    """World points [...,N,3] under a camera-from-world pose ([...,3,3],
    [...,3]) -> (uv [...,N,2], depth [...,N], visible [...,N] bool). The
    equirectangular model sees every direction; its depth is the norm."""
    return project_camera_points(model, p, pos_w @ R_cw.transpose(-1, -2) + t_cw[..., None, :])


def project_camera_points(model: CameraModel, p: CameraParams, pc: torch.Tensor):
    """Camera-frame points [...,N,3] -> (uv [...,N,2], depth [...,N],
    visible [...,N] bool), reproject_to_image's projection."""
    if model == CameraModel.EQUIRECTANGULAR:
        norm = torch.linalg.norm(pc, dim=-1)
        b = pc / torch.clamp(norm, min=1e-12)[..., None]
        return undistorted_from_bearings(model, p, b), norm, norm > 1e-6
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = p.fx * pc[..., 0] / zs + p.cx
    v = p.fy * pc[..., 1] / zs + p.cy
    visible = (z > 0.0) & (u >= 0.0) & (u < p.width) & (v >= 0.0) & (v < p.height)
    return torch.stack([u, v], dim=-1), z, visible


class WindowRows(NamedTuple):
    """Kernel R's window rows: per query row what kernel C's window call
    reads (match/hamming.WindowGate's row fields) and the row's valid
    flag, as the matchers of match/projection.py take them."""

    u: torch.Tensor  # [M] f32 projected pixel
    v: torch.Tensor  # [M] f32
    xr: torch.Tensor  # [M] f32 x_right, -1 where the depth is not above 1e-6
    rad: torch.Tensor  # [M] f32 margin * scale_factors[level]
    lo: torch.Tensor  # [M] i32 lowest keypoint level
    hi: torch.Tensor  # [M] i32 highest keypoint level
    valid: torch.Tensor  # [M] bool
    pred_scale: Optional[torch.Tensor]  # [M] i32 predicted level (the table), else None


def log_scale_of(scale_factor: float) -> float:
    """The float32 log of an ORB scale factor as the JAX package takes it
    (`jnp.log(jnp.float32(sf))`, correctly rounded): the double log of the
    float32 factor, rounded to float32. numpy's float32 log is an ulp off
    it for 1.2, sqrt(2) and 1.1."""
    return float(np.float32(math.log(float(np.float32(scale_factor)))))


def f32_reciprocal(x: float) -> float:
    """1 / x in float32 from float32 x: what a jitted division by the
    constant x multiplies by (XLA folds `v / c` into `v * (1 / c)`)."""
    return float(np.float32(1.0) / np.float32(x))


# the fusion gate's dmin / 1.3, as the JAX version's jitted code takes it
DMIN_SCALE = f32_reciprocal(1.3)


def times_f32(x: torch.Tensor, c: float) -> torch.Tensor:
    """x times the float32 constant c, one float32 product on the CPU and on
    the card alike (c as a float32 scalar tensor)."""
    return x * torch.tensor(c, dtype=torch.float32)


def predicted_octave(ratio: torch.Tensor, inv_log_scale: float, num_levels: int) -> torch.Tensor:
    """clip(ceil(log(max(ratio, 1e-9)) * inv_log_scale), 0, num_levels - 1)
    as int32: the JAX version's jitted `ceil(log(r) / log_scale)`, whose
    division by the constant is a product with its float32 reciprocal
    (inv_log_scale = f32_reciprocal(log_scale))."""
    lv = torch.ceil(times_f32(torch.log(torch.clamp(ratio, min=1e-9)), inv_log_scale))
    return torch.clamp(lv, 0, num_levels - 1).to(torch.int32)


def _fma_f32(a, b, c):
    """a b + c for float32 tensors with one rounding, as `__fmaf_rn` gives
    it (the float64 product a b is exact; round_sum_f32 adds c)."""
    return round_sum_f32(a.double() * b.double(), c)


def round_sum_f32(p, c):
    """p + c rounded once to float32, for a float64 tensor p that holds an
    exact product of float32s and a float32 tensor c: the float64 sum is
    rounded to odd (a float64 TwoSum gives the sum's error; an inexact sum
    with an even last bit moves one ulp towards it), which a rounding to
    float32 then rounds correctly (53 >= 2 x 24 + 2 bits). On the CPU, where
    no float64 sum lies on a float32 tie (its 29 low bits 1 followed by
    zeros) or below float32's normal range, the sum rounds to float32 as it
    is: the exact sum lies within half a float64 ulp of it, on the same side
    of every float32 tie."""
    c = c.double()
    s = p + c
    if not s.is_cuda:
        a = s.abs()
        if not bool(((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000).any()
                    | ((a < 2.0 ** -126) & (a > 0.0)).any()):
            return s.float()
    e = s - p
    err = (p - (s - e)) + (c - e)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    away = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    return torch.where(fix, torch.nextafter(s, away), s).float()


def camera_points(R_cw, t_cw, pts):
    """R p + t [M,3] as a float32 matmul rounds it on the CPU (and the JAX
    version's einsum): per row an FMA chain over k = 0, 1, 2, then + t, each
    FMA rounded once (_fma_f32), so the card gives the same bits as kernel
    R's `__fmaf_rn` chain (a cuBLAS matmul sums in another order, an ulp of
    x apart: fx / z times that in u, hundredths of a pixel for a landmark
    0.1 m away)."""
    rows = []
    for i in range(3):
        acc = pts[:, 0] * R_cw[i, 0]
        for k in (1, 2):
            acc = _fma_f32(pts[:, k], R_cw[i, k], acc)
        rows.append(acc + t_cw[i])
    return torch.stack(rows, dim=-1)


def dot3_f32(a, b):
    """The dot product over the last axis of [...,3] float32 tensors as the
    JAX version's jitted `sum(a * b, -1)` and a float32 matmul on the CPU
    round it: fma(a2, b2, fma(a1, b1, a0 b0)) (kernels L and R use the same
    `__fmaf_rn` chain)."""
    return _fma_f32(a[..., 2], b[..., 2], _fma_f32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def norm3_f32(v):
    """|v| over the last axis of [...,3] float32, as the JAX version's
    jitted `linalg.norm` rounds it: sqrt(dot3_f32(v, v)), the root
    correctly rounded (taken in float64: torch's float32 sqrt on the CPU
    is not, on some inputs)."""
    return torch.sqrt(dot3_f32(v, v).double()).float()


def centre_f32(R_cw, t_cw):
    """The camera centre -R^T t [3] of a [3,3] / [3] pose, each entry the
    FMA chain of dot3_f32 (the JAX version's jitted `-R.T @ t`)."""
    return -dot3_f32(R_cw.T, t_cw[None, :])


def project_window_rows_plain(p: CameraParams, R_cw, t_cw, pos, *, scale_factors,
                              margin: float, last_level=None, last_valid=None, tbl_u32=None,
                              log_scale: float = 0.0, num_levels: int = 1,
                              model: CameraModel = CameraModel.PERSPECTIVE) -> WindowRows:
    """Plain version of kernel R's window rows under `model`, the torch
    expressions of the tracking cascade and its matchers. Two modes:
    * the last frame's chained landmarks: pos [M,3] world points with
      last_level [M] (the last frame's keypoint levels) and last_valid [M]
      bool; radius margin * scale_factors[level], levels level -+ 1
      (unclamped), valid = last_valid and the in-image test
      (match_current_and_last_frames);
    * the landmark table: pos = tbl_f32 [C,8] (position, normal, min and
      max distance) with tbl_u32 [C,10] (the valid flag in column 9); valid
      is the local-map gate (valid, in image, distance in [0.8 min, 1.3
      max], cos(ray, normal) > 0.5, depth > 0), pred_scale the predicted
      level, radius margin * scale_factors[pred], levels pred -+ 1 clamped
      to [0, num_levels - 1] (match_frame_and_landmarks)."""
    pts = pos[:, 0:3] if tbl_u32 is not None else pos
    uv, depth, vis = project_camera_points(model, p, camera_points(R_cw, t_cw, pts))
    # fxb / depth a true division, as the JAX version's (its divisor varies)
    # and the kernel's: torch's `float / tensor` would take the reciprocal
    xr = torch.where(depth > 1e-6, uv[:, 0] - torch.full_like(depth, p.focal_x_baseline)
                     / torch.clamp(depth, min=1e-6),
                     torch.full_like(depth, -1.0))
    u, v = uv[:, 0].contiguous(), uv[:, 1].contiguous()
    if tbl_u32 is None:
        lvl = last_level.to(torch.int32)
        return WindowRows(u, v, xr, margin * scale_factors[lvl.long()], lvl - 1, lvl + 1,
                          last_valid & vis, None)
    normal, dmin, dmax = pos[:, 3:6], pos[:, 6], pos[:, 7]
    ray = pts - centre_f32(R_cw, t_cw)
    dist = norm3_f32(ray)
    dist_ok = (dist >= 0.8 * dmin) & (dist <= 1.3 * dmax)
    cosang = dot3_f32(ray, normal) / torch.clamp(dist, min=1e-9)
    observable = (tbl_u32[:, 9] > 0) & vis & dist_ok & (cosang > 0.5) & (depth > 0)
    ratio = torch.clamp(dmax, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred = predicted_octave(ratio, f32_reciprocal(log_scale), num_levels)
    return WindowRows(u, v, xr, margin * scale_factors[pred.long()],
                      torch.clamp(pred - 1, min=0), torch.clamp(pred + 1, max=num_levels - 1),
                      observable, pred)


def project_window_rows(p: CameraParams, R_cw, t_cw, pos, *, scale_factors, margin: float,
                        last_level=None, last_valid=None, tbl_u32=None, log_scale: float = 0.0,
                        num_levels: int = 1,
                        model: CameraModel = CameraModel.PERSPECTIVE) -> WindowRows:
    """Kernel R's window rows on CUDA tensors, one launch and one output
    allocation; the plain version on CPU tensors (same arguments and
    results as project_window_rows_plain)."""
    if not pos.is_cuda:
        return project_window_rows_plain(
            p, R_cw, t_cw, pos, scale_factors=scale_factors, margin=margin,
            last_level=last_level, last_valid=last_valid, tbl_u32=tbl_u32, log_scale=log_scale,
            num_levels=num_levels, model=model)
    M = pos.shape[0]
    table = tbl_u32 is not None
    dev = pos.device
    f32, i32 = torch.float32, torch.int32
    ins = ((pos, (M, 8 if table else 3), f32), (R_cw, (3, 3), f32), (t_cw, (3,), f32),
           (scale_factors, scale_factors.shape[:1], f32))
    ins += ((tbl_u32, (M, 10), i32),) if table else \
        ((last_level, (M,), i32), (last_valid, (M,), torch.bool))
    for x, shape, dt in ins:
        if x is None or x.dtype != dt or x.shape != shape or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"project_window_rows: expects contiguous {dt} {tuple(shape)} "
                             "tensors on the points' device")
    if table and (pos.data_ptr() % 16 or not 1 <= num_levels <= scale_factors.shape[0]):
        raise ValueError("project_window_rows: a 16-byte aligned table, at most "
                         "len(scale_factors) levels")
    # one allocation, a row each: u, v, xr, rad (f32), lo, hi, pred (i32),
    # then the valid bytes
    buf = torch.empty((8, M), dtype=i32, device=dev)
    base = buf.data_ptr()
    lib = kbuild.load()
    kbuild.check(lib.svt_window_rows(
        projection_family(model), M, int(table), p.fx, p.fy, p.cx, p.cy, p.width, p.height,
        p.focal_x_baseline, R_cw.data_ptr(), t_cw.data_ptr(), pos.data_ptr(),
        tbl_u32.data_ptr() if table else 0, 0 if table else last_level.data_ptr(),
        0 if table else last_valid.data_ptr(), scale_factors.data_ptr(), float(margin),
        f32_reciprocal(log_scale) if table else 0.0, int(num_levels),
        *(base + 4 * M * q for q in range(8)),
        kbuild.stream_ptr(dev)), "project_window_rows")
    project_window_rows.launches += 1
    u, v, xr, rad = buf[:4].view(f32).unbind(0)
    lo, hi, pred = buf[4:7].unbind(0)
    return WindowRows(u, v, xr, rad, lo, hi, buf[7].view(torch.bool)[:M],
                      pred if table else None)


project_window_rows.launches = 0


class Camera:
    """Host-side camera record: static model/setup + parameter record."""

    def __init__(self, name: str, model: CameraModel, setup: Setup,
                 params: CameraParams, fps: float = 30.0,
                 color_order: str = "Gray", *, width: int, height: int):
        self.name = name
        self.model = model
        self.setup = setup
        self.params = params
        self.fps = float(fps)
        self.color_order = color_order
        self.width = int(width)
        self.height = int(height)

    @property
    def true_baseline(self) -> float:
        """The stereo baseline in metres, focal_x_baseline / fx."""
        fx = float(self.params.fx)
        return float(self.params.focal_x_baseline) / fx if fx != 0 else 0.0

    def undistort(self, pts):
        return undistort_keypoints(self.model, self.params, pts)

    def bearings(self, und_pts):
        return bearings_from_undistorted(self.model, self.params, und_pts)


_MODEL_ALIASES = {
    "perspective": CameraModel.PERSPECTIVE,
    "fisheye": CameraModel.FISHEYE,
    "equirectangular": CameraModel.EQUIRECTANGULAR,
    "radialdivision": CameraModel.RADIAL_DIVISION,
    "radial_division": CameraModel.RADIAL_DIVISION,
    "radial division": CameraModel.RADIAL_DIVISION,
}

_SETUP_ALIASES = {
    "monocular": Setup.MONOCULAR,
    "stereo": Setup.STEREO,
    "rgbd": Setup.RGBD,
    "rgb-d": Setup.RGBD,
}


def camera_from_yaml(node: dict) -> Camera:
    """Build a Camera from a reference-compatible YAML 'Camera' section."""
    model = _MODEL_ALIASES[str(node["model"]).strip().lower()]
    setup = _SETUP_ALIASES[str(node["setup"]).strip().lower()]
    # the equirectangular projection is centred on the image
    centred = model == CameraModel.EQUIRECTANGULAR
    params = make_params(
        fx=node.get("fx", 0.0), fy=node.get("fy", 0.0),
        cx=node.get("cx", node["cols"] / 2.0 if centred else 0.0),
        cy=node.get("cy", node["rows"] / 2.0 if centred else 0.0),
        k1=node.get("k1", 0.0), k2=node.get("k2", 0.0),
        p1=node.get("p1", 0.0), p2=node.get("p2", 0.0),
        k3=node.get("k3", 0.0), k4=node.get("k4", 0.0),
        width=node["cols"], height=node["rows"],
        focal_x_baseline=node.get("focal_x_baseline", 0.0),
        depth_thr=node.get("depth_threshold", 40.0),
    )
    return Camera(node.get("name", "camera"), model, setup, params,
                  fps=node.get("fps", 30.0),
                  color_order=node.get("color_order", "Gray"),
                  width=node["cols"], height=node["rows"])
