"""Camera models as batched torch functions (perspective model only).

Port of stella_vslam_tpu/camera/base.py. The perspective (pinhole +
radial-tangential) model and the MONOCULAR / STEREO / RGBD setups are ported;
fisheye, equirectangular and radial-division raise NotImplementedError until
ROADMAP Queue 1 item 14b. Undistortion is the same fixed-iteration inversion
as the JAX version, written as elementwise ops in the same order.

Kernel R (csrc/reproject.cu) computes the per-point functions of the hot
path on CUDA tensors: `undistort_norm` (every keypoint of every frame) and
`reproject_gate` (the tracking cascade's projections of the chained
landmarks and, with the local-map gate and predicted scale, of the
landmark table). On CPU tensors each runs its plain version, the torch
expressions below.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

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


_NOT_PORTED = "camera model {} is not ported yet (ROADMAP Queue 1 item 14b)"


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


def _perspective_undistort_norm(p: CameraParams, xd, yd, iters: int = 10):
    """Invert radtan by fixed-point iteration on normalized coords."""
    x, y = xd, yd
    for _ in range(iters):
        dx, dy = _radtan_distort(p, x, y)
        x = xd - (dx - x)
        y = yd - (dy - y)
    return x, y


def perspective_undistort(p: CameraParams, pts: torch.Tensor) -> torch.Tensor:
    """Pixel keypoints [N,2] -> undistorted pixel keypoints (same K)."""
    xn = (pts[..., 0] - p.cx) / p.fx
    yn = (pts[..., 1] - p.cy) / p.fy
    x, y = _perspective_undistort_norm(p, xn, yn)
    return torch.stack([x * p.fx + p.cx, y * p.fy + p.cy], dim=-1)


def undistort_norm(p: CameraParams, pts: torch.Tensor) -> torch.Tensor:
    """Kernel R's undistortion on CUDA tensors (normalize, the 10
    iterations of _perspective_undistort_norm, back to pixels), the plain
    version `perspective_undistort` on CPU tensors."""
    if not pts.is_cuda:
        return perspective_undistort(p, pts)
    N = pts.shape[0]
    if tuple(pts.shape) != (N, 2) or pts.dtype != torch.float32:
        raise ValueError("undistort_norm: expected float32 [N,2] pixel keypoints")
    pts = pts.contiguous()
    out = torch.empty_like(pts)
    lib = kbuild.load()
    kbuild.check(lib.svt_undistort(N, p.fx, p.fy, p.cx, p.cy, p.k1, p.k2, p.p1, p.p2, p.k3,
                                   pts.data_ptr(), out.data_ptr(),
                                   kbuild.stream_ptr(pts.device)), "undistort_norm")
    undistort_norm.launches += 1
    return out


undistort_norm.launches = 0


def undistort_keypoints(model: CameraModel, p: CameraParams,
                        pts: torch.Tensor) -> torch.Tensor:
    if model == CameraModel.PERSPECTIVE:
        return undistort_norm(p, pts)
    raise NotImplementedError(_NOT_PORTED.format(CameraModel(model).name))


def bearings_from_undistorted(model: CameraModel, p: CameraParams,
                              pts: torch.Tensor) -> torch.Tensor:
    """Undistorted keypoints [N,2] -> unit bearing vectors [N,3]."""
    if model != CameraModel.PERSPECTIVE:
        raise NotImplementedError(_NOT_PORTED.format(CameraModel(model).name))
    xn = (pts[..., 0] - p.cx) / p.fx
    yn = (pts[..., 1] - p.cy) / p.fy
    v = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def reproject_to_image(model: CameraModel, p: CameraParams, R_cw: torch.Tensor,
                       t_cw: torch.Tensor, pos_w: torch.Tensor):
    """World points [N,3] -> (uv [N,2], depth [N], visible [N] bool)."""
    if model != CameraModel.PERSPECTIVE:
        raise NotImplementedError(_NOT_PORTED.format(CameraModel(model).name))
    pc = pos_w @ R_cw.T + t_cw
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = p.fx * pc[..., 0] / zs + p.cx
    v = p.fy * pc[..., 1] / zs + p.cy
    visible = (z > 0.0) & (u >= 0.0) & (u < p.width) & (v >= 0.0) & (v < p.height)
    return torch.stack([u, v], dim=-1), z, visible


def reproject_gate_plain(p: CameraParams, R_cw, t_cw, pos, tbl_u32=None, *,
                         log_scale: float = 0.0, num_levels: int = 1):
    """Plain version of kernel R's projection. pos [M,3] world points, or
    with `tbl_u32` the packed landmark table (pos = tbl_f32 [C,8]: position,
    normal, min and max distance; tbl_u32 [C,10] with the valid flag in
    column 9). Returns (uv [M,2], depth [M], flag [M] bool, x_right [M],
    predicted scale [M] i32 or None): flag is the in-image test for points,
    the local-map gate for the table (valid, in image, distance in
    [0.8 min, 1.3 max], cos(ray, normal) > 0.5, depth > 0)."""
    pts = pos[:, 0:3] if tbl_u32 is not None else pos
    uv, depth, vis = reproject_to_image(CameraModel.PERSPECTIVE, p, R_cw, t_cw, pts)
    xr = torch.where(depth > 1e-6, uv[:, 0] - p.focal_x_baseline / torch.clamp(depth, min=1e-6),
                     torch.full_like(depth, -1.0))
    if tbl_u32 is None:
        return uv, depth, vis, xr, None
    normal, dmin, dmax = pos[:, 3:6], pos[:, 6], pos[:, 7]
    cam_center = -R_cw.T @ t_cw
    ray = pts - cam_center
    dist = torch.linalg.norm(ray, dim=-1)
    dist_ok = (dist >= 0.8 * dmin) & (dist <= 1.3 * dmax)
    cosang = torch.sum(ray * normal, dim=-1) / torch.clamp(dist, min=1e-9)
    observable = (tbl_u32[:, 9] > 0) & vis & dist_ok & (cosang > 0.5) & (depth > 0)
    ratio = torch.clamp(dmax, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred_scale = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale),
        0, num_levels - 1).to(torch.int32)
    return uv, depth, observable, xr, pred_scale


def reproject_gate(p: CameraParams, R_cw, t_cw, pos, tbl_u32=None, *,
                   log_scale: float = 0.0, num_levels: int = 1):
    """Kernel R's projection on CUDA tensors, the plain version on CPU
    tensors (same arguments and results as reproject_gate_plain)."""
    if not pos.is_cuda:
        return reproject_gate_plain(p, R_cw, t_cw, pos, tbl_u32, log_scale=log_scale,
                                    num_levels=num_levels)
    M = pos.shape[0]
    table = tbl_u32 is not None
    width = 8 if table else 3
    dev = pos.device
    if tuple(pos.shape) != (M, width) or pos.dtype != torch.float32 \
            or not pos.is_contiguous():
        raise ValueError(f"reproject_gate: pos must be a contiguous float32 [M,{width}]")
    if table and (tuple(tbl_u32.shape) != (M, 10) or tbl_u32.dtype != torch.int32
                  or not tbl_u32.is_contiguous() or tbl_u32.device != dev):
        raise ValueError("reproject_gate: tbl_u32 must be a contiguous int32 [M,10]")
    Rt = torch.cat([R_cw.reshape(9), t_cw.reshape(3)]).to(torch.float32)
    if Rt.device != dev:
        raise ValueError("reproject_gate: the pose must be on the points' device")
    uv = torch.empty((M, 2), dtype=torch.float32, device=dev)
    depth = torch.empty(M, dtype=torch.float32, device=dev)
    flag = torch.empty(M, dtype=torch.bool, device=dev)
    xr = torch.empty(M, dtype=torch.float32, device=dev)
    scale = torch.empty(M, dtype=torch.int32, device=dev) if table else None
    lib = kbuild.load()
    kbuild.check(lib.svt_reproject(
        M, int(table), p.fx, p.fy, p.cx, p.cy, p.width, p.height, p.focal_x_baseline,
        Rt.data_ptr(), pos.data_ptr(), tbl_u32.data_ptr() if table else 0,
        float(log_scale), int(num_levels), uv.data_ptr(), depth.data_ptr(), flag.data_ptr(),
        xr.data_ptr(), scale.data_ptr() if table else 0, kbuild.stream_ptr(dev)),
        "reproject_gate")
    reproject_gate.launches += 1
    return uv, depth, flag, xr, scale


reproject_gate.launches = 0


class Camera:
    """Host-side camera record: static model/setup + parameter record."""

    def __init__(self, name: str, model: CameraModel, setup: Setup,
                 params: CameraParams, fps: float = 30.0,
                 color_order: str = "Gray", *, width: int, height: int):
        if model != CameraModel.PERSPECTIVE:
            raise NotImplementedError(_NOT_PORTED.format(CameraModel(model).name))
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
    params = make_params(
        fx=node.get("fx", 0.0), fy=node.get("fy", 0.0),
        cx=node.get("cx", 0.0), cy=node.get("cy", 0.0),
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
