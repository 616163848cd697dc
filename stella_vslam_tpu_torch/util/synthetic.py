"""Synthetic worlds rendered with numpy only (no cv2).

Counterparts of stella_vslam_tpu/util/synthetic.py, for machines without
cv2. PlaneWorld: the same seeded rectangle texture, a 3x3 sigma=0.8
Gaussian blur (reflect-101 border, as cv2.GaussianBlur), and the exact
plane homography applied by an inverse bilinear warp (zero outside the
texture). cv2.warpPerspective interpolates with 1/32-pixel fixed-point
weights, so the images are close to the JAX package's, not bit-identical.
Exposure drift and pose-seeded pixel noise follow the JAX version. Floating
panels are not ported. DistortedPlaneWorld: PlaneWorld through a fisheye or
a radial-division camera, each distorted pixel sampling the plane along its
undistorted ray (float64, no cv2; the JAX package's end-to-end test
resamples a pinhole image with cv2.remap instead). BoxWorld (the
equirectangular camera's textured box room, ray-cast per pixel): the same
textures from the same rng calls in the same order, blurred as cv2 blurs a
float32 image (bit for bit), and the JAX version's renderer, which is numpy
already: the images equal the JAX package's byte for byte.
"""
from __future__ import annotations

import zlib

import numpy as np


def _gauss3(img: np.ndarray, sigma: float = 0.8) -> np.ndarray:
    k = np.exp(-0.5 * (np.arange(-1, 2) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    p = np.pad(img, 1, mode="reflect")  # reflect-101 == cv2's default
    rows = k[0] * p[:-2] + k[1] * p[1:-1] + k[2] * p[2:]
    return k[0] * rows[:, :-2] + k[1] * rows[:, 1:-1] + k[2] * rows[:, 2:]


def _gauss3_f32(img: np.ndarray, sigma: float = 0.8) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), sigma) of a float32 image, bit for bit:
    the horizontal pass centre-first, fma(k_c, b, k_s * (a + c)), then the
    vertical pass side-first, fma(k_s, a + c, k_c * b), each fma evaluated
    exactly in float64 (a float32 product is exact there) and rounded once."""
    k = np.exp(-0.5 * (np.arange(-1, 2) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    ks, kc = np.float64(k[0]), np.float64(k[1])
    f32 = np.float32
    p = np.pad(img, 1, mode="reflect")
    side = (p[:, :-2] + p[:, 2:]).astype(f32)
    rows = (kc * p[:, 1:-1] + (f32(ks) * side).astype(f32)).astype(f32)
    side = (rows[:-2] + rows[2:]).astype(f32)
    return (ks * side + (f32(kc) * rows[1:-1]).astype(f32)).astype(f32)


class PlaneWorld:
    """Texture on the world plane Z = depth; camera-from-world poses given.
    World (X, Y) maps to texture pixels via meters_per_px."""

    def __init__(self, width=400, height=300, fx=320.0, fy=320.0, depth=4.0,
                 tex_size=2048, meters_per_px=0.01, seed=13,
                 noise_sigma=0.0, exposure_amp=0.0):
        self.W, self.H = width, height
        self.fx, self.fy = fx, fy
        self.cx, self.cy = width / 2.0, height / 2.0
        self.depth = depth
        self.mpp = meters_per_px
        self.noise_sigma = float(noise_sigma)
        self.exposure_amp = float(exposure_amp)
        rng = np.random.default_rng(seed)
        tex = np.zeros((tex_size, tex_size), np.float32)
        for _ in range(6000):
            x, y = rng.integers(0, tex_size, 2)
            w, h = rng.integers(4, 40, 2)
            # filled rectangle with inclusive corners, clipped to the image
            tex[y:y + h + 1, x:x + w + 1] = float(rng.uniform(20, 235))
        self.texture = np.clip(_gauss3(tex), 0, 255).astype(np.uint8)
        self.tex_size = tex_size
        self._grid = None  # the pixel grid (v, u), float64, built at the first render

    def camera_yaml(self):
        return {
            "name": "synthetic", "setup": "monocular", "model": "perspective",
            "fx": self.fx, "fy": self.fy, "cx": self.cx, "cy": self.cy,
            "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
            "fps": 20.0, "cols": self.W, "rows": self.H, "color_order": "Gray",
        }

    def render(self, pose_cw: np.ndarray, uv=None) -> np.ndarray:
        """Render the u8 image for camera-from-world pose (4x4). `uv`: per
        output pixel, the float64 pixel (u [H,W], v [H,W]) of the ideal
        pinhole camera whose ray it sees (a distorted camera's map); the
        pixel grid itself by default."""
        R, t = pose_cw[:3, :3], pose_cw[:3, 3]
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]])
        A = np.stack([R[:, 0], R[:, 1], self.depth * R[:, 2] + t], axis=1)
        half = self.tex_size / 2 * self.mpp
        Tm = np.array([[self.mpp, 0, -half], [0, self.mpp, -half], [0, 0, 1.0]])
        Hinv = np.linalg.inv(K @ A @ Tm)  # image px -> texture px
        if uv is None:
            if self._grid is None:
                self._grid = np.mgrid[0:self.H, 0:self.W].astype(np.float64)
            v, u = self._grid
        else:
            u, v = uv
        den = Hinv[2, 0] * u + Hinv[2, 1] * v + Hinv[2, 2]
        tu = (Hinv[0, 0] * u + Hinv[0, 1] * v + Hinv[0, 2]) / den
        tv = (Hinv[1, 0] * u + Hinv[1, 1] * v + Hinv[1, 2]) / den
        x0 = np.floor(tu).astype(np.int64)
        y0 = np.floor(tv).astype(np.int64)
        fx_ = (tu - x0).astype(np.float32)
        fy_ = (tv - y0).astype(np.float32)
        n = self.tex_size
        flat = self.texture.reshape(-1)
        # the four neighbours' rows and columns, clipped, and which lie inside
        rows = [(np.clip(y, 0, n - 1) * n, (y >= 0) & (y < n)) for y in (y0, y0 + 1)]
        cols = [(np.clip(x, 0, n - 1), (x >= 0) & (x < n)) for x in (x0, x0 + 1)]

        def sample(r, c):
            # the u8 texel as float32, exactly the float32 texture's value
            return np.where(r[1] & c[1], np.take(flat, r[0] + c[0]).astype(np.float32),
                            np.float32(0.0))

        out = ((sample(rows[0], cols[0]) * (1 - fx_) + sample(rows[0], cols[1]) * fx_)
               * (1 - fy_)
               + (sample(rows[1], cols[0]) * (1 - fx_) + sample(rows[1], cols[1]) * fx_) * fy_)
        out = out.astype(np.float32)
        if not (self.exposure_amp or self.noise_sigma):
            return np.clip(np.rint(out), 0, 255).astype(np.uint8)
        img = np.clip(np.rint(out), 0, 255).astype(np.uint8).astype(np.float32)
        c = -R.T @ t
        if self.exposure_amp:
            img *= 1.0 + self.exposure_amp * np.sin(0.7 * c[0] + 1.3 * c[1] + 0.4)
        if self.noise_sigma:
            # seeded from the pose by a stable hash: same pose -> same image
            nrng = np.random.default_rng(zlib.crc32(np.round(pose_cw, 6).tobytes()))
            img += nrng.normal(0.0, self.noise_sigma, img.shape).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.uint8)


# the fisheye and division coefficients of the JAX package's distorted
# end-to-end test (tests/test_fisheye_radial_e2e.py)
FISH_D = (0.08, -0.02, 0.015, -0.005)  # Kannala-Brandt k1..k4
RADIAL_K1 = -0.12  # division model


def kb_undistort_norm(xd: np.ndarray, yd: np.ndarray, d=FISH_D, iters: int = 30):
    """Normalised distorted coordinates -> the undistorted ray's normalised
    coordinates under Kannala-Brandt, in float64: Newton on theta for
    theta (1 + k1 t^2 + k2 t^4 + k3 t^6 + k4 t^8) = r_d, then tan(theta)
    along the same direction (cv2.fisheye.undistortPoints' model)."""
    k1, k2, k3, k4 = d
    rd = np.sqrt(xd * xd + yd * yd)
    th = rd.copy()
    for _ in range(iters):
        t2 = th * th
        f = th * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - rd
        df = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        th = th - f / df
    scale = np.where(rd > 1e-12, np.tan(th) / np.maximum(rd, 1e-12), 1.0)
    return xd * scale, yd * scale


def radial_division_undistort_norm(xd: np.ndarray, yd: np.ndarray, k1: float = RADIAL_K1):
    """The division model's closed form, x_u = x_d / (1 + k1 r_d^2), in
    float64."""
    scale = 1.0 / (1.0 + k1 * (xd * xd + yd * yd))
    return xd * scale, yd * scale


class DistortedPlaneWorld:
    """PlaneWorld seen through a fisheye (Kannala-Brandt, FISH_D) or a
    radial-division (RADIAL_K1) camera with the world's intrinsics: every
    distorted pixel takes the undistorted ray of its normalised coordinates
    (float64, no cv2), which PlaneWorld.render casts onto the plane and
    samples as it samples its own pixels, with the same texture, noise and
    exposure drift."""

    def __init__(self, world: PlaneWorld, model: str):
        if model not in ("fisheye", "radial_division"):
            raise ValueError(f"DistortedPlaneWorld: no model {model!r}")
        self.world, self.model = world, model
        v, u = np.mgrid[0:world.H, 0:world.W].astype(np.float64)
        xd, yd = (u - world.cx) / world.fx, (v - world.cy) / world.fy
        und = kb_undistort_norm if model == "fisheye" else radial_division_undistort_norm
        xu, yu = und(xd, yd)
        self._uv = (world.fx * xu + world.cx, world.fy * yu + world.cy)

    def __getattr__(self, name):
        return getattr(self.world, name)

    def camera_yaml(self):
        cam = dict(self.world.camera_yaml(), model=self.model,
                   name=f"synthetic {self.model}", k1=0.0, k2=0.0, k3=0.0, k4=0.0)
        for key in ("p1", "p2"):
            cam.pop(key)
        if self.model == "fisheye":
            cam.update(zip(("k1", "k2", "k3", "k4"), FISH_D))
        else:
            cam["k1"] = RADIAL_K1
        return cam

    def render(self, pose_cw: np.ndarray) -> np.ndarray:
        return self.world.render(pose_cw, uv=self._uv)


class BoxWorld:
    """Textured axis-aligned box room rendered for an equirectangular camera
    by exact per-pixel ray casting (parallax-correct ground truth for 360
    SLAM)."""

    def __init__(self, width=640, height=320, half=4.0, tex_size=1024, seed=5):
        self.W, self.H = width, height
        self.half = half
        rng = np.random.default_rng(seed)
        self.textures = []
        for _ in range(6):
            tex = np.zeros((tex_size, tex_size), np.float32)
            for _k in range(2500):
                x, y = rng.integers(0, tex_size, 2)
                w, h = rng.integers(4, 40, 2)
                # filled rectangle with inclusive corners, clipped to the image
                tex[y:y + h + 1, x:x + w + 1] = float(rng.uniform(20, 235))
            self.textures.append(_gauss3_f32(tex))
        self.tex_size = tex_size
        # pixel-centre bearings in the camera frame (the equirectangular
        # convention of camera.base.bearings_from_undistorted)
        u = np.arange(width, dtype=np.float64)
        v = np.arange(height, dtype=np.float64)
        lon = (u - width / 2.0) * (2.0 * np.pi) / width
        lat = -(v - height / 2.0) * np.pi / height
        lon, lat = np.meshgrid(lon, lat)
        self._bearings = np.stack(
            [np.cos(lat) * np.sin(lon), -np.sin(lat), np.cos(lat) * np.cos(lon)], axis=-1)

    def camera_yaml(self):
        return {"name": "synthetic-360", "setup": "monocular", "model": "equirectangular",
                "fps": 20.0, "cols": self.W, "rows": self.H, "color_order": "Gray"}

    def render(self, pose_cw: np.ndarray) -> np.ndarray:
        """Render the u8 image for camera-from-world pose (4x4); the camera
        centre must stay inside the box."""
        R, t = pose_cw[:3, :3], pose_cw[:3, 3]
        c = -R.T @ t
        d = self._bearings @ R  # world-frame ray directions [H,W,3]
        h = self.half
        # exit distance through the box from an interior point
        with np.errstate(divide="ignore", invalid="ignore"):
            d_safe = np.where(np.abs(d) < 1e-12, 1e-12, d)
            t_axis = np.where(d > 0, (h - c) / d_safe, (-h - c) / d_safe)
            t_axis = np.where(np.abs(d) < 1e-12, np.inf, t_axis)
        face_axis = np.argmin(t_axis, axis=-1)
        t_exit = np.take_along_axis(t_axis, face_axis[..., None], axis=-1)[..., 0]
        p = c + d * t_exit[..., None]  # hit points
        sign_pos = np.take_along_axis(d, face_axis[..., None], axis=-1)[..., 0] > 0
        img = np.zeros((self.H, self.W), np.float32)
        uv_axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
        for axis in range(3):
            for pos in (False, True):
                m = (face_axis == axis) & (sign_pos == pos)
                if not m.any():
                    continue
                a, b = uv_axes[axis]
                tu = (p[m, a] + h) / (2 * h) * (self.tex_size - 1)
                tv = (p[m, b] + h) / (2 * h) * (self.tex_size - 1)
                tex = self.textures[axis * 2 + int(pos)]
                # bilinear sample
                x0 = np.clip(tu.astype(np.int64), 0, self.tex_size - 2)
                y0 = np.clip(tv.astype(np.int64), 0, self.tex_size - 2)
                fx_ = tu - x0
                fy_ = tv - y0
                img[m] = (tex[y0, x0] * (1 - fx_) * (1 - fy_)
                          + tex[y0, x0 + 1] * fx_ * (1 - fy_)
                          + tex[y0 + 1, x0] * (1 - fx_) * fy_
                          + tex[y0 + 1, x0 + 1] * fx_ * fy_)
        return np.clip(img, 0, 255).astype(np.uint8)


def equirect_circle(n: int = 250, radius: float = 1.8, yaw_rate: float = 0.01):
    """bench.py's equirectangular circuit (bench.py:141-150): n
    camera-from-world poses on a circle of `radius` m in the horizontal
    plane, yawing `yaw_rate` rad a frame; returns (poses [n,4,4], centres
    [n,3])."""
    poses, centres = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        center = np.array([radius * np.sin(ang), 0.0, radius * np.cos(ang)])
        yaw = yaw_rate * i
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, 3] = T[:3, :3] @ -center
        poses.append(T)
        centres.append(center)
    return np.stack(poses), np.stack(centres)


def _se3_exp_f32(xi: np.ndarray):
    """SE(3) exponential in float32 (ops/lie.se3_exp), numpy."""
    xi = xi.astype(np.float32)
    rho, phi = xi[:3], xi[3:]
    th2 = np.float32(phi @ phi)
    th = np.float32(np.sqrt(max(th2, np.float32(1e-16))))
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0]], np.float32)
    if th2 < 1e-8:
        a, b, c = 1 - th2 / 6, 0.5 - th2 / 24, 1 / 6 - th2 / 120
    else:
        a, b, c = np.sin(th) / th, (1 - np.cos(th)) / th2, (th - np.sin(th)) / (th2 * th)
    I = np.eye(3, dtype=np.float32)
    R = I + a * K + b * (K @ K)
    J = I + b * K + c * (K @ K)
    return R.astype(np.float32), (J @ rho).astype(np.float32)


def lateral_trajectory(n_frames: int, step=0.02, yaw_rate=0.002):
    """Sideways translation with slight yaw, keeping the plane in view."""
    poses = []
    for i in range(n_frames):
        R, t = _se3_exp_f32(np.array([i * step, 0.002 * i, 0.0, 0.0,
                                      yaw_rate * i, 0.0]))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return poses
