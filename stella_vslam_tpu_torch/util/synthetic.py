"""Synthetic plane world rendered with numpy only (no cv2).

Counterpart of stella_vslam_tpu/util/synthetic.py PlaneWorld, for machines
without cv2: the same seeded rectangle texture, a 3x3 sigma=0.8 Gaussian
blur (reflect-101 border, as cv2.GaussianBlur), and the exact plane
homography applied by an inverse bilinear warp (zero outside the texture).
cv2.warpPerspective interpolates with 1/32-pixel fixed-point weights, so the
images are close to the JAX package's, not bit-identical. Exposure drift and
pose-seeded pixel noise follow the JAX version. Floating panels are not
ported.
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

    def camera_yaml(self):
        return {
            "name": "synthetic", "setup": "monocular", "model": "perspective",
            "fx": self.fx, "fy": self.fy, "cx": self.cx, "cy": self.cy,
            "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
            "fps": 20.0, "cols": self.W, "rows": self.H, "color_order": "Gray",
        }

    def render(self, pose_cw: np.ndarray) -> np.ndarray:
        """Render the u8 image for camera-from-world pose (4x4)."""
        R, t = pose_cw[:3, :3], pose_cw[:3, 3]
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]])
        A = np.stack([R[:, 0], R[:, 1], self.depth * R[:, 2] + t], axis=1)
        half = self.tex_size / 2 * self.mpp
        Tm = np.array([[self.mpp, 0, -half], [0, self.mpp, -half], [0, 0, 1.0]])
        Hinv = np.linalg.inv(K @ A @ Tm)  # image px -> texture px
        v, u = np.mgrid[0:self.H, 0:self.W].astype(np.float64)
        den = Hinv[2, 0] * u + Hinv[2, 1] * v + Hinv[2, 2]
        tu = (Hinv[0, 0] * u + Hinv[0, 1] * v + Hinv[0, 2]) / den
        tv = (Hinv[1, 0] * u + Hinv[1, 1] * v + Hinv[1, 2]) / den
        x0 = np.floor(tu).astype(np.int64)
        y0 = np.floor(tv).astype(np.int64)
        fx_ = (tu - x0).astype(np.float32)
        fy_ = (tv - y0).astype(np.float32)
        tex = self.texture.astype(np.float32)
        n = self.tex_size

        def sample(yy, xx):
            ok = (yy >= 0) & (yy < n) & (xx >= 0) & (xx < n)
            return np.where(ok, tex[np.clip(yy, 0, n - 1), np.clip(xx, 0, n - 1)], 0.0)

        out = ((sample(y0, x0) * (1 - fx_) + sample(y0, x0 + 1) * fx_) * (1 - fy_)
               + (sample(y0 + 1, x0) * (1 - fx_) + sample(y0 + 1, x0 + 1) * fx_) * fy_)
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
