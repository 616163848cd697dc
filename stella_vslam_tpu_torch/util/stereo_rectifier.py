"""Stereo rectification with precomputed remap tables, without cv2.

Port of stella_vslam_tpu/util/stereo_rectifier.py (reference
src/stella_vslam/util/stereo_rectifier.{h,cc}). The JAX version builds the
tables with cv2.initUndistortRectifyMap (radial-tangential, with the
rational k4..k6 when D has 8 entries) or cv2.fisheye.initUndistortRectifyMap
(Kannala-Brandt, D[:4]) and remaps every pair with cv2.remap INTER_LINEAR
on the host. The port has no cv2:

* `undistort_rectify_map` builds the same float32 tables in numpy, in
  float64 as OpenCV does (the inverse of K_new @ R, the distortion of each
  pixel's ray, the cast to float32);
* `RemapTable` reproduces cv2.remap's arithmetic for 8-bit images as
  OpenCV 5 computes it (float32 fractions and fused lerps; older versions
  round the position to 1/32 px and blend with 15-bit integer weights,
  which differs by up to 5 gray levels). The taps and fractions are
  computed once; the remap of a frame is four gathers and three lerps on
  the device.

Rectification is plain glue, as in the JAX version, which runs it on the
host; here it runs on the device the images were uploaded to.
"""
from __future__ import annotations

import numpy as np
import torch


def undistort_rectify_map(K, D, R, K_new, size, fisheye: bool = False):
    """(map_x, map_y) [H,W] float32: for each pixel of the rectified image
    of size (W, H), its position in the raw image with camera matrix K and
    distortion D, rotated by R (cv2.initUndistortRectifyMap with m1type
    CV_32FC1, or its fisheye form with D[:4])."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    R = np.asarray(R, np.float64).reshape(3, 3)
    K_new = np.asarray(K_new, np.float64).reshape(3, 3)
    D = np.asarray(D, np.float64).reshape(-1)
    W, H = int(size[0]), int(size[1])
    iR = np.linalg.inv(K_new @ R)
    i = np.arange(H, dtype=np.float64)[:, None]
    j = np.arange(W, dtype=np.float64)[None, :]
    _x = i * iR[0, 1] + iR[0, 2] + j * iR[0, 0]
    _y = i * iR[1, 1] + iR[1, 2] + j * iR[1, 0]
    _w = i * iR[2, 1] + iR[2, 2] + j * iR[2, 0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        if fisheye:
            k = np.zeros(4)
            k[:min(4, D.size)] = D[:4]
            x, y = _x / _w, _y / _w
            r = np.sqrt(x * x + y * y)
            th = np.arctan(r)
            th2 = th * th
            th4 = th2 * th2
            theta_d = th * (1 + k[0] * th2 + k[1] * th4 + k[2] * th4 * th2 + k[3] * th4 * th4)
            scale = np.where(r == 0, 1.0, theta_d / r)
            xd, yd = x * scale, y * scale
            u = fx * (xd + K[0, 1] / fx * yd) + cx
            v = fy * yd + cy
            behind = _w <= 0
            u = np.where(behind, np.where(_x > 0, -np.inf, np.inf), u)
            v = np.where(behind, np.where(_y > 0, -np.inf, np.inf), v)
        else:
            if D.size > 8 and np.any(D[8:] != 0):
                raise NotImplementedError("thin-prism and tilt distortion terms")
            d = np.zeros(8)
            d[:min(8, D.size)] = D[:8]
            k1, k2, p1, p2, k3, k4, k5, k6 = d
            w = 1.0 / _w
            x, y = _x * w, _y * w
            x2, y2 = x * x, y * y
            r2 = x2 + y2
            _2xy = 2 * x * y
            kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
            u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + cx
            v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + cy
    return u.astype(np.float32), v.astype(np.float32)


class RemapTable:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR) for uint8 [h, w] images
    (BORDER_CONSTANT 0), as OpenCV 5 computes it: the source position's
    floor and float32 fractions (fx, fy), taps outside the image read as 0,
    a = fma(fx, p01 - p00, p00), b = fma(fx, p11 - p10, p10),
    v = fma(fy, b - a, a) in float32, rounded half to even and saturated.
    Each fused multiply-add is formed in float64 and rounded to float32:
    exactly for a and b (integer differences times a float32 fraction); v
    can round twice where float64 cannot hold the sum, which tests/
    test_torch_rectifier.py measures against cv2.remap. Non-finite map
    entries give 0."""

    def __init__(self, map_x: np.ndarray, map_y: np.ndarray, src_size, device="cuda"):
        w_src, h_src = int(src_size[0]), int(src_size[1])
        self.shape = map_x.shape
        mx, my = np.asarray(map_x, np.float32), np.asarray(map_y, np.float32)
        ok = np.isfinite(mx) & np.isfinite(my)
        # a finite position far outside reads four zero taps, as a
        # non-finite one gives 0
        mx = np.clip(np.where(ok, mx, -4.0), -4.0, w_src + 4.0).astype(np.float32)
        my = np.clip(np.where(ok, my, -4.0), -4.0, h_src + 4.0).astype(np.float32)
        x0, y0 = np.floor(mx), np.floor(my)
        fx, fy = (mx - x0).astype(np.float32), (my - y0).astype(np.float32)
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        idx, inside = [], []
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            xx, yy = x0 + dx, y0 + dy
            inside.append((xx >= 0) & (xx < w_src) & (yy >= 0) & (yy < h_src))
            idx.append(np.clip(yy, 0, h_src - 1) * w_src + np.clip(xx, 0, w_src - 1))
        dev = torch.device(device)
        self.idx = torch.as_tensor(np.stack(idx).reshape(4, -1), device=dev)
        self.inside = torch.as_tensor(np.stack(inside).reshape(4, -1), device=dev)
        self.fx = torch.as_tensor(fx.reshape(-1).astype(np.float64), device=dev)
        self.fy = torch.as_tensor(fy.reshape(-1).astype(np.float64), device=dev)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        src = img.reshape(-1).to(torch.float32)
        p = torch.where(self.inside, src[self.idx], torch.zeros((), device=src.device))
        f32, f64 = torch.float32, torch.float64
        a = (self.fx * (p[1] - p[0]).to(f64) + p[0].to(f64)).to(f32)
        b = (self.fx * (p[3] - p[2]).to(f64) + p[2].to(f64)).to(f32)
        v = (self.fy * (b - a).to(f64) + a.to(f64)).to(f32)
        return torch.clamp(torch.round(v), 0, 255).to(torch.uint8).reshape(self.shape)


class StereoRectifier:
    def __init__(self, camera, rectifier_params: dict, device="cuda"):
        """rectifier_params: the StereoRectifier YAML section, with K_left /
        D_left / R_left (and _right) as flat lists and `model` perspective
        or fisheye (reference stereo_rectifier.cc:14-60)."""
        p = camera.params
        self.size = (camera.width, camera.height)
        K_new = np.array([[p.fx, 0, p.cx], [0, p.fy, p.cy], [0, 0, 1]], np.float64)
        fisheye = str(rectifier_params.get("model", "perspective")).lower() == "fisheye"
        self.maps = {}
        self._remap = {}
        for side in ("left", "right"):
            K = np.array(rectifier_params[f"K_{side}"], np.float64).reshape(3, 3)
            D = np.array(rectifier_params[f"D_{side}"], np.float64)
            R = np.array(rectifier_params[f"R_{side}"], np.float64).reshape(3, 3)
            m1, m2 = undistort_rectify_map(K, D, R, K_new, self.size, fisheye)
            self.maps[side] = (m1, m2)
            self._remap[side] = RemapTable(m1, m2, self.size, device)

    def rectify(self, img_left: torch.Tensor, img_right: torch.Tensor):
        """Raw uint8 [H,W] images on the rectifier's device -> the rectified
        pair."""
        return self._remap["left"](img_left), self._remap["right"](img_right)
