"""ORB feature extraction on the card: kernels A (FAST + NMS) and B (describe).

Port of stella_vslam_tpu/feature/orb_extractor.py. The pyramid, slot layout
and every table (resize matrices, blur taps, moment masks, steered BRIEF
offsets) are built by the same numpy code as the JAX version, so slot k of
a frame means the same cell of the same level on both sides:

* pyramid: bilinear INTER_LINEAR resize level to level as `R @ img @ C^T`
  (`torch.matmul`, f32 with TF32 off — the plain large matmul the JAX version
  leaves to XLA);
* kernel A, `fast_nms`: per NMS cell, the exact FAST-9/16 score of every
  pixel and the cell's best packed key (iscore<<12 | row<<6 | col), with the
  two-threshold retry (`ini_fast_thr`, then `min_fast_thr`);
* kernel B, `orb_describe`: per keypoint, the clamped 45x45 patch (bf16
  rounded, like the JAX version's one-hot bf16 gathers), the IC-angle, the
  7x7 sigma=2 blur rounded to integer gray levels, and the steered 256-pair
  BRIEF of the selected 12-degree bin, packed into 8 x 32-bit words.

Descriptors travel as int32 tensors holding the bits of the JAX version's
uint32 words (torch has no uint32 arithmetic).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.feature import orb_pattern
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.kernels import build as kbuild

# FAST-9/16 Bresenham circle offsets (dx, dy), radius 3.
_FAST_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)
ANGLE_BINS = 30  # 12-degree steering quantization (original ORB uses 2*pi/30)
_DESC_R = 19  # rotated BRIEF pattern reach: 13*sqrt(2) < 19
_DESC_W = 2 * _DESC_R + 1  # 39
_RAW_R = _DESC_R + 3  # + blur halo
_RAW_W = 2 * _RAW_R + 1  # 45
_MOM_OFF = _RAW_R - orb_pattern.HALF_PATCH  # 7: moment circle inside the raw patch
# the f32 angle quantum, as `angle / (2*pi/30)` rounds it in the JAX version
_TAU = float(np.float32(2.0 * np.pi / ANGLE_BINS))


class FrameFeatures(NamedTuple):
    """SoA keypoint record (the JAX version's FrameFeatures, as tensors)."""

    xy: torch.Tensor  # [N,2] f32, level-0 (raw/distorted) pixel coords
    response: torch.Tensor  # [N] f32 FAST score
    angle: torch.Tensor  # [N] f32 radians
    level: torch.Tensor  # [N] i32 pyramid level
    valid: torch.Tensor  # [N] bool
    desc: torch.Tensor  # [N,8] i32 (bits of the 256-bit rBRIEF)

    @property
    def num_slots(self) -> int:
        return self.xy.shape[0]


# ---------------------------------------------------------------------------
# tables (same numpy construction as the JAX version)
# ---------------------------------------------------------------------------


def _resize_matrices(h_in: int, w_in: int, h_out: int, w_out: int):
    """Bilinear (INTER_LINEAR, half-pixel centers) resize as two dense
    matrices: out = R @ img @ C^T, R [h_out, h_in], C [w_out, w_in]."""

    def mat(n_out, n_in):
        m = np.zeros((n_out, n_in), dtype=np.float32)
        scale = n_in / n_out
        for i in range(n_out):
            src = (i + 0.5) * scale - 0.5
            j0 = int(np.floor(src))
            f = src - j0
            j0c = min(max(j0, 0), n_in - 1)
            j1c = min(max(j0 + 1, 0), n_in - 1)
            m[i, j0c] += 1.0 - f
            m[i, j1c] += f
        return m

    return mat(h_out, h_in), mat(w_out, w_in)


def gauss_taps() -> np.ndarray:
    """[7,7] f32 two-dimensional taps, each f32(k[ty] * k[tx]) in float64 —
    the entries of the JAX version's in-patch blur matrix."""
    k = orb_pattern.gaussian_kernel_7x7().astype(np.float64)
    return (k[:, None] * k[None, :]).astype(np.float32)


def steered_offsets(pattern: str = "native") -> np.ndarray:
    """[ANGLE_BINS, 256, 4] int8 (rx0, ry0, rx1, ry1) in the 39x39 blurred
    patch: pair p of bin a rotated by 2*pi*a/30, rounded with Python's round
    in float64 (the JAX version's _steered_bit_matrix)."""
    pat = orb_pattern.brief_pattern(pattern)
    out = np.zeros((ANGLE_BINS, 256, 4), np.int8)
    for a in range(ANGLE_BINS):
        th = 2.0 * np.pi * a / ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for p in range(256):
            x0, y0, x1, y1 = pat[p]
            out[a, p] = (int(round(c * x0 - s * y0)) + _DESC_R,
                         int(round(s * x0 + c * y0)) + _DESC_R,
                         int(round(c * x1 - s * y1)) + _DESC_R,
                         int(round(s * x1 + c * y1)) + _DESC_R)
    return out


class _LevelGeom(NamedTuple):
    H: int
    W: int
    cs: int  # NMS cell size (level px)
    Gy: int
    Gx: int
    scale: float


def level_geometry(params: OrbParams, width: int, height: int,
                   min_area: int, border: int):
    """Per-level (H, W, cell size, grid) exactly as the JAX extractor."""
    min_area_sqrt = math.sqrt(min_area)
    levels = []
    for lvl in range(params.num_levels):
        s = params.scale_factors[lvl]
        W_l = max(int(round(width / s)), 2 * border + 8)
        H_l = max(int(round(height / s)), 2 * border + 8)
        span_x = W_l - 2 * border
        span_y = H_l - 2 * border
        cell = min_area_sqrt / s
        Gx = max(int(math.ceil(span_x / cell)), 1)
        Gy = max(int(math.ceil(span_y / cell)), 1)
        cs = int(math.ceil(max(span_x / Gx, span_y / Gy)))
        if cs > 63:
            raise ValueError("packed-key NMS supports cell size <= 63 px "
                             "(min_size <= ~4000)")
        levels.append(_LevelGeom(H_l, W_l, cs, Gy, Gx, s))
    return levels


def extractor_tables(params: OrbParams, levels, pattern: str = "native") -> dict:
    """Every constant table the extractor uses, as numpy arrays."""
    k10, k01 = orb_pattern.ic_angle_moment_kernels()
    resize = [_resize_matrices(levels[i - 1].H, levels[i - 1].W,
                               levels[i].H, levels[i].W)
              for i in range(1, len(levels))]
    return {"resize": resize, "taps": gauss_taps(), "k10": k10, "k01": k01,
            "offsets": steered_offsets(pattern)}


# ---------------------------------------------------------------------------
# kernel A: FAST score + cell NMS
# ---------------------------------------------------------------------------


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Exact FAST-9/16 score of every pixel (plain version): the largest t
    for which 9 contiguous circle pixels are all brighter than
    centre + t, or all darker than centre - t; zero padding outside."""
    H, W = img.shape
    pad = 3
    padded = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    d = torch.stack([padded[pad + dy:pad + dy + H, pad + dx:pad + dx + W] - img
                     for dx, dy in _FAST_OFFSETS.tolist()])  # [16,H,W]
    def window_min(v):
        # cyclic min over (k .. k+8) by doubling: 2, 4, 8, then +1
        w = torch.minimum(v, v.roll(-1, 0))
        w = torch.minimum(w, w.roll(-2, 0))
        w = torch.minimum(w, w.roll(-4, 0))
        return torch.minimum(w, v.roll(-8, 0)).amax(dim=0)

    return torch.maximum(window_min(d), window_min(-d))


def fast_nms_plain(img: torch.Tensor, g: _LevelGeom, border: int,
                   ini_thr: float, min_thr: float) -> torch.Tensor:
    """[Gy*Gx] int32 best packed key per NMS cell, -1 where none."""
    b = border
    score = fast_score_map(img)
    dev = img.device
    ys = torch.arange(g.H, device=dev, dtype=torch.int32)[:, None]
    xs = torch.arange(g.W, device=dev, dtype=torch.int32)[None, :]
    region = (xs >= b) & (xs < g.W - b) & (ys >= b) & (ys < g.H - b)
    iscore = torch.clamp(torch.round(score), 0, 1023).to(torch.int32)
    corner_lo = region & (score > min_thr)
    corner_hi = score > ini_thr
    payload = (((ys - b) % g.cs) << 6) | ((xs - b) % g.cs)
    key = (iscore << 12) | payload
    neg = torch.full_like(key, -1)
    key_lo = torch.where(corner_lo, key, neg)
    key_hi = torch.where(corner_lo & corner_hi, key, neg)
    need_h, need_w = b + g.Gy * g.cs, b + g.Gx * g.cs

    def cell_max(k):
        k = torch.nn.functional.pad(
            k, (0, max(0, need_w - g.W), 0, max(0, need_h - g.H)), value=-1)
        sub = k[b:need_h, b:need_w]
        return sub.reshape(g.Gy, g.cs, g.Gx, g.cs).amax(dim=(1, 3))

    best_hi = cell_max(key_hi)
    best_lo = cell_max(key_lo)
    return torch.where(best_hi >= 0, best_hi, best_lo).reshape(-1)


def fast_nms(img: torch.Tensor, g: _LevelGeom, border: int,
             ini_thr: float, min_thr: float) -> torch.Tensor:
    """Kernel A on a CUDA image, the plain version on a CPU image."""
    if not img.is_cuda:
        return fast_nms_plain(img, g, border, ini_thr, min_thr)
    if img.dtype != torch.float32 or img.shape != (g.H, g.W) \
            or not img.is_contiguous():
        raise ValueError("fast_nms: expects a contiguous f32 [H,W] level image")
    lib = kbuild.load()
    out = torch.empty(g.Gy * g.Gx, dtype=torch.int32, device=img.device)
    kbuild.check(lib.svt_fast_nms(
        img.data_ptr(), g.H, g.W, border, g.cs, g.Gy, g.Gx, float(ini_thr),
        float(min_thr), out.data_ptr(), kbuild.stream_ptr(img.device)),
        "fast_nms")
    fast_nms.launches += 1
    return out


fast_nms.launches = 0


# ---------------------------------------------------------------------------
# kernel B: orientation + blur + steered BRIEF
# ---------------------------------------------------------------------------


class DescribeTables(NamedTuple):
    taps: torch.Tensor  # [7,7] f32
    k10: torch.Tensor  # [31,31] f32
    k01: torch.Tensor  # [31,31] f32
    offsets: torch.Tensor  # [30,256,4] int8


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K,256] bool -> [K,8] int32 words, bit p in word p//32 at p%32."""
    K = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(K, 8, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def orb_describe_plain(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid,
                       tab: DescribeTables):
    """pyr: flat f32 pyramid; per keypoint the level's base offset, H, W,
    pixel (x, y) and validity -> (angle [K] f32, desc [K,8] i32)."""
    K = kp_x.shape[0]
    dev = pyr.device
    d = torch.arange(-_RAW_R, _RAW_R + 1, device=dev, dtype=torch.int64)
    H = kp_H.long()[:, None]
    W = kp_W.long()[:, None]
    rows = torch.minimum(torch.clamp(kp_y.long()[:, None] + d, min=0), H - 1)
    cols = torch.minimum(torch.clamp(kp_x.long()[:, None] + d, min=0), W - 1)
    idx = kp_base.long()[:, None, None] + rows[:, :, None] * W[:, :, None] \
        + cols[:, None, :]
    raw = pyr[idx].to(torch.bfloat16).to(torch.float32)  # [K,45,45]
    circ = raw[:, _MOM_OFF:_MOM_OFF + 31, _MOM_OFF:_MOM_OFF + 31]
    m10 = (circ * tab.k10).sum(dim=(1, 2))
    m01 = (circ * tab.k01).sum(dim=(1, 2))
    angle = torch.where(kp_valid, torch.atan2(m01, m10), torch.zeros_like(m10))
    acc = torch.zeros((K, _DESC_W, _DESC_W), device=dev, dtype=torch.float32)
    for ty in range(7):
        for tx in range(7):
            acc = acc + tab.taps[ty, tx] * raw[:, ty:ty + _DESC_W, tx:tx + _DESC_W]
    blur = torch.round(acc).reshape(K, -1)
    bins = torch.remainder(torch.round(angle / _TAU).to(torch.int64), ANGLE_BINS)
    off = tab.offsets.long()[bins]  # [K,256,4]
    i0 = blur.gather(1, off[..., 1] * _DESC_W + off[..., 0])
    i1 = blur.gather(1, off[..., 3] * _DESC_W + off[..., 2])
    return angle, _pack_bits(i1 > i0)


def orb_describe(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid,
                 tab: DescribeTables):
    """Kernel B on CUDA tensors, the plain version on CPU tensors."""
    if not pyr.is_cuda:
        return orb_describe_plain(pyr, kp_base, kp_H, kp_W, kp_x, kp_y,
                                  kp_valid, tab)
    K = kp_x.shape[0]
    for t, dt in ((kp_base, torch.int32), (kp_H, torch.int32),
                  (kp_W, torch.int32), (kp_x, torch.int32),
                  (kp_y, torch.int32), (kp_valid, torch.bool)):
        if t.dtype != dt or t.shape != (K,) or not t.is_cuda \
                or not t.is_contiguous():
            raise ValueError("orb_describe: bad keypoint array")
    if pyr.dtype != torch.float32 or not pyr.is_contiguous():
        raise ValueError("orb_describe: expects a contiguous f32 pyramid")
    lib = kbuild.load()
    angle = torch.empty(K, dtype=torch.float32, device=pyr.device)
    desc = torch.empty((K, 8), dtype=torch.int32, device=pyr.device)
    kbuild.check(lib.svt_orb_describe(
        pyr.data_ptr(), kp_base.data_ptr(), kp_H.data_ptr(), kp_W.data_ptr(),
        kp_x.data_ptr(), kp_y.data_ptr(), kp_valid.data_ptr(), K,
        tab.taps.data_ptr(), tab.k10.data_ptr(), tab.k01.data_ptr(),
        tab.offsets.data_ptr(), _TAU, angle.data_ptr(), desc.data_ptr(),
        kbuild.stream_ptr(pyr.device)), "orb_describe")
    orb_describe.launches += 1
    return angle, desc


orb_describe.launches = 0


# ---------------------------------------------------------------------------
# the extractor
# ---------------------------------------------------------------------------


class OrbExtractor:
    """Grayscale image -> FrameFeatures with a fixed slot layout (the sum
    over levels of NMS cells). Mirrors the JAX OrbExtractor.extract."""

    def __init__(self, params: OrbParams, width: int, height: int,
                 min_area: int = 800, descriptor_pattern: str = "native",
                 device="cpu", tables: Optional[dict] = None):
        """`tables` replaces the built tables (see convert.extractor_tables)."""
        self.params = params
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        self.border = orb_pattern.EDGE_BORDER
        self.levels = level_geometry(params, self.width, self.height,
                                     min_area, self.border)
        self.num_slots = sum(g.Gy * g.Gx for g in self.levels)
        self.descriptor_pattern = descriptor_pattern or "native"
        if tables is None:
            tables = extractor_tables(params, self.levels,
                                      self.descriptor_pattern)
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self._resize_mats = [(f32(R), f32(C).T.contiguous())
                             for R, C in tables["resize"]]
        self._tables = DescribeTables(
            taps=f32(tables["taps"]), k10=f32(tables["k10"]),
            k01=f32(tables["k01"]),
            offsets=torch.as_tensor(np.asarray(tables["offsets"], np.int8),
                                    device=dev))
        # per-slot constants of the fixed layout
        lv, base, hh, ww = [], [], [], []
        off = 0
        for l, g in enumerate(self.levels):
            n = g.Gy * g.Gx
            lv.append(np.full(n, l, np.int32))
            base.append(np.full(n, off, np.int32))
            hh.append(np.full(n, g.H, np.int32))
            ww.append(np.full(n, g.W, np.int32))
            off += g.H * g.W
        i32 = lambda parts: torch.as_tensor(
            np.concatenate(parts).astype(np.int32), device=dev)
        self._slot_level = i32(lv)
        self._slot_base, self._slot_H, self._slot_W = i32(base), i32(hh), i32(ww)
        # level scale per slot, rounded to f32 as `px * g.scale` rounds it
        self._slot_scale = torch.cat(
            [torch.full((g.Gy * g.Gx,), g.scale, dtype=torch.float32)
             for g in self.levels]).to(dev)

    def pyramid(self, image: torch.Tensor) -> list:
        """[H,W] grayscale (u8 or f32) -> the f32 level images."""
        img = image.to(self.device, torch.float32)
        out = [img]
        for R, Ct in self._resize_mats:
            img = (R @ img) @ Ct  # bilinear INTER_LINEAR as two matmuls
            out.append(img)
        return out

    def cell_keypoints(self, best: torch.Tensor, g: _LevelGeom):
        """Kernel A's per-cell keys -> (px, py, valid, response) of the
        level's slots; px/py are clamped into the level, as in JAX."""
        b = self.border
        cell = torch.arange(g.Gy * g.Gx, device=best.device, dtype=torch.int32)
        py = torch.clamp(b + (cell // g.Gx) * g.cs + ((best >> 6) & 63), 0, g.H - 1)
        px = torch.clamp(b + (cell % g.Gx) * g.cs + (best & 63), 0, g.W - 1)
        ok = best >= 0
        resp = torch.where(ok, (best >> 12).to(torch.float32),
                           torch.zeros((), device=best.device))
        return px, py, ok, resp

    def extract(self, image: torch.Tensor, mask=None) -> FrameFeatures:
        """image: [H,W] grayscale tensor (u8 or f32, 0..255) on the
        extractor's device."""
        if mask is not None:
            raise NotImplementedError(
                "extraction masks are not ported yet (ROADMAP Queue 1 item 14)")
        p = self.params
        levels = self.pyramid(image)
        pts = [self.cell_keypoints(
            fast_nms(img.contiguous(), g, self.border, float(p.ini_fast_thr),
                     float(p.min_fast_thr)), g)
            for img, g in zip(levels, self.levels)]
        px, py, valid, resp = (torch.cat(c) for c in zip(*pts))
        pyr = torch.cat([img.reshape(-1) for img in levels])
        angle, desc = orb_describe(pyr, self._slot_base, self._slot_H,
                                   self._slot_W, px.to(torch.int32),
                                   py.to(torch.int32), valid, self._tables)
        xy = torch.stack([px.to(torch.float32) * self._slot_scale,
                          py.to(torch.float32) * self._slot_scale], dim=-1)
        return FrameFeatures(xy=xy, response=resp, angle=angle,
                             level=self._slot_level, valid=valid, desc=desc)
