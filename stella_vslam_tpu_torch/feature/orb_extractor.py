"""ORB feature extraction on the card: kernels A (FAST + NMS) and B (describe).

Port of stella_vslam_tpu/feature/orb_extractor.py. The pyramid, slot layout
and every table (resize matrices, blur taps, moment masks, steered BRIEF
offsets) are built by the same numpy code as the JAX version, so slot k of
a frame means the same cell of the same level on both sides:

* pyramid, kernel S (K3), `resize_level`: bilinear INTER_LINEAR resize
  level to level, the JAX version's `R @ img @ C^T`; on the card each output
  pixel forms its four taps from the two non-zero entries of its rows of R
  and C as a dot product that walks the source index upwards (the CPU's
  matmul rounds so; cuBLAS splits its sums every 8 source indices on most
  of these shapes, so one pixel in ~16 differs from it by an ulp). Plain
  version: the two `torch.matmul`, f32 with TF32 off. The levels of all
  images of a batch live in one flat buffer [B, sum of H*W] that kernels A
  and B read;
* kernel A, `fast_nms`: per NMS cell, the exact FAST-9/16 score of every
  pixel and the cell's best packed key (iscore<<12 | row<<6 | col), with the
  two-threshold retry (`ini_fast_thr`, then `min_fast_thr`);
* kernel B, `orb_describe`: per keypoint, the clamped 45x45 patch (bf16
  rounded, like the JAX version's one-hot bf16 gathers), the IC-angle, the
  7x7 sigma=2 blur rounded to integer gray levels, and the steered 256-pair
  BRIEF of the selected 12-degree bin, packed into 8 x 32-bit words; for the
  stereo matcher it also writes the 11x21 strip around the blurred patch's
  centre (`orb_describe_strips`; the JAX version's extract_with_patches).

A batch of images (a stereo pair, `extract_pair_with_patches`) goes through
each launch of S, A and B together, as the JAX version's vmap does.

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


def resize_taps(m: np.ndarray):
    """A resize matrix [n_out, n_in] -> (j [n_out,2] int32, w [n_out,2] f32):
    each row's non-zero entries in ascending column order; a row with one
    (a clamped border, or a tap of weight 0) repeats its column with weight 0."""
    n_out = m.shape[0]
    j = np.zeros((n_out, 2), np.int32)
    w = np.zeros((n_out, 2), np.float32)
    for i in range(n_out):
        nz = np.nonzero(m[i])[0]
        if not 1 <= len(nz) <= 2:
            raise ValueError("a resize row needs one or two non-zero entries")
        j[i] = (nz[0], nz[-1])
        w[i] = (m[i, nz[0]], m[i, nz[1]] if len(nz) == 2 else 0.0)
    return j, w


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
# kernel S: level-to-level resize
# ---------------------------------------------------------------------------


class ResizeLevel(NamedTuple):
    """One level step: the matmul operands and the kernel's taps."""

    R: torch.Tensor  # [h_out, h_in] f32
    Ct: torch.Tensor  # [w_in, w_out] f32 (C transposed)
    row_j: torch.Tensor  # [h_out, 2] i32
    row_w: torch.Tensor  # [h_out, 2] f32
    col_j: torch.Tensor  # [w_out, 2] i32
    col_w: torch.Tensor  # [w_out, 2] f32


def resize_level_plain(img: torch.Tensor, R: torch.Tensor, Ct: torch.Tensor) -> torch.Tensor:
    """[h_in, w_in] -> [h_out, w_out]: `(R @ img) @ C^T`, the JAX version's form."""
    return (R @ img) @ Ct


def resize_level(pyr: torch.Tensor, off_in: int, g_in, off_out: int, g_out,
                 step: ResizeLevel):
    """Level l-1 (at off_in of each row of the flat pyramid [B, P]) ->
    level l (written at off_out): kernel S on a CUDA pyramid, the plain
    version on a CPU one."""
    n_in, n_out = g_in.H * g_in.W, g_out.H * g_out.W
    if not pyr.is_cuda:
        for b in range(pyr.shape[0]):
            src = pyr[b, off_in:off_in + n_in].view(g_in.H, g_in.W)
            pyr[b, off_out:off_out + n_out] = resize_level_plain(src, step.R, step.Ct).reshape(-1)
        return
    if pyr.dtype != torch.float32 or pyr.dim() != 2 or not pyr.is_contiguous() \
            or off_out + n_out > pyr.shape[1] or off_in + n_in > off_out:
        raise ValueError("resize_level: expects a contiguous f32 [B, P] pyramid")
    lib = kbuild.load()
    ptr = lambda off: pyr.data_ptr() + 4 * off
    kbuild.check(lib.svt_resize_level(
        pyr.shape[0], ptr(off_in), pyr.shape[1], g_in.W, ptr(off_out), g_out.H, g_out.W,
        step.row_j.data_ptr(), step.row_w.data_ptr(), step.col_j.data_ptr(),
        step.col_w.data_ptr(), kbuild.stream_ptr(pyr.device)), "resize_level")
    resize_level.launches += 1


resize_level.launches = 0


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
    """Kernel A on a CUDA image, the plain version on a CPU image. `img`:
    one level [H,W] -> [Gy*Gx], or a batch [B,H,W] whose images are each
    contiguous (any batch stride) -> [B, Gy*Gx]."""
    if not img.is_cuda:
        if img.dim() == 2:
            return fast_nms_plain(img, g, border, ini_thr, min_thr)
        return torch.stack([fast_nms_plain(x, g, border, ini_thr, min_thr) for x in img])
    batch = img if img.dim() == 3 else img[None]
    if img.dtype != torch.float32 or tuple(batch.shape[1:]) != (g.H, g.W) \
            or batch.stride(1) != g.W or batch.stride(2) != 1:
        raise ValueError("fast_nms: expects f32 [H,W] level images, each contiguous")
    lib = kbuild.load()
    B = batch.shape[0]
    out = torch.empty((B, g.Gy * g.Gx), dtype=torch.int32, device=img.device)
    kbuild.check(lib.svt_fast_nms(
        B, batch.data_ptr(), batch.stride(0), g.H, g.W, border, g.cs, g.Gy, g.Gx,
        float(ini_thr), float(min_thr), out.data_ptr(), kbuild.stream_ptr(img.device)),
        "fast_nms")
    fast_nms.launches += 1
    return out if img.dim() == 3 else out[0]


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


STRIP_H, STRIP_W = 11, 21  # the stereo matcher's window rows x slide span
_STRIP_Y, _STRIP_X = _DESC_R - STRIP_H // 2, _DESC_R - STRIP_W // 2


def orb_describe_plain(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid,
                       tab: DescribeTables, strips: bool = False):
    """pyr: flat f32 pyramid; per keypoint the level's base offset, H, W,
    pixel (x, y) and validity -> (angle [K] f32, desc [K,8] i32), and with
    `strips` the [K,11,21] uint8 strip around the blurred patch's centre."""
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
    if not strips:
        return angle, _pack_bits(i1 > i0)
    strip = blur.reshape(K, _DESC_W, _DESC_W)[
        :, _STRIP_Y:_STRIP_Y + STRIP_H, _STRIP_X:_STRIP_X + STRIP_W].to(torch.uint8)
    return angle, _pack_bits(i1 > i0), strip.contiguous()


def _describe_launch(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid,
                     tab: DescribeTables, strips: bool):
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
    strip = torch.empty((K, STRIP_H, STRIP_W), dtype=torch.uint8, device=pyr.device) \
        if strips else None
    kbuild.check(lib.svt_orb_describe(
        pyr.data_ptr(), kp_base.data_ptr(), kp_H.data_ptr(), kp_W.data_ptr(),
        kp_x.data_ptr(), kp_y.data_ptr(), kp_valid.data_ptr(), K,
        tab.taps.data_ptr(), tab.k10.data_ptr(), tab.k01.data_ptr(),
        tab.offsets.data_ptr(), _TAU, angle.data_ptr(), desc.data_ptr(),
        strip.data_ptr() if strips else None, kbuild.stream_ptr(pyr.device)), "orb_describe")
    return (angle, desc, strip) if strips else (angle, desc)


def orb_describe(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid,
                 tab: DescribeTables):
    """Kernel B on CUDA tensors, the plain version on CPU tensors."""
    if not pyr.is_cuda:
        return orb_describe_plain(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid, tab)
    out = _describe_launch(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid, tab, False)
    orb_describe.launches += 1
    return out


orb_describe.launches = 0


def orb_describe_strips(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid,
                        tab: DescribeTables):
    """Kernel B with its blurred-strip output (the stereo path), counted
    apart from orb_describe; the plain version on CPU tensors."""
    if not pyr.is_cuda:
        return orb_describe_plain(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid, tab,
                                  strips=True)
    out = _describe_launch(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid, tab, True)
    orb_describe_strips.launches += 1
    return out


orb_describe_strips.launches = 0


# ---------------------------------------------------------------------------
# the extractor
# ---------------------------------------------------------------------------


class OrbExtractor:
    """Grayscale image -> FrameFeatures with a fixed slot layout (the sum
    over levels of NMS cells). Mirrors the JAX OrbExtractor.extract."""

    def __init__(self, params: OrbParams, width: int, height: int,
                 min_area: int = 800, descriptor_pattern: str = "native",
                 device="cuda", tables: Optional[dict] = None):
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
        i32np = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        self._resize = []
        for R, C in tables["resize"]:
            (rj, rw), (cj, cw) = resize_taps(np.asarray(R)), resize_taps(np.asarray(C))
            self._resize.append(ResizeLevel(
                R=f32(R), Ct=f32(C).T.contiguous(), row_j=i32np(rj), row_w=f32(rw),
                col_j=i32np(cj), col_w=f32(cw)))
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
        self._level_off = [int(b[0]) for b in base]
        self.pyramid_size = off  # floats of one image's levels
        self._slot_level = i32(lv)
        self._slot_base, self._slot_H, self._slot_W = i32(base), i32(hh), i32(ww)
        self._batch_slots = {}
        # level scale per slot, rounded to f32 as `px * g.scale` rounds it
        self._slot_scale = torch.cat(
            [torch.full((g.Gy * g.Gx,), g.scale, dtype=torch.float32)
             for g in self.levels]).to(dev)

    def pyramid_flat(self, images: torch.Tensor) -> torch.Tensor:
        """[B,H,W] grayscale (u8 or f32) on the extractor's device -> the f32
        levels of each image, one flat row [B, pyramid_size] each (kernel S
        on the card, the two matmuls on the CPU)."""
        B = images.shape[0]
        g0 = self.levels[0]
        pyr = torch.empty((B, self.pyramid_size), dtype=torch.float32, device=self.device)
        pyr[:, :g0.H * g0.W] = images.reshape(B, -1)
        for l in range(1, len(self.levels)):
            resize_level(pyr, self._level_off[l - 1], self.levels[l - 1],
                         self._level_off[l], self.levels[l], self._resize[l - 1])
        return pyr

    def level_views(self, pyr: torch.Tensor) -> list:
        """The flat pyramid [B, P] -> per level a [B,H,W] view."""
        return [pyr[:, o:o + g.H * g.W].view(pyr.shape[0], g.H, g.W)
                for o, g in zip(self._level_off, self.levels)]

    def pyramid(self, image: torch.Tensor) -> list:
        """[H,W] grayscale (u8 or f32) -> the f32 level images."""
        img = image.to(self.device)
        return [v[0] for v in self.level_views(self.pyramid_flat(img[None]))]

    def pyramid_plain(self, image: torch.Tensor) -> list:
        """The plain version of `pyramid`: the two matmuls per level on the
        image's device."""
        img = image.to(torch.float32)
        out = [img]
        for step in self._resize:
            img = resize_level_plain(img, step.R, step.Ct)
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

    def _slots(self, B: int):
        """Per-slot (base offset, H, W) of a batch of B pyramids."""
        if B not in self._batch_slots:
            shift = (torch.arange(B, dtype=torch.int32, device=self.device)
                     * self.pyramid_size)[:, None]
            self._batch_slots[B] = ((self._slot_base[None] + shift).reshape(-1).contiguous(),
                                    self._slot_H.repeat(B), self._slot_W.repeat(B))
        return self._batch_slots[B]

    def _extract_batch(self, images: torch.Tensor, strips: bool):
        """[B,H,W] -> a list of B FrameFeatures and, with `strips`, the
        [B, N, 11, 21] uint8 blurred strips; one launch of S per level, of
        A per level and one of B for the whole batch."""
        p = self.params
        B = images.shape[0]
        pyr = self.pyramid_flat(images)
        pts = [self.cell_keypoints(
            fast_nms(lv, g, self.border, float(p.ini_fast_thr), float(p.min_fast_thr)), g)
            for lv, g in zip(self.level_views(pyr), self.levels)]
        px, py, valid, resp = (torch.cat(c, dim=-1) for c in zip(*pts))  # [B, N]
        base, hh, ww = self._slots(B)
        out = (orb_describe_strips if strips else orb_describe)(
            pyr.reshape(-1), base, hh, ww, px.reshape(-1).to(torch.int32),
            py.reshape(-1).to(torch.int32), valid.reshape(-1).contiguous(), self._tables)
        N = self.num_slots
        angle, desc = out[0].view(B, N), out[1].view(B, N, 8)
        xy = torch.stack([px.to(torch.float32) * self._slot_scale,
                          py.to(torch.float32) * self._slot_scale], dim=-1)
        feats = [FrameFeatures(xy=xy[b], response=resp[b], angle=angle[b],
                               level=self._slot_level, valid=valid[b], desc=desc[b])
                 for b in range(B)]
        return feats, (out[2].view(B, N, STRIP_H, STRIP_W) if strips else None)

    def extract(self, image: torch.Tensor, mask=None) -> FrameFeatures:
        """image: [H,W] grayscale tensor (u8 or f32, 0..255) on the
        extractor's device."""
        if mask is not None:
            raise NotImplementedError(
                "extraction masks are not ported yet (ROADMAP Queue 1 item 14b)")
        return self._extract_batch(image[None], False)[0][0]

    def extract_pair_with_patches(self, image_left: torch.Tensor, image_right: torch.Tensor):
        """Both images of a stereo pair through one launch of each kernel;
        returns ((feats_l, strips_l), (feats_r, strips_r))."""
        feats, strips = self._extract_batch(torch.stack([image_left, image_right]), True)
        return (feats[0], strips[0]), (feats[1], strips[1])
