"""ORB feature extraction on the card: kernels A (FAST + NMS) and B (describe).

Port of stella_vslam_tpu/feature/orb_extractor.py. The pyramid, slot layout
and every table (resize matrices, blur taps, moment masks, steered BRIEF
offsets) are built by the same numpy code as the JAX version, so slot k of
a frame means the same cell of the same level on both sides:

* pyramid, kernel S (K3), `resize_pyramid`: bilinear INTER_LINEAR resize
  level to level, the JAX version's `R @ img @ C^T`; on the card one launch
  builds every level of a batch of images, tile by tile of the coarsest
  level (`pyramid_plan`), each output pixel formed from the two non-zero
  entries of its rows of R and C with a product and one fused multiply-add
  per pass (`resize_level_taps_plain`; torch's CPU matmul rounds otherwise
  in ~1 pixel in 10^4, cuBLAS in ~1 in 16). Plain version: level 0 copied
  and the two `torch.matmul` a level. The levels of all images of a batch
  live in one flat buffer [B, sum of H*W] that kernels A and B read;
* kernel A, `fast_nms_pyramid`: one launch for every level of a batch of
  pyramids; per NMS cell, the exact FAST-9/16 score of every pixel above
  `min_fast_thr` and the cell's best packed key (iscore<<12 | row<<6 |
  col), with the two-threshold retry (`ini_fast_thr`, then
  `min_fast_thr`), written with its slot's (px, py, valid, response); with
  an extraction mask, only the pixels whose level-0 mask pixel (the JAX
  version's nearest resize) is set (`fast_nms` runs one level through the
  same kernel);
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

import ctypes

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import _fma_f32
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
# kernel S: the pyramid, one launch for a batch of images
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


def resize_level_taps_plain(img: torch.Tensor, step: ResizeLevel) -> torch.Tensor:
    """[h_in, w_in] -> [h_out, w_out] with kernel S's arithmetic: the row
    pass at each source column fma(rw1, b, rw0 a) (one rounding for the
    product, one for the fused add), then the column pass from those two
    values the same way (camera.base._fma_f32 in float64)."""
    dev = img.device
    rj, cj = step.row_j.to(dev).long(), step.col_j.to(dev).long()
    rw, cw = step.row_w.to(dev), step.col_w.to(dev)
    t = _fma_f32(rw[:, 1:2], img[rj[:, 1]], rw[:, 0:1] * img[rj[:, 0]])  # [h_out, w_in]
    return _fma_f32(cw[None, :, 1], t[:, cj[:, 1]], cw[None, :, 0] * t[:, cj[:, 0]])


TILES = (8, 12, 16, 24)  # kernel S's tiles: coarsest-level pixels a side
BLOCK_ROWS = (4, 8, 16, 32)  # kernel S's blocks: 32 x BLOCK_ROWS threads
SMS = 132  # an H100 SXM's multiprocessors (plan_cost; the card's own count on the card)
MAX_LEVELS_S = 16  # kMaxLevels in csrc/resize.cu
MAX_SMEM_S = 227 * 1024  # an H100 block's shared memory, static and dynamic
# kernel S's static shared arrays (csrc/resize.cu): per level the level
# table (5 ints) and the row and column plans (4 each), and the tap offsets
STATIC_SMEM_S = 4 * (MAX_LEVELS_S * (5 + 2 * 4) + 2 * (MAX_LEVELS_S + 1))


class PyramidPlan(NamedTuple):
    """Kernel S's plan of one pyramid layout (pyramid_plan): per tile of the
    coarsest level and per level, on each axis apart, the owned interval
    (the owned intervals partition the level's rows, or columns) and the
    computed interval (it holds the owned one and both taps of every row,
    or column, of the computed interval one level up); a tile's rectangle
    is its row interval times its column interval."""

    levels: tuple  # _LevelGeom per level
    level_off: tuple  # each level's offset in a flat pyramid row
    size: int  # floats of one pyramid
    steps: tuple  # ResizeLevel per level 1..L-1
    tile: int
    block_rows: int  # the block's rows of 32 threads
    rows: np.ndarray  # [nty, L, 4] int32 owned lo, hi, computed lo, hi
    cols: np.ndarray  # [ntx, L, 4] int32
    odd_at: int  # floats of the even levels' buffer, where the odd levels' starts
    buf_words: int  # floats of both buffers (even)
    row_taps: int  # the most row taps of levels 1..L-1 a tile computes
    col_taps: int  # ... column taps
    smem_bytes: int  # shared memory a block takes: the buffers and 16 bytes a tap
    computed: int  # pixels of levels 1..L-1 the blocks of one image compute
    level_tab: torch.Tensor  # [L, 5] int32 H, W, offset, first row tap, first column tap
    row_plan: torch.Tensor  # rows on the device
    col_plan: torch.Tensor
    # [sum H_1.., 2] i32, the taps of levels 1..L-1 concatenated (None at L = 1)
    row_j: Optional[torch.Tensor]
    row_w: Optional[torch.Tensor]
    col_j: Optional[torch.Tensor]
    col_w: Optional[torch.Tensor]


def axis_plan(sizes, taps, tile: int) -> np.ndarray:
    """One axis of kernel S's plan: sizes [L] (the levels' heights, or
    widths), taps[l - 1] [sizes[l], 2] the source indices at level l - 1 of
    level l's rows (or columns) -> [nt, L, 4] int32 (owned lo, hi, computed
    lo, hi per tile and level) for tiles of `tile` on the coarsest level."""
    L = len(sizes)
    cuts = list(range(0, sizes[-1], tile)) + [sizes[-1]]
    plan = np.zeros((len(cuts) - 1, L, 4), np.int64)
    for t in range(len(cuts) - 1):
        plan[t, L - 1] = (cuts[t], cuts[t + 1], cuts[t], cuts[t + 1])
    for l in range(L - 1, 0, -1):
        j = np.asarray(taps[l - 1], np.int64)
        cuts = [0] + [int(j[c, 0]) for c in cuts[1:-1]] + [sizes[l - 1]]
        for t in range(len(cuts) - 1):
            lo, hi = plan[t, l, 2:]
            plan[t, l - 1] = (cuts[t], cuts[t + 1], min(cuts[t], j[lo:hi].min()),
                              max(cuts[t + 1], j[lo:hi].max() + 1))
    return plan.astype(np.int32)


def _tile_layout(levels, rtaps, ctaps, tile: int):
    """(rows, cols, odd_at, buf_words, row_taps, col_taps, smem bytes) of
    kernel S's tiles of `tile` coarsest-level pixels a side."""
    L = len(levels)
    rows = axis_plan([g.H for g in levels], rtaps, tile)
    cols = axis_plan([g.W for g in levels], ctaps, tile)
    area = [int((rows[:, l, 3] - rows[:, l, 2]).max() * (cols[:, l, 3] - cols[:, l, 2]).max())
            for l in range(L)]
    odd_at = max(area[0::2])
    buf_words = odd_at + max(area[1::2] + [1])
    buf_words += buf_words % 2
    row_taps = int((rows[:, 1:, 3] - rows[:, 1:, 2]).sum(axis=1).max()) if L > 1 else 0
    col_taps = int((cols[:, 1:, 3] - cols[:, 1:, 2]).sum(axis=1).max()) if L > 1 else 0
    return (rows, cols, odd_at, buf_words, row_taps, col_taps,
            4 * buf_words + 16 * (row_taps + col_taps))


def plan_cost(blocks: int, pixels: int, threads: int, smem_bytes: int, levels: int,
              sms: int = SMS) -> float:
    """Kernel S's time in arbitrary units, the model its plan is chosen by:
    waves of blocks (a block of up to 1024 threads at 64 registers each
    fills an SM's register file) times a block's work, the pixels a
    thread stages or computes plus 3.4 per level's barrier. Fitted to
    device times of 16 tiles and block sizes at five shapes on an H100
    (scripts/torch_pyramid_fuse_probe.py --variants; PERF.md); it
    picks the fastest plan measured for one 752x480 frame, a pair and a
    640x320 frame."""
    per_sm = max(1, min(1024 // threads,
                        MAX_SMEM_S // (smem_bytes + STATIC_SMEM_S + 1024)))
    waves = math.ceil(blocks / (sms * per_sm))
    return waves * (pixels / blocks / threads + 3.4 * levels)


def pyramid_plan(levels, level_off, steps, device, batch: int = 1,
                 tile: Optional[int] = None, block_rows: Optional[int] = None) -> PyramidPlan:
    """Kernel S's plan for `levels` laid out at level_off in a flat pyramid
    row, with the level steps' taps (ResizeLevel per level 1..L-1), for
    launches of `batch` images. The tile and the block's rows (32 threads
    each) are `tile` and `block_rows`, or the pair of TILES x BLOCK_ROWS
    that plan_cost ranks first among those whose shared memory (with the
    kernel's static arrays) fits MAX_SMEM_S (smaller tiles, down to 1,
    where none does); a layout that no tile fits is refused (ValueError)."""
    L = len(levels)
    shape = f"{levels[0].W}x{levels[0].H}, {L} levels"
    if L > MAX_LEVELS_S:
        raise ValueError(f"kernel S: at most {MAX_LEVELS_S} levels ({shape})")
    rtaps = [st.row_j.cpu().numpy() for st in steps]
    ctaps = [st.col_j.cpu().numpy() for st in steps]
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" \
        else SMS
    best = None
    # the smaller tiles only where none of TILES fits (scale factors from
    # ~1.5 up, whose coarsest pixel spans many of level 0)
    for tiles in ([tile],) if tile else (TILES, (4, 2, 1)):
        for t in tiles:
            lay = _tile_layout(levels, rtaps, ctaps, t)
            rows, cols, smem = lay[0], lay[1], lay[-1]
            if smem + STATIC_SMEM_S > MAX_SMEM_S:
                continue
            blocks = batch * rows.shape[0] * cols.shape[0]
            pixels = batch * sum(int((rows[:, l, 3] - rows[:, l, 2]).sum()
                                     * (cols[:, l, 3] - cols[:, l, 2]).sum()) for l in range(L))
            for r in ([block_rows] if block_rows else BLOCK_ROWS):
                cost = plan_cost(blocks, pixels, 32 * r, smem, L, sms)
                if best is None or cost < best[0]:
                    best = (cost, t, r, lay)
        if best is not None:
            break
    if best is None:
        raise ValueError(f"kernel S: no tile of the coarsest level fits {MAX_SMEM_S} bytes "
                         f"of shared memory ({shape})")
    _, t, block_rows, (rows, cols, odd_at, buf_words, row_taps, col_taps, smem_bytes) = best
    computed = sum(int((rows[:, l, 3] - rows[:, l, 2]).sum() * (cols[:, l, 3] - cols[:, l, 2]).sum())
                   for l in range(1, L))
    tab = np.zeros((L, 5), np.int32)
    nr = nc = 0
    for l, (g, off) in enumerate(zip(levels, level_off)):
        tab[l, :3] = (g.H, g.W, off)
        if l:
            tab[l, 3:] = (nr, nc)
            nr, nc = nr + g.H, nc + g.W
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)
    cat = lambda ts: torch.cat(ts).to(device).contiguous() if ts else None
    return PyramidPlan(
        levels=tuple(levels), level_off=tuple(level_off),
        size=int(level_off[-1] + levels[-1].H * levels[-1].W), steps=tuple(steps), tile=t,
        block_rows=int(block_rows), rows=rows, cols=cols, odd_at=odd_at, buf_words=buf_words,
        row_taps=row_taps, col_taps=col_taps, smem_bytes=smem_bytes, computed=computed,
        level_tab=i32(tab), row_plan=i32(rows), col_plan=i32(cols),
        row_j=cat([st.row_j for st in steps]), row_w=cat([st.row_w for st in steps]),
        col_j=cat([st.col_j for st in steps]), col_w=cat([st.col_w for st in steps]))


def resize_pyramid(images: torch.Tensor, plan: PyramidPlan) -> torch.Tensor:
    """[B, H0, W0] grayscale images (u8 or f32) -> their flat f32 pyramids
    [B, plan.size]: kernel S, one launch for every level of every image, on
    CUDA images; on CPU images the plain version, level 0 copied and the
    two matmuls a level (resize_level_plain)."""
    B = images.shape[0]
    g0 = plan.levels[0]
    pyr = torch.empty((B, plan.size), dtype=torch.float32, device=images.device)
    if not images.is_cuda:
        pyr[:, :g0.H * g0.W] = images.reshape(B, -1)
        for l in range(1, len(plan.levels)):
            g_in, g = plan.levels[l - 1], plan.levels[l]
            o_in, o = plan.level_off[l - 1], plan.level_off[l]
            step = plan.steps[l - 1]
            for b in range(B):
                src = pyr[b, o_in:o_in + g_in.H * g_in.W].view(g_in.H, g_in.W)
                pyr[b, o:o + g.H * g.W] = resize_level_plain(src, step.R, step.Ct).reshape(-1)
        return pyr
    if images.dtype not in (torch.uint8, torch.float32) or images.dim() != 3 \
            or tuple(images.shape[1:]) != (g0.H, g0.W):
        raise ValueError(f"resize_pyramid: expects u8 or f32 images [B, {g0.H}, {g0.W}]")
    if plan.level_tab.device != images.device:
        raise ValueError("resize_pyramid: a plan from pyramid_plan on the images' device")
    if images.stride(2) != 1 or images.stride(1) != g0.W:
        images = images.contiguous()
    lib = kbuild.load()
    kbuild.check(lib.svt_resize_pyramid(
        B, len(plan.levels), int(images.dtype == torch.uint8), images.data_ptr(),
        images.stride(0), pyr.data_ptr(), plan.size, plan.level_tab.data_ptr(),
        plan.row_plan.data_ptr(), plan.rows.shape[0], plan.col_plan.data_ptr(),
        plan.cols.shape[0], plan.row_j.data_ptr() if plan.steps else None,
        plan.row_w.data_ptr() if plan.steps else None,
        plan.col_j.data_ptr() if plan.steps else None,
        plan.col_w.data_ptr() if plan.steps else None, plan.odd_at, plan.buf_words,
        plan.row_taps, plan.col_taps, plan.block_rows, kbuild.stream_ptr(images.device)), "resize_pyramid")
    resize_pyramid.launches += 1
    return pyr


resize_pyramid.launches = 0


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


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """jax.image.resize's "nearest" source index of each of n_out outputs
    from n_in inputs, the identity where the sizes are equal. JAX writes
    floor((i + 0.5) * n_in / n_out) in float32; its compiler folds the
    constants into one factor, f32(n_in * f32(1 / n_out)), which decides
    the ties ((i + 0.5) * n_in / n_out an integer), so this is computed so
    too."""
    if n_in == n_out:
        return np.arange(n_out, dtype=np.int32)
    f32 = np.float32
    i = np.arange(n_out, dtype=f32)
    k = f32(f32(n_in) * (f32(1.0) / f32(n_out)))
    return np.floor((i + f32(0.5)) * k).astype(np.int32)


class LevelMask(NamedTuple):
    """An extraction mask as kernel A reads it at one level: the level-0
    mask (uint8, 0 = excluded) and the level's nearest source row of each
    of its rows and column of each of its columns, tables built by
    nearest_index for a level-0 mask of src_hw (H0, W0)."""

    mask: torch.Tensor  # [H0, W0] uint8
    rows: torch.Tensor  # [H] int32
    cols: torch.Tensor  # [W] int32
    src_hw: tuple


def fast_nms_plain(img: torch.Tensor, g: _LevelGeom, border: int,
                   ini_thr: float, min_thr: float,
                   mask: Optional[LevelMask] = None) -> torch.Tensor:
    """[Gy*Gx] int32 best packed key per NMS cell, -1 where none; with a
    mask, only the pixels whose nearest level-0 mask pixel is set."""
    b = border
    score = fast_score_map(img)
    dev = img.device
    ys = torch.arange(g.H, device=dev, dtype=torch.int32)[:, None]
    xs = torch.arange(g.W, device=dev, dtype=torch.int32)[None, :]
    region = (xs >= b) & (xs < g.W - b) & (ys >= b) & (ys < g.H - b)
    if mask is not None:
        region = region & (mask.mask[mask.rows.long()[:, None], mask.cols.long()[None, :]] != 0)
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


def cell_keypoints(best: torch.Tensor, g: _LevelGeom, border: int):
    """A level's per-cell keys [..., Gy*Gx] -> (px, py, valid, response) of
    its slots; px/py are clamped into the level, as in JAX."""
    cell = torch.arange(g.Gy * g.Gx, device=best.device, dtype=torch.int32)
    py = torch.clamp(border + (cell // g.Gx) * g.cs + ((best >> 6) & 63), 0, g.H - 1)
    px = torch.clamp(border + (cell % g.Gx) * g.cs + (best & 63), 0, g.W - 1)
    ok = best >= 0
    resp = torch.where(ok, (best >> 12).to(torch.float32), torch.zeros((), device=best.device))
    return px, py, ok, resp


def fast_arc_corner(img: torch.Tensor, t: float) -> torch.Tensor:
    """Kernel A's early reject in plain form, [H,W] -> [H,W] bool: two
    neighbouring compass points (ring 0, 4, 8, 12) brighter than centre + t
    (or darker than centre - t), then a circular run of 9 set bits in the
    16-bit mask of ring pixels brighter than centre + t (or of those darker
    than centre - t), folded from shifted ANDs. It holds exactly where
    fast_score_map(img) > t (zero padding outside, as there)."""
    H, W = img.shape
    pad = 3
    padded = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    d = torch.stack([padded[pad + dy:pad + dy + H, pad + dx:pad + dx + W] - img
                     for dx, dy in _FAST_OFFSETS.tolist()])  # [16,H,W]
    bit = (1 << torch.arange(16, device=img.device))[:, None, None]

    def run9(m):
        m2 = m | (m << 16)
        r = m2 & (m2 >> 1)
        r = r & (r >> 2)
        r = r & (r >> 4)
        return (r & (m2 >> 8) & 0xFFFF) != 0

    def compass(m):
        q = (m & 1) | ((m >> 3) & 2) | ((m >> 6) & 4) | ((m >> 9) & 8)
        return (q & ((q >> 1) | (q << 3)) & 15) != 0

    out = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    for m in (((d > t) * bit).sum(0), ((d < -t) * bit).sum(0)):
        out |= compass(m) & run9(m)
    return out


MAX_CELLS = 32  # NMS cells of a work item of kernel A (kMaxCells in csrc/fast_nms.cu)
LEVEL_INTS = 8  # a row of kernel A's level table (kLevelInts)
WORK_CELLS0 = 2  # level-0 cells' pixels a work item of kernel A holds, about
MAX_SMEM_WORDS = 12 * 1024  # a work item's tile and pixel list: 48 KB


def _work_words(cs: int, n: int) -> int:
    """Kernel A's shared-memory words for n cells of size cs: the tile with
    its 3-px halo and the list of candidate pixels."""
    return (cs + 6) * (n * cs + 6) + n * cs * cs


def fast_work_list(levels, border: int) -> np.ndarray:
    """Kernel A's work items over a pyramid's levels, [n, 4] int32 (level,
    cell row, first cell column, cells): runs of cells of one cell row,
    each holding about as many pixels as WORK_CELLS0 level-0 cells (the
    nearest whole number of cells, at least one, at most MAX_CELLS, and
    fewer where the item would pass MAX_SMEM_WORDS), level 0 first."""
    target = WORK_CELLS0 * levels[0].cs * levels[0].cs
    items = []
    for lvl, g in enumerate(levels):
        cc = g.cs * g.cs
        per = max(1, min(MAX_CELLS, (2 * target + cc) // (2 * cc)))
        while per > 1 and _work_words(g.cs, per) > MAX_SMEM_WORDS:
            per -= 1
        for cy in range(g.Gy):
            for cx in range(0, g.Gx, per):
                items.append((lvl, cy, cx, min(per, g.Gx - cx)))
    return np.asarray(items, np.int32)


class FastPyramid(NamedTuple):
    """Kernel A's tables of one pyramid layout, built once per extractor:
    each level's geometry and place in the flat pyramid and in the slots,
    the work list, and the per-level nearest-index tables of a level-0
    extraction mask of src_hw (H0, W0), concatenated over the levels."""

    levels: tuple  # _LevelGeom per level
    border: int
    level_off: tuple  # each level's offset in a flat pyramid row
    slot_off: tuple  # each level's first slot
    num_slots: int
    src_hw: tuple
    level_tab: torch.Tensor  # [L, 8] int32 (H, W, cs, Gx, level_off, slot_off, row, col)
    work: torch.Tensor  # [n, 4] int32 (fast_work_list)
    mask_rows: torch.Tensor  # [sum H] int32
    mask_cols: torch.Tensor  # [sum W] int32
    smem_words: int  # the largest work item's tile and pixel list in shared memory


def _level_tab(levels, level_off):
    """Each level's row of FastPyramid.level_tab, its first slot, and the
    slot count."""
    slot_off, tab = [], []
    ns = nr = nc = 0
    for g, off in zip(levels, level_off):
        tab.append((g.H, g.W, g.cs, g.Gx, off, ns, nr, nc))
        slot_off.append(ns)
        ns, nr, nc = ns + g.Gy * g.Gx, nr + g.H, nc + g.W
    return np.asarray(tab, np.int32).reshape(len(levels), LEVEL_INTS), slot_off, ns


def fast_pyramid_tables(levels, border: int, level_off, src_hw, device) -> FastPyramid:
    """FastPyramid of `levels` laid out at level_off in a flat pyramid row,
    for a level-0 mask of src_hw (H0, W0)."""
    H0, W0 = src_hw
    tab, slot_off, ns = _level_tab(levels, level_off)
    work = fast_work_list(levels, border)
    smem = max(_work_words(levels[l].cs, n) for l, n in {(int(l), int(n))
                                                          for l, _, _, n in work})
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)
    return FastPyramid(
        levels=tuple(levels), border=border, level_off=tuple(level_off),
        slot_off=tuple(slot_off), num_slots=ns, src_hw=(H0, W0),
        level_tab=i32(tab), work=i32(work),
        mask_rows=i32(np.concatenate([nearest_index(H0, g.H) for g in levels])),
        mask_cols=i32(np.concatenate([nearest_index(W0, g.W) for g in levels])),
        smem_words=smem)


class SlotLayout(NamedTuple):
    """Where an extractor's slots lie (kernel T's band walk reads it): slot
    k of level l, cell (cy, cx) = divmod(k - slot_off[l], Gx[l]), holds a
    keypoint at the level pixel (border + cx cs + dx, border + cy cs + dy),
    0 <= dx, dy < cs, clamped into the level, times level_scale[l] in
    float32 (`cell_keypoints`, `OrbExtractor._extract_batch`)."""

    levels: tuple  # _LevelGeom each, in slot order
    border: int
    level_tab: torch.Tensor  # [L, 8] int32, FastPyramid.level_tab's columns
    level_scale: torch.Tensor  # [L] f32
    num_slots: int


def slot_layout(levels, border: int, device) -> SlotLayout:
    """The SlotLayout of `levels` (_LevelGeom each)."""
    tab, _, ns = _level_tab(levels, [0] * len(levels))
    scale = torch.tensor([g.scale for g in levels], dtype=torch.float32, device=device)
    return SlotLayout(tuple(levels), border, torch.as_tensor(tab, device=device), scale, ns)


def _level_mask(fp: FastPyramid, mask: torch.Tensor, lvl: int) -> LevelMask:
    g, r0, c0 = fp.levels[lvl], sum(h.H for h in fp.levels[:lvl]), \
        sum(h.W for h in fp.levels[:lvl])
    return LevelMask(mask, fp.mask_rows[r0:r0 + g.H], fp.mask_cols[c0:c0 + g.W], fp.src_hw)


def fast_nms_pyramid_plain(pyr: torch.Tensor, fp: FastPyramid, ini_thr: float, min_thr: float,
                           mask: Optional[torch.Tensor] = None):
    """The plain version of fast_nms_pyramid: per image and level
    fast_nms_plain, then cell_keypoints, the levels concatenated."""
    keys = []
    for lvl, (g, off) in enumerate(zip(fp.levels, fp.level_off)):
        m = _level_mask(fp, mask, lvl) if mask is not None else None
        keys.append(torch.stack([
            fast_nms_plain(row[off:off + g.H * g.W].view(g.H, g.W), g, fp.border, ini_thr,
                           min_thr, m) for row in pyr]))
    pts = [cell_keypoints(k, g, fp.border) for k, g in zip(keys, fp.levels)]
    px, py, valid, resp = (torch.cat(c, dim=-1) for c in zip(*pts))
    return torch.cat(keys, dim=-1), px, py, valid, resp


def _check_mask(mask, H0, W0, dev):
    if mask.dtype != torch.uint8 or tuple(mask.shape) != (H0, W0) \
            or not mask.is_contiguous() or mask.device != dev:
        raise ValueError(f"kernel A: the mask must be a contiguous uint8 [{H0}, {W0}] "
                         "on the pyramid's device")


def _fast_launch(pyr, stride, B, fp: FastPyramid, ini_thr, min_thr, mask):
    """One launch of kernel A over B pyramids `stride` floats apart from
    pyr's first element -> (key, px, py, valid, response), each [B, N]."""
    dev = pyr.device
    N = fp.num_slots
    key = torch.empty((B, N), dtype=torch.int32, device=dev)
    px, py = torch.empty_like(key), torch.empty_like(key)
    valid = torch.empty((B, N), dtype=torch.bool, device=dev)
    resp = torch.empty((B, N), dtype=torch.float32, device=dev)
    if fp.level_tab.device != dev:
        raise ValueError("kernel A: tables from fast_pyramid_tables on the pyramid's device")
    if mask is not None:
        _check_mask(mask, *fp.src_hw, dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_fast_pyramid(
        B, pyr.data_ptr(), stride, fp.level_tab.data_ptr(), fp.work.data_ptr(),
        fp.work.shape[0], fp.smem_words, fp.border, N, float(ini_thr), float(min_thr),
        mask.data_ptr() if mask is not None else None,
        mask.shape[1] if mask is not None else 0, fp.mask_rows.data_ptr(),
        fp.mask_cols.data_ptr(), key.data_ptr(), px.data_ptr(), py.data_ptr(),
        valid.data_ptr(), resp.data_ptr(), kbuild.stream_ptr(dev)), "fast_nms")
    return key, px, py, valid, resp


def fast_nms_pyramid(pyr: torch.Tensor, fp: FastPyramid, ini_thr: float, min_thr: float,
                     mask: Optional[torch.Tensor] = None):
    """Kernel A on a CUDA pyramid, one launch for every level of every image;
    the plain version on a CPU one. pyr: flat pyramids [B, P] (fp's
    layout); mask: None or a level-0 extraction mask [H0, W0] uint8 (0 =
    excluded) that every image shares. Returns (key, px, py, valid,
    response), each [B, N] in the extractor's slot layout (int32, int32,
    int32, bool, f32)."""
    if not pyr.is_cuda:
        return fast_nms_pyramid_plain(pyr, fp, ini_thr, min_thr, mask)
    if pyr.dtype != torch.float32 or pyr.dim() != 2 or not pyr.is_contiguous() \
            or pyr.shape[1] < fp.level_off[-1] + fp.levels[-1].H * fp.levels[-1].W:
        raise ValueError("fast_nms_pyramid: expects a contiguous f32 [B, P] pyramid")
    out = _fast_launch(pyr, pyr.shape[1], pyr.shape[0], fp, ini_thr, min_thr, mask)
    fast_nms_pyramid.launches += 1
    if mask is not None:
        fast_nms_pyramid.masked_launches += 1
    return out


fast_nms_pyramid.launches = 0
# the launches with an extraction mask (counted in `launches` too)
fast_nms_pyramid.masked_launches = 0


def fast_nms(img: torch.Tensor, g: _LevelGeom, border: int,
             ini_thr: float, min_thr: float,
             mask: Optional[LevelMask] = None) -> torch.Tensor:
    """One level through kernel A (a one-level launch of the pyramid
    kernel) on a CUDA image, the plain version on a CPU image. `img`: one
    level [H,W] -> [Gy*Gx], or a batch [B,H,W] whose images are each
    contiguous (any batch stride) -> [B, Gy*Gx]. `mask`: an extraction
    mask that every image of the batch shares."""
    if not img.is_cuda:
        if img.dim() == 2:
            return fast_nms_plain(img, g, border, ini_thr, min_thr, mask)
        return torch.stack([fast_nms_plain(x, g, border, ini_thr, min_thr, mask)
                            for x in img])
    batch = img if img.dim() == 3 else img[None]
    if img.dtype != torch.float32 or tuple(batch.shape[1:]) != (g.H, g.W) \
            or batch.stride(1) != g.W or batch.stride(2) != 1:
        raise ValueError("fast_nms: expects f32 [H,W] level images, each contiguous")
    src_hw = (g.H, g.W)
    if mask is not None:
        if tuple(mask.rows.shape) != (g.H,) or tuple(mask.cols.shape) != (g.W,) \
                or tuple(mask.mask.shape) != tuple(mask.src_hw):
            raise ValueError("fast_nms: the mask must be a uint8 [H0,W0] with [H] and [W] "
                             "index tables into it")
        src_hw = tuple(mask.src_hw)
    fp = fast_pyramid_tables([g], border, [0], src_hw, img.device)
    if mask is not None:
        fp = fp._replace(mask_rows=mask.rows.to(torch.int32).contiguous(),
                         mask_cols=mask.cols.to(torch.int32).contiguous())
    out = _fast_launch(batch, batch.stride(0), batch.shape[0], fp, ini_thr, min_thr,
                       mask.mask if mask is not None else None)[0]
    fast_nms.launches += 1
    return out if img.dim() == 3 else out[0]


fast_nms.launches = 0


# ---------------------------------------------------------------------------
# kernel B: orientation + blur + steered BRIEF
# ---------------------------------------------------------------------------


MAX_BIN_PIXELS = 512  # distinct pixels of a bin's 256 pairs, at most


class DescribeTables(NamedTuple):
    taps: torch.Tensor  # [7,7] f32
    k10: torch.Tensor  # [31,31] f32
    k01: torch.Tensor  # [31,31] f32
    offsets: torch.Tensor  # [30,256,4] int8
    # each bin's distinct pixels (linear positions in the 39x39, ascending,
    # padded with 0), their count, and each pair's two places in that list:
    # kernel B blurs only those (bin_pixel_tables)
    pix: torch.Tensor  # [30,512] int16
    npix: torch.Tensor  # [30] int32
    pidx: torch.Tensor  # [30,256,2] int16
    taps_host: tuple = ()  # the 49 taps as Python floats (kernel B's launch parameter)


def bin_pixel_tables(offsets):
    """[30,256,4] (rx0, ry0, rx1, ry1) pair offsets -> (pix [30,512] int16,
    npix [30] int32, pidx [30,256,2] int16): per steering bin the distinct
    blurred-patch pixels its pairs read, ascending, and each pair's point 0
    and point 1 as places in that list."""
    off = np.asarray(offsets, np.int64)
    pix = np.zeros((ANGLE_BINS, MAX_BIN_PIXELS), np.int16)
    npix = np.zeros(ANGLE_BINS, np.int32)
    pidx = np.zeros((ANGLE_BINS, 256, 2), np.int16)
    for b in range(ANGLE_BINS):
        pts = np.concatenate([off[b, :, 1] * _DESC_W + off[b, :, 0],
                              off[b, :, 3] * _DESC_W + off[b, :, 2]])
        u, inv = np.unique(pts, return_inverse=True)
        pix[b, :u.size], npix[b] = u, u.size
        pidx[b, :, 0], pidx[b, :, 1] = inv[:256], inv[256:]
    return pix, npix, pidx


def describe_tables(taps, k10, k01, offsets, device) -> DescribeTables:
    """DescribeTables on `device` from numpy-convertible taps [7,7], moment
    masks [31,31] and pair offsets [30,256,4], with the bins' pixel tables."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    pix, npix, pidx = bin_pixel_tables(offsets)
    return DescribeTables(
        taps=f32(taps), k10=f32(k10), k01=f32(k01),
        offsets=torch.as_tensor(np.asarray(offsets, np.int8), device=device),
        pix=torch.as_tensor(pix, device=device), npix=torch.as_tensor(npix, device=device),
        pidx=torch.as_tensor(pidx, device=device),
        taps_host=tuple(float(x) for x in np.asarray(taps, np.float32).reshape(-1)))


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


def orb_describe_pixels_plain(pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid,
                              tab: DescribeTables, strips: bool = False):
    """orb_describe_plain with kernel B's structure: per keypoint, only its
    bin's distinct pixels (tab.pix) are blurred (and the strip's, with
    `strips`), each with the same 49 rounded products and sums; the pairs
    read them through tab.pidx. Returns what orb_describe_plain returns."""
    K = kp_x.shape[0]
    dev = pyr.device
    d = torch.arange(-_RAW_R, _RAW_R + 1, device=dev, dtype=torch.int64)
    H = kp_H.long()[:, None]
    W = kp_W.long()[:, None]
    rows = torch.minimum(torch.clamp(kp_y.long()[:, None] + d, min=0), H - 1)
    cols = torch.minimum(torch.clamp(kp_x.long()[:, None] + d, min=0), W - 1)
    idx = kp_base.long()[:, None, None] + rows[:, :, None] * W[:, :, None] \
        + cols[:, None, :]
    raw = pyr[idx].to(torch.bfloat16).to(torch.float32).reshape(K, -1)  # [K,45*45]
    circ = raw.reshape(K, _RAW_W, _RAW_W)[:, _MOM_OFF:_MOM_OFF + 31, _MOM_OFF:_MOM_OFF + 31]
    m10 = (circ * tab.k10).sum(dim=(1, 2))
    m01 = (circ * tab.k01).sum(dim=(1, 2))
    angle = torch.where(kp_valid, torch.atan2(m01, m10), torch.zeros_like(m10))
    bins = torch.remainder(torch.round(angle / _TAU).to(torch.int64), ANGLE_BINS)

    def blur(pos):  # [K,P] linear 39x39 positions -> [K,P] blurred values
        at = (pos // _DESC_W) * _RAW_W + pos % _DESC_W
        acc = torch.zeros(pos.shape, device=dev, dtype=torch.float32)
        for ty in range(7):
            for tx in range(7):
                acc = acc + tab.taps[ty, tx] * raw.gather(1, at + ty * _RAW_W + tx)
        return torch.round(acc)

    vals = blur(tab.pix.long()[bins])  # [K,512]
    pidx = tab.pidx.long()[bins]  # [K,256,2]
    i0, i1 = vals.gather(1, pidx[..., 0]), vals.gather(1, pidx[..., 1])
    if not strips:
        return angle, _pack_bits(i1 > i0)
    sy = torch.arange(_STRIP_Y, _STRIP_Y + STRIP_H, device=dev)
    sx = torch.arange(_STRIP_X, _STRIP_X + STRIP_W, device=dev)
    spos = (sy[:, None] * _DESC_W + sx[None]).reshape(1, -1).expand(K, -1)
    strip = blur(spos).reshape(K, STRIP_H, STRIP_W).to(torch.uint8)
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
    if len(tab.taps_host) != 49 or tab.pix.device != pyr.device:
        raise ValueError("orb_describe: tables from describe_tables on the pyramid's device")
    lib = kbuild.load()
    taps = (ctypes.c_float * 49)(*tab.taps_host)
    angle = torch.empty(K, dtype=torch.float32, device=pyr.device)
    desc = torch.empty((K, 8), dtype=torch.int32, device=pyr.device)
    strip = torch.empty((K, STRIP_H, STRIP_W), dtype=torch.uint8, device=pyr.device) \
        if strips else None
    kbuild.check(lib.svt_orb_describe(
        pyr.data_ptr(), kp_base.data_ptr(), kp_H.data_ptr(), kp_W.data_ptr(),
        kp_x.data_ptr(), kp_y.data_ptr(), kp_valid.data_ptr(), K,
        ctypes.addressof(taps), tab.k10.data_ptr(), tab.k01.data_ptr(),
        tab.pix.data_ptr(), tab.npix.data_ptr(), tab.pidx.data_ptr(), _TAU, angle.data_ptr(),
        desc.data_ptr(),
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
        self._tables = describe_tables(tables["taps"], tables["k10"], tables["k01"],
                                       tables["offsets"], dev)
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
        self._fast = fast_pyramid_tables(self.levels, self.border, self._level_off,
                                         (self.height, self.width), dev)
        # kernel S's plan per batch size (one image; a stereo pair)
        self._pyramids = {1: pyramid_plan(self.levels, self._level_off, self._resize, dev)}
        self.slot_layout = slot_layout(self.levels, self.border, dev)
        # level scale per slot, rounded to f32 as `px * g.scale` rounds it
        self._slot_scale = torch.cat(
            [torch.full((g.Gy * g.Gx,), g.scale, dtype=torch.float32)
             for g in self.levels]).to(dev)

    def pyramid_flat(self, images: torch.Tensor) -> torch.Tensor:
        """[B,H,W] grayscale (u8 or f32) on the extractor's device -> the f32
        levels of each image, one flat row [B, pyramid_size] each (kernel S
        on the card, one launch; the two matmuls a level on the CPU)."""
        return resize_pyramid(images, self.pyramid_plan_for(images.shape[0]))

    def pyramid_plan_for(self, batch: int) -> PyramidPlan:
        """Kernel S's plan for launches of `batch` images (built once)."""
        if batch not in self._pyramids:
            self._pyramids[batch] = pyramid_plan(self.levels, self._level_off, self._resize,
                                                 self.device, batch=batch)
        return self._pyramids[batch]

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

    def pyramid_taps_plain(self, image: torch.Tensor) -> list:
        """Kernel S's arithmetic in plain form: resize_level_taps_plain level
        by level on the image's device (the level images, f32)."""
        img = image.to(torch.float32)
        out = [img]
        for step in self._resize:
            img = resize_level_taps_plain(img, step)
            out.append(img)
        return out

    def _slots(self, B: int):
        """Per-slot (base offset, H, W) of a batch of B pyramids."""
        if B not in self._batch_slots:
            shift = (torch.arange(B, dtype=torch.int32, device=self.device)
                     * self.pyramid_size)[:, None]
            self._batch_slots[B] = ((self._slot_base[None] + shift).reshape(-1).contiguous(),
                                    self._slot_H.repeat(B), self._slot_W.repeat(B))
        return self._batch_slots[B]

    def _extract_batch(self, images: torch.Tensor, strips: bool, mask=None):
        """[B,H,W] -> a list of B FrameFeatures and, with `strips`, the
        [B, N, 11, 21] uint8 blurred strips; one launch each of S, A and B
        for the whole batch. `mask`: a level-0 extraction
        mask [H,W] uint8 the batch shares."""
        p = self.params
        B = images.shape[0]
        pyr = self.pyramid_flat(images)
        if mask is not None:
            mask = mask.contiguous()
            _check_mask(mask, self.height, self.width, pyr.device)
        _, px, py, valid, resp = fast_nms_pyramid(
            pyr, self._fast, float(p.ini_fast_thr), float(p.min_fast_thr), mask)  # [B, N]
        base, hh, ww = self._slots(B)
        out = (orb_describe_strips if strips else orb_describe)(
            pyr.reshape(-1), base, hh, ww, px.reshape(-1), py.reshape(-1), valid.reshape(-1),
            self._tables)
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
        extractor's device. mask: None, or [H,W] uint8 on that device,
        0 = excluded (the JAX version's `mask != 0`)."""
        return self._extract_batch(image[None], False, mask)[0][0]

    def extract_pair_with_patches(self, image_left: torch.Tensor, image_right: torch.Tensor):
        """Both images of a stereo pair through one launch of each kernel;
        returns ((feats_l, strips_l), (feats_r, strips_r))."""
        feats, strips = self._extract_batch(torch.stack([image_left, image_right]), True)
        return (feats[0], strips[0]), (feats[1], strips[1])
