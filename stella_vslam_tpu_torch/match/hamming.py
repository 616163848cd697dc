"""256-bit Hamming matching core: kernels C (`hamming_top2`) and J
(`epipolar_top2`) and helpers.

Port of stella_vslam_tpu/match/hamming.py. The JAX version forms the whole
[M,N] distance matrix as a +/-1 int8 matmul and reduces it after masking;
the matchers here call `hamming_top2`, which returns per query row the best
and second-best distance and their target indices over the gated targets:

* on CUDA tensors, kernel C (csrc/hamming_top2.cu): XOR + popcount with the
  gates evaluated in registers, the [M,N] matrix never stored; the gates
  are a projection window, an orientation cosine (tracking) or an angle
  difference (the initializer's area matcher). With a window, the call
  first sorts the targets into grid cells over the window's image extent
  (`build_cell_index`, the same source's index kernel) and a row visits
  only the targets of the cells its window meets; without one, blocks of
  rows share tiles of targets;
* on CPU tensors, `hamming_top2_plain`: the JAX version's dense form (a
  +/-1 f32 matmul — exact, every sum is an integer of magnitude <= 256);
  with `walk=True`, restricted to the pairs of kernel C's cell walk (the
  cover is conservative, so the result is the dense one).

Kernel J (the same source) is the mapping module's matcher: the gates of
match_for_triangulation (orientation cosine, near-epipole rejection, the
epipolar residual) for one query row against each of B neighbour
keyframes. It first sorts each neighbour's targets by the angle of their
epipolar plane about the epipole (the band index), and a row visits only
the targets whose plane can pass its residual gate
(`epipolar_band_plain` is that walk in plain form).

Masked entries count as distance 257 and ties break to the lowest target
index, as jnp.argmin breaks them. Ratio tests, orientation checks and
duplicate resolution stay plain torch on the [M] outputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild

HAMMING_DIST_THR_LOW = 50
HAMMING_DIST_THR_HIGH = 100
MAX_HAMMING_DIST = 256
_MASKED = MAX_HAMMING_DIST + 1


class WindowGate(NamedTuple):
    """Projection gates: |du|,|dv| <= rad, lo <= level <= hi, and
    |xr_row - xr_col| <= rad when both x_right are > 0. `extent` is the
    (width, height) of the image the coordinates lie in: it sizes the grid
    of kernel C's cell index (targets outside it go to the border cells), not
    the result."""

    row_u: torch.Tensor  # [M] f32
    row_v: torch.Tensor  # [M] f32
    row_xr: torch.Tensor  # [M] f32
    row_rad: torch.Tensor  # [M] f32
    row_lo: torch.Tensor  # [M] i32
    row_hi: torch.Tensor  # [M] i32
    col_u: torch.Tensor  # [N] f32
    col_v: torch.Tensor  # [N] f32
    col_xr: torch.Tensor  # [N] f32
    col_level: torch.Tensor  # [N] i32
    extent: Tuple[float, float]


_WINDOW_TENSORS = WindowGate._fields[:10]


class OrientGate(NamedTuple):
    """Orientation gate: row_c*col_c + row_s*col_s >= cos_thr."""

    row_c: torch.Tensor  # [M] f32
    row_s: torch.Tensor
    col_c: torch.Tensor  # [N] f32
    col_s: torch.Tensor
    cos_thr: float


class AngleGate(NamedTuple):
    """Orientation gate of the area matcher: |atan2(sin d, cos d)| <= thr
    with d = row_angle - col_angle (match/area.py:49-51)."""

    row_angle: torch.Tensor  # [M] f32 radians
    col_angle: torch.Tensor  # [N] f32
    thr: float  # radians


class EpipolarGate(NamedTuple):
    """The gates of match_for_triangulation (match/robust.py), per row and
    per target of each neighbour b, computed once: row i passes target j of
    neighbour b when row_c*col_c + row_s*col_s >= cos_thr, not
    (col_near[b,j] and not row_stereo[i]), and
    |clip(dot(col_epl[b,j], row_bear[i]) / col_norm[b,j], -1, 1)| < row_thr[i]."""

    row_c: torch.Tensor  # [N1] f32 cos of the angle
    row_s: torch.Tensor  # [N1] f32 sin
    row_bear: torch.Tensor  # [N1,3] f32 bearing
    row_thr: torch.Tensor  # [N1] f32 sin of the scaled residual threshold
    row_stereo: torch.Tensor  # [N1] bool
    col_c: torch.Tensor  # [B,N2] f32
    col_s: torch.Tensor  # [B,N2] f32
    col_epl: torch.Tensor  # [B,N2,3] f32 E_12 b2
    col_norm: torch.Tensor  # [B,N2] f32 max(|E_12 b2|, 1e-12)
    col_near: torch.Tensor  # [B,N2] bool near the epipole and not stereo
    E: torch.Tensor  # [B,3,3] f32 E_12 (kf1 <- kf2 in bearing space): col_epl = E b2
    cos_thr: float


class CellIndex(NamedTuple):
    """Targets sorted by the grid cell of their (u, v): cell (cx, cy) of a
    finite point is (floor(u * inv_cell), floor(v * inv_cell)) clamped to
    the gx x gy grid (the border cells take what lies outside it), cell id
    cy * gx + cx; a NaN coordinate goes to cell gx * gy, after every cell.
    order lists the targets by cell id (the plain version: ascending index
    within a cell; the kernel: in no fixed order within a cell); start[c]
    is cell c's first position in it, start[gx * gy + 1] = N."""

    start: torch.Tensor  # [gx * gy + 2] i32
    order: torch.Tensor  # [N] i32
    inv_cell: float  # 1 / cell size, a power of two
    gx: int
    gy: int


class LaunchCount:
    """The launches of one mode of kernel C, read and reset like a wrapper's
    count (`hamming_top2.launches` counts both modes). A caller that counts
    its own launches passes its count to `hamming_top2` as `counter`."""

    def __init__(self):
        self.launches = 0


window_walk = LaunchCount()  # window mode: the cell walk
brute_force = LaunchCount()  # no window: shared target tiles

MAX_CELLS = 1024  # kernel C's index holds a count per cell in shared memory


def cell_grid(width: float, height: float):
    """(inv_cell, gx, gy): power-of-two cells, at most 32 a side, over
    [0, width) x [0, height)."""
    size = 1.0
    while max(width, height) > 32 * size:
        size *= 2.0
    return 1.0 / size, max(1, math.ceil(width / size)), max(1, math.ceil(height / size))


def _cells_of(col_u, col_v, inv_cell, gx, gy):
    """Each target's cell id (gx * gy for a NaN coordinate)."""
    def axis(x, g):
        f = torch.floor(x * inv_cell)
        return torch.where(torch.isnan(f), 0.0, f).clamp(0, g - 1).to(torch.int64)

    nan = torch.isnan(col_u) | torch.isnan(col_v)
    return torch.where(nan, gx * gy, axis(col_v, gy) * gx + axis(col_u, gx))


def build_cell_index_plain(col_u, col_v, width: float, height: float) -> CellIndex:
    inv, gx, gy = cell_grid(width, height)
    cell = _cells_of(col_u, col_v, inv, gx, gy)
    counts = torch.bincount(cell, minlength=gx * gy + 1)
    start = torch.cat([torch.zeros(1, dtype=torch.int64, device=cell.device),
                       torch.cumsum(counts, 0)])
    order = torch.argsort(cell, stable=True)
    return CellIndex(start.to(torch.int32), order.to(torch.int32), inv, gx, gy)


def _cell_index_launch(B: int, N: int, u, v, stride: int, set_stride: int, width: float,
                       height: float, name: str):
    """One launch of the cell index kernel over B sets of N targets: u, v
    f32 CUDA tensors, target j of set b at element b set_stride + j stride
    of each -> (start [B, gx * gy + 2], order [B, N], inv_cell, gx, gy)."""
    if N >= 1 << 16:
        raise ValueError(f"{name}: at most 65535 targets a set")
    inv, gx, gy = cell_grid(width, height)
    start = torch.empty((B, gx * gy + 2), dtype=torch.int32, device=u.device)
    order = torch.empty((B, N), dtype=torch.int32, device=u.device)
    lib = kbuild.load()
    kbuild.check(lib.svt_cell_index(B, N, u.data_ptr(), v.data_ptr(), stride, set_stride, inv,
                                    gx, gy, start.data_ptr(), order.data_ptr(),
                                    kbuild.stream_ptr(u.device)), name)
    return start, order, inv, gx, gy


def build_cell_index(col_u, col_v, width: float, height: float) -> CellIndex:
    """Kernel C's cell index (one launch of the index kernel, one set) on
    CUDA tensors, the plain version on CPU tensors. col_u, col_v [N] f32."""
    if not col_u.is_cuda:
        return build_cell_index_plain(col_u, col_v, width, height)
    N = col_u.shape[0]
    _check(col_u, (N,), torch.float32, "col_u")
    _check(col_v, (N,), torch.float32, "col_v")
    start, order, inv, gx, gy = _cell_index_launch(1, N, col_u, col_v, 1, 0, width, height,
                                                   "cell_index")
    build_cell_index.launches += 1
    return CellIndex(start[0], order[0], inv, gx, gy)


build_cell_index.launches = 0


def build_cell_index_batch(uv: torch.Tensor, width: float, height: float):
    """The cell indexes of B sets of N points, uv [B, N, 2] f32 (a fuse
    chunk's keypoints): per set the cells and starts build_cell_index
    gives, stacked as (start [B, gx * gy + 2], order [B, N], inv_cell, gx,
    gy). On CUDA one launch of kernel C's index kernel, a block per set,
    reading uv in place, a cell's points in no fixed order (kernel L's walk
    does not depend on it); on the CPU build_cell_index_plain per set."""
    if not uv.is_cuda:
        inv, gx, gy = cell_grid(width, height)
        idx = [build_cell_index_plain(x[:, 0], x[:, 1], width, height) for x in uv]
        return (torch.stack([c.start for c in idx]), torch.stack([c.order for c in idx]), inv,
                gx, gy)
    B, N = uv.shape[0], uv.shape[1]
    _check(uv, (B, N, 2), torch.float32, "uv")
    out = _cell_index_launch(B, N, uv, uv[..., 1], 2, 2 * N, width, height, "cell_index_batch")
    build_cell_index_batch.launches += 1
    return out


build_cell_index_batch.launches = 0


def _cell_span(c, rad, inv_cell, g):
    """The cells [a, b] a window [c - rad, c + rad] meets on one axis,
    widened by kernel C's rounding margin (0.01 + 1e-5 (|c| + |rad|), each
    operation rounded in f32); a NaN bound takes the grid's end."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=c.device)
    m = (rad + f32(0.01)) + f32(1e-5) * (c.abs() + rad.abs())
    lo, hi = torch.floor((c - m) * inv_cell), torch.floor((c + m) * inv_cell)
    a = torch.where(torch.isnan(lo), 0.0, lo.clamp(0, g - 1))
    b = torch.where(torch.isnan(hi), float(g - 1), hi.clamp(0, g - 1))
    return a.to(torch.int64), b.to(torch.int64)


def cell_walk_mask(window: WindowGate) -> torch.Tensor:
    """[M,N] bool: the targets a row of kernel C's window walk visits (those
    in the cells its window meets, on the index of the window's targets over
    its extent; never the NaN cell)."""
    cells = build_cell_index_plain(window.col_u, window.col_v, *window.extent)
    return cells_visited(cells, window.row_u, window.row_v, window.row_rad)


def cells_visited(cells: CellIndex, u, v, rad) -> torch.Tensor:
    """[M,N] bool: the targets of `cells` in the cells a window [u +- rad] x
    [v +- rad] meets, widened by kernel C's rounding margin (the walk of
    kernel C's window rows and of kernel L); never the NaN cell."""
    x0, x1 = _cell_span(u, rad, cells.inv_cell, cells.gx)
    y0, y1 = _cell_span(v, rad, cells.inv_cell, cells.gy)
    N = cells.order.shape[0]
    G = cells.gx * cells.gy
    cell = torch.empty(N, dtype=torch.int64, device=cells.order.device)
    cell[cells.order.long()] = torch.repeat_interleave(
        torch.arange(G + 1, device=cell.device), (cells.start[1:] - cells.start[:-1]).long())
    cx, cy = cell % cells.gx, cell // cells.gx
    return (cell[None, :] < G) & (cx[None, :] >= x0[:, None]) & (cx[None, :] <= x1[:, None]) \
        & (cy[None, :] >= y0[:, None]) & (cy[None, :] <= y1[:, None])


def pairs_visited(q_desc, t_desc, row_ok, col_ok, window: Optional[WindowGate] = None,
                  orient=None, counter=None) -> torch.Tensor:
    """The (row, target) pairs a launch of kernel C visits (the arguments as
    `hamming_top2` takes them), as a device scalar: in window mode the cell
    walk of every row that passes row_ok; in brute-force mode every target
    for such a row."""
    if window is None:
        return row_ok.sum() * t_desc.shape[0]
    return (cell_walk_mask(window) & row_ok[:, None]).sum()


def unpack_bits_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[N,8] int32 descriptor words -> [N,256] f32 in {-1, +1}."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[..., None] >> shifts) & 1  # arithmetic shift; bit 31 kept
    return bits.reshape(desc.shape[0], 256).to(torch.float32) * 2.0 - 1.0


def pairwise_hamming(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """[N,8] x [M,8] -> [N,M] int32 exact Hamming distances."""
    dot = unpack_bits_pm1(desc1) @ unpack_bits_pm1(desc2).T
    return ((256.0 - dot) * 0.5).round().to(torch.int32)


def angle_diff_ok(angle1, angle2, thr_deg: float = 30.0) -> torch.Tensor:
    """|circular angle difference| <= thr_deg."""
    d = angle1 - angle2
    d = torch.atan2(torch.sin(d), torch.cos(d))
    # the f32 threshold as a host scalar: a device tensor built from a host
    # value costs a blocking copy per call
    thr = float(torch.deg2rad(torch.tensor(thr_deg, dtype=torch.float32)))
    return torch.abs(d) <= thr


def gate_matrix(row_ok, col_ok, window: Optional[WindowGate],
                orient: Union[OrientGate, AngleGate, None]) -> torch.Tensor:
    """[M,N] bool candidate mask (plain version of the kernel's gates)."""
    cand = row_ok[:, None] & col_ok[None, :]
    if window is not None:
        w = window
        rad = w.row_rad[:, None]
        cand = cand & (torch.abs(w.col_u[None, :] - w.row_u[:, None]) <= rad) \
            & (torch.abs(w.col_v[None, :] - w.row_v[:, None]) <= rad) \
            & (w.col_level[None, :] >= w.row_lo[:, None]) \
            & (w.col_level[None, :] <= w.row_hi[:, None])
        both = (w.col_xr[None, :] > 0) & (w.row_xr[:, None] > 0)
        cand = cand & (~both | (torch.abs(w.row_xr[:, None] - w.col_xr[None, :]) <= rad))
    if isinstance(orient, AngleGate):
        d = orient.row_angle[:, None] - orient.col_angle[None, :]
        cand = cand & (torch.abs(torch.atan2(torch.sin(d), torch.cos(d))) <= orient.thr)
    elif orient is not None:
        o = orient
        cosd = o.row_c[:, None] * o.col_c[None, :] + o.row_s[:, None] * o.col_s[None, :]
        cand = cand & (cosd >= o.cos_thr)
    return cand


def hamming_top2_plain(q_desc, t_desc, row_ok, col_ok,
                       window: Optional[WindowGate] = None,
                       orient: Union[OrientGate, AngleGate, None] = None,
                       counter=None, walk: bool = False):
    """(best, best_idx, second, second_idx), each [M] int32. With a window
    and `walk`, only the pairs of kernel C's cell walk are candidates (a
    model of the kernel). `counter` is `hamming_top2`'s; no kernel launches
    here, so it is not raised."""
    dist = pairwise_hamming(q_desc, t_desc)
    cand = gate_matrix(row_ok, col_ok, window, orient)
    if window is not None and walk:
        cand = cand & cell_walk_mask(window)
    dist = torch.where(cand, dist, torch.full_like(dist, _MASKED))
    best, best_idx = dist.min(dim=1)
    masked = dist.scatter(1, best_idx[:, None], _MASKED)
    second, second_idx = masked.min(dim=1)
    return (best.to(torch.int32), best_idx.to(torch.int32),
            second.to(torch.int32), second_idx.to(torch.int32))


def _check(t, shape, dtype, name):
    if t.shape != shape or t.dtype != dtype or not t.is_cuda \
            or not t.is_contiguous():
        raise ValueError(f"hamming_top2: {name} must be a contiguous CUDA "
                         f"{dtype} tensor of shape {tuple(shape)}")


def _aligned(t):
    """t, or a copy of it where its data does not start on 16 bytes (kernel
    C's brute-force mode copies target tiles 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def hamming_top2(q_desc, t_desc, row_ok, col_ok,
                 window: Optional[WindowGate] = None,
                 orient: Union[OrientGate, AngleGate, None] = None,
                 counter=None):
    """Kernel C on CUDA tensors, the plain version on CPU tensors. With a
    window, the call first sorts the window's targets into cells
    (`build_cell_index` over `window.extent`), then walks them. `counter`:
    an object whose `launches` the launch also raises (a caller's own
    count)."""
    if not q_desc.is_cuda:
        return hamming_top2_plain(q_desc, t_desc, row_ok, col_ok, window, orient)
    M, N = q_desc.shape[0], t_desc.shape[0]
    if N >= 1 << 16:
        raise ValueError("hamming_top2: at most 65535 targets")
    _check(q_desc, (M, 8), torch.int32, "q_desc")
    _check(t_desc, (N, 8), torch.int32, "t_desc")
    _check(row_ok, (M,), torch.bool, "row_ok")
    _check(col_ok, (N,), torch.bool, "col_ok")
    w_ptrs, c_args = [0] * 10, [0, 0, 0.0, 0, 0]
    if window is not None:
        for i, (name, t) in enumerate(zip(_WINDOW_TENSORS, window)):
            n = M if name.startswith("row") else N
            dt = torch.int32 if name in ("row_lo", "row_hi", "col_level") \
                else torch.float32
            _check(t, (n,), dt, name)
            w_ptrs[i] = t.data_ptr()
        cells = build_cell_index(window.col_u, window.col_v, *window.extent)
        c_args = [cells.start.data_ptr(), cells.order.data_ptr(), float(cells.inv_cell),
                  cells.gx, cells.gy]
    else:
        t_desc, col_ok = _aligned(t_desc), _aligned(col_ok)
        if orient is not None:
            orient = type(orient)(*[_aligned(f) if isinstance(f, torch.Tensor) else f
                                    for f in orient])
    # orientation mode 1 (cosine) reads row_c, row_s, col_c, col_s; mode 2
    # (angle) reads the angles through the row_c and col_c slots
    o_ptrs, o_thr, o_mode = [0] * 4, 0.0, 0
    if isinstance(orient, AngleGate):
        _check(orient.row_angle, (M,), torch.float32, "row_angle")
        _check(orient.col_angle, (N,), torch.float32, "col_angle")
        o_ptrs[0], o_ptrs[2] = orient.row_angle.data_ptr(), orient.col_angle.data_ptr()
        o_thr, o_mode = float(orient.thr), 2
    elif orient is not None:
        for i, name in enumerate(OrientGate._fields[:4]):
            t = orient[i]
            _check(t, (M if name.startswith("row") else N,), torch.float32, name)
            o_ptrs[i] = t.data_ptr()
        o_thr, o_mode = float(orient.cos_thr), 1
    out = torch.empty((M, 4), dtype=torch.int32, device=q_desc.device)
    lib = kbuild.load()
    kbuild.check(lib.svt_hamming_top2(
        M, N, q_desc.data_ptr(), t_desc.data_ptr(), row_ok.data_ptr(),
        col_ok.data_ptr(), int(window is not None), *w_ptrs, *c_args,
        o_mode, *o_ptrs, o_thr, out.data_ptr(),
        kbuild.stream_ptr(q_desc.device)), "hamming_top2")
    hamming_top2.launches += 1
    (window_walk if window is not None else brute_force).launches += 1
    if counter is not None:
        counter.launches += 1
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3]


hamming_top2.launches = 0


def epipolar_gate_matrix(b: int, row_ok, col_ok, g: EpipolarGate) -> torch.Tensor:
    """[N1,N2] bool candidate mask of neighbour b (plain version of kernel
    J's gates, in the JAX expression order)."""
    cand = row_ok[:, None] & col_ok[b][None, :]
    cosd = g.row_c[:, None] * g.col_c[b][None, :] + g.row_s[:, None] * g.col_s[b][None, :]
    cand = cand & (cosd >= g.cos_thr)
    cand = cand & ~(g.col_near[b][None, :] & ~g.row_stereo[:, None])
    e, r = g.col_epl[b], g.row_bear
    dot = e[None, :, 0] * r[:, None, 0] + e[None, :, 1] * r[:, None, 1] \
        + e[None, :, 2] * r[:, None, 2]
    c = torch.clamp(dot / g.col_norm[b][None, :], -1.0, 1.0)
    return cand & (torch.abs(c) < g.row_thr[:, None])


def _top2_of(dist) -> torch.Tensor:
    """[4,N1] (best, best_idx, second, second_idx) int32 of a masked [N1,N2]
    distance matrix: the minima of the packed keys dist * N2 + target, so
    that ties go to the lowest target on every device, as jnp.argmin and
    kernel J break them."""
    N2 = dist.shape[1]
    key = dist.long() * N2 + torch.arange(N2, device=dist.device)
    k1 = key.min(dim=1).values
    best_idx = k1 % N2
    k2 = key.scatter(1, best_idx[:, None], _MASKED * N2 + best_idx[:, None]).min(dim=1).values
    return torch.stack([k1 // N2, best_idx, k2 // N2, k2 % N2]).to(torch.int32)


def epipolar_top2_plain(q_desc, t_desc, row_ok, col_ok, gate: EpipolarGate):
    """(best, best_idx, second, second_idx), each [B,N1] int32."""
    outs = []
    for b in range(t_desc.shape[0]):
        dist = pairwise_hamming(q_desc, t_desc[b])
        outs.append(_top2_of(torch.where(epipolar_gate_matrix(b, row_ok, col_ok, gate), dist,
                                         torch.full_like(dist, _MASKED))))
    o = torch.stack(outs, dim=1)  # [4,B,N1]
    return o[0], o[1], o[2], o[3]


# kernel J's band index: angle bins over [0, pi), the margin on the
# residual bound, and the off-plane and length limits past which a target
# is visited by every row. The kernels take them from epipolar_band_index
# and epipolar_top2, so the plain band and the card's are one band.
J_BAND_BINS = 1024
J_BAND_TAU = 2e-4
J_OFF_PLANE = 1e-4
J_MIN_NORM = 1e-6


class EpipolarBand(NamedTuple):
    """Kernel J's band index: each neighbour's targets sorted by bucket,
    J_BAND_BINS angle bins, then the bucket every row visits, then the
    bucket none visits (targets that fail col_ok)."""

    basis: torch.Tensor  # [B,9] f32 (e1, u, v), epipole_basis
    start: torch.Tensor  # [B,J_BAND_BINS+3] i32 bucket starts
    order: torch.Tensor  # [B,N2] i32 targets by bucket


def epipole_basis(E) -> torch.Tensor:
    """[B,9] float32 (e1, u, v) of each neighbour, as kernel J's band index
    takes it (in float64): e1 the longest cross product of two columns of
    E_12, normalised (every epipolar plane's normal E b2 is perpendicular
    to it); u = e1 x the axis e1 is least along, normalised; v = e1 x u."""
    cols = E.double().transpose(-1, -2)  # [B,3,3]: column k of E at [:, k]
    cr = torch.stack([torch.linalg.cross(cols[:, a], cols[:, (a + 1) % 3], dim=-1)
                      for a in range(3)], 1)
    n2 = (cr * cr).sum(-1)
    best = n2.argmax(dim=1)
    ar = torch.arange(E.shape[0], device=E.device)
    nb = n2[ar, best]
    e = torch.where((nb > 0)[:, None], cr[ar, best] / torch.sqrt(nb.clamp(min=1e-300))[:, None],
                    torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=E.device))
    axis = torch.nn.functional.one_hot(e.abs().argmin(dim=1), 3).double()
    u = torch.linalg.cross(e, axis, dim=-1)
    u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    v = torch.linalg.cross(e, u, dim=-1)
    return torch.cat([e, u, v], -1).float()


def band_buckets(col_ok, gate: EpipolarGate, basis) -> torch.Tensor:
    """[B,N2] int64 bucket of every target in plain form: the bin of the
    angle phi (mod pi) of its unit epipolar normal in (u, v), J_BAND_BINS
    for one off the plane perpendicular to e1 or too short (every row
    visits it), J_BAND_BINS + 1 for one that fails col_ok."""
    nb, inv = J_BAND_BINS, J_BAND_BINS / math.pi
    n = gate.col_epl / gate.col_norm[..., None]
    off = (n * basis[:, None, 0:3]).sum(-1)
    phi = torch.atan2((n * basis[:, None, 6:9]).sum(-1), (n * basis[:, None, 3:6]).sum(-1))
    phi = torch.where(phi < 0, phi + math.pi, phi)
    bins = torch.clamp((phi * inv).long(), 0, nb - 1)
    always = ~(gate.col_norm >= J_MIN_NORM) | ~(off.abs() <= J_OFF_PLANE)
    return torch.where(~col_ok, torch.full_like(bins, nb + 1),
                       torch.where(always, torch.full_like(bins, nb), bins))


def epipolar_band_index_plain(col_ok, gate: EpipolarGate) -> EpipolarBand:
    """Kernel J's band index in plain form (within a bucket, targets in
    index order; the kernel's order there is its atomics')."""
    basis = epipole_basis(gate.E)
    bucket = band_buckets(col_ok, gate, basis)
    counts = torch.stack([torch.bincount(b, minlength=J_BAND_BINS + 2) for b in bucket])
    start = torch.cat([torch.zeros_like(counts[:, :1]), torch.cumsum(counts, 1)], 1)
    return EpipolarBand(basis, start.to(torch.int32),
                        torch.argsort(bucket, dim=1, stable=True).to(torch.int32))


def band_index_buckets(band: EpipolarBand) -> torch.Tensor:
    """[B,N2] int64: the bucket each target sits in within a band index."""
    order = band.order.long()
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    return torch.searchsorted(band.start.long(), pos, right=True) - 1


def epipolar_band_plain(q_desc, t_desc, row_ok, col_ok, gate: EpipolarGate):
    """Kernel J's band walk in plain form: epipolar_top2_plain's outputs,
    each row of each neighbour testing only the targets its band visits
    (band_buckets; a row away from the epipole visits the bins within
    asin((thr + J_BAND_TAU) / s) of its band's centre, s its sine to the
    epipole, and one more on each side, and a row near the epipole every
    bin). Returns (best, best_idx, second, second_idx, the pairs visited
    [B,N1,N2] bool: live rows and valid targets)."""
    B = t_desc.shape[0]
    nb, inv = J_BAND_BINS, J_BAND_BINS / math.pi
    basis = epipole_basis(gate.E)
    buckets = band_buckets(col_ok, gate, basis)
    outs, visits = [], []
    for b in range(B):
        u, v = basis[b, 3:6], basis[b, 6:9]
        bucket = buckets[b]
        wu, wv = gate.row_bear @ u, gate.row_bear @ v
        sn = torch.sqrt(wu * wu + wv * wv)
        bound = gate.row_thr + J_BAND_TAU
        band = bound < sn
        delta = torch.asin(torch.clamp(bound / sn, max=1.0))
        centre = torch.atan2(wv, wu) + 0.5 * math.pi
        centre = centre - math.pi * torch.floor(centre / math.pi)
        lo = torch.floor((centre - delta) * inv).long() - 1
        hi = torch.floor((centre + delta) * inv).long() + 1
        whole = ~band | (hi - lo + 1 >= nb)
        lo = torch.where(whole, torch.zeros_like(lo), lo)
        width = torch.where(whole, torch.full_like(hi, nb - 1), hi - lo)
        in_band = torch.remainder(bucket[None, :] - lo[:, None], nb) <= width[:, None]
        visit = ((bucket[None, :] < nb) & in_band) | (bucket[None, :] == nb)
        visits.append(visit & row_ok[:, None])
        dist = pairwise_hamming(q_desc, t_desc[b])
        mask = epipolar_gate_matrix(b, row_ok, col_ok, gate) & visit
        outs.append(_top2_of(torch.where(mask, dist, torch.full_like(dist, _MASKED))))
    o = torch.stack(outs, dim=1)
    return o[0], o[1], o[2], o[3], torch.stack(visits)


def _f32(x):
    return x.to(torch.float32).contiguous()


def _u8(x):
    return x.contiguous().view(torch.uint8)


def epipolar_band_index(col_ok, gate: EpipolarGate) -> EpipolarBand:
    """Kernel J's band index (csrc/hamming_top2.cu, one launch, a block a
    neighbour) on CUDA tensors, the plain version on CPU tensors. col_ok
    [B,N2] bool."""
    if not col_ok.is_cuda:
        return epipolar_band_index_plain(col_ok, gate)
    B, N2 = col_ok.shape
    if not 0 < N2 < 1 << 16:
        raise ValueError("epipolar_band_index: 1 to 65535 targets")
    args = ((_f32(gate.E), (B, 3, 3), torch.float32, "E"),
            (_f32(gate.col_epl), (B, N2, 3), torch.float32, "col_epl"),
            (_f32(gate.col_norm), (B, N2), torch.float32, "col_norm"),
            (_u8(col_ok), (B, N2), torch.uint8, "col_ok"))
    for x, shape, dt, name in args:
        _check(x, shape, dt, name)
    dev = col_ok.device
    band = EpipolarBand(torch.empty((B, 9), dtype=torch.float32, device=dev),
                        torch.empty((B, J_BAND_BINS + 3), dtype=torch.int32, device=dev),
                        torch.empty((B, N2), dtype=torch.int32, device=dev))
    kbuild.check(kbuild.load().svt_epipolar_band_index(
        B, N2, *(x[0].data_ptr() for x in args), J_BAND_BINS, J_OFF_PLANE, J_MIN_NORM,
        *(x.data_ptr() for x in band), kbuild.stream_ptr(dev)), "epipolar_band_index")
    epipolar_band_index.launches += 1
    return band


epipolar_band_index.launches = 0


def epipolar_top2(q_desc, t_desc, row_ok, col_ok, gate: EpipolarGate,
                  band: Optional[EpipolarBand] = None):
    """Kernel J on CUDA tensors: the band index (epipolar_band_index, or
    `band` when given) and the band walk (one launch, counted here); the
    plain version on CPU tensors. q_desc [N1,8] int32, t_desc [B,N2,8]
    int32, row_ok [N1] bool, col_ok [B,N2] bool."""
    if not q_desc.is_cuda:
        return epipolar_top2_plain(q_desc, t_desc, row_ok, col_ok, gate)
    B, N2 = t_desc.shape[0], t_desc.shape[1]
    N1 = q_desc.shape[0]
    if not 0 < N2 < 1 << 16:
        raise ValueError("epipolar_top2: 1 to 65535 targets")
    args = ((q_desc.contiguous(), (N1, 8), torch.int32, "q_desc"),
            (_f32(gate.row_c), (N1,), torch.float32, "row_c"),
            (_f32(gate.row_s), (N1,), torch.float32, "row_s"),
            (_f32(gate.row_bear), (N1, 3), torch.float32, "row_bear"),
            (_f32(gate.row_thr), (N1,), torch.float32, "row_thr"),
            (_u8(row_ok), (N1,), torch.uint8, "row_ok"),
            (_u8(gate.row_stereo), (N1,), torch.uint8, "row_stereo"),
            (_aligned(t_desc.contiguous()), (B, N2, 8), torch.int32, "t_desc"),
            (_f32(gate.col_c), (B, N2), torch.float32, "col_c"),
            (_f32(gate.col_s), (B, N2), torch.float32, "col_s"),
            (_f32(gate.col_epl), (B, N2, 3), torch.float32, "col_epl"),
            (_f32(gate.col_norm), (B, N2), torch.float32, "col_norm"),
            (_u8(col_ok), (B, N2), torch.uint8, "col_ok"),
            (_u8(gate.col_near), (B, N2), torch.uint8, "col_near"))
    for x, shape, dt, name in args:
        _check(x, shape, dt, name)
    if band is None:
        band = epipolar_band_index(col_ok, gate)
    for x, shape, dt, name in zip(band, ((B, 9), (B, J_BAND_BINS + 3), (B, N2)),
                                  (torch.float32, torch.int32, torch.int32),
                                  ("basis", "start", "order")):
        _check(x, shape, dt, name)
    out = torch.empty((B, N1, 4), dtype=torch.int32, device=q_desc.device)
    kbuild.check(kbuild.load().svt_epipolar_top2(
        B, N1, N2, *(x[0].data_ptr() for x in args), float(gate.cos_thr), J_BAND_BINS,
        J_BAND_TAU, *(x.data_ptr() for x in band), out.data_ptr(),
        kbuild.stream_ptr(q_desc.device)), "epipolar_top2")
    epipolar_top2.launches += 1
    return out[..., 0], out[..., 1], out[..., 2], out[..., 3]


epipolar_top2.launches = 0


def resolve_duplicate_targets(target_idx, dist, accepted, num_targets: int):
    """Keep, per target, only the lowest-distance accepted source (ties ->
    lowest source index): key dist*M + src, a scatter-min per target."""
    M = target_idx.shape[0]
    big = 2 ** 30
    src = torch.arange(M, device=target_idx.device, dtype=torch.int64)
    key = torch.where(accepted, dist.to(torch.int64) * M + src,
                      torch.full_like(src, big))
    best = torch.full((num_targets,), big, dtype=torch.int64,
                      device=target_idx.device)
    tgt = target_idx.to(torch.int64)
    # every source scatters (a rejected one its `big` key at target 0), so
    # no boolean index makes the host wait for a count
    best = best.scatter_reduce(0, torch.where(accepted, tgt, torch.zeros_like(tgt)), key,
                               reduce="amin")
    return accepted & (best[tgt] == key)
