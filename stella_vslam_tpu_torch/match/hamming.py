"""256-bit Hamming matching core: kernel C (`hamming_top2`) and helpers.

Port of stella_vslam_tpu/match/hamming.py. The JAX version forms the whole
[M,N] distance matrix as a +/-1 int8 matmul and reduces it after masking;
the matchers here call `hamming_top2`, which returns per query row the best
and second-best distance and their target indices over the gated targets:

* on CUDA tensors, kernel C (csrc/hamming_top2.cu): XOR + popcount with the
  gates evaluated in registers, the [M,N] matrix never stored; the gates
  are a projection window, an orientation cosine (tracking) or an angle
  difference (the initializer's area matcher);
* on CPU tensors, `hamming_top2_plain`: the JAX version's dense form (a
  +/-1 f32 matmul — exact, every sum is an integer of magnitude <= 256).

Masked entries count as distance 257 and ties break to the lowest target
index, as jnp.argmin breaks them. Ratio tests, orientation checks and
duplicate resolution stay plain torch on the [M] outputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild

HAMMING_DIST_THR_LOW = 50
HAMMING_DIST_THR_HIGH = 100
MAX_HAMMING_DIST = 256
_MASKED = MAX_HAMMING_DIST + 1


class WindowGate(NamedTuple):
    """Projection gates: |du|,|dv| <= rad, lo <= level <= hi, and
    |xr_row - xr_col| <= rad when both x_right are > 0."""

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
    thr = torch.deg2rad(torch.tensor(thr_deg, dtype=torch.float32, device=d.device))
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
                       orient: Union[OrientGate, AngleGate, None] = None):
    """(best, best_idx, second, second_idx), each [M] int32."""
    dist = pairwise_hamming(q_desc, t_desc)
    dist = torch.where(gate_matrix(row_ok, col_ok, window, orient), dist,
                       torch.full_like(dist, _MASKED))
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


def hamming_top2(q_desc, t_desc, row_ok, col_ok,
                 window: Optional[WindowGate] = None,
                 orient: Union[OrientGate, AngleGate, None] = None):
    """Kernel C on CUDA tensors, the plain version on CPU tensors."""
    if not q_desc.is_cuda:
        return hamming_top2_plain(q_desc, t_desc, row_ok, col_ok, window, orient)
    M, N = q_desc.shape[0], t_desc.shape[0]
    if N >= 1 << 16:
        raise ValueError("hamming_top2: at most 65535 targets")
    _check(q_desc, (M, 8), torch.int32, "q_desc")
    _check(t_desc, (N, 8), torch.int32, "t_desc")
    _check(row_ok, (M,), torch.bool, "row_ok")
    _check(col_ok, (N,), torch.bool, "col_ok")
    w_ptrs = [0] * 10
    if window is not None:
        for i, (name, t) in enumerate(zip(WindowGate._fields, window)):
            n = M if name.startswith("row") else N
            dt = torch.int32 if name in ("row_lo", "row_hi", "col_level") \
                else torch.float32
            _check(t, (n,), dt, name)
            w_ptrs[i] = t.data_ptr()
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
        col_ok.data_ptr(), int(window is not None), *w_ptrs,
        o_mode, *o_ptrs, o_thr, out.data_ptr(),
        kbuild.stream_ptr(q_desc.device)), "hamming_top2")
    hamming_top2.launches += 1
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3]


hamming_top2.launches = 0


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
    best = best.scatter_reduce(0, tgt[accepted], key[accepted], reduce="amin")
    return accepted & (best[tgt] == key)
