"""Kernel C's cell index and cell walk (plain versions) against the dense
top-2 (`hamming_top2_plain` without an index) on seeded random cases.

The window modes of kernel C visit only the targets in the grid cells a
row's window meets; the result must be the dense walk's exactly. The plain
cell index (`build_cell_index_plain`) and the plain cell walk
(`hamming_top2_plain` with `walk=True`, built on `cell_walk_mask`) are what
the kernel computes, so these cases hold the cover to be conservative: targets
far outside the image (undistorted fisheye and division keypoints), NaN
coordinates, empty windows, rows that all fail row_ok, one or two targets,
ties at equal distance, and windows whose edge falls exactly on a target
at a cell boundary. Integer outputs must be equal.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu_torch.match import hamming as H

torch.set_num_threads(1)


def _case(seed, M, N, *, width=752.0, height=480.0, spread=1.0, rad=(5.0, 80.0),
          ok_rate=0.9, nan_rate=0.0, ties=False):
    rng = np.random.default_rng(seed)
    q = rng.integers(-2 ** 31, 2 ** 31, (M, 8), dtype=np.int64)
    t = rng.integers(-2 ** 31, 2 ** 31, (N, 8), dtype=np.int64)
    k = min(M, N)
    t[:k] = q[:k] ^ (rng.integers(0, 2, (k, 8)) << rng.integers(0, 32, (k, 8)))
    if ties:  # groups of equal descriptors: equal distances to every row
        t = t[rng.integers(0, max(1, N // 8), N)]
    # targets over the image, or `spread` times as far around its centre
    cu = width / 2 + (rng.uniform(0, width, N) - width / 2) * spread
    cv = height / 2 + (rng.uniform(0, height, N) - height / 2) * spread
    nan = rng.random(N) < nan_rate
    cu[nan] = np.nan
    cv[nan & (rng.random(N) < 0.5)] = np.nan
    src = rng.integers(0, N, M)
    ru = np.nan_to_num(cu[src], nan=100.0) + rng.normal(0, 4, M)
    rv = np.nan_to_num(cv[src], nan=100.0) + rng.normal(0, 4, M)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    lvl = rng.integers(0, 4, N)
    lo = rng.integers(0, 3, M)
    xr_c = np.where(rng.random(N) < 0.5, cu - 30.0, -1.0)
    xr_r = np.where(rng.random(M) < 0.5, ru - 30.0, -1.0)
    win = H.WindowGate(
        row_u=f32(ru), row_v=f32(rv), row_xr=f32(xr_r),
        row_rad=f32(rng.uniform(*rad, M)), row_lo=i32(lo), row_hi=i32(lo + 1),
        col_u=f32(cu), col_v=f32(cv), col_xr=f32(xr_c), col_level=i32(lvl),
        extent=(width, height))
    row_ok = torch.as_tensor(rng.random(M) < ok_rate)
    col_ok = torch.as_tensor(rng.random(N) < 0.9)
    return (torch.as_tensor(q.astype(np.int32)), torch.as_tensor(t.astype(np.int32)), row_ok,
            col_ok), win


def _orients(args, win, seed):
    rng = np.random.default_rng(seed)
    M, N = args[0].shape[0], args[1].shape[0]
    a_r = torch.as_tensor(rng.uniform(-3.2, 3.2, M).astype(np.float32))
    a_c = torch.as_tensor(rng.uniform(-3.2, 3.2, N).astype(np.float32))
    return [None, H.OrientGate(torch.cos(a_r), torch.sin(a_r), torch.cos(a_c), torch.sin(a_c),
                               0.8660254),
            H.AngleGate(a_r, a_c, 0.5235988)]


def _equal_to_dense(args, win, orient=None):
    dense = H.hamming_top2_plain(*args, window=win, orient=orient)
    walked = H.hamming_top2_plain(*args, window=win, orient=orient, walk=True)
    wrapper = H.hamming_top2(*args, window=win, orient=orient)
    for d, w, x in zip(dense, walked, wrapper):
        assert torch.equal(d, w) and torch.equal(d, x)
    cand = H.gate_matrix(args[2], args[3], win, orient)
    assert not bool((cand & ~H.cell_walk_mask(win)).any()), "the cover missed a pair"
    return dense


CASES = {
    "image": dict(M=600, N=900),
    "fisheye_outside": dict(M=500, N=900, spread=5.0),
    "division_far_outside": dict(M=300, N=700, spread=40.0, rad=(5.0, 400.0)),
    "nan_coordinates": dict(M=400, N=600, nan_rate=0.1),
    "ties": dict(M=300, N=500, ties=True),
    "small_windows": dict(M=800, N=1200, rad=(0.5, 3.0)),
    "equirect_640x320": dict(M=500, N=800, width=640.0, height=320.0),
    "tiny_image": dict(M=100, N=150, width=40.0, height=30.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cell_walk_equals_dense(name):
    kw = dict(CASES[name])
    args, win = _case(sorted(CASES).index(name) + 11, kw.pop("M"), kw.pop("N"), **kw)
    for orient in _orients(args, win, 5):
        _equal_to_dense(args, win, orient)


def test_rows_with_empty_windows_report_the_dense_walks_default():
    """Rows whose window holds no target (negative or zero radius, a window
    in an empty part of the image) and rows that fail row_ok: best 257 at
    index 0, second 257 at 0, as the dense walk's masked row gives."""
    args, win = _case(3, 200, 300)
    rad = win.row_rad.clone()
    rad[::3] = -1.0
    rad[1::3] = 0.0
    win = win._replace(row_rad=rad, row_u=torch.where(torch.arange(200) % 3 == 2,
                                                      torch.tensor(5000.0), win.row_u))
    dense = _equal_to_dense(args, win)
    assert bool((dense[0] == 257).all()) and bool((dense[1] == 0).all())
    assert bool((dense[2] == 257).all()) and bool((dense[3] == 0).all())


def test_all_rows_fail_row_ok():
    args, win = _case(4, 150, 400, ok_rate=0.0)
    dense = _equal_to_dense(args, win)
    assert bool((dense[0] == 257).all())
    assert int(H.pairs_visited(*args, window=win)) == 0


@pytest.mark.parametrize("N", [1, 2])
def test_one_or_two_targets(N):
    args, win = _case(5 + N, 40, N, rad=(50.0, 400.0))
    _equal_to_dense(args, win)


def test_window_edge_on_a_cell_boundary():
    """Targets on cell boundaries (multiples of the 32-px cell) and rows
    whose window edge lands exactly on them (|du| == rad in float32): the
    widened span must still reach the target's cell."""
    rng = np.random.default_rng(8)
    N, M = 400, 400
    cu = (rng.integers(0, 24, N) * 32.0).astype(np.float32)
    cv = (rng.integers(0, 15, N) * 32.0).astype(np.float32)
    j = rng.integers(0, N, M)
    # half the radii in eighths of a pixel (cu +- rad exact), half anywhere
    rad = np.where(np.arange(M) % 2 == 0, rng.integers(4, 320, M) / 8.0,
                   rng.uniform(0.5, 40.0, M)).astype(np.float32)
    sign = np.where(rng.random(M) < 0.5, 1.0, -1.0).astype(np.float32)
    ru = (cu[j] + sign * rad).astype(np.float32)
    rv = cv[j] + np.float32(0.25)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    args, win = _case(9, M, N)
    win = win._replace(row_u=f32(ru), row_v=f32(rv), row_rad=f32(rad), col_u=f32(cu),
                       col_v=f32(cv), row_xr=f32(-np.ones(M)), col_xr=f32(-np.ones(N)),
                       row_lo=torch.zeros(M, dtype=torch.int32),
                       row_hi=torch.full((M,), 3, dtype=torch.int32))
    args = (args[0], args[1], torch.ones(M, dtype=torch.bool), torch.ones(N, dtype=torch.bool))
    exact = (np.abs(cu[j] - ru) == rad)
    assert exact.mean() > 0.5  # most windows end exactly on their target's boundary
    _equal_to_dense(args, win)


@pytest.mark.parametrize("size", [(752.0, 480.0), (640.0, 320.0), (400.0, 300.0), (5.0, 3.0),
                                  (4000.0, 3000.0)])
def test_cell_index_sorts_targets_stably(size):
    args, win = _case(10, 10, 3000, spread=3.0, nan_rate=0.05)
    cells = H.build_cell_index_plain(win.col_u, win.col_v, *size)
    inv, gx, gy = H.cell_grid(*size)
    assert gx * gy <= H.MAX_CELLS and (cells.inv_cell, cells.gx, cells.gy) == (inv, gx, gy)
    assert sorted(cells.order.tolist()) == list(range(3000))
    cell = H._cells_of(win.col_u, win.col_v, inv, gx, gy)
    key = cell[cells.order.long()] * 4096 + cells.order.long()
    assert bool((key[1:] > key[:-1]).all())  # by cell, ascending index within a cell
    assert cells.start.shape[0] == gx * gy + 2 and int(cells.start[-1]) == 3000
    assert torch.equal(cells.start[1:] - cells.start[:-1],
                       torch.bincount(cell, minlength=gx * gy + 1).to(torch.int32))
    nan = torch.isnan(win.col_u) | torch.isnan(win.col_v)
    assert torch.equal(cell == gx * gy, nan)


def test_stage3_windows_visit_a_small_share_of_the_pairs():
    """Windows of the local-map stage (radius 5 x scale factor, 1-2 cells a
    side) at 752x480 visit far fewer pairs than the dense walk: the
    prediction for kernel C is 30x or more."""
    args, win = _case(12, 4096, 2872, rad=(5.0, 18.0))
    visited = int(H.pairs_visited(*args, window=win))
    dense = int(args[2].sum()) * 2872
    assert visited * 30 <= dense
    assert int(H.pairs_visited(*args)) == dense
