"""Kernel T's band walk, as a plain function of the slot layout, on the CPU.

Kernel T (csrc/stereo_match.cu) visits, for each left keypoint, only the
right slots in the cells that the row band and the disparity range can
reach; `chip_smoke.band_cells_plain` is that walk in torch. The walk is exact
only if every pair the dense gate of `stereo_match_plain` admits lies in a
visited cell. That is held here on the extractor's real slots for a
rendered 752x480, 8-level pair of the bench's plane world, and on seeded
layouts made to reach the walk's edges: left keypoints on the boundary
between two cell rows (the band crosses both), at levels 0 and L-1, and
last cell rows that reach past the level (their y interval clamps). The
layout invariant the walk rests on (every valid slot's keypoint inside its
cell's interval) is held on the extracted pair.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from stella_vslam_tpu_torch.feature import orb_extractor as ox
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.feature.orb_pattern import EDGE_BORDER
from stella_vslam_tpu_torch.match import stereo as st
from tests.synthetic_world import PlaneWorld

torch.set_num_threads(1)


def _dense_candidates(args, kw):
    """The pairs stereo_match_plain's gate admits, [NL, NR] bool."""
    l_xy, l_lvl, l_valid, r_xy, r_lvl, r_valid = (args[q] for q in (0, 1, 3, 5, 6, 8))
    max_disp = st.max_disparity(kw["focal_x_baseline"], kw["true_baseline"])
    d = l_xy[:, None, 0] - r_xy[None, :, 0]
    return (((r_xy[None, :, 1] - l_xy[:, None, 1]).abs()
             <= 2.0 * kw["scale_factors"][r_lvl.long()][None])
            & (d >= 0) & (d < max_disp) & ((l_lvl[:, None] - r_lvl[None]).abs() <= 1)
            & l_valid[:, None] & r_valid[None])


def _walk(args, kw, layout):
    max_disp = st.max_disparity(kw["focal_x_baseline"], kw["true_baseline"])
    cells = chip_smoke.band_cells_plain(args[0], args[1], args[3], layout, kw["scale_factors"],
                                max_disp)
    return cells, chip_smoke.band_visited(cells, layout)


@pytest.fixture(scope="module")
def rendered_pair():
    world = PlaneWorld(width=752, height=480, fx=458.0, fy=458.0, depth=4.0, tex_size=4096,
                       meters_per_px=0.008, noise_sigma=2.0, exposure_amp=0.06)
    ex = ox.OrbExtractor(OrbParams(num_levels=8), 752, 480, min_area=800, device="cpu")
    T = np.eye(4)
    T[0, 3] = -0.6
    Tb = np.eye(4)
    Tb[0, 3] = -0.12
    (fl, sl), (fr, sr) = ex.extract_pair_with_patches(
        torch.from_numpy(world.render(T)), torch.from_numpy(world.render(Tb @ T)))
    fxb = float(np.float32(458.0 * 0.12))
    kw = dict(scale_factors=torch.tensor(ex.params.scale_factors, dtype=torch.float32),
              focal_x_baseline=fxb, true_baseline=fxb / float(np.float32(458.0)))
    args = (fl.xy, fl.level, fl.desc, fl.valid, sl, fr.xy, fr.level, fr.desc, fr.valid, sr)
    return ex, args, kw


def test_extracted_slots_lie_in_their_cells(rendered_pair):
    """Every valid slot of both images: its keypoint inside its cell's y and
    x intervals, at its layout level."""
    ex, args, _ = rendered_pair
    iv = chip_smoke.slot_cells(ex.slot_layout, "cpu")
    assert ex.slot_layout.num_slots == 2872
    for xy, lvl, valid in ((args[0], args[1], args[3]), (args[5], args[6], args[8])):
        inside = (xy[:, 1] >= iv[:, 0]) & (xy[:, 1] <= iv[:, 1]) & (xy[:, 0] >= iv[:, 2]) \
            & (xy[:, 0] <= iv[:, 3])
        assert int(valid.sum()) > 1500
        assert bool(inside[valid].all())
        assert torch.equal(lvl, ex._slot_level)


def test_band_walk_covers_the_dense_gate_on_a_rendered_pair(rendered_pair):
    """The walk visits every admitted pair of the extracted 752x480 pair,
    and about 40 slots a valid left keypoint of the 2872 (measured 68787
    pairs in all, 15115 admitted)."""
    ex, args, kw = rendered_pair
    cand = _dense_candidates(args, kw)
    cells, visited = _walk(args, kw, ex.slot_layout)
    assert int(cand.sum()) > 5000
    assert not bool((cand & ~visited).any()), int((cand & ~visited).sum())
    assert chip_smoke.band_pairs(cells) == int(visited.sum())
    assert chip_smoke.band_pairs(cells) < 60 * int(args[3].sum())


def _edge_layout():
    """Three levels of a 400x300 image whose last cell rows and columns reach
    past the level (the interval's end clamps to H - 1 / W - 1)."""
    levels = []
    for l, (gy, gx) in enumerate(((7, 9), (6, 7), (4, 5))):
        s = 1.2 ** l
        W, H = int(round(400 / s)), int(round(300 / s))
        cs = int(np.ceil(max((W - 2 * EDGE_BORDER) / gx, (H - 2 * EDGE_BORDER) / gy))) + 6
        levels.append(ox._LevelGeom(H, W, cs, gy, gx, s))
    return levels


@pytest.mark.parametrize("case", ["row_boundary", "end_levels", "clamped_rows", "random"])
def test_band_walk_covers_the_dense_gate_at_its_edges(case):
    """Seeded layouts and keypoints at the walk's edges: every admitted pair
    lies in a visited cell."""
    levels = _edge_layout()
    layout = ox.slot_layout(levels, EDGE_BORDER, "cpu")
    assert any(EDGE_BORDER + g.Gy * g.cs > g.H for g in levels)
    args, kw = chip_smoke.stereo_layout_case("cpu", levels, levels, EDGE_BORDER, seed=3,
                                             max_shift=40.0)
    args = list(args)
    rng = np.random.default_rng(11)
    NL, L = args[0].shape[0], len(levels)
    l_xy, l_lvl = args[0].clone(), args[1].clone()
    iv = chip_smoke.slot_cells(layout, "cpu")
    if case == "row_boundary":
        # on a cell row's first or last y, or half a pixel beyond it
        pick = torch.from_numpy(rng.integers(0, iv.shape[0], NL))
        edge = torch.where(torch.from_numpy(rng.random(NL) < 0.5), iv[pick, 0], iv[pick, 1])
        l_xy[:, 1] = edge + torch.from_numpy(rng.choice([-0.5, 0.0, 0.5], NL)).float()
        l_lvl = torch.from_numpy(rng.integers(0, L, NL).astype(np.int32))
    elif case == "end_levels":
        l_lvl = torch.from_numpy(rng.choice([0, L - 1], NL).astype(np.int32))
    elif case == "clamped_rows":
        # the right keypoints of the last cell rows at the level's last pixel row
        first = np.cumsum([0] + [g.Gy * g.Gx for g in levels])
        r_xy = args[5].clone()
        for l, g in enumerate(levels):
            last = slice(first[l] + (g.Gy - 1) * g.Gx, first[l + 1])
            r_xy[last, 1] = float(np.float32(g.H - 1) * np.float32(g.scale))
        args[5] = r_xy
        args[8] = torch.ones_like(args[8])
        l_xy[:, 1] = torch.from_numpy(rng.uniform(200, 300, NL)).float()
    args[0], args[1] = l_xy, l_lvl
    cand = _dense_candidates(args, kw)
    _, visited = _walk(args, kw, layout)
    assert int(cand.sum()) > 20
    assert not bool((cand & ~visited).any()), int((cand & ~visited).sum())
