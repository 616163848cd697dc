"""Kernel B's per-bin pixel tables (orb_extractor.bin_pixel_tables) and the
plain describe restricted to them (orb_describe_pixels_plain), on the CPU.

Kernel B blurs only the pixels its keypoint's steering bin reads. These
tests hold the tables to the pair offsets (both points of every pair of
every bin, the strip apart) and the restricted plain describe to
orb_describe_plain exactly, on seeded frames of the synthetic world and on
chip_smoke.bin_edge_keypoints: keypoints whose patches are intensity ramps aimed
near both edges of every one of the 30 bins, on images whose borders clamp
the patch (down to images smaller than a patch, like the top pyramid
levels). tests/test_torch_cuda.py holds kernel B to orb_describe_plain on
the same generator.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu_torch.feature import orb_extractor as ox
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld, lateral_trajectory
from chip_smoke import bin_edge_keypoints

torch.set_num_threads(1)


def _tables(pattern="native"):
    ex = ox.OrbExtractor(OrbParams(num_levels=4), 400, 300, min_area=400,
                         descriptor_pattern=pattern, device="cpu")
    return ex, ex._tables


@pytest.mark.parametrize("pattern", ["native", "opencv"])
def test_bin_pixel_tables_cover_every_pair(pattern):
    """Each bin's list holds exactly the distinct pixels its 256 pairs read,
    ascending, and each pair's places in it point back at its two pixels."""
    _, tab = _tables(pattern)
    off = tab.offsets.long().numpy()
    pix, npix, pidx = tab.pix.numpy(), tab.npix.numpy(), tab.pidx.long().numpy()
    assert pix.shape == (ox.ANGLE_BINS, ox.MAX_BIN_PIXELS) and pidx.shape == (ox.ANGLE_BINS, 256, 2)
    for b in range(ox.ANGLE_BINS):
        p0 = off[b, :, 1] * 39 + off[b, :, 0]
        p1 = off[b, :, 3] * 39 + off[b, :, 2]
        want = np.unique(np.concatenate([p0, p1]))
        n = int(npix[b])
        assert n == want.size <= ox.MAX_BIN_PIXELS
        assert np.array_equal(pix[b, :n], want)
        assert np.all(pix[b, n:] == 0)
        assert np.array_equal(pix[b, pidx[b, :, 0]], p0)
        assert np.array_equal(pix[b, pidx[b, :, 1]], p1)
        assert pidx[b].min() >= 0 and pidx[b].max() < n


def test_bin_pixel_tables_leave_the_strip_to_its_own_blur():
    """The strip (rows 14-24, columns 9-29 of the 39x39) is blurred apart in
    strip mode: every pair pixel lies in the 39x39, and the union of the
    bins' lists is far smaller than the patch the parent kernel blurred."""
    _, tab = _tables()
    pix, npix = tab.pix.numpy(), tab.npix.numpy()
    allp = np.unique(np.concatenate([pix[b, :npix[b]] for b in range(ox.ANGLE_BINS)]))
    assert allp.min() >= 0 and allp.max() < 39 * 39
    assert npix.max() < 39 * 39 // 3
    strip = {(14 + r) * 39 + 9 + c for r in range(ox.STRIP_H) for c in range(ox.STRIP_W)}
    assert len(strip) == 231 and max(strip) < 39 * 39


def _frame_args(seed):
    ex, tab = _tables()
    img = PlaneWorld(noise_sigma=2.0, seed=seed).render(lateral_trajectory(3)[seed % 3])
    levels = ex.pyramid(torch.from_numpy(img))
    pts = [ox.cell_keypoints(ox.fast_nms_plain(l, g, ex.border, 20.0, 7.0), g, ex.border)
           for l, g in zip(levels, ex.levels)]
    px, py, valid, _ = (torch.cat(c) for c in zip(*pts))
    return (torch.cat([l.reshape(-1) for l in levels]), ex._slot_base, ex._slot_H, ex._slot_W,
            px.to(torch.int32), py.to(torch.int32), valid, tab)


@pytest.mark.parametrize("seed", [0, 1])
def test_restricted_describe_equals_plain_on_frames(seed):
    args = _frame_args(seed)
    a = ox.orb_describe_plain(*args, strips=True)
    b = ox.orb_describe_pixels_plain(*args, strips=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    a2 = ox.orb_describe_plain(*args)
    b2 = ox.orb_describe_pixels_plain(*args)
    assert len(b2) == 2 and all(torch.equal(x, y) for x, y in zip(a2, b2))


def test_restricted_describe_equals_plain_at_bin_edges_and_borders():
    """Every bin, angles near both its edges, patches clamped at every
    border and corner and on images smaller than a patch."""
    _, tab = _tables()
    args = bin_edge_keypoints() + (tab,)
    a = ox.orb_describe_plain(*args, strips=True)
    b = ox.orb_describe_pixels_plain(*args, strips=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    bins = torch.remainder(torch.round(a[0] / ox._TAU).long(), ox.ANGLE_BINS)
    assert set(bins[:-1].tolist()) == set(range(ox.ANGLE_BINS))
    assert float(a[0][-1]) == 0.0
