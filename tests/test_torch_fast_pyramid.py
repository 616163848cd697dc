"""Kernel A's pyramid form in the port (plain CPU versions) against the JAX
package, and the pieces of its CUDA design that run on the CPU.

- `fast_nms_pyramid_plain` (every level's FAST + cell NMS, the slots'
  px / py / valid / response in the extractor's layout) against JAX's
  `OrbExtractor._process_level` on the same level images, exactly: xy,
  response, valid and level at 320x240 with 4 levels, without a mask,
  with a seeded random mask and with the half-image mask, and for a batch
  of two images.
- `fast_arc_corner`, the plain twin of the kernel's early reject (compass
  points, then a circular run of 9 in the 16-bit masks d > t and d < -t),
  against `fast_score_map(img) > t` over every bright and every dark ring
  pattern, with ring differences exactly at +-t and one step past it, and
  over random and hypothesis-drawn images.
- `fast_work_list`: the kernel's work items cover every border-region pixel
  of every level exactly once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stella_vslam_tpu.feature.orb_extractor import OrbExtractor as JaxExtractor
from stella_vslam_tpu.feature.orb_params import OrbParams as JaxOrbParams
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.feature import orb_extractor as ox
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from tests.synthetic_world import PlaneWorld, lateral_trajectory

torch.set_num_threads(1)

W, H, LEVELS = 320, 240, 4


@pytest.fixture(scope="module")
def setup():
    world = PlaneWorld(width=W, height=H, noise_sigma=2.0, exposure_amp=0.06)
    images = [world.render(T) for T in lateral_trajectory(3, step=0.03)[1:]]
    jex = JaxExtractor(JaxOrbParams(num_levels=LEVELS), W, H, min_area=400)
    tex = ox.OrbExtractor(OrbParams(num_levels=LEVELS), W, H, min_area=400, device="cpu",
                          tables=convert.extractor_tables(jex))
    fns = [jax.jit(lambda im, mk, g=g, lvl=lvl: jex._process_level(im, mk, g, lvl)[0])
           for lvl, g in enumerate(jex.levels)]
    return images, jex, tex, fns


def jax_levels(jex, img):
    """The JAX extractor's level images of img, (R @ x) @ C^T per level."""
    x = jnp.asarray(img, jnp.float32)
    out = [x]
    for R, C in jex._resize_mats:
        x = (R @ x) @ C.T
        out.append(x)
    return out


def jax_slots(jex, fns, levels, mask):
    """(xy, response, valid, level) of every slot from JAX's _process_level
    (jitted, as the extractor runs it) on the given level images, levels
    concatenated."""
    m = None if mask is None else jnp.asarray(mask) != 0
    outs = [fn(x, m) for fn, x in zip(fns, levels)]
    return [np.concatenate([np.asarray(o[i]) for o in outs]) for i in (0, 1, 4, 3)]


def masks():
    half = np.ones((H, W), np.uint8)
    half[:, : W // 2] = 0
    rnd = (np.random.default_rng(11).random((H, W)) > 0.3).astype(np.uint8)
    return {"none": None, "half": half, "random": rnd}


@pytest.mark.parametrize("which", ["none", "half", "random"])
def test_pyramid_plain_equals_jax(setup, which):
    """A batch of two images through fast_nms_pyramid_plain against JAX
    image by image, on the JAX package's own level images."""
    images, jex, tex, fns = setup
    mask = masks()[which]
    lv = [jax_levels(jex, img) for img in images]
    pyr = torch.stack([torch.cat([torch.from_numpy(np.array(x)).reshape(-1) for x in l])
                       for l in lv])
    assert pyr.shape[1] == tex.pyramid_size
    p = tex.params
    key, px, py, valid, resp = ox.fast_nms_pyramid(
        pyr, tex._fast, float(p.ini_fast_thr), float(p.min_fast_thr),
        None if mask is None else torch.from_numpy(mask))
    scale = tex._slot_scale
    for b, l in enumerate(lv):
        jxy, jresp, jvalid, jlevel = jax_slots(jex, fns, l, mask)
        xy = torch.stack([px[b].float() * scale, py[b].float() * scale], -1)
        np.testing.assert_array_equal(xy.numpy(), jxy)
        np.testing.assert_array_equal(resp[b].numpy(), jresp)
        np.testing.assert_array_equal(valid[b].numpy(), jvalid)
        np.testing.assert_array_equal(tex._slot_level.numpy(), jlevel)
        np.testing.assert_array_equal(valid[b].numpy(), key[b].numpy() >= 0)
        assert 0 < int(valid[b].sum()) < tex.num_slots


def test_extract_batch_takes_the_pyramid_slots(setup):
    """A pair's slots (xy, response, level, valid) are each image's alone,
    and fast_nms_pyramid's."""
    images, _, tex, _ = setup
    single = [tex.extract(torch.from_numpy(img)) for img in images]
    (fl, _), (fr, _) = tex.extract_pair_with_patches(*[torch.from_numpy(i) for i in images])
    pyr = tex.pyramid_flat(torch.from_numpy(np.stack(images)))
    p = tex.params
    _, px, py, valid, resp = ox.fast_nms_pyramid(pyr, tex._fast, float(p.ini_fast_thr),
                                                 float(p.min_fast_thr))
    for b, (a, f) in enumerate(((single[0], fl), (single[1], fr))):
        for name in ("xy", "response", "level", "valid"):
            assert torch.equal(getattr(a, name), getattr(f, name))
        assert torch.equal(a.valid, valid[b]) and torch.equal(a.response, resp[b])
        assert torch.equal(a.xy[:, 0], px[b].float() * tex._slot_scale)
        assert torch.equal(a.xy[:, 1], py[b].float() * tex._slot_scale)


def ring_image(d):
    """A 7x7 image of zeros whose FAST ring around the centre holds d [16]
    (so the ring differences are d exactly)."""
    return tile(np.asarray(d, np.float32)[None])[0]


def tile(rings):
    """Rings [n, 16] as ring_image blocks of 7x7 side by side in one image
    (a ring never reaches a neighbouring block's centre): the image and the
    blocks' centres (rows, cols)."""
    n = len(rings)
    cols = int(np.ceil(np.sqrt(n)))
    rows = (n + cols - 1) // cols
    img = np.zeros((7 * rows, 7 * cols), np.float32)
    cy, cx = 7 * (np.arange(n) // cols) + 3, 7 * (np.arange(n) % cols) + 3
    for k, (dx, dy) in enumerate(ox._FAST_OFFSETS):
        img[cy + dy, cx + dx] = rings[:, k]
    return img, (cy, cx)


def reject_agrees(img, t):
    """fast_arc_corner equal to fast_score_map > t over the whole image;
    the corners it finds."""
    x = torch.from_numpy(img)
    got = ox.fast_arc_corner(x, t)
    assert torch.equal(got, ox.fast_score_map(x) > t)
    return int(got.sum())


@pytest.mark.parametrize("t", [7.0, 20.0])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_early_reject_every_ring_pattern(t, sign):
    """All 2^16 patterns of ring pixels past the threshold (d = t + 1, the
    rest exactly at t or at 0), bright and dark, each at a centre of its own
    7x7 block: the reject is score > t at the centre and everywhere else."""
    pats = np.arange(1 << 16)
    bits = (pats[:, None] >> np.arange(16)) & 1
    # the patterns holding a circular run of 9
    runs = np.zeros(len(pats), bool)
    for k in range(16):
        runs |= np.all(bits[:, (k + np.arange(9)) % 16] == 1, axis=1)
    for rest in (t, 0.0):
        d = np.where(bits == 1, t + 1.0, rest) * sign
        found = 0
        for chunk, run in zip(np.array_split(d, 16), np.array_split(runs, 16)):
            img, (cy, cx) = tile(chunk.astype(np.float32))
            found += reject_agrees(img, t)
            got = ox.fast_arc_corner(torch.from_numpy(img), t)[cy, cx]
            np.testing.assert_array_equal(got.numpy(), run)
        assert found >= int(runs.sum()) > 0


def test_early_reject_at_the_threshold():
    """Ring differences exactly at +-t, one float step past it and one
    before it, arcs of 8, 9 and 10 at every start, mixed signs."""
    t = 7.0
    vals = [t, np.nextafter(np.float32(t), np.float32(99)), np.nextafter(np.float32(t),
                                                                         np.float32(0)), t + 1]
    rings = []
    for start in range(16):
        for n in (8, 9, 10):
            for v in vals:
                for sign in (1.0, -1.0):
                    d = np.full(16, -sign * 3.0)
                    for j in range(n):
                        d[(start + j) % 16] = sign * v
                    rings.append(d)
    img, _ = tile(np.asarray(rings, np.float32))
    assert reject_agrees(img, t) > 0


def test_early_reject_random_images():
    rng = np.random.default_rng(5)
    for scale in (4.0, 12.0, 40.0):
        img = (128 + rng.normal(scale=scale, size=(64, 80))).round().astype(np.float32)
        for t in (7.0, 20.0):
            reject_agrees(img, t)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(-30, 30), min_size=16, max_size=16),
       st.sampled_from([7.0, 20.0]))
def test_early_reject_hypothesis(d, t):
    reject_agrees(ring_image(np.asarray(d, np.float32)), t)


@pytest.mark.parametrize("size,levels,min_area", [((752, 480), 8, 800), ((640, 320), 6, 800),
                                                  ((1280, 720), 8, 800), ((320, 240), 4, 400),
                                                  ((97, 61), 3, 3000)])
def test_work_list_covers_every_region_pixel_once(size, levels, min_area):
    w, h = size
    geo = ox.level_geometry(OrbParams(num_levels=levels), w, h, min_area, 19)
    work = ox.fast_work_list(geo, 19)
    assert work[0, 0] == 0 and np.all(np.diff(work[:, 0]) >= 0)  # level 0 first
    assert work[:, 3].min() >= 1 and work[:, 3].max() <= ox.MAX_CELLS
    for lvl, g in enumerate(geo):
        hits = np.zeros((g.H, g.W), np.int32)
        for _, cy, cx, n in work[work[:, 0] == lvl]:
            assert cx + n <= g.Gx and cy < g.Gy
            y0, x0 = 19 + cy * g.cs, 19 + cx * g.cs
            hits[y0:min(y0 + g.cs, g.H - 19), x0:min(x0 + n * g.cs, g.W - 19)] += 1
        region = np.zeros_like(hits)
        region[19:g.H - 19, 19:g.W - 19] = 1
        np.testing.assert_array_equal(hits, region)
    tex = ox.OrbExtractor(OrbParams(num_levels=levels), w, h, min_area=min_area, device="cpu")
    np.testing.assert_array_equal(tex._fast.work.numpy(), work)
    assert tex._fast.smem_words * 4 <= 48 * 1024
