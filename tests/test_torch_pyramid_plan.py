"""Kernel S's plan (the whole pyramid in one launch, tile by tile of the
coarsest level) and its arithmetic, on the CPU.

- `pyramid_plan` at the shapes the port runs (752x480 at 8 levels, 640x320
  at 6, 1280x720 at 8, 1920x960 at 6) and at hypothesis-drawn sizes and
  scale factors: the owned intervals partition every level on each axis,
  each computed interval holds its owned one and both taps of every row
  (column) of the computed interval one level up, and the buffers fit the
  card's shared memory.
- A torch emulation of the kernel's tile walk (`tile_walk`: level 0's
  computed rectangle staged, each level computed over its computed
  rectangle from the level above's with `resize_level_taps_plain`, only
  the owned pixels written) equals `resize_level_taps_plain` over whole
  levels bit for bit, every pixel written once, for one image and a pair.
- The two-tap form against the matmul pyramids: torch's CPU matmul (the
  port's CPU path) and JAX's jitted `(R @ x) @ C.T` (XLA's CPU dot), with
  the differing pixels counted against stated bounds and kernel A's cell
  keys held.
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
from stella_vslam_tpu_torch.util.drift import pose_at_xy
from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

torch.set_num_threads(1)

SHAPES = [(752, 480, 8), (640, 320, 6), (1280, 720, 8), (1920, 960, 6)]
# pixels of levels 1-7 of a 752x480 bench frame (756,407) whose two-tap
# value differs from torch's CPU matmul pyramid: 188 and 136 on the two
# frames below
TORCH_MATMUL_DIFF_MAX = 250
# ... and from JAX's jitted matmul pyramid on the CPU (XLA's dot rounds
# each product apart): 147,861 and 147,197, a few ulps each
JAX_MATMUL_DIFF_SHARE = 0.2
MATMUL_MAX_ABS = 1e-4


def plan_of(params: OrbParams, width: int, height: int, min_area: int = 800):
    """The extractor's levels, level steps and kernel S plan, without the
    rest of its tables."""
    levels = ox.level_geometry(params, width, height, min_area, 19)
    steps = []
    for a, b in zip(levels[:-1], levels[1:]):
        R, C = ox._resize_matrices(a.H, a.W, b.H, b.W)
        (rj, rw), (cj, cw) = ox.resize_taps(R), ox.resize_taps(C)
        t = torch.as_tensor
        steps.append(ox.ResizeLevel(t(R), t(C).T.contiguous(), t(rj), t(rw), t(cj), t(cw)))
    off = np.concatenate([[0], np.cumsum([g.H * g.W for g in levels])[:-1]]).tolist()
    return levels, steps, ox.pyramid_plan(levels, off, steps, "cpu")


def check_axis(plan: np.ndarray, sizes, taps):
    L = len(sizes)
    for l in range(L):
        own = plan[:, l, :2]
        assert own[0, 0] == 0 and own[-1, 1] == sizes[l]
        np.testing.assert_array_equal(own[1:, 0], own[:-1, 1])
        assert np.all(own[:, 1] >= own[:, 0])
        comp = plan[:, l, 2:]
        assert np.all(comp[:, 0] <= own[:, 0]) and np.all(comp[:, 1] >= own[:, 1])
        assert np.all(comp[:, 0] >= 0) and np.all(comp[:, 1] <= sizes[l])
        assert np.all(comp[:, 1] > comp[:, 0])
        if l:
            j = taps[l - 1]
            for t in range(plan.shape[0]):
                used = j[comp[t, 0]:comp[t, 1]]
                assert used.min() >= plan[t, l - 1, 2] and used.max() < plan[t, l - 1, 3]


def check_plan(levels, steps, plan):
    check_axis(plan.rows, [g.H for g in levels], [s.row_j.numpy() for s in steps])
    check_axis(plan.cols, [g.W for g in levels], [s.col_j.numpy() for s in steps])
    assert plan.smem_bytes + ox.STATIC_SMEM_S <= ox.MAX_SMEM_S == 227 * 1024


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_plan_partitions_and_covers(shape):
    w, h, L = shape
    levels, steps, plan = plan_of(OrbParams(num_levels=L), w, h)
    check_plan(levels, steps, plan)
    assert plan.tile in ox.TILES and plan.block_rows in ox.BLOCK_ROWS
    if shape == (752, 480, 8):
        # 9 x 14 tiles of 16 on the 210x134 level, a block of 32 x 32 threads
        # for one image, of 32 x 16 for a pair (the fastest measured)
        assert (plan.tile, plan.block_rows) == (16, 32)
        assert plan.rows.shape[0] * plan.cols.shape[0] == 126
        pair = ox.pyramid_plan(levels, np.concatenate(
            [[0], np.cumsum([g.H * g.W for g in levels])[:-1]]).tolist(), steps, "cpu", batch=2)
        assert (pair.tile, pair.block_rows) == (16, 16)


@settings(max_examples=40, deadline=None)
@given(st.integers(60, 2200), st.integers(60, 1400), st.integers(1, 12),
       st.floats(1.05, 2.0))
def test_plan_partitions_and_covers_drawn(w, h, L, sf):
    levels, steps, plan = plan_of(OrbParams(num_levels=L, scale_factor=sf), w, h, 400)
    check_plan(levels, steps, plan)


def test_plan_refuses_a_layout_that_does_not_fit():
    levels, steps, _ = plan_of(OrbParams(num_levels=12, scale_factor=2.0), 3000, 3000, 400)
    off = np.concatenate([[0], np.cumsum([g.H * g.W for g in levels])[:-1]]).tolist()
    with pytest.raises(ValueError, match="3000x3000"):
        ox.pyramid_plan(levels, off, steps, "cpu", tile=64)


def tile_walk(images: torch.Tensor, plan: ox.PyramidPlan):
    """Kernel S's walk in torch: per (tile, image) the computed rectangles
    level by level, the owned pixels written. Returns the flat pyramids
    and how often each pixel was written."""
    B = images.shape[0]
    out = torch.full((B, plan.size), float("nan"))
    hits = torch.zeros((B, plan.size), dtype=torch.int32)
    for b in range(B):
        for r in plan.rows:
            for c in plan.cols:
                buf = images[b, r[0, 2]:r[0, 3], c[0, 2]:c[0, 3]].to(torch.float32)
                for l, (g, off) in enumerate(zip(plan.levels, plan.level_off)):
                    if l:
                        s = plan.steps[l - 1]
                        rs, cs = slice(r[l, 2], r[l, 3]), slice(c[l, 2], c[l, 3])
                        buf = ox.resize_level_taps_plain(buf, s._replace(
                            row_j=s.row_j[rs] - int(r[l - 1, 2]), row_w=s.row_w[rs],
                            col_j=s.col_j[cs] - int(c[l - 1, 2]), col_w=s.col_w[cs]))
                    view = out[b, off:off + g.H * g.W].view(g.H, g.W)
                    hv = hits[b, off:off + g.H * g.W].view(g.H, g.W)
                    oy, ox_ = slice(r[l, 0], r[l, 1]), slice(c[l, 0], c[l, 1])
                    view[oy, ox_] = buf[r[l, 0] - r[l, 2]:r[l, 1] - r[l, 2],
                                        c[l, 0] - c[l, 2]:c[l, 1] - c[l, 2]]
                    hv[oy, ox_] += 1
    return out, hits


@pytest.fixture(scope="module")
def bench():
    world = bench_world()
    images = [world.render(pose_at_xy(x, 0.0)) for x in (0.6, 3.0)]
    jex = JaxExtractor(JaxOrbParams(num_levels=8), 752, 480, min_area=800)
    tex = ox.OrbExtractor(OrbParams(num_levels=8), 752, 480, min_area=800, device="cpu",
                          tables=convert.extractor_tables(jex))
    return images, jex, tex


@pytest.mark.parametrize("batch", [1, 2], ids=["one image", "a pair"])
def test_tile_walk_equals_whole_levels(bench, batch):
    images, _, tex = bench
    imgs = torch.from_numpy(np.stack(images[:batch]))
    out, hits = tile_walk(imgs, tex.pyramid_plan_for(batch))
    assert bool((hits == 1).all())
    for b in range(batch):
        whole = torch.cat([x.reshape(-1) for x in tex.pyramid_taps_plain(imgs[b])])
        assert torch.equal(out[b], whole)


def test_tile_walk_equals_whole_levels_f32_input():
    """An f32 input (the rectifier's) at a ragged size and 5 levels."""
    levels, steps, plan = plan_of(OrbParams(num_levels=5), 401, 299, 400)
    img = torch.from_numpy(np.random.default_rng(3).random((1, 299, 401), np.float32) * 255)
    out, hits = tile_walk(img, plan)
    assert bool((hits == 1).all())
    x, whole = img[0], [img[0].reshape(-1)]
    for s in steps:
        x = ox.resize_level_taps_plain(x, s)
        whole.append(x.reshape(-1))
    assert torch.equal(out[0], torch.cat(whole))


def test_taps_plain_against_matmul_pyramids(bench):
    images, jex, tex = bench
    thr = (float(tex.params.ini_fast_thr), float(tex.params.min_fast_thr))
    jit_levels = jax.jit(lambda x: [x := (R @ x) @ C.T for R, C in jex._resize_mats])
    for img in images:
        taps = tex.pyramid_taps_plain(torch.from_numpy(img))
        cpu = tex.pyramid_plain(torch.from_numpy(img))
        jl = [np.asarray(x) for x in jit_levels(jnp.asarray(img, jnp.float32))]
        n = sum(a.numel() for a in taps[1:])
        assert n == 756407
        d_torch = sum(int((a != b).sum()) for a, b in zip(taps[1:], cpu[1:]))
        d_jax = sum(int((a.numpy() != b).sum()) for a, b in zip(taps[1:], jl))
        assert 0 < d_torch <= TORCH_MATMUL_DIFF_MAX
        assert d_jax <= JAX_MATMUL_DIFF_SHARE * n
        assert max(float((a - b).abs().max()) for a, b in zip(taps[1:], cpu[1:])) \
            <= MATMUL_MAX_ABS
        assert max(float(np.abs(a.numpy() - b).max()) for a, b in zip(taps[1:], jl)) \
            <= MATMUL_MAX_ABS
        for a, b, g in zip(taps, cpu, tex.levels):
            assert torch.equal(ox.fast_nms_plain(a, g, tex.border, *thr),
                               ox.fast_nms_plain(b, g, tex.border, *thr))


def test_cpu_pyramid_is_the_matmul_form(bench):
    """On the CPU, resize_pyramid copies level 0 and runs the two matmuls a
    level, the JAX version's form."""
    images, _, tex = bench
    imgs = torch.from_numpy(np.stack(images))
    pyr = tex.pyramid_flat(imgs)
    before = ox.resize_pyramid.launches
    for b, img in enumerate(images):
        want = torch.cat([x.reshape(-1) for x in tex.pyramid_plain(torch.from_numpy(img))])
        assert torch.equal(pyr[b], want)
    assert ox.resize_pyramid.launches == before
