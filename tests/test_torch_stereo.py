"""The port's stereo path against the JAX package's, on the CPU.

* kernel T's plain version (`stereo_match_plain`) against JAX's
  `stereo_match` on seeded inputs made to hit every branch: keypoints in
  shared row bands, right keypoints with equal descriptors (tied distances:
  the lowest index wins), left rows with no candidate, best shifts at the
  border (0 and 10) and in the middle, constant patches (all shifts tie),
  levels one apart and two apart. Matched flags equal; x_right and depth
  within 1e-5 relative. The filter's SAD sum stays under 2^24, where JAX's
  float32 sum is exact (asserted).
* kernel B's strips (the 11x21 centre of the blurred descriptor patch)
  against JAX's `extract_with_patches` patches: level 0 exactly; on the
  resized levels, whose images differ by at most 7.6e-5 between the
  packages (tests/test_torch_orb.py), a strip value may move by one gray
  level — measured 8 of 147 609 on this pair, bound 1e-4 of them.
* one rendered pair of the test plane world (noise sigma 2, exposure
  drift; baseline 0.12 m) through both packages' pair extraction and
  matcher: measured 719 matched in both and no slot whose matched flag
  differs (bound: 0.5% of the slots); depth within 1e-3 relative where both
  matched (measured 7.5e-5, from a strip value one gray level apart).
* the twin of test_stereo_rgbd.py::test_stereo_depths_accurate on the
  port's System, and the twins of its slow end-to-end tests.
* mapping on by default (as in the JAX package): a `System(cfg)` fed with
  no enable call makes keyframe events.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.camera.base import camera_from_yaml as jcamera_from_yaml
from stella_vslam_tpu.feature.orb_extractor import OrbExtractor as JaxExtractor
from stella_vslam_tpu.feature.orb_params import OrbParams as JaxOrbParams
from stella_vslam_tpu.match.stereo import stereo_match as jax_stereo_match
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.feature import orb_extractor as ox
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.match import stereo as st
from stella_vslam_tpu_torch.system import System
from tests.synthetic_world import PlaneWorld, lateral_trajectory

torch.set_num_threads(1)

BASELINE = 0.12
REL_TOL = 1e-5
PAIR_FLAG_DIFF_MAX = 0.005
PAIR_DEPTH_REL = 1e-3
STRIP_RESIZED_DIFF_MAX = 1e-4


def _strip(patches39) -> np.ndarray:
    """JAX's [N, 1521] patches -> the [N, 11, 21] uint8 strips kernel B writes."""
    p = np.asarray(jnp.asarray(patches39).astype(jnp.float32)).reshape(-1, 39, 39)
    return p[:, 14:25, 9:30].astype(np.uint8)


def _stereo_camera(world):
    cam = world.camera_yaml()
    cam["setup"] = "stereo"
    cam["focal_x_baseline"] = world.fx * BASELINE
    return cam


def seeded_inputs(seed=0, NL=240, NR=260, num_levels=4):
    """Left and right keypoints, descriptors and 39x39 patches that reach
    every branch of the matcher."""
    rng = np.random.default_rng(seed)
    bands = np.array([40.0, 41.5, 90.0, 150.0, 210.0])
    l_y = rng.choice(bands, NL) + rng.uniform(-0.5, 0.5, NL)
    l_y[:12] = 280.0  # no right keypoint in this band: an empty row
    l_xy = np.stack([rng.uniform(60.0, 380.0, NL), l_y], -1).astype(np.float32)
    l_level = rng.integers(0, num_levels, NL).astype(np.int32)
    l_valid = rng.random(NL) < 0.95
    l_desc = rng.integers(0, 2 ** 32, (NL, 8), dtype=np.uint64).astype(np.uint32)
    l_patch = rng.integers(0, 256, (NL, 39, 39)).astype(np.float32)
    l_patch[12:20] = 128.0  # constant patches: every shift ties
    r_xy = np.stack([rng.uniform(0.0, 400.0, NR), rng.choice(bands, NR)], -1)
    r_level = rng.integers(0, num_levels, NR).astype(np.int32)
    r_valid = rng.random(NR) < 0.95
    r_desc = rng.integers(0, 2 ** 32, (NR, 8), dtype=np.uint64).astype(np.uint32)
    r_patch = rng.integers(0, 256, (NR, 39, 39)).astype(np.float32)
    src = rng.permutation(np.arange(12, NL))[:NR - 60]
    for j, i in enumerate(src):
        # a true match of left i: disparity 0..40 px, the same row band,
        # a level 0, 1 or 2 away, a few flipped bits, the patch shifted by
        # s px (s = +-5 puts the best shift at the border)
        r_xy[j] = (l_xy[i, 0] - rng.uniform(0.0, 40.0), l_xy[i, 1] + rng.uniform(-1.0, 1.0))
        r_level[j] = np.clip(l_level[i] + rng.integers(-2, 3), 0, num_levels - 1)
        flips = rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32) \
            & rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32) \
            & rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
        r_desc[j] = l_desc[i] ^ flips
        s = int(rng.choice([-5, -3, 0, 2, 5]))
        r_patch[j] = np.roll(l_patch[i], s, axis=1) + rng.integers(-2, 3, (39, 39))
    # tied distances: a second right keypoint equal to an earlier one
    for j in range(NR - 60, NR - 40):
        r_xy[j], r_level[j], r_desc[j] = r_xy[j - 100], r_level[j - 100], r_desc[j - 100]
        r_valid[j] = True
    l_patch = np.clip(l_patch, 0, 255)
    r_patch = np.clip(r_patch, 0, 255)
    return dict(l_xy=l_xy, l_level=l_level, l_desc=l_desc, l_valid=l_valid, l_patch=l_patch,
                r_xy=r_xy.astype(np.float32), r_level=r_level, r_desc=r_desc,
                r_valid=r_valid, r_patch=r_patch)


def _run_both(inp, num_levels=4):
    cam = _stereo_camera(PlaneWorld())
    jcam, tcam = jcamera_from_yaml(cam), camera_from_yaml(cam)
    sf = np.asarray(OrbParams(num_levels=num_levels).scale_factors, np.float32)
    jx, jd = jax_stereo_match(
        *(jnp.asarray(inp[f"{s}_{k}"]) if k != "patch" else
          jnp.asarray(inp[f"{s}_patch"].reshape(-1, 1521)).astype(jnp.bfloat16)
          for s in ("l", "r") for k in ("xy", "level", "desc", "valid", "patch")),
        scale_factors=jnp.asarray(sf), inv_scale_factors=jnp.asarray(1.0 / sf),
        focal_x_baseline=jcam.params.focal_x_baseline,
        true_baseline=jnp.float32(jcam.true_baseline), num_levels=num_levels)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = []
    for s in ("l", "r"):
        args += [t(inp[f"{s}_xy"]), t(inp[f"{s}_level"]),
                 t(inp[f"{s}_desc"].view(np.int32)), t(inp[f"{s}_valid"]),
                 t(inp[f"{s}_patch"][:, 14:25, 9:30].astype(np.uint8))]
    tx, td = st.stereo_match_plain(*args, scale_factors=t(sf),
                                   focal_x_baseline=tcam.params.focal_x_baseline,
                                   true_baseline=tcam.true_baseline)
    return (np.asarray(jx), np.asarray(jd)), (tx.numpy(), td.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stereo_match_plain_equals_jax(seed):
    inp = seeded_inputs(seed)
    (jx, jd), (tx, td) = _run_both(inp)
    jm, tm = jd > 0, td > 0
    assert 40 <= jm.sum() < len(jm) - 20, jm.sum()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tx[tm], jx[jm], rtol=REL_TOL)
    np.testing.assert_allclose(td[tm], jd[jm], rtol=REL_TOL)
    assert np.all(tx[~tm] == -1.0) and np.all(td[~tm] == -1.0)
    # the filter's SAD sum stays where JAX's float32 sum is exact: each
    # SAD is at most 121 * 255
    assert len(jm) * 121 * 255 < 2 ** 24


def test_stereo_match_branches_are_reached():
    """The seeded inputs reach each branch: rows with no candidate, rows
    whose smallest distance is shared by two right keypoints, candidates
    cut by the level gate, and matched rows whose best shift is at either
    border (0, 10) and inside (numpy, independent of both packages)."""
    inp = seeded_inputs(0)
    sf = np.asarray(OrbParams(num_levels=4).scale_factors, np.float32)
    l_xy, r_xy = inp["l_xy"], inp["r_xy"]
    popc = np.vectorize(lambda v: bin(int(v)).count("1"))
    dist = popc(inp["l_desc"][:, None, :] ^ inp["r_desc"][None, :, :]).sum(-1)
    row = np.abs(r_xy[None, :, 1] - l_xy[:, None, 1]) <= 2 * sf[inp["r_level"]][None]
    disp = l_xy[:, None, 0] - r_xy[None, :, 0]
    lvl = np.abs(inp["l_level"][:, None] - inp["r_level"][None]) <= 1
    base = row & (disp >= 0) & (disp < 458.0) & inp["l_valid"][:, None] & inp["r_valid"][None]
    cand = base & lvl
    assert (~cand.any(1)).sum() >= 12
    assert (base & ~lvl).any()
    d = np.where(cand, dist, 257)
    best = d.min(1)
    assert ((d == best[:, None]).sum(1)[best < 75] >= 2).any()
    shifts = []
    for i in np.nonzero(best < 75)[0]:
        lp = inp["l_patch"][i, 14:25, 14:25]
        rp = inp["r_patch"][int(np.argmin(d[i]))][14:25]
        sad = [np.abs(lp - rp[:, 9 + k:20 + k]).sum() for k in range(11)]
        shifts.append(int(np.argmin(sad)))
    assert {0, 10} <= set(shifts) and any(0 < k < 10 for k in shifts)


@pytest.fixture(scope="module")
def pair_setup():
    world = PlaneWorld(noise_sigma=2.0, exposure_amp=0.06)
    T = np.eye(4)
    Tb = np.eye(4)
    Tb[0, 3] = -BASELINE
    left, right = world.render(T), world.render(Tb @ T)
    jex = JaxExtractor(JaxOrbParams(num_levels=4), 400, 300, min_area=400)
    tex = ox.OrbExtractor(OrbParams(num_levels=4), 400, 300, min_area=400, device="cpu",
                          tables=convert.extractor_tables(jex))
    jpair = jex.extract_pair_with_patches(left, right)
    tpair = tex.extract_pair_with_patches(torch.from_numpy(left), torch.from_numpy(right))
    return world, tex, jpair, tpair


def test_strips_match_jax_patches(pair_setup):
    _, tex, jpair, tpair = pair_setup
    n0 = tex.levels[0].Gy * tex.levels[0].Gx
    for (jf, jp), (tf, ts) in zip(jpair, tpair):
        valid = np.asarray(jf.valid)
        js, ts = _strip(jp).astype(np.int32), ts.numpy().astype(np.int32)
        np.testing.assert_array_equal(ts[:n0][valid[:n0]], js[:n0][valid[:n0]])
        d = np.abs(ts[n0:] - js[n0:])[valid[n0:]]
        assert d.max() <= 1 and (d > 0).mean() <= STRIP_RESIZED_DIFF_MAX, (d > 0).sum()


def test_pair_matching_agrees_with_jax(pair_setup):
    world, _, ((jfl, jpl), (jfr, jpr)), ((tfl, tsl), (tfr, tsr)) = pair_setup
    cam = _stereo_camera(world)
    jcam, tcam = jcamera_from_yaml(cam), camera_from_yaml(cam)
    sf = np.asarray(OrbParams(num_levels=4).scale_factors, np.float32)
    jx, jd = jax_stereo_match(
        jfl.xy, jfl.level, jfl.desc, jfl.valid, jpl, jfr.xy, jfr.level, jfr.desc, jfr.valid,
        jpr, scale_factors=jnp.asarray(sf), inv_scale_factors=jnp.asarray(1.0 / sf),
        focal_x_baseline=jcam.params.focal_x_baseline,
        true_baseline=jnp.float32(jcam.true_baseline), num_levels=4)
    tx, td = st.stereo_match(
        tfl.xy, tfl.level, tfl.desc, tfl.valid, tsl, tfr.xy, tfr.level, tfr.desc, tfr.valid,
        tsr, scale_factors=torch.from_numpy(sf), focal_x_baseline=tcam.params.focal_x_baseline,
        true_baseline=tcam.true_baseline)
    jd, td = np.asarray(jd), td.numpy()
    jm, tm = jd > 0, td > 0
    assert jm.sum() > 300
    assert (jm != tm).mean() <= PAIR_FLAG_DIFF_MAX, (jm != tm).sum()
    both = jm & tm
    np.testing.assert_allclose(td[both], jd[both], rtol=PAIR_DEPTH_REL)
    assert abs(np.median(td[tm]) - world.depth) < 0.05


def stereo_cfg(world):
    d = {"Camera": _stereo_camera(world), "Feature": {"num_levels": 4},
         "Preprocessing": {"min_size": 400}, "Initializer": {"use_fixed_seed": True}}
    return Config.from_dict(d)


def render_pair(world, T):
    Tb = np.eye(4)
    Tb[0, 3] = -BASELINE
    return world.render(T), world.render(Tb @ T)


def test_stereo_depths_accurate():
    world = PlaneWorld()
    imgs = render_pair(world, np.eye(4))
    slam = System(stereo_cfg(world), device="cpu", inline_mapping=True)
    slam.startup()
    slam.feed_stereo_frame(imgs[0], imgs[1], 0.0)
    slam.tracker.finalize_pending()
    assert slam.map_db.num_keyframes() == 1
    kf = next(iter(slam.map_db.keyframes.values()))
    d = kf.h_depths
    good = d[d > 0]
    assert len(good) > 80, f"only {len(good)} stereo depths"
    frac_close = (np.abs(good - world.depth) < 0.25).mean()
    assert frac_close > 0.75, f"depth accuracy {frac_close:.2f}"
    assert abs(np.median(good) - world.depth) < 0.05
    slam.shutdown()


def test_system_maps_by_default():
    """As in the JAX package (tests/test_slam_e2e.py), `System(cfg)` maps
    without an enable call: every setup starts with mapping enabled, and an
    RGBD run queues and maps keyframes."""
    world = PlaneWorld()
    for setup in ("monocular", "stereo", "RGBD"):
        cam = dict(_stereo_camera(world), setup=setup)
        slam = System(Config.from_dict({"Camera": cam, "Feature": {"num_levels": 4},
                                        "Preprocessing": {"min_size": 400}}),
                      device="cpu", inline_mapping=True)
        assert slam.mapping_module_is_enabled(), setup
    slam.startup()
    depth = np.full((world.H, world.W), world.depth, np.float32)
    for i, T in enumerate(lateral_trajectory(3, step=0.03)):
        slam.feed_RGBD_frame(world.render(T), depth, i * 0.05)
    slam.shutdown()
    assert slam.mapper.num_processed >= 2 and len(slam.keyframe_event_ms) >= 2


@pytest.mark.slow
def test_stereo_slam_tracks_metric_scale():
    world = PlaneWorld()
    n = 25
    poses = lateral_trajectory(n, step=0.03)
    slam = System(stereo_cfg(world), device="cpu", inline_mapping=True)
    slam.startup()
    for i, T in enumerate(poses):
        l, r = render_pair(world, T)
        slam.feed_stereo_frame(l, r, i * 0.05)
    slam.shutdown()
    by_ts = {round(ts / 0.05): pose for (ts, pose, _, _) in slam.frame_poses}
    tracked = [i for i in range(n) if by_ts.get(i) is not None]
    assert len(tracked) >= n - 2, f"tracked {len(tracked)}/{n}"
    i0, i1 = tracked[0], tracked[-1]
    c = lambda T: -T[:3, :3].T @ T[:3, 3]
    est = np.linalg.norm(c(by_ts[i1]) - c(by_ts[i0]))
    gt = np.linalg.norm(c(poses[i1]) - c(poses[i0]))
    assert abs(est - gt) / gt < 0.08, f"scale error: est {est:.3f} vs gt {gt:.3f}"


@pytest.mark.slow
def test_rgbd_slam_instant_map():
    world = PlaneWorld()
    cam = dict(_stereo_camera(world), setup="rgbd")
    cfg = Config.from_dict({"Camera": cam, "Feature": {"num_levels": 4},
                            "Preprocessing": {"min_size": 400}})
    slam = System(cfg, device="cpu", inline_mapping=True)
    slam.startup()
    depth_map = np.full((world.H, world.W), world.depth, np.float32)
    for i, T in enumerate(lateral_trajectory(10, step=0.03)):
        slam.feed_RGBD_frame(world.render(T), depth_map, i * 0.05)
    slam.shutdown()
    assert slam.map_db.num_keyframes() >= 1
    assert slam.map_db.num_landmarks() > 80
    tracked = sum(1 for (_, p, _, _) in slam.frame_poses if p is not None)
    assert tracked >= 8
