"""The port's monocular System against the JAX System, end to end, on the CPU.

Both run monocular with mapping disabled (the JAX mapper detached, as the
port has none) on the same rendered frames of the test plane world
(400x300, 4 levels, min_size 400, 12 frames of lateral_trajectory at
0.03 m/frame). The port runs its plain CPU versions of kernels A-I, and its
Initializer takes the RANSAC seeds the JAX Initializer derives from its
fixed-seed key stream (tests/test_torch_initializer.py jax_seed_source).
Both must initialize at frame 5 and track the same 7 of 12 frames.

The poses do not agree to float precision, and cannot: the port's
extraction matches JAX's to its stated tolerances (level-0 FAST exact,
descriptor bit mismatch ~1e-6, angles ~2e-7 rad), which is enough to move
one area match at frames 3-4 (135 vs 136 matches), and the frame-5
initialization then sees a different match set. The scene is a plane, so
the F model that the cost ratio picks is near-degenerate and its E
decomposition swings with the match set. Given the same frames the two
Initializers agree to 1.7e-5 (tests/test_torch_initializer.py). Measured
here: camera centres 0.022 apart (map units: the init pair's median depth,
~4 m), rotations 1.27 deg apart, 82 vs 130 landmarks, and Sim3 ATE against
the ground truth 23.2 mm (JAX) and 6.3 mm (port). Bounds, ~2x the measured
gaps: centres within 0.05, rotations within 2.5 deg; the port's Sim3 ATE
at most the JAX run's plus 10 mm.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util.mono_slice import sim3_ate
from tests.synthetic_world import PlaneWorld, lateral_trajectory
from tests.test_torch_initializer import cfg_dict, jax_seed_source

torch.set_num_threads(1)

N_FRAMES = 12


def _by_feed_order(slam, n):
    res = slam.frame_poses
    fid0 = res[0][3]
    out = [None] * n
    for (_, pose, _, fid) in res:
        out[fid - fid0] = pose
    return out


@pytest.fixture(scope="module")
def runs():
    world = PlaneWorld()
    images = [world.render(T) for T in lateral_trajectory(N_FRAMES, step=0.03)]
    jslam = JSystem(JConfig.from_dict(cfg_dict(world)), inline_mapping=True)
    jslam.disable_mapping_module()
    jslam.tracker.mapper = None  # the mapper's pass must not touch the map
    jslam.startup()
    tslam = System(Config.from_dict(cfg_dict(world)), device="cpu")
    tslam.tracker.initializer.seed_source = jax_seed_source()
    tslam.disable_mapping_module()
    tslam.startup()
    for i, img in enumerate(images):
        jslam.feed_monocular_frame(img, i * 0.05)
        tslam.feed_monocular_frame(img, i * 0.05)
    jslam.shutdown()
    tslam.shutdown()
    return _by_feed_order(jslam, N_FRAMES), _by_feed_order(tslam, N_FRAMES), jslam, tslam


def test_same_frames_tracked(runs):
    jp, tp, _, _ = runs
    tracked_j = [p is not None for p in jp]
    tracked_t = [p is not None for p in tp]
    assert tracked_j == tracked_t
    assert tracked_t.index(True) == 5 and sum(tracked_t) == 7


def _centres(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses if p is not None])


def test_poses_match_jax(runs):
    jp, tp, jslam, tslam = runs
    for a, b in zip(jp, tp):
        if a is None:
            continue
        ca = -a[:3, :3].T @ a[:3, 3]
        cb = -b[:3, :3].T @ b[:3, 3]
        assert np.linalg.norm(ca - cb) < 0.05
        cosang = np.clip((np.trace(a[:3, :3] @ b[:3, :3].T) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cosang)) < 2.5
    assert tslam.map_db.num_keyframes() == jslam.map_db.num_keyframes() == 2
    assert tslam.map_db.num_landmarks() >= 50


def test_sim3_ate_within_jax(runs):
    jp, tp, _, _ = runs
    gt = lateral_trajectory(N_FRAMES, step=0.03)
    tracked = [i for i, p in enumerate(jp) if p is not None]
    g = _centres([gt[i] for i in tracked])
    ate_j, _ = sim3_ate(_centres(jp), g)
    ate_t, _ = sim3_ate(_centres(tp), g)
    assert ate_t <= ate_j + 0.010, (ate_t, ate_j)


def test_map_erasure_and_local_table(runs):
    """The map's erase functions and its covisibility-local device table,
    on the port's two-keyframe map: erasing a landmark unlinks it from both
    keyframes, the spanning root cannot be erased, erasing the other
    keyframe drops its observations, and the table centred on the root
    then holds the root's landmarks only."""
    _, _, _, tslam = runs
    md = tslam.map_db
    root, other = md.spanning_roots[0], max(md.keyframes)
    assert root != other
    n = md.num_landmarks()
    md.refresh_device_table(center_kf_id=other, max_local_keyframes=60)
    snap = md.device_table.snap
    assert snap.count == n
    assert set(snap.ids[:n].tolist()) == set(md.landmarks)

    lm_id = next(iter(md.landmarks))
    md.erase_landmark(lm_id)
    assert lm_id not in md.landmarks and md.num_landmarks() == n - 1
    for kf in md.keyframes.values():
        assert lm_id not in kf.lm_ids.tolist()

    md.erase_keyframe(root)
    assert root in md.keyframes
    md.erase_keyframe(other)
    assert set(md.keyframes) == {root}
    assert all(list(lm.observations) == [root] for lm in md.landmarks.values())

    md.refresh_device_table(center_kf_id=root, max_local_keyframes=60)
    root_lms = md.keyframes[root].lm_ids
    snap = md.device_table.snap
    assert snap.count == (root_lms >= 0).sum() == n - 1
    assert set(snap.ids[:snap.count].tolist()) == set(root_lms[root_lms >= 0].tolist())


def test_reset_restarts_initialization(runs):
    """After reset the tracker initializes anew: the map is cleared, and
    the next frame becomes the initializer's first frame."""
    _, _, _, tslam = runs
    tr = tslam.tracker
    tr.reset()
    assert tr.state == "Initializing" and tslam.map_db.num_keyframes() == 0
    assert tr.initializer.init_frame is None
    world = PlaneWorld()
    tslam.feed_monocular_frame(world.render(lateral_trajectory(1)[0]), 10.0)
    assert tr.initializer.init_frame is not None and tr.state == "Initializing"
