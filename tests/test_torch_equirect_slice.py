"""The port's equirectangular slice against the JAX package's, on the CPU.

Both run tests/test_equirect_e2e.py's path cut to 20 frames (BoxWorld at
512x256, 4 levels, min_size 300, translating along x at 0.05 m a frame with
a slight yaw), monocular with mapping on and inline; the port's Initializer
draws the JAX Initializer's RANSAC seeds (tests/test_torch_initializer.py).
(At 256x128 neither package initializes: the area matcher finds fewer
than 50 matches.)

One keyframe event from one map state: the JAX System (its BoW database
and global optimizer detached, as tests/test_torch_mapping.py does) runs
until the tracker queues its first keyframe after the two init keyframes;
its map and mapper state are converted into the port's, and both run
mapping_with_new_keyframe on it: the same new landmarks with the same
observations, the same fusions and kept keyframes, and keyframe poses
within 1e-4.

The slice end to end: the port's own 20-frame run passes
tests/test_equirect_e2e.py's bounds cut to its length (at least 16 frames
tracked, relative Sim3 ATE < 5%, >= 2 keyframes, > 80 landmarks), and its
per-frame camera centres stand within 2 mm of the JAX run's (both start
from the same init pose and scale; measured 0.09 mm, init at frame 3 in
both).
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.mapping_module import MappingModule
from stella_vslam_tpu_torch.util import equirect_slice
from stella_vslam_tpu_torch.util.mono_slice import sim3_ate
from stella_vslam_tpu_torch.util.synthetic import BoxWorld
from tests.test_torch_initializer import jax_seed_source

torch.set_num_threads(1)

N_FRAMES = 20


def e2e_path(n):
    """tests/test_equirect_e2e.py's poses and camera centres."""
    poses, centres = [], []
    for i in range(n):
        T = np.eye(4)
        yaw = 0.004 * i
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        centre = np.array([i * 0.05, 0.002 * i, 0.0])
        T[:3, 3] = T[:3, :3] @ -centre
        poses.append(T)
        centres.append(centre)
    return np.stack(poses), np.stack(centres)


def _cfg(world):
    return {"Camera": world.camera_yaml(), "Feature": {"num_levels": 4},
            "Preprocessing": {"min_size": 300}, "Initializer": {"use_fixed_seed": True}}


def _by_feed_order(slam, n):
    res = slam.frame_poses
    fid0 = res[0][3]
    poses = [None] * n
    for (_, pose, _, fid) in res:
        poses[fid - fid0] = pose
    return poses


@pytest.fixture(scope="module")
def runs():
    world = BoxWorld(width=512, height=256, half=4.0)
    gt, centres = e2e_path(N_FRAMES)
    images = [world.render(T) for T in gt]
    out = {}
    # ---- JAX until its first keyframe after the init pair is queued ----
    js = JSystem(JConfig.from_dict(_cfg(world)), inline_mapping=True)
    js.mapper.bow_db = None
    js.mapper.global_optimizer = None
    js.startup()
    i = 0
    while True:
        js.tracker.feed_frame(js.create_monocular_frame(images[i], i * 0.05))
        queued = list(js.mapper._queue.queue)
        if any(kf.id >= 2 for kf in queued):
            break
        js._drain_mapper_inline()
        i += 1
    kf_j = queued[-1]
    cam, orb = camera_from_yaml(world.camera_yaml()), OrbParams(num_levels=4)
    md = convert.map_database(js.map_db, cam, orb, device="cpu")
    pm = MappingModule(md, cam, orb, device="cpu")
    convert.mapper_state(js.mapper, pm)
    kf_p = md.keyframes[kf_j.id]
    next_lm = js.map_db._next_landmark_id
    replaced0 = set(js.map_db.replaced_ids)
    js.mapper._queue.get()
    js.mapper.mapping_with_new_keyframe(kf_j)
    pm.mapping_with_new_keyframe(kf_p)
    out["event"] = dict(md=md, next_lm=next_lm, replaced0=replaced0,
                        jkfs=sorted(js.map_db.keyframes),
                        jpos={k: v.pose_cw.copy() for k, v in js.map_db.keyframes.items()},
                        jobs={i: dict(l.observations) for i, l in js.map_db.landmarks.items()},
                        jreplaced=dict(js.map_db.replaced_ids))
    for j in range(i + 1, N_FRAMES):
        js.feed_monocular_frame(images[j], j * 0.05)
    js.shutdown()
    out["jax"] = _by_feed_order(js, N_FRAMES)
    # ---- the port end to end, through util/equirect_slice.run_leg ----
    ts = equirect_slice.make_system(world, "cpu", inline_mapping=True, num_levels=4,
                                    min_size=300)
    ts.tracker.initializer.seed_source = jax_seed_source()

    class Stored:
        """The world with the images rendered above."""
        render = staticmethod(lambda T: images[int(np.argmin(
            [np.abs(T - g).max() for g in gt]))])

    out["stats"] = equirect_slice.run_leg("cpu", Stored, gt, centres, slam=ts)
    out["port"] = _by_feed_order(ts, N_FRAMES)
    out["centres"] = centres
    return out


def test_keyframe_event_matches_jax(runs):
    e = runs["event"]
    md = e["md"]
    new_j = {i: o for i, o in e["jobs"].items() if i >= e["next_lm"]}
    new_p = {i: dict(l.observations) for i, l in md.landmarks.items() if i >= e["next_lm"]}
    assert len(new_j) > 20 and new_p == new_j
    rep_j = {k: v for k, v in e["jreplaced"].items() if k not in e["replaced0"]}
    rep_p = {k: v for k, v in md.replaced_ids.items() if k not in e["replaced0"]}
    assert rep_p == rep_j
    assert sorted(md.keyframes) == e["jkfs"]
    for k, kf in md.keyframes.items():
        np.testing.assert_allclose(kf.pose_cw, e["jpos"][k], atol=1e-4)


def test_port_slice_passes_the_e2e_bounds(runs):
    s, centres = runs["stats"], runs["centres"]
    assert s["tracked"] >= N_FRAMES - 4 and s["lost_after_init"] == 0
    assert s["worker_errors"] == 0
    est, gt = [], []
    for pose, c in zip(runs["port"], centres):
        if pose is not None:
            est.append(-pose[:3, :3].T @ pose[:3, 3])
            gt.append(c)
    ate, _ = sim3_ate(np.asarray(est), np.asarray(gt))
    traj_len = np.linalg.norm(np.diff(np.asarray(gt), axis=0), axis=1).sum()
    assert ate / traj_len < 0.05, f"ATE {ate:.3f} m over {traj_len:.2f} m"
    assert s["keyframes_kept"] >= 2 and s["landmarks"] > 80


def test_port_poses_follow_jax(runs):
    pj, pp = runs["jax"], runs["port"]
    assert [p is None for p in pj] == [p is None for p in pp]
    d = max(np.linalg.norm((-a[:3, :3].T @ a[:3, 3]) - (-b[:3, :3].T @ b[:3, 3]))
            for a, b in zip(pj, pp) if a is not None)
    assert d < 2e-3, d
