"""The port's mapping module against the JAX package's, on the CPU.

Both run the test plane world monocular with mapping enabled and inline
(400x300, 4 levels, min_size 400, 40 frames of lateral_trajectory, the
base-map run of tests/conftest.py). The JAX System has its BoW database and
global optimizer detached (the port has neither) and its local-BA shape
set warm at K = 16 (the port's bucket). The port's Initializer draws the
JAX Initializer's RANSAC seeds (tests/test_torch_initializer.py).

One keyframe event from one map state: the JAX System runs until the
tracker queues its first keyframe after the two init keyframes; its map and
its mapper's state are converted into the port's (convert.map_database,
convert.mapper_state); both then assemble and run the local BA of that
keyframe, and both run mapping_with_new_keyframe on it:
* the local BA problems are identical, and the BA (3 robust + 6 plain
  iterations at K = 16, L = 2048, D = 12) gives poses within 1e-4, points
  within 1e-3 and the same outlier flags;
* the event creates the same landmarks (ids and observations), fuses the
  same pairs, keeps the same keyframes and landmarks, and leaves keyframe
  poses within 1e-4 (measured 1.7e-6) and landmark positions within 1e-3
  (8.1e-5).
The JAX run then continues to frame 40, and the fusion of its last event's
fresh landmarks (settle_fresh_fuse) runs on the JAX map and on its
conversion: the same fusions.

The slice end to end: the port's own 40-frame run, held to
tests/test_slam_e2e.py's bounds (initialized before frame 15, no frame lost
after init, >= 2 keyframes, > 80 landmarks, relative ATE < 6.5%). The two
runs are compared by these bounds, not frame by frame: an in-tolerance
extraction difference moves the init pose (ROADMAP Queue 3). Measured: JAX
init at frame 6, 34 tracked, 3 keyframes, 642 landmarks, relative ATE
5.48%; the port (its RANSAC seeds JAX's) init at frame 6, 34 tracked, 3
keyframes, 691 landmarks, relative ATE 5.45%, one local BA. The keyframe
event from one state: 185 new landmarks and 52 fusions in both; the local
BA (532 landmark rows) gives poses within 6.7e-7 and points within 1.0e-4
of JAX's; the settled fresh fusion, 50 replacements in both.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.module.tracking_kernels import make_cam_scalars as jcam_scalars
from stella_vslam_tpu.ops.optim import ba as jba
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.mapping_module import MappingModule
from stella_vslam_tpu_torch.ops.optim import ba
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util.mono_slice import sim3_ate
from tests.synthetic_world import PlaneWorld, lateral_trajectory
from tests.test_torch_initializer import cfg_dict, jax_seed_source

import jax.numpy as jnp

torch.set_num_threads(1)

N_FRAMES = 40


def _jax_system(world):
    js = JSystem(JConfig.from_dict(cfg_dict(world)), inline_mapping=True)
    js.mapper.bow_db = None
    js.mapper.global_optimizer = None
    js.mapper._ba_shapes = {(16, L) for L in (2048, 4096, 8192)}
    js.startup()
    return js


def _port_from_jax(js, world):
    cam, orb = camera_from_yaml(world.camera_yaml()), OrbParams(num_levels=4)
    md = convert.map_database(js.map_db, cam, orb, device="cpu")
    pm = MappingModule(md, cam, orb, device="cpu")
    convert.mapper_state(js.mapper, pm)
    return md, pm


@pytest.fixture(scope="module")
def runs():
    world = PlaneWorld()
    gt = lateral_trajectory(N_FRAMES)
    images = [world.render(T) for T in gt]
    out = {}
    # ---- JAX until its first keyframe after the init pair is queued ----
    js = _jax_system(world)
    i = 0
    while True:
        js.tracker.feed_frame(js.create_monocular_frame(images[i], i * 0.05))
        queued = list(js.mapper._queue.queue)
        if any(kf.id >= 2 for kf in queued):
            break
        js._drain_mapper_inline()
        i += 1
    kf_j = queued[-1]
    md, pm = _port_from_jax(js, world)
    kf_p = md.keyframes[kf_j.id]
    # ---- the local BA of that keyframe, assembled by both ----
    (pack, K, L, D), jl, jk, _, _ = js.mapper._assemble_local_ba(kf_j)
    pprob, pl, pk, _ = pm._assemble_local_ba(kf_p)
    jprob = jba.unpack_problem(jnp.asarray(pack), K, L, D)
    jres = jba.bundle_adjust_packed(jnp.asarray(pack), jcam_scalars(js.camera), K=K, L=L,
                                    D=D, num_first=3, num_second=6)
    pres = ba.bundle_adjust(pprob, pm.cam_scalars, num_first=3, num_second=6)
    out["ba"] = dict(jprob=jprob, pprob=pprob, ids=(jl, jk, pl, pk), jres=jres, pres=pres)
    # ---- the keyframe event from the same state ----
    next_lm = js.map_db._next_landmark_id
    replaced0 = set(js.map_db.replaced_ids)
    js.mapper._queue.get()
    js.mapper.mapping_with_new_keyframe(kf_j)
    pm.mapping_with_new_keyframe(kf_p)
    out["event"] = dict(js_md=js.map_db, md=md, next_lm=next_lm, replaced0=replaced0,
                        jkfs=sorted(js.map_db.keyframes), jlms=set(js.map_db.landmarks),
                        jpos={k: v.pose_cw.copy() for k, v in js.map_db.keyframes.items()},
                        jobs={i: dict(l.observations) for i, l in js.map_db.landmarks.items()},
                        jreplaced=dict(js.map_db.replaced_ids),
                        jlm_pos=js.map_db.fields.pos.copy())
    # ---- JAX on to the end, then the last event's fresh fusion on both ----
    for j in range(i + 1, N_FRAMES):
        js.feed_monocular_frame(images[j], j * 0.05)
    js.tracker.finalize_pending()
    md2, pm2 = _port_from_jax(js, world)
    replaced1 = set(js.map_db.replaced_ids)
    js.mapper.settle_fresh_fuse()
    pm2.settle_fresh_fuse()
    out["settle"] = dict(j={k: v for k, v in js.map_db.replaced_ids.items() if k not in replaced1},
                         p={k: v for k, v in md2.replaced_ids.items() if k not in replaced1},
                         jlms=set(js.map_db.landmarks), plms=set(md2.landmarks))
    js.shutdown()
    out["jax_e2e"] = _by_feed_order(js, N_FRAMES)
    # ---- the port end to end ----
    ts = System(Config.from_dict(cfg_dict(world)), device="cpu", inline_mapping=True)
    ts.tracker.initializer.seed_source = jax_seed_source()
    ts.enable_mapping_module()
    ts.startup()
    for j, img in enumerate(images):
        ts.feed_monocular_frame(img, j * 0.05)
    ts.shutdown()
    out["port_e2e"] = _by_feed_order(ts, N_FRAMES)
    out["port"] = ts
    out["gt"] = gt
    return out


def _by_feed_order(slam, n):
    res = slam.frame_poses
    fid0 = res[0][3]
    poses = [None] * n
    for (_, pose, _, fid) in res:
        poses[fid - fid0] = pose
    return poses, slam.map_db.num_keyframes(), slam.map_db.num_landmarks()


def test_local_ba_matches_jax(runs):
    r = runs["ba"]
    jl, jk, pl, pk = r["ids"]
    assert jl == pl and jk == pk
    jp, pp = r["jprob"], r["pprob"]
    assert tuple(pp.obs_cam.shape) == (2048, 12) and pp.cam_R.shape[0] == 16
    for name in ("cam_R", "cam_t", "cam_fixed", "cam_valid", "lm_pos", "lm_valid", "obs_cam",
                 "obs_uv", "obs_x_right", "obs_inv_sigma_sq", "obs_valid"):
        np.testing.assert_array_equal(getattr(pp, name).numpy(),
                                      np.asarray(getattr(jp, name)).astype(
                                          getattr(pp, name).numpy().dtype), err_msg=name)
    jr, pr = r["jres"], r["pres"]
    np.testing.assert_allclose(pr.cam_R.numpy(), np.asarray(jr.cam_R), atol=1e-4)
    np.testing.assert_allclose(pr.cam_t.numpy(), np.asarray(jr.cam_t), atol=1e-4)
    nl = sum(1 for x in pl if x >= 0)
    assert nl > 100
    np.testing.assert_allclose(pr.lm_pos.numpy()[:nl], np.asarray(jr.lm_pos)[:nl], atol=1e-3)
    np.testing.assert_array_equal(pr.obs_is_outlier.numpy(), np.asarray(jr.obs_is_outlier))


def test_keyframe_event_matches_jax(runs):
    e = runs["event"]
    md = e["md"]
    new_j = {i: o for i, o in e["jobs"].items() if i >= e["next_lm"]}
    new_p = {i: dict(l.observations) for i, l in md.landmarks.items() if i >= e["next_lm"]}
    assert len(new_j) > 50 and new_p == new_j
    rep_j = {k: v for k, v in e["jreplaced"].items() if k not in e["replaced0"]}
    rep_p = {k: v for k, v in md.replaced_ids.items() if k not in e["replaced0"]}
    assert rep_p == rep_j
    assert sorted(md.keyframes) == e["jkfs"]
    assert set(md.landmarks) == e["jlms"]
    for i, lm in md.landmarks.items():
        assert lm.observations == e["jobs"][i]
    for k, kf in md.keyframes.items():
        np.testing.assert_allclose(kf.pose_cw, e["jpos"][k], atol=1e-4)
    ids = sorted(md.landmarks)
    np.testing.assert_allclose(md.fields.pos[ids], e["jlm_pos"][ids], atol=1e-3)


def test_settle_fresh_fuse_matches_jax(runs):
    s = runs["settle"]
    assert s["p"] == s["j"] and s["plms"] == s["jlms"]


def test_port_slam_initializes_and_tracks(runs):
    poses, _, _ = runs["port_e2e"]
    tracked = [p is not None for p in poses]
    first = tracked.index(True)
    assert first < 15, f"initialized too late: frame {first}"
    assert all(tracked[first:]), "tracking lost after initialization"


def test_port_map_grows(runs):
    _, n_kf, n_lm = runs["port_e2e"]
    assert n_kf >= 2 and n_lm > 80
    assert len(runs["port"].local_ba_ms) >= 1


def _rel_ate(poses, gt):
    est = np.array([-p[:3, :3].T @ p[:3, 3] for p in poses if p is not None])
    g = np.array([-T[:3, :3].T @ T[:3, 3] for T, p in zip(gt, poses) if p is not None])
    ate, _ = sim3_ate(est, g)
    return ate / np.linalg.norm(np.diff(g, axis=0), axis=1).sum(), len(est)


def test_port_trajectory_ate(runs):
    rel, n = _rel_ate(runs["port_e2e"][0], runs["gt"])
    rel_j, _ = _rel_ate(runs["jax_e2e"][0], runs["gt"])
    assert n >= 20
    assert rel < 0.065, (rel, rel_j)
