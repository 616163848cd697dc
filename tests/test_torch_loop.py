"""The port's loop closer against the JAX package's, on the CPU.

The slice as a whole, from one map state: the JAX System runs the test
plane world monocular and inline (400x300, 4 levels, min_size 400,
lateral_trajectory) until it holds at least 4 keyframes; its map, BoW
database and vocabulary are converted into the port's (convert.map_database,
convert.bow_database, convert.bow_vocabulary); both then run
`request_loop_closure(kf_a, kf_b)` on the newest keyframe and its strongest
covisibility, with the same PnP seed (the JAX detector's next key, summed as
ransac._seed_from_key does). That runs the whole path in both: brute-force
match, PnP RANSAC, three rounds of pose optimization with two projection
rematches, the centroid scale, the Sim3 refinement, the correction of the
covisible keyframes and their landmarks, the replacement and fusion of
duplicates, the loop edges, the Sim3 pose graph and the global bundle
adjustment. A third run converts the same state once more and closes the
same loop with the port's global BA sharded over four CPU shards
(`ba_devices`), against the same JAX run.

Tolerances: the validated Sim3 within 1e-4 (s, R, t; the same matched slots
and inliers); the same landmarks replaced and added (ids, observations and
keyframe slots equal); the same loop edges and pose-graph edge list;
keyframe poses within 1e-4 and landmark positions within 1e-3 after the
pose graph and the global BA (float32 sums in another order; measured 2.4e-7
and 7.0e-6).

A port-only loop closure end to end on tests/test_loop_closure.py's world
(out and back with injected drift) is marked slow, like its JAX twin.
"""
import jax
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.ops.solve import ransac as jransac
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.global_optimization_module import GlobalOptimizationModule
from stella_vslam_tpu_torch.mapping_module import MappingModule
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util.drift import inject_segment_drift, pose_at_x
from stella_vslam_tpu_torch.util.mono_slice import trajectory_stats
from tests.synthetic_world import PlaneWorld, lateral_trajectory
from tests.test_torch_initializer import cfg_dict

torch.set_num_threads(1)

MAX_FRAMES = 90


def _spy(obj, name, log):
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        log.append(a)
        return fn(*a, **kw)

    setattr(obj, name, wrapped)


def _map_state(md):
    return dict(
        kf_poses={k: kf.pose_cw.copy() for k, kf in md.keyframes.items()},
        kf_slots={k: kf.lm_ids.copy() for k, kf in md.keyframes.items()},
        lm_obs={i: dict(lm.observations) for i, lm in md.landmarks.items()},
        lm_pos={i: np.array(lm.pos_w) for i, lm in md.landmarks.items()},
        replaced=dict(md.replaced_ids),
        loop_edges={k: set(kf.graph_node.loop_edges) for k, kf in md.keyframes.items()},
        connections={k: dict(kf.graph_node.connections) for k, kf in md.keyframes.items()})


@pytest.fixture(scope="module")
def runs():
    world = PlaneWorld()
    gt = lateral_trajectory(MAX_FRAMES)
    js = JSystem(JConfig.from_dict(cfg_dict(world)), inline_mapping=True)
    js.mapper._ba_shapes = {(16, L) for L in (2048, 4096, 8192)}
    js.startup()
    n = 0
    while js.map_db.num_keyframes() < 4 and n < MAX_FRAMES:
        js.feed_monocular_frame(world.render(gt[n]), n * 0.05)
        n += 1
    js.tracker.finalize_pending()
    jmd = js.map_db
    assert jmd.num_keyframes() >= 4, f"{jmd.num_keyframes()} keyframes after {n} frames"
    assert js.global_optimizer.num_loops_closed == 0
    kf_a = max(jmd.keyframes)
    kf_b = jmd.keyframes[kf_a].graph_node.get_top_n_covisibilities(1)[0]

    # ---- the same state in the port, twice: its global BA unsharded, and
    # sharded over 4 CPU shards (the JAX global BA runs sharded over the 8
    # virtual devices of tests/conftest.py) ----
    cam, orb = camera_from_yaml(world.camera_yaml()), OrbParams(num_levels=4)
    # the JAX detector's next PnP seed
    jd = js.global_optimizer.loop_detector
    seed = int(np.asarray(jransac._seed_from_key(jax.random.split(jd._key)[1])))

    def port_state(ba_devices):
        md = convert.map_database(jmd, cam, orb, device="cpu")
        vocab = convert.bow_vocabulary(js.bow_vocab, device="cpu")
        bow_db = convert.bow_database(js.bow_db, vocab)
        go = GlobalOptimizationModule(md, cam, orb, bow_db, device="cpu", use_fixed_seed=True)
        go.mapper = MappingModule(md, cam, orb, device="cpu")
        go.loop_detector.next_seed = seed
        go.ba_devices = ba_devices
        assert set(bow_db.bow_vecs) == set(jmd.keyframes)
        return md, go

    (md, go), (md4, go4) = port_state(None), port_state(["cpu"] * 4)
    before = _map_state(md)
    shards = []
    _spy(go4, "run_global_bundle_adjustment", shards)

    jlog, plog = [], []
    _spy(js.global_optimizer, "correct_loop", jlog)
    _spy(go, "correct_loop", plog)
    ok_j = js.global_optimizer.request_loop_closure(kf_a, kf_b)
    ok_p = go.request_loop_closure(kf_a, kf_b)
    ok_4 = go4.request_loop_closure(kf_a, kf_b)
    return dict(ok=(ok_j, ok_p, ok_4), jlog=jlog, plog=plog, before=before, pair=(kf_a, kf_b),
                j=_map_state(jmd), p=_map_state(md), p4=_map_state(md4),
                jgo=js.global_optimizer, go=go, go4=go4, sharded_bas=len(shards), frames=n)


def test_validation_matches_jax(runs):
    assert runs["ok"] == (True, True, True)
    (_, cj, sim_j, slot_j, inl_j), (_, cp, sim_p, slot_p, inl_p) = runs["jlog"][0], runs["plog"][0]
    assert cj == cp == runs["pair"][1]
    assert abs(float(sim_j[0]) - float(sim_p[0])) < 1e-4
    assert np.abs(np.asarray(sim_j[1]) - sim_p[1]).max() < 1e-4
    assert np.abs(np.asarray(sim_j[2]) - sim_p[2]).max() < 1e-4
    assert np.array_equal(np.asarray(inl_j), inl_p) and int(inl_p.sum()) >= 40
    assert np.array_equal(np.asarray(slot_j)[inl_p], slot_p[inl_p])
    # two views of one map: the loop transform is the identity scale
    assert abs(float(sim_p[0]) - 1.0) < 0.02


def test_correction_replaces_and_adds_the_same_landmarks(runs):
    j, p, b = runs["j"], runs["p"], runs["before"]
    assert p["replaced"] == j["replaced"]
    assert set(p["lm_obs"]) == set(j["lm_obs"])
    assert p["lm_obs"] == j["lm_obs"]
    for k in p["kf_slots"]:
        assert np.array_equal(p["kf_slots"][k], j["kf_slots"][k]), k
    # something happened: observations were added or landmarks replaced
    changed = sum(1 for i, o in p["lm_obs"].items() if o != b["lm_obs"].get(i))
    assert changed + len(set(p["replaced"]) - set(b["replaced"])) > 0


def test_loop_edges_and_pose_graph_edges_match_jax(runs):
    a, c = runs["pair"]
    assert runs["p"]["loop_edges"] == runs["j"]["loop_edges"]
    assert c in runs["p"]["loop_edges"][a] and a in runs["p"]["loop_edges"][c]
    assert runs["p"]["connections"] == runs["j"]["connections"]
    ej, ep = runs["jgo"]._last_pose_graph_edges, runs["go"]._last_pose_graph_edges
    assert ep == ej
    assert (min(a, c), max(a, c)) in ep["loop_edges"] and len(ep["edges"]) >= 3
    assert runs["go"].num_loops_closed == 1 and not runs["go"].loop_ba_running


def test_poses_and_landmarks_after_pose_graph_and_global_ba(runs):
    j, p, b = runs["j"], runs["p"], runs["before"]
    d_pose = max(np.abs(p["kf_poses"][k] - j["kf_poses"][k]).max() for k in p["kf_poses"])
    d_lm = max(np.abs(p["lm_pos"][i] - j["lm_pos"][i]).max() for i in p["lm_pos"])
    print(f"after pose graph and global BA: keyframe poses within {d_pose:.3g}, "
          f"landmarks within {d_lm:.3g}")
    assert d_pose < 1e-4 and d_lm < 1e-3
    # the correction and the optimizers moved the map
    moved = max(np.abs(p["kf_poses"][k] - b["kf_poses"][k]).max() for k in p["kf_poses"])
    assert moved > 1e-6


def test_sharded_global_ba_loop_closure_matches_jax(runs):
    """The same loop closure with the port's global BA sharded over 4 CPU
    shards (ba_devices): the same landmarks and edges, and poses and
    landmarks after the pose graph and the global BA within the unsharded
    port's bounds of JAX's (measured 3.4e-7 and 7.4e-6; unsharded 2.4e-7
    and 7.0e-6)."""
    j, p4 = runs["j"], runs["p4"]
    assert runs["sharded_bas"] >= 1 and runs["go4"].num_loops_closed == 1
    assert p4["replaced"] == j["replaced"] and p4["lm_obs"] == j["lm_obs"]
    assert p4["loop_edges"] == j["loop_edges"]
    d_pose = max(np.abs(p4["kf_poses"][k] - j["kf_poses"][k]).max() for k in p4["kf_poses"])
    d_lm = max(np.abs(p4["lm_pos"][i] - j["lm_pos"][i]).max() for i in p4["lm_pos"])
    print(f"sharded global BA: keyframe poses within {d_pose:.3g}, landmarks within {d_lm:.3g}")
    assert d_pose < 1e-4 and d_lm < 1e-3


@pytest.mark.slow
def test_port_loop_closure_end_to_end():
    """Out and back with injected drift (tests/test_loop_closure.py's run)
    through the port alone: the loop is detected and closed, a loop edge is
    registered, the frame after the correction tracks, and one similarity
    aligns the whole trajectory to ground truth within 0.10 m (an unclosed
    map aligns no better than 0.25 m; measured 0.021 m)."""
    world = PlaneWorld(width=400, height=300, fx=320.0, depth=4.0, tex_size=2048,
                       meters_per_px=0.01)
    slam = System(Config.from_dict(cfg_dict(world)), device="cpu", inline_mapping=True)
    slam.enable_mapping_module()
    slam.startup()
    xs_out = [i * 0.1 for i in range(65)]
    xs_back = [6.4 - i * 0.1 for i in range(1, 45)] + [2.0 - i * 0.05 for i in range(1, 61)]
    t = 0.0
    for x in xs_out:
        slam.feed_monocular_frame(world.render(pose_at_x(x)), t)
        t += 0.2
    assert slam.tracker.state == "Tracking"
    inject_segment_drift(slam, tx_metric=0.55, yaw_deg=3.0, cutoff_frac=0.3, gt_span_metric=6.4)
    loop_frame = None
    for i, x in enumerate(xs_back):
        n = slam.global_optimizer.num_loops_closed
        slam.feed_monocular_frame(world.render(pose_at_x(x)), t)
        if slam.global_optimizer.num_loops_closed > n and loop_frame is None:
            loop_frame = len(xs_out) + i
        t += 0.2
    slam.shutdown()
    assert slam.global_optimizer.num_loops_closed >= 1
    assert any(kf.graph_node.loop_edges for kf in slam.map_db.keyframes.values())
    poses = slam.frame_poses
    assert poses[loop_frame + 1][1] is not None
    _, tracked, lost, ate, _ = trajectory_stats(poses, [(x, 0.0) for x in xs_out + xs_back])
    assert tracked >= 100 and lost <= 2
    assert ate < 0.10, f"trajectory inconsistent after the loop: {ate:.3f} m"
