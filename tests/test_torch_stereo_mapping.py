"""Keyframe events of stereo and RGBD keyframes: the port's mapper against
the JAX package's, from one converted map state, on the CPU.

Both packages run the test plane world (400x300, 4 levels, min_size 400,
baseline 0.12 m; RGBD with a constant 4 m depth map) inline, the JAX System
with its BoW database and loop closer detached and its local-BA shape set
warm at K = 16 (the port's bucket). The JAX System runs until the tracker
queues keyframe 1 and then keyframe 2; at each, its map and its mapper's
state are converted into the port's (convert.map_database,
convert.mapper_state) and both run mapping_with_new_keyframe on it. The
events create the same landmarks (ids and observations), fuse the same
pairs, keep the same keyframes and landmarks, and leave keyframe poses
within 1e-4 and landmark positions within 1e-3.

The camera moves 0.08 m per frame. Keyframe 1's only covisible neighbour,
keyframe 0, lies closer than the camera's baseline (measured 0.069 m
stereo, 0.087 m RGBD, against 0.12 m) but farther than the monocular
parallax gate's 1% of the median depth (4 m): the non-monocular branch of
the triangulation's neighbour check skips it (stella_vslam_tpu/
mapping_module.py:562-564) where the monocular branch would keep it, and
the event triangulates nothing. Keyframe 2's neighbours lie 0.6-1.2 m away
and are used.
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
from tests.synthetic_world import PlaneWorld, lateral_trajectory

torch.set_num_threads(1)

BASELINE = 0.12
N_FRAMES = 20
STEP = 0.08


def _camera(world, setup):
    return dict(world.camera_yaml(), setup=setup, focal_x_baseline=world.fx * BASELINE)


def _snapshot_event(js, cam, kf_j):
    """Run keyframe kf_j's event in both packages from the JAX state."""
    tcam, orb = camera_from_yaml(cam), OrbParams(num_levels=4)
    md = convert.map_database(js.map_db, tcam, orb, device="cpu")
    pm = MappingModule(md, tcam, orb, device="cpu")
    convert.mapper_state(js.mapper, pm)
    kf_p = md.keyframes[kf_j.id]
    dispatched = []
    tri = pm._dispatch_triangulation
    pm._dispatch_triangulation = lambda cur: dispatched.append(tri(cur)) or dispatched[-1]
    covis = kf_p.graph_node.get_top_n_covisibilities(pm.num_covis_tri)
    baselines = [float(np.linalg.norm(kf_p.cam_center - md.keyframes[o].cam_center))
                 for o in covis]
    median_depth = kf_p.compute_median_depth(md)
    next_lm, replaced0 = js.map_db._next_landmark_id, set(js.map_db.replaced_ids)
    js.mapper._queue.get()
    js.mapper.mapping_with_new_keyframe(kf_j)
    pm.mapping_with_new_keyframe(kf_p)
    j = js.map_db
    return dict(md=md, next_lm=next_lm, replaced0=replaced0, jkfs=sorted(j.keyframes),
                jlms=set(j.landmarks), jpos={k: v.pose_cw.copy() for k, v in j.keyframes.items()},
                jobs={i: dict(l.observations) for i, l in j.landmarks.items()},
                jreplaced=dict(j.replaced_ids), jlm_pos=j.fields.pos.copy(),
                triangulated=dispatched[0] is not None, baselines=baselines,
                median_depth=median_depth, true_baseline=tcam.true_baseline,
                mono_ratio=pm.baseline_dist_thr_ratio)


def _run(setup):
    world = PlaneWorld()
    cam = _camera(world, setup)
    js = JSystem(JConfig.from_dict({
        "Camera": cam, "Feature": {"num_levels": 4}, "Preprocessing": {"min_size": 400},
        "Initializer": {"use_fixed_seed": True}}), inline_mapping=True)
    js.mapper.bow_db = None
    js.mapper.global_optimizer = None
    js.mapper._ba_shapes = {(16, L) for L in (2048, 4096, 8192)}
    js.startup()
    Tb = np.eye(4)
    Tb[0, 3] = -BASELINE
    depth = np.full((world.H, world.W), world.depth, np.float32)
    events = {}
    for i, T in enumerate(lateral_trajectory(N_FRAMES, step=STEP)):
        if setup == "stereo":
            frm = js.create_stereo_frame(world.render(T), world.render(Tb @ T), i * 0.05)
        else:
            frm = js.create_RGBD_frame(world.render(T), depth, i * 0.05)
        js.tracker.feed_frame(frm)
        for kf in list(js.mapper._queue.queue):
            if kf.id in (1, 2) and kf.id not in events:
                js.mapper._queue.queue.remove(kf)
                js.mapper._queue.queue.appendleft(kf)
                events[kf.id] = _snapshot_event(js, cam, kf)
        js._drain_mapper_inline()
        if len(events) == 2:
            break
    js.shutdown()
    return events


@pytest.fixture(scope="module", params=["stereo", "RGBD"])
def events(request):
    return request.param, _run(request.param)


@pytest.mark.parametrize("kf_id", [1, 2])
def test_keyframe_event_matches_jax(events, kf_id):
    setup, evs = events
    e = evs[kf_id]
    md = e["md"]
    new_j = {i: o for i, o in e["jobs"].items() if i >= e["next_lm"]}
    new_p = {i: dict(l.observations) for i, l in md.landmarks.items() if i >= e["next_lm"]}
    assert new_p == new_j, setup
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


def test_neighbour_closer_than_the_baseline_is_skipped(events):
    """Keyframe 1: its neighbour is closer than the baseline and skipped, so
    nothing is triangulated; keyframe 2's neighbours are matched and
    triangulated."""
    setup, evs = events
    e1, e2 = evs[1], evs[2]
    assert e1["baselines"] and max(e1["baselines"]) < e1["true_baseline"]
    # the monocular gate would keep it
    assert min(e1["baselines"]) / e1["median_depth"] >= e1["mono_ratio"]
    assert not e1["triangulated"]
    assert min(e2["baselines"]) > e2["true_baseline"] and e2["triangulated"]
    new2 = [i for i in e2["jobs"] if i >= e2["next_lm"]]
    # RGBD keyframes seed a landmark at every keypoint with depth, so the
    # plane leaves nothing to triangulate
    assert len(new2) >= 10 if setup == "stereo" else len(new2) == 0, len(new2)
