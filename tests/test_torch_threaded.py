"""The port's default, threaded System on the CPU.

(i) Both packages' default System (pipelined tracker and finalize thread,
mapping and loop-closing threads running) in RGBD mode with mapping
disabled, on tests/test_torch_slice.py's 10 frames: the pipelined dispatch
and finalize with no table publish. Held to that file's bounds: camera
centres within 2e-4 m, rotations within 0.1 deg, the port's rigid ATE at
most the JAX run's plus 1 mm.

(ii) The twin of tests/test_threaded_pipeline.py: the port's default System
monocular with mapping on, 60 frames of lateral_trajectory, 4 levels,
min_size 400, with the pause barrier exercised at frame 40. What that file
asserts about the orchestration holds (initialized before frame 15, at most
2 frames lost, no event stranded at shutdown, no pending BA, a local BA ran,
the publisher's times set), and also: no worker thread contained an
exception, and the chain was rebased on the device at least once (a table
published while frames were in flight).

Its ATE bound is measured: 5 runs of the fixture's run, side by side with
two more pytest workers (the tier-1 command's -n 6 load), read relative
Sim3 ATEs of 2.599 / 2.602 / 2.602 / 2.602 / 3.426 % of the path length
(the last run inserted 4 keyframes and ran 2 local BAs where the others
inserted 5 and ran 3: the threads' interleaving moves keyframe decisions).
The bound is 7 %, twice the worst reading.

(iii) With mapping disabled the pipelined tracker gives the inline
tracker's poses on the same frames: the dispatches see the same chained
state in the same order.

(iv) A keyframe decision made before a loop correction inserts nothing
after it.
"""
import threading
import types

import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.system import System
from tests.synthetic_world import PlaneWorld, lateral_trajectory, umeyama_align
from tests.test_torch_initializer import cfg_dict
from tests.test_torch_slice import _ate, _by_feed_order, _cfg

torch.set_num_threads(1)

ATE_REL_BOUND = 0.07


def _rgbd_run(slam, images, depth):
    slam.disable_mapping_module()
    slam.startup()
    for i, img in enumerate(images):
        slam.feed_RGBD_frame(img, depth, i * 0.05)
    slam.shutdown()
    return _by_feed_order(slam, len(images))


@pytest.fixture(scope="module")
def rgbd_runs():
    """(ground truth, JAX threaded, port threaded, port inline, port threaded
    System)."""
    world = PlaneWorld()
    gt = lateral_trajectory(10, step=0.03)
    images = [world.render(T) for T in gt]
    depth = np.full((world.H, world.W), 20000, np.uint16)
    jslam = JSystem(JConfig.from_dict(_cfg(world)))
    jslam.tracker.mapper = None  # the mapper's pass must not touch the map
    tslam = System(Config.from_dict(_cfg(world)), device="cpu")
    islam = System(Config.from_dict(_cfg(world)), device="cpu", inline_mapping=True)
    return (gt, _rgbd_run(jslam, images, depth), _rgbd_run(tslam, images, depth),
            _rgbd_run(islam, images, depth), tslam)


def test_threaded_rgbd_slice_matches_jax(rgbd_runs):
    gt, jp, tp, _, tslam = rgbd_runs
    assert not tslam.inline_mapping and tslam.worker_errors == 0
    assert sum(p is not None for p in jp) == 10
    assert sum(p is not None for p in tp) == 10
    for a, b in zip(jp, tp):
        ca = -a[:3, :3].T @ a[:3, 3]
        cb = -b[:3, :3].T @ b[:3, 3]
        assert np.linalg.norm(ca - cb) < 2e-4
        cosang = np.clip((np.trace(a[:3, :3] @ b[:3, :3].T) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cosang)) < 0.1
    assert _ate(tp, gt) <= _ate(jp, gt) + 1e-3


def test_pipelined_tracker_gives_inline_poses(rgbd_runs):
    _, _, tp, ip, _ = rgbd_runs
    for a, b in zip(tp, ip):
        assert a is not None and b is not None
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


class _LateDevice:
    """Stands for a CUDA event on the CPU, where a dispatch has finished
    when it returns: the finalize thread waits on it until `delay_s` has
    passed, as it would on a device that runs behind the host."""

    def __init__(self, delay_s: float):
        self._done = threading.Event()
        threading.Timer(delay_s, self._done.set).start()

    def synchronize(self):
        self._done.wait()


def _hold_in_flight(tracker, frame_ids, delay_s: float = 1.0):
    """Frames with these ids stay in flight for delay_s after dispatch."""
    dispatch = tracker._dispatch

    def held(frm, snap=None):
        p = dispatch(frm, snap)
        if p is not None and frm.id in frame_ids:
            p.event = _LateDevice(delay_s)
        return p

    tracker._dispatch = held


def run_mono(n: int = 60, hold_frame: int = 30):
    """The threaded monocular run; frame `hold_frame` stays in flight while
    a table is published (the mapper's publish, here at the caller), so
    the next dispatch finds the chain stale with a frame in flight."""
    world = PlaneWorld()
    poses_gt = lateral_trajectory(n)
    slam = System(Config.from_dict(cfg_dict(world)), device="cpu")
    slam.enable_mapping_module()
    slam.startup()
    for i, T in enumerate(poses_gt):
        if i == hold_frame:
            frm = slam.create_monocular_frame(world.render(T), i * 0.05)
            _hold_in_flight(slam.tracker, {frm.id})
            slam.tracker.feed_frame(frm)
            slam.map_db.refresh_device_table(center_kf_id=slam.tracker.ref_keyfrm_id)
        else:
            slam.feed_monocular_frame(world.render(T), i * 0.05)
        if i == 40:
            # the pause barrier: the staged event and the pending BA settle
            # before is_paused flips (the loop closer relies on the order)
            slam.pause_other_threads()
            assert slam.mapper.is_paused()
            assert slam.mapper._event is None
            assert slam.mapper._pending_ba is None
            slam.resume_other_threads()
    slam.shutdown()
    by_ts = {round(ts / 0.05): pose for (ts, pose, _, _) in slam.frame_poses}
    return slam, poses_gt, [by_ts.get(i) for i in range(n)]


def relative_ate(poses_gt, results) -> float:
    """Sim3 ATE over the tracked frames, relative to the path length."""
    est = np.array([-p[:3, :3].T @ p[:3, 3] for p in results if p is not None])
    gt = np.array([-T[:3, :3].T @ T[:3, 3] for T, p in zip(poses_gt, results)
                   if p is not None])
    assert len(est) >= 30
    aligned, _ = umeyama_align(est, gt)
    ate = np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1)))
    return float(ate / np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())


@pytest.fixture(scope="module")
def mono_run():
    return run_mono()


def test_threaded_mono_tracks_and_maps(mono_run):
    slam, _, results = mono_run
    tracked = [r is not None for r in results]
    first = tracked.index(True)
    assert first < 15, f"initialized too late: frame {first}"
    assert sum(1 for t in tracked[first:] if not t) <= 2
    assert slam.map_db.num_keyframes() >= 2 and slam.map_db.num_landmarks() > 80
    # no keyframe event stranded in the staged slot or the queue
    assert slam.mapper._event is None and slam.mapper._queue.empty()
    assert slam.mapper.num_processed >= 2
    assert slam.mapper._pending_ba is None and len(slam.mapper.local_ba_ms) >= 1
    assert slam.frame_publisher.extraction_time_ms > 0.0
    assert slam.frame_publisher.tracking_time_ms > 0.0
    assert slam.worker_errors == 0, slam.worker_error_log
    # a table was published while frames were in flight, and the chain
    # followed it on the device
    assert slam.tracker.num_rebases >= 1


def test_threaded_mono_ate(mono_run):
    _, poses_gt, results = mono_run
    rel = relative_ate(poses_gt, results)
    assert rel < ATE_REL_BOUND, f"relative ATE {rel:.2%}"


def test_no_keyframe_from_a_frame_tracked_before_a_correction():
    """A keyframe decision made before a loop correction (which bumps the
    map epoch) does not insert the frame after it: its pose is in the gauge
    from before the correction."""
    world = PlaneWorld()
    slam = System(Config.from_dict(cfg_dict(world)), device="cpu")
    tr = slam.tracker
    inserted = []

    def insert(map_db, frm):
        inserted.append(frm)
        return types.SimpleNamespace(id=7)

    tr.keyfrm_inserter.insert_new_keyframe = insert
    tr._insert_pending = ("before", slam.map_db.epoch)
    slam.map_db.bump_epoch()
    tr._drain_insert()
    assert inserted == [] and tr._insert_pending is None and not tr._insert_busy
    tr._insert_pending = ("after", slam.map_db.epoch)
    tr._drain_insert()
    assert inserted == ["after"] and tr.ref_keyfrm_id == 7
