"""A frame tracked across two map epochs keeps one gauge.

The threaded mono circuit on an H100 (scripts/torch_rgbd_leg_repeat.py --leg
threaded) reported one frame 0.36-0.51 m off after the alignment in 5 of 40
runs, each the frame dispatched right after a loop correction: the
correction published its table (epoch e+1), and before the tracker's next
dispatch the detached global BA's writeback bumped the map to epoch e+2
without having published yet. The dispatch read the correction's table, but
its chain (the last frame's associated landmark positions and poses) was
still in the gauge from before the correction; the host resync was skipped,
since the host map was already past that table, and the frame tracked in the
old gauge while its relative pose was anchored on the table's (corrected)
keyframe pose.

Here the interleaving is built deterministically on the CPU: a monocular
System (inline) tracks the plane world; then the whole map is moved by a
rigid transform W under an epoch bump and published (the correction), the
epoch is bumped again without a publish (the writeback), and the next frame
is fed. The repaired tracker moves its chain into the table's gauge on the
device (kernel Q's rebase, here its plain version): that frame's reported
camera centre lies within 2 frame steps of the line through its
neighbours. With the rebase and the drop of the chain disabled (the
tracker before the repair) the same frame is reported off by the size of
W's translation. When the correction's table lacks the chain's anchor
keyframe the chain cannot be rebased: the tracker drops its associations and
moves its poses into the table's gauge by another keyframe both tables hold,
and the frame reads as right as with the rebase.
"""
import numpy as np
import torch

from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util.drift import pose_at_xy
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld

torch.set_num_threads(1)

SHIFT = np.array([0.5, 0.1, 0.0])  # the gauge move's translation, in map units
N_BEFORE, N_AFTER = 24, 4


def _move_map(slam, W):
    """Every keyframe and landmark into the world frame X' = W X."""
    md = slam.map_db
    W_inv = np.linalg.inv(W)
    for kf in md.keyframes.values():
        kf.set_pose_cw(kf.pose_cw @ W_inv)
    for lm in md.landmarks.values():
        lm.pos_w = W[:3, :3] @ lm.pos_w + W[:3, 3]


def _run(repaired: bool, drop_anchor: bool = False):
    world = PlaneWorld(width=400, height=300, fx=320.0, depth=4.0, tex_size=2048,
                       meters_per_px=0.01)
    cfg = Config.from_dict({"Camera": world.camera_yaml(), "Feature": {"num_levels": 4},
                            "Preprocessing": {"min_size": 400},
                            "Initializer": {"use_fixed_seed": True},
                            "LoopDetector": {"enabled": False}})
    slam = System(cfg, device="cpu", inline_mapping=True)
    slam.startup()
    tr, md = slam.tracker, slam.map_db
    if not repaired:
        tr._try_rebase_chain = lambda snap: False
        tr._drop_chain = lambda snap: True
    drops = []
    drop = tr._drop_chain

    def drop_rec(snap):
        drops.append(snap.version)
        return drop(snap)
    tr._drop_chain = drop_rec
    xs = [i * 0.02 for i in range(N_BEFORE + 1 + N_AFTER)]
    for i in range(N_BEFORE):
        slam.feed_monocular_frame(world.render(pose_at_xy(xs[i], 0.0)), i * 0.05)
    assert tr.state == "Tracking" and md.num_keyframes() >= 2
    W = np.eye(4)
    a = 0.05
    W[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    W[:3, 3] = SHIFT
    with md.lock:  # the correction: an epoch bump, the map moved, its table
        md.bump_epoch()
        _move_map(slam, W)
    md.refresh_device_table(center_kf_id=tr.ref_keyfrm_id)
    if drop_anchor:  # the anchor keyframe left out of the correction's table
        del md.device_table.snap.kf_poses[tr._chain_anchor[0]]
    md.bump_epoch()  # the global BA's writeback, before its publish
    k = N_BEFORE
    slam.feed_monocular_frame(world.render(pose_at_xy(xs[k], 0.0)), k * 0.05)
    md.refresh_device_table(center_kf_id=tr.ref_keyfrm_id)  # the writeback's table
    for i in range(k + 1, len(xs)):
        slam.feed_monocular_frame(world.render(pose_at_xy(xs[i], 0.0)), i * 0.05)
    slam.shutdown()
    poses = slam.frame_poses
    fid0 = poses[0][3]
    centre = {fid - fid0: -p[:3, :3].T @ p[:3, 3] for (_, p, _, fid) in poses if p is not None}
    assert {k - 1, k, k + 1} <= set(centre)
    # the frame against the straight line through its neighbours (the
    # motion is uniform; one frame's step is ~0.02 m in the map's scale)
    mid = 0.5 * (centre[k - 1] + centre[k + 1])
    step = float(np.linalg.norm(centre[k + 1] - centre[k - 1])) / 2
    return float(np.linalg.norm(centre[k] - mid)), step, tr.num_rebases, len(drops)


def test_frame_tracked_across_two_epochs_keeps_its_gauge():
    off, step, rebases, drops = _run(repaired=True)
    assert rebases == 1 and drops == 0
    # measured on a CPU: 0.54 of a step (the tracking's own scatter)
    assert off < 2 * step, (off, step)


def test_without_the_repair_the_frame_reads_in_the_old_gauge():
    off, step, rebases, _ = _run(repaired=False)
    assert rebases == 0
    # the old gauge is |SHIFT| = 0.51 map units away, ~130 frame steps
    # (measured on a CPU: 0.511)
    assert off > 0.8 * np.linalg.norm(SHIFT) and off > 50 * step, (off, step)


def test_frame_after_a_dropped_chain_keeps_its_gauge():
    off, step, rebases, drops = _run(repaired=True, drop_anchor=True)
    assert rebases == 0 and drops == 1
    assert off < 2 * step, (off, step)
