"""The port's tracking cascade (track_frame) against the JAX one on one
frame pair of the test plane world, with identical inputs.

The JAX System (RGBD, mapping disabled) initializes on frame 0 and tracks
frame 1; then both implementations run track_frame for frame 2 from the
JAX tracker's state — frame features, device-chained associations and
poses, the reference keyframe's associations and the packed landmark table
— carried over by convert.py. Both the motion-model path and the keyframe
fallback path are run. Measured (CPU): poses within 1.2e-5 (motion) and
8e-7 (fallback), landmark-id agreement 1.0 over all slots, identical
stage-1, candidate, inlier and observability counts.
Bounds: pose within 1e-4, id agreement >= 0.99.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.module.tracking_kernels import TrackingKernels
from tests.synthetic_world import PlaneWorld, lateral_trajectory

torch.set_num_threads(1)


def _t(a, dtype=None):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, dtype=dtype))


def run_pair(use_motion):
    world = PlaneWorld()
    cam = world.camera_yaml()
    cam["setup"] = "RGBD"
    cam["focal_x_baseline"] = world.fx * 0.12
    cfg = {"Camera": cam, "Feature": {"num_levels": 4},
           "Preprocessing": {"min_size": 400, "depthmap_factor": 5000.0}}
    slam = JSystem(JConfig.from_dict(cfg), inline_mapping=True)
    slam.disable_mapping_module()
    slam.tracker.mapper = None
    slam.startup()
    poses = lateral_trajectory(3, step=0.03)
    depth = np.full((world.H, world.W), 20000, np.uint16)
    for i in range(2):
        slam.feed_RGBD_frame(world.render(poses[i]), depth, i * 0.05)
    tr = slam.tracker
    frm = slam.create_RGBD_frame(world.render(poses[2]), depth, 0.1)
    last = tr.last_frm
    kf = slam.map_db.keyframes[tr.ref_keyfrm_id]
    tr._refresh_kf_assoc(kf)
    snap = slam.map_db.device_table.snap
    args = [frm.undist_xy, frm.feats.level, frm.feats.desc, frm.feats.valid,
            frm.feats.angle, frm.x_right,
            last.feats.desc, last.feats.level, last.feats.angle,
            tr._last_assoc_pos, tr._last_assoc_valid, tr._last_assoc_id,
            kf.feats.desc, kf.feats.angle,
            tr._kf_assoc_pos, tr._kf_assoc_valid, tr._kf_assoc_id,
            snap.tbl_f32, snap.tbl_u32, *tr._dev_pose, *tr._dev_pose_prev]
    out_j = tr.kernels.track_frame(*args, use_motion=use_motion, margin_local=5.0)

    tk = TrackingKernels(camera_from_yaml(cfg["Camera"]), OrbParams(num_levels=4),
                         device="cpu")
    tbl_f32, tbl_u32 = convert.table_snap(snap, device="cpu")
    targs = [_t(a) for a in args]
    targs[17], targs[18] = tbl_f32, tbl_u32
    out_t = tk.track_frame(*targs, use_motion=use_motion, margin_local=5.0)
    return out_j, out_t, frm.num_slots


@pytest.mark.parametrize("use_motion", [True, False])
def test_track_frame_matches_jax(use_motion):
    out_j, out_t, n = run_pair(use_motion)
    pj, pt = np.asarray(out_j.packed), out_t.packed.numpy()
    np.testing.assert_allclose(pt[:12], pj[:12], atol=1e-4)
    counts_j, counts_t = pj[12:16], pt[12:16]
    assert counts_j[1] == counts_t[1] == (0 if use_motion else 1)
    assert counts_j[3] > 100  # the frame is really tracked
    ids_j, ids_t = pj[16:16 + n], pt[16:16 + n]
    assert np.mean(ids_j == ids_t) >= 0.99
    assert abs(counts_j[3] - counts_t[3]) <= 0.01 * counts_j[3]
