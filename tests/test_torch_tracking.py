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


def jax_state():
    """The JAX System (RGBD, mapping disabled) after frames 0 and 1, and
    frame 2: (world, cfg, slam, frame 2, its true pose, last frame, reference
    keyframe with its associations refreshed)."""
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
    kf = slam.map_db.keyframes[tr.ref_keyfrm_id]
    tr._refresh_kf_assoc(kf)
    return world, cfg, slam, frm, poses[2], tr.last_frm, kf


def run_pair(use_motion):
    _, cfg, slam, frm, _, last, kf = jax_state()
    tr = slam.tracker
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


def test_chance_matches_of_a_missed_jump_yield_to_the_fallback():
    """A motion prediction 0.3 m off the truth, and 12 last-frame
    associations that fit it exactly (chance matches): stage 1 keeps
    num_matches_thr inliers at the wrong pose while the keyframe fallback
    finds hundreds at the right one, so the cascade takes the fallback.
    (bench.py's RGBD leg, threaded, kept stage 1 in 2 of 43 runs at its
    0.8 m turnaround and went on 8-18 degrees off.)"""
    world, cfg, slam, frm, T_true, last, kf = jax_state()
    tr = slam.tracker
    tbl_f32, tbl_u32 = convert.table_snap(slam.map_db.device_table.snap, device="cpu")
    cur = [_t(a) for a in (frm.undist_xy, frm.feats.level, frm.feats.desc, frm.feats.valid,
                           frm.feats.angle, frm.x_right)]
    last_desc, last_level, last_angle = (_t(a) for a in (
        last.feats.desc, last.feats.level, last.feats.angle))
    kf_args = [_t(a) for a in (kf.feats.desc, kf.feats.angle, tr._kf_assoc_pos,
                               tr._kf_assoc_valid, tr._kf_assoc_id)]

    # the prediction: the true camera centre moved 0.3 m along y
    T_wrong = T_true.copy()
    T_wrong[:3, 3] -= T_true[:3, :3] @ np.array([0.0, 0.3, 0.0])
    R_w = torch.tensor(T_wrong[:3, :3], dtype=torch.float32)
    t_w = torch.tensor(T_wrong[:3, 3], dtype=torch.float32)
    # 12 level-0 current keypoints at least 40 px apart, each the match of a
    # last-frame slot whose landmark projects onto it under the prediction
    und, lev, valid = cur[0].numpy(), cur[1].numpy(), cur[3].numpy()
    picks = []
    for j in np.nonzero(valid & (lev == 0))[0]:
        if all(np.hypot(*(und[j] - und[k])) >= 40.0 for k in picks):
            picks.append(int(j))
        if len(picks) == 12:
            break
    assert len(picks) == 12
    n = frm.num_slots
    pos = torch.zeros((n, 3))
    has = torch.zeros(n, dtype=torch.bool)
    ids = torch.full((n,), -1, dtype=torch.int32)
    p = slam.camera.params
    z = world.depth
    for k, j in enumerate(picks):
        x_c = np.array([(und[j, 0] - p.cx) / p.fx * z, (und[j, 1] - p.cy) / p.fy * z, z])
        pos[j] = torch.tensor(T_wrong[:3, :3].T @ (x_c - T_wrong[:3, 3]), dtype=torch.float32)
        has[j] = True
        ids[j] = 1_000_000 + k
        last_desc[j], last_level[j], last_angle[j] = cur[2][j], cur[1][j], cur[4][j]

    tk = TrackingKernels(camera_from_yaml(cfg["Camera"]), OrbParams(num_levels=4),
                         device="cpu")
    out = tk.track_frame(*cur, last_desc, last_level, last_angle, pos, has, ids, *kf_args,
                         tbl_f32, tbl_u32, R_w, t_w, R_w, t_w, use_motion=True,
                         margin_local=5.0)
    packed = out.packed.numpy()
    n1, used_fb, _, n_final = packed[12:16]
    assert n1 >= tk.num_matches_thr  # stage 1 alone would have been kept
    assert used_fb == 1
    assert n_final > 100
    R, t = packed[:9].reshape(3, 3).astype(np.float64), packed[9:12].astype(np.float64)
    centre_err = np.linalg.norm(-R.T @ t + T_true[:3, :3].T @ T_true[:3, 3])
    assert centre_err < 0.02
    cos = (np.trace(R @ T_true[:3, :3].T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.5
