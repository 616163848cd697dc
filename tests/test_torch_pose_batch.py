"""Kernel D's batched entry (`optimize_pose_batch`) on the CPU: its plain
version equals the per-problem `optimize_pose_plain` (bit for bit: it runs
it on each problem), with per-slot inputs shared by the batch or given per
problem, in both residual models; and the tracking cascade that solves its
keyframe fallback and motion model in one batch gives the same outputs as
solving them one problem at a time, with two launches of D a tracked frame
where it made three.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu_torch.ops.optim import pose as pose_mod
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

torch.set_num_threads(1)


def _problem(rng, N, model):
    if model == "perspective":
        cam = CamScalars(320.0, 320.0, 200.0, 150.0, 400.0, 300.0, float(np.float32(320 * 0.12)))
        uv = np.stack([rng.uniform(5, 395, N), rng.uniform(5, 295, N)], -1)
        z = rng.uniform(2.0, 6.0, N)
        pos = np.stack([(uv[:, 0] - 200.0) * z / 320.0, (uv[:, 1] - 150.0) * z / 320.0, z], -1)
        xr = np.where(rng.random(N) < 0.5, uv[:, 0] - cam.focal_x_baseline / z, -1.0)
    else:
        cam = CamScalars(1.0, 1.0, 160.0, 80.0, 320.0, 160.0, 0.0)
        d = rng.normal(size=(N, 3))
        pos = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(2.0, 6.0, (N, 1))
        lon = np.arctan2(pos[:, 0], pos[:, 2])
        lat = np.arcsin(pos[:, 1] / np.linalg.norm(pos, axis=1))
        uv = np.stack([160.0 + lon * 320.0 / (2 * np.pi), 80.0 + lat * 160.0 / np.pi], -1)
        xr = -np.ones(N)
    obs = uv + rng.normal(0, 1.0, (N, 2))
    out = rng.random(N) < 0.2
    obs[out] += rng.uniform(-30, 30, (int(out.sum()), 2))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return cam, f(pos), f(obs), f(xr), f(rng.uniform(0.3, 1.0, N)), \
        torch.as_tensor(rng.random(N) < 0.9)


@pytest.mark.parametrize("model", ["perspective", "equirectangular"])
@pytest.mark.parametrize("shared", [True, False])
def test_batch_plain_equals_per_problem(model, shared):
    rng = np.random.default_rng(7 if shared else 8)
    N, B = 150, 3
    # shared: one frame's observations and points from three initial poses
    probs = [_problem(rng, N, model) for _ in range(1 if shared else B)] * (B if shared else 1)
    cam = probs[0][0]
    R0 = torch.eye(3)[None].repeat(B, 1, 1)
    t0 = torch.as_tensor(rng.normal(0, 0.03, (B, 3)).astype(np.float32))
    pos = torch.stack([p[1] for p in probs])
    valid = torch.stack([p[5] for p in probs])
    per = [torch.stack([p[i] for p in probs]) for i in (2, 3, 4)]
    slot = [probs[0][i] for i in (2, 3, 4)] if shared else per
    kw = dict(model=model, num_rounds=4, num_robust_rounds=2, num_each_iter=10)
    got = pose_mod.optimize_pose_batch(R0, t0, pos, *slot, valid, cam, **kw)
    for b in range(B):
        one = pose_mod.optimize_pose_plain(R0[b], t0[b], pos[b],
                                           *[s if shared else s[b] for s in slot],
                                           valid[b], cam, **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
    # the batch of one is optimize_pose
    one = pose_mod.optimize_pose(R0[0], t0[0], pos[0], *[s if shared else s[0] for s in slot],
                                 valid[0], cam, **kw)
    for g, o in zip(got, one):
        assert torch.equal(g[0], o)


def test_batch_plain_shapes_and_equal_problems():
    rng = np.random.default_rng(9)
    cam, pos, obs, xr, isg, valid = _problem(rng, 20, "perspective")
    R0, t0 = torch.eye(3)[None].repeat(2, 1, 1), torch.zeros(2, 3)
    got = pose_mod.optimize_pose_batch_plain(R0, t0, torch.stack([pos, pos]), obs, xr, isg,
                                             torch.stack([valid, valid]), cam)
    assert got.R_cw.shape == (2, 3, 3) and got.is_inlier.shape == (2, 20)
    assert torch.equal(got.R_cw[0], got.R_cw[1])


@pytest.mark.parametrize("use_motion", [True, False])
def test_track_frame_batched_stage_equals_one_problem_at_a_time(use_motion, monkeypatch):
    """The cascade's batch (stage 2 and stage 1 in one D launch, stage 3
    alone) against D called once per problem on the same frame: the same
    outputs, bit for bit; with the motion model the frame makes 2 launches
    of D where one problem a launch makes 3."""
    from stella_vslam_tpu_torch import convert
    from stella_vslam_tpu_torch.camera.base import camera_from_yaml
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.module.tracking_kernels import TrackingKernels
    from tests.test_torch_tracking import _t, jax_state

    _, cfg, slam, frm, _, last, kf = jax_state()
    tr = slam.tracker
    snap = slam.map_db.device_table.snap
    args = [_t(a) for a in (
        frm.undist_xy, frm.feats.level, frm.feats.desc, frm.feats.valid, frm.feats.angle,
        frm.x_right, last.feats.desc, last.feats.level, last.feats.angle,
        tr._last_assoc_pos, tr._last_assoc_valid, tr._last_assoc_id, kf.feats.desc,
        kf.feats.angle, tr._kf_assoc_pos, tr._kf_assoc_valid, tr._kf_assoc_id,
        snap.tbl_f32, snap.tbl_u32, *tr._dev_pose, *tr._dev_pose_prev)]
    args[17], args[18] = convert.table_snap(snap, device="cpu")
    tk = TrackingKernels(camera_from_yaml(cfg["Camera"]), OrbParams(num_levels=4),
                         device="cpu")
    batch = pose_mod.optimize_pose_batch
    sizes = []

    def counting(R0, *a, **kw):
        sizes.append(R0.shape[0])
        return batch(R0, *a, **kw)

    monkeypatch.setattr(pose_mod, "optimize_pose_batch", counting)
    out = tk.track_frame(*args, use_motion=use_motion, margin_local=5.0)
    assert sizes == ([2, 1] if use_motion else [1, 1])

    def one_at_a_time(R0, t0, pos, uv, xr, isg, valid, cam, **kw):
        sizes.append(-R0.shape[0])
        res = [pose_mod.optimize_pose(R0[b], t0[b], pos[b], uv, xr, isg, valid[b], cam, **kw)
               for b in range(R0.shape[0])]
        return pose_mod.PoseOptResult(*[torch.stack(f) for f in zip(*res)])

    monkeypatch.setattr(pose_mod, "optimize_pose_batch", one_at_a_time)
    ref = tk.track_frame(*args, use_motion=use_motion, margin_local=5.0)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert float(out.packed[15]) > 100  # the frame is really tracked
