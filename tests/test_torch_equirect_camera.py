"""The equirectangular camera of the port against the JAX package, on the
CPU, from numpy-seeded inputs: bearings and their inverse, reprojection
(every direction visible, depth the norm), the pose optimizer's residual
and pose Jacobian (ops/optim/residuals.py:92) and bundle adjustment's rows
(ops/optim/ba.py:322-335), on directions that include the +-pi longitude
seam and the poles, with half the seam points observed across it; and
BoxWorld, the ray-cast box room, byte for byte.

Bounds: pixels within 1e-4 px + 1e-6 relative and unit vectors within 1e-5
(float32 trigonometry of another library); Jacobians within 1e-5 relative
to their largest entry; residuals within 1e-5 of the image width: each is
the difference of two pixel coordinates up to W, whose float32 ulp (6.1e-5
at W = 640) the two libraries' atan2 and asin can move by one (measured
7.6e-6 px). The residual's longitude
wraps by a floor modulo in both packages: a point a hair either side of
the seam, observed on the other side, gives a residual of a few pixels,
not ~width.
"""
import jax.numpy as jnp
import numpy as np
import torch

from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu.ops import lie as jlie
from stella_vslam_tpu.ops.optim import ba as jba
from stella_vslam_tpu.ops.optim import residuals as jres
from stella_vslam_tpu.util.synthetic import BoxWorld as JBoxWorld
from stella_vslam_tpu_torch.camera import base as tcam
from stella_vslam_tpu_torch.ops.optim import ba as tba
from stella_vslam_tpu_torch.ops.optim import residuals as tres
from stella_vslam_tpu_torch.util.synthetic import BoxWorld, equirect_circle

torch.set_num_threads(1)

W, H = 640, 320
M = jcam.CameraModel.EQUIRECTANGULAR
TM = tcam.CameraModel.EQUIRECTANGULAR


def _params():
    return (jcam.make_params(cx=W / 2, cy=H / 2, width=W, height=H),
            tcam.make_params(cx=W / 2, cy=H / 2, width=W, height=H))


def _directions(rng, n=600):
    """Random unit directions plus the seam (longitude +-pi, i.e. z < 0,
    x = +-tiny) and the poles (y = +-1)."""
    d = rng.normal(size=(n, 3))
    seam = np.stack([rng.choice([-1, 1], 40) * rng.uniform(1e-7, 1e-3, 40),
                     rng.uniform(-0.8, 0.8, 40), -np.ones(40)], -1)
    poles = np.stack([rng.normal(0, 1e-4, 20), np.repeat([-1.0, 1.0], 10),
                      rng.normal(0, 1e-4, 20)], -1)
    d = np.concatenate([d, seam, poles])
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _pose(rng):
    R, t = jlie.se3_exp(jnp.asarray(np.concatenate(
        [rng.normal(0, 0.3, 3), rng.normal(0, 0.4, 3)]).astype(np.float32)))
    return np.array(R), np.array(t)


def test_bearings_and_reprojection_match_jax():
    rng = np.random.default_rng(11)
    jp, tp = _params()
    pts = np.stack([rng.uniform(0, W, 500), rng.uniform(0, H, 500)], -1).astype(np.float32)
    pts = np.concatenate([pts, [[0, 0], [W - 1e-3, H / 2], [W / 2, 0], [W / 2, H]]]
                         ).astype(np.float32)
    np.testing.assert_array_equal(
        tcam.undistort_keypoints(TM, tp, torch.from_numpy(pts)).numpy(), pts)
    b_j = np.asarray(jcam.bearings_from_undistorted(M, jp, jnp.asarray(pts)))
    b_t = tcam.bearings_from_undistorted(TM, tp, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(b_t, b_j, atol=1e-5)
    d = _directions(rng)
    uv_j = np.asarray(jcam.undistorted_from_bearings(M, jp, jnp.asarray(d)))
    uv_t = tcam.undistorted_from_bearings(TM, tp, torch.from_numpy(d)).numpy()
    # at the seam either package may land on u = 0 or u = W (atan2 of +-0)
    du = np.abs(uv_t[:, 0] - uv_j[:, 0])
    du = np.minimum(du, np.abs(du - W))
    assert du.max() <= 1e-4 + 1e-6 * W
    np.testing.assert_allclose(uv_t[:, 1], uv_j[:, 1], atol=1e-4, rtol=1e-6)
    R, t = _pose(rng)
    pos = (d * rng.uniform(0.5, 6.0, (len(d), 1)).astype(np.float32) - t) @ R
    pos = pos.astype(np.float32)
    out_j = jcam.reproject_to_image(M, jp, jnp.asarray(R), jnp.asarray(t), jnp.asarray(pos))
    out_t = tcam.reproject_to_image(TM, tp, torch.from_numpy(R), torch.from_numpy(t),
                                    torch.from_numpy(pos))
    uj, ut = np.asarray(out_j[0]), out_t[0].numpy()
    du = np.abs(ut[:, 0] - uj[:, 0])
    du = np.minimum(du, np.abs(du - W))
    assert du.max() <= 1e-3, du.max()
    np.testing.assert_allclose(ut[:, 1], uj[:, 1], atol=1e-3)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=1e-6)
    assert out_t[2].numpy().all() and np.asarray(out_j[2]).all()


def _seam_observations(rng, n=400):
    """Points in the camera frame with observations near their projection
    (1 px noise); half of the seam points straddle it: the point a hair on
    one side, its observation a few pixels over the other."""
    d = _directions(rng, n)
    Xc = d * rng.uniform(0.5, 6.0, (len(d), 1))
    lon = np.arctan2(Xc[:, 0], Xc[:, 2])
    lat = np.arcsin(Xc[:, 1] / np.linalg.norm(Xc, axis=1))
    uv = np.stack([W / 2 + lon * W / (2 * np.pi), H / 2 + lat * H / np.pi], -1)
    uv += rng.normal(0, 1.0, uv.shape)
    # the seam points (longitude within a pixel of +-pi): half of them
    # observed over on the other edge
    near = np.abs(np.abs(lon) - np.pi) < 2 * np.pi / W
    cross = near & (rng.random(len(d)) < 0.5)
    assert cross.sum() >= 10
    uv[cross, 0] = np.where(lon[cross] > 0, rng.uniform(0, 3, cross.sum()),
                            W - rng.uniform(0, 3, cross.sum()))
    return Xc, uv.astype(np.float32)


def _rel_close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


def test_residual_and_jacobians_match_jax():
    rng = np.random.default_rng(12)
    R, t = _pose(rng)
    Xc, uv = _seam_observations(rng)
    pos = ((Xc - t) @ R).astype(np.float32)
    xr = -np.ones(len(pos), np.float32)
    jc = jres.CamScalars(*[jnp.float32(v) for v in (0, 0, W / 2, H / 2, W, H, 0)])
    tc = tres.CamScalars(0.0, 0.0, W / 2, H / 2, float(W), float(H), 0.0)
    r_j, J_j, _, dof_j, ok_j = jres.equirectangular_residual(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(pos), jnp.asarray(uv), jnp.asarray(xr), jc)
    r_t, J_t, dof_t, ok_t = tres.equirectangular_residual(
        torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(pos), torch.from_numpy(uv),
        torch.from_numpy(xr), tc)
    # the seam straddlers' residuals stay a few pixels: the wrap is taken
    assert np.abs(np.asarray(r_j)[:, 0]).max() < 20
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-5 * W)
    _rel_close(J_t.numpy(), J_j)
    np.testing.assert_array_equal(dof_t.numpy(), np.asarray(dof_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    # bundle adjustment's rows (ba.py _residuals / _pose_rows), 2 cameras
    L, D = len(pos) // 2, 2
    R2, t2 = _pose(rng)
    cam_R = np.stack([R, R2]).astype(np.float32)
    cam_t = np.stack([t, t2]).astype(np.float32)
    obs_cam = np.stack([np.zeros(L), np.ones(L)], -1).astype(np.int32)
    uv2 = uv.reshape(-1)[: L * D * 2].reshape(L, D, 2)
    prob = dict(cam_R=cam_R, cam_t=cam_t, cam_fixed=np.array([True, False]),
                cam_valid=np.ones(2, bool), lm_pos=pos[:L], lm_valid=np.ones(L, bool),
                obs_cam=obs_cam, obs_uv=uv2, obs_x_right=-np.ones((L, D), np.float32),
                obs_inv_sigma_sq=np.ones((L, D), np.float32), obs_valid=np.ones((L, D), bool))
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    tprob = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in prob.items()})
    r_j, Jc_j, Jp_j, dof_j, ok_j, _ = jba._residuals(
        jprob, jprob.cam_R, jprob.cam_t, jprob.lm_pos, jc, "equirectangular")
    r_t, Jc_t, Jp_t, ok_t = tba._pose_rows(tprob, tprob.cam_R, tprob.cam_t, tprob.lm_pos, tc,
                                           "equirectangular")
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-5 * W)
    _rel_close(Jc_t.numpy(), Jc_j)
    _rel_close(Jp_t.numpy(), Jp_j)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


def test_box_world_renders_jax_images_byte_for_byte():
    jw = JBoxWorld(width=128, height=64, tex_size=256)
    tw = BoxWorld(width=128, height=64, tex_size=256)
    for a, b in zip(jw.textures, tw.textures):
        np.testing.assert_array_equal(a, b)
    assert tw.camera_yaml() == jw.camera_yaml()
    poses, centres = equirect_circle(250)
    for i in range(0, 250, 25):
        np.testing.assert_array_equal(tw.render(poses[i]), jw.render(poses[i]))
    np.testing.assert_allclose(-np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3]),
                               centres, atol=1e-12)
