"""The equirectangular modes of the port's pose optimizer and bundle
adjustment (the plain versions of kernels D and F-I) against the JAX
package's, on the CPU.

Problems are made with numpy from a seed inside a 4 m box room, as a 360
camera sees it: points all around the cameras (in front, beside, behind,
above), observed in equirectangular pixels (640x320) with 0.5 px noise, 8%
gross outliers, some near the +-pi longitude seam, where an observation
may fall on the other edge of the image; perturbed initial poses and
points. Bounds: the pose optimizer's pose within 1e-4 and its inlier flags
equal; bundle adjustment at K = 4 and 8 cameras, L = 200 points: keyframe
poses within 1e-4 (measured 2.7e-7), the points with two or more inlier
observations within 1e-4 (measured 4.8e-5; a point seen once is free
along its ray), the outlier flags equal, the cost within 1e-4 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops.optim import ba as jba
from stella_vslam_tpu.ops.optim import pose as jpose
from stella_vslam_tpu.ops.optim.residuals import CamScalars as JCam
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.ops.optim import ba as tba
from stella_vslam_tpu_torch.ops.optim import pose as tpose
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

torch.set_num_threads(1)

W, H = 640, 320
JC = JCam(*[jnp.float32(v) for v in (0.0, 0.0, W / 2, H / 2, W, H, 0.0)])
TC = CamScalars(0.0, 0.0, W / 2, H / 2, float(W), float(H), 0.0)
MODEL = "equirectangular"


def _rot(ax, ang):
    ax = np.asarray(ax, float) / np.linalg.norm(ax)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _project(R, t, X):
    Xc = X @ R.T + t if R.ndim == 2 else np.einsum("...ij,...j->...i", R, X) + t
    lon = np.arctan2(Xc[..., 0], Xc[..., 2])
    lat = np.arcsin(Xc[..., 1] / np.linalg.norm(Xc, axis=-1))
    return np.stack([W / 2 + lon * W / (2 * np.pi), H / 2 + lat * H / np.pi], -1)


def _room_points(rng, L):
    """Points on the walls, floor and ceiling of a 4 m box room."""
    X = rng.uniform(-4, 4, (L, 3))
    face = rng.integers(0, 3, L)
    X[np.arange(L), face] = rng.choice([-4.0, 4.0], L)
    return X


def _noisy(rng, uv):
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.random(uv.shape[:-1]) < 0.08
    uv[out] += rng.uniform(-30, 30, (int(out.sum()), 2))
    uv[..., 0] = np.mod(uv[..., 0], W)  # an observation past the seam wraps
    return uv


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_matches_jax(seed):
    rng = np.random.default_rng(seed)
    R, t = _rot(rng.normal(size=3), 0.3), rng.normal(0, 0.5, 3)
    X = _room_points(rng, 600)
    uv = _noisy(rng, _project(R, t, X))
    R0, t0 = _rot(rng.normal(size=3), 0.02) @ R, t + rng.normal(0, 0.03, 3)
    lvl = rng.integers(0, 4, 600)
    arrays = [R0, t0, X, uv, -np.ones(600), (1.0 / 1.2 ** (2 * lvl)),
              rng.random(600) < 0.95]
    arrays = [a.astype(np.float32) if a.dtype == np.float64 else a for a in arrays]
    rj = jpose.optimize_pose(*[jnp.asarray(a) for a in arrays], JC, model=MODEL)
    rt = tpose.optimize_pose(*[torch.from_numpy(np.array(a)) for a in arrays], TC, model=MODEL)
    np.testing.assert_allclose(rt.R_cw.numpy(), np.asarray(rj.R_cw), atol=1e-4)
    np.testing.assert_allclose(rt.t_cw.numpy(), np.asarray(rj.t_cw), atol=1e-4)
    np.testing.assert_array_equal(rt.is_inlier.numpy(), np.asarray(rj.is_inlier))
    # it converged to the truth, seam observations included
    assert np.abs(rt.t_cw.numpy() - t).max() < 5e-3
    assert 0.8 < float(rt.is_inlier.float().mean()) < 0.95


def _ba_problem(K, L, D, seed):
    rng = np.random.default_rng(seed)
    R = np.stack([_rot([0, 1, 0], 0.3 * k) for k in range(K)])
    C = np.stack([[0.4 * np.cos(k), 0.05 * k, 0.4 * np.sin(k)] for k in range(K)])
    t = -np.einsum("kij,kj->ki", R, C)
    X = _room_points(rng, L)
    obs_cam = np.stack([rng.permutation(K)[:D] for _ in range(L)]).astype(np.int32)
    uv = _noisy(rng, _project(R[obs_cam], t[obs_cam], X[:, None, :]))
    lvl = rng.integers(0, 4, (L, D))
    cam_R = np.stack([R[k] @ _rot(rng.normal(size=3), 0.004) if k else R[k] for k in range(K)])
    cam_t = t + np.concatenate([[[0, 0, 0]], rng.normal(0, 0.005, (K - 1, 3))])
    p = dict(cam_R=cam_R, cam_t=cam_t, cam_fixed=np.arange(K) < 2,
             cam_valid=np.ones(K, bool), lm_pos=X + rng.normal(0, 0.01, X.shape),
             lm_valid=rng.random(L) < 0.97, obs_cam=obs_cam, obs_uv=uv,
             obs_x_right=-np.ones((L, D)), obs_inv_sigma_sq=1.0 / 1.2 ** (2 * lvl),
             obs_valid=rng.random((L, D)) < 0.95)
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in p.items()}


@pytest.mark.parametrize("K,D", [(4, 3), (8, 4)])
def test_bundle_adjust_matches_jax(K, D):
    p = _ba_problem(K, 200, D, seed=K)
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})
    rj = jba.bundle_adjust(jprob, JC, model=MODEL)
    rt = tba.bundle_adjust(convert.ba_problem(jprob, device="cpu"), TC, model=MODEL)
    np.testing.assert_allclose(rt.cam_R.numpy(), np.asarray(rj.cam_R), atol=1e-4)
    np.testing.assert_allclose(rt.cam_t.numpy(), np.asarray(rj.cam_t), atol=1e-4)
    np.testing.assert_array_equal(rt.obs_is_outlier.numpy(), np.asarray(rj.obs_is_outlier))
    assert int(rt.obs_is_outlier.sum()) > 0
    # a point with one inlier observation is free along its ray
    twice = (p["obs_valid"] & ~np.asarray(rj.obs_is_outlier)).sum(1) >= 2
    assert twice.sum() > 150
    np.testing.assert_allclose(rt.lm_pos.numpy()[twice], np.asarray(rj.lm_pos)[twice],
                               atol=1e-4)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-4)
