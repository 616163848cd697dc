"""Motion-only pose optimization of the port (kernel D's plain CPU
version) against the JAX optimize_pose on identical observations.

Inputs from a numpy seed: N=800 slots, landmarks 2-6 m in front of the
camera, 1 px pixel noise, 20% outliers moved by up to 40 px, half of the
slots stereo (3-dof), 5% empty slots, per-slot 1/sigma^2 from 4 levels, a
start pose 0.03 m and ~1 deg off. Measured (CPU, seeds 0-2): |dR| <= 6e-8,
|dt| <= 2e-7, identical inlier sets. Bounds: R and t within 1e-4; inlier sets equal
except for slots whose chi-square lies within 1e-3 of its threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops.optim import pose as jpose
from stella_vslam_tpu.ops.optim.residuals import CamScalars as JCam
from stella_vslam_tpu_torch.ops.optim import pose as tpose
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

torch.set_num_threads(1)


def _problem(seed, n=800):
    rng = np.random.default_rng(seed)
    fx, cx, cy, fxb = 320.0, 200.0, 150.0, float(np.float32(320.0 * 0.12))
    uv = np.stack([rng.uniform(5, 395, n), rng.uniform(5, 295, n)], -1)
    z = rng.uniform(2.0, 6.0, n)
    pc = np.stack([(uv[:, 0] - cx) * z / fx, (uv[:, 1] - cy) * z / fx, z], -1)
    a = 0.04
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.1, -0.05, 0.2])
    pos_w = (pc - t) @ R
    obs = uv + rng.normal(0, 1.0, (n, 2))
    out = rng.random(n) < 0.2
    obs[out] += rng.uniform(-40, 40, (int(out.sum()), 2))
    xr = np.where(rng.random(n) < 0.5, obs[:, 0] - fxb / z, -1.0)
    inv_sig = (1.0 / 1.44 ** rng.integers(0, 4, n))
    b = 0.02
    R0 = R @ np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    f = lambda x: np.asarray(x, np.float32)
    arrays = (f(R0), f(t + 0.03), f(pos_w), f(obs), f(xr), f(inv_sig),
              rng.random(n) < 0.95)
    cam = dict(fx=fx, fy=fx, cx=cx, cy=cy, width=400.0, height=300.0,
               focal_x_baseline=fxb)
    return arrays, cam


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_pose_matches_jax(seed):
    arrays, cam = _problem(seed)
    rj = jpose.optimize_pose(*[jnp.asarray(a) for a in arrays],
                             JCam(**{k: jnp.float32(v) for k, v in cam.items()}))
    rt = tpose.optimize_pose(*[torch.from_numpy(np.array(a)) for a in arrays],
                             CamScalars(**cam))
    np.testing.assert_allclose(rt.R_cw.numpy(), np.asarray(rj.R_cw), atol=1e-4)
    np.testing.assert_allclose(rt.t_cw.numpy(), np.asarray(rj.t_cw), atol=1e-4)
    chi2 = np.asarray(rj.chi_sq)
    thr = np.where(arrays[4] > 0, jpose.CHI_SQ_3D, jpose.CHI_SQ_2D)
    near = np.abs(chi2 - thr) < 1e-3
    differ = np.asarray(rj.is_inlier) != rt.is_inlier.numpy()
    assert not np.any(differ & ~near)
    # the optimizer really separates the outliers
    assert 0.6 < float(np.asarray(rj.is_inlier).mean()) < 0.9
