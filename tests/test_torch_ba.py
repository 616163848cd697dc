"""Bundle adjustment of the port (ops/optim/ba.py, the plain version of
kernels F, G, H, I) against the JAX package's bundle_adjust, on the CPU.

Problems are made with numpy from a seed: cameras along a short baseline
looking at points 3-7 m away, observations with 1 px noise, 8% gross
outliers, perturbed initial poses (a few mm, ~0.3 deg) and points (1 cm),
some padded observation slots. Cases: the two-camera init BA (camera 0
fixed, D = 2, as the monocular initializer builds it) and a K = 4, D = 3
problem with stereo rows, a fixed camera, an invalid camera slot, fixed
points and keep-inlier rows. Tolerance: for the K = 4 problem, poses and
points within 1e-4 (f32 sums in another order: torch's einsum and
index_add_ against XLA's one-hot matmuls; measured 2.7e-5); for the
two-camera problem, whose scale is free, a bound from JAX's own spread
(see the test); outlier flags identical in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops.optim import ba as jba
from stella_vslam_tpu.ops.optim.residuals import CamScalars as JCam
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.ops.optim import ba as tba
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

torch.set_num_threads(1)

FX, CX, CY, FXB = 320.0, 200.0, 150.0, float(np.float32(320.0 * 0.12))


def _rot(ax, ang):
    ax = np.asarray(ax, float) / np.linalg.norm(ax)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def make_problem(K, L, D, stereo=False, extras=False, seed=0, spacing=0.4):
    rng = np.random.default_rng(seed)
    R = np.stack([_rot([0, 1, 0], 0.02 * k) for k in range(K)])
    t = np.stack([[-spacing * k, 0.1 * spacing * k, 0.0] for k in range(K)])
    X = np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1, 1, L),
                  rng.uniform(2.5, 4.5, L)], -1)
    obs_cam = np.stack([rng.permutation(K)[:D] for _ in range(L)]).astype(np.int32)
    Xc = np.einsum("ldij,lj->ldi", R[obs_cam], X) + t[obs_cam]
    uv = np.stack([FX * Xc[..., 0] / Xc[..., 2] + CX,
                   FX * Xc[..., 1] / Xc[..., 2] + CY], -1)
    xr = np.where(rng.random((L, D)) < (0.5 if stereo else 0.0),
                  uv[..., 0] - FXB / Xc[..., 2], -1.0)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    xr = np.where(xr > 0, xr + rng.normal(0, 0.5, xr.shape), -1.0)
    out = rng.random((L, D)) < 0.08
    uv[out] += rng.uniform(-30, 30, (int(out.sum()), 2))
    valid = rng.random((L, D)) < 0.95
    lvl = rng.integers(0, 4, (L, D))
    isig = (1.0 / 1.2 ** (2 * lvl)).astype(np.float32)
    cam_R = np.stack([R[k] @ _rot(rng.normal(size=3), 0.005) if k else R[k] for k in range(K)])
    cam_t = t + np.concatenate([[[0, 0, 0]], rng.normal(0, 0.005, (K - 1, 3))])
    p = dict(
        cam_R=cam_R, cam_t=cam_t, cam_fixed=np.arange(K) == 0,
        cam_valid=np.ones(K, bool), lm_pos=X + rng.normal(0, 0.01, X.shape),
        lm_valid=rng.random(L) < 0.97, obs_cam=obs_cam, obs_uv=uv, obs_x_right=xr,
        obs_inv_sigma_sq=isig, obs_valid=valid)
    if extras:
        p["cam_valid"][K - 1] = False
        p["lm_fixed"] = rng.random(L) < 0.1
        p["lm_keep_inlier"] = rng.random(L) < 0.1
    return p


_F32 = lambda a: a.astype(np.float32) if a.dtype == np.float64 else a
JCAM = JCam(fx=FX, fy=FX, cx=CX, cy=CY, width=400.0, height=300.0,
            focal_x_baseline=FXB)


def _jax_problem(p):
    return jba.BAProblem(**{k: jnp.asarray(_F32(v)) for k, v in p.items()})


def _jax(p):
    return jba.bundle_adjust(_jax_problem(p), JCAM)


def _run_both(p):
    """The JAX BA and the port's on the same problem (carried over by
    convert.ba_problem)."""
    tprob = convert.ba_problem(_jax_problem(p), device="cpu")
    rt = tba.bundle_adjust(tprob, CamScalars(FX, FX, CX, CY, 400.0, 300.0, FXB))
    return _jax(p), rt


def _diffs(ra, rb):
    return {name: float(np.abs(np.asarray(getattr(ra, name))
                               - np.asarray(getattr(rb, name))).max())
            for name in ("cam_R", "cam_t", "lm_pos")}


def _check(rj, rt, bound):
    for name, d in _diffs(rj, rt).items():
        assert d < bound[name], (name, d, bound[name])
    assert np.array_equal(np.asarray(rj.obs_is_outlier), rt.obs_is_outlier.numpy())


def test_two_view_init_ba_matches_jax():
    """Two cameras with camera 0 fixed leave the scale free, and the gain
    stop ends the schedule before weakly observed depths converge, so the
    result moves with the last bits of its input: JAX's own result moves by
    1.3e-4 (translation), 8.8e-6 (rotation) and 8.9 cm (the worst point)
    when the observations are scaled by 1 + 1e-6. The port must stay within
    4x that spread of JAX (plus 1e-4); measured: 4.0e-4, 1.9e-5 and 0.31 m,
    2.2x to 3.4x the spread."""
    p = make_problem(K=2, L=300, D=2)
    rj, rt = _run_both(p)
    q = dict(p, obs_uv=p["obs_uv"] * (1 + 1e-6))
    spread = _diffs(rj, _jax(q))
    _check(rj, rt, {k: 4 * v + 1e-4 for k, v in spread.items()})
    # the BA really moved the free camera, and flags the gross outliers
    assert np.abs(rt.cam_t.numpy()[1] - p["cam_t"][1]).max() > 1e-4
    assert int(rt.obs_is_outlier.sum()) > 0
    assert abs(float(rj.cost) - float(rt.cost)) <= 1e-3 * abs(float(rj.cost))


def test_stereo_rows_fixed_points_match_jax():
    p = make_problem(K=4, L=256, D=3, stereo=True, extras=True, seed=1)
    rj, rt = _run_both(p)
    _check(rj, rt, dict(cam_R=1e-4, cam_t=1e-4, lm_pos=1e-4))
    assert abs(float(rj.cost) - float(rt.cost)) <= 1e-4 * abs(float(rj.cost))
    fixed = p["lm_fixed"]
    assert np.array_equal(rt.lm_pos.numpy()[fixed], p["lm_pos"][fixed].astype(np.float32))
    assert np.array_equal(rt.cam_R.numpy()[3], p["cam_R"][3].astype(np.float32))


def test_global_shape_matches_jax():
    """The global BA's shape and schedule: K = 64 camera slots (a 384 x 384
    reduced system, past the 192 rows kernel G holds in shared memory), D =
    16 observers, one Huber stage of 16 iterations and no reclassification.
    Cameras 0.05 m apart (at the other problems' 0.4 m the 64th would stand 25 m
    off the points). Poses and points within 1e-4 of JAX (measured 5e-7), the
    final outlier flags equal."""
    p = make_problem(K=64, L=300, D=16, seed=5, spacing=0.05)
    jprob = _jax_problem(p)
    rj = jba.bundle_adjust(jprob, JCAM, num_first=16, num_second=0)
    rt = tba.bundle_adjust(convert.ba_problem(jprob, device="cpu"),
                           CamScalars(FX, FX, CX, CY, 400.0, 300.0, FXB),
                           num_first=16, num_second=0)
    _check(rj, rt, dict(cam_R=1e-4, cam_t=1e-4, lm_pos=1e-4))
    assert abs(float(rj.cost) - float(rt.cost)) <= 1e-4 * abs(float(rj.cost))
    assert np.abs(rt.cam_t.numpy()[1:] - p["cam_t"][1:]).max() > 1e-4


def test_plain_linearize_in_float64_matches_float32():
    """Plain F runs in the dtype of its inputs (the card check holds kernel
    F against it in float64), and plain G solves damped_reduced_system."""
    p = make_problem(K=4, L=256, D=3, stereo=True, extras=True, seed=3)
    prob = convert.ba_problem(_jax_problem(p), device="cpu")
    prob64 = tba.BAProblem(*[v.double() if v is not None and v.is_floating_point() else v
                             for v in prob])
    cam = CamScalars(FX, FX, CX, CY, 400.0, 300.0, FXB)
    inlier = torch.ones_like(prob.obs_valid)
    lam = torch.tensor(1e-4)
    o32 = tba.linearize_schur_plain(prob, cam, prob.cam_R, prob.cam_t, prob.lm_pos, inlier,
                                    lam, True)
    o64 = tba.linearize_schur_plain(prob64, cam, prob64.cam_R, prob64.cam_t, prob64.lm_pos,
                                    inlier, lam.double(), True)
    for a, b in zip(o32[:5], o64[:5]):
        assert b.dtype == torch.float64
        assert float((a.double() - b).abs().max()) <= 1e-5 * float(b.abs().max())
    _, Hcc, b_c, S_red, rhs_red, _ = o64
    S, rhs = tba.damped_reduced_system(prob64, Hcc, b_c, S_red, rhs_red, lam.double())
    dx, _, _ = tba.reduced_solve_plain(prob64, prob64.cam_R, prob64.cam_t, Hcc, b_c, S_red,
                                       rhs_red, lam.double())
    np.testing.assert_allclose(dx.reshape(-1).numpy(), -np.linalg.solve(S.numpy(), rhs.numpy()),
                               rtol=1e-9, atol=1e-12)
    # fixed (slot 0) and invalid (slot 3) cameras do not move
    assert float(dx[0].abs().max()) == 0.0 and float(dx[3].abs().max()) == 0.0


def test_solve_spd_blocked_matches_dense():
    from stella_vslam_tpu_torch.ops import linalg

    rng = np.random.default_rng(2)
    for n in (12, 30):
        A = rng.normal(size=(n, n))
        S = A @ A.T + n * np.eye(n)
        b = rng.normal(size=n)
        x = linalg.solve_spd_blocked(torch.tensor(S, dtype=torch.float64),
                                     torch.tensor(b, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(x, np.linalg.solve(S, b), rtol=1e-9, atol=1e-12)


def test_equirectangular_raises():
    p = make_problem(K=2, L=8, D=2)
    prob = tba.BAProblem(**{k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.float32) if v.dtype == np.float64 else v)) for k, v in p.items()})
    with pytest.raises(NotImplementedError, match="item 14"):
        tba.bundle_adjust(prob, CamScalars(FX, FX, CX, CY, 400.0, 300.0, FXB),
                          model="equirectangular")
