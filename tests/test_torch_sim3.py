"""The port's Sim(3) optimizers (ops/optim/sim3.py, the plain versions of
kernels O and P) against the JAX package's, on the CPU, on the problems of
tests/test_sim3_opt.py (made here with numpy from a seed): a two-view Sim3
refinement from a perturbed start, with gross outliers added, and a 24
keyframe circle with odometric drift closed by one loop edge.

Tolerances: s, R, t of both optimizers within 1e-4 of the JAX result (both
run the same float32 Gauss-Newton; the sums of the normal equations are
taken in another order, and the pose graph's dense solve is the same blocked
Cholesky), inlier flags equal. The closed-form Jacobian of kernel O
(`transform_jacobian`) and of the edge residual are held against
torch.func.jacfwd / a float64 finite difference within 1e-3 relative to the
largest entry (float32 forward-mode against a formula).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops.optim import sim3 as jsim3
from stella_vslam_tpu_torch.ops import lie as tlie
from stella_vslam_tpu_torch.ops.optim import sim3 as tsim3

torch.set_num_threads(1)
FX, FY, CX, CY = 450.0, 450.0, 376.0, 240.0
TOL = 1e-4


def transform_problem(seed=8, n=80, n_outliers=8):
    rng = np.random.default_rng(seed)
    pts2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(4, 8, n)], -1).astype(np.float32)
    xi = np.array([0.3, -0.1, 0.2, 0.05, -0.1, 0.08, 0.15], np.float32)
    s_gt, R_gt, t_gt = tlie.sim3_exp(torch.from_numpy(xi))
    pts1 = tlie.sim3_apply(s_gt[None], R_gt, t_gt, torch.from_numpy(pts2)).numpy()

    def proj(p):
        return np.stack([FX * p[:, 0] / p[:, 2] + CX, FY * p[:, 1] / p[:, 2] + CY],
                        -1).astype(np.float32)

    obs1, obs2 = proj(pts1), proj(pts2)
    obs1[:n_outliers] += rng.uniform(15, 40, (n_outliers, 2)).astype(np.float32)
    obs1 += rng.normal(0, 0.3, obs1.shape).astype(np.float32)
    obs2 += rng.normal(0, 0.3, obs2.shape).astype(np.float32)
    dxi = np.array([0.05, 0.02, -0.04, 0.01, 0.02, -0.02, -0.05], np.float32)
    s0, R0, t0 = tlie.sim3_compose(*tlie.sim3_exp(torch.from_numpy(dxi)), s_gt, R_gt, t_gt)
    lvl = rng.integers(0, 3, n)
    isig = (1.0 / 1.2 ** (2 * lvl)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-5:] = False
    return dict(s0=s0.numpy(), R0=R0.numpy(), t0=t0.numpy(), pts1=pts1, pts2=pts2,
                obs1=obs1, obs2=obs2, isig1=isig, isig2=isig[::-1].copy(), valid=valid,
                gt=(float(s_gt), R_gt.numpy(), t_gt.numpy()))


def _args(p, conv):
    return [conv(p[k]) for k in ("s0", "R0", "t0", "pts1", "pts2", "obs1", "obs2", "isig1",
                                 "isig2", "valid")]


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_transform_matches_jax(fix_scale):
    p = transform_problem()
    rj = jsim3.optimize_transform(*_args(p, jnp.asarray), FX, FY, CX, CY, chi_sq=9.966,
                                  fix_scale=fix_scale)
    rt = tsim3.optimize_transform(*_args(p, lambda a: torch.from_numpy(np.array(a))),
                                  FX, FY, CX, CY, chi_sq=9.966, fix_scale=fix_scale)
    assert abs(float(rj.s_12) - float(rt.s_12)) < TOL
    assert np.abs(np.asarray(rj.R_12) - rt.R_12.numpy()).max() < TOL
    assert np.abs(np.asarray(rj.t_12) - rt.t_12.numpy()).max() < TOL
    assert np.array_equal(np.asarray(rj.is_inlier), rt.is_inlier.numpy())
    assert int(rt.num_inliers) == int(rj.num_inliers)
    if not fix_scale:  # and it found the transform (the outliers and padding dropped)
        assert abs(float(rt.s_12) - p["gt"][0]) < 5e-3
        assert 60 <= int(rt.num_inliers) <= 67


@pytest.mark.parametrize("fix_scale", [False, True])
def test_transform_jacobian_closed_form(fix_scale):
    p = transform_problem(seed=9)
    a = _args(p, lambda x: torch.from_numpy(np.array(x)))
    prob = tsim3.TransformProblem(*a[3:])
    s, R, t = a[:3]
    inlier = prob.valid.to(torch.float32)
    cam = (FX, FY, CX, CY)
    J = tsim3.transform_jacobian(prob, s, R, t, inlier, cam, fix_scale)
    f = lambda xi: tsim3._cost_vec(prob, xi, s, R, t, inlier, cam, fix_scale)
    Jf = torch.func.jacfwd(f)(torch.zeros(7))
    assert float((J - Jf).abs().max()) < 1e-3 * float(Jf.abs().max())
    assert float(J[:, 6].abs().max()) == 0.0 or not fix_scale


def circle_graph(K=24, seed=0):
    gt = []
    for k in range(K):
        th = 2 * np.pi * k / K
        xi = torch.tensor([np.cos(th), np.sin(th), 0.0, 0.0, 0.0, th], dtype=torch.float32)
        R, t = tlie.se3_exp(xi)
        gt.append((R.numpy(), t.numpy()))
    est_R = np.zeros((K, 3, 3), np.float32)
    est_t = np.zeros((K, 3), np.float32)
    est_R[0], est_t[0] = gt[0]
    dR, dt = (x.numpy() for x in tlie.se3_exp(torch.tensor(
        [0.01, -0.008, 0.004, 0.002, 0.003, -0.004])))
    for k in range(1, K):
        R_rel = gt[k][0] @ gt[k - 1][0].T
        t_rel = gt[k][1] - R_rel @ gt[k - 1][1]
        R_d, t_d = dR @ R_rel, dR @ t_rel + dt * 0.1
        est_R[k] = R_d @ est_R[k - 1]
        est_t[k] = R_d @ est_t[k - 1] + t_d
    ei, ej, es, eR, et = [], [], [], [], []
    for k in range(1, K):
        R_ij = est_R[k] @ est_R[k - 1].T
        ei.append(k), ej.append(k - 1), es.append(1.0), eR.append(R_ij)
        et.append(est_t[k] - R_ij @ est_t[k - 1])
    R_loop = gt[K - 1][0] @ gt[0][0].T
    ei.append(K - 1), ej.append(0), es.append(1.05), eR.append(R_loop)
    et.append(gt[K - 1][1] - R_loop @ gt[0][1])
    # padding as the global optimizer pads: vertices to 32, edges to 32
    Kp, Ep, E = 32, 32, len(ei)
    pad = lambda a, n, fill: np.concatenate(
        [np.asarray(a), np.broadcast_to(fill, (n - len(a),) + np.asarray(a).shape[1:])])
    eye = np.eye(3, dtype=np.float32)
    return dict(
        s=pad(np.ones(K, np.float32), Kp, np.float32(1)), R=pad(est_R, Kp, eye),
        t=pad(est_t, Kp, np.float32(0)),
        fixed=np.concatenate([np.arange(K) == 0, np.ones(Kp - K, bool)]),
        valid=np.arange(Kp) < K, ei=pad(np.array(ei, np.int32), Ep, np.int32(0)),
        ej=pad(np.array(ej, np.int32), Ep, np.int32(0)),
        es=pad(np.array(es, np.float32), Ep, np.float32(1)),
        eR=pad(np.stack(eR).astype(np.float32), Ep, eye),
        et=pad(np.stack(et).astype(np.float32), Ep, np.float32(0)),
        evalid=np.arange(Ep) < E, gt=gt, K=K)


_GKEYS = ("s", "R", "t", "fixed", "valid", "ei", "ej", "es", "eR", "et", "evalid")


def test_optimize_pose_graph_matches_jax():
    g = circle_graph()
    rj = jsim3.optimize_pose_graph(*[jnp.asarray(g[k]) for k in _GKEYS])
    rt = tsim3.optimize_pose_graph(*[torch.from_numpy(np.array(g[k])) for k in _GKEYS])
    assert np.abs(np.asarray(rj.s_cw) - rt.s_cw.numpy()).max() < TOL
    assert np.abs(np.asarray(rj.R_cw) - rt.R_cw.numpy()).max() < TOL
    assert np.abs(np.asarray(rj.t_cw) - rt.t_cw.numpy()).max() < TOL
    K = g["K"]
    # the loop is closed: the graph's squared residual fell more than 10x
    graph = tsim3.PoseGraph(*[torch.from_numpy(np.array(g[k])) for k in _GKEYS[3:]])
    cost = lambda s, R, t: float(tsim3.pose_graph_linearize_plain(graph, s, R, t)[2])
    c0 = cost(*[torch.from_numpy(np.array(g[k])) for k in _GKEYS[:3]])
    assert cost(rt.s_cw, rt.R_cw, rt.t_cw) < 0.1 * c0
    # padding and the fixed root did not move
    assert np.array_equal(rt.R_cw.numpy()[K:], g["R"][K:])
    assert np.array_equal(rt.t_cw.numpy()[0], g["t"][0])


def test_edge_jacobian_against_finite_differences():
    """vmap(jacfwd) of the edge residual (what kernel P's dual numbers
    reproduce) against central differences in float64."""
    g = circle_graph()
    t64 = lambda k: torch.from_numpy(np.array(g[k])).double() \
        if g[k].dtype == np.float32 else torch.from_numpy(np.array(g[k]))
    graph = tsim3.PoseGraph(*[t64(k) for k in _GKEYS[3:]])
    s, R, t = t64("s"), t64("R"), t64("t")
    r, J = tsim3.edge_residuals_plain(graph, s, R, t)
    e = 23  # the loop edge: a residual far from zero
    i, j = int(g["ei"][e]), int(g["ej"][e])
    a = (s[i], R[i], t[i], s[j], R[j], t[j], graph.edge_s[e], graph.edge_R[e], graph.edge_t[e])
    h = 1e-6
    for c in range(14):
        d = torch.zeros(14, dtype=torch.float64)
        d[c] = h
        fd = (tsim3._edge_residual(d, *a) - tsim3._edge_residual(-d, *a)) / (2 * h)
        assert float((fd - J[e, :, c]).abs().max()) < 1e-5
    assert float(r[e].abs().max()) > 1e-2
