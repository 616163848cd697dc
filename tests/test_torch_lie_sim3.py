"""The port's Sim(3) functions (ops/lie.py) against the JAX package's, on
the CPU: the same numpy inputs through both. Tolerance 1e-5 (absolute, on
values of order 1): both are float32 programs of the same expressions, and
they differ by the rounding of sin / cos / exp / acos and of the 3x3 solve
in sim3_log (LAPACK against XLA's LU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops import lie as jlie
from stella_vslam_tpu_torch.ops import lie as tlie

torch.set_num_threads(1)
TOL = 1e-5


def _xi(seed, n=64, small=False):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[:, 6] *= 0.3
    if small:  # the Taylor branches: tiny rotation and / or tiny log-scale
        xi[: n // 3, 3:6] *= 1e-6
        xi[n // 3: 2 * n // 3, 6] *= 1e-6
        xi[0] = 0.0
    return xi


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("small", [False, True])
def test_sim3_exp_log(small):
    xi = _xi(0, small=small)
    sj, Rj, tj = jlie.sim3_exp(jnp.asarray(xi))
    st, Rt, tt = tlie.sim3_exp(torch.from_numpy(xi))
    _close(sj, st), _close(Rj, Rt), _close(tj, tt)
    _close(jlie._sim3_W(jnp.asarray(xi[:, 6]), jnp.asarray(xi[:, 3:6])),
           tlie._sim3_W(torch.from_numpy(xi[:, 6]), torch.from_numpy(xi[:, 3:6])))
    # the log on JAX's group elements, so both see the same input
    s, R, t = (np.asarray(x) for x in (sj, Rj, tj))
    _close(jlie.sim3_log(*_j(s, R, t)), tlie.sim3_log(*_t(s, R, t)))
    if not small:  # round trip (the log of a tiny rotation is clipped at acos)
        _close(xi, tlie.sim3_log(st, Rt, tt), tol=1e-4)


def test_sim3_group_ops():
    a, b = _xi(1), _xi(2)
    sa, Ra, ta = (np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(a)))
    sb, Rb, tb = (np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(b)))
    p = np.random.default_rng(3).normal(0, 2, (64, 3)).astype(np.float32)
    for u, v in zip(jlie.sim3_compose(*_j(sa, Ra, ta, sb, Rb, tb)),
                    tlie.sim3_compose(*_t(sa, Ra, ta, sb, Rb, tb))):
        _close(u, v)
    for u, v in zip(jlie.sim3_inverse(*_j(sa, Ra, ta)), tlie.sim3_inverse(*_t(sa, Ra, ta))):
        _close(u, v)
    _close(jlie.sim3_apply(*_j(sa, Ra, ta, p)), tlie.sim3_apply(*_t(sa, Ra, ta, p)))
    _close(jlie.se3_apply(*_j(Ra, ta, p)), tlie.se3_apply(*_t(Ra, ta, p)))
    for u, v in zip(jlie.se3_inverse(*_j(Ra, ta)), tlie.se3_inverse(*_t(Ra, ta))):
        _close(u, v)


@pytest.mark.parametrize("small", [False, True])
def test_so3_log_and_jacobian_inverse(small):
    phi = _xi(4, small=small)[:, 3:6]
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    _close(jlie.so3_log(jnp.asarray(R)), tlie.so3_log(torch.from_numpy(R)))
    _close(jlie.so3_left_jacobian_inv(jnp.asarray(phi)),
           tlie.so3_left_jacobian_inv(torch.from_numpy(phi)))


def test_rotation_project_fast():
    rng = np.random.default_rng(5)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.5, (32, 3)).astype(np.float32))))
    M = (R * rng.uniform(0.5, 2.0, (32, 1, 1)) + rng.normal(0, 0.05, R.shape)).astype(np.float32)
    M[::4] *= -1.0  # det < 0: the sign is corrected first
    out = tlie.rotation_project_fast(torch.from_numpy(M))
    _close(jlie.rotation_project_fast(jnp.asarray(M)), out)
    eye = torch.eye(3).expand(32, 3, 3)
    assert float((out @ out.transpose(-1, -2) - eye).abs().max()) < 1e-4
