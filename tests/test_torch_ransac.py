"""Two-view RANSAC of the port (ops/solve) against the JAX package, on the
CPU (the plain versions of kernel E).

The same correspondences, made with numpy from a seed, go through both; the
port gets the uint32 seeds that the JAX functions derive from their keys
(`ransac._seed_from_key`, chunk keys from `jax.random.split(key, 8)`).
Tolerances: the hash and the sampled indices are integer results and must be
equal; the DLT models are float32 results of sums taken in another order
(XLA's and torch's matmul blocking), compared up to sign (see
test_minimal_solvers_match_jax);
for the RANSAC results, the best cost agrees to 5e-3 relative (F measured
1.2e-3 on the same winning hypothesis: its rank-2 model differs in the 4th
digit, and JAX jitted and unjitted differ by 7e-5 on it), inlier counts
are equal and inlier masks agree on >= 99% of the matches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops.solve import fundamental as jF
from stella_vslam_tpu.ops.solve import homography as jH
from stella_vslam_tpu.ops.solve import ransac as jR
from stella_vslam_tpu_torch.ops.solve import fundamental as tF
from stella_vslam_tpu_torch.ops.solve import homography as tH
from stella_vslam_tpu_torch.ops.solve import ransac as tR

torch.set_num_threads(1)


def _seed(key) -> int:
    return int(np.asarray(jR._seed_from_key(key)))


def two_view(n=400, planar=True, outlier_frac=0.3, noise=0.5, seed=0):
    """Matches of a camera pair (fx 320, 400x300): points on a plane at
    depth 4 (planar) or spread in depth 2-8, 1-px-scale noise, a share of
    random outliers, and 10% of the slots invalid."""
    rng = np.random.default_rng(seed)
    fx, cx, cy = 320.0, 200.0, 150.0
    uv1 = np.stack([rng.uniform(10, 390, n), rng.uniform(10, 290, n)], -1)
    z = np.full(n, 4.0) if planar else rng.uniform(2.0, 8.0, n)
    X = np.stack([(uv1[:, 0] - cx) * z / fx, (uv1[:, 1] - cy) * z / fx, z], -1)
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    Xc = X @ R.T + np.array([0.3, 0.05, 0.02])
    uv2 = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    uv1 = uv1 + rng.normal(0, noise, uv1.shape)
    uv2 = uv2 + rng.normal(0, noise, uv2.shape)
    out = rng.random(n) < outlier_frac
    uv2[out] = np.stack([rng.uniform(0, 400, out.sum()), rng.uniform(0, 300, out.sum())], -1)
    valid = rng.random(n) < 0.9
    return uv1.astype(np.float32), uv2.astype(np.float32), valid


def _both(p1, p2, v):
    return ((jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(v)),
            (torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(v)))


@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9, 0xFFFFFFFF])
def test_hash_uniform_bit_exact(seed):
    shape = (3, 8, 97)
    j = np.asarray(jR.hash_uniform(jnp.uint32(seed), shape)).reshape(-1)
    t = tR.hash_uniform(seed, 0, j.size, "cpu").numpy()
    assert np.array_equal(j.view(np.uint32), t.view(np.uint32))


@pytest.mark.parametrize("k", [4, 8])
def test_sample_minimal_sets_exact(k):
    rng = np.random.default_rng(k)
    valid = rng.random(300) < 0.6
    key = jax.random.PRNGKey(11 + k)
    j = np.asarray(jR.sample_minimal_sets(key, jnp.asarray(valid), 300, k))
    t = tR.sample_minimal_sets(_seed(key), torch.from_numpy(valid), 300, k).numpy()
    assert np.array_equal(j, t)
    assert valid[t].all()
    # nothing valid: every slot takes index 0, as argmax over all -1.0
    none = tR.sample_minimal_sets(5, torch.zeros(10, dtype=torch.bool), 3, k)
    assert int(none.abs().sum()) == 0


def _diff_up_to_sign(a, b):
    """Per model: max |a - +-b| after scaling both to unit Frobenius norm."""
    a = a.reshape(len(a), -1) / np.linalg.norm(a.reshape(len(a), -1), axis=1)[:, None]
    b = b.reshape(len(b), -1) / np.linalg.norm(b.reshape(len(b), -1), axis=1)[:, None]
    sign = np.sign(np.sum(a * b, axis=1, keepdims=True))
    return np.max(np.abs(a - sign * b), axis=1)


@pytest.mark.parametrize("which", ["H", "F"])
def test_minimal_solvers_match_jax(which):
    p1, p2, _ = two_view(n=400, planar=which == "H", outlier_frac=0.0)
    k = 4 if which == "H" else 8
    rng = np.random.default_rng(3)
    idx = np.stack([rng.choice(400, k, replace=False) for _ in range(64)])
    s1, s2 = p1[idx], p2[idx]
    if which == "H":
        j = np.asarray(jH.compute_H_21(jnp.asarray(s1), jnp.asarray(s2)))
        t = tH.compute_H_21(torch.from_numpy(s1), torch.from_numpy(s2)).numpy()
    else:
        j = np.asarray(jF.compute_F_21(jnp.asarray(s1), jnp.asarray(s2)))
        t = tF.compute_F_21(torch.from_numpy(s1), torch.from_numpy(s2)).numpy()
    # 18 squarings converge to the null vector only as fast as the gap of
    # the two smallest eigenvalues allows; on the few sets where that gap is
    # near f32 resolution the two summation orders land on different
    # vectors. Measured on these 64 sets: median 8.4e-6 (H) / 2.6e-4 (F),
    # one H set at 0.81, the worst F set at 0.038.
    d = _diff_up_to_sign(j, t)
    tol = 1e-3 if which == "H" else 1e-2
    assert np.median(d) < tol / 10
    assert np.mean(d < tol) >= 0.9


def _check_result(rj, rt):
    cj, ct = float(rj.cost), float(rt.cost)
    assert bool(rj.valid) and bool(rt.valid)
    assert abs(cj - ct) <= 5e-3 * abs(cj), (cj, ct)
    assert int(rj.num_inliers) == int(rt.num_inliers)
    agree = np.mean(np.asarray(rj.is_inlier) == rt.is_inlier.numpy())
    assert agree >= 0.99


@pytest.mark.parametrize("which", ["H", "F"])
def test_find_via_ransac_matches_jax(which):
    p1, p2, v = two_view(planar=which == "H", seed=5)
    (jp1, jp2, jv), (tp1, tp2, tv) = _both(p1, p2, v)
    key = jax.random.PRNGKey(42)
    jmod, tmod = (jH, tH) if which == "H" else (jF, tF)
    rj = jmod.find_via_ransac(key, jp1, jp2, jv, num_hypotheses=256, recompute=False)
    rt = tmod.find_via_ransac(_seed(key), tp1, tp2, tv, num_hypotheses=256,
                              recompute=False)
    _check_result(rj, rt)
    # one LO refit on top
    rj = jmod.find_via_ransac(key, jp1, jp2, jv, num_hypotheses=256, recompute=True)
    rt = tmod.find_via_ransac(_seed(key), tp1, tp2, tv, num_hypotheses=256,
                              recompute=True)
    _check_result(rj, rt)


@pytest.mark.parametrize("which", ["H", "F"])
def test_escalated_sweep_matches_jax(which):
    p1, p2, v = two_view(n=300, planar=which == "H", outlier_frac=0.6, seed=9)
    (jp1, jp2, jv), (tp1, tp2, tv) = _both(p1, p2, v)
    key = jax.random.PRNGKey(5)
    seeds = [_seed(k) for k in jax.random.split(key, 4)]
    jmod, tmod = (jH, tH) if which == "H" else (jF, tF)
    rj = jmod.find_via_ransac_escalated(key, jp1, jp2, jv, num_hypotheses=256,
                                        num_chunks=4)
    rt = tmod.find_via_ransac_escalated(seeds, tp1, tp2, tv, num_hypotheses=256)
    _check_result(rj, rt)
