"""The port's minimal two-view fits against the JAX package's jitted ones,
stage by stage, counting the elements whose bits differ.

The JAX System runs its RANSAC (`find_via_ransac`) under `jax.jit`, so
each hypothesis's 8-point F (and 4-point H) is XLA's CPU program: read from
its optimized HLO and the bits, the Hartley means and deviations are
reductions that add in point order from 0 (and divide by k as a product
with 1 / k), A^T A and every small matrix product an FMA chain over k, the
Frobenius and column norms FMA chains from 0 with correctly rounded roots,
jnp.linalg.svd LAPACK's sgesdd through scipy, jnp.linalg.inv of H's
normalization a product by the diagonal's reciprocals, and the epipolar
cost's einsums FMA chains. The port's CPU plain (ops/solve/homography.py,
fundamental.py, ops/linalg.py) takes the same steps, so every stage below
equals JAX's program bit for bit: 0 elements apart at each, on random sets
and on the sets JAX's sampler draws from a two-view scene. (Before the
port took these forms, on 1024 random sets: `_normalize` 10 418 of 16 384
normalized coordinates apart, A^T A 64 078 of 82 944, the null vector from
the same A^T A 9209 of 9216.) Each stage of the port takes the port's own
previous stage; each of JAX's is a jitted prefix of compute_F_21 /
compute_H_21.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops.solve import fundamental as jF
from stella_vslam_tpu.ops.solve import homography as jH
from stella_vslam_tpu.ops.solve import ransac as jR
from stella_vslam_tpu_torch.ops import linalg as tl
from stella_vslam_tpu_torch.ops.solve import fundamental as tF
from stella_vslam_tpu_torch.ops.solve import homography as tH

from tests.test_torch_ransac import two_view

torch.set_num_threads(1)

# the stages and the elements held apart from JAX's jitted program at each
HELD = {"normalize": 0, "A": 0, "AtA": 0, "null_vector": 0, "svd": 0, "F": 0,
        "epipolar_cost": 0, "H_A": 0, "H_AtA": 0, "H_null_vector": 0, "H": 0}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def apart(j, t) -> int:
    """Elements whose bits differ (JAX's array or tuple against the port's)."""
    if isinstance(j, (tuple, list)):
        return sum(apart(a, b) for a, b in zip(j, t))
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    return int(np.sum(_bits(j) != _bits(t)))


def jax_stages(kind):
    """JAX's stages of compute_F_21 (kind "F") or compute_H_21 ("H") as
    jitted prefixes: {stage: jitted function of (pts1, pts2)}."""
    def prefix(p1, p2, upto):
        n1, T1 = jH._normalize(p1)
        n2, T2 = jH._normalize(p2)
        if upto == "normalize":
            return n1, T1, n2, T2
        x1, y1, x2, y2 = n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1]
        ones, zeros = jnp.ones_like(x1), jnp.zeros_like(x1)
        if kind == "F":
            A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], -1)
        else:
            A = jnp.concatenate([
                jnp.stack([zeros, zeros, zeros, -x1, -y1, -ones, y2 * x1, y2 * y1, y2], -1),
                jnp.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], -1)],
                axis=-2)
        if upto == "A":
            return A
        AtA = jnp.einsum("...ki,...kj->...ij", A, A)
        if upto == "AtA":
            return AtA
        f = jR.smallest_eigvec_sym(AtA)
        if upto == "null_vector":
            return f
        if upto == "svd":
            return jnp.linalg.svd(f.reshape(f.shape[:-1] + (3, 3)))
        raise ValueError(upto)
    stages = ["normalize", "A", "AtA", "null_vector"] + (["svd"] if kind == "F" else [])
    out = {s: jax.jit(lambda a, b, s=s: prefix(a, b, s)) for s in stages}
    out[kind] = jax.jit(jF.compute_F_21 if kind == "F" else jH.compute_H_21)
    return out


def port_stages(kind, p1, p2):
    """The port's stages, each on the port's previous one."""
    n1, T1 = tH._normalize(p1)
    n2, T2 = tH._normalize(p2)
    A = (tF if kind == "F" else tH).dlt_rows(n1, n2)
    AtA = tH.normal_matrix(A, minimal=True)
    f = tl.smallest_eigvec_spd_in_order(AtA)
    out = {"normalize": (n1, T1, n2, T2), "A": A, "AtA": AtA, "null_vector": f}
    if kind == "F":
        out["svd"] = tl.svd3_lapack(f.reshape(f.shape[:-1] + (3, 3)))
        out["F"] = tF.compute_F_21(p1, p2)
    else:
        out["H"] = tH.compute_H_21(p1, p2)
    return out


def random_sets(B, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 752, (B, k, 2)).astype(np.float32),
            rng.uniform(0, 480, (B, k, 2)).astype(np.float32))


def sampled_sets(B, k, seed):
    """The minimal sets JAX's sampler draws from a two-view scene's matches
    (tests/test_torch_ransac.py two_view, general for F, planar for H),
    with the matches."""
    p1, p2, v = two_view(n=400, planar=k == 4, seed=seed)
    idx = np.asarray(jR.sample_minimal_sets(jax.random.PRNGKey(seed), jnp.asarray(v), B, k))
    return p1[idx], p2[idx], p1, p2


@pytest.mark.parametrize("source", ["random", "sampled"])
def test_eight_point_stages_match_jax_jit(source):
    B = 1024
    s1, s2, m1, m2 = (sampled_sets(B, 8, 11) if source == "sampled"
                      else random_sets(B, 8, 42) + random_sets(1, 2872, 43))
    if source == "random":
        m1, m2 = m1[0], m2[0]
    jst = jax_stages("F")
    tst = port_stages("F", torch.from_numpy(s1), torch.from_numpy(s2))
    counts = {s: apart(f(s1, s2), tst[s]) for s, f in jst.items()}
    # the cost of every hypothesis on every match, from JAX's models
    Fj = np.asarray(jst["F"](s1, s2))
    jc = jax.jit(lambda F, a, b: jF._epipolar_cost(F, a[None], b[None], 1.0))(Fj, m1, m2)
    tc = tF._epipolar_cost(torch.from_numpy(Fj.copy()), torch.from_numpy(m1)[None],
                           torch.from_numpy(m2)[None], 1.0)
    counts["epipolar_cost"] = apart(jc, tc)
    print(f"F, {source} sets: elements apart from JAX's jitted program by stage {counts}")
    assert counts == {s: HELD[s] for s in counts}


@pytest.mark.parametrize("source", ["random", "sampled"])
def test_four_point_stages_match_jax_jit(source):
    B = 1024
    s1, s2 = (sampled_sets(B, 4, 12) if source == "sampled" else random_sets(B, 4, 44))[:2]
    jst = jax_stages("H")
    tst = port_stages("H", torch.from_numpy(s1), torch.from_numpy(s2))
    counts = {("H_" + s if s in ("A", "AtA", "null_vector") else s): apart(f(s1, s2), tst[s])
              for s, f in jst.items()}
    print(f"H, {source} sets: elements apart from JAX's jitted program by stage {counts}")
    assert counts == {s: HELD[s] for s in counts}
