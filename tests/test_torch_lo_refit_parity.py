"""The port's LO refit (a two-view fit over every match with a mask) against
the JAX package's jitted compute_F_21 / compute_H_21 with `valid`, stage by
stage, counting the elements whose bits differ.

XLA's CPU program splits each masked sum of `_normalize` (the count, the
sum of the points, the sum of the absolute deviations) into windows of 32
rows, padded with zeros floor(P / 2) before and ceil(P / 2) after to a
multiple of 32, each summed in order from 0, then the same over the
partials while more than 32 remain, then a sum in order of the last few
(its optimized HLO: `reduce-window` size 32, `pad=4_4` at N = 2872, `8_9`
then `13_13` at 1199, `2_2` at 700, `15_16` at 33). The mean and the
deviation are true divisions by the count. The port's plain
(`ops/linalg.sum_windowed`) takes that order, so the sums, T and the
normalised points equal JAX's bit for bit.

A^T A is an HLO dot. Up to 384 rows XLA emits an FMA chain over the rows
from 0, which the port takes (`homography.CHAIN_ROWS`); from 385 rows the
dot is a runtime matrix product whose order none of the candidates
tried reproduces (ROADMAP Queue 3): there the port keeps torch's einsum,
and A^T A and what follows it are held to a tolerance, with the count apart
printed (on an 8-core Xeon with AVX-512: F 69-73 of 81 entries at
700-2872 rows).
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

torch.set_num_threads(1)

SIZES = [2872, 1199, 700, 33]
EXACT = ("cnt", "mean", "dev", "normalized", "T")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def apart(j, t) -> int:
    if isinstance(j, (tuple, list)):
        return sum(apart(a, b) for a, b in zip(j, t))
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    return int(np.sum(_bits(j) != _bits(t)))


def masked_matches(N, seed):
    """N pixel matches (752 x 480) with a quarter of them masked out."""
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(0, 752, N), rng.uniform(0, 480, N)], -1).astype(np.float32)
    p2 = (p1 + rng.normal(0, 6.0, (N, 2))).astype(np.float32)
    return p1, p2, rng.random(N) < 0.75


def jax_stages(kind):
    """JAX's stages as jitted prefixes of its masked fit: the sums as
    `_normalize` writes them, then its own functions."""
    def sums(p, v):
        w = v[..., None].astype(p.dtype)
        cnt = jnp.sum(w, axis=-2, keepdims=True) + 1e-12
        mean = jnp.sum(p * w, axis=-2, keepdims=True) / cnt
        dev = jnp.sum(jnp.abs(p - mean) * w, axis=-2, keepdims=True) / cnt + 1e-12
        return cnt, mean, dev

    def ata(p1, p2, v):
        n1, _ = jH._normalize(p1, v)
        n2, _ = jH._normalize(p2, v)
        x1, y1, x2, y2 = n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1]
        ones, zeros = jnp.ones_like(x1), jnp.zeros_like(x1)
        if kind == "F":
            A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], -1)
            A = A * v[..., None].astype(A.dtype)
        else:
            A = jnp.concatenate([
                jnp.stack([zeros, zeros, zeros, -x1, -y1, -ones, y2 * x1, y2 * y1, y2], -1),
                jnp.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], -1)],
                axis=-2)
            A = A * jnp.concatenate([v, v], -1)[..., None].astype(A.dtype)
        return jnp.einsum("...ki,...kj->...ij", A, A)

    return {"sums": jax.jit(sums), "normalize": jax.jit(jH._normalize), "AtA": jax.jit(ata),
            "null_vector": jax.jit(jR.smallest_eigvec_sym),
            "model": jax.jit(jF.compute_F_21 if kind == "F" else jH.compute_H_21)}


def port_sums(p, v):
    w = v[..., None].to(p.dtype)
    cnt = tl.sum_windowed(w, -2)[..., None, :] + 1e-12
    mean = tl.sum_windowed(p * w, -2)[..., None, :] / cnt
    dev = tl.sum_windowed(torch.abs(p - mean) * w, -2)[..., None, :] / cnt + 1e-12
    return cnt, mean, dev


@pytest.mark.parametrize("kind", ["F", "H"])
@pytest.mark.parametrize("N", SIZES)
def test_masked_refit_stages_match_jax_jit(kind, N):
    p1, p2, v = masked_matches(N, seed=N + (0 if kind == "F" else 1))
    t1, t2, tv = torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(v)
    jst = jax_stages(kind)
    counts = {}
    for name, j, t in zip(("cnt", "mean", "dev"), jst["sums"](p1, v), port_sums(t1, tv)):
        counts[name] = apart(j, t)
    (jn1, jT1), (jn2, jT2) = jst["normalize"](p1, v), jst["normalize"](p2, v)
    (n1, T1), (n2, T2) = tH._normalize(t1, tv), tH._normalize(t2, tv)
    counts["normalized"] = apart((jn1, jn2), (n1, n2))
    counts["T"] = apart((jT1, jT2), (T1, T2))
    if kind == "F":
        A = tF.dlt_rows(n1, n2) * tv[..., None].float()
    else:
        A = tH.dlt_rows(n1, n2) * torch.cat([tv, tv])[..., None].float()
    AtA = tH.normal_matrix(A, minimal=False)
    jAtA = np.asarray(jst["AtA"](p1, p2, v))
    counts["AtA"] = apart(jAtA, AtA)
    f = tl.smallest_eigvec_spd_in_order(AtA)
    jf = np.asarray(jst["null_vector"](jAtA))
    counts["null_vector"] = apart(jf, f)
    model = (tF.compute_F_21 if kind == "F" else tH.compute_H_21)(t1, t2, tv)
    jm = np.asarray(jst["model"](p1, p2, v))
    counts["model"] = apart(jm, model)
    rows = A.shape[0]
    print(f"{kind} refit over N={N} ({rows} rows): elements apart from JAX's jitted program "
          f"by stage {counts}")
    assert {s: counts[s] for s in EXACT} == {s: 0 for s in EXACT}
    if rows <= tH.CHAIN_ROWS:
        assert counts["AtA"] == counts["null_vector"] == counts["model"] == 0
    else:
        # the runtime product's order is not reproduced: a tolerance
        scale = float(np.abs(jAtA).max())
        assert np.abs(jAtA - AtA.numpy()).max() <= 1e-5 * scale
        sign = np.sign(float(np.dot(jf, f.numpy())))
        assert np.abs(jf - sign * f.numpy()).max() <= 1e-3
        jm, tm = jm / np.linalg.norm(jm), model.numpy() / np.linalg.norm(model.numpy())
        assert np.abs(jm - np.sign(float((jm * tm).sum())) * tm).max() <= 1e-3


@pytest.mark.parametrize("N", [1, 31, 32, 33, 64, 65, 1024, 1025, 40000])
def test_sum_windowed_matches_jax_jit_sum(N):
    """The windowed order on its own, at the edges of its padding rule."""
    rng = np.random.default_rng(N)
    x = (rng.standard_normal((N, 2)) * 100).astype(np.float32)
    j = jax.jit(lambda a: jnp.sum(a, axis=0))(x)
    assert apart(j, tl.sum_windowed(torch.from_numpy(x), 0)) == 0
