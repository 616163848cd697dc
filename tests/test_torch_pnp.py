"""The port's PnP RANSAC (ops/solve/pnp.py, the plain version of kernel N)
against the JAX package's, on the CPU, with the same seed: JAX derives its
seed as the sum of its key's words (ransac._seed_from_key), so the key
[0, seed] hands it the port's.

Problem from a numpy seed: 400 bearings of points 3-7 m away under a known
pose, 20% replaced by random directions, 5% invalid, levels 0-3.
* the sampled sets are equal (the hash is integer arithmetic);
* hypotheses: the ok flags equal and (R, t) within 1e-4 where both are ok, on
  at least 95% of the 2048 hypotheses. Not all: a Newton start near a double
  root lands on another root when the last bit of a product differs, and
  JAX's own jitted and eager p3p_grunert part on 2.5% of the hypotheses of
  this problem (the test prints both shares);
* the winner: the same inlier set, the pose within 1e-4 (measured 1.4e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from stella_vslam_tpu.ops.solve import pnp as jpnp
from stella_vslam_tpu.ops.solve import ransac as jransac
from stella_vslam_tpu_torch.ops.solve import pnp as tpnp
from stella_vslam_tpu_torch.ops.solve import ransac as transac

torch.set_num_threads(1)
SEED = 12345


def problem(n=400, seed=1):
    rng = np.random.default_rng(seed)
    P = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    P[:, 2] += 5
    a = 0.2
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    t = np.array([0.3, -0.1, 0.2], np.float32)
    pc = P @ R.T + t
    b = pc / np.linalg.norm(pc, axis=1, keepdims=True)
    n_out = n // 5
    b[:n_out] = rng.normal(size=(n_out, 3))
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    valid[-n // 20:] = False
    return dict(b=b.astype(np.float32), P=P, octaves=rng.integers(0, 4, n).astype(np.int32),
                valid=valid, sf=np.array([1.2 ** i for i in range(8)], np.float32), R=R, t=t,
                n_out=n_out)


def _key(seed):
    return jnp.asarray([0, seed], dtype=jnp.uint32)


def test_seed_and_sampled_sets_equal():
    p = problem()
    assert int(jransac._seed_from_key(_key(SEED))) == SEED
    ij = np.asarray(jransac.sample_minimal_sets(_key(SEED), jnp.asarray(p["valid"]), 256, 3))
    it = transac.sample_minimal_sets(SEED, torch.from_numpy(p["valid"]), 256, 3).numpy()
    assert np.array_equal(ij, it)
    assert p["valid"][it].all()


def test_p3p_hypotheses_match_jax():
    p = problem()
    idx = transac.sample_minimal_sets(SEED, torch.from_numpy(p["valid"]), 256, 3).numpy()
    fb, fP = p["b"][idx], p["P"][idx]
    Rj, tj, okj = (np.asarray(x) for x in jax.jit(jpnp.p3p_grunert)(jnp.asarray(fb),
                                                                   jnp.asarray(fP)))
    Re, _, oke = (np.asarray(x) for x in jpnp.p3p_grunert(jnp.asarray(fb), jnp.asarray(fP)))
    Rt, tt, okt = (x.numpy() for x in tpnp.p3p_grunert(torch.from_numpy(fb),
                                                       torch.from_numpy(fP)))
    assert Rt.shape == (256, 8, 3, 3) and okt.shape == (256, 8)
    d = np.maximum(np.abs(Rj - Rt).reshape(256, 8, 9).max(-1), np.abs(tj - tt).max(-1))
    both = okj & okt
    share = float((d[both] <= 1e-4).mean())
    own = float((np.abs(Rj - Re).reshape(256, 8, 9).max(-1)[okj & oke] <= 1e-4).mean())
    print(f"ok flags equal {(okj == okt).mean():.4f}; within 1e-4 where both ok: port vs "
          f"jitted JAX {share:.4f}, eager vs jitted JAX {own:.4f}")
    assert (okj == okt).mean() >= 0.99
    assert both.sum() > 500 and share >= 0.95
    # an invalid hypothesis is the identity in both
    assert np.array_equal(Rt[~okt], np.broadcast_to(np.eye(3, dtype=np.float32),
                                                    Rt[~okt].shape))


def test_find_via_ransac_matches_jax():
    p = problem()
    rj = jpnp.find_via_ransac(_key(SEED), jnp.asarray(p["b"]), jnp.asarray(p["P"]),
                              jnp.asarray(p["octaves"]), jnp.asarray(p["valid"]),
                              scale_factors=jnp.asarray(p["sf"]), min_num_inliers=15)
    t = torch.from_numpy
    rt = tpnp.find_via_ransac(SEED, t(p["b"]), t(p["P"]), t(p["octaves"]), t(p["valid"]),
                              scale_factors=t(p["sf"]), min_num_inliers=15)
    assert bool(rj.valid) and bool(rt.valid)
    assert np.array_equal(np.asarray(rj.is_inlier), rt.is_inlier.numpy())
    assert int(rt.num_inliers) == int(rj.num_inliers) >= 280
    assert np.abs(np.asarray(rj.R_cw) - rt.R_cw.numpy()).max() < 1e-4
    assert np.abs(np.asarray(rj.t_cw) - rt.t_cw.numpy()).max() < 1e-4
    # and it is the pose: no replaced bearing and no invalid row is an inlier
    assert np.abs(rt.R_cw.numpy() - p["R"]).max() < 1e-3
    assert not rt.is_inlier.numpy()[~p["valid"]].any()


def test_too_few_inliers_is_invalid_in_both():
    p = problem(n=60, seed=3)
    rng = np.random.default_rng(4)
    b = rng.normal(size=p["b"].shape).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    rj = jpnp.find_via_ransac(_key(7), jnp.asarray(b), jnp.asarray(p["P"]),
                              jnp.asarray(p["octaves"]), jnp.asarray(p["valid"]),
                              scale_factors=jnp.asarray(p["sf"]), min_num_inliers=15)
    t = torch.from_numpy
    rt = tpnp.find_via_ransac(7, t(b), t(p["P"]), t(p["octaves"]), t(p["valid"]),
                              scale_factors=t(p["sf"]), min_num_inliers=15)
    assert not bool(rj.valid) and not bool(rt.valid)
