"""The port's landmark fusion against the JAX package's, on the CPU.

Landmarks are frame 0's valid keypoints of the test plane world (400x300,
4 levels, min_size 400) back-projected onto the plane, with their
descriptors perturbed by a seeded number of bit flips (most by a few bits,
some by many), distance ranges and normals as the landmark statistics
give them, and a tenth marked invalid. They are fused into frames 0, 5 and
10 of lateral_trajectory at their ground-truth poses; a fifth of the
keypoints carry a stereo x_right 3 px left of their u, so the 3-D
chi-square branch runs too. Both packages get the same inputs:

* reproject_for_fuse (kernel L's prologue): predicted octave and gate
  exact, projections within 1e-4 px;
* detect_duplication (kernel L's scan with the duplicate resolution):
  best index, best distance and accepted flags exact;
* MappingKernels.fuse (kernel L's plain version) against
  MappingKernels.fuse_multi, three keyframes and a padding one: accepted
  flags exact, best indices exact on the real keyframes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.match import fuse as jfuse
from stella_vslam_tpu.module.mapping_kernels import MappingKernels as JMappingKernels
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.match import fuse
from stella_vslam_tpu_torch.module.mapping_kernels import (
    FuseKeyframes, MappingKernels, reproject_for_fuse)
from tests.synthetic_world import PlaneWorld, lateral_trajectory
from tests.test_torch_initializer import cfg_dict

torch.set_num_threads(1)

FRAMES = (0, 5, 10)


@pytest.fixture(scope="module")
def data():
    world = PlaneWorld()
    gt = lateral_trajectory(11)
    jslam = JSystem(JConfig.from_dict(cfg_dict(world)), inline_mapping=True)
    jfr = [jslam.create_monocular_frame(world.render(gt[i]), i * 0.05) for i in FRAMES]
    cam = camera_from_yaml(world.camera_yaml())
    orb = OrbParams(num_levels=4)
    pfr = [convert.frame(f, cam, orb, device="cpu") for f in jfr]
    rng = np.random.default_rng(11)
    f0 = pfr[0]
    sel = np.nonzero(f0.h_valid)[0]
    T0 = gt[0]
    R0, t0 = T0[:3, :3], T0[:3, 3]
    C0 = -R0.T @ t0
    rays = f0.h_bearings[sel].astype(np.float64) @ R0  # world directions
    s = (world.depth - C0[2]) / rays[:, 2]
    pos = C0 + s[:, None] * rays
    dist = np.linalg.norm(pos - C0, axis=1)
    sf = np.asarray(orb.scale_factors)
    dmax = dist * sf[f0.h_level[sel]]
    desc = f0.h_desc[sel].copy()
    nflip = np.where(rng.random(len(sel)) < 0.6, rng.integers(0, 6, len(sel)),
                     rng.integers(20, 60, len(sel)))
    for i, k in enumerate(nflip):
        for bit in rng.choice(256, k, replace=False):
            desc[i, bit // 32] ^= np.uint32(1 << (bit % 32))
    lm = dict(pos=pos.astype(np.float32), desc=desc, dmax=dmax.astype(np.float32),
              dmin=(dmax / sf[-1]).astype(np.float32),
              normal=((pos - C0) / dist[:, None]).astype(np.float32),
              valid=rng.random(len(sel)) < 0.9)
    xr = []
    for f in pfr:
        u = f.h_undist_xy[:, 0]
        xr.append(np.where(rng.random(f.num_slots) < 0.2, u - 3.0, -1.0).astype(np.float32))
    poses = [gt[i].astype(np.float32) for i in FRAMES]
    return dict(jslam=jslam, jfr=jfr, pfr=pfr, cam=cam, orb=orb, lm=lm, xr=xr, poses=poses)


def _lm_f(lm):
    return torch.from_numpy(np.concatenate(
        [lm["pos"], lm["dmin"][:, None], lm["dmax"][:, None], lm["normal"]], 1))


def _desc_t(d):
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32))


def _jax_reproject(d, b):
    jmk = JMappingKernels(d["jslam"].camera, d["jslam"].orb_params)
    P, lm = d["poses"][b], d["lm"]
    return jmk.reproject_landmarks_for_fuse(
        jnp.asarray(P[:3, :3]), jnp.asarray(P[:3, 3]), jnp.asarray(lm["pos"]),
        jnp.asarray(lm["dmin"]), jnp.asarray(lm["dmax"]), jnp.asarray(lm["normal"]),
        jnp.asarray(lm["valid"]))


def test_reproject_for_fuse_matches_jax(data):
    mk = MappingKernels(data["cam"], data["orb"], device="cpu")
    n_gate = 0
    for b in range(len(FRAMES)):
        P = torch.from_numpy(data["poses"][b])
        uv, xr, pred, gate = reproject_for_fuse(
            mk.cam, mk.log_scale, 4, P[:3, :3], P[:3, 3], _lm_f(data["lm"]),
            torch.from_numpy(data["lm"]["valid"]))
        juv, jxr, jpred, jgate = [np.asarray(x) for x in _jax_reproject(data, b)]
        np.testing.assert_array_equal(pred.numpy(), jpred)
        np.testing.assert_array_equal(gate.numpy(), jgate)
        np.testing.assert_allclose(uv.numpy(), juv, atol=1e-4)
        np.testing.assert_allclose(xr.numpy(), jxr, atol=1e-4)
        n_gate += int(jgate.sum())
    assert n_gate > 200, n_gate


def test_detect_duplication_exact(data):
    orb = data["orb"]
    sf = np.asarray(orb.scale_factors, np.float32)
    sig = np.asarray(orb.level_sigma_sq, np.float32)
    n_acc = 0
    for b in range(len(FRAMES)):
        juv, jxr, jpred, jgate = _jax_reproject(data, b)
        jf, pf = data["jfr"][b], data["pfr"][b]
        xr = data["xr"][b]
        ji, ja, jb = jfuse.detect_duplication(
            jf.undist_xy, jf.feats.level, jf.feats.desc, jf.feats.valid, jnp.asarray(xr),
            jnp.asarray(data["lm"]["desc"]), juv, jxr, jpred, jgate,
            scale_factors=jnp.asarray(sf), level_sigma_sq=jnp.asarray(sig),
            num_levels=4, margin=3.0)
        t = lambda a: torch.from_numpy(np.array(a))
        pi, pa, pb = fuse.detect_duplication(
            pf.undist_xy, pf.feats.level, pf.feats.desc, pf.feats.valid, t(xr),
            _desc_t(data["lm"]["desc"]), t(juv), t(jxr), t(jpred), t(jgate),
            scale_factors=t(sf), level_sigma_sq=t(sig))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
        n_acc += int(np.asarray(ja).sum())
    assert n_acc > 100, n_acc


def test_fuse_matches_jax(data):
    """Keyframes 0, 5, 10 and a padding copy of 0 (batch_valid false)."""
    idx = [0, 1, 2, 0]
    bv = np.array([True, True, True, False])
    pf, jf, lm = data["pfr"], data["jfr"], data["lm"]
    st = lambda fn: torch.stack([fn(pf[i]) for i in idx])
    kfs = FuseKeyframes(st(lambda f: f.undist_xy), st(lambda f: f.feats.level),
                        st(lambda f: f.feats.desc), st(lambda f: f.feats.valid),
                        torch.from_numpy(np.stack([data["xr"][i] for i in idx])))
    P = np.stack([np.concatenate([data["poses"][i][:3, :3].reshape(9),
                                  data["poses"][i][:3, 3]]) for i in idx]).astype(np.float32)
    mk = MappingKernels(data["cam"], data["orb"], device="cpu")
    best, acc = mk.fuse(kfs, torch.from_numpy(P), torch.from_numpy(bv), _lm_f(lm),
                        _desc_t(lm["desc"]), torch.from_numpy(lm["valid"]))
    jmk = JMappingKernels(data["jslam"].camera, data["jslam"].orb_params)
    js = lambda fn: jnp.stack([fn(jf[i]) for i in idx])
    jbest, jacc = jmk.fuse_multi(
        js(lambda f: f.undist_xy), js(lambda f: f.feats.level), js(lambda f: f.feats.desc),
        js(lambda f: f.feats.valid), jnp.asarray(np.stack([data["xr"][i] for i in idx])),
        jnp.asarray(P[:, :9].reshape(-1, 3, 3)), jnp.asarray(P[:, 9:12]), jnp.asarray(bv),
        jnp.asarray(lm["pos"]), jnp.asarray(lm["desc"]), jnp.asarray(lm["dmin"]),
        jnp.asarray(lm["dmax"]), jnp.asarray(lm["normal"]), jnp.asarray(lm["valid"]),
        margin=3.0)
    jacc = np.asarray(jacc)
    np.testing.assert_array_equal(acc.numpy(), jacc)
    np.testing.assert_array_equal(best.numpy()[:3], np.asarray(jbest)[:3])
    assert jacc.sum() > 100 and not jacc[3].any()
