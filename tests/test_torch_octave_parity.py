"""The predicted octave and fusion's distance gate against the JAX package's
jitted code, on the CPU, where the two ways of dividing by a constant part.

XLA folds a jitted division by a constant into a product with the float32
reciprocal, so the JAX package computes ceil(log(r) / log_scale) (the
tracker's stage 3, module/tracking_kernels.py:276-280, and fusion's
_reproject_for_fuse_impl, module/mapping_kernels.py:323-328) and fusion's
dist >= dmin / 1.3 (:320) with the reciprocals, and takes log_scale as the
correctly rounded float32 log of the float32 factor. The port's helpers
(camera.base.log_scale_of, predicted_octave, DMIN_SCALE) do the same.

Landmarks sit on the optical axis of a camera at the origin, (0, 0, z), so
that their distance is z exactly; with z a power of two, dmax / dist is the
float32 ratio chosen. The ratios are the float32 values within 3000
ulps of 1.2^k (k = 1..7) where the port's former form (numpy's float32 log
and a true division) and the JAX package part, with as many where they
agree; at fusion's lower bound the distance is set to dmin * f32(1 / 1.3)
where that differs from dmin / 1.3. The octave and the gate must equal JAX's on
every row where torch's and XLA's CPU log agree; where the logs differ by
an ulp, an octave at a ceil may differ (ROADMAP Queue 3 states the share),
and those rows are counted, not compared.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu.feature.orb_params import OrbParams as JOrbParams
from stella_vslam_tpu.module.mapping_kernels import MappingKernels as JMappingKernels
from stella_vslam_tpu.module.tracking_kernels import TrackingKernels as JTrackingKernels
from stella_vslam_tpu_torch.camera import base as tcam
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.module.mapping_kernels import MappingKernels, reproject_for_fuse
from stella_vslam_tpu_torch.module.tracking_kernels import TrackingKernels

torch.set_num_threads(1)

YAML = {"name": "axis", "model": "perspective", "setup": "monocular", "fx": 458.654,
        "fy": 457.296, "cx": 367.215, "cy": 248.375, "cols": 752, "rows": 480, "fps": 20.0}
LEVELS = 8
# every scale factor of the repo's configurations and tests (1.2, the
# default; 2.0, test_torch_pyramid_plan.py) and sqrt(2) and 1.1, where
# numpy's float32 log is an ulp off JAX's too
FACTORS = [1.2, 2.0, math.sqrt(2.0), 1.1]


@pytest.mark.parametrize("sf", FACTORS)
def test_log_scale_matches_jax(sf):
    """log_scale_of and both kernels' classes take JAX's float32 log."""
    want = float(jnp.log(jnp.float32(sf)))
    assert tcam.log_scale_of(sf) == want
    cam = tcam.camera_from_yaml(YAML)
    orb = OrbParams(num_levels=LEVELS, scale_factor=sf)
    assert MappingKernels(cam, orb, device="cpu").log_scale == want
    assert TrackingKernels(cam, orb, device="cpu").log_scale == want
    jorb = JOrbParams(num_levels=LEVELS, scale_factor=sf)
    assert JTrackingKernels(jcam.camera_from_yaml(YAML), jorb).log_scale == want


def _jax_log(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))


def _axis_landmarks(dist: np.ndarray, dmin: np.ndarray, dmax: np.ndarray):
    """Landmarks on the optical axis at z = dist (their distance to the
    camera at the origin, exactly), normal (0, 0, 1): the packed fuse rows
    [M,8] (pos | dmin | dmax | normal) as float32."""
    rows = np.zeros((len(dist), 8), np.float32)
    rows[:, 2], rows[:, 3], rows[:, 4], rows[:, 7] = dist, dmin, dmax, 1.0
    return rows


def _octave_rows(ratios: np.ndarray, seed: int):
    """Rows whose dmax / dist is `ratios` exactly: dist a power of two in
    [1, 8] (seeded), dmax = ratio * dist, dmin = dist / 2."""
    z = (np.float32(2.0) ** np.random.default_rng(seed).integers(0, 4, len(ratios))).astype(
        np.float32)
    rows = _axis_landmarks(z, z / 2, ratios * z)
    assert np.array_equal(rows[:, 4] / rows[:, 2], ratios)
    return rows


def _ceil_ratios(sf: float, seed: int):
    """Float32 ratios within 3000 ulps of sf^k (k = 1..7): every one where
    the port's former octave (numpy's float32 log constant, a true
    division) differs from the reciprocal form on the JAX constant, and as
    many where they agree. Returns (ratios, logs agree with XLA's)."""
    old_ls = float(np.log(np.float32(sf)))
    inv = np.float32(1.0) / np.float32(math.log(float(np.float32(sf))))
    near = []
    for k in range(1, LEVELS):
        c = np.float32(sf ** k).view(np.int32)
        near.append(np.arange(c - 3000, c + 3000, dtype=np.int32).view(np.float32))
    r = np.concatenate(near)
    lt = torch.log(torch.from_numpy(r))
    old = torch.ceil(lt / old_ls).numpy()
    new = torch.ceil(lt * torch.tensor(inv)).numpy()
    part = np.nonzero(old != new)[0]
    same = np.random.default_rng(seed).choice(np.nonzero(old == new)[0], len(part),
                                              replace=False)
    r = r[np.concatenate([part, same])]
    return r, torch.log(torch.from_numpy(r)).numpy() == _jax_log(r), len(part)


def _dmin_rows(n: int, seed: int):
    """Rows at fusion's lower distance bound: for seeded dmin in [0.5, 20],
    the distance is the lesser of dmin / 1.3 (a true division) and dmin *
    f32(1 / 1.3) where the two differ, so that the two forms gate the row
    apart; dmax = 1.5 x the distance. Returns (rows, those at the bound)."""
    rng = np.random.default_rng(seed)
    dmin = rng.uniform(0.5, 20.0, 20 * n).astype(np.float32)
    q_div = dmin / np.float32(1.3)
    q_mul = dmin * (np.float32(1.0) / np.float32(1.3))
    at = np.nonzero(q_div != q_mul)[0][:n]
    assert len(at) == n
    dmin = np.concatenate([dmin[at], rng.uniform(0.5, 20.0, n).astype(np.float32)])
    dist = np.concatenate([np.minimum(q_div, q_mul)[at], dmin[n:] * np.float32(0.9)])
    return _axis_landmarks(dist, dmin, dist * np.float32(1.5)), np.arange(2 * n) < n


def test_fuse_octave_and_dmin_gate_match_jax():
    """reproject_for_fuse (kernel L's plain prologue) against JAX's
    _reproject_for_fuse_impl at octave ceils and at dist == dmin / 1.3."""
    ratios, log_ok, n_part = _ceil_ratios(1.2, seed=1)
    drows, at_bound = _dmin_rows(200, seed=2)
    rows = np.concatenate([_octave_rows(ratios, seed=3), drows])
    log_ok = np.concatenate([log_ok, np.ones(len(drows), bool)])
    M = len(rows)
    jorb = JOrbParams(num_levels=LEVELS, scale_factor=1.2)
    jmk = JMappingKernels(jcam.camera_from_yaml(YAML), jorb)
    eye, zero = jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)
    _, _, jpred, jgate = (np.asarray(a) for a in jmk.reproject_landmarks_for_fuse(
        eye, zero, jnp.asarray(rows[:, 0:3]), jnp.asarray(rows[:, 3]),
        jnp.asarray(rows[:, 4]), jnp.asarray(rows[:, 5:8]), jnp.ones(M, bool)))
    mk = MappingKernels(tcam.camera_from_yaml(YAML), OrbParams(num_levels=LEVELS),
                        device="cpu")
    _, _, pred, gate = reproject_for_fuse(
        mk.cam, mk.log_scale, LEVELS, torch.eye(3), torch.zeros(3), torch.from_numpy(rows),
        torch.ones(M, dtype=torch.bool), mk.camera.model)
    pred, gate = pred.numpy(), gate.numpy()
    # f32(1 / 1.3) lies below 1 / f32(1.3): where the two forms differ, the
    # product is the lesser, and JAX keeps a row at that distance
    assert n_part > 0 and bool(jgate[len(ratios):][at_bound].all())
    assert np.array_equal(gate, jgate), int((gate != jgate).sum())
    differ = pred != jpred
    assert not np.any(differ & log_ok), (int(np.sum(differ & log_ok)), M)
    # where XLA's log and torch's differ by an ulp, an octave may differ
    assert np.sum(differ) <= np.sum(~log_ok)


def test_tracker_octave_matches_jax():
    """The tracker's window rows (kernel R's plain table mode) against the
    JAX tracker's stage-3 octave, jitted as track_frame is, with its own
    log_scale, at octave ceils."""
    ratios, log_ok, n_part = _ceil_ratios(1.2, seed=4)
    rows = _octave_rows(ratios, seed=5)
    M = len(rows)
    jtk = JTrackingKernels(jcam.camera_from_yaml(YAML),
                           JOrbParams(num_levels=LEVELS, scale_factor=1.2))

    @jax.jit
    def stage3_octave(dist, tbl_max_dist):
        # module/tracking_kernels.py:276-280
        ratio = jnp.maximum(tbl_max_dist, 1e-9) / jnp.maximum(dist, 1e-9)
        return jnp.clip(jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / jtk.log_scale),
                        0, LEVELS - 1).astype(jnp.int32)

    jpred = np.asarray(stage3_octave(jnp.asarray(rows[:, 2]), jnp.asarray(rows[:, 4])))
    tk = TrackingKernels(tcam.camera_from_yaml(YAML), OrbParams(num_levels=LEVELS),
                         device="cpu")
    tbl = np.concatenate([rows[:, 0:3], rows[:, 5:8], rows[:, 3:5]], 1)
    u32 = np.zeros((M, 10), np.int32)
    u32[:, 9] = 1
    out = tcam.project_window_rows_plain(
        tk.camera.params, torch.eye(3), torch.zeros(3), torch.from_numpy(tbl),
        scale_factors=tk.scale_factors, margin=5.0, tbl_u32=torch.from_numpy(u32),
        log_scale=tk.log_scale, num_levels=LEVELS)
    pred = out.pred_scale.numpy()
    assert n_part > 0 and bool(out.valid.all())
    differ = pred != jpred
    assert not np.any(differ & log_ok), (int(np.sum(differ & log_ok)), M)
    assert np.sum(differ) <= np.sum(~log_ok)



STEREO_YAML = dict(YAML, name="stereo", setup="stereo", focal_x_baseline=50.3213)


def _stereo_landmarks(M: int, seed: int):
    """Seeded landmarks in front of a turned camera, over depths 0.5-30."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((M, 8), np.float32)
    rows[:, 2] = rng.uniform(0.5, 30.0, M)
    rows[:, 0] = rng.uniform(-0.7, 0.7, M) * rows[:, 2]
    rows[:, 1] = rng.uniform(-0.5, 0.5, M) * rows[:, 2]
    rows[:, 3], rows[:, 4], rows[:, 7] = 0.1, 100.0, 1.0
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    return rows, R, np.array([0.1, -0.2, 0.3], np.float32)


@pytest.mark.parametrize("path", ["fuse", "tracker"])
def test_x_right_matches_jax(path):
    """The predicted x_right u - focal_x_baseline / depth, bit for bit
    against the JAX package's, for fusion (reproject_for_fuse against
    _reproject_for_fuse_impl) and the tracker's window rows (against stage
    3's lm_xr_t, module/tracking_kernels.py:281-285, jitted). The divisor
    varies, so XLA keeps a true division; torch's `float / tensor` would
    take the reciprocal and round twice (96 of these 20000 rows apart)."""
    M = 20000
    rows, R, t = _stereo_landmarks(M, seed=6)
    jcamera = jcam.camera_from_yaml(STEREO_YAML)
    if path == "fuse":
        jmk = JMappingKernels(jcamera, JOrbParams(num_levels=LEVELS, scale_factor=1.2))
        juv, jxr, _, _ = (np.asarray(a) for a in jmk.reproject_landmarks_for_fuse(
            jnp.asarray(R), jnp.asarray(t), jnp.asarray(rows[:, 0:3]), jnp.asarray(rows[:, 3]),
            jnp.asarray(rows[:, 4]), jnp.asarray(rows[:, 5:8]), jnp.ones(M, bool)))
        mk = MappingKernels(tcam.camera_from_yaml(STEREO_YAML), OrbParams(num_levels=LEVELS),
                            device="cpu")
        uv, xr, _, _ = reproject_for_fuse(
            mk.cam, mk.log_scale, LEVELS, torch.from_numpy(R), torch.from_numpy(t),
            torch.from_numpy(rows), torch.ones(M, dtype=torch.bool), mk.camera.model)
        u, xr = uv[:, 0].numpy(), xr.numpy()
    else:
        p = jcamera.params

        @jax.jit
        def stage3_xr(R_, t_, pos):
            uv_t, depth_t, _ = jcam.reproject_to_image(jcamera.model, p, R_, t_, pos)
            return uv_t[:, 0], jnp.where(
                depth_t > 1e-6, uv_t[:, 0] - p.focal_x_baseline / jnp.maximum(depth_t, 1e-6),
                -1.0)

        juv0, jxr = (np.asarray(a) for a in stage3_xr(jnp.asarray(R), jnp.asarray(t),
                                                       jnp.asarray(rows[:, 0:3])))
        juv = np.stack([juv0, juv0], 1)
        tk = TrackingKernels(tcam.camera_from_yaml(STEREO_YAML), OrbParams(num_levels=LEVELS),
                             device="cpu")
        tbl = np.concatenate([rows[:, 0:3], rows[:, 5:8], rows[:, 3:5]], 1)
        u32 = np.zeros((M, 10), np.int32)
        u32[:, 9] = 1
        out = tcam.project_window_rows_plain(
            tk.camera.params, torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(tbl),
            scale_factors=tk.scale_factors, margin=5.0, tbl_u32=torch.from_numpy(u32),
            log_scale=tk.log_scale, num_levels=LEVELS)
        u, xr = out.u.numpy(), out.xr.numpy()
    assert tcam.camera_from_yaml(STEREO_YAML).params.focal_x_baseline > 0
    assert np.array_equal(u, juv[:, 0]), int(np.sum(u != juv[:, 0]))
    assert np.array_equal(xr, jxr), int(np.sum(xr != jxr))

def _shares(sf: float = 1.2, ulps: int = 3000):
    """Over the float32 ratios within `ulps` of sf^k (k = 1..LEVELS-1): the
    share whose torch and XLA CPU logs differ, and the shares whose octave
    differs from JAX's jitted one, in the port's form and in the former
    one (numpy's float32 log constant, a true division)."""
    r = np.concatenate([np.arange(np.float32(sf ** k).view(np.int32) - ulps,
                                  np.float32(sf ** k).view(np.int32) + ulps,
                                  dtype=np.int32).view(np.float32) for k in range(1, LEVELS)])
    inv = np.float32(1.0) / np.float32(tcam.log_scale_of(sf))
    lt, lj = torch.log(torch.from_numpy(r)).numpy(), _jax_log(r)
    jax_ = np.ceil(lj * inv)
    former = torch.ceil(torch.from_numpy(lt) / float(np.log(np.float32(sf)))).numpy()
    return dict(ratios=len(r), log_differs=float(np.mean(lt != lj)),
                octave_differs=float(np.mean(np.ceil(lt * inv) != jax_)),
                former_octave_differs=float(np.mean(former != jax_)))


def test_log_differs_from_xla_on_a_small_share():
    """The difference kept (ROADMAP Queue 3): torch's and XLA's CPU log of
    float32 ratios near 1.2^k differ by an ulp on a few percent, and the
    octave of such a ratio at a ceil can then differ from JAX's; the share
    of ratios within 3000 ulps of a ceil whose octave differs stays
    below 1%."""
    sh = _shares()
    assert 0.0 < sh["log_differs"] < 0.25 and sh["octave_differs"] < 0.01, sh


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(_shares())
