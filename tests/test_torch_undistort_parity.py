"""The port's keypoint undistortion and bearings against the JAX System's
jitted preprocessing, on the same seeded pixels.

The JAX System runs `cam.undistort` and then `cam.bearings` inside one
`jax.jit` (stella_vslam_tpu/system.py `_preprocess`, `_mono_preprocess`),
with the camera's parameters as constants. XLA takes a division by a
constant as a product with its float32 reciprocal, contracts `x fx + cx`
and other products into FMAs, and folds the bearings' `((x fx + cx) - cx) /
fx` into `x fx (1 / fx)`; the port's CPU plain (camera/base.py
`undistort_and_bearings`, kernel R's plain twin) rounds as that program
does. Measured here (CPU, 2872 slots, seeds 0-2): the perspective model,
with and without EuRoC's radial-tangential coefficients, and the division
model equal it bit for bit, undistorted pixels and bearings. The fisheye
keeps the JAX version's eager rounding (XLA's CPU tan differs from torch's
by ulps, so no contraction reaches the jitted bits, and the jitted
normalisation would leave it past 4 ulps of both forms), and the
equirectangular bearings' sines and cosines differ from XLA's by ulps:
their counts of differing rows are printed and held at what this form
reaches (ROADMAP Queue 3's kept differences).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu_torch.camera import base as tcam
from stella_vslam_tpu_torch.util import synthetic

torch.set_num_threads(1)

N = 2872
BENCH = dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480)
EUROC = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
             k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, width=752, height=480)
FISHEYE = dict(BENCH, **dict(zip(("k1", "k2", "k3", "k4"), synthetic.FISH_D)))
RADIAL = dict(BENCH, k1=synthetic.RADIAL_K1)
EQUIRECT = dict(cx=320.0, cy=160.0, width=640, height=320)

# (model, parameters, most rows whose undistorted pixels differ, most rows
# whose bearings differ, over the three seeds): the worlds the port's tests
# and slices run (the bench and plane worlds' pinhole camera, EuRoC's
# distortion, the fisheye and division legs' cameras, the equirectangular
# box room)
CASES = [
    ("perspective", BENCH, 0, 0),
    ("perspective", EUROC, 0, 0),
    ("radial_division", RADIAL, 0, 0),
    ("fisheye", FISHEYE, 1688, 1128),
    ("equirectangular", EQUIRECT, 0, 1524),
]


def jitted_preprocess(model, params):
    """JAX's `_preprocess` for a camera of `model` with `params`."""
    M, p = jcam.CameraModel[model.upper()], jcam.make_params(**params)

    @jax.jit
    def pre(xy):
        und = jcam.undistort_keypoints(M, p, xy)
        return und, jcam.bearings_from_undistorted(M, p, und)
    return pre


def pixels(params, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, params["width"], N), rng.uniform(0, params["height"], N)],
                    -1).astype(np.float32)


def rows_apart(a, b):
    return int(np.sum(np.any(a != b, axis=-1)))


@pytest.mark.parametrize("model,params,und_held,bear_held", CASES,
                         ids=["bench", "euroc", "radial", "fisheye", "equirect"])
def test_preprocessing_matches_jax_jit(model, params, und_held, bear_held):
    pre = jitted_preprocess(model, params)
    M, p = tcam.CameraModel[model.upper()], tcam.make_params(**params)
    counts = []
    for seed in range(3):
        xy = pixels(params, seed)
        und_j, bear_j = (np.asarray(a) for a in pre(jnp.asarray(xy)))
        und_t, bear_t = (a.numpy() for a in tcam.undistort_and_bearings(M, p, torch.from_numpy(xy)))
        # the undistortion alone is the same function
        assert torch.equal(torch.from_numpy(und_t),
                           tcam.undistort_keypoints(M, p, torch.from_numpy(xy)))
        counts.append((rows_apart(und_t, und_j), rows_apart(bear_t, bear_j)))
        np.testing.assert_allclose(und_t, und_j, atol=1e-3, rtol=0)
        np.testing.assert_allclose(bear_t, bear_j, atol=1e-5, rtol=0)
    print(f"{model}: rows apart from JAX's jitted preprocessing (undistorted, bearings) "
          f"per seed {counts} of {N}")
    assert max(c[0] for c in counts) <= und_held and max(c[1] for c in counts) <= bear_held


def test_kernel_r_wrappers_take_the_fused_plain_on_the_cpu():
    """undistort_norm / undistort_radial with bearings on CPU tensors: the
    plain (undistorted, bearings) pair, the bearings of the normalised
    coordinates, which differ from bearings recomputed from the rounded
    pixels (bearings_from_undistorted, JAX's standalone jitted form)."""
    for kern, params in ((tcam.undistort_norm, EUROC), (tcam.undistort_radial, RADIAL)):
        p = tcam.make_params(**params)
        xy = torch.from_numpy(pixels(params, 7))
        und, bear = kern(p, xy, bearings=True)
        assert torch.equal(und, kern(p, xy))
        assert tuple(bear.shape) == (N, 3)
        torch.testing.assert_close(bear.norm(dim=-1), torch.ones(N), atol=1e-6, rtol=0)
        M = tcam.CameraModel.PERSPECTIVE if kern is tcam.undistort_norm \
            else tcam.CameraModel.RADIAL_DIVISION
        alone = tcam.bearings_from_undistorted(M, p, und)
        torch.testing.assert_close(bear, alone, atol=1e-6, rtol=0)


if __name__ == "__main__":
    for case in CASES:
        test_preprocessing_matches_jax_jit(*case)
