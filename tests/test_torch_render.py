"""The port's numpy-only plane world against the cv2 renderer of the JAX
package (tests/synthetic_world.PlaneWorld), on the same poses.

cv2.warpPerspective interpolates with 1/32-pixel fixed-point weights and
the port's warp in float64, so the images are close, not identical.
Measured (CPU): identical trajectories; texture mean |diff| 2.4e-7;
per-image mean |diff| <= 4.2e-4 gray levels and max |diff| 1 on the plain
world, <= 4.4e-4 and 2 with pixel noise and exposure drift. Bounds: mean
|diff| < 0.01 gray levels, max |diff| <= 2.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu_torch.util import synthetic as port
from tests.synthetic_world import PlaneWorld, lateral_trajectory

torch.set_num_threads(1)


@pytest.mark.parametrize("hardened", [False, True])
def test_numpy_world_renders_like_cv2(hardened):
    kw = dict(noise_sigma=2.0, exposure_amp=0.06) if hardened else {}
    ref, mine = PlaneWorld(**kw), port.PlaneWorld(**kw)
    assert np.abs(ref.texture.astype(int) - mine.texture.astype(int)).mean() < 1e-3
    poses = lateral_trajectory(12, step=0.03)
    for T_ref, T_mine in zip(poses, port.lateral_trajectory(12, step=0.03)):
        np.testing.assert_allclose(T_mine, T_ref, atol=1e-7)
    for T in poses[::4]:
        d = np.abs(ref.render(T).astype(int) - mine.render(T).astype(int))
        assert d.mean() < 0.01 and d.max() <= 2, (d.mean(), d.max())
