"""The port's RANSAC seed stream against the JAX Initializer's, on the CPU.

key_seed_source (util/threefry.py's Threefry-2x32 and split, without JAX)
must give, attempt by attempt, the seeds the JAX Initializer derives from
jax.random keys (tests/test_torch_initializer.py jax_seed_source): exactly,
for 32 attempts. The port's Initializer draws them by default.
"""
import pytest
import torch

from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.module.initializer import Initializer, key_seed_source
from tests.synthetic_world import PlaneWorld
from tests.test_torch_initializer import jax_seed_source

torch.set_num_threads(1)

ATTEMPTS = 32


@pytest.mark.parametrize("seed", [42, 0, 1, 2, 3, 4, 5, 6, 7])
def test_key_seed_source_equals_jax(seed):
    port, ref = key_seed_source(seed), jax_seed_source(seed)
    for _ in range(ATTEMPTS):
        assert port() == ref()


def test_fixed_seed_initializer_draws_jax_stream():
    cam = camera_from_yaml(PlaneWorld().camera_yaml())
    init = Initializer(cam, OrbParams(num_levels=4), use_fixed_seed=True)
    ref = jax_seed_source(42)
    for _ in range(4):
        assert init.seed_source() == ref()
