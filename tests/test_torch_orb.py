"""ORB front-end of the port (kernels A and B, plain CPU versions) against
the JAX OrbExtractor on identical images.

Inputs: three frames of the photo-hardened test plane world (400x300,
pixel noise sigma 2, exposure drift), 4 levels, min_size 400 (938 slots),
with the JAX extractor's own tables carried over by convert.py.

Measured on these frames (CPU): level-0 scores and winners bit-exact; the
resized levels' scores differ by at most 7.6e-5; slot agreement
(xy, level, valid) 1.0 over 2814 slots; descriptor bit mismatch over all
valid slots 1.5e-6 (1 bit in 673 k). The blurred patch is rounded to integer gray levels
(orb_extractor.py:383); a sum of the 49 taps in another order can flip a
value sitting at .5, and that flips descriptor bits — the rate is measured
and bounded, not hidden. Bounds: the measured values plus small headroom.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.feature.orb_extractor import OrbExtractor as JaxExtractor
from stella_vslam_tpu.feature.orb_extractor import fast_score_map as jax_fast_score
from stella_vslam_tpu.feature.orb_params import OrbParams as JaxOrbParams
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.feature import orb_extractor as ox
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from tests.synthetic_world import PlaneWorld, lateral_trajectory

torch.set_num_threads(1)

SCORE_TOL = 1e-4
SLOT_AGREEMENT_MIN = 0.998
DESC_BIT_MISMATCH_MAX = 5e-5


def make_setup():
    world = PlaneWorld(noise_sigma=2.0, exposure_amp=0.06)
    images = [world.render(T) for T in lateral_trajectory(3, step=0.03)]
    jex = JaxExtractor(JaxOrbParams(num_levels=4), 400, 300, min_area=400)
    tex = ox.OrbExtractor(OrbParams(num_levels=4), 400, 300, min_area=400,
                          device="cpu", tables=convert.extractor_tables(jex))
    return images, jex, tex


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def test_tables_match_jax(setup):
    _, jex, _ = setup
    own = ox.extractor_tables(OrbParams(num_levels=4), ox.level_geometry(
        OrbParams(num_levels=4), 400, 300, 400, 19))
    carried = convert.extractor_tables(jex)
    for (R0, C0), (R1, C1) in zip(own["resize"], carried["resize"]):
        np.testing.assert_array_equal(R0, R1)
        np.testing.assert_array_equal(C0, C1)
    for k in ("taps", "k10", "k01"):
        np.testing.assert_array_equal(own[k], carried[k])
    # a pair whose rotated endpoints land on one pixel has an all-zero row
    # in the JAX bit matrix (its bit is always 0); only that it is
    # degenerate can be carried over
    o, c = own["offsets"], carried["offsets"]
    degenerate = np.all(o[..., :2] == o[..., 2:], axis=-1)
    np.testing.assert_array_equal(np.all(c[..., :2] == c[..., 2:], axis=-1), degenerate)
    np.testing.assert_array_equal(o[~degenerate], c[~degenerate])


def test_level0_scores_and_winners_bit_exact(setup):
    images, jex, tex = setup
    for img in images:
        s_j = np.asarray(jax_fast_score(jnp.asarray(img, jnp.float32)))
        s_t = ox.fast_score_map(torch.from_numpy(img).float()).numpy()
        np.testing.assert_array_equal(s_j, s_t)
        fj = jex.extract(img)
        ft = tex.extract(torch.from_numpy(img))
        n0 = tex.levels[0].Gy * tex.levels[0].Gx
        for name in ("xy", "response", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(fj, name))[:n0],
                                          getattr(ft, name).numpy()[:n0])


def score_gap(setup):
    images, jex, tex = setup
    gap = 0.0
    for img in images:
        lv_t = tex.pyramid(torch.from_numpy(img))
        x = jnp.asarray(img, jnp.float32)
        for lvl in range(1, len(tex.levels)):
            R, C = jex._resize_mats[lvl - 1]
            x = (R @ x) @ C.T
            gap = max(gap, float(np.abs(np.asarray(jax_fast_score(x))
                                        - ox.fast_score_map(lv_t[lvl]).numpy()).max()))
    return gap


def test_resized_level_scores_close(setup):
    assert score_gap(setup) <= SCORE_TOL


def agreement(setup):
    """(slot agreement, descriptor bit-mismatch rate) over all frames."""
    images, jex, tex = setup
    same, slots, bits, nbits = 0, 0, 0, 0
    for img in images:
        fj = jex.extract(img)
        ft = tex.extract(torch.from_numpy(img))
        xy_ok = np.all(np.asarray(fj.xy) == ft.xy.numpy(), axis=1)
        ok = xy_ok & (np.asarray(fj.level) == ft.level.numpy()) \
            & (np.asarray(fj.valid) == ft.valid.numpy())
        same += int(ok.sum())
        slots += len(ok)
        both = ok & np.asarray(fj.valid)
        x = np.bitwise_xor(np.asarray(fj.desc).view(np.int32), ft.desc.numpy())[both]
        bits += int(np.unpackbits(x.view(np.uint8)).sum())
        nbits += int(both.sum()) * 256
    return same / slots, bits / nbits


def test_slots_and_descriptors_agree(setup):
    slot_rate, bit_rate = agreement(setup)
    assert slot_rate >= SLOT_AGREEMENT_MIN, slot_rate
    assert bit_rate <= DESC_BIT_MISMATCH_MAX, bit_rate
