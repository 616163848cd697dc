"""Extraction masks in the port (kernel A's mask, plain CPU version)
against the JAX OrbExtractor's `extract(img, mask)`.

The mask enters JAX's NMS as `region & (resize(mask, level, "nearest") >
0.5)` (stella_vslam_tpu/feature/orb_extractor.py:332-337); the port reads
the level-0 mask through per-level nearest-index tables. The tables equal
jax.image.resize's choice on every level of both geometries below, and a
masked extraction at 752x480 with 8 levels (2872 slots, the carried tables
of the JAX extractor) equals JAX's exactly: keypoints, levels, validity
and descriptors, on the half-image mask of tests/test_orb_extractor.py
and on a seeded random mask. `test_mask_respected` twins the JAX test.
The System applies the mask to monocular frames only; its stereo and RGBD
feeds accept one and ignore it, as the JAX package's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.feature.orb_extractor import OrbExtractor as JaxExtractor
from stella_vslam_tpu.feature.orb_params import OrbParams as JaxOrbParams
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.feature import orb_extractor as ox
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util.drift import pose_at_xy
from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

torch.set_num_threads(1)

W, H = 752, 480


def half_mask(w, h):
    """tests/test_orb_extractor.py's mask: the left half excluded."""
    m = np.ones((h, w), np.uint8)
    m[:, : w // 2] = 0
    return m


def random_mask(w, h, seed=11):
    return (np.random.default_rng(seed).random((h, w)) > 0.3).astype(np.uint8)


@pytest.fixture(scope="module")
def setup():
    img = bench_world().render(pose_at_xy(0.3, 0.0))
    jex = JaxExtractor(JaxOrbParams(num_levels=8), W, H, min_area=800)
    tex = ox.OrbExtractor(OrbParams(num_levels=8), W, H, min_area=800, device="cpu",
                          tables=convert.extractor_tables(jex))
    return img, jex, tex


@pytest.mark.parametrize("size,levels,min_area", [((752, 480), 8, 800), ((320, 240), 4, 800)])
def test_nearest_tables_match_jax_resize(size, levels, min_area):
    w, h = size
    tex = ox.OrbExtractor(OrbParams(num_levels=levels), w, h, min_area=min_area, device="cpu")
    mask = random_mask(w, h)
    for lvl, g in enumerate(tex.levels):
        rows, cols = ox._level_mask(tex._fast, None, lvl)[1:3]
        ref = np.asarray(jax.image.resize(jnp.asarray(mask, jnp.float32), (g.H, g.W),
                                          method="nearest") > 0.5)
        np.testing.assert_array_equal(mask[rows.numpy()][:, cols.numpy()] != 0, ref)


@pytest.mark.parametrize("which", ["half", "random"])
def test_masked_extraction_equals_jax(setup, which):
    img, jex, tex = setup
    mask = half_mask(W, H) if which == "half" else random_mask(W, H)
    jf = jex.extract(jnp.asarray(img), jnp.asarray(mask))
    tf = tex.extract(torch.from_numpy(img), torch.from_numpy(mask))
    valid = np.asarray(jf.valid)
    np.testing.assert_array_equal(tf.valid.numpy(), valid)
    np.testing.assert_array_equal(tf.xy.numpy(), np.asarray(jf.xy))
    np.testing.assert_array_equal(tf.level.numpy(), np.asarray(jf.level))
    np.testing.assert_array_equal(tf.response.numpy(), np.asarray(jf.response))
    np.testing.assert_array_equal(tf.desc.numpy()[valid],
                                  np.asarray(jf.desc).view(np.int32)[valid])
    unmasked = tex.extract(torch.from_numpy(img)).valid.numpy()
    assert 0 < valid.sum() < unmasked.sum()


def test_mask_respected():
    w, h = 320, 240
    tex = ox.OrbExtractor(OrbParams(num_levels=4), w, h, device="cpu")
    img = np.full((h, w), 50, dtype=np.float32)
    img[60:160, 80:220] = 200
    feats = tex.extract(torch.from_numpy(img), torch.from_numpy(half_mask(w, h)))
    xy = feats.xy.numpy()[feats.valid.numpy()]
    assert len(xy) > 0
    assert np.all(xy[:, 0] >= w // 2 - 2)


def _system(setup_name):
    cam = bench_world().camera_yaml()
    cam["setup"] = setup_name
    if setup_name != "monocular":
        cam["focal_x_baseline"] = cam["fx"] * 0.12
    cfg = Config.from_dict({"Camera": cam, "Feature": {"num_levels": 4},
                            "Preprocessing": {"min_size": 800, "depthmap_factor": 5000.0,
                                              "mask_rectangles": [[0.0, 0.5, 0.0, 0.2]]}})
    return System(cfg, device="cpu", inline_mapping=True)


def test_system_masks_monocular_frames_only():
    """The monocular frame goes through the masked extraction; the stereo
    and RGBD feeds take a mask and leave it unused; mask_rectangles is read
    and stored, not applied (the JAX package's behaviour)."""
    img = bench_world().render(pose_at_xy(0.3, 0.0))
    mask = half_mask(W, H)
    mono = _system("monocular")
    assert mono.mask_rectangles == [[0.0, 0.5, 0.0, 0.2]]
    frm = mono.create_monocular_frame(img, 0.0, mask)
    ref = mono.extractor.extract(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_array_equal(frm.feats.valid.numpy(), ref.valid.numpy())
    np.testing.assert_array_equal(frm.feats.xy.numpy(), ref.xy.numpy())
    plain = mono.create_monocular_frame(img, 0.0)
    assert frm.feats.valid.sum() < plain.feats.valid.sum()
    rgbd = _system("RGBD")
    depth = np.full((H, W), 4.0 * 5000.0, np.float32)
    a = rgbd.create_RGBD_frame(img, depth, 0.0, mask)
    b = rgbd.create_RGBD_frame(img, depth, 0.0)
    np.testing.assert_array_equal(a.feats.valid.numpy(), b.feats.valid.numpy())
    stereo = _system("stereo")
    a = stereo.create_stereo_frame(img, img, 0.0, mask)
    b = stereo.create_stereo_frame(img, img, 0.0)
    np.testing.assert_array_equal(a.feats.valid.numpy(), b.feats.valid.numpy())
