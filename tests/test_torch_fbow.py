"""FBoW vocabularies in the port (data/fbow_io.py, kernel V's plain version)
against the JAX package, on the CPU.

The in-repo fixture tests/data/reference_layout_vocab.fbow is irregular
(913 blocks, m_k = 10, 9 or 10 children, depth 4, 7761 words): `read_fbow`
gives the JAX reader's tables exactly, and its malformed-file matrix
(tests/test_fbow_fixture.py:121) raises as JAX's does. The descent's word
ids equal JAX's `transform` exactly: on 2872 seeded descriptors (a
keyframe's slot count at 752x480) on the fixture, and on a complete tree
that `write_fbow` writes from the packaged vocabulary (where they also
equal the .npz form's kernel-M descent). `write_fbow` -> `read_fbow`
round-trips, `convert.fbow_vocabulary` carries a JAX vocabulary's tables
across as they are, and `BowVocabulary.load` returns the port's
FbowVocabulary for a .fbow file.

The loop detector with the fixture vocabulary: the JAX System runs the test
plane world (400x300, 4 levels, min_size 400) with
vocab_path=the fixture until it holds 5 keyframes; its map and BoW
database are converted (convert.map_database, convert.bow_database). Every
keyframe's BoW vector, recomputed by the port's vocabulary from its
descriptors, equals the JAX database's, and the port's detector returns
JAX's candidates for each keyframe, as do the database's raw scored
candidates.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.data import fbow_io as jfbow
from stella_vslam_tpu.data.bow_vocabulary import BowVocabulary as JBowVocabulary
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.data import fbow_io as tfbow
from stella_vslam_tpu_torch.data.bow_vocabulary import BowVocabulary
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.module.loop_detector import LoopDetector
from tests.synthetic_world import PlaneWorld, lateral_trajectory
from tests.test_torch_initializer import cfg_dict

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "reference_layout_vocab.fbow")
DEFAULT_NPZ = os.path.join(os.path.dirname(__file__), "..", "stella_vslam_tpu_torch", "data",
                           "vocab_default.npz")


def seeded_descriptors(n=2872, seed=4):
    d = np.random.default_rng(seed).integers(0, 2 ** 32, (n, 8), dtype=np.uint64)
    return d.astype(np.uint32)


def jax_words(jv, desc_u32):
    # the device tables built eagerly: built inside the first trace, they
    # would leak its tracers into a second shape's (as BowVocabulary's do)
    jv._dev_tables()
    return np.asarray(jv.transform(jnp.asarray(desc_u32)))


def port_words(tv, desc_u32):
    return tv.transform(torch.from_numpy(desc_u32.view(np.int32))).numpy()


def assert_same_tables(tv, jv):
    np.testing.assert_array_equal(tv.centers_pm1, jv.centers_pm1)
    np.testing.assert_array_equal(tv.node_info, jv.node_info)
    np.testing.assert_array_equal(tv.n_children, jv.n_children)
    if jv.weights is not None:
        np.testing.assert_array_equal(tv.weights, jv.weights)
    assert (tv.max_depth, tv.num_words, tv.desc_name) == (jv.max_depth, jv.num_words,
                                                         jv.desc_name)
    assert hash(tv) == hash(jv)


@pytest.fixture(scope="module")
def fixture_vocabs():
    return jfbow.read_fbow(FIXTURE), tfbow.read_fbow(FIXTURE, device="cpu")


def test_read_fixture_tables_equal_jax(fixture_vocabs):
    jv, tv = fixture_vocabs
    assert_same_tables(tv, jv)
    assert tv.node_info.shape == (913, 10) and tv.max_depth == 4 and tv.num_words == 7761
    assert set(np.unique(tv.n_children)) <= {9, 10} and (tv.n_children == 9).any()
    loaded = BowVocabulary.load(FIXTURE, device="cpu")
    assert isinstance(loaded, tfbow.FbowVocabulary)
    assert_same_tables(loaded, jv)


def _malformed(blob, tmp_path):
    import struct

    bad_sig = bytearray(blob)
    struct.pack_into("<Q", bad_sig, 0, 0xDEADBEEF)
    # desc_size field lives at params offset 108 (i32), file offset 8 + 108
    bad_desc = bytearray(blob)
    struct.pack_into("<i", bad_desc, 8 + 108, 61)
    cases = {"bad_sig": (bytes(bad_sig), ValueError, "signature"),
             "truncated_header": (blob[:64], Exception, None),
             "truncated_blocks": (blob[: len(blob) // 2], Exception, None),
             "bad_desc_size": (bytes(bad_desc), ValueError, "descriptor size")}
    for name, (data, exc, match) in cases.items():
        p = tmp_path / f"{name}.fbow"
        p.write_bytes(data)
        yield name, str(p), exc, match


def test_malformed_fbow_matrix(tmp_path):
    """The JAX reader's failure modes, case by case: the port raises where
    JAX raises, with the same exception type."""
    blob = open(FIXTURE, "rb").read()
    for name, path, exc, match in _malformed(blob, tmp_path):
        with pytest.raises(exc, match=match) as got:
            tfbow.read_fbow(path, device="cpu")
        with pytest.raises(exc, match=match) as ref:
            jfbow.read_fbow(path)
        assert type(got.value) is type(ref.value), name


def test_transform_equals_jax_on_fixture(fixture_vocabs):
    jv, tv = fixture_vocabs
    desc = seeded_descriptors()
    w_t = port_words(tv, desc)
    np.testing.assert_array_equal(w_t, jax_words(jv, desc))
    assert len(np.unique(w_t)) > 1000  # the descents spread over the tree
    # a descriptor equal to a leaf's centre descends to that leaf
    leaf_blk, leaf_k = np.argwhere((tv.node_info & 0x80000000) != 0)[123]
    centre = tfbow.pack_centers(tv.centers_pm1[leaf_blk, leaf_k]).view(np.uint32)[None]
    assert port_words(tv, centre)[0] == jax_words(jv, centre)[0]


def test_complete_tree_roundtrip_and_descent(tmp_path):
    """write_fbow of the packaged vocabulary (10^4 words) -> read_fbow in
    both packages: equal tables, the port's writer's bytes equal JAX's, and
    the descent's word ids equal JAX's and the .npz form's kernel-M ids."""
    npz = BowVocabulary.load(DEFAULT_NPZ, device="cpu")
    p_port, p_jax = tmp_path / "port.fbow", tmp_path / "jax.fbow"
    npz.save_fbow(str(p_port))
    jnpz = JBowVocabulary.load(DEFAULT_NPZ)
    jnpz.save_fbow(str(p_jax))
    assert p_port.read_bytes() == p_jax.read_bytes()
    tv, jv = tfbow.read_fbow(str(p_port), device="cpu"), jfbow.read_fbow(str(p_port))
    assert_same_tables(tv, jv)
    assert tv.node_info.shape == (1111, 10) and tv.num_words == 10000
    desc = seeded_descriptors(seed=5)
    w_t = port_words(tv, desc)
    np.testing.assert_array_equal(w_t, jax_words(jv, desc))
    np.testing.assert_array_equal(w_t, npz.transform(torch.from_numpy(desc.view(np.int32))).numpy())


def test_write_read_roundtrip(tmp_path):
    rng = np.random.default_rng(8)
    levels = [rng.integers(0, 2, (4 ** (l + 1), 256)).astype(np.float32) * 2 - 1
              for l in range(3)]
    path = tmp_path / "small.fbow"
    tfbow.write_fbow(str(path), levels)
    tv = tfbow.read_fbow(str(path), device="cpu")
    assert tv.max_depth == 3 and tv.num_words == 64 and tv.node_info.shape == (21, 4)
    np.testing.assert_array_equal(tv.centers_pm1[0], levels[0])
    np.testing.assert_array_equal(tv.centers_pm1[5:21].reshape(64, 256), levels[2])
    leaf = (tv.node_info[5:] & 0x80000000) != 0
    assert leaf.all()
    np.testing.assert_array_equal(tv.node_info[5:].reshape(-1) & 0x7FFFFFFF, np.arange(64))
    # the leaves' own centres descend alike in both packages
    desc = tfbow.pack_centers(levels[2]).view(np.uint32)
    np.testing.assert_array_equal(port_words(tv, desc), jax_words(jfbow.read_fbow(str(path)),
                                                                 desc))


def test_convert_carries_tables(fixture_vocabs):
    jv, _ = fixture_vocabs
    tv = convert.fbow_vocabulary(jv, device="cpu")
    assert_same_tables(tv, jv)
    desc = seeded_descriptors(n=512, seed=6)
    np.testing.assert_array_equal(port_words(tv, desc), jax_words(jv, desc))


@pytest.fixture(scope="module")
def loop_state():
    world = PlaneWorld()
    gt = lateral_trajectory(90)
    js = JSystem(JConfig.from_dict(cfg_dict(world)), vocab_path=FIXTURE, inline_mapping=True)
    js.mapper._ba_shapes = {(16, L) for L in (2048, 4096, 8192)}
    js.startup()
    n = 0
    while js.map_db.num_keyframes() < 5 and n < len(gt):
        js.feed_monocular_frame(world.render(gt[n]), n * 0.05)
        n += 1
    js.tracker.finalize_pending()
    assert isinstance(js.bow_vocab, jfbow.FbowVocabulary)
    assert js.map_db.num_keyframes() >= 5
    cam, orb = camera_from_yaml(world.camera_yaml()), OrbParams(num_levels=4)
    md = convert.map_database(js.map_db, cam, orb, device="cpu")
    vocab = convert.fbow_vocabulary(js.bow_vocab, device="cpu")
    return js, md, vocab, cam, orb


def test_bow_vectors_equal_jax(loop_state):
    js, md, vocab, _, _ = loop_state
    assert set(js.bow_db.bow_vecs) == set(md.keyframes)
    for kf_id, kf in md.keyframes.items():
        words, vec = vocab.compute_bow(np.asarray(kf.h_desc).view(np.uint32), kf.h_valid)
        assert vec == js.bow_db.bow_vecs[kf_id], kf_id
        assert len(vec) > 20


def test_loop_candidates_equal_jax(loop_state):
    js, md, vocab, cam, orb = loop_state
    bow_db = convert.bow_database(js.bow_db, vocab)
    det = LoopDetector(cam, orb, bow_db, device="cpu", min_continuity=1)
    jdet = js.global_optimizer.loop_detector
    jdet.min_continuity, jdet.cont_sets = 1, []
    for kf_id in sorted(md.keyframes):
        got = det.detect_loop_candidates(md, md.keyframes[kf_id])
        ref = jdet.detect_loop_candidates(js.map_db, js.map_db.keyframes[kf_id])
        assert list(got) == list(ref), kf_id
        raw = bow_db.acquire_keyframes(bow_db.bow_vecs[kf_id], reject={kf_id},
                                       keyframes=md.keyframes)
        raw_ref = js.bow_db.acquire_keyframes(js.bow_db.bow_vecs[kf_id], reject={kf_id},
                                              keyframes=js.map_db.keyframes)
        assert list(raw) == list(raw_ref), kf_id
        assert len(raw) > 0
