"""The port's BoW vocabulary and database (data/bow_vocabulary.py, the plain
version of kernel M; data/bow_database.py) against the JAX package's, on the
CPU. The word ids of `transform` must be equal, not close: the JAX version's
bf16 +-1 products with f32 sums are exact integers, and both take the first
best child. `words_to_bow`, `score` and `acquire_keyframes` are host code and
must agree exactly too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.data.bow_database import BowDatabase as JBowDatabase
from stella_vslam_tpu.data.bow_vocabulary import BowVocabulary as JBowVocabulary
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.data import bow_vocabulary as tbow
from stella_vslam_tpu_torch.data.bow_database import BowDatabase
from tests.synthetic_world import PlaneWorld, lateral_trajectory

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vocabs():
    jv = JBowVocabulary.default()
    return jv, tbow.BowVocabulary.default("cpu")


def _words(jv, tv, desc_u32):
    jv._dev_centers()  # made outside the jit trace, or a later shape reuses a tracer
    wj = np.asarray(jv.transform(jnp.asarray(desc_u32)))
    wt = tv.transform(torch.from_numpy(desc_u32.view(np.int32))).numpy()
    return wj, wt


def test_default_vocabulary_is_the_packaged_one(vocabs):
    jv, tv = vocabs
    assert len(tv.centers) == 4 and tv.num_words == 10000
    for a, b in zip(jv.centers, tv.centers):
        assert np.array_equal(a, b)
    conv = convert.bow_vocabulary(jv, device="cpu")
    assert torch.equal(conv.packed_centers(), tv.packed_centers())
    assert tv.packed_centers().shape == (11110, 8)


def test_transform_equal_on_random_descriptors(vocabs):
    rng = np.random.default_rng(0)
    d = rng.integers(0, 2 ** 32, (2872, 8), dtype=np.uint64).astype(np.uint32)
    d[:10] = 0  # ties at every level: the lowest child index wins in both
    d[10:20] = 0xFFFFFFFF
    wj, wt = _words(*vocabs, d)
    assert np.array_equal(wj, wt)
    assert len(np.unique(wt)) > 1000


def test_transform_equal_on_the_seeded_random_tree():
    jv, tv = JBowVocabulary(seed=5), tbow.BowVocabulary(seed=5, device="cpu")
    rng = np.random.default_rng(1)
    d = rng.integers(0, 2 ** 32, (500, 8), dtype=np.uint64).astype(np.uint32)
    wj, wt = _words(jv, tv, d)
    assert np.array_equal(wj, wt)


def test_transform_equal_on_extracted_descriptors(vocabs):
    from stella_vslam_tpu.feature.orb_extractor import OrbExtractor as JExtractor
    from stella_vslam_tpu.feature.orb_params import OrbParams as JOrbParams

    world = PlaneWorld()
    ex = JExtractor(JOrbParams(num_levels=4), world.W, world.H, min_area=400)
    jv, tv = vocabs
    bows = []
    for pose in lateral_trajectory(3, step=0.2)[::2]:
        feats = ex.extract(jnp.asarray(world.render(pose)))
        d = np.ascontiguousarray(np.asarray(feats.desc, np.uint32))
        valid = np.asarray(feats.valid)
        wj, wt = _words(jv, tv, d)
        assert np.array_equal(wj, wt)
        # compute_bow (host entry) and words_to_bow agree with JAX's
        _, bj = jv.compute_bow(d, valid)
        ids, bt = tv.compute_bow(d, valid)
        assert bj == bt and abs(sum(bt.values()) - 1.0) < 1e-9
        assert np.array_equal(ids >= 0, valid)
        bows.append(bt)
    # neighbouring views share words; score is symmetric and equals JAX's
    s = tbow.BowVocabulary.score(bows[0], bows[1])
    assert s == JBowVocabulary.score(bows[0], bows[1]) == tbow.BowVocabulary.score(bows[1], bows[0])
    assert 0.0 < s < 1.0 and tbow.BowVocabulary.score(bows[0], bows[0]) > 0.999


class _Node:
    def __init__(self, covis):
        self._c = covis

    def get_top_n_covisibilities(self, n):
        return self._c[:n]


class _Kf:
    def __init__(self, covis, erased=False):
        self.graph_node = _Node(covis)
        self.will_be_erased = erased


def test_database_acquire_keyframes_equal(vocabs):
    jv, tv = vocabs
    rng = np.random.default_rng(2)
    jdb, tdb = JBowDatabase(jv), BowDatabase(tv)
    vecs = {}
    for k in range(12):
        words = rng.choice(300, 60, replace=False) + (0 if k < 8 else 150)
        w = rng.random(60)
        vecs[k] = {int(a): float(b) for a, b in zip(words, w / w.sum())}
        jdb.add_keyframe(k, vecs[k])
        tdb.add_keyframe(k, vecs[k])
    jdb.erase_keyframe(3)
    tdb.erase_keyframe(3)
    kfs = {k: _Kf([(k + 1) % 12, (k + 2) % 12], erased=(k == 5)) for k in range(12)}
    q = vecs[0]
    for kw in (dict(), dict(min_score=0.05, reject={0, 1}),
               dict(min_score=0.02, reject={0}, keyframes=kfs)):
        assert jdb.acquire_keyframes(q, **kw) == tdb.acquire_keyframes(q, **kw)
    assert tdb.acquire_keyframes(q, reject={0})  # something is found
    # the converted database carries the vectors and the inverted index
    cdb = convert.bow_database(jdb, tv)
    assert cdb.bow_vecs == tdb.bow_vecs
    assert {w: s for w, s in cdb.keyfrms_in_word.items() if s} == \
        {w: s for w, s in tdb.keyfrms_in_word.items() if s}


def test_load_refuses_fbow(tmp_path):
    """A truncated .fbow is refused as the JAX package refuses it (the name
    is from when the port refused every .fbow): a complete header with its
    blocks cut raises ValueError, a cut header struct.error, in both."""
    import os
    import struct

    from stella_vslam_tpu.data.bow_vocabulary import BowVocabulary as JBowVocabulary

    fixture = os.path.join(os.path.dirname(__file__), "data", "reference_layout_vocab.fbow")
    blob = open(fixture, "rb").read()
    for data, exc in ((blob[:8 + 120 + 10], ValueError),
                      (int(55824124).to_bytes(8, "little") + b"\0" * 64, struct.error)):
        p = tmp_path / "v.fbow"
        p.write_bytes(data)
        with pytest.raises(exc) as got:
            tbow.BowVocabulary.load(str(p), "cpu")
        with pytest.raises(exc) as ref:
            JBowVocabulary.load(str(p))
        assert type(got.value) is type(ref.value) and str(got.value) == str(ref.value)
