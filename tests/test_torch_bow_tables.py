"""The .npz vocabulary's tree as kernel V's FBoW block tables
(data/bow_vocabulary.py regular_tree_tables) against the tables that the
port's FBoW writer and reader give for the same tree, and the words of
BowVocabulary.transform (kernel V's plain version on the CPU) against the
JAX package's BowVocabulary.transform, element by element.
"""
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.data.bow_vocabulary import BowVocabulary as JBowVocabulary
from stella_vslam_tpu_torch.data import bow_vocabulary as tbow
from stella_vslam_tpu_torch.data import fbow_io

torch.set_num_threads(1)

VOCABS = {"packaged": lambda: (JBowVocabulary.default(), tbow.BowVocabulary.default("cpu")),
          "seeded": lambda: (JBowVocabulary(seed=5), tbow.BowVocabulary(seed=5, device="cpu"))}


@pytest.fixture(scope="module", params=sorted(VOCABS))
def vocabs(request):
    return VOCABS[request.param]()


def test_regular_tree_tables_equal_the_fbow_round_trip(vocabs):
    _, tv = vocabs
    tab = tv.tables()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v.fbow")
        tv.save_fbow(path)
        ref = fbow_io.read_fbow(path, "cpu").tables()
    assert (tab.m_k, tab.max_depth) == (ref.m_k, ref.max_depth) == (10, 4)
    assert tab.n_children.shape == (1111,)
    for a, b in zip(tab[:3], ref[:3]):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    assert tv.packed_centers().shape == (11110, 8)


@pytest.mark.parametrize("N", [1, 130, 2872])
def test_transform_equals_jax(vocabs, N):
    jv, tv = vocabs
    rng = np.random.default_rng(N)
    d = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    if N > 20:
        d[:10] = 0  # ties at every level: the lowest child wins in both
        d[10:20] = 0xFFFFFFFF
    jv._dev_centers()  # made outside the jit trace, or a later shape reuses a tracer
    wj = np.asarray(jv.transform(jnp.asarray(d)))
    wt = tv.transform(torch.from_numpy(d.view(np.int32)))
    assert wt.dtype == torch.int32 and wt.shape == (N,)
    assert np.array_equal(wj, wt.numpy())
