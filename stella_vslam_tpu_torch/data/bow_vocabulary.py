"""Bag-of-visual-words vocabulary: tree descent on kernel V.

Port of stella_vslam_tpu/data/bow_vocabulary.py (reference
src/stella_vslam/data/bow_vocabulary.{h,cc}, which wraps a pretrained FBoW
tree). The vocabulary is a hierarchy of binary centers, branching K_BRANCH,
DEPTH levels: level l holds K_BRANCH^(l+1) centers of 256 bits, the children
of node p of level l-1 at rows p*K_BRANCH .. p*K_BRANCH + K_BRANCH - 1. A
descriptor walks down from the root: at each level it takes the child at the
least Hamming distance, the lowest child index on ties; the node reached at
the last level is its word.

The JAX version computes the similarity of every descriptor to every node
of a level as a bf16 +-1 matmul with f32 sums (exact integers) and selects
the current node's children by a one-hot product. Here the regular tree is
held as FBoW block tables (`tables`, built once: a block per interior node
in breadth-first order, as `write_fbow` lays it out, a leaf's payload the
last level's node index), and `transform` is data/fbow_io.py's
`fbow_transform`: kernel V (csrc/bow_fbow.cu) on CUDA tensors, its plain
version on CPU tensors. The word ids are equal to the JAX version's, not
close.

Host code builds tf (L1-normalised) BoW vectors and the inverted index
(bow_database.py). `load` reads the .npz form, or the reference's .fbow
(detected by its signature) as an `FbowVocabulary` with the same surface
(data/fbow_io.py); `save_fbow` writes the tree in that form. `train` and
`save` are not ported (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from stella_vslam_tpu_torch.data.fbow_io import (FBOW_SIGNATURE, FbowTables, fbow_transform,
                                                 pack_centers, read_fbow, write_fbow)

K_BRANCH = 10
DEPTH = 4  # 10^4 = 10000 words
_VOCAB_SEED = 0xB0A
_FBOW_MAGIC = FBOW_SIGNATURE.to_bytes(8, "little")
_LEAF = 0x80000000


def regular_tree_tables(centers, device) -> FbowTables:
    """Kernel V's tables of a complete tree (per-level [K^(l+1), 256] +-1
    centers): the blocks in breadth-first order, so that level l's centres
    in row order are its blocks' children in order; an interior child's
    payload is its block (the first block of level l+1 plus its node
    index), a leaf's the MSB and its node index. The tables that
    read_fbow(write_fbow(centers)) gives."""
    K, depth = len(centers[0]), len(centers)
    first = np.cumsum([0] + [K ** l for l in range(depth)])
    info = [first[l + 1] + np.arange(K ** (l + 1), dtype=np.uint32) for l in range(depth - 1)]
    info.append(np.uint32(_LEAF) | np.arange(K ** depth, dtype=np.uint32))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return FbowTables(
        centers=up(pack_centers(np.concatenate(centers))),
        node_info=up(np.concatenate(info).astype(np.uint32).view(np.int32)),
        n_children=up(np.full(int(first[-1]), K, np.int32)), m_k=int(K), max_depth=depth)


class BowVocabulary:
    def __init__(self, seed: int = _VOCAB_SEED, device="cuda"):
        rng = np.random.default_rng(seed)
        # level l has K^(l+1) nodes: [K^(l+1), 256] float32 in {-1, +1}
        self.centers = []
        for lvl in range(DEPTH):
            n = K_BRANCH ** (lvl + 1)
            self.centers.append(rng.integers(0, 2, size=(n, 256)).astype(np.float32) * 2 - 1)
        self.device = torch.device(device)
        self.num_words = K_BRANCH ** DEPTH
        self._tables = None

    def set_centers(self, centers):
        self.centers = [np.ascontiguousarray(c, dtype=np.float32) for c in centers]
        self._tables = None

    def tables(self) -> FbowTables:
        """Kernel V's tables of the tree on the vocabulary's device, built
        once."""
        if self._tables is None:
            self._tables = regular_tree_tables(self.centers, self.device)
        return self._tables

    def packed_centers(self) -> torch.Tensor:
        """[sum of the level sizes, 8] int32: every center's bits, levels in
        order (the tables' centres)."""
        return self.tables().centers

    # ------------------------------------------------------------------
    def transform(self, desc: torch.Tensor) -> torch.Tensor:
        """[N,8] int32 descriptors (the uint32 bits) -> [N] int32 word ids."""
        return fbow_transform(desc.contiguous(), self.tables())

    def compute_bow(self, desc_u32: np.ndarray, valid: np.ndarray):
        """Host entry: (word ids [N] i64 with -1 where invalid, bow dict
        word -> tf weight, L1-normalised)."""
        d = np.ascontiguousarray(np.asarray(desc_u32, np.uint32)).view(np.int32)
        words = self.transform(torch.from_numpy(d).to(self.device)).cpu().numpy()
        return self.words_to_bow(words, valid)

    @staticmethod
    def words_to_bow(words: np.ndarray, valid: np.ndarray):
        """Host half of compute_bow (the mapper reads the word ids of a
        keyframe together with its other results)."""
        words = np.where(valid, words.astype(np.int64), -1)
        vw = words[words >= 0]
        if len(vw) == 0:
            return words, {}
        uniq, cnt = np.unique(vw, return_counts=True)
        total = cnt.sum()
        return words, {int(w): float(c) / total for w, c in zip(uniq, cnt)}

    @staticmethod
    def score(bow1: dict, bow2: dict) -> float:
        """DBoW2 L1 score: 1 - 0.5 * sum|v - w| = sum min(v_i, w_i) for
        L1-normalised vectors (reference bow_vocabulary.cc score)."""
        s = 0.0
        for w, v in bow1.items():
            u = bow2.get(w)
            if u is not None:
                s += min(v, u)
        return s

    # ------------------------------------------------------------------
    def save_fbow(self, path: str):
        """Export in the reference's FBoW binary format (data/fbow_io.py)."""
        write_fbow(path, self.centers)

    @staticmethod
    def load(path: str, device="cuda"):
        """Load a vocabulary: the .npz form (bit-packed or float centers,
        `level_0` .. `level_3`), or a reference FBoW `.fbow` binary
        (system.cc:44-50), detected by its signature and returned as an
        FbowVocabulary."""
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic == _FBOW_MAGIC:
            return read_fbow(path, device)
        v = BowVocabulary(device=device)
        data = np.load(path)
        centers = []
        for i in range(DEPTH):
            c = data[f"level_{i}"]
            if c.dtype == np.uint8:  # bit-packed form
                c = np.unpackbits(c, axis=1)[:, :256].astype(np.float32) * 2 - 1
            centers.append(c)
        v.set_centers(centers)
        return v

    @staticmethod
    def default(device="cuda") -> "BowVocabulary":
        """The packaged pretrained vocabulary (vocab_default.npz beside this
        module, trained on descriptors of the synthetic worlds); the seeded
        random tree when the file is missing."""
        path = os.path.join(os.path.dirname(__file__), "vocab_default.npz")
        if os.path.exists(path):
            return BowVocabulary.load(path, device)
        return BowVocabulary(device=device)
