"""Bag-of-visual-words vocabulary: tree descent on kernel M.

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
the current node's children by a one-hot product. `bow_transform` does the
descent itself: on CUDA tensors kernel M (csrc/bow_transform.cu: one thread
per descriptor, XOR + popcount against the 10 children of its node, the
centers packed to 8 words per node); on CPU tensors `bow_transform_plain`
(a gather of the children and a +-1 f32 product, exact for the same reason).
The word ids are equal to the JAX version's, not close.

Host code builds tf (L1-normalised) BoW vectors and the inverted index
(bow_database.py). `train`, `save`, `save_fbow` and the `.fbow` reader come
with map IO (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from stella_vslam_tpu_torch.kernels import build as kbuild

K_BRANCH = 10
DEPTH = 4  # 10^4 = 10000 words
_VOCAB_SEED = 0xB0A
_FBOW_MAGIC = int(55824124).to_bytes(8, "little")


def pack_centers(centers) -> np.ndarray:
    """Per-level [n,256] +-1 centers -> one [sum n, 8] int32 array (the
    uint32 bits; bit k of word w is element 32 w + k, as in a descriptor),
    levels in order."""
    out = []
    for c in centers:
        bits = (np.asarray(c) > 0).astype(np.uint32).reshape(len(c), 8, 32)
        out.append((bits << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32))
    return np.ascontiguousarray(np.concatenate(out)).view(np.int32)


def bow_transform_plain(desc: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel M: [N,8] int32 descriptors, packed centers
    [11110,8] int32 -> [N] int32 leaf ids."""
    from stella_vslam_tpu_torch.match.hamming import unpack_bits_pm1

    N = desc.shape[0]
    pm1 = unpack_bits_pm1(desc)  # [N,256]
    node = torch.zeros(N, dtype=torch.int64, device=desc.device)
    child = torch.arange(K_BRANCH, device=desc.device)
    base = 0
    for lvl in range(DEPTH):
        rows = base + node[:, None] * K_BRANCH + child[None, :]  # [N,K]
        c = unpack_bits_pm1(packed[rows.reshape(-1)]).reshape(N, K_BRANCH, 256)
        sim = torch.einsum("nd,nkd->nk", pm1, c)  # 256 - 2 * Hamming, exact
        node = node * K_BRANCH + torch.argmax(sim, dim=-1)  # first maximum
        base += K_BRANCH ** (lvl + 1)
    return node.to(torch.int32)


def bow_transform(desc: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Kernel M on CUDA tensors, the plain version on CPU tensors."""
    if not desc.is_cuda:
        return bow_transform_plain(desc, packed)
    N = desc.shape[0]
    n_nodes = sum(K_BRANCH ** (l + 1) for l in range(DEPTH))
    for t, shape, name in ((desc, (N, 8), "desc"), (packed, (n_nodes, 8), "centers")):
        if tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != desc.device \
                or not t.is_contiguous():
            raise ValueError(f"bow_transform: {name} must be a contiguous int32 "
                             f"tensor of shape {shape} on {desc.device}")
    out = torch.empty(N, dtype=torch.int32, device=desc.device)
    if N == 0:
        return out
    lib = kbuild.load()
    kbuild.check(lib.svt_bow_transform(N, desc.data_ptr(), packed.data_ptr(),
                                       out.data_ptr(), kbuild.stream_ptr(desc.device)),
                 "bow_transform")
    bow_transform.launches += 1
    return out


bow_transform.launches = 0


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
        self._packed = None

    def set_centers(self, centers):
        self.centers = [np.ascontiguousarray(c, dtype=np.float32) for c in centers]
        self._packed = None

    def packed_centers(self) -> torch.Tensor:
        if self._packed is None:
            self._packed = torch.from_numpy(pack_centers(self.centers)).to(self.device)
        return self._packed

    # ------------------------------------------------------------------
    def transform(self, desc: torch.Tensor) -> torch.Tensor:
        """[N,8] int32 descriptors (the uint32 bits) -> [N] int32 word ids."""
        return bow_transform(desc.contiguous(), self.packed_centers())

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
    @staticmethod
    def load(path: str, device="cuda") -> "BowVocabulary":
        """Load a vocabulary in the .npz form (bit-packed or float centers,
        `level_0` .. `level_3`)."""
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic == _FBOW_MAGIC:
            raise NotImplementedError(
                "reading a .fbow vocabulary is not ported yet (it comes with "
                "map IO, ROADMAP Queue 1 item 10)")
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
