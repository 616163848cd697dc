"""FBoW (.fbow) vocabularies: the reference's file format and its tree
descent on kernel V.

Port of stella_vslam_tpu/data/fbow_io.py. The reference loads its mandatory
vocabulary from an FBoW binary file (src/stella_vslam/system.cc:44-50,
data/bow_vocabulary.cc:20-22; the format is rmsalinas/fbow's `Vocabulary`).
`read_fbow` and `write_fbow` are the JAX version's reader and writer,
malformed-file errors included.

Binary layout (fbow::Vocabulary::toStream / fromStream):

    uint64  signature = 55824124
    params  (120 bytes, natural C alignment):
        char[50]  desc_name           (e.g. "orb"), offset 0
        u32       aligment            offset 52 (2 pad bytes after the name)
        u32       nblocks             offset 56
        u64       desc_size_bytes_wp  offset 64 (descriptor bytes + pad)
        u64       block_size_bytes_wp offset 72
        u64       feature_off_start   offset 80
        u64       child_off_start     offset 88
        u64       total_size          offset 96
        i32       desc_type           offset 104 (OpenCV type; 0 = CV_8UC1)
        i32       desc_size           offset 108 (32 for ORB)
        u32       m_k                 offset 112 (max children per node)
        u32       nwords              offset 116
    data    total_size bytes = nblocks * block_size_bytes_wp

Each block describes one interior node and its <= m_k children: u16 N
(children present), u8 isLeaf, u8 pad, u32 parent_id; block_node_info[m_k]
at child_off_start (u32 id_or_childblock: MSB set -> leaf, low 31 bits the
word id, else the child's block; f32 weight); the children's binary centres
at feature_off_start, desc_size_bytes_wp bytes each.

Tree descent (`FbowVocabulary.transform`): from block 0, the child whose
centre is at the least Hamming distance from the descriptor (the lowest
child on ties: the JAX version's first argmax of 256 - 2 Hamming), until a
leaf; `max_depth` rounds, a finished descriptor holds its word, one that
never reaches a leaf gets word 0. On CUDA tensors kernel V
(csrc/bow_fbow.cu) walks it, a group of 16 lanes per descriptor (a lane a
child), against the centres packed to 8 words each once at load; on CPU
tensors `fbow_transform_plain` gathers each descriptor's block and takes
the popcount of the XOR byte by byte. The .npz vocabulary's regular tree
takes the same route (data/bow_vocabulary.py regular_tree_tables). The
word ids are equal to the JAX version's, not close.
"""
from __future__ import annotations

import struct
from typing import Dict, NamedTuple

import numpy as np
import torch

from stella_vslam_tpu_torch.kernels import build as kbuild

FBOW_SIGNATURE = 55824124
_PARAMS_FMT = "<50s2xII4xQQQQQiiII"  # 120 bytes, natural C alignment
_PARAMS_SIZE = struct.calcsize(_PARAMS_FMT)
_NODE_INFO = np.dtype([("id_or_childblock", "<u4"), ("weight", "<f4")])
_LEAF = 0x80000000
# bits set in each byte value
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


class FbowTables(NamedTuple):
    """An FBoW tree as kernel V reads it (device tensors)."""

    centers: torch.Tensor  # [nblocks * m_k, 8] int32: the packed centre bits
    node_info: torch.Tensor  # [nblocks * m_k] int32: id_or_childblock's bits
    n_children: torch.Tensor  # [nblocks] int32
    m_k: int
    max_depth: int


def pack_centers(centers_pm1: np.ndarray) -> np.ndarray:
    """[..., 256] centres in {-1, +1} (0 where unused) -> [..., 8] int32
    words holding the uint32 bits (bit k of word w is element 32 w + k, as
    in a descriptor; an unused centre packs to 0)."""
    bits = (np.asarray(centers_pm1) > 0).astype(np.uint32)
    bits = bits.reshape(*bits.shape[:-1], 8, 32)
    words = (bits << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)
    return np.ascontiguousarray(words).view(np.int32)


def fbow_transform_plain(desc: torch.Tensor, tab: FbowTables) -> torch.Tensor:
    """Plain version of kernel V: [N,8] int32 descriptors -> [N] int32
    word ids, by a gather of each descriptor's block and the popcount of
    the XOR (a byte table)."""
    N, dev = desc.shape[0], desc.device
    nblocks, m_k = tab.n_children.shape[0], tab.m_k
    pop = torch.from_numpy(_POPCOUNT8).to(dev)
    d8 = desc.contiguous().view(torch.uint8).reshape(N, 1, 32)
    c8 = tab.centers.contiguous().view(torch.uint8).reshape(nblocks, m_k, 32)
    info = tab.node_info.reshape(nblocks, m_k)
    kidx = torch.arange(m_k, device=dev)
    blk = torch.zeros(N, dtype=torch.int64, device=dev)
    word = torch.zeros(N, dtype=torch.int32, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    for _ in range(tab.max_depth):
        dist = pop[torch.bitwise_xor(d8, c8[blk]).long()].sum(-1)  # [N, m_k]
        present = kidx[None, :] < tab.n_children[blk][:, None]
        dist = torch.where(present, dist, torch.full_like(dist, 257))
        best = torch.argmin(dist, dim=-1)  # the first minimum
        node = info[blk, best]
        is_leaf = node < 0  # the MSB
        payload = node & 0x7FFFFFFF
        word = torch.where(~done & is_leaf, payload, word)
        # an out-of-range child block reads the last block, as JAX's
        # gather clamps it
        blk = torch.where(done | is_leaf, blk, torch.clamp(payload.long(), max=nblocks - 1))
        done = done | is_leaf
    return word


def fbow_transform(desc: torch.Tensor, tab: FbowTables) -> torch.Tensor:
    """Kernel V on CUDA tensors, the plain version on CPU tensors."""
    if not desc.is_cuda:
        return fbow_transform_plain(desc, tab)
    N = desc.shape[0]
    nblocks = tab.n_children.shape[0]
    for t, shape, name in ((desc, (N, 8), "desc"), (tab.centers, (nblocks * tab.m_k, 8), "centers"),
                           (tab.node_info, (nblocks * tab.m_k,), "node_info"),
                           (tab.n_children, (nblocks,), "n_children")):
        if tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != desc.device \
                or not t.is_contiguous():
            raise ValueError(f"fbow_transform: {name} must be a contiguous int32 "
                             f"tensor of shape {shape} on {desc.device}")
    out = torch.empty(N, dtype=torch.int32, device=desc.device)
    if N == 0:
        return out
    if desc.data_ptr() % 16:  # the kernel reads a descriptor as two 16-byte words
        desc = desc.clone()
    if tab.centers.data_ptr() % 16:
        raise ValueError("fbow_transform: the centres must be 16-byte aligned")
    lib = kbuild.load()
    kbuild.check(lib.svt_fbow_transform(
        N, nblocks, tab.m_k, tab.max_depth, desc.data_ptr(), tab.centers.data_ptr(),
        tab.node_info.data_ptr(), tab.n_children.data_ptr(), out.data_ptr(),
        kbuild.stream_ptr(desc.device)), "fbow_transform")
    fbow_transform.launches += 1
    return out


fbow_transform.launches = 0


class FbowVocabulary:
    """A (possibly irregular) FBoW tree with the BowVocabulary surface:
    `transform` (the descent on kernel V), `compute_bow` / `words_to_bow`,
    `score`, `num_words`. The tables are the JAX version's numpy arrays;
    the device tables are built once, at the first transform."""

    def __init__(self, centers_pm1: np.ndarray, node_info: np.ndarray,
                 n_children: np.ndarray, max_depth: int, desc_name: str = "orb",
                 device="cuda"):
        # centers_pm1: [nblocks, m_k, 256] float32 in {-1,+1} (invalid rows 0)
        self.centers_pm1 = centers_pm1
        self.node_info = node_info          # [nblocks, m_k] u32
        self.weights = None                 # [nblocks, m_k] f32 (set by reader)
        self.n_children = n_children        # [nblocks] i32
        self.max_depth = int(max_depth)
        self.desc_name = desc_name
        self.device = torch.device(device)
        leaf = (node_info & _LEAF) != 0
        ids = node_info & 0x7FFFFFFF
        self.num_words = int(ids[leaf].max()) + 1 if leaf.any() else 0
        self._tables = None
        self._content_hash = None

    def __hash__(self):
        if self._content_hash is None:
            import hashlib

            h = hashlib.sha1()
            h.update(np.ascontiguousarray(self.centers_pm1).tobytes())
            h.update(np.ascontiguousarray(self.node_info).tobytes())
            self._content_hash = int.from_bytes(h.digest()[:8], "little")
        return self._content_hash

    def __eq__(self, other):
        return type(other) is type(self) and hash(other) == hash(self)

    def tables(self) -> FbowTables:
        """Kernel V's tables on the vocabulary's device, built once."""
        if self._tables is None:
            nblocks, m_k = self.node_info.shape
            up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            self._tables = FbowTables(
                centers=up(pack_centers(self.centers_pm1).reshape(nblocks * m_k, 8)),
                node_info=up(np.asarray(self.node_info, np.uint32).reshape(-1).view(np.int32)),
                n_children=up(np.asarray(self.n_children, np.int32)),
                m_k=int(m_k), max_depth=self.max_depth)
        return self._tables

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
        words = np.where(valid, words.astype(np.int64), -1)
        vw = words[words >= 0]
        if len(vw) == 0:
            return words, {}
        uniq, cnt = np.unique(vw, return_counts=True)
        total = cnt.sum()
        return words, {int(w): float(c) / total for w, c in zip(uniq, cnt)}

    @staticmethod
    def score(bow1: Dict[int, float], bow2: Dict[int, float]) -> float:
        s = 0.0
        for w, v in bow1.items():
            u = bow2.get(w)
            if u is not None:
                s += min(v, u)
        return s


# ---------------------------------------------------------------------------
def read_fbow(path: str, device="cuda") -> FbowVocabulary:
    with open(path, "rb") as f:
        raw = f.read()
    (sig,) = struct.unpack_from("<Q", raw, 0)
    if sig != FBOW_SIGNATURE:
        raise ValueError(
            f"{path}: not an FBoW vocabulary (signature {sig:#x}, "
            f"expected {FBOW_SIGNATURE:#x})")
    (desc_name, aligment, nblocks, desc_size_wp, block_size_wp,
     feature_off, child_off, total_size, desc_type, desc_size,
     m_k, nwords) = struct.unpack_from(_PARAMS_FMT, raw, 8)
    desc_name = desc_name.split(b"\0")[0].decode("ascii", "replace")
    if desc_size != 32:
        raise ValueError(
            f"{path}: descriptor size {desc_size} bytes unsupported "
            "(expected 32-byte ORB)")
    data = np.frombuffer(raw, np.uint8, count=total_size,
                         offset=8 + _PARAMS_SIZE)
    blocks = data[: nblocks * block_size_wp].reshape(nblocks, block_size_wp)

    n_children = blocks[:, 0:2].copy().view("<u2")[:, 0].astype(np.int32)
    n_children = np.minimum(n_children, m_k)
    info_bytes = blocks[:, child_off: child_off + m_k * 8]
    info = np.ascontiguousarray(info_bytes).view(_NODE_INFO).reshape(
        nblocks, m_k)
    feats = blocks[:, feature_off: feature_off + m_k * desc_size_wp]
    feats = np.ascontiguousarray(feats).reshape(nblocks, m_k, desc_size_wp)
    feats = feats[:, :, :desc_size]  # drop alignment padding

    bits = np.unpackbits(feats.reshape(-1, desc_size), axis=1,
                         bitorder="little")
    pm1 = (bits.astype(np.float32) * 2 - 1).reshape(nblocks, m_k, 256)
    kmask = np.arange(m_k)[None, :] < n_children[:, None]
    pm1 *= kmask[:, :, None]

    # depth bound: walk down following max child-block index per level
    depth, frontier = 0, {0}
    seen = set()
    while frontier and depth < 64:
        depth += 1
        nxt = set()
        for b in frontier:
            if b in seen or b >= nblocks:
                continue
            seen.add(b)
            for k in range(n_children[b]):
                v = int(info[b, k]["id_or_childblock"])
                if not (v & _LEAF):
                    nxt.add(v)
        frontier = nxt
    vocab = FbowVocabulary(pm1, info["id_or_childblock"].copy(),
                           n_children, depth, desc_name, device=device)
    vocab.weights = info["weight"].copy()
    if nwords and vocab.num_words > nwords:
        # ids must stay within the declared word count
        raise ValueError(f"{path}: corrupt vocabulary (word id "
                         f"{vocab.num_words - 1} >= nwords {nwords})")
    vocab.num_words = max(vocab.num_words, int(nwords))
    return vocab


def write_fbow(path: str, centers_pm1_levels, desc_name: str = "orb",
               aligment: int = 8):
    """Serialize a COMPLETE k-ary tree (list of per-level center arrays,
    level l shaped [K^(l+1), 256] in {-1,+1}, the layout of
    BowVocabulary.centers) into the FBoW on-disk format: blocks in BFS
    order, block 0 the root; leaf children carry sequential word ids with
    the MSB set and weight 1.0."""
    K = centers_pm1_levels[0].shape[0]
    depth = len(centers_pm1_levels)
    desc_size = 32
    desc_size_wp = -(-desc_size // aligment) * aligment
    child_off = 8
    feature_off = child_off + K * 8
    # feature area aligned
    feature_off = -(-feature_off // aligment) * aligment
    block_size = feature_off + K * desc_size_wp
    block_size_wp = -(-block_size // aligment) * aligment

    # interior nodes: levels 0..depth-1 have K^l blocks each (root = K^0)
    nblocks = sum(K**l for l in range(depth))
    buf = np.zeros((nblocks, block_size_wp), np.uint8)
    # block index of interior node (level l, index i) in BFS order
    first_block_of_level = np.cumsum([0] + [K**l for l in range(depth)])

    nwords = K**depth
    for lvl in range(depth):
        c = centers_pm1_levels[lvl]
        for parent in range(K**lvl):
            b = first_block_of_level[lvl] + parent
            blk = buf[b]
            blk[0:2].view("<u2")[0] = K
            blk[2] = 1 if lvl == depth - 1 else 0
            blk[4:8].view("<u4")[0] = (
                first_block_of_level[lvl - 1] + parent // K if lvl else 0)
            info = blk[child_off: child_off + K * 8].view(_NODE_INFO)
            for k in range(K):
                node = parent * K + k
                if lvl == depth - 1:
                    info[k]["id_or_childblock"] = _LEAF | node
                    info[k]["weight"] = 1.0
                else:
                    info[k]["id_or_childblock"] = (
                        first_block_of_level[lvl + 1] + node)
                    info[k]["weight"] = 0.0
                center_bits = (c[node] > 0).astype(np.uint8)
                packed = np.packbits(center_bits, bitorder="little")
                blk[feature_off + k * desc_size_wp:
                    feature_off + k * desc_size_wp + desc_size] = packed

    total_size = nblocks * block_size_wp
    params = struct.pack(
        _PARAMS_FMT, desc_name.encode("ascii"), aligment, nblocks,
        desc_size_wp, block_size_wp, feature_off, child_off, total_size,
        0, desc_size, K, nwords)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", FBOW_SIGNATURE))
        f.write(params)
        f.write(buf.tobytes())
