// Kernel V: the vocabulary tree's descent, for both vocabulary forms.
//
// Replaces stella_vslam_tpu/data/fbow_io.py FbowVocabulary.transform (:128)
// and stella_vslam_tpu/data/bow_vocabulary.py BowVocabulary.transform
// (:76). The TPU forms keep one current node per descriptor and run the
// levels in lockstep: a gather of the node's +-1 children (FBoW) or a
// product with every centre of the level and a one-hot pick of the node's
// children (.npz), a bf16 product with the +-1 descriptor (256 - 2 Hamming,
// exact in f32), the first argmax over the children, masked updates for the
// descriptors that reached a leaf. Both trees reach this kernel as FBoW
// block tables: the .npz form's regular tree is 1 + 10 + 100 + 1000 blocks
// of 10 children (data/bow_vocabulary.py BowVocabulary.tables).
//
// A group of 16 lanes walks one descriptor, 8 descriptors a block of 128
// threads (at a keyframe's 2872 descriptors 359 blocks, every SM busy).
// Per round, lane k reads child k's 32-byte centre as two 16-byte loads
// through the read-only path, its node_info word and the block's child
// count, all of which depend only on the current block, takes the Hamming
// distance (XOR and popcount of 8 words), and the group takes the least
// (distance << 16) | k with __reduce_min_sync: the lowest child on ties,
// the JAX version's first argmax of 256 - 2 Hamming. The winner's
// node_info comes from its lane by a shuffle. Children past 16 (m_k > 16)
// are looped by lane, and their node_info is read after the choice. The
// MSB of node_info marks a leaf, whose low 31 bits are the word id, else
// they are the child block (read clamped to the last block, as JAX's
// gather clamps an out-of-range index). A descriptor that reaches a leaf
// stops there; one that has not after max_depth rounds gets word 0. A block
// with no child takes child 0, as the first argmin of all-absent distances.
//
// Nothing is staged in shared memory: a round's loads depend only on the
// current block, so each round is one trip to L2, as a round from a staged
// copy would be after the trip that stages it (staging the first two
// levels, 11 x 10 x 36 bytes at m_k = 10, measured 0.0084 against 0.0050
// ms at 2872 descriptors on the H100; scripts/torch_bow_pnp_probe.py).
//
// Bound: per descriptor and visited block, m_k centres of 32 bytes and
// their node_info (the tables are read through L1 / L2; the bound counts
// each distinct table byte the run visits once, plus 32 bytes in and 4 out
// a descriptor) against ~3 integer operations per centre word, the larger.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 16;
constexpr uint32_t kLeaf = 0x80000000u;

struct Tables {
  const uint4* centers;  // [nblocks * m_k][2]: a centre's 8 words
  const uint32_t* node_info;
  const int* n_children;
  int nblocks, m_k;
};

__device__ __forceinline__ int popc_xor(const uint4& a, const uint4& b, const uint4& c,
                                        const uint4& d) {
  return __popc(a.x ^ c.x) + __popc(a.y ^ c.y) + __popc(a.z ^ c.z) + __popc(a.w ^ c.w) +
         __popc(b.x ^ d.x) + __popc(b.y ^ d.y) + __popc(b.z ^ d.z) + __popc(b.w ^ d.w);
}

__global__ void __launch_bounds__(kThreads)
fbow_transform_kernel(int N, int max_depth, Tables t, const uint4* __restrict__ desc,
                      int* __restrict__ out) {
  const int m_k = t.m_k;
  const int lane = threadIdx.x & (kGroup - 1);
  const int n = blockIdx.x * (kThreads / kGroup) + threadIdx.x / kGroup;
  if (n >= N) return;  // the whole group leaves together
  const unsigned mask = 0xFFFFu << (threadIdx.x & 16);
  const uint4 d0 = __ldg(desc + 2 * n), d1 = __ldg(desc + 2 * n + 1);
  int blk = 0, word = 0;
  for (int round = 0; round < max_depth; ++round) {
    const size_t base = (size_t)m_k * blk;
    const int nc = min(__ldg(t.n_children + blk), m_k);
    uint32_t key = 0xFFFFFFFFu, my_info = 0;
    for (int k = lane; k < m_k; k += kGroup) {
      const uint4 c0 = __ldg(t.centers + 2 * (base + k)), c1 = __ldg(t.centers + 2 * (base + k) + 1);
      const uint32_t info = __ldg(t.node_info + base + k);
      if (k == lane) my_info = info;
      if (k < nc) key = min(key, ((uint32_t)popc_xor(d0, d1, c0, c1) << 16) | (uint32_t)k);
    }
    key = __reduce_min_sync(mask, key);
    const int best = key == 0xFFFFFFFFu ? 0 : (int)(key & 0xFFFFu);
    uint32_t info = __shfl_sync(mask, my_info, best & (kGroup - 1), kGroup);
    if (best >= kGroup) info = __ldg(t.node_info + base + best);
    if (info & kLeaf) {
      word = (int)(info & 0x7FFFFFFFu);
      break;
    }
    blk = min((int)info, t.nblocks - 1);
  }
  if (lane == 0) out[n] = word;
}

}  // namespace

// desc [N,8] (16-byte aligned), centers [nblocks * m_k, 8] (16-byte
// aligned), node_info [nblocks * m_k] (uint32 bits), n_children [nblocks];
// out [N] word ids
extern "C" int svt_fbow_transform(int N, int nblocks, int m_k, int max_depth,
                                  const uint32_t* desc, const uint32_t* centers,
                                  const uint32_t* node_info, const int* n_children, int* out,
                                  void* stream) {
  if (nblocks <= 0 || m_k <= 0 || m_k > 0xFFFF) return (int)cudaErrorInvalidValue;
  const int per_block = kThreads / kGroup;
  const int blocks = (N + per_block - 1) / per_block;
  const Tables t{reinterpret_cast<const uint4*>(centers), node_info, n_children, nblocks, m_k};
  if (blocks > 0)
    fbow_transform_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        N, max_depth, t, reinterpret_cast<const uint4*>(desc), out);
  return (int)cudaGetLastError();
}
