// Kernel V: the FBoW vocabulary's tree descent.
//
// Replaces stella_vslam_tpu/data/fbow_io.py FbowVocabulary.transform
// (:128). The TPU form keeps one current block per descriptor and runs
// max_depth rounds in lockstep: a gather of the block's m_k +-1 centres
// ([N, m_k, 256] bf16), a batched product with the +-1 descriptor (256 - 2
// Hamming, exact in f32), the first argmax over the block's n_children, and
// masked updates for the descriptors that reached a leaf.
//
// Here each descriptor walks the tree itself, as kernel M does on the
// regular tree (csrc/bow_transform.cu), with the node table indexed by
// block: one thread per descriptor; at each block the XOR-popcount of its
// 8 words against the block's n_children centres, packed to 8 words once
// at load; the least distance wins and ties go to the lowest child (the
// first maximum of the similarity); the MSB of the chosen child's
// node_info marks a leaf, whose low 31 bits are the word id, else they are
// the child block (read clamped to the last block, as JAX's gather clamps
// an out-of-range index). A descriptor that reaches a leaf stops there and
// holds its word; one that has not after max_depth rounds gets word 0.
//
// Bound: per descriptor and visited block, n_children x 8 words of XOR,
// popcount and add (~240 integer operations at m_k = 10) against 36 bytes
// per descriptor plus the tables (the fixture's 913 blocks: 292 KB of
// centres, read through L1/L2); at a keyframe's 2872 descriptors it is
// bound by the tables' bytes, and by latency in practice (max_depth
// dependent gathers).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fbow_transform_kernel(int N, int nblocks, int m_k, int max_depth,
                      const uint32_t* __restrict__ desc, const uint32_t* __restrict__ centers,
                      const uint32_t* __restrict__ node_info, const int* __restrict__ n_children,
                      int* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  uint32_t d[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) d[w] = desc[8 * n + w];
  int blk = 0;
  int word = 0;
  for (int round = 0; round < max_depth; ++round) {
    const int nc = min(n_children[blk], m_k);
    const uint32_t* c = centers + 8 * (long long)blk * m_k;
    int best = 257, best_k = 0;
    for (int k = 0; k < nc; ++k) {
      int dist = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) dist += __popc(d[w] ^ c[8 * k + w]);
      if (dist < best) {
        best = dist;
        best_k = k;
      }
    }
    const uint32_t info = node_info[(long long)blk * m_k + best_k];
    const int payload = (int)(info & 0x7fffffffu);
    if (info & 0x80000000u) {
      word = payload;
      break;
    }
    blk = min(payload, nblocks - 1);
  }
  out[n] = word;
}

}  // namespace

// desc [N,8], centers [nblocks * m_k, 8], node_info [nblocks * m_k] (uint32
// bits), n_children [nblocks]; out [N] word ids
extern "C" int svt_fbow_transform(int N, int nblocks, int m_k, int max_depth, const uint32_t* desc,
                                  const uint32_t* centers, const uint32_t* node_info,
                                  const int* n_children, int* out, void* stream) {
  if (nblocks <= 0 || m_k <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0)
    fbow_transform_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        N, nblocks, m_k, max_depth, desc, centers, node_info, n_children, out);
  return (int)cudaGetLastError();
}
