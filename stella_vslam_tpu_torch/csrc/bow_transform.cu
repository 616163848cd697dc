// Kernel M: bag-of-words tree descent.
//
// Replaces stella_vslam_tpu/data/bow_vocabulary.py BowVocabulary.transform
// (:76). The TPU form multiplies the +-1 descriptors with every center of a
// level (four bf16 matmuls of [N,256] x [256, 10..10000] with f32 sums) and
// picks the current node's ten children by a one-hot product, because it has
// no cheap gather. Here each descriptor walks the tree itself: one thread per
// descriptor, per level XOR + popcount of its 8 words against the 10
// children of its node, the least distance wins and ties go to the lowest
// child index (the first maximum of the similarity 256 - 2 * distance, which
// is an exact integer in the TPU form too, so the leaf ids are equal).
//
// centers: [10 + 100 + 1000 + 10000, 8] uint32, levels in order; the children
// of node p of a level are rows p*10 .. p*10+9 of the next. The two top
// levels (110 nodes, 3.5 KB) sit in shared memory; the rest (352 KB) stays
// in L2. Bound: 40 distances of 8 words per descriptor (~1000 integer
// operations) against 36 bytes per descriptor plus the 355 KB of centers:
// bound by the centers' bytes at the slice's N = 2872, and by latency in
// practice (4 dependent gathers).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBranch = 10;
constexpr int kDepth = 4;
constexpr int kTopNodes = kBranch + kBranch * kBranch;  // levels 0 and 1
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
bow_transform_kernel(int N, const uint32_t* __restrict__ desc,
                     const uint32_t* __restrict__ centers, int* __restrict__ out) {
  __shared__ uint32_t top[kTopNodes * 8];
  for (int i = threadIdx.x; i < kTopNodes * 8; i += blockDim.x) top[i] = centers[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  uint32_t d[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) d[w] = desc[8 * n + w];
  int node = 0;
  int base = 0;     // first row of the level
  int count = kBranch;  // nodes in the level
  for (int lvl = 0; lvl < kDepth; ++lvl) {
    const uint32_t* c = (lvl < 2 ? top : centers) + 8 * (base + node * kBranch);
    int best = 257, best_k = 0;
    for (int k = 0; k < kBranch; ++k) {
      int dist = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) dist += __popc(d[w] ^ c[8 * k + w]);
      if (dist < best) {
        best = dist;
        best_k = k;
      }
    }
    node = node * kBranch + best_k;
    base += count;
    count *= kBranch;
  }
  out[n] = node;
}

}  // namespace

extern "C" int svt_bow_transform(int N, const uint32_t* desc, const uint32_t* centers,
                                 int* out, void* stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0)
    bow_transform_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(N, desc, centers, out);
  return (int)cudaGetLastError();
}
