// Which atomics on another block's shared memory give the right answer on
// this card: a cluster of 8 blocks of 512 threads, each thread aiming at
// entry (tid % 64) of block (tid / 64 + rank) % 8 with a 32-bit atomicCAS,
// a 32-bit atomicMin, a 64-bit atomicMin and a 64-bit minimum by a CAS loop,
// through cooperative_groups' map_shared_rank (distributed shared memory).
// Block 0 then checks its 64 entries against the minimum computed on the
// card by one thread, and counts the CAS claimers of each entry.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//         -o dsmem_atomics_check scripts/dsmem_atomics_check.cu && ./dsmem_atomics_check
//
// Kernel Q's dedup (stella_vslam_tpu_torch/csrc/track_assoc.cu) keeps to
// the atomics this reports right.
#include <cooperative_groups.h>

#include <cstdint>
#include <cstdio>

namespace cg = cooperative_groups;

constexpr int kEntries = 64;

__device__ unsigned long long packed(unsigned v) {
  return ((unsigned long long)(0x80000000u | (v & 7)) << 32) | v;
}

__global__ void check(unsigned* out) {
  __shared__ unsigned cas32[kEntries], min32[kEntries], claims[kEntries], wrong[kEntries];
  __shared__ unsigned long long min64[kEntries], loop64[kEntries];
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank(), t = threadIdx.x;
  for (int i = t; i < kEntries; i += blockDim.x) {
    cas32[i] = min32[i] = 0xffffffffu;
    claims[i] = wrong[i] = 0;
    min64[i] = loop64[i] = ~0ull;
  }
  cl.sync();
  const int e = t % kEntries, dst = (t / kEntries + r) % 8;
  const unsigned v = (unsigned)(r * 512 + t) ^ 0x5a5au;
  const unsigned prev = atomicCAS(cl.map_shared_rank(cas32, dst) + e, 0xffffffffu, v);
  atomicMin(cl.map_shared_rank(min32, dst) + e, v);
  atomicMin(cl.map_shared_rank(min64, dst) + e, packed(v));
  unsigned long long* p = cl.map_shared_rank(loop64, dst) + e;
  unsigned long long old = *(volatile unsigned long long*)p;
  while (packed(v) < old) {
    const unsigned long long got = atomicCAS(p, old, packed(v));
    if (got == old) break;
    old = got;
  }
  if (prev == 0xffffffffu) atomicAdd(cl.map_shared_rank(claims, dst) + e, 1u);
  cl.sync();
  if (prev != 0xffffffffu && prev != cl.map_shared_rank(cas32, dst)[e])
    atomicAdd(cl.map_shared_rank(wrong, dst) + e, 1u);
  cl.sync();
  if (r == 0 && t < kEntries) {
    unsigned m32 = 0xffffffffu;
    unsigned long long m64 = ~0ull;
    for (int rr = 0; rr < 8; ++rr)
      for (int tt = 0; tt < 512; ++tt) {
        if (tt % kEntries != t || (tt / kEntries + rr) % 8 != 0) continue;
        const unsigned vv = (unsigned)(rr * 512 + tt) ^ 0x5a5au;
        m32 = min(m32, vv);
        m64 = packed(vv) < m64 ? packed(vv) : m64;
      }
    out[5 * t] = min32[t] == m32;
    out[5 * t + 1] = min64[t] == m64;
    out[5 * t + 2] = loop64[t] == m64;
    out[5 * t + 3] = claims[t] == 1;
    out[5 * t + 4] = wrong[t];
  }
  cl.sync();
}

int main() {
  unsigned* d = nullptr;
  cudaMalloc(&d, 5 * kEntries * sizeof(unsigned));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8);
  cfg.blockDim = dim3(512);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 8;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, check, d);
  const cudaError_t sync = cudaDeviceSynchronize();
  unsigned h[5 * kEntries];
  cudaMemcpy(h, d, sizeof h, cudaMemcpyDeviceToHost);
  int ok[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < kEntries; ++i)
    for (int j = 0; j < 5; ++j) ok[j] += (int)h[5 * i + j];
  printf("launch %d, sync %d; entries right of %d: 32-bit atomicMin %d, 64-bit atomicMin %d, "
         "64-bit CAS loop %d, 32-bit CAS with one claimer %d; CAS losers that saw another "
         "value than the entry's %d\n",
         (int)launch, (int)sync, kEntries, ok[0], ok[1], ok[2], ok[3], ok[4]);
  cudaFree(d);
  return launch == cudaSuccess && sync == cudaSuccess ? 0 : 1;
}
