// The RANSAC minimal-set sampler shared by kernels E (ransac_two_view.cu),
// U (essential_5pt.cu) and N (pnp_ransac.cu).
//
// Replaces stella_vslam_tpu/ops/solve/ransac.py hash_uniform (:30) and
// sample_minimal_sets (:50): slot s of set b takes the argmax over the N
// matches of the hashed uniform of the flat index (b * K + s) * N + n,
// -1.0 where the match is invalid, the lowest index on ties. The hash is
// integer arithmetic and its uniforms are exact in f32, so comparing the
// integers they scale gives the JAX version's indices bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace svt_ransac {

// The hash's uniform (hash_uniform of the JAX version: (x >> 8) / 2^24) as
// the integer it scales: the same order, without the conversion and the
// product.
__device__ __forceinline__ int hash_key(uint32_t seed_mul, uint32_t i) {
  uint32_t x = i + seed_mul;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (int)(x >> 8);
}

// The whole block draws set b's K indices into idx (shared memory, K ints)
// in one pass over the N matches: a position that is not valid keys -1,
// below every valid one, so it is not hashed, and where no position is
// valid every slot takes index 0 (the lowest of the tied -1 keys). Every
// thread calls it. Up to 32 warps. A thread reads the validity of BATCH of
// its matches at once before it hashes them in order (so BATCH loads are
// in flight, not one).
//
// on_match(n, ok, live) is called for every match, by the lanes of a warp
// together: live holds the lanes whose n < N (the first ones of the warp,
// whose n are consecutive), so the hook may take a ballot over them.
struct NoHook {
  __device__ void operator()(int, bool, unsigned) {}
};

template <int K, int BATCH, class Hook>
__device__ void sample_set(uint32_t seed, int b, int N, const uint8_t* __restrict__ valid,
                           int* idx, Hook& on_match) {
  __shared__ int bv_s[32][K];
  __shared__ int bi_s[32][K];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t seed_mul = seed * 2654435761u;
  int bv[K], bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bv[s] = -2;
    bi[s] = 0x7fffffff;
  }
  const int step = blockDim.x;
  for (int n0 = tid; n0 < N; n0 += BATCH * step) {
    bool ok[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) ok[u] = n0 + u * step < N && valid[n0 + u * step] != 0;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int n = n0 + u * step;
      if (n >= N) break;
      const int live = N - (n - lane);
      on_match(n, ok[u], live >= 32 ? 0xffffffffu : (1u << live) - 1u);
      if (!ok[u]) continue;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const uint32_t flat = ((uint32_t)b * K + s) * (uint32_t)N + (uint32_t)n;
        const int key = hash_key(seed_mul, flat);
        // this thread's n only grows: a tie keeps the lower index
        if (key > bv[s]) {
          bv[s] = key;
          bi[s] = n;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    for (int o = 16; o > 0; o >>= 1) {
      const int ov = __shfl_xor_sync(0xffffffffu, bv[s], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[s], o);
      if (ov > bv[s] || (ov == bv[s] && oi < bi[s])) {
        bv[s] = ov;
        bi[s] = oi;
      }
    }
    if (lane == 0) {
      bv_s[warp][s] = bv[s];
      bi_s[warp][s] = bi[s];
    }
  }
  __syncthreads();
  if (tid < K) {
    int v = bv_s[0][tid], i = bi_s[0][tid];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (bv_s[w][tid] > v || (bv_s[w][tid] == v && bi_s[w][tid] < i)) {
        v = bv_s[w][tid];
        i = bi_s[w][tid];
      }
    idx[tid] = v < 0 ? 0 : i;
  }
  __syncthreads();
}

template <int K, int BATCH = 1>
__device__ void sample_set(uint32_t seed, int b, int N, const uint8_t* __restrict__ valid,
                           int* idx) {
  NoHook none;
  sample_set<K, BATCH>(seed, b, N, valid, idx, none);
}

}  // namespace svt_ransac
