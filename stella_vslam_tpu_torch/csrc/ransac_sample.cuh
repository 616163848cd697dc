// The RANSAC minimal-set sampler shared by kernels E (ransac_two_view.cu)
// and U (essential_5pt.cu).
//
// Replaces stella_vslam_tpu/ops/solve/ransac.py hash_uniform (:30) and
// sample_minimal_sets (:50): slot s of set b takes the argmax over the N
// matches of the hashed uniform of the flat index (b * K + s) * N + n,
// -1.0 where the match is invalid, the lowest index on ties. The hash is
// integer arithmetic and its uniforms are exact in f32, so the indices equal
// the JAX version's bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace svt_ransac {

__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t i) {
  uint32_t x = i + seed * 2654435761u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// argmax order: larger value first, then the lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The whole block draws set b's K indices into idx (shared memory, K ints);
// every thread calls it. Up to 32 warps.
template <int K>
__device__ void sample_set(uint32_t seed, int b, int N, const uint8_t* __restrict__ valid,
                           int* idx) {
  __shared__ float bv_s[32][K];
  __shared__ int bi_s[32][K];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float bv[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bv[s] = -2.f;
    bi[s] = 0x7fffffff;
  }
  for (int n = tid; n < N; n += blockDim.x) {
    const bool ok = valid[n] != 0;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const uint32_t flat = ((uint32_t)b * K + s) * (uint32_t)N + (uint32_t)n;
      const float u = ok ? hash_uniform(seed, flat) : -1.f;
      if (better(u, n, bv[s], bi[s])) {
        bv[s] = u;
        bi[s] = n;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[s], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[s], o);
      if (better(ov, oi, bv[s], bi[s])) {
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
    float v = bv_s[0][tid];
    int i = bi_s[0][tid];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (better(bv_s[w][tid], bi_s[w][tid], v, i)) {
        v = bv_s[w][tid];
        i = bi_s[w][tid];
      }
    idx[tid] = i;
  }
  __syncthreads();
}

}  // namespace svt_ransac
