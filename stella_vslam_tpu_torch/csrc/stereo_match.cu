// Kernel T (K19): rectified stereo keypoint matching.
//
// Replaces stella_vslam_tpu/match/stereo.py: stereo_match (:32). The TPU
// form builds the [NL, NR] masked Hamming matrix (row band, disparity range,
// level within one, validity), takes min / argmin per row, gathers the best
// right patch with a one-hot bf16 matmul, slides an 11x11 SAD window +-5 px,
// refines by a parabola and filters by twice the masked mean SAD.
//
// On Hopper, two launches:
//  1. stereo_match_kernel: one warp per left keypoint. The lanes walk the
//     right keypoints (lane-strided, so a warp reads 32 consecutive
//     descriptors per step), apply the gates in the JAX version's float32
//     arithmetic and keep the packed key (distance << 16 | index): the
//     warp's minimum key is the lowest index among the smallest distances,
//     as jnp.min / jnp.argmin give, and an empty row gives 257 and index 0.
//     A matched row (distance < 75) then computes its 11 SADs in integers
//     (lane d sums the 121 absolute differences of shift d - 5 over the
//     11x21 blurred strips kernel B wrote), and lane 0 takes the argmin
//     (lowest shift on ties), the parabola and the disparity, in the JAX
//     version's order of float32 operations.
//  2. stereo_filter_kernel: one block sums the matched rows' SADs and count
//     in integers (the JAX version's float32 sum is exact while it stays
//     under 2^24), forms the mean as float32 / float32 and applies the 2x
//     filter, then writes x_right and depth (-1 where unmatched).
// Bound: operations — NL x NR candidate pairs, each with ~6 compares and,
// where the gates pass, 8 XOR + 8 popc; the right descriptors (92 KB) stay
// in L2. The SAD step is 1331 integer ops per matched row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStripH = 11, kStripW = 21, kStripArea = kStripH * kStripW;
constexpr int kWin = 5, kSlide = 5, kShifts = 2 * kSlide + 1;
constexpr int kWarps = 8;
constexpr unsigned kEmptyKey = 257u << 16;
constexpr int kFilterThreads = 1024;

__global__ void __launch_bounds__(kWarps * 32)
stereo_match_kernel(int NL, int NR, const float* __restrict__ l_xy,
                    const int* __restrict__ l_level, const uint32_t* __restrict__ l_desc,
                    const uint8_t* __restrict__ l_valid, const uint8_t* __restrict__ l_strip,
                    const float* __restrict__ r_xy, const int* __restrict__ r_level,
                    const uint32_t* __restrict__ r_desc, const uint8_t* __restrict__ r_valid,
                    const uint8_t* __restrict__ r_strip, const float* __restrict__ scale_factors,
                    float max_disp, int* __restrict__ best_sad_out,
                    float* __restrict__ disp_out, uint8_t* __restrict__ matched_out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= NL) return;
  const bool lv = l_valid[i] != 0;
  const float lx = l_xy[2 * i], ly = l_xy[2 * i + 1];
  const int ll = l_level[i];
  uint32_t ld[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) ld[w] = l_desc[i * 8 + w];

  unsigned key = kEmptyKey;
  if (lv)
    for (int j = lane; j < NR; j += 32) {
      if (!r_valid[j]) continue;
      const int rl = r_level[j];
      if (abs(ll - rl) > 1) continue;
      const float dy = fabsf(__fsub_rn(r_xy[2 * j + 1], ly));
      if (!(dy <= 2.0f * scale_factors[rl])) continue;
      const float disp = __fsub_rn(lx, r_xy[2 * j]);
      if (!(disp >= 0.0f && disp < max_disp)) continue;
      int d = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) d += __popc(ld[w] ^ r_desc[j * 8 + w]);
      key = min(key, ((unsigned)d << 16) | (unsigned)j);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
  const int best = (int)(key >> 16), best_idx = (int)(key & 0xffffu);
  const bool matched = lv && best < 75;  // (THR_LOW + THR_HIGH) / 2

  int sad = 0;
  if (matched && lane < kShifts) {
    // lane d: window of the right strip shifted by d - 5 against the left
    // strip's centre window
    const uint8_t* lp = l_strip + (size_t)i * kStripArea;
    const uint8_t* rp = r_strip + (size_t)best_idx * kStripArea;
    for (int r = 0; r < kStripH; ++r)
#pragma unroll
      for (int c = 0; c < 2 * kWin + 1; ++c)
        sad += abs((int)lp[r * kStripW + kSlide + c] - (int)rp[r * kStripW + lane + c]);
  }
  int sads[kShifts];
#pragma unroll
  for (int d = 0; d < kShifts; ++d) sads[d] = __shfl_sync(0xffffffffu, sad, d);
  if (lane != 0) return;
  if (!matched) {
    best_sad_out[i] = 0;
    disp_out[i] = 0.0f;
    matched_out[i] = 0;
    return;
  }
  int best_d = 0, best_sad = sads[0];
#pragma unroll
  for (int d = 1; d < kShifts; ++d)
    if (sads[d] < best_sad) {
      best_sad = sads[d];
      best_d = d;
    }
  const int ds = min(max(best_d, 1), kShifts - 2);
  const float s_m = (float)sads[ds - 1], s_0 = (float)sads[ds], s_p = (float)sads[ds + 1];
  const float denom = __fsub_rn(__fadd_rn(s_m, s_p), __fmul_rn(2.0f, s_0));
  float frac = fabsf(denom) > 1e-6f
                   ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(s_m, s_p)), denom)
                   : 0.0f;
  frac = fminf(fmaxf(frac, -1.0f), 1.0f);
  const bool at_border = best_d == 0 || best_d == 2 * kSlide;
  const float delta = at_border ? (float)(best_d - kSlide)
                                : __fadd_rn((float)(ds - kSlide), frac);
  const float x_right = __fadd_rn(r_xy[2 * best_idx], delta);
  float disparity = __fsub_rn(lx, x_right);
  if (disparity <= 0.0f) disparity = 0.01f;
  best_sad_out[i] = best_sad;
  disp_out[i] = disparity;
  matched_out[i] = (disparity > 0.0f && disparity < max_disp) ? 1 : 0;
}

__global__ void __launch_bounds__(kFilterThreads)
stereo_filter_kernel(int NL, const float* __restrict__ l_xy,
                     const int* __restrict__ best_sad, const float* __restrict__ disp,
                     const uint8_t* __restrict__ matched, float focal_x_baseline,
                     float* __restrict__ x_right_out, float* __restrict__ depth_out) {
  __shared__ unsigned long long s_sum[kFilterThreads / 32];
  __shared__ int s_cnt[kFilterThreads / 32];
  unsigned long long sum = 0;
  int cnt = 0;
  for (int i = threadIdx.x; i < NL; i += kFilterThreads)
    if (matched[i]) {
      sum += (unsigned long long)best_sad[i];
      ++cnt;
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  }
  if ((threadIdx.x & 31) == 0) {
    s_sum[threadIdx.x >> 5] = sum;
    s_cnt[threadIdx.x >> 5] = cnt;
  }
  __syncthreads();
  unsigned long long total = 0;
  int n = 0;
  for (int w = 0; w < kFilterThreads / 32; ++w) {
    total += s_sum[w];
    n += s_cnt[w];
  }
  const float mean = __fdiv_rn((float)total, (float)max(n, 1));
  const float thr = __fmul_rn(2.0f, mean);
  for (int i = threadIdx.x; i < NL; i += kFilterThreads) {
    const bool keep = matched[i] && (float)best_sad[i] <= thr;
    depth_out[i] = keep ? __fdiv_rn(focal_x_baseline, disp[i]) : -1.0f;
    x_right_out[i] = keep ? __fsub_rn(l_xy[2 * i], disp[i]) : -1.0f;
  }
}

}  // namespace

// scratch: best_sad [NL] int, disp [NL] float, matched [NL] bytes
extern "C" int svt_stereo_match(int NL, int NR, const float* l_xy, const int* l_level,
                                const uint32_t* l_desc, const uint8_t* l_valid,
                                const uint8_t* l_strip, const float* r_xy,
                                const int* r_level, const uint32_t* r_desc,
                                const uint8_t* r_valid, const uint8_t* r_strip,
                                const float* scale_factors, float max_disp,
                                float focal_x_baseline, int* best_sad, float* disp,
                                uint8_t* matched, float* x_right_out, float* depth_out,
                                void* stream) {
  if (NL <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  stereo_match_kernel<<<(NL + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      NL, NR, l_xy, l_level, l_desc, l_valid, l_strip, r_xy, r_level, r_desc, r_valid,
      r_strip, scale_factors, max_disp, best_sad, disp, matched);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stereo_filter_kernel<<<1, kFilterThreads, 0, s>>>(NL, l_xy, best_sad, disp, matched,
                                                     focal_x_baseline, x_right_out, depth_out);
  return (int)cudaGetLastError();
}
