// Kernel B: IC-angle orientation, in-patch blur and steered BRIEF.
//
// Replaces stella_vslam_tpu/feature/orb_extractor.py: _extract_patches
// (:392), the IC-angle and blur lines of _process_level (:378-383) and
// _describe_all (:418). The TPU form gathers 45x45 patches with one-hot
// bf16 matmuls, blurs with a [2025 -> 1521] matmul and evaluates all 30
// steering bins x 256 pairs as one [7680, 1521] matmul before selecting a
// bin — matmuls because per-element gathers serialize on the TPU.
//
// On Hopper: one 256-thread block per keypoint, with real gathers. The
// block loads its clamped 45x45 raw patch into shared memory (rounded to
// bf16, as the JAX version's patches are), reduces the two moment sums,
// takes atan2f, blurs the central 39x39 with the 49 two-dimensional f32 taps
// (a fixed ty-major order; products and sums rounded separately, no FMA),
// rounds with rintf, and computes only the selected bin's 256 comparisons:
// thread p compares pair p, and a warp ballot packs word p/32. Bound: ~98 K
// flops and 8 KB of gathers per keypoint, ~0.3 GFLOP per 2872-slot frame —
// arithmetic in shared memory; the design keeps every intermediate (raw and
// blurred patch, comparison bits) on chip.
//
// For the stereo matcher (K19's subpixel step, stella_vslam_tpu/match/
// stereo.py:67-98, which reads the blurred patches that
// extract_with_patches returns) the kernel optionally writes the 11x21
// strip around the blurred patch's centre (rows 14..24, columns 9..29 of
// the 39x39) as bytes: the blurred values are integer gray levels 0..255,
// exact in a byte as in the JAX version's bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRawR = 22;
constexpr int kRawW = 45;
constexpr int kRawArea = kRawW * kRawW;
constexpr int kDescW = 39;
constexpr int kDescArea = kDescW * kDescW;
constexpr int kMomW = 31;
constexpr int kMomOff = kRawR - 15;  // moment circle centred in the raw patch
constexpr int kBins = 30;
constexpr int kThreads = 256;
constexpr int kStripH = 11, kStripW = 21;
constexpr int kStripY = kDescW / 2 - kStripH / 2;  // 14
constexpr int kStripX = kDescW / 2 - kStripW / 2;  // 9

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, scratch[w]);
  return s;
}

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const float* __restrict__ pyr, const int* __restrict__ kp_base,
                    const int* __restrict__ kp_H, const int* __restrict__ kp_W,
                    const int* __restrict__ kp_x, const int* __restrict__ kp_y,
                    const uint8_t* __restrict__ kp_valid,
                    const float* __restrict__ taps49, const float* __restrict__ m10,
                    const float* __restrict__ m01, const int8_t* __restrict__ offsets,
                    float tau, float* __restrict__ out_angle,
                    uint32_t* __restrict__ out_desc, uint8_t* __restrict__ out_strip) {
  __shared__ float raw[kRawArea];
  __shared__ float blur[kDescArea];
  __shared__ float taps[49];
  __shared__ float scratch[kThreads / 32];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int H = kp_H[k], W = kp_W[k], px = kp_x[k], py = kp_y[k];
  const float* img = pyr + kp_base[k];
  if (tid < 49) taps[tid] = taps49[tid];
  for (int i = tid; i < kRawArea; i += kThreads) {
    const int r = i / kRawW, c = i - r * kRawW;
    const int yy = min(max(py + r - kRawR, 0), H - 1);
    const int xx = min(max(px + c - kRawR, 0), W - 1);
    raw[i] = __bfloat162float(__float2bfloat16_rn(img[yy * W + xx]));
  }
  __syncthreads();

  // IC-angle moments over the radius-15 circle (orb_pattern masks)
  float a10 = 0.f, a01 = 0.f;
  for (int i = tid; i < kMomW * kMomW; i += kThreads) {
    const int v = i / kMomW, u = i - v * kMomW;
    const float val = raw[(v + kMomOff) * kRawW + (u + kMomOff)];
    a10 = __fadd_rn(a10, __fmul_rn(m10[i], val));
    a01 = __fadd_rn(a01, __fmul_rn(m01[i], val));
  }
  const float s10 = block_sum(a10, scratch);
  const float s01 = block_sum(a01, scratch);
  const float angle = kp_valid[k] ? atan2f(s01, s10) : 0.f;

  // 7x7 sigma=2 blur of the central 39x39, rounded to integer gray levels
  for (int o = tid; o < kDescArea; o += kThreads) {
    const int ry = o / kDescW, rx = o - ry * kDescW;
    float acc = 0.f;
#pragma unroll
    for (int ty = 0; ty < 7; ++ty)
#pragma unroll
      for (int tx = 0; tx < 7; ++tx)
        acc = __fadd_rn(acc, __fmul_rn(taps[ty * 7 + tx], raw[(ry + ty) * kRawW + rx + tx]));
    blur[o] = rintf(acc);
  }
  __syncthreads();
  if (out_strip != nullptr)
    for (int i = tid; i < kStripH * kStripW; i += kThreads) {
      const int r = i / kStripW, c = i - r * kStripW;
      out_strip[k * kStripH * kStripW + i] =
          (uint8_t)(int)blur[(kStripY + r) * kDescW + kStripX + c];
    }

  int bin = (int)rintf(__fdiv_rn(angle, tau)) % kBins;
  if (bin < 0) bin += kBins;
  const int8_t* off = offsets + (bin * 256 + tid) * 4;  // rx0, ry0, rx1, ry1
  const float i0 = blur[off[1] * kDescW + off[0]];
  const float i1 = blur[off[3] * kDescW + off[2]];
  const uint32_t word = __ballot_sync(0xffffffffu, i1 > i0);
  if ((tid & 31) == 0) out_desc[k * 8 + (tid >> 5)] = word;
  if (tid == 0) out_angle[k] = angle;
}

}  // namespace

extern "C" int svt_orb_describe(const float* pyr, const int* kp_base, const int* kp_H,
                                const int* kp_W, const int* kp_x, const int* kp_y,
                                const uint8_t* kp_valid, int K, const float* taps49,
                                const float* m10, const float* m01,
                                const int8_t* offsets, float tau, float* out_angle,
                                uint32_t* out_desc, uint8_t* out_strip, void* stream) {
  if (K > 0)
    orb_describe_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
        pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid, taps49, m10, m01, offsets,
        tau, out_angle, out_desc, out_strip);
  return (int)cudaGetLastError();
}
