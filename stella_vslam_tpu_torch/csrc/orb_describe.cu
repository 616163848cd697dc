// Kernel B: IC-angle orientation, in-patch blur and steered BRIEF.
//
// Replaces stella_vslam_tpu/feature/orb_extractor.py: _extract_patches
// (:392), the IC-angle and blur lines of _process_level (:378-383) and
// _describe_all (:418). The TPU form gathers 45x45 patches with one-hot
// bf16 matmuls, blurs with a [2025 -> 1521] matmul and evaluates all 30
// steering bins x 256 pairs as one [7680, 1521] matmul before selecting a
// bin — matmuls because per-element gathers serialize on the TPU.
//
// On Hopper: one warp per keypoint, four keypoints a block. The warp loads
// its clamped 45x45 raw patch into shared memory (rounded to bf16, as the
// JAX version's patches are; lane c loads columns c and c + 32, kLoadBatch
// rows in flight), reduces the two moment sums, takes atan2f, and blurs
// only the pixels that the selected bin's 256 pairs read (the bin's
// distinct pixels, at most 512, from the host-built tables of
// DescribeTables) with the 49 two-dimensional f32 taps in registers (a
// fixed ty-major order; products and sums rounded separately, no FMA),
// rounded with rintf; lane p then compares pair p + 32 w and a ballot packs
// word w. The moment sums keep the parent kernel's order: per lane its
// four strided elements for each of the eight 32-thread groups of the old
// 256-thread block, a shuffle tree per group, the groups' sums in order, so
// the angles keep their bits. Bound: ~30 K flops a keypoint for the blur of
// its bin's 294-323 pixels and ~4 K for the moments, 8 KB of gathers:
// shared-memory loads (49 a blurred pixel) and the patch's load latency;
// the design blurs a fifth of the 1521 pixels that its parent blurred,
// reads the taps from registers, and keeps the patch's loads in flight.
// (Taps in the constant bank, the blurred values held in registers, and
// the patch loaded in linear order were each slower on an H100.)
//
// For the stereo matcher (K19's subpixel step, stella_vslam_tpu/match/
// stereo.py:67-98, which reads the blurred patches that
// extract_with_patches returns) the kernel optionally blurs and writes the
// 11x21 strip around the blurred patch's centre (rows 14..24, columns 9..29
// of the 39x39) as bytes: the blurred values are integer gray levels
// 0..255, exact in a byte as in the JAX version's bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRawR = 22;
constexpr int kRawW = 45;
constexpr int kRawArea = kRawW * kRawW;
constexpr int kDescW = 39;
constexpr int kMomW = 31;
constexpr int kMomArea = kMomW * kMomW;
constexpr int kMomOff = kRawR - 15;  // moment circle centred in the raw patch
constexpr int kBins = 30;
constexpr int kMaxBinPixels = 512;  // orb_extractor.MAX_BIN_PIXELS
constexpr int kWarps = 4;           // keypoints a block
constexpr int kLoadBatch = 16;      // patch rows in flight per lane
constexpr int kOldThreads = 256;    // the parent's block, whose moment order is kept
constexpr int kStripH = 11, kStripW = 21;
constexpr int kStripY = kDescW / 2 - kStripH / 2;  // 14
constexpr int kStripX = kDescW / 2 - kStripW / 2;  // 9
constexpr unsigned kFull = 0xffffffffu;

// the sum over the warp of one value, rounded at each add, into lane 0
__device__ __forceinline__ float warp_tree(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
  return v;
}

// the 49 blur taps, passed by value as a kernel parameter
struct Taps {
  float v[49];
};

// the blurred value at linear position pos of the 39x39 (49 taps, ty-major)
__device__ __forceinline__ float blur_at(const float* raw, const float (&tap)[49], int pos) {
  const int ry = pos / kDescW, rx = pos - ry * kDescW;
  const float* r = raw + ry * kRawW + rx;
  float acc = 0.f;
#pragma unroll
  for (int ty = 0; ty < 7; ++ty)
#pragma unroll
    for (int tx = 0; tx < 7; ++tx)
      acc = __fadd_rn(acc, __fmul_rn(tap[ty * 7 + tx], r[ty * kRawW + tx]));
  return rintf(acc);
}

__global__ void __launch_bounds__(kWarps * 32)
orb_describe_kernel(const float* __restrict__ pyr, const int* __restrict__ kp_base,
                    const int* __restrict__ kp_H, const int* __restrict__ kp_W,
                    const int* __restrict__ kp_x, const int* __restrict__ kp_y,
                    const uint8_t* __restrict__ kp_valid, int K, const Taps tap,
                    const float* __restrict__ m10, const float* __restrict__ m01,
                    const int16_t* __restrict__ pix,
                    const int* __restrict__ npix, const int16_t* __restrict__ pidx, float tau,
                    float* __restrict__ out_angle, uint32_t* __restrict__ out_desc,
                    uint8_t* __restrict__ out_strip) {
  __shared__ float raw_s[kWarps][kRawArea];
  __shared__ float blur_s[kWarps][kMaxBinPixels];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + w;
  if (k >= K) return;
  float* raw = raw_s[w];
  float* blur = blur_s[w];
  const int H = kp_H[k], W = kp_W[k], px = kp_x[k], py = kp_y[k];
  const float* img = pyr + kp_base[k];
  // the patch column by column: lane c loads columns c and c + 32, the
  // rows in order, kLoadBatch rows in flight
  const int xa = min(max(px + lane - kRawR, 0), W - 1);
  const int xb = min(max(px + lane + 32 - kRawR, 0), W - 1);
  const bool has_b = lane + 32 < kRawW;
  for (int r0 = 0; r0 < kRawW; r0 += kLoadBatch) {
    float va[kLoadBatch], vb[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int r = r0 + u;
      const float* row = img + min(max(py + r - kRawR, 0), H - 1) * W;
      va[u] = r < kRawW ? row[xa] : 0.f;
      vb[u] = r < kRawW && has_b ? row[xb] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int r = r0 + u;
      if (r < kRawW) {
        raw[r * kRawW + lane] = __bfloat162float(__float2bfloat16_rn(va[u]));
        if (has_b) raw[r * kRawW + lane + 32] = __bfloat162float(__float2bfloat16_rn(vb[u]));
      }
    }
  }
  float tr[49];
#pragma unroll
  for (int i = 0; i < 49; ++i) tr[i] = tap.v[i];
  __syncwarp();

  // IC-angle moments over the radius-15 circle (orb_pattern masks), in the
  // parent's order: old thread g * 32 + lane summed i = itself + 256 j
  // (unrolled: the groups' loads and trees are independent until the end)
  constexpr int kGroups = kOldThreads / 32;
  constexpr int kPer = (kMomArea + kOldThreads - 1) / kOldThreads;  // 4
  float a10[kGroups], a01[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    a10[g] = 0.f;
    a01[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = g * 32 + lane + j * kOldThreads;
      if (i < kMomArea) {
        const int v = i / kMomW, u = i - v * kMomW;
        const float val = raw[(v + kMomOff) * kRawW + (u + kMomOff)];
        a10[g] = __fadd_rn(a10[g], __fmul_rn(m10[i], val));
        a01[g] = __fadd_rn(a01[g], __fmul_rn(m01[i], val));
      }
    }
  }
  float s10 = 0.f, s01 = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    s10 = __fadd_rn(s10, warp_tree(a10[g]));  // lane 0's sums are the ones kept
    s01 = __fadd_rn(s01, warp_tree(a01[g]));
  }
  s10 = __shfl_sync(kFull, s10, 0);
  s01 = __shfl_sync(kFull, s01, 0);
  const float angle = kp_valid[k] ? atan2f(s01, s10) : 0.f;

  int bin = (int)rintf(__fdiv_rn(angle, tau)) % kBins;
  if (bin < 0) bin += kBins;
  // only the pixels the bin's pairs read
  const int n = npix[bin];
  const int16_t* bp = pix + bin * kMaxBinPixels;
#pragma unroll 2
  for (int i = lane; i < n; i += 32) blur[i] = blur_at(raw, tr, bp[i]);
  if (out_strip != nullptr)
#pragma unroll 2
    for (int i = lane; i < kStripH * kStripW; i += 32) {
      const int r = i / kStripW, c = i - r * kStripW;
      out_strip[(size_t)k * kStripH * kStripW + i] =
          (uint8_t)(int)blur_at(raw, tr, (kStripY + r) * kDescW + kStripX + c);
    }
  __syncwarp();
  const int16_t* pp = pidx + bin * 512;  // [256][2] positions in the bin's pixel list
#pragma unroll
  for (int wd = 0; wd < 8; ++wd) {
    const int p = wd * 32 + lane;
    const uint32_t word = __ballot_sync(kFull, blur[pp[2 * p + 1]] > blur[pp[2 * p]]);
    if (lane == 0) out_desc[(size_t)k * 8 + wd] = word;
  }
  if (lane == 0) out_angle[k] = angle;
}

}  // namespace

// taps49: the 49 blur taps in host memory (they travel as a kernel
// parameter)
extern "C" int svt_orb_describe(const float* pyr, const int* kp_base, const int* kp_H,
                                const int* kp_W, const int* kp_x, const int* kp_y,
                                const uint8_t* kp_valid, int K, const float* taps49,
                                const float* m10, const float* m01, const int16_t* pix,
                                const int* npix, const int16_t* pidx, float tau,
                                float* out_angle, uint32_t* out_desc, uint8_t* out_strip,
                                void* stream) {
  Taps tap;
  for (int i = 0; i < 49; ++i) tap.v[i] = taps49[i];
  if (K > 0)
    orb_describe_kernel<<<(K + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
        pyr, kp_base, kp_H, kp_W, kp_x, kp_y, kp_valid, K, tap, m10, m01, pix, npix, pidx,
        tau, out_angle, out_desc, out_strip);
  return (int)cudaGetLastError();
}
