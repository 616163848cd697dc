// Kernel A: FAST-9/16 corner score fused with the two-threshold cell NMS.
//
// Replaces stella_vslam_tpu/feature/orb_extractor.py: fast_score_map (:88)
// and the NMS half of OrbExtractor._process_level (:325-373). The TPU form
// builds the full [H,W] score map from 16 shifted images and reduces a
// packed key (iscore<<12 | row<<6 | col) per cell with two reshaped maxes.
//
// On Hopper: one thread block per NMS cell. Each thread scores a strided
// share of the cell's pixels straight from the level image (the 3-px FAST
// ring of a pixel inside the border region always lies inside the image, so
// no padding is read), packs its hi/lo keys and folds them into two
// shared-memory maxima. The score map is never written to device memory.
// Bound: about 40 bytes read per pixel from L1/L2 (16 ring pixels plus the
// centre, reused across neighbouring threads) and ~60 integer/float ops; a
// 752x480 level is ~0.35 M pixels, so a level is launch-latency bound at the
// slice's sizes, not bandwidth bound. The images of a batch (a stereo
// pair's level) go in one launch, one grid z index each.
//
// Bit-exactness: scores are differences and min/max of the same float32
// pixels as the JAX version, thresholds compare the float score, and
// iscore = clamp(rint(score), 0, 1023) (rintf rounds half to even, like
// jnp.round).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ float fast_score(const float* img, int W, int y, int x) {
  const float c = img[y * W + x];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = img[(y + kRingDy[k]) * W + (x + kRingDx[k])] - c;
  float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float mn = d[k], mx = d[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(k + j) & 15];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    bright = fmaxf(bright, mn);   // all 9 brighter than centre + t
    dark = fmaxf(dark, -mx);      // all 9 darker than centre - t
  }
  return fmaxf(bright, dark);
}

__global__ void fast_nms_kernel(const float* __restrict__ img, long long img_stride,
                                int H, int W, int border, int cs, int Gy, int Gx,
                                float ini_thr, float min_thr, int* __restrict__ out_key) {
  __shared__ int best_hi, best_lo;
  if (threadIdx.x == 0) {
    best_hi = -1;
    best_lo = -1;
  }
  __syncthreads();
  const int cx = blockIdx.x, cy = blockIdx.y;
  img += blockIdx.z * img_stride;
  out_key += blockIdx.z * Gy * Gx;
  const int y0 = border + cy * cs, x0 = border + cx * cs;
  int hi = -1, lo = -1;
  for (int p = threadIdx.x; p < cs * cs; p += blockDim.x) {
    const int ry = p / cs, rx = p - ry * cs;
    const int y = y0 + ry, x = x0 + rx;
    if (y >= H - border || x >= W - border) continue;  // outside the region
    const float s = fast_score(img, W, y, x);
    if (!(s > min_thr)) continue;
    const int iscore = (int)fminf(fmaxf(rintf(s), 0.f), 1023.f);
    const int key = (iscore << 12) | (ry << 6) | rx;
    lo = max(lo, key);
    if (s > ini_thr) hi = max(hi, key);
  }
  if (lo >= 0) atomicMax(&best_lo, lo);
  if (hi >= 0) atomicMax(&best_hi, hi);
  __syncthreads();
  if (threadIdx.x == 0)
    out_key[cy * Gx + cx] = best_hi >= 0 ? best_hi : best_lo;
}

}  // namespace

// img: B level images, img_stride floats apart; out_key: [B, Gy*Gx]
extern "C" int svt_fast_nms(int B, const float* img, long long img_stride, int H, int W,
                            int border, int cs, int Gy, int Gx, float ini_thr,
                            float min_thr, int* out_key, void* stream) {
  dim3 grid(Gx, Gy, B);
  fast_nms_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      img, img_stride, H, W, border, cs, Gy, Gx, ini_thr, min_thr, out_key);
  return (int)cudaGetLastError();
}
