// Kernel L: landmark fusion candidates, B keyframes x M landmarks per launch.
//
// Replaces stella_vslam_tpu/module/mapping_kernels.py _fuse_multi_impl
// (:228-258) with its prologue _reproject_for_fuse_impl (:308-335, the
// elementwise camera/base.py reproject_to_image :232 fused in) and
// match/fuse.py detect_duplication (:26-73) up to its duplicate resolution.
// The TPU form reprojects the [M] landmarks per keyframe, then builds
// [M,N] window, level, chi-square and Hamming matrices and reduces them.
//
// Templated on the camera model: the prologue projects with the model's
// own projection (camera.cuh for the equirectangular one, whose depth in
// the gates and the predicted x_right is the norm).
//
// On Hopper, two launches a chunk. First kernel C's cell index
// (hamming_top2.cu cell_index_kernel, one block per keyframe, shared-memory
// atomics) sorts each keyframe's keypoints into the cells of the grid over
// the camera's image extent (kernel C's grid), reading the interleaved [B,
// N, 2] uv in place; a keypoint outside the image goes to a border cell, a
// NaN one to the bucket after the last cell; a cell's keypoints are in no
// fixed order. Then this kernel: kLanes lanes per (keyframe
// b = blockIdx.y, landmark m); a padding keyframe (kf_valid 0) or
// landmark (lm_valid 0) is gated out before the prologue. Every lane computes the landmark's prologue in registers
// (projection, the distance range [dmin * f32(1/1.3), dmax*1.3], viewing
// cosine > 0.5, predicted octave clip(ceil(log(ratio) * f32(1 /
// log(scale_factor))), 0, L-1), predicted x_right); a gated landmark's lanes then visit only the
// keypoints in the cells its window [u +- r] x [v +- r], r = margin *
// scale_factor[pred], meets (widened by kernel C's rounding margin,
// cells.cuh; in a cell row the cells between its ends are one run of the
// sorted keypoints), and no NaN keypoint. A visited keypoint passes when it
// lies in the window |du|,|dv| <= r, its octave is in [pred-1, pred+1], the
// stereo-aware chi-square on its octave's sigma^2 holds (5.99146 /
// 7.81473) and it is valid; the lanes keep the least packed key
// (Hamming distance << 16 | keypoint), seeded with the key the full scan
// gives keypoint 0 when it is no candidate (257 << 16). A keypoint the walk
// skips fails the window test, and the minimum does not depend on the
// order of the visit, so the output is the full scan's bit for bit
// (module/mapping_kernels.fuse_cells_plain). Float expressions follow the
// JAX version's jitted order: separate roundings, the camera-frame point,
// the camera centre, the norm and the cosine's sum as FMA chains (XLA's
// matmul and reductions on the CPU), and the divisions by a constant as
// products with the reciprocal, which the wrapper passes; the plain
// prologue rounds each the same way, so the two equal on the card.
// Bound: the prologue per (keyframe, landmark) (~90 operations, ~140 with
// the equirectangular trigonometry), the keypoints the windows' cells hold
// (~15 gate operations each, 8 XOR and popcounts a candidate), and the
// keypoint fields and landmark rows read once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"
#include "cells.cuh"

namespace {

// lanes of one (keyframe, landmark); on a recorded 16 x 2048 chunk 16 lanes
// took 7.7 us, 8 took 10.0 and 4 took 13.7 on an H100 (PERF.md)
constexpr int kLanes = 16;
constexpr int kThreads = 128;
constexpr int kRows = kThreads / kLanes;  // landmarks a block
constexpr int kMaxLevels = 32;
constexpr float kChi2D = 5.99146f;
constexpr float kChi3D = 7.81473f;
constexpr uint32_t kMasked = 257u << 16;

struct FuseCam {
  float fx, fy, cx, cy, width, height, fxb;
};

struct CellGrid {
  const int* start;  // [B, gx * gy + 2]
  const int* order;  // [B, N]
  float inv;
  int gx, gy;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// a0 b0 + a1 b1 + a2 b2 as one FMA chain in k order: the JAX version's
// jitted matmul, norm and sum on the CPU (camera.base.dot3_f32)
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

template <int MODEL>
__global__ void __launch_bounds__(kThreads)
fuse_kernel(int N, int M, const float* __restrict__ kp_uv, const int* __restrict__ kp_level,
            const uint32_t* __restrict__ kp_desc, const uint8_t* __restrict__ kp_valid,
            const float* __restrict__ kp_xr, const float* __restrict__ poses,
            const uint8_t* __restrict__ kf_valid, const float* __restrict__ lm_f,
            const uint32_t* __restrict__ lm_desc, const uint8_t* __restrict__ lm_valid, FuseCam cam,
            const float* __restrict__ scale_factors, const float* __restrict__ sigma_sq,
            int num_levels, float inv_log_scale, float dmin_scale, float margin, CellGrid cells,
            int* __restrict__ out,
            uint8_t* __restrict__ gate_out) {
  __shared__ float s_sf[kMaxLevels], s_sig[kMaxLevels];
  for (int i = threadIdx.x; i < num_levels; i += blockDim.x) {
    s_sf[i] = scale_factors[i];
    s_sig[i] = sigma_sq[i];
  }
  __syncthreads();
  const int m = blockIdx.x * kRows + threadIdx.x / kLanes;
  const int b = blockIdx.y;
  const int sub_lane = threadIdx.x % kLanes;
  // a landmark's lanes leave together; the shuffles below name only them
  const unsigned group = ((1u << kLanes) - 1u) << ((threadIdx.x & 31) & ~(kLanes - 1));
  if (m >= M) return;
  if (kf_valid[b] == 0 || lm_valid[m] == 0) {  // a padding row: gated out
    if (sub_lane == 0) {
      int* o = out + ((size_t)b * M + m) * 2;
      o[0] = 257;
      o[1] = 0;
      gate_out[(size_t)b * M + m] = 0;
    }
    return;
  }
  // ---- prologue: _reproject_for_fuse_impl ----
  const float* R = poses + 12 * b;
  const float* t = R + 9;
  const float* f = lm_f + 8 * m;  // pos(3) dmin dmax normal(3)
  const float p[3] = {f[0], f[1], f[2]};
  const float dmin = f[3], dmax = f[4];
  float pc[3], ray[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    pc[r] = add(dot3(p[0], p[1], p[2], R[3 * r], R[3 * r + 1], R[3 * r + 2]), t[r]);
#pragma unroll
  for (int k = 0; k < 3; ++k) ray[k] = sub(p[k], -dot3(R[k], R[3 + k], R[6 + k], t[0], t[1], t[2]));
  float u, v, z;  // z: the depth (the norm for the equirectangular model)
  bool in_img;
  if constexpr (MODEL == svt_cam::kEquirect) {
    in_img = svt_cam::equirect_project(pc[0], pc[1], pc[2], cam.cx, cam.cy, cam.width,
                                       cam.height, u, v, z);
  } else {
    z = pc[2];
    const float zs = fabsf(z) < 1e-8f ? 1e-8f : z;
    u = add(__fdiv_rn(mul(cam.fx, pc[0]), zs), cam.cx);
    v = add(__fdiv_rn(mul(cam.fy, pc[1]), zs), cam.cy);
    in_img = z > 0.f && u >= 0.f && u < cam.width && v >= 0.f && v < cam.height;
  }
  const float dist = __fsqrt_rn(dot3(ray[0], ray[1], ray[2], ray[0], ray[1], ray[2]));
  // dmin / 1.3 and log(ratio) / log(scale factor): the JAX version's jitted
  // divisions by a constant, which XLA takes as products with the float32
  // reciprocals dmin_scale and inv_log_scale
  const bool dist_ok = dist >= mul(dmin, dmin_scale) && dist <= mul(dmax, 1.3f);
  const float cosang =
      __fdiv_rn(dot3(ray[0], ray[1], ray[2], f[5], f[6], f[7]), fmaxf(dist, 1e-9f));
  const float ratio = __fdiv_rn(fmaxf(dmax, 1e-9f), fmaxf(dist, 1e-9f));
  const float lvl_f = ceilf(mul(logf(fmaxf(ratio, 1e-9f)), inv_log_scale));
  const int pred = (int)fminf(fmaxf(lvl_f, 0.f), (float)(num_levels - 1));
  // fxb / z a true division, as the JAX version's (its divisor varies)
  const float lm_xr = z > 1e-6f ? sub(u, __fdiv_rn(cam.fxb, fmaxf(z, 1e-6f))) : -1.f;
  const bool gate = in_img && dist_ok && cosang > 0.5f && z > 0.f;
  // ---- the cell walk: detect_duplication over the window's cells ----
  uint32_t best = N > 0 ? kMasked : 0xffffffffu;
  if (gate) {
    const float radius = mul(margin, s_sf[pred]);
    uint32_t qd[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) qd[w] = lm_desc[m * 8 + w];
    const size_t kb = (size_t)b * N;
    const int* start = cells.start + (size_t)b * (cells.gx * cells.gy + 2);
    const int* order = cells.order + kb;
    int x0, x1, y0, y1;
    svt_cells::cell_span(u, radius, cells.inv, cells.gx, x0, x1);
    svt_cells::cell_span(v, radius, cells.inv, cells.gy, y0, y1);
    for (int cy = y0; cy <= y1; ++cy) {
      const int e = start[cy * cells.gx + x1 + 1];
      for (int k = start[cy * cells.gx + x0] + sub_lane; k < e; k += kLanes) {
        const int j = order[k];
        const float du = sub(kp_uv[2 * (kb + j)], u);
        const float dv = sub(kp_uv[2 * (kb + j) + 1], v);
        bool cand = fabsf(du) <= radius && fabsf(dv) <= radius;
        const int lvl = kp_level[kb + j];
        cand = cand && lvl >= pred - 1 && lvl <= pred + 1 && kp_valid[kb + j] != 0;
        if (cand) {
          const float kxr = kp_xr[kb + j];
          const float err2 = add(mul(du, du), mul(dv, dv));
          const float sig = s_sig[lvl];
          if (kxr > 0.f && lm_xr > 0.f) {
            const float dr = sub(lm_xr, kxr);
            cand = __fdiv_rn(add(err2, mul(dr, dr)), sig) <= kChi3D;
          } else {
            cand = __fdiv_rn(err2, sig) <= kChi2D;
          }
        }
        if (cand) {
          uint32_t d = 0;
#pragma unroll
          for (int w = 0; w < 8; ++w) d += __popc(qd[w] ^ kp_desc[(kb + j) * 8 + w]);
          best = min(best, (d << 16) | (uint32_t)j);
        }
      }
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    best = min(best, __shfl_xor_sync(group, best, o, kLanes));
  if (sub_lane == 0) {
    int* o = out + ((size_t)b * M + m) * 2;
    // a gated-out landmark sees every keypoint masked: distance 257 at index 0
    o[0] = gate ? (int)(best >> 16) : 257;
    o[1] = gate ? (int)(best & 0xffffu) : 0;
    gate_out[(size_t)b * M + m] = gate ? 1 : 0;
  }
}

}  // namespace

// model: 0 perspective, 2 equirectangular (camera.cuh); inv_log_scale and
// dmin_scale the float32 reciprocals of log(scale factor) and 1.3; cell_start [B, gx *
// gy + 2] and cell_order [B, N]: the keypoints' cell indexes
// (svt_cell_index over the image extent with inv_cell, gx, gy); out
// [B, M, 2] (distance, keypoint), gate_out [B, M] (0 or 1)
extern "C" int svt_fuse(int model, int B, int N, int M, const float* kp_uv,
                        const int* kp_level, const uint32_t* kp_desc, const uint8_t* kp_valid,
                        const float* kp_xr, const float* poses, const uint8_t* kf_valid,
                        const float* lm_f, const uint32_t* lm_desc, const uint8_t* lm_valid,
                        float fx, float fy, float cx, float cy, float width, float height,
                        float fxb, const float* scale_factors, const float* sigma_sq,
                        int num_levels, float inv_log_scale, float dmin_scale, float margin,
                        const int* cell_start, const int* cell_order, float inv_cell, int gx,
                        int gy, int* out, uint8_t* gate_out, void* stream) {
  if (num_levels > kMaxLevels || gx < 1 || gy < 1) return (int)cudaErrorInvalidValue;
  if (model != svt_cam::kPerspective && model != svt_cam::kEquirect)
    return (int)cudaErrorInvalidValue;
  auto kernel = model == svt_cam::kEquirect ? fuse_kernel<svt_cam::kEquirect>
                                            : fuse_kernel<svt_cam::kPerspective>;
  if (M > 0 && B > 0) {
    const dim3 grid((M + kRows - 1) / kRows, B);
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        N, M, kp_uv, kp_level, kp_desc, kp_valid, kp_xr, poses, kf_valid, lm_f, lm_desc,
        lm_valid, FuseCam{fx, fy, cx, cy, width, height, fxb}, scale_factors, sigma_sq,
        num_levels, inv_log_scale, dmin_scale, margin,
        CellGrid{cell_start, cell_order, inv_cell, gx, gy}, out, gate_out);
  }
  return (int)cudaGetLastError();
}
