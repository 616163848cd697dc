// Kernel R: the camera's per-point projections, two entry points.
//
// Replaces stella_vslam_tpu/camera/base.py reproject_to_image (:232) with
// what the tracking cascade builds around it: the x_right of the
// projections, the local-map gate and predicted scale of
// stella_vslam_tpu/module/tracking_kernels.py track_frame (:266-285), and
// the window radius and level bounds of stella_vslam_tpu/match/
// projection.py (:53 and :127, margin * scale_factors[level], level -+ 1);
// and the keypoint undistortion of camera/base.py undistort_keypoints
// (:190-200): _perspective_undistort_norm (:89, 10 fixed-point
// iterations), fisheye_undistort (:134, Kannala-Brandt, 10 Newton steps on
// theta) and radial_division_undistort (:160), with the normalization
// around them. The TPU forms are lane-major elementwise programs; on the
// card each was ~15 eager torch ops per call, every one a launch and a
// round trip through device memory.
//
//  window_rows_kernel (one thread per row, 32 threads a block so that
//    4096 rows spread over 128 SMs): the camera-frame point under R and t
//    (read as they are, 12 floats every thread shares), pixel, depth,
//    in-image flag and x_right, and the window row kernel C's window call
//    reads (match/hamming.py WindowGate): u, v, x_right, radius margin *
//    scale_factors[level] (one f32 product), level bounds and the row's
//    valid flag. Mode 0 (the last frame's chained landmarks, [M,3]
//    points): the level is the last frame's keypoint's, the bounds level -+
//    1 unclamped, the flag its association flag and the in-image test.
//    Mode 1 (the landmark table, rows of the packed [C,8] f32 / [C,10] u32
//    table; the f32 row read as two 16-byte vectors): the distance to the
//    camera centre, the gate distance in [0.8 min, 1.3 max], cos(ray,
//    normal) > 0.5, depth > 0, the table's valid flag make the flag; the
//    predicted level clip(ceil(log(max / dist) * inv_log_scale), 0, L-1)
//    is written too and sets the radius and the bounds, clamped to [0,
//    L-1]. inv_log_scale is the float32 reciprocal of log(scale factor):
//    the JAX version's jitted division by that constant is this product.
//  frame_finish_kernel (one thread per keypoint slot, 128 a block),
//    templated on the model: normalize; radial-tangential: 10 iterations
//    of x = xd - (distort(x) - x); Kannala-Brandt: 10 Newton steps on
//    theta, then tan(theta) / theta_d; division: 1 / (1 + k1 r^2);
//    equirectangular: the identity; back to pixels and the unit bearings
//    of the normalised coordinates (longitude / latitude for the
//    equirectangular model). The frame's finish also writes what JAX's
//    jitted _mono_preprocess and _rgbd_preprocess (stella_vslam_tpu/
//    system.py:178-189, :486-505) build in the same program: x_right and
//    the depths (-1 for mono, kernel T's for stereo, the depth map sampled
//    at the keypoint for RGBD) and the packed [N,21] host-mirror row of
//    data/frame.py pack_host_cols, staged in shared memory and written as
//    16-byte stores. One launch a frame, where the parent launched the
//    undistortion and ~4 (mono) to ~20 (RGBD) torch kernels around it.
// Bound: ~40-70 bytes and ~100 operations per row (the slice's 2872 slots
// or 4096 table rows; the finish ~170 bytes a slot): ~0.1 us of bytes, so
// each is bound by its launch.
// Floats follow the torch expressions' order. In the window rows the
// camera-frame point (an FMA chain in k order, then + t, as a CPU matmul
// and the plain version round it: near the camera an ulp of x is
// hundredths of a pixel of u), the pinhole projection and x_right round
// every operation as the plain version does, so u, v and x_right of the
// perspective model equal it; the gate's
// camera centre, distance and cosine are FMA chains in k order (the JAX
// version's jitted matmul, norm and sum on the CPU; camera.base.dot3_f32
// in the plain version), the ratio a true division and the log CUDA's
// logf, as torch's log on the card, so the flag and the predicted level
// equal the plain version's on the card;
// the equirectangular projection (camera.cuh) agrees to a few ulps. The
// undistortion rounds as its plain version, which rounds as the JAX
// version's jitted code (XLA's reciprocal product, its FMA contractions),
// and equals it bit for bit: an ulp in the monocular initializer's input
// moves, through the near-degenerate two-view geometry of a planar scene,
// which hypothesis wins. The fisheye and division modes follow the same
// rule (tanf is the function torch calls on the card).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"

namespace {

constexpr int kRowThreads = 32;
constexpr int kFinishThreads = 128;
constexpr int kPackCols = 21;  // data/frame.py pack_host_cols

struct Intr {
  float fx, fy, cx, cy, width, height, fxb;
};

// distortion coefficients: radial-tangential k1 k2 p1 p2 k3, Kannala-Brandt
// k1..k4, division k1
struct Dist {
  float k1, k2, p1, p2, k3, k4;
};

// the window rows, structure of arrays (one allocation, carved by the wrapper)
struct Rows {
  float *u, *v, *xr, *rad;
  int *lo, *hi, *pred;
  uint8_t* valid;
};

template <int MODEL, int MODE>
__global__ void __launch_bounds__(kRowThreads)
window_rows_kernel(int M, Intr k, const float* __restrict__ Rg, const float* __restrict__ tg,
                   const float* __restrict__ pos, const int* __restrict__ tbl_u32,
                   const int* __restrict__ last_level, const uint8_t* __restrict__ last_valid,
                   const float* __restrict__ scale_factors, float margin, float inv_log_scale,
                   int num_levels, Rows out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float R[9], t[3];
#pragma unroll
  for (int q = 0; q < 9; ++q) R[q] = __ldg(Rg + q);
#pragma unroll
  for (int q = 0; q < 3; ++q) t[q] = __ldg(tg + q);
  float p0, p1, p2;
  float4 row_a, row_b;  // mode 1: position, normal, min and max distance
  if constexpr (MODE == 1) {
    const float4* row = reinterpret_cast<const float4*>(pos) + 2 * m;
    row_a = __ldg(row);
    row_b = __ldg(row + 1);
    p0 = row_a.x;
    p1 = row_a.y;
    p2 = row_a.z;
  } else {
    p0 = pos[3 * m];
    p1 = pos[3 * m + 1];
    p2 = pos[3 * m + 2];
  }
  // R p + t as the plain version (and a CPU matmul) rounds it: an FMA chain
  // over k = 0, 1, 2, then + t; another order moves x by an ulp, and u by
  // fx / z times that
  const auto row = [&](int r) {
    const float acc = __fmaf_rn(p2, R[3 * r + 2],
                                __fmaf_rn(p1, R[3 * r + 1], __fmul_rn(p0, R[3 * r])));
    return __fadd_rn(acc, t[r]);
  };
  const float x = row(0), y = row(1), z = row(2);
  float u, v, depth;
  bool in_img;
  if constexpr (MODEL == svt_cam::kEquirect) {
    in_img = svt_cam::equirect_project(x, y, z, k.cx, k.cy, k.width, k.height, u, v, depth);
  } else {
    const float zs = fabsf(z) < 1e-8f ? 1e-8f : z;
    u = __fadd_rn(__fdiv_rn(__fmul_rn(k.fx, x), zs), k.cx);
    v = __fadd_rn(__fdiv_rn(__fmul_rn(k.fy, y), zs), k.cy);
    depth = z;
    in_img = z > 0.f && u >= 0.f && u < k.width && v >= 0.f && v < k.height;
  }
  out.u[m] = u;
  out.v[m] = v;
  // fxb / depth a true division, as the JAX version's (its divisor varies)
  out.xr[m] = depth > 1e-6f ? __fsub_rn(u, __fdiv_rn(k.fxb, fmaxf(depth, 1e-6f)))
                            : -1.f;
  if constexpr (MODE == 0) {
    const int lvl = last_level[m];
    out.rad[m] = __fmul_rn(margin, scale_factors[lvl]);
    out.lo[m] = lvl - 1;
    out.hi[m] = lvl + 1;
    out.valid[m] = (last_valid[m] != 0 && in_img) ? 1 : 0;
  } else {
    // the camera centre -R^T t, the distance and the viewing cosine as the
    // JAX version's jitted matmul, norm and sum round them on the CPU (and
    // the plain version's dot3_f32): one FMA chain over k = 0, 1, 2 each
    const auto dot3 = [](float a0, float a1, float a2, float b0, float b1, float b2) {
      return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
    };
    const float c0 = -dot3(R[0], R[3], R[6], t[0], t[1], t[2]);
    const float c1 = -dot3(R[1], R[4], R[7], t[0], t[1], t[2]);
    const float c2 = -dot3(R[2], R[5], R[8], t[0], t[1], t[2]);
    const float r0 = __fsub_rn(p0, c0), r1 = __fsub_rn(p1, c1), r2 = __fsub_rn(p2, c2);
    const float dist = __fsqrt_rn(dot3(r0, r1, r2, r0, r1, r2));
    const float dmin = row_b.z, dmax = row_b.w;
    const bool dist_ok = dist >= __fmul_rn(0.8f, dmin) && dist <= __fmul_rn(1.3f, dmax);
    const float cosang =
        __fdiv_rn(dot3(r0, r1, r2, row_a.w, row_b.x, row_b.y), fmaxf(dist, 1e-9f));
    const bool valid = tbl_u32[10 * m + 9] > 0;
    out.valid[m] = (valid && in_img && dist_ok && cosang > 0.5f && depth > 0.f) ? 1 : 0;
    const float ratio = __fdiv_rn(fmaxf(dmax, 1e-9f), fmaxf(dist, 1e-9f));
    // the JAX version's jitted ceil(log(ratio) / log_scale) divides by a
    // constant, which XLA takes as a product with its float32 reciprocal
    const float lv = ceilf(__fmul_rn(logf(fmaxf(ratio, 1e-9f)), inv_log_scale));
    const int pred = (int)fminf(fmaxf(lv, 0.f), (float)(num_levels - 1));
    out.pred[m] = pred;
    out.rad[m] = __fmul_rn(margin, scale_factors[pred]);
    out.lo[m] = max(pred - 1, 0);
    out.hi[m] = min(pred + 1, num_levels - 1);
  }
}

// kernel R's undistortion of one keypoint, templated on the distortion
// model, rounded as the plain versions round it (camera/base.py; the
// perspective and division models follow the JAX version's jitted
// preprocessing): the normalisation a product with the float32 reciprocal
// of fx, every contraction XLA makes an `__fmaf_rn` and every other product
// and sum rounded on its own, and x fx + cx one FMA. The unit bearing comes
// from the normalised coordinates (x times fx (1 / fx), the squared norm's
// FMA, the correctly rounded root). The equirectangular model's
// undistortion is the identity; its bearing is longitude / latitude on the
// unit sphere as torch's ops on the card round it (a division by the
// scalar width or height is a product with its float32 reciprocal there).
// The result equals the plain version on the card bit for bit.
template <int MODEL>
__device__ __forceinline__ void undistort_point(const Intr& k, const Dist& dc, float rcp_w,
                                                float rcp_h, float px, float py, float& ux,
                                                float& uy, float b[3]) {
  if constexpr (MODEL == svt_cam::kEquirect) {
    ux = px;
    uy = py;
    const float lon = __fmul_rn(__fmul_rn(__fsub_rn(px, k.cx), svt_cam::kTwoPi), rcp_w);
    const float lat = __fmul_rn(__fmul_rn(-__fsub_rn(py, k.cy), svt_cam::kPi), rcp_h);
    const float cl = cosf(lat);
    b[0] = __fmul_rn(cl, sinf(lon));
    b[1] = -sinf(lat);
    b[2] = __fmul_rn(cl, cosf(lon));
    return;
  }
  const float xd = __fmul_rn(__fsub_rn(px, k.cx), __frcp_rn(k.fx));
  const float yd = __fmul_rn(__fsub_rn(py, k.cy), __frcp_rn(k.fy));
  float x, y;
  if constexpr (MODEL == svt_cam::kPerspective) {
    // perspective_undistort: 10 fixed-point steps x = xd - (distort(x) - x)
    const float two_p1 = 2.f * dc.p1, two_p2 = 2.f * dc.p2;  // exact doublings
    x = xd;
    y = yd;
    for (int it = 0; it < 10; ++it) {
      const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
      const float radial =
          __fmaf_rn(r2, __fmaf_rn(r2, __fmaf_rn(r2, dc.k3, dc.k2), dc.k1), 1.f);
      const float dx = __fmaf_rn(__fmaf_rn(2.f * x, x, r2), dc.p2,
                                 __fmaf_rn(__fmul_rn(x, two_p1), y, __fmul_rn(x, radial)));
      const float dy = __fmaf_rn(__fmul_rn(x, two_p2), y,
                                 __fmaf_rn(__fmaf_rn(2.f * y, y, r2), dc.p1,
                                           __fmul_rn(y, radial)));
      x = __fsub_rn(xd, __fsub_rn(dx, x));
      y = __fsub_rn(yd, __fsub_rn(dy, y));
    }
  } else if constexpr (MODEL == svt_cam::kFisheye) {
    // fisheye_undistort, in the JAX version's eager rounding as its plain
    // version (torch on the card divides by the scalar fx through its
    // reciprocal, as above): theta_d = |(xd, yd)|, 10 Newton steps on the
    // Kannala-Brandt theta (a derivative under 1e-6 counts as 1), then the
    // scale tan(theta) / theta_d (1 at the centre). 3 k1, 5 k2 and 7 k3 are
    // one rounding each, as torch takes them (a double product of a float
    // and a small integer, rounded to float once).
    const float theta_d = __fsqrt_rn(__fadd_rn(__fmul_rn(xd, xd), __fmul_rn(yd, yd)));
    const float k1_3 = 3.f * dc.k1, k2_5 = 5.f * dc.k2, k3_7 = 7.f * dc.k3;
    float theta = theta_d;
    for (int it = 0; it < 10; ++it) {
      const float t2 = __fmul_rn(theta, theta);
      const float poly = __fadd_rn(
          1.f, __fmul_rn(t2, __fadd_rn(dc.k1, __fmul_rn(t2, __fadd_rn(dc.k2, __fmul_rn(
                   t2, __fadd_rn(dc.k3, __fmul_rn(t2, dc.k4))))))));
      const float f = __fsub_rn(__fmul_rn(theta, poly), theta_d);
      const float df = __fadd_rn(
          1.f, __fmul_rn(t2, __fadd_rn(k1_3, __fmul_rn(t2, __fadd_rn(k2_5, __fmul_rn(
                   t2, __fadd_rn(k3_7, __fmul_rn(__fmul_rn(t2, 9.f), dc.k4))))))));
      theta = __fsub_rn(theta, __fdiv_rn(f, fabsf(df) < 1e-6f ? 1.f : df));
    }
    const float scale = theta_d > 1e-8f ? __fdiv_rn(tanf(theta), fmaxf(theta_d, 1e-8f)) : 1.f;
    x = __fmul_rn(xd, scale);
    y = __fmul_rn(yd, scale);
  } else {
    // radial_division_undistort: one division by 1 + k1 r^2 (|.| < 1e-8
    // taken as 1e-8)
    const float r2 = __fmaf_rn(xd, xd, __fmul_rn(yd, yd));
    const float denom = __fmaf_rn(r2, dc.k1, 1.f);
    const float scale = __fdiv_rn(1.f, fabsf(denom) < 1e-8f ? 1e-8f : denom);
    x = __fmul_rn(xd, scale);
    y = __fmul_rn(yd, scale);
  }
  if constexpr (MODEL == svt_cam::kFisheye) {
    ux = __fadd_rn(__fmul_rn(x, k.fx), k.cx);
    uy = __fadd_rn(__fmul_rn(y, k.fy), k.cy);
  } else {
    ux = __fmaf_rn(x, k.fx, k.cx);
    uy = __fmaf_rn(y, k.fy, k.cy);
  }
  const float xb = __fmul_rn(x, __fmul_rn(k.fx, __frcp_rn(k.fx)));
  const float yb = __fmul_rn(y, __fmul_rn(k.fy, __frcp_rn(k.fy)));
  const float nrm = __fsqrt_rn(__fadd_rn(__fmaf_rn(yb, yb, __fmul_rn(xb, xb)), 1.f));
  b[0] = __fdiv_rn(xb, nrm);
  b[1] = __fdiv_rn(yb, nrm);
  b[2] = __fdiv_rn(1.f, nrm);
}

// what a frame's finish reads besides the keypoints, and where it writes
enum Feed { kUndistortOnly = 0, kMono = 1, kStereo = 2, kRGBD = 3 };

struct FinishIn {
  const float* xy;        // [N,2]
  const int* level;       // [N]
  const float* angle;     // [N]
  const uint8_t* valid;   // [N] bool bytes
  const float* response;  // [N]
  const int4* desc;       // [N,8] int32 as two 16-byte vectors a row
  const float* xr;        // stereo: kernel T's x_right [N]
  const float* depth;     // stereo: kernel T's depths [N]
  const float* depth_map;  // RGBD: [H,W] raw depth
  int H, W;
  float inv_factor;  // RGBD: the float32 of 1 / depthmap_factor
};

struct FinishOut {
  float *und, *bear, *xr, *depth, *packed;
};

// The frame's finish, one thread a slot (kernel R's undistortion with all
// that JAX's jitted _mono_preprocess / _rgbd_preprocess build around it in
// the same program): the undistorted keypoint and its bearing; x_right and
// the depth (-1 for mono; kernel T's for stereo; for RGBD the depth map
// sampled at the keypoint's pixel, truncated and clamped as JAX's
// astype(int32) and clip, times inv_factor, -1 unless valid and positive,
// and x_right = und_x - fxb / max(d, 1e-6) as a true division); and the
// packed [N,21] host-mirror row (data/frame.py pack_host_cols: xy, und,
// bearing, level, angle, valid, response, x_right, depth, the descriptor's
// bits). A row is 84 bytes, so a block stages its rows in shared memory
// (stride 21 floats: no bank conflicts) and writes them out as contiguous
// 16-byte stores. kUndistortOnly writes und and (when given) bear only:
// the camera's undistortion entry point (svt_undistort).
template <int MODEL>
__global__ void __launch_bounds__(kFinishThreads)
frame_finish_kernel(int N, int feed, Intr k, Dist dc, float rcp_w, float rcp_h, FinishIn in,
                    FinishOut out) {
  __shared__ __align__(16) float rows[kFinishThreads * kPackCols];
  const int n0 = blockIdx.x * kFinishThreads;
  const int n = n0 + threadIdx.x;
  if (n < N) {
    const float2 p = reinterpret_cast<const float2*>(in.xy)[n];
    float ux, uy, b[3];
    undistort_point<MODEL>(k, dc, rcp_w, rcp_h, p.x, p.y, ux, uy, b);
    if (out.und) reinterpret_cast<float2*>(out.und)[n] = make_float2(ux, uy);
    if (out.bear) {
      out.bear[3 * n] = b[0];
      out.bear[3 * n + 1] = b[1];
      out.bear[3 * n + 2] = b[2];
    }
    if (feed != kUndistortOnly) {
      const bool valid = in.valid[n] != 0;
      float xr = -1.f, d = -1.f;
      if (feed == kStereo) {
        xr = in.xr[n];
        d = in.depth[n];
      } else if (feed == kRGBD) {
        const int xs = min(max(__float2int_rz(p.x), 0), in.W - 1);
        const int ys = min(max(__float2int_rz(p.y), 0), in.H - 1);
        const float raw =
            __fmul_rn(__ldg(in.depth_map + (size_t)ys * in.W + xs), in.inv_factor);
        d = (valid && raw > 0.f) ? raw : -1.f;
        // fxb / d a true division, as the JAX version's (its divisor varies)
        xr = d > 0.f ? __fsub_rn(ux, __fdiv_rn(k.fxb, fmaxf(d, 1e-6f))) : -1.f;
      }
      if (out.xr) {
        out.xr[n] = xr;
        out.depth[n] = d;
      }
      float* r = rows + threadIdx.x * kPackCols;
      r[0] = p.x;
      r[1] = p.y;
      r[2] = ux;
      r[3] = uy;
      r[4] = b[0];
      r[5] = b[1];
      r[6] = b[2];
      r[7] = __int2float_rn(in.level[n]);
      r[8] = in.angle[n];
      r[9] = valid ? 1.f : 0.f;
      r[10] = in.response[n];
      r[11] = xr;
      r[12] = d;
      const int4 d0 = __ldg(in.desc + 2 * n), d1 = __ldg(in.desc + 2 * n + 1);
      r[13] = __int_as_float(d0.x);
      r[14] = __int_as_float(d0.y);
      r[15] = __int_as_float(d0.z);
      r[16] = __int_as_float(d0.w);
      r[17] = __int_as_float(d1.x);
      r[18] = __int_as_float(d1.y);
      r[19] = __int_as_float(d1.z);
      r[20] = __int_as_float(d1.w);
    }
  }
  if (feed == kUndistortOnly) return;  // the same for the whole block
  __syncthreads();
  // the block's rows are contiguous in the pack (and start 16-byte aligned:
  // 128 rows of 84 bytes a block): 16-byte stores, then the tail's floats
  const int nf = min(kFinishThreads, N - n0) * kPackCols;
  float* dst = out.packed + (size_t)n0 * kPackCols;
  const int nv = nf / 4;
  for (int q = threadIdx.x; q < nv; q += kFinishThreads)
    reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(rows)[q];
  for (int q = 4 * nv + threadIdx.x; q < nf; q += kFinishThreads) dst[q] = rows[q];
}

template <int MODEL>
void launch_finish(int N, int feed, const Intr& k, const Dist& dc, float rcp_w, float rcp_h,
                   const FinishIn& in, const FinishOut& out, cudaStream_t s) {
  const int grid = (N + kFinishThreads - 1) / kFinishThreads;
  frame_finish_kernel<MODEL><<<grid, kFinishThreads, 0, s>>>(N, feed, k, dc, rcp_w, rcp_h, in,
                                                              out);
}

int finish(int model, int N, int feed, const Intr& k, const Dist& dc, float rcp_w, float rcp_h,
           const FinishIn& in, const FinishOut& out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0) {
    if (model == svt_cam::kPerspective)
      launch_finish<svt_cam::kPerspective>(N, feed, k, dc, rcp_w, rcp_h, in, out, s);
    else if (model == svt_cam::kFisheye)
      launch_finish<svt_cam::kFisheye>(N, feed, k, dc, rcp_w, rcp_h, in, out, s);
    else if (model == svt_cam::kEquirect)
      launch_finish<svt_cam::kEquirect>(N, feed, k, dc, rcp_w, rcp_h, in, out, s);
    else
      launch_finish<svt_cam::kRadialDivision>(N, feed, k, dc, rcp_w, rcp_h, in, out, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// model: 0 perspective, 2 equirectangular. R [9] and t [3] f32.
// mode 0: pos [M,3] with last_level [M] int32 and last_valid [M] bytes.
// mode 1: pos is the packed f32 table [M,8] (16-byte aligned) with tbl_u32
// [M,10]; pred (the predicted level) is written too, with inv_log_scale the
// float32 reciprocal of log(scale factor).
// out: u, v, xr, rad [M] f32, lo, hi, pred [M] int32, valid [M] bytes.
extern "C" int svt_window_rows(int model, int M, int mode, float fx, float fy, float cx,
                               float cy, float width, float height, float fxb, const float* R,
                               const float* t, const float* pos, const int* tbl_u32,
                               const int* last_level, const uint8_t* last_valid,
                               const float* scale_factors, float margin, float inv_log_scale,
                               int num_levels, float* u, float* v, float* xr, float* rad,
                               int* lo, int* hi, int* pred, uint8_t* valid, void* stream) {
  if ((model != svt_cam::kPerspective && model != svt_cam::kEquirect) || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  Intr k{fx, fy, cx, cy, width, height, fxb};
  Rows out{u, v, xr, rad, lo, hi, pred, valid};
  const int grid = (M + kRowThreads - 1) / kRowThreads;
  cudaStream_t s = (cudaStream_t)stream;
#define SVT_ROWS(MODEL, MODE)                                                            \
  window_rows_kernel<MODEL, MODE><<<grid, kRowThreads, 0, s>>>(                          \
      M, k, R, t, pos, tbl_u32, last_level, last_valid, scale_factors, margin, inv_log_scale, \
      num_levels, out)
  if (model == svt_cam::kEquirect) {
    if (mode == 1) SVT_ROWS(svt_cam::kEquirect, 1);
    else SVT_ROWS(svt_cam::kEquirect, 0);
  } else {
    if (mode == 1) SVT_ROWS(svt_cam::kPerspective, 1);
    else SVT_ROWS(svt_cam::kPerspective, 0);
  }
#undef SVT_ROWS
  return (int)cudaGetLastError();
}

// model: 0 radial-tangential, 1 Kannala-Brandt, 3 division; bear (may be
// null): [N,3] unit bearings of the undistorted keypoints
extern "C" int svt_undistort(int model, int N, float fx, float fy, float cx, float cy, float k1,
                             float k2, float p1, float p2, float k3, float k4, const float* pts,
                             float* out, float* bear, void* stream) {
  if (model != svt_cam::kPerspective && model != svt_cam::kFisheye &&
      model != svt_cam::kRadialDivision)
    return (int)cudaErrorInvalidValue;
  FinishIn in{};
  in.xy = pts;
  return finish(model, N, kUndistortOnly, Intr{fx, fy, cx, cy, 0.f, 0.f, 0.f},
                Dist{k1, k2, p1, p2, k3, k4}, 0.f, 0.f, in,
                FinishOut{out, bear, nullptr, nullptr, nullptr}, stream);
}

// The frame's finish: model 0-3 (camera.cuh), feed 1 mono, 2 stereo (xr_in,
// d_in: kernel T's outputs), 3 RGBD (depth_map [H,W], inv_factor, fxb).
// xy [N,2], level [N] int32, angle [N], valid [N] bytes, response [N],
// desc [N,8] int32 (16-byte aligned); rcp_w, rcp_h: the float32
// reciprocals of the equirectangular image's width and height. Writes und
// [N,2] (null for the equirectangular model, whose undistortion is the
// identity), bear [N,3], xr_out and d_out [N] (null for stereo) and packed
// [N,21] (16-byte aligned).
extern "C" int svt_frame_finish(int model, int feed, int N, float fx, float fy, float cx,
                                float cy, float k1, float k2, float p1, float p2, float k3,
                                float k4, float rcp_w, float rcp_h, float fxb, const float* xy,
                                const int* level, const float* angle, const uint8_t* valid,
                                const float* response, const int* desc, const float* xr_in,
                                const float* d_in, const float* depth_map, int H, int W,
                                float inv_factor, float* und, float* bear, float* xr_out,
                                float* d_out, float* packed, void* stream) {
  if (model < 0 || model > 3 || feed < kMono || feed > kRGBD || !bear || !packed ||
      (model != svt_cam::kEquirect && !und) || (feed == kStereo && (!xr_in || !d_in)) ||
      (feed != kStereo && (!xr_out || !d_out)) ||
      (feed == kRGBD && (!depth_map || H < 1 || W < 1)))
    return (int)cudaErrorInvalidValue;
  FinishIn in{xy, level, angle, valid, response, reinterpret_cast<const int4*>(desc),
              xr_in, d_in, depth_map, H, W, inv_factor};
  return finish(model, N, feed, Intr{fx, fy, cx, cy, 0.f, 0.f, fxb},
                Dist{k1, k2, p1, p2, k3, k4}, rcp_w, rcp_h, in,
                FinishOut{und, bear, feed == kStereo ? nullptr : xr_out,
                          feed == kStereo ? nullptr : d_out, packed},
                stream);
}
