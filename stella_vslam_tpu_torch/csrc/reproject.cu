// Kernel R: the perspective camera's per-point projections, two entry points.
//
// Replaces stella_vslam_tpu/camera/base.py reproject_to_image (:232) with the
// x_right of the tracking cascade's projections, and for the local-map
// stage the visibility gate and predicted scale of
// stella_vslam_tpu/module/tracking_kernels.py track_frame (:266-285); and
// _perspective_undistort_norm (:89, 10 fixed-point iterations) with the
// normalization around it (perspective_undistort). The TPU forms are
// lane-major elementwise programs; on the card each was ~15 eager torch ops
// per call, every one a launch and a round trip through device memory.
//
//  reproject_kernel (one thread per point): camera-frame point, pixel,
//    depth, in-image flag and x_right; mode 1 (the landmark table, rows of
//    the packed [C,8] f32 / [C,10] u32 table) also the distance to the
//    camera centre, the gate distance in [0.8 min, 1.3 max], cos(ray,
//    normal) > 0.5, depth > 0, the table's valid flag, and the predicted
//    scale level clip(ceil(log(max / dist) / log(scale factor)), 0, L-1).
//  undistort_kernel (one thread per keypoint): normalize, 10 iterations of
//    x = xd - (distort(x) - x), back to pixels.
// Bound: ~30 bytes and ~100 operations per point (the slice's 2872 slots or
// 4096 table rows): ~0.04 us of bytes, so it is bound by its launch.
// Floats follow the torch expressions' order. In the reprojection the card
// may contract a product and a sum into one FMA, so uv agrees to ~1e-6
// relative and a flag differs from the plain version's only where its
// quantity sits at the threshold. The undistortion rounds every operation
// as its plain version does on the card and equals it bit for bit: a true
// division and an FMA there moved the monocular initializer's input by an
// ulp and, through the near-degenerate two-view geometry of a planar
// scene, its init frame.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Intr {
  float fx, fy, cx, cy, width, height, fxb;
};

__global__ void __launch_bounds__(kThreads)
reproject_kernel(int M, int mode, Intr k, const float* __restrict__ Rt,
                 const float* __restrict__ pos, const int* __restrict__ tbl_u32,
                 float log_scale, int num_levels, float* __restrict__ uv_out,
                 float* __restrict__ depth_out, uint8_t* __restrict__ vis_out,
                 float* __restrict__ xr_out, int* __restrict__ scale_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float* R = Rt;
  const float* t = Rt + 9;
  const int stride = mode == 1 ? 8 : 3;
  const float p0 = pos[stride * m], p1 = pos[stride * m + 1], p2 = pos[stride * m + 2];
  const float x = p0 * R[0] + p1 * R[1] + p2 * R[2] + t[0];
  const float y = p0 * R[3] + p1 * R[4] + p2 * R[5] + t[1];
  const float z = p0 * R[6] + p1 * R[7] + p2 * R[8] + t[2];
  const float zs = fabsf(z) < 1e-8f ? 1e-8f : z;
  const float u = k.fx * x / zs + k.cx;
  const float v = k.fy * y / zs + k.cy;
  const bool in_img = z > 0.f && u >= 0.f && u < k.width && v >= 0.f && v < k.height;
  uv_out[2 * m] = u;
  uv_out[2 * m + 1] = v;
  depth_out[m] = z;
  xr_out[m] = z > 1e-6f ? u - k.fxb / fmaxf(z, 1e-6f) : -1.f;
  if (mode == 0) {
    vis_out[m] = in_img ? 1 : 0;
    return;
  }
  // camera centre -R^T t
  const float c0 = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
  const float c1 = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
  const float c2 = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
  const float r0 = p0 - c0, r1 = p1 - c1, r2 = p2 - c2;
  const float dist = sqrtf(r0 * r0 + r1 * r1 + r2 * r2);
  const float* row = pos + 8 * m;
  const float dmin = row[6], dmax = row[7];
  const bool dist_ok = dist >= 0.8f * dmin && dist <= 1.3f * dmax;
  const float cosang = (r0 * row[3] + r1 * row[4] + r2 * row[5]) / fmaxf(dist, 1e-9f);
  const bool valid = tbl_u32[10 * m + 9] > 0;
  vis_out[m] = (valid && in_img && dist_ok && cosang > 0.5f && z > 0.f) ? 1 : 0;
  const float ratio = fmaxf(dmax, 1e-9f) / fmaxf(dist, 1e-9f);
  const float lv = ceilf(logf(fmaxf(ratio, 1e-9f)) / log_scale);
  scale_out[m] = (int)fminf(fmaxf(lv, 0.f), (float)(num_levels - 1));
}

__global__ void __launch_bounds__(kThreads)
undistort_kernel(int N, Intr k, float k1, float k2, float p1, float p2, float k3,
                 const float* __restrict__ pts, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  // every product and sum rounded on its own, in the torch expressions'
  // order (no contraction into FMAs), and the division by fx as torch
  // divides a CUDA tensor by a scalar (times the float32 reciprocal): the
  // result equals the plain version on the card bit for bit
  const float xd = __fmul_rn(__fsub_rn(pts[2 * n], k.cx), __fdiv_rn(1.f, k.fx));
  const float yd = __fmul_rn(__fsub_rn(pts[2 * n + 1], k.cy), __fdiv_rn(1.f, k.fy));
  const float two_p1 = 2.f * p1, two_p2 = 2.f * p2;  // exact doublings
  float x = xd, y = yd;
  for (int it = 0; it < 10; ++it) {
    const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
    const float radial = __fadd_rn(
        1.f, __fmul_rn(r2, __fadd_rn(k1, __fmul_rn(r2, __fadd_rn(k2, __fmul_rn(r2, k3))))));
    const float dx = __fadd_rn(
        __fadd_rn(__fmul_rn(x, radial), __fmul_rn(__fmul_rn(two_p1, x), y)),
        __fmul_rn(p2, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.f, x), x))));
    const float dy = __fadd_rn(
        __fadd_rn(__fmul_rn(y, radial), __fmul_rn(p1, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.f, y), y)))),
        __fmul_rn(__fmul_rn(two_p2, x), y));
    x = __fsub_rn(xd, __fsub_rn(dx, x));
    y = __fsub_rn(yd, __fsub_rn(dy, y));
  }
  out[2 * n] = __fadd_rn(__fmul_rn(x, k.fx), k.cx);
  out[2 * n + 1] = __fadd_rn(__fmul_rn(y, k.fy), k.cy);
}

}  // namespace

// mode 0: pos [M,3]; outputs uv [M,2], depth, in-image flag, x_right.
// mode 1: pos is the packed f32 table [M,8] with tbl_u32 [M,10]; the flag is
// the local-map gate and scale_out the predicted level. Rt: R [9] then t [3].
extern "C" int svt_reproject(int M, int mode, float fx, float fy, float cx, float cy,
                             float width, float height, float fxb, const float* Rt,
                             const float* pos, const int* tbl_u32, float log_scale,
                             int num_levels, float* uv_out, float* depth_out, uint8_t* vis_out,
                             float* xr_out, int* scale_out, void* stream) {
  Intr k{fx, fy, cx, cy, width, height, fxb};
  if (M > 0)
    reproject_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        M, mode, k, Rt, pos, tbl_u32, log_scale, num_levels, uv_out, depth_out, vis_out, xr_out,
        scale_out);
  return (int)cudaGetLastError();
}

extern "C" int svt_undistort(int N, float fx, float fy, float cx, float cy, float k1, float k2,
                             float p1, float p2, float k3, const float* pts, float* out,
                             void* stream) {
  Intr k{fx, fy, cx, cy, 0.f, 0.f, 0.f};
  if (N > 0)
    undistort_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        N, k, k1, k2, p1, p2, k3, pts, out);
  return (int)cudaGetLastError();
}
