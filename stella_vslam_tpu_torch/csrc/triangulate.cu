// Kernel K: two-view DLT triangulation and its checks, for the new keyframe
// against B neighbour keyframes in one launch.
//
// Replaces stella_vslam_tpu/module/mapping_kernels.py _triangulate_pair_impl
// (:58-142, after its matcher) with ops/triangulation.py triangulate_dlt
// (:15), ops/linalg.py inv3x3 (:174) and camera/base.py reproject_to_image
// (:232), vmapped over the neighbours by _triangulate_multi_impl (:145). The
// TPU form gathers the matched neighbour keypoints with one-hot [N1,N2]
// reductions, then runs the DLT and the checks as [N1]-wide vector code.
//
// Templated on the camera model: the reprojection checks project with the
// model's own projection (camera.cuh for the equirectangular one), while
// the depth check stays the camera-frame z > 0 in both views, as in JAX
// (mapping_kernels.py:102).
//
// Here one thread per (neighbour b = blockIdx.y, new-keyframe slot): it
// gathers its matched neighbour keypoint (idx2 from kernel J), builds the
// row-normalised 4x4 DLT system, solves the 3x3 normal equations by the
// adjugate with the 1e-9 ridge, and applies the checks in the JAX
// version's float32 expression order, each rounding separate (no FMA):
// positive depth in both views, parallax cos < 0.99998, reprojection
// chi-square <= 5.991 in both views with visibility, and the distance ratio
// within the scale-factor ratio x 2. Bound: ~1.5 MB of traffic for 5 x 2872
// slots (the inputs once, the outputs once) and ~600 float operations per
// slot: ~0.5 us of memory time, so the kernel is bound by its launch and
// one thread's serial arithmetic; the design keeps everything in registers
// and reads each input once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 32;
constexpr float kChi2D = 5.991f;

struct TriCam {
  float fx, fy, cx, cy, width, height;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// (R x) + t, each row summed left to right: x @ R.T + t
__device__ __forceinline__ void transform(const float* R, const float* t, const float* x,
                                          float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = add(add(add(mul(x[0], R[3 * r]), mul(x[1], R[3 * r + 1])), mul(x[2], R[3 * r + 2])),
                 t[r]);
}

// camera centre -R^T t
__device__ __forceinline__ void centre(const float* R, const float* t, float* c) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    c[k] = -add(add(mul(R[k], t[0]), mul(R[3 + k], t[1])), mul(R[6 + k], t[2]));
}

__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf(add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2])));
}

// reproject_to_image: (u, v, depth, visible)
template <int MODEL>
__device__ __forceinline__ bool reproject(const TriCam& c, const float* R, const float* t,
                                          const float* x, float& u, float& v, float& z) {
  float pc[3];
  transform(R, t, x, pc);
  if constexpr (MODEL == svt_cam::kEquirect)
    return svt_cam::equirect_project(pc[0], pc[1], pc[2], c.cx, c.cy, c.width, c.height, u, v,
                                     z);
  z = pc[2];
  const float zs = fabsf(z) < 1e-8f ? 1e-8f : z;
  u = add(__fdiv_rn(mul(c.fx, pc[0]), zs), c.cx);
  v = add(__fdiv_rn(mul(c.fy, pc[1]), zs), c.cy);
  return z > 0.f && u >= 0.f && u < c.width && v >= 0.f && v < c.height;
}

// rows b[0]*P[2] - b[2]*P[0] and b[1]*P[2] - b[2]*P[1] of P = [R | t]
__device__ __forceinline__ void dlt_rows(const float* b, const float* R, const float* t,
                                         float* r0, float* r1) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p0 = k < 3 ? R[k] : t[0];
    const float p1 = k < 3 ? R[3 + k] : t[1];
    const float p2 = k < 3 ? R[6 + k] : t[2];
    r0[k] = sub(mul(b[0], p2), mul(b[2], p0));
    r1[k] = sub(mul(b[1], p2), mul(b[2], p1));
  }
}

template <int MODEL>
__global__ void __launch_bounds__(kThreads)
triangulate_kernel(int N1, int N2, const float* __restrict__ uv1, const int* __restrict__ lvl1,
                   const float* __restrict__ bear1, const float* __restrict__ uv2,
                   const int* __restrict__ lvl2, const float* __restrict__ bear2,
                   const float* __restrict__ poses, const int* __restrict__ match,
                   const uint8_t* __restrict__ accepted, const uint8_t* __restrict__ pair_valid,
                   TriCam cam, const float* __restrict__ sigma_sq,
                   const float* __restrict__ scale_factors, int num_levels,
                   float* __restrict__ pos_out, int* __restrict__ idx_out,
                   uint8_t* __restrict__ ok_out) {
  __shared__ float s_sig[kMaxLevels], s_sf[kMaxLevels];
  for (int i = threadIdx.x; i < num_levels; i += blockDim.x) {
    s_sig[i] = sigma_sq[i];
    s_sf[i] = scale_factors[i];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= N1) return;
  const size_t o = (size_t)b * N1 + i;
  const int j = match[o];
  const float* R1 = poses;  // [B+1, 12]: row 0 the new keyframe, then the neighbours
  const float* t1 = poses + 9;
  const float* R2 = poses + 12 * (b + 1);
  const float* t2 = R2 + 9;
  const float b1[3] = {bear1[3 * i], bear1[3 * i + 1], bear1[3 * i + 2]};
  const size_t jb = (size_t)b * N2 + j;
  const float b2[3] = {bear2[3 * jb], bear2[3 * jb + 1], bear2[3 * jb + 2]};

  // ---- DLT ----
  float A[4][4];
  dlt_rows(b1, R1, t1, A[0], A[1]);
  dlt_rows(b2, R2, t2, A[2], A[3]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float n = add(sqrtf(add(add(add(mul(A[r][0], A[r][0]), mul(A[r][1], A[r][1])),
                                      mul(A[r][2], A[r][2])),
                                  mul(A[r][3], A[r][3]))),
                        1e-12f);
#pragma unroll
    for (int k = 0; k < 4; ++k) A[r][k] = __fdiv_rn(A[r][k], n);
  }
  float M[3][3], c[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      M[p][q] = add(add(add(mul(A[0][p], A[0][q]), mul(A[1][p], A[1][q])), mul(A[2][p], A[2][q])),
                    mul(A[3][p], A[3][q]));
    c[p] = add(add(add(mul(A[0][p], A[0][3]), mul(A[1][p], A[1][3])), mul(A[2][p], A[2][3])),
               mul(A[3][p], A[3][3]));
    M[p][p] = add(M[p][p], 1e-9f);
  }
  // inv3x3: adjugate / determinant, |det| < 1e-12 clamped to 1e-12
  const float a = M[0][0], bb = M[0][1], cc = M[0][2], d = M[1][0], e = M[1][1], f = M[1][2],
              g = M[2][0], h = M[2][1], ii = M[2][2];
  float adj[3][3];
  adj[0][0] = sub(mul(e, ii), mul(f, h));
  adj[0][1] = sub(mul(cc, h), mul(bb, ii));
  adj[0][2] = sub(mul(bb, f), mul(cc, e));
  adj[1][0] = sub(mul(f, g), mul(d, ii));
  adj[1][1] = sub(mul(a, ii), mul(cc, g));
  adj[1][2] = sub(mul(cc, d), mul(a, f));
  adj[2][0] = sub(mul(d, h), mul(e, g));
  adj[2][1] = sub(mul(bb, g), mul(a, h));
  adj[2][2] = sub(mul(a, e), mul(bb, d));
  float det = add(add(mul(a, adj[0][0]), mul(bb, adj[1][0])), mul(cc, adj[2][0]));
  if (fabsf(det) < 1e-12f) det = 1e-12f;
  float X[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float i0 = __fdiv_rn(adj[p][0], det), i1 = __fdiv_rn(adj[p][1], det),
                i2 = __fdiv_rn(adj[p][2], det);
    X[p] = -add(add(mul(i0, c[0]), mul(i1, c[1])), mul(i2, c[2]));
  }

  // ---- checks ----
  float pc1[3], pc2[3];
  transform(R1, t1, X, pc1);
  transform(R2, t2, X, pc2);
  const bool depth_ok = pc1[2] > 0.f && pc2[2] > 0.f;
  float C1[3], C2[3], ray1[3], ray2[3];
  centre(R1, t1, C1);
  centre(R2, t2, C2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ray1[k] = sub(X[k], C1[k]);
    ray2[k] = sub(X[k], C2[k]);
  }
  const float d1 = norm3(ray1), d2 = norm3(ray2);
  const float cos_rays =
      __fdiv_rn(add(add(mul(ray1[0], ray2[0]), mul(ray1[1], ray2[1])), mul(ray1[2], ray2[2])),
                fmaxf(mul(d1, d2), 1e-12f));
  const bool parallax_ok = cos_rays < 0.99998f;
  float u1, v1, z1, u2, v2, z2;
  const bool vis1 = reproject<MODEL>(cam, R1, t1, X, u1, v1, z1);
  const bool vis2 = reproject<MODEL>(cam, R2, t2, X, u2, v2, z2);
  const int l1 = lvl1[i], l2 = lvl2[jb];
  const float du1 = sub(u1, uv1[2 * i]), dv1 = sub(v1, uv1[2 * i + 1]);
  const float du2 = sub(u2, uv2[2 * jb]), dv2 = sub(v2, uv2[2 * jb + 1]);
  const float e1 = __fdiv_rn(add(mul(du1, du1), mul(dv1, dv1)), s_sig[l1]);
  const float e2 = __fdiv_rn(add(mul(du2, du2), mul(dv2, dv2)), s_sig[l2]);
  const bool reproj_ok = e1 <= kChi2D && e2 <= kChi2D && vis1 && vis2;
  const float ratio_dist = __fdiv_rn(d2, fmaxf(d1, 1e-12f));
  const float ratio_scale = __fdiv_rn(s_sf[l2], fmaxf(s_sf[l1], 1e-12f));
  const bool scale_ok =
      ratio_dist < mul(ratio_scale, 2.f) && ratio_dist > __fdiv_rn(ratio_scale, 2.f);
  const bool ok = accepted[o] && depth_ok && parallax_ok && reproj_ok && scale_ok &&
                  pair_valid[b] != 0;
  pos_out[3 * o] = X[0];
  pos_out[3 * o + 1] = X[1];
  pos_out[3 * o + 2] = X[2];
  idx_out[o] = ok ? j : -1;
  ok_out[o] = ok ? 1 : 0;
}

}  // namespace

// model: 0 perspective, 2 equirectangular (camera.cuh)
extern "C" int svt_triangulate(int model, int B, int N1, int N2, const float* uv1,
                               const int* lvl1, const float* bear1, const float* uv2,
                               const int* lvl2, const float* bear2, const float* poses,
                               const int* match, const uint8_t* accepted,
                               const uint8_t* pair_valid, float fx, float fy, float cx,
                               float cy, float width, float height, const float* sigma_sq,
                               const float* scale_factors, int num_levels, float* pos_out,
                               int* idx_out, uint8_t* ok_out, void* stream) {
  if (num_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (model != svt_cam::kPerspective && model != svt_cam::kEquirect)
    return (int)cudaErrorInvalidValue;
  auto kernel = model == svt_cam::kEquirect ? triangulate_kernel<svt_cam::kEquirect>
                                            : triangulate_kernel<svt_cam::kPerspective>;
  if (N1 > 0 && B > 0) {
    const dim3 grid((N1 + kThreads - 1) / kThreads, B);
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        N1, N2, uv1, lvl1, bear1, uv2, lvl2, bear2, poses, match, accepted, pair_valid,
        TriCam{fx, fy, cx, cy, width, height}, sigma_sq, scale_factors, num_levels, pos_out,
        idx_out, ok_out);
  }
  return (int)cudaGetLastError();
}
