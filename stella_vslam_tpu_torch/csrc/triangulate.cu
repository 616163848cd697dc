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
// Here four lanes per (neighbour b = blockIdx.y, new-keyframe slot), eight
// slots a warp, 128 threads a block. The group gathers its matched
// neighbour keypoint (idx2 from kernel J); lane r builds and normalises row
// r of the 4x4 DLT system (rows 0-1 from view 1, 2-3 from view 2); the nine
// normal-equation and three right-hand entries are summed over the lanes by
// shuffles in the rows' order 0..3; lane p computes the adjugate's row p
// and X[p] (the 1e-9 ridge, |det| < 1e-12 clamped), which the shuffles
// broadcast; then the checks are split: lane 0 view 1 and lane 1 view 2
// (positive depth, visibility, reprojection chi-square <= 5.991), lane 2
// the parallax cos < 0.99998, lane 3 the distance ratio within the
// scale-factor ratio x 2, combined by a ballot. Every operation rounds as
// the JAX version's float32 expressions in order (`__fmul_rn`,
// `__fadd_rn`, `__fdiv_rn`, no FMA), as the one-thread-a-slot kernel
// before it did, so pos, idx and ok keep its bits. Bound: ~1.5 MB of
// traffic for 5 x 2872 slots (the inputs once, the outputs once) and ~600
// float operations per slot: ~0.5 us of memory time. The one-thread form
// ran a dependent chain of ~600 operations (25 divisions, 7 roots) in 115
// blocks, under one an SM; four lanes give 4x the warps in flight and a
// chain about a third as long. The level tables are read through the
// read-only cache (no shared-memory prologue), and the bool inputs and
// output are read and written as bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;  // lanes a (neighbour, slot): one a DLT row
constexpr unsigned kFull = 0xffffffffu;
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

// the sum over the group's four lanes of v, in lane order (the DLT rows'
// order 0..3 of the parent's sums), the same in every lane of the group
__device__ __forceinline__ float group_sum(float v) {
  const float v0 = __shfl_sync(kFull, v, 0, kLanes), v1 = __shfl_sync(kFull, v, 1, kLanes),
              v2 = __shfl_sync(kFull, v, 2, kLanes), v3 = __shfl_sync(kFull, v, 3, kLanes);
  return add(add(add(v0, v1), v2), v3);
}

template <int MODEL>
__global__ void __launch_bounds__(kThreads)
triangulate_kernel(int N1, int N2, const float* __restrict__ uv1, const int* __restrict__ lvl1,
                   const float* __restrict__ bear1, const float* __restrict__ uv2,
                   const int* __restrict__ lvl2, const float* __restrict__ bear2,
                   const float* __restrict__ poses, const int* __restrict__ match,
                   const uint8_t* __restrict__ accepted, const uint8_t* __restrict__ pair_valid,
                   TriCam cam, const float* __restrict__ sigma_sq,
                   const float* __restrict__ scale_factors, float* __restrict__ pos_out,
                   int* __restrict__ idx_out, uint8_t* __restrict__ ok_out) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int slot = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int b = blockIdx.y;
  // every lane of the warp takes part in the shuffles: a group past the end
  // recomputes the last slot and writes nothing
  const bool live = slot < N1;
  const int i = live ? slot : N1 - 1;
  const size_t o = (size_t)b * N1 + i;
  const int j = __ldg(match + o);
  const size_t jb = (size_t)b * N2 + j;
  const float* R1 = poses;  // [B+1, 12]: row 0 the new keyframe, then the neighbours
  const float* t1 = poses + 9;
  const float* R2 = poses + 12 * (b + 1);
  const float* t2 = R2 + 9;

  // ---- DLT: lane r builds and normalises row r (rows 0-1 from view 1,
  // 2-3 from view 2): b[r & 1] * P[2] - b[2] * P[r & 1] ----
  const bool second = lane >= 2;
  const float* R = second ? R2 : R1;
  const float* t = second ? t2 : t1;
  const float* bp = second ? bear2 + 3 * jb : bear1 + 3 * i;
  const int q = lane & 1;
  const float bq = __ldg(bp + q), b2 = __ldg(bp + 2);
  float A[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p2 = __ldg(k < 3 ? R + 6 + k : t + 2);
    const float pq = __ldg(k < 3 ? R + 3 * q + k : t + q);
    A[k] = sub(mul(bq, p2), mul(b2, pq));
  }
  const float nrm = add(
      sqrtf(add(add(add(mul(A[0], A[0]), mul(A[1], A[1])), mul(A[2], A[2])), mul(A[3], A[3]))),
      1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) A[k] = __fdiv_rn(A[k], nrm);
  // the normal equations A^T A (symmetric: a product is the same either
  // way round) and A^T a3, each summed over the rows in order 0..3
  const float a = add(group_sum(mul(A[0], A[0])), 1e-9f);
  const float bb = group_sum(mul(A[0], A[1])), cc = group_sum(mul(A[0], A[2]));
  const float e = add(group_sum(mul(A[1], A[1])), 1e-9f);
  const float f = group_sum(mul(A[1], A[2]));
  const float ii = add(group_sum(mul(A[2], A[2])), 1e-9f);
  const float c0 = group_sum(mul(A[0], A[3])), c1 = group_sum(mul(A[1], A[3])),
              c2 = group_sum(mul(A[2], A[3]));
  const float d = bb, g = cc, h = f;  // M[1][0], M[2][0], M[2][1]
  // inv3x3 by adjugate / determinant (|det| < 1e-12 clamped): lane p (lane
  // 3 repeats row 2) computes the adjugate's row p and X[p]
  const int p = min(lane, 2);
  const float adj0 = sub(mul(p == 0 ? e : p == 1 ? f : d, p == 0 ? ii : p == 1 ? g : h),
                         mul(p == 0 ? f : p == 1 ? d : e, p == 0 ? h : p == 1 ? ii : g));
  const float adj1 = sub(mul(p == 0 ? cc : p == 1 ? a : bb, p == 0 ? h : p == 1 ? ii : g),
                         mul(p == 0 ? bb : p == 1 ? cc : a, p == 0 ? ii : p == 1 ? g : h));
  const float adj2 = sub(mul(p == 0 ? bb : p == 1 ? cc : a, p == 0 ? f : p == 1 ? d : e),
                         mul(p == 0 ? cc : p == 1 ? a : bb, p == 0 ? e : p == 1 ? f : d));
  float det = add(add(mul(a, __shfl_sync(kFull, adj0, 0, kLanes)),
                      mul(bb, __shfl_sync(kFull, adj0, 1, kLanes))),
                  mul(cc, __shfl_sync(kFull, adj0, 2, kLanes)));
  if (fabsf(det) < 1e-12f) det = 1e-12f;
  const float xp = -add(add(mul(__fdiv_rn(adj0, det), c0), mul(__fdiv_rn(adj1, det), c1)),
                        mul(__fdiv_rn(adj2, det), c2));
  const float X[3] = {__shfl_sync(kFull, xp, 0, kLanes), __shfl_sync(kFull, xp, 1, kLanes),
                      __shfl_sync(kFull, xp, 2, kLanes)};

  // ---- checks, split over the lanes and combined by a ballot ----
  bool pass;
  if (!second) {
    // lane 0 view 1, lane 1 view 2: depth, visibility and the reprojection
    // chi-square (lane 0 also the match's acceptance, lane 1 the pair's)
    const float* Rv = q ? R2 : R1;
    const float* tv = q ? t2 : t1;
    const float* uv = q ? uv2 + 2 * jb : uv1 + 2 * i;
    const int l = q ? __ldg(lvl2 + jb) : __ldg(lvl1 + i);
    float pc[3], u, v, z;
    transform(Rv, tv, X, pc);
    const bool vis = reproject<MODEL>(cam, Rv, tv, X, u, v, z);
    const float du = sub(u, __ldg(uv)), dv = sub(v, __ldg(uv + 1));
    const float err = __fdiv_rn(add(mul(du, du), mul(dv, dv)), __ldg(sigma_sq + l));
    pass = pc[2] > 0.f && err <= kChi2D && vis &&
           (q ? __ldg(pair_valid + b) != 0 : __ldg(accepted + o) != 0);
  } else {
    // lane 2 the parallax, lane 3 the distance ratio against the scale
    // factors' ratio x 2; both from the rays to the two camera centres
    float C1[3], C2[3], ray1[3], ray2[3];
    centre(R1, t1, C1);
    centre(R2, t2, C2);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ray1[k] = sub(X[k], C1[k]);
      ray2[k] = sub(X[k], C2[k]);
    }
    const float d1 = norm3(ray1), d2 = norm3(ray2);
    if (q == 0) {
      const float cos_rays = __fdiv_rn(
          add(add(mul(ray1[0], ray2[0]), mul(ray1[1], ray2[1])), mul(ray1[2], ray2[2])),
          fmaxf(mul(d1, d2), 1e-12f));
      pass = cos_rays < 0.99998f;
    } else {
      const float ratio_dist = __fdiv_rn(d2, fmaxf(d1, 1e-12f));
      const float ratio_scale = __fdiv_rn(__ldg(scale_factors + __ldg(lvl2 + jb)),
                                          fmaxf(__ldg(scale_factors + __ldg(lvl1 + i)), 1e-12f));
      pass = ratio_dist < mul(ratio_scale, 2.f) && ratio_dist > __fdiv_rn(ratio_scale, 2.f);
    }
  }
  const int first = threadIdx.x & 31 & ~(kLanes - 1);  // the group's first lane in the warp
  const unsigned group = (__ballot_sync(kFull, pass) >> first) & 0xFu;
  if (!live) return;
  if (lane < 3) pos_out[3 * o + lane] = xp;
  else {
    const bool ok = group == 0xFu;
    idx_out[o] = ok ? j : -1;
    ok_out[o] = ok ? 1 : 0;
  }
}

}  // namespace

// model: 0 perspective, 2 equirectangular (camera.cuh)
extern "C" int svt_triangulate(int model, int B, int N1, int N2, const float* uv1,
                               const int* lvl1, const float* bear1, const float* uv2,
                               const int* lvl2, const float* bear2, const float* poses,
                               const int* match, const uint8_t* accepted,
                               const uint8_t* pair_valid, float fx, float fy, float cx,
                               float cy, float width, float height, const float* sigma_sq,
                               const float* scale_factors, float* pos_out,
                               int* idx_out, uint8_t* ok_out, void* stream) {
  if (model != svt_cam::kPerspective && model != svt_cam::kEquirect)
    return (int)cudaErrorInvalidValue;
  auto kernel = model == svt_cam::kEquirect ? triangulate_kernel<svt_cam::kEquirect>
                                            : triangulate_kernel<svt_cam::kPerspective>;
  if (N1 > 0 && B > 0) {
    const dim3 grid((N1 * kLanes + kThreads - 1) / kThreads, B);
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        N1, N2, uv1, lvl1, bear1, uv2, lvl2, bear2, poses, match, accepted, pair_valid,
        TriCam{fx, fy, cx, cy, width, height}, sigma_sq, scale_factors, pos_out, idx_out,
        ok_out);
  }
  return (int)cudaGetLastError();
}
