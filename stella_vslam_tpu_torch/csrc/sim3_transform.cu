// Kernel O: Sim(3) refinement between two keyframes from mutual reprojection.
//
// Replaces stella_vslam_tpu/ops/optim/sim3.py optimize_transform (:56): 10
// accept-if-better Gauss-Newton steps on the 7-vector of a left perturbation
// of S_12 (6 with fix_scale). The TPU form is a lax.scan whose step takes the
// [4N,7] Jacobian by jax.jacfwd through sim3_exp, forms J^T J by a matmul and
// retraces for every N. Here one block runs the whole schedule for any N:
//
//  per step, every thread walks its pairs: the forward point q = s R x2 + t
//  and the backward point p = S^-1 x1, their pixel residuals, and the
//  closed-form Jacobian rows (the perturbation moves q by rho + phi x q +
//  sigma q, rows [I, -hat(q), q] through the projection; p by
//  -(1/s) R^T [I, -hat(x1), x1]; the sigma column is zero with fix_scale;
//  a depth inside the projection's |z| < 1e-6 guard is a constant), rows
//  weighted by sqrt(inv_sigma * inlier) with the previous step's inliers;
//  J^T J (28 entries), J^T r and the cost are reduced over the block;
//  thread 0 adds 1e-6 I, solves by the unrolled Cholesky of ops/linalg.py and
//  forms the trial state Exp(dx) S; the block reduces the trial cost with
//  the same weights; the state is kept unless the trial cost is not larger;
//  then every pair's inlier flag is reset by the chi-square test at the
//  state kept.
//
// Bound: latency. A step reads 14 floats per pair (160 KB at N = 2872) and
// does ~500 operations per pair; the 10 steps are serial, each with two
// block reductions and a one-thread 7x7 solve. The state, the normal
// equations and the trial stay in shared memory; only the inlier flags touch
// device memory between steps.
#include <stdint.h>

#include "sim3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAcc = 36;  // 28 upper entries of J^T J, 7 of J^T r, the cost

struct State {
  float s, R[9], t[3];
};

struct Cam {
  float fx, fy, cx, cy;
};

// Sum of NV values over the block; every thread gets the totals. Warps are
// summed in order.
template <int NV>
__device__ void block_sum(float (&v)[NV], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nw = kThreads / 32;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float s = v[q];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) scratch[warp * NV + q] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += scratch[w * NV + threadIdx.x];
    scratch[nw * NV + threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = scratch[nw * NV + q];
  __syncthreads();
}

// pixel residual of a camera-frame point and, when J is not null, the
// projection's 2x3 derivative
__device__ __forceinline__ void project(const Cam& c, const float* X, const float* obs, float* r,
                                        float (*dp)[3]) {
  const bool live = fabsf(X[2]) >= 1e-6f;
  const float z = live ? X[2] : 1e-6f;
  r[0] = c.fx * X[0] / z + c.cx - obs[0];
  r[1] = c.fy * X[1] / z + c.cy - obs[1];
  if (dp) {
    dp[0][0] = c.fx / z; dp[0][1] = 0.f; dp[0][2] = live ? -c.fx * X[0] / (z * z) : 0.f;
    dp[1][0] = 0.f; dp[1][1] = c.fy / z; dp[1][2] = live ? -c.fy * X[1] / (z * z) : 0.f;
  }
}

// forward point q = s R x2 + t, backward point p = (1/s) R^T (x1 - t)
__device__ __forceinline__ void transfer(const State& S, const float* x1, const float* x2,
                                         float* q, float* p) {
  const float si = 1.f / S.s;
  float ti[3];
  for (int i = 0; i < 3; ++i)
    ti[i] = -si * (S.R[i] * S.t[0] + S.R[3 + i] * S.t[1] + S.R[6 + i] * S.t[2]);
  for (int i = 0; i < 3; ++i) {
    q[i] = S.s * (S.R[3 * i] * x2[0] + S.R[3 * i + 1] * x2[1] + S.R[3 * i + 2] * x2[2]) + S.t[i];
    p[i] = si * (S.R[i] * x1[0] + S.R[3 + i] * x1[1] + S.R[6 + i] * x1[2]) + ti[i];
  }
}

// rows [I, -hat(v), sig v] of the point v
__device__ __forceinline__ void point_rows(const float* v, bool fix_scale, float (*M)[7]) {
  const float h[3][3] = {{0.f, v[2], -v[1]}, {-v[2], 0.f, v[0]}, {v[1], -v[0], 0.f}};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      M[i][j] = i == j ? 1.f : 0.f;
      M[i][3 + j] = h[i][j];
    }
    M[i][6] = fix_scale ? 0.f : v[i];
  }
}

__device__ __forceinline__ void add_row(const float* Jr, float r, float w, float* acc) {
  int q = 0;
#pragma unroll
  for (int a = 0; a < 7; ++a)
#pragma unroll
    for (int b = a; b < 7; ++b) acc[q++] += (w * Jr[a]) * (w * Jr[b]);
#pragma unroll
  for (int a = 0; a < 7; ++a) acc[28 + a] += (w * Jr[a]) * (w * r);
  acc[35] += (w * r) * (w * r);
}

__global__ void __launch_bounds__(kThreads)
sim3_transform_kernel(int N, const float* __restrict__ pts1, const float* __restrict__ pts2,
                      const float* __restrict__ obs1, const float* __restrict__ obs2,
                      const float* __restrict__ isig1, const float* __restrict__ isig2,
                      const uint8_t* __restrict__ valid, const float* __restrict__ R0,
                      const float* __restrict__ t0, const float* __restrict__ s0, Cam cam,
                      float chi_sq, int fix_scale, int num_iter, float* __restrict__ out,
                      uint8_t* __restrict__ inlier) {
  __shared__ float scratch[(kThreads / 32 + 1) * kAcc];
  __shared__ State S, Sn;
  __shared__ float cost0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    S.s = s0[0];
    for (int i = 0; i < 9; ++i) S.R[i] = R0[i];
    for (int i = 0; i < 3; ++i) S.t[i] = t0[i];
  }
  for (int n = tid; n < N; n += kThreads) inlier[n] = valid[n];
  __syncthreads();
  for (int it = 0; it < num_iter; ++it) {
    // linearize at S with the previous step's inliers
    float acc[kAcc];
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    const float si = 1.f / S.s;
    for (int n = tid; n < N; n += kThreads) {
      if (!inlier[n]) continue;
      float q[3], p[3], r1[2], r2[2], d1[2][3], d2[2][3];
      transfer(S, pts1 + 3 * n, pts2 + 3 * n, q, p);
      project(cam, q, obs1 + 2 * n, r1, d1);
      project(cam, p, obs2 + 2 * n, r2, d2);
      float M[3][7], Mb[3][7], Mp[3][7];
      point_rows(q, fix_scale != 0, M);
      point_rows(pts1 + 3 * n, fix_scale != 0, Mb);
      for (int i = 0; i < 3; ++i)
        for (int c = 0; c < 7; ++c)
          Mp[i][c] = -si * (S.R[i] * Mb[0][c] + S.R[3 + i] * Mb[1][c] + S.R[6 + i] * Mb[2][c]);
      const float w1 = sqrtf(isig1[n]), w2 = sqrtf(isig2[n]);
      for (int k = 0; k < 2; ++k) {
        float Jr[7];
        for (int c = 0; c < 7; ++c)
          Jr[c] = d1[k][0] * M[0][c] + d1[k][1] * M[1][c] + d1[k][2] * M[2][c];
        add_row(Jr, r1[k], w1, acc);
        for (int c = 0; c < 7; ++c)
          Jr[c] = d2[k][0] * Mp[0][c] + d2[k][1] * Mp[1][c] + d2[k][2] * Mp[2][c];
        add_row(Jr, r2[k], w2, acc);
      }
    }
    block_sum<kAcc>(acc, scratch);
    if (tid == 0) {
      // H = J^T J + 1e-6 I; dx = -H^-1 J^T r by the unrolled Cholesky
      float H[7][7], L[7][7], y[7], x[7];
      int q = 0;
      for (int a = 0; a < 7; ++a)
        for (int b = a; b < 7; ++b) {
          H[a][b] = acc[q];
          H[b][a] = acc[q++];
        }
      for (int a = 0; a < 7; ++a) H[a][a] += 1e-6f;
      for (int j = 0; j < 7; ++j) {
        float s = H[j][j];
        for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
        s = sqrtf(fmaxf(s, 1e-20f));
        L[j][j] = s;
        const float inv = 1.f / s;
        for (int i = j + 1; i < 7; ++i) {
          float v = H[i][j];
          for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
          L[i][j] = v * inv;
        }
      }
      for (int i = 0; i < 7; ++i) {
        float v = acc[28 + i];
        for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
        y[i] = v / L[i][i];
      }
      for (int i = 6; i >= 0; --i) {
        float v = y[i];
        for (int k = i + 1; k < 7; ++k) v -= L[k][i] * x[k];
        x[i] = v / L[i][i];
      }
      float dx[7], ds, dR[9], dt[3];
      for (int i = 0; i < 7; ++i) dx[i] = -x[i];
      sim3::sim3_exp(dx, ds, dR, dt);
      if (fix_scale) ds = 1.f;
      sim3::sim3_compose(ds, dR, dt, S.s, S.R, S.t, Sn.s, Sn.R, Sn.t);
      cost0 = acc[35];
    }
    __syncthreads();
    // the trial cost with the same weights
    float c1[1] = {0.f};
    for (int n = tid; n < N; n += kThreads) {
      if (!inlier[n]) continue;
      float q[3], p[3], r1[2], r2[2];
      transfer(Sn, pts1 + 3 * n, pts2 + 3 * n, q, p);
      project(cam, q, obs1 + 2 * n, r1, nullptr);
      project(cam, p, obs2 + 2 * n, r2, nullptr);
      const float w1 = sqrtf(isig1[n]), w2 = sqrtf(isig2[n]);
      c1[0] += (w1 * r1[0]) * (w1 * r1[0]) + (w1 * r1[1]) * (w1 * r1[1]) +
               (w2 * r2[0]) * (w2 * r2[0]) + (w2 * r2[1]) * (w2 * r2[1]);
    }
    block_sum<1>(c1, scratch);
    if (tid == 0 && c1[0] <= cost0) S = Sn;
    __syncthreads();
    // inlier reset at the state kept
    for (int n = tid; n < N; n += kThreads) {
      float q[3], p[3], r1[2], r2[2];
      transfer(S, pts1 + 3 * n, pts2 + 3 * n, q, p);
      project(cam, q, obs1 + 2 * n, r1, nullptr);
      project(cam, p, obs2 + 2 * n, r2, nullptr);
      const float e1 = (r1[0] * r1[0] + r1[1] * r1[1]) * isig1[n];
      const float e2 = (r2[0] * r2[0] + r2[1] * r2[1]) * isig2[n];
      inlier[n] = (valid[n] && e1 <= chi_sq && e2 <= chi_sq && q[2] > 1e-4f && p[2] > 1e-4f)
                      ? 1 : 0;
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[0] = S.s;
    for (int i = 0; i < 9; ++i) out[1 + i] = S.R[i];
    for (int i = 0; i < 3; ++i) out[10 + i] = S.t[i];
  }
}

}  // namespace

extern "C" int svt_sim3_transform(int N, const float* pts1, const float* pts2, const float* obs1,
                                  const float* obs2, const float* isig1, const float* isig2,
                                  const uint8_t* valid, const float* R0, const float* t0,
                                  const float* s0, float fx, float fy, float cx, float cy,
                                  float chi_sq, int fix_scale, int num_iter, float* out,
                                  uint8_t* inlier, void* stream) {
  Cam c{fx, fy, cx, cy};
  sim3_transform_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      N, pts1, pts2, obs1, obs2, isig1, isig2, valid, R0, t0, s0, c, chi_sq, fix_scale, num_iter,
      out, inlier);
  return (int)cudaGetLastError();
}
