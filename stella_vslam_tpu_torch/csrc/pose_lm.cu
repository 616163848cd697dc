// Kernel D: motion-only pose optimization, the whole schedule in one launch.
//
// Replaces stella_vslam_tpu/ops/optim/pose.py optimize_pose (:39) with the
// perspective and equirectangular residuals of ops/optim/residuals.py (:46,
// :92; the kernel is templated on the model, the equirectangular rows and
// their 2x3 Jacobian coming from camera.cuh): num_rounds rounds of
// (1 + num_each_iter) deferred-acceptance LM evaluations of a 6-DoF pose,
// Huber weights in the first num_robust_rounds rounds, chi-square
// reclassification (5.991 mono / 7.815 stereo) after each round. The TPU
// form is a lax.scan of batched [N,3,6] Jacobian einsums and an unrolled
// 6x6 Cholesky.
//
// On Hopper: ONE thread block owns the problem. Each thread keeps a strided
// share of the N observation slots (and their inlier flags) for the whole
// run; every evaluation is one pass in which each thread forms residuals and
// Jacobians in registers and accumulates the 21 upper normal-equation terms,
// the 6 gradient terms and the cost, followed by a warp-shuffle + shared
// memory block reduction. Thread 0 then runs the damped 6x6 Cholesky solve,
// the accept/reject test and the SE(3) retraction (pose.py:83-101) and
// publishes the next trial pose through shared memory. Bound: ~49 dependent
// passes over N slots (4 x 11 evaluations + 5 chi-square passes), each
// ~150 flops per slot, plus the serial thread-0 solve between passes —
// latency bound (barriers and the serial solve), not throughput bound; one
// launch replaces the ~1000 small kernels an eager version of the schedule
// would issue.
//
// Float32 throughout; sums are taken in another order than the JAX version,
// so results agree to a tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 28;  // 21 (upper H) + 6 (b) + 1 (cost)

struct Cam {
  float fx, fy, cx, cy, fxb, width, height;
};

// residual r[3], Jacobian J[3][6], dof, depth_ok for one slot
template <int MODEL>
__device__ __forceinline__ void residual(const float* R, const float* t, const float* p,
                                         float ou, float ov, float oxr, const Cam& c,
                                         float r[3], float J[3][6], float dof[3],
                                         bool& depth_ok) {
  const float x = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + t[0];
  const float y = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + t[1];
  const float z = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + t[2];
  float d[3][3];  // d(pi)/d(Xc)
  if constexpr (MODEL == svt_cam::kEquirect) {
    float re[2], de[2][3];
    depth_ok = svt_cam::equirect_residual(x, y, z, ou, ov, c.cx, c.cy, c.width, c.height, re,
                                          de);
    r[0] = re[0];
    r[1] = re[1];
    r[2] = 0.f;
    dof[0] = 1.f;
    dof[1] = 1.f;
    dof[2] = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      d[0][j] = de[0][j];
      d[1][j] = de[1][j];
      d[2][j] = 0.f;
    }
  } else {
    const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
    const float iz = 1.f / zs;
    const float iz2 = iz * iz;
    const float u = c.fx * x * iz + c.cx;
    const float v = c.fy * y * iz + c.cy;
    const float ur = u - c.fxb * iz;
    const bool stereo = oxr > 0.f;
    r[0] = u - ou;
    r[1] = v - ov;
    r[2] = stereo ? ur - oxr : 0.f;
    dof[0] = 1.f;
    dof[1] = 1.f;
    dof[2] = stereo ? 1.f : 0.f;
    depth_ok = z > 1e-4f;
    const float dp[3][3] = {{c.fx * iz, 0.f, -c.fx * x * iz2},
                            {0.f, c.fy * iz, -c.fy * y * iz2},
                            {c.fx * iz, 0.f, -c.fx * x * iz2 + c.fxb * iz2}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) d[i][j] = dp[i][j];
  }
  // d(Xc)/d(xi) = [I | -hat(Xc)], -hat(X) = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
  const float mh[3][3] = {{0.f, z, -y}, {-z, 0.f, x}, {y, -x, 0.f}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      J[i][j] = d[i][j];
      J[i][3 + j] = d[i][0] * mh[0][j] + d[i][1] * mh[1][j] + d[i][2] * mh[2][j];
    }
  }
}

__device__ void cholesky_solve6(const float A[36], const float b[6], float x[6]) {
  float L[6][6] = {};
  for (int j = 0; j < 6; ++j) {
    float s = A[j * 6 + j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    s = sqrtf(fmaxf(s, 1e-20f));
    L[j][j] = s;
    const float inv = 1.f / s;
    for (int i = j + 1; i < 6; ++i) {
      float v = A[i * 6 + j];
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float v = b[i];
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * x[k];
    x[i] = v / L[i][i];
  }
}

// (R, t) <- Exp(xi) * (R, t), xi = [rho, phi] (ops/lie.py se3_update_left)
__device__ void se3_update_left(const float* R, const float* t, const float xi[6],
                                float* Rn, float* tn) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  const float sn = sinf(th), cs = cosf(th);
  const float a = small ? 1.f - th2 / 6.f : sn / th;
  const float bb = small ? 0.5f - th2 / 24.f : (1.f - cs) / th2;
  const float cc = small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th);
  const float K[3][3] = {{0.f, -phi[2], phi[1]}, {phi[2], 0.f, -phi[0]}, {-phi[1], phi[0], 0.f}};
  float K2[3][3], dR[3][3], Jl[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      K2[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      dR[i][j] = e + a * K[i][j] + bb * K2[i][j];
      Jl[i][j] = e + bb * K[i][j] + cc * K2[i][j];
    }
  float dt[3];
  for (int i = 0; i < 3; ++i) dt[i] = Jl[i][0] * rho[0] + Jl[i][1] * rho[1] + Jl[i][2] * rho[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rn[i * 3 + j] = dR[i][0] * R[0 * 3 + j] + dR[i][1] * R[1 * 3 + j] + dR[i][2] * R[2 * 3 + j];
    tn[i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] + dt[i];
  }
}

// damped step from (H, b) and lambda, applied to (R, t)
__device__ void lm_step(const float* H, const float* b, float lam, const float* R,
                        const float* t, float* Rn, float* tn) {
  float Hd[36], nb[6], dx[6];
  for (int i = 0; i < 36; ++i) Hd[i] = H[i];
  for (int i = 0; i < 6; ++i) {
    Hd[i * 6 + i] = (H[i * 6 + i] + lam * H[i * 6 + i]) + 1e-9f;
    nb[i] = b[i];
  }
  cholesky_solve6(Hd, nb, dx);
  for (int i = 0; i < 6; ++i) dx[i] = -dx[i];
  se3_update_left(R, t, dx, Rn, tn);
}

template <int MODEL>
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(int N, const float* __restrict__ pos, const float* __restrict__ uv,
               const float* __restrict__ xr, const float* __restrict__ inv_sig,
               const uint8_t* __restrict__ valid, const float* __restrict__ R0,
               const float* __restrict__ t0, Cam cam, int num_rounds, int num_robust,
               int num_iter, float* __restrict__ R_out, float* __restrict__ t_out,
               uint8_t* __restrict__ inlier, float* __restrict__ chi2_out) {
  __shared__ float red[kWarps][kTerms];
  __shared__ float tot[kTerms];
  __shared__ float Ps[9], Pt[3];  // pose the next pass evaluates
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 9) Ps[tid] = R0[tid];
  if (tid < 3) Pt[tid] = t0[tid];
  for (int j = tid; j < N; j += kThreads) inlier[j] = valid[j];
  __syncthreads();

  // thread-0 LM state (registers of thread 0 only)
  float Rb[9], tb[3], Hb[36], bvec[6], cost_b = 0.f, lam = 1e-4f;

  // One evaluation pass at the pose in (Ps, Pt); totals land in `tot`.
  auto eval_pass = [&](bool use_huber) {
    float acc[kTerms];
#pragma unroll
    for (int i = 0; i < kTerms; ++i) acc[i] = 0.f;
    float R[9], t[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = Ps[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = Pt[i];
    for (int j = tid; j < N; j += kThreads) {
      float r[3], J[3][6], dof[3];
      bool depth_ok;
      residual<MODEL>(R, t, pos + 3 * j, uv[2 * j], uv[2 * j + 1], xr[j], cam, r, J, dof,
                      depth_ok);
      const float isg = inv_sig[j];
      const bool stereo = xr[j] > 0.f;
      const float sqrt_chi = sqrtf(stereo ? 7.815f : 5.991f);
      const float w_obs = (valid[j] && inlier[j] && depth_ok) ? isg : 0.f;
      const float e2 = r[0] * r[0] * dof[0] + r[1] * r[1] * dof[1] + r[2] * r[2] * dof[2];
      const float chi = sqrtf(fmaxf(e2 * isg, 1e-12f));
      const float hw = (use_huber && chi > sqrt_chi) ? sqrt_chi / chi : 1.f;
      const float w = w_obs * hw;
      if (w == 0.f) continue;
      int n = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int bcol = a; bcol < 6; ++bcol) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k) s += J[k][a] * (dof[k] * w) * J[k][bcol];
          acc[n++] += s;
        }
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) s += J[k][a] * (dof[k] * w) * r[k];
        acc[21 + a] += s;
      }
      acc[27] += w * e2;
    }
#pragma unroll
    for (int i = 0; i < kTerms; ++i) {
      float v = acc[i];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][i] = v;
    }
    __syncthreads();
    if (tid < kTerms) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w][tid];
      tot[tid] = s;
    }
    __syncthreads();
  };
  auto unpack = [&](float* H, float* b, float& cost) {
    int n = 0;
    for (int a = 0; a < 6; ++a)
      for (int bcol = a; bcol < 6; ++bcol) {
        H[a * 6 + bcol] = tot[n];
        H[bcol * 6 + a] = tot[n];
        ++n;
      }
    for (int a = 0; a < 6; ++a) b[a] = tot[21 + a];
    cost = tot[27];
  };
  // chi-square classification at (Ps, Pt); optionally writes chi2
  auto classify = [&](bool write_chi2) {
    for (int j = tid; j < N; j += kThreads) {
      float r[3], J[3][6], dof[3];
      bool depth_ok;
      residual<MODEL>(Ps, Pt, pos + 3 * j, uv[2 * j], uv[2 * j + 1], xr[j], cam, r, J, dof,
                      depth_ok);
      const float chi2 =
          (r[0] * r[0] * dof[0] + r[1] * r[1] * dof[1] + r[2] * r[2] * dof[2]) * inv_sig[j];
      const float thr = xr[j] > 0.f ? 7.815f : 5.991f;
      if (write_chi2)
        chi2_out[j] = chi2;
      else
        inlier[j] = (valid[j] && depth_ok && chi2 <= thr) ? 1 : 0;
    }
    __syncthreads();
  };

  for (int round = 0; round < num_rounds; ++round) {
    const bool use_huber = round < num_robust;
    eval_pass(use_huber);  // at the round's start pose
    if (tid == 0) {
      for (int i = 0; i < 9; ++i) Rb[i] = Ps[i];
      for (int i = 0; i < 3; ++i) tb[i] = Pt[i];
      unpack(Hb, bvec, cost_b);
      lam = 1e-4f;
      float Rn[9], tn[3];
      lm_step(Hb, bvec, 1e-4f, Rb, tb, Rn, tn);
      for (int i = 0; i < 9; ++i) Ps[i] = Rn[i];
      for (int i = 0; i < 3; ++i) Pt[i] = tn[i];
    }
    __syncthreads();
    for (int it = 0; it < num_iter; ++it) {
      eval_pass(use_huber);  // at the trial pose
      if (tid == 0) {
        float Ht[36], bt[6], cost_t;
        unpack(Ht, bt, cost_t);
        const bool accept = cost_t < cost_b;
        if (accept) {
          for (int i = 0; i < 9; ++i) Rb[i] = Ps[i];
          for (int i = 0; i < 3; ++i) tb[i] = Pt[i];
          for (int i = 0; i < 36; ++i) Hb[i] = Ht[i];
          for (int i = 0; i < 6; ++i) bvec[i] = bt[i];
          cost_b = cost_t;
        }
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-9f), 1e6f);
        float Rn[9], tn[3];
        lm_step(Hb, bvec, lam, Rb, tb, Rn, tn);
        for (int i = 0; i < 9; ++i) Ps[i] = Rn[i];
        for (int i = 0; i < 3; ++i) Pt[i] = tn[i];
      }
      __syncthreads();
    }
    // the round ends at its best pose; reclassify there
    if (tid == 0) {
      for (int i = 0; i < 9; ++i) Ps[i] = Rb[i];
      for (int i = 0; i < 3; ++i) Pt[i] = tb[i];
    }
    __syncthreads();
    classify(false);
  }
  classify(true);
  if (tid < 9) R_out[tid] = Ps[tid];
  if (tid < 3) t_out[tid] = Pt[tid];
}

}  // namespace

// model: 0 perspective, 2 equirectangular (camera.cuh)
extern "C" int svt_pose_lm(int model, int N, const float* pos, const float* uv,
                           const float* xr, const float* inv_sig, const uint8_t* valid,
                           const float* R0, const float* t0, float fx, float fy, float cx,
                           float cy, float fxb, float width, float height, int num_rounds,
                           int num_robust, int num_iter, float* R_out, float* t_out,
                           uint8_t* inlier, float* chi2_out, void* stream) {
  Cam cam{fx, fy, cx, cy, fxb, width, height};
  cudaStream_t s = (cudaStream_t)stream;
  if (model == svt_cam::kEquirect)
    pose_lm_kernel<svt_cam::kEquirect><<<1, kThreads, 0, s>>>(
        N, pos, uv, xr, inv_sig, valid, R0, t0, cam, num_rounds, num_robust, num_iter, R_out,
        t_out, inlier, chi2_out);
  else if (model == svt_cam::kPerspective)
    pose_lm_kernel<svt_cam::kPerspective><<<1, kThreads, 0, s>>>(
        N, pos, uv, xr, inv_sig, valid, R0, t0, cam, num_rounds, num_robust, num_iter, R_out,
        t_out, inlier, chi2_out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
