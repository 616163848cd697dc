// Kernel D: motion-only pose optimization, a batch of problems in one launch.
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
// On Hopper: one cluster of kCluster = 8 blocks owns a problem, and
// a launch solves B problems (the tracking cascade's keyframe fallback and
// motion model together). Each block stages its share of the N slots in
// shared memory once (pos and 1/sigma^2 as one float4, uv and x_right as
// another, the valid and inlier bits as a byte: 33 bytes a slot) and every
// pass reads them from there. A pass is one residual per slot: the 21 upper
// normal-equation terms, the 6 gradient terms and the cost, summed in
// registers, then over the warp by recursive halving (31 shuffles, lane l
// ending with term l), then stored as the warp's 28 partials into every
// block of the cluster (distributed shared memory: the stores do not wait,
// where loads of the peers' partials would). One cluster barrier
// follows; lane i of every warp then sums term i over the
// cluster's blocks and warps in one fixed order from its own block's
// copy, and a shuffle hands the 28 totals to every lane. Every thread
// then carries the LM state (best pose, H, b, cost, lambda) in registers
// and runs the damped 6x6 Cholesky, the accept test and the SE(3)
// retraction itself: the same inputs and instructions give the same bits
// in every thread, so no thread waits for a serial section and no second
// barrier broadcasts its result. The partials are double-buffered: a warp
// writes pass k + 1's while a slower one may still read pass k's.
//
// A round's chi-square classification happens inside the next round's
// first evaluation (the same pose, the same residual: the new inlier flag
// is set before the slot is weighted), and the final classification writes
// the chi-square values: 4 x 11 evaluations + 1 final pass = 45 passes
// over the slots, one barrier each, where the previous design made 49
// passes with three barriers and a thread-0 solve each.
//
// Bound: latency. Each pass is ~250 dependent FP32 operations a slot (0.7 M
// at N = 2872) followed by the reduction, the barrier and the redundant
// 6x6 solve (~500 dependent operations). Measured with clock64 per phase
// (not kept) on an H100, the previous one-block design spent 63% of its
// time in its threads' chains of ~6 slots read from L2, 18% in thread 0's
// solve and 13% in the shuffle tree: the slot work set the pace. So a
// problem is spread over a cluster of 8 blocks (1.4 slots a thread at
// N = 2872; clusters of 1, 2 and 4 blocks were slower at N = 1199 and 2872,
// PERF.md); at that size the slot work, the cluster barrier and the solve
// take comparable shares. At most kMaxSlotsPerBlock slots a block fit in
// shared memory (227 KB): the wrapper (ops/optim/pose.py, CLUSTER and
// MAX_SLOTS_PER_BLOCK) refuses more than kMaxSlotsPerBlock x kCluster.
//
// Float32 throughout; sums are taken in another order than the JAX version,
// so results agree to a tolerance, not bit for bit. The order is fixed by
// the launch shape, so a launch repeats bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kCluster = 8;  // blocks a problem (ops/optim/pose.py CLUSTER)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 28;  // 21 (upper H) + 6 (b) + 1 (cost)
constexpr int kSlotBytes = 33;           // 2 float4 + 1 flag byte
constexpr int kMaxSlotsPerBlock = 6400;  // (232448 - 8 blocks' partials) / 33, rounded down
constexpr uint8_t kValid = 1, kInlier = 2;

struct Cam {
  float fx, fy, cx, cy, fxb, width, height;
};

// The problems of one launch: per-slot inputs with a batch stride in
// elements (0 when every problem shares the tensor), poses and outputs per
// problem.
struct Batch {
  const float* pos;
  long long pos_bs;
  const float* uv;
  long long uv_bs;
  const float* xr;
  long long xr_bs;
  const float* isg;
  long long isg_bs;
  const uint8_t* valid;
  long long valid_bs;
  const float* R0;  // [B,9]
  const float* t0;  // [B,3]
  float* R_out;
  float* t_out;
  uint8_t* inlier;  // [B,N]
  float* chi2;      // [B,N]
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

__device__ __forceinline__ void cholesky_solve6(const float A[36], const float b[6],
                                                float x[6]) {
  float L[6][6] = {}, inv_d[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j * 6 + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float inv = rsqrtf(fmaxf(s, 1e-20f));  // 1 / L[j][j]
    inv_d[j] = inv;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = A[i * 6 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v * inv;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v * inv_d[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * x[k];
    x[i] = v * inv_d[i];
  }
}

// (R, t) <- Exp(xi) * (R, t), xi = [rho, phi] (ops/lie.py se3_update_left)
__device__ __forceinline__ void se3_update_left(const float* R, const float* t,
                                                const float xi[6], float* Rn, float* tn) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float ith = 1.f / th, ith2 = ith * ith;
  const float a = small ? 1.f - th2 / 6.f : sn * ith;
  const float bb = small ? 0.5f - th2 / 24.f : (1.f - cs) * ith2;
  const float cc = small ? 1.f / 6.f - th2 / 120.f : (th - sn) * (ith2 * ith);
  const float K[3][3] = {{0.f, -phi[2], phi[1]}, {phi[2], 0.f, -phi[0]}, {-phi[1], phi[0], 0.f}};
  float K2[3][3], dR[3][3], Jl[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      dR[i][j] = e + a * K[i][j] + bb * K2[i][j];
      Jl[i][j] = e + bb * K[i][j] + cc * K2[i][j];
    }
  float dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dt[i] = Jl[i][0] * rho[0] + Jl[i][1] * rho[1] + Jl[i][2] * rho[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[i * 3 + j] = dR[i][0] * R[0 * 3 + j] + dR[i][1] * R[1 * 3 + j] + dR[i][2] * R[2 * 3 + j];
    tn[i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] + dt[i];
  }
}

// damped step from the packed upper H (21), b and lambda, applied to (R, t)
__device__ __forceinline__ void lm_step(const float* Hu, const float* b, float lam,
                                        const float* R, const float* t, float* Rn, float* tn) {
  float Hd[36], dx[6];
  int n = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c) {
      Hd[a * 6 + c] = Hu[n];
      Hd[c * 6 + a] = Hu[n];
      ++n;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) Hd[i * 6 + i] = (Hd[i * 6 + i] + lam * Hd[i * 6 + i]) + 1e-9f;
  cholesky_solve6(Hd, b, dx);
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = -dx[i];
  se3_update_left(R, t, dx, Rn, tn);
}

// One step of the warp's recursive halving: a lane keeps terms [0, H) or
// [H, 2H) of v (by its bit H) in v[0, H) and adds its partner's copy of them.
template <int H>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// the partials of a pass: [2 buffers][kCluster blocks][kWarps][kTerms]
constexpr int kPartFloats = 2 * kCluster * kWarps * kTerms;

template <int MODEL>
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(int N, int chunk, Batch bt, Cam cam, int num_rounds, int num_robust,
               int num_iter) {
  extern __shared__ float4 smem[];
  float* part = reinterpret_cast<float*>(smem);
  float4* sA = smem + kPartFloats / 4;  // pos, 1/sigma^2
  float4* sB = sA + chunk;              // u, v, x_right
  uint8_t* sF = reinterpret_cast<uint8_t*>(sB + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int prob = blockIdx.x / kCluster;
  const int rank = (int)cluster.block_rank();
  const int base = rank * chunk;
  const int n_loc = max(0, min(N - base, chunk));

  // stage this block's slots
  {
    const float* pos = bt.pos + prob * bt.pos_bs;
    const float* uv = bt.uv + prob * bt.uv_bs;
    const float* xr = bt.xr + prob * bt.xr_bs;
    const float* isg = bt.isg + prob * bt.isg_bs;
    const uint8_t* valid = bt.valid + prob * bt.valid_bs;
    for (int j = tid; j < n_loc; j += kThreads) {
      const int g = base + j;
      sA[j] = make_float4(pos[3 * g], pos[3 * g + 1], pos[3 * g + 2], isg[g]);
      sB[j] = make_float4(uv[2 * g], uv[2 * g + 1], xr[g], 0.f);
      sF[j] = valid[g] ? (kValid | kInlier) : 0;
    }
  }
  float Rc[9], tc[3];  // the pose the next pass evaluates
#pragma unroll
  for (int i = 0; i < 9; ++i) Rc[i] = bt.R0[prob * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) tc[i] = bt.t0[prob * 3 + i];
  cluster.sync();  // every block of the cluster has started: peers' stores may land

  int buf = 0;
  // One evaluation pass at (Rc, tc): every thread gets the 28 totals.
  // `reclassify` sets each slot's inlier flag at this pose first.
  auto eval_pass = [&](bool use_huber, bool reclassify, float tot[kTerms]) {
    float acc[kTerms];
#pragma unroll
    for (int i = 0; i < kTerms; ++i) acc[i] = 0.f;
    for (int j = tid; j < n_loc; j += kThreads) {
      const float4 a = sA[j], b4 = sB[j];
      const float p[3] = {a.x, a.y, a.z};
      float r[3], J[3][6], dof[3];
      bool depth_ok;
      residual<MODEL>(Rc, tc, p, b4.x, b4.y, b4.z, cam, r, J, dof, depth_ok);
      const float isg = a.w;
      const bool stereo = b4.z > 0.f;
      const float e2 = r[0] * r[0] * dof[0] + r[1] * r[1] * dof[1] + r[2] * r[2] * dof[2];
      const float chi2 = e2 * isg;
      uint8_t f = sF[j];
      if (reclassify) {
        const bool in = (f & kValid) && depth_ok && chi2 <= (stereo ? 7.815f : 5.991f);
        f = (f & kValid) | (in ? kInlier : 0);
        sF[j] = f;
      }
      const float sqrt_chi = sqrtf(stereo ? 7.815f : 5.991f);
      const float w_obs = ((f & kValid) && (f & kInlier) && depth_ok) ? isg : 0.f;
      const float chi = sqrtf(fmaxf(chi2, 1e-12f));
      const float hw = (use_huber && chi > sqrt_chi) ? sqrt_chi / chi : 1.f;
      const float w = w_obs * hw;
      if (w == 0.f) continue;
      int n = 0;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
#pragma unroll
        for (int d = c; d < 6; ++d) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k) s += J[k][c] * (dof[k] * w) * J[k][d];
          acc[n++] += s;
        }
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) s += J[k][c] * (dof[k] * w) * r[k];
        acc[21 + c] += s;
      }
      acc[27] += w * e2;
    }
    // the warp's sums by recursive halving: at each step a lane keeps half
    // of its terms and adds its partner's copy of them, so that lane l ends
    // with the warp's sum of term l (31 shuffles for 32 terms, 4 of them 0)
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = i < kTerms ? acc[i] : 0.f;
    halve<16>(v, lane);
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    float* const pb = part + buf * kCluster * kWarps * kTerms;
    if (lane < kTerms) {
      const int off = (rank * kWarps + warp) * kTerms + lane;
#pragma unroll
      for (int rb = 0; rb < kCluster; ++rb) cluster.map_shared_rank(pb, rb)[off] = v[0];
    }
    cluster.sync();
    // lane i sums term i over (block, warp) in one order, in every warp:
    // four running sums over the partials in turn, then their sum
    float s = 0.f;
    if (lane < kTerms) {
      float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kCluster * kWarps; ++w) q[w & 3] += pb[w * kTerms + lane];
      s = (q[0] + q[1]) + (q[2] + q[3]);
    }
#pragma unroll
    for (int i = 0; i < kTerms; ++i) tot[i] = __shfl_sync(0xffffffffu, s, i);
    buf ^= 1;
  };

  float Rb[9], tb[3], Hb[21], bv[6], cost_b = 0.f, lam = 1e-4f;
  float tot[kTerms];
  for (int round = 0; round < num_rounds; ++round) {
    const bool use_huber = round < num_robust;
    // at the round's start pose (the previous round's best), which the
    // previous round's classification is fused into
    eval_pass(use_huber, round > 0, tot);
#pragma unroll
    for (int i = 0; i < 9; ++i) Rb[i] = Rc[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) tb[i] = tc[i];
#pragma unroll
    for (int i = 0; i < 21; ++i) Hb[i] = tot[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) bv[i] = tot[21 + i];
    cost_b = tot[27];
    lam = 1e-4f;
    lm_step(Hb, bv, 1e-4f, Rb, tb, Rc, tc);
    for (int it = 0; it < num_iter; ++it) {
      eval_pass(use_huber, false, tot);  // at the trial pose
      const bool accept = tot[27] < cost_b;
      if (accept) {
#pragma unroll
        for (int i = 0; i < 9; ++i) Rb[i] = Rc[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) tb[i] = tc[i];
#pragma unroll
        for (int i = 0; i < 21; ++i) Hb[i] = tot[i];
#pragma unroll
        for (int i = 0; i < 6; ++i) bv[i] = tot[21 + i];
        cost_b = tot[27];
      }
      lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-9f), 1e6f);
      lm_step(Hb, bv, lam, Rb, tb, Rc, tc);
    }
    // the round ends at its best pose
#pragma unroll
    for (int i = 0; i < 9; ++i) Rc[i] = Rb[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) tc[i] = tb[i];
  }
  // the last classification at the final pose, with the chi-square values
  {
    uint8_t* inlier = bt.inlier + (long long)prob * N;
    float* chi2_out = bt.chi2 + (long long)prob * N;
    for (int j = tid; j < n_loc; j += kThreads) {
      const float4 a = sA[j], b4 = sB[j];
      const float p[3] = {a.x, a.y, a.z};
      float r[3], J[3][6], dof[3];
      bool depth_ok;
      residual<MODEL>(Rc, tc, p, b4.x, b4.y, b4.z, cam, r, J, dof, depth_ok);
      const float chi2 = (r[0] * r[0] * dof[0] + r[1] * r[1] * dof[1] + r[2] * r[2] * dof[2]) * a.w;
      const uint8_t f = sF[j];
      const bool in = num_rounds > 0
                          ? (f & kValid) && depth_ok && chi2 <= (b4.z > 0.f ? 7.815f : 5.991f)
                          : (f & kValid) != 0;
      inlier[base + j] = in ? 1 : 0;
      chi2_out[base + j] = chi2;
    }
  }
  if (rank == 0 && tid == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) bt.R_out[prob * 9 + i] = Rc[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) bt.t_out[prob * 3 + i] = tc[i];
  }
  // no block leaves while a peer may still read its partials
  cluster.sync();
}

template <int MODEL>
cudaError_t launch(int B, int N, const Batch& bt, const Cam& cam, int rounds, int robust,
                   int iters, cudaStream_t st) {
  const int chunk = (N + kCluster - 1) / kCluster;
  if (chunk > kMaxSlotsPerBlock) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kPartFloats + (size_t)chunk * kSlotBytes;
  auto kernel = pose_lm_kernel<MODEL>;
  const cudaError_t e = svt::reserve_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, N, chunk, bt, cam, rounds, robust, iters);
}

}  // namespace

// model: 0 perspective, 2 equirectangular (camera.cuh); the *_bs arguments
// are batch strides in elements (0: the tensor is shared by every problem)
extern "C" int svt_pose_lm(int model, int B, int N, const float* pos,
                           long long pos_bs, const float* uv, long long uv_bs, const float* xr,
                           long long xr_bs, const float* inv_sig, long long isg_bs,
                           const uint8_t* valid, long long valid_bs, const float* R0,
                           const float* t0, float fx, float fy, float cx, float cy, float fxb,
                           float width, float height, int num_rounds, int num_robust,
                           int num_iter, float* R_out, float* t_out, uint8_t* inlier,
                           float* chi2_out, void* stream) {
  if (B < 1 || N < 0) return (int)cudaErrorInvalidValue;
  Cam cam{fx, fy, cx, cy, fxb, width, height};
  Batch bt{pos, pos_bs, uv, uv_bs, xr, xr_bs, inv_sig, isg_bs, valid, valid_bs,
           R0, t0, R_out, t_out, inlier, chi2_out};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (model == svt_cam::kEquirect)
    e = launch<svt_cam::kEquirect>(B, N, bt, cam, num_rounds, num_robust, num_iter, s);
  else if (model == svt_cam::kPerspective)
    e = launch<svt_cam::kPerspective>(B, N, bt, cam, num_rounds, num_robust, num_iter, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
