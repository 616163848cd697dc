// Kernels F, G, H, I: one Levenberg-Marquardt iteration of Schur-complement
// bundle adjustment in three launches, with the accept / reject decision and
// the damping update kept on the device; kernel I: the chi-square
// classification between the two stages and after the last.
//
// Replaces the iteration body of stella_vslam_tpu/ops/optim/ba.py
// bundle_adjust (:739): _pose_rows (:294), _row_weights (:389), _linearize
// (:416), _sym3_inv (:512), _solve_schur (:610, with linalg.py
// solve_spd_blocked :72) and _total_cost (:731), and its reclassification
// and final outlier flags (:786-799). The TPU form is a lane-major
// program over [L,D] arrays whose camera-side sums are one-hot [N,K] matmuls
// and whose Schur product is one [6K,3L] @ [3L,6K] matmul.
//
//  F ba_linearize_kernel (grid over landmarks, one thread per landmark):
//    residual rows and Jacobians of the landmark's D observations at the
//    current state, Huber or plain weights, the cost, Hcc / b_c per camera,
//    Hpp / b_p and W = Jc^T w Jp per observation, the damped inverse
//    G = (Hpp + damp)^-1 (_sym3_inv), and the Schur terms
//    S_red[k_d, k_e] += W_d G W_e^T, rhs_red[k_d] += W_d G b_p. Sums go into
//    a block-local copy of the camera-side system in shared memory, then into
//    device memory with one atomic per nonzero entry per block; where that
//    copy does not fit a block's shared memory (K > 39, the global BA's
//    buckets), the Schur terms are added straight into device memory and only
//    Hcc, b_c, the right-hand side and the cost keep a block-local copy. Within a
//    warp whose landmarks all observe the same camera pair (every landmark of
//    the two-keyframe init BA does), the terms are first summed by shuffles.
//  G ba_solve_kernel (one block): damps Hcc, masks fixed and invalid
//    cameras, solves the 6K x 6K reduced system by Cholesky, forms the trial
//    camera poses Exp(dx) * T, and clears the accumulators for the next F.
//    Up to 6K = 192 the system sits in shared memory; above (the global BA)
//    it is factored in a device-memory scratch by the same right-looking
//    Cholesky with 1024 threads (the 590 KB of a K = 64 system stay in L2) and
//    the two triangular solves run column by column across the block.
//  H ba_backsub_kernel (grid over landmarks): back-substitutes each point
//    update, evaluates the trial cost, and the last block to finish (a
//    fence-and-counter handshake) compares it with F's cost: it accepts or
//    rejects the trial state, halves or quadruples lambda, sets the
//    gain < 1e-3 stop flag, and every later F, G and H launch of the stage
//    returns at once when the flag is set. The LM loop needs no host read.
//  I ba_classify_kernel (grid over observations): chi-square and depth at
//    the committed state, as the second stage's inlier mask or the final
//    outlier flags. Bound by its bytes (~25 per observation).
// Bound: at init size (K = 2, L = 4096, D = 2) an iteration moves ~0.7 MB
// (the problem, the per-observation W blocks and the trial state) and does
// ~5 MFLOP, so it is bound by latency: three dependent launches and G's
// serial column loop. The design keeps every per-observation intermediate
// in registers, writes only W (6x3 per observation) for H, and reduces the
// camera-side sums on chip before touching device memory.
//
// Atomics sum in an order that changes from run to run, so the result is
// deterministic only to float32 rounding: the chip check holds a whole BA
// to the plain version on synthetic problems (poses within 1e-4, points
// seen twice within 1e-3), and each kernel to its plain version on the same
// inputs on the map slice's local problems, whose reduced systems are too
// ill-conditioned for a whole-BA bound at float32 rounding.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kChi2D = 5.991f;
constexpr float kChi3D = 7.815f;
constexpr int kThreadsLm = 128;
constexpr int kThreadsSolve = 512;
constexpr int kThreadsSolveGlobal = 1024;
constexpr int kSolveSharedDim = 192;        // largest 6K factored in shared memory
constexpr size_t kMaxBlockSmem = 232448;     // 227 KB, the most a block can opt into

// ctrl[] slots
constexpr int kCost0 = 0;  // cost at the linearization point (F)
constexpr int kCost1 = 1;  // trial cost (H)
constexpr int kLam = 2;
constexpr int kDone = 3;
constexpr int kLastCost = 4;

struct Cam {
  float fx, fy, cx, cy, fxb;
};

struct Problem {
  int K, L, D;
  const int* obs_cam;       // [L,D]
  const float* obs_uv;      // [L,D,2]
  const float* obs_xr;      // [L,D]
  const float* obs_isig;    // [L,D]
  const uint8_t* obs_valid; // [L,D]
  const uint8_t* inlier;    // [L,D]
  const uint8_t* lm_valid;  // [L]
  const uint8_t* lm_fixed;  // [L] or null
  const float* cam_free;    // [K] 1 = optimised
};

// One observation projected at a state: camera-frame point, residual rows
// (row 2 the stereo row, counted when hs = 1), chi-square and its threshold.
struct ObsResidual {
  float x, y, z, iz, r[3], hs, sq, chi2, thr;
  bool depth_ok;
};

__device__ __forceinline__ void obs_residual(const Problem& P, const Cam& c, const float* R,
                                             const float* t, const float* p, int od,
                                             ObsResidual& q) {
  q.x = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + t[0];
  q.y = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + t[1];
  q.z = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + t[2];
  const float zs = fabsf(q.z) < 1e-6f ? 1e-6f : q.z;
  q.iz = 1.f / zs;
  const float u = c.fx * q.x * q.iz + c.cx;
  const float v = c.fy * q.y * q.iz + c.cy;
  const float ur = u - c.fxb * q.iz;
  const float xr = P.obs_xr[od];
  q.hs = xr > 0.f ? 1.f : 0.f;
  q.r[0] = u - P.obs_uv[2 * od];
  q.r[1] = v - P.obs_uv[2 * od + 1];
  q.r[2] = ur - xr;
  q.depth_ok = q.z > 1e-4f;
  q.sq = q.r[0] * q.r[0] + q.r[1] * q.r[1] + q.r[2] * q.r[2] * q.hs;
  q.chi2 = q.sq * P.obs_isig[od];
  q.thr = xr > 0.f ? kChi3D : kChi2D;
}

// One observation's residual rows, Jacobians and row weights.
struct ObsTerms {
  float r[3], Jc[3][6], Jp[3][3], wr[3], w_base, sq_w;
  bool active;
};

__device__ __forceinline__ void obs_terms(const Problem& P, const Cam& c, const float* R,
                                          const float* t, const float* p, int l, int d,
                                          bool use_huber, ObsTerms& o) {
  const int od = l * P.D + d;
  ObsResidual res;
  obs_residual(P, c, R, t, p, od, res);
  const float x = res.x, y = res.y, z = res.z, iz = res.iz, iz2 = iz * iz, hs = res.hs;
  for (int i = 0; i < 3; ++i) o.r[i] = res.r[i];
  const bool on = P.obs_valid[od] && P.inlier[od] && res.depth_ok && P.lm_valid[l];
  o.w_base = on ? P.obs_isig[od] : 0.f;
  const float sq = res.sq, chi2 = res.chi2, thr = res.thr;
  const float chi = sqrtf(fmaxf(chi2, 1e-12f));
  const float sthr = sqrtf(thr);
  const float hw = (use_huber && chi > sthr) ? sthr / chi : 1.f;
  const float w = o.w_base * hw;
  o.sq_w = w * sq;
  o.wr[0] = w;
  o.wr[1] = w;
  o.wr[2] = w * hs;
  o.active = o.w_base != 0.f;
  const float dpi[3][3] = {{c.fx * iz, 0.f, -c.fx * x * iz2},
                           {0.f, c.fy * iz, -c.fy * y * iz2},
                           {c.fx * iz, 0.f, -c.fx * x * iz2 + c.fxb * iz2}};
  // hat(Xc) = [[0,-z,y],[z,0,-x],[-y,x,0]]; rotation block = -dpi @ hat
  const float h[3][3] = {{0.f, -z, y}, {z, 0.f, -x}, {-y, x, 0.f}};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o.Jc[q][j] = dpi[q][j];
      o.Jc[q][3 + j] = -(dpi[q][0] * h[0][j] + dpi[q][1] * h[1][j] + dpi[q][2] * h[2][j]);
      o.Jp[q][j] = dpi[q][0] * R[0 + j] + dpi[q][1] * R[3 + j] + dpi[q][2] * R[6 + j];
    }
  }
}

// damped symmetric 3x3 inverse (6 unique entries: 00 01 02 11 12 22)
__device__ __forceinline__ void sym3_inv(const float* H, float lam, float* G) {
  const float tr = H[0] + H[3] + H[5];
  const float damp = lam * fmaxf(tr / 3.f, 1e-6f) + 1e-7f;
  const float a = H[0] + damp, b = H[1], c = H[2], d = H[3] + damp, e = H[4], f = H[5] + damp;
  const float A00 = d * f - e * e, A01 = c * e - b * f, A02 = b * e - c * d;
  const float A11 = a * f - c * c, A12 = b * c - a * e, A22 = a * d - b * b;
  const float det = a * A00 + b * A01 + c * A02;
  const float idet = fabsf(det) < 1e-18f ? 0.f : 1.f / det;
  G[0] = A00 * idet; G[1] = A01 * idet; G[2] = A02 * idet;
  G[3] = A11 * idet; G[4] = A12 * idet; G[5] = A22 * idet;
}

__device__ __forceinline__ float sym_get(const float* G, int i, int j) {
  const int a = min(i, j), b = max(i, j);
  // 00 01 02 11 12 22
  return G[a == 0 ? b : (a == 1 ? 2 + b : 5)];
}

// Adds N values at shared[base + i] for this lane's key (-1: nothing). When
// every contributing lane of the warp shares one key, the values are summed
// by shuffles first and lane 0 adds them once, at the base of a lane that
// holds the key (lane 0's own may belong to no key: a padded observation).
template <int NV>
__device__ __forceinline__ void warp_accumulate(float* shared, int key, int base,
                                                const float (&v)[NV]) {
  const int lane = threadIdx.x & 31;
  const int lead = __reduce_max_sync(0xffffffffu, key);
  if (lead < 0) return;
  const bool uniform = __all_sync(0xffffffffu, key < 0 || key == lead);
  if (uniform) {
    const int src = __ffs(__ballot_sync(0xffffffffu, key == lead)) - 1;
    const int lead_base = __shfl_sync(0xffffffffu, base, src);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = key < 0 ? 0.f : v[i];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0 && s != 0.f) atomicAdd(&shared[lead_base + i], s);
    }
  } else if (key >= 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (v[i] != 0.f) atomicAdd(&shared[base + i], v[i]);
  }
}

__global__ void __launch_bounds__(kThreadsLm)
ba_linearize_kernel(Problem P, Cam cam, const float* __restrict__ cam_R,
                    const float* __restrict__ cam_t, const float* __restrict__ lm,
                    int use_huber, float* __restrict__ ctrl, float* __restrict__ Wg,
                    float* __restrict__ lmblk, float* __restrict__ hc_g,
                    float* __restrict__ S_g, float* __restrict__ rhs_g, int s_direct) {
  if (ctrl[kDone] != 0.f) return;
  extern __shared__ float sm[];
  const int K = P.K, n6 = 6 * P.K;
  float* hc_s = sm;               // [K,27]: 21 upper Hcc + 6 b_c
  float* rhs_s = hc_s + 27 * K;   // [6K]
  float* cost_s = rhs_s + n6;     // [1]
  // [6K,6K]: the block's copy, or the device-memory system itself
  float* S_s = s_direct ? S_g : cost_s + 1;
  const int total = 27 * K + n6 + 1 + (s_direct ? 0 : n6 * n6);
  for (int i = threadIdx.x; i < total; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  const float lam = ctrl[kLam];
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = l < P.L;
  float p[3] = {0.f, 0.f, 0.f};
  if (mine)
    for (int j = 0; j < 3; ++j) p[j] = lm[3 * l + j];
  float Hpp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, bp[3] = {0.f, 0.f, 0.f};
  float cost = 0.f, wsum = 0.f;
  // pass 1: per-observation terms; camera-side sums; W kept for H
  for (int d = 0; d < P.D; ++d) {
    ObsTerms o;
    int k = 0;
    if (mine) {
      k = P.obs_cam[l * P.D + d];
      obs_terms(P, cam, cam_R + 9 * k, cam_t + 3 * k, p, l, d, use_huber != 0, o);
    } else {
      o.active = false;
      o.sq_w = 0.f;
      o.w_base = 0.f;
    }
    cost += o.sq_w;
    wsum += o.w_base;
    float hc[27];
    float W[18];
    if (o.active) {
      int q = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) {
          float s = 0.f;
          for (int r = 0; r < 3; ++r) s += o.wr[r] * o.Jc[r][i] * o.Jc[r][j];
          hc[q++] = s;
        }
      for (int i = 0; i < 6; ++i) {
        float s = 0.f;
        for (int r = 0; r < 3; ++r) s += o.wr[r] * o.Jc[r][i] * o.r[r];
        hc[21 + i] = s;
      }
      q = 0;
      for (int i = 0; i < 3; ++i)
        for (int j = i; j < 3; ++j) {
          float s = 0.f;
          for (int r = 0; r < 3; ++r) s += o.wr[r] * o.Jp[r][i] * o.Jp[r][j];
          Hpp[q++] += s;
        }
      for (int i = 0; i < 3; ++i) {
        float s = 0.f;
        for (int r = 0; r < 3; ++r) s += o.wr[r] * o.Jp[r][i] * o.r[r];
        bp[i] += s;
      }
      for (int i = 0; i < 6; ++i)
        for (int a = 0; a < 3; ++a) {
          float s = 0.f;
          for (int r = 0; r < 3; ++r) s += o.wr[r] * o.Jc[r][i] * o.Jp[r][a];
          W[i * 3 + a] = s;
        }
    } else {
      for (int i = 0; i < 27; ++i) hc[i] = 0.f;
      for (int i = 0; i < 18; ++i) W[i] = 0.f;
    }
    if (mine)
      for (int i = 0; i < 18; ++i) Wg[(l * P.D + d) * 18 + i] = W[i];
    warp_accumulate<27>(hc_s, o.active ? k : -1, 27 * k, hc);
  }
  if (mine) {
    float* blk = lmblk + 10 * l;
    for (int i = 0; i < 6; ++i) blk[i] = Hpp[i];
    for (int i = 0; i < 3; ++i) blk[6 + i] = bp[i];
    blk[9] = wsum > 0.f ? 1.f : 0.f;
  }
  {
    const float c1[1] = {cost};
    warp_accumulate<1>(cost_s, 0, 0, c1);
  }
  // pass 2: Schur terms with G = damped Hpp^-1 (0 for fixed points)
  float G[6];
  sym3_inv(Hpp, lam, G);
  const bool keep = mine && !(P.lm_fixed && P.lm_fixed[l]);
  if (!keep)
    for (int i = 0; i < 6; ++i) G[i] = 0.f;
  for (int d = 0; d < P.D; ++d) {
    float A[18];  // W_d G
    int kd = -1;
    if (keep) {
      const float* Wd = Wg + (l * P.D + d) * 18;
      bool nz = false;
      for (int i = 0; i < 6; ++i)
        for (int a = 0; a < 3; ++a) {
          float s = 0.f;
          for (int b = 0; b < 3; ++b) s += Wd[i * 3 + b] * sym_get(G, b, a);
          A[i * 3 + a] = s;
          nz |= Wd[i * 3 + a] != 0.f;
        }
      if (nz) kd = P.obs_cam[l * P.D + d];
    } else {
      for (int i = 0; i < 18; ++i) A[i] = 0.f;
    }
    float rr[6];
    for (int i = 0; i < 6; ++i)
      rr[i] = A[i * 3 + 0] * bp[0] + A[i * 3 + 1] * bp[1] + A[i * 3 + 2] * bp[2];
    warp_accumulate<6>(rhs_s, kd, 6 * max(kd, 0), rr);
    for (int e = 0; e < P.D; ++e) {
      int ke = -1;
      float blk[36];
      if (kd >= 0) {
        const float* We = Wg + (l * P.D + e) * 18;
        bool nz = false;
        for (int i = 0; i < 6; ++i)
          for (int j = 0; j < 6; ++j) {
            const float s = A[i * 3 + 0] * We[j * 3 + 0] + A[i * 3 + 1] * We[j * 3 + 1] +
                            A[i * 3 + 2] * We[j * 3 + 2];
            blk[i * 6 + j] = s;
            nz |= s != 0.f;
          }
        if (nz) ke = P.obs_cam[l * P.D + e];
      } else {
        for (int i = 0; i < 36; ++i) blk[i] = 0.f;
      }
      // S_red row (kd*6 + i), column (ke*6 + j): scatter as 6 rows of 6
      const int key = ke >= 0 ? kd * K + ke : -1;
      const int kd0 = max(kd, 0), ke0 = max(ke, 0);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float row[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) row[j] = blk[i * 6 + j];
        warp_accumulate<6>(S_s, key, (kd0 * 6 + i) * n6 + ke0 * 6, row);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 27 * K; i += blockDim.x)
    if (hc_s[i] != 0.f) atomicAdd(&hc_g[i], hc_s[i]);
  if (!s_direct)
    for (int i = threadIdx.x; i < n6 * n6; i += blockDim.x)
      if (S_s[i] != 0.f) atomicAdd(&S_g[i], S_s[i]);
  for (int i = threadIdx.x; i < n6; i += blockDim.x)
    if (rhs_s[i] != 0.f) atomicAdd(&rhs_g[i], rhs_s[i]);
  if (threadIdx.x == 0) atomicAdd(&ctrl[kCost0], cost_s[0]);
}

// (R, t) <- Exp(xi) * (R, t), xi = [rho, phi] (ops/lie.py se3_exp, se3_compose)
__device__ void se3_left(const float* xi, const float* R, const float* t, float* Rn,
                         float* tn) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  const float a = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / th2;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (th2 * th);
  const float Kh[3][3] = {{0.f, -phi[2], phi[1]}, {phi[2], 0.f, -phi[0]}, {-phi[1], phi[0], 0.f}};
  float K2[3][3], dR[3][3], J[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) K2[i][j] = Kh[i][0] * Kh[0][j] + Kh[i][1] * Kh[1][j] + Kh[i][2] * Kh[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      dR[i][j] = e + a * Kh[i][j] + b * K2[i][j];
      J[i][j] = e + b * Kh[i][j] + c * K2[i][j];
    }
  for (int i = 0; i < 3; ++i) {
    const float dt = J[i][0] * rho[0] + J[i][1] * rho[1] + J[i][2] * rho[2];
    for (int j = 0; j < 3; ++j)
      Rn[i * 3 + j] = dR[i][0] * R[j] + dR[i][1] * R[3 + j] + dR[i][2] * R[6 + j];
    tn[i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] + dt;
  }
}

// kGlobal: the system is factored in the device-memory scratch A_g (n > 192)
template <bool kGlobal>
__global__ void __launch_bounds__(kGlobal ? kThreadsSolveGlobal : kThreadsSolve)
ba_solve_kernel(int K, const float* __restrict__ cam_free, const float* __restrict__ cam_R,
                const float* __restrict__ cam_t, float* __restrict__ ctrl,
                float* __restrict__ hc_g, float* __restrict__ S_g, float* __restrict__ rhs_g,
                float* __restrict__ dx_g, float* __restrict__ cam_Rn, float* __restrict__ cam_tn,
                float* A_g) {
  if (ctrl[kDone] != 0.f) return;
  extern __shared__ float sm[];
  const int n = 6 * K, tid = threadIdx.x;
  float* S = kGlobal ? A_g : sm;         // [n,n]
  float* x = kGlobal ? sm : sm + n * n;  // [n]
  // the device-memory route reads what other threads wrote before a barrier
  // through a volatile pointer: the compiler may otherwise keep an entry it
  // loaded in an earlier column (measured: a wrong factor from the first
  // free column on)
  volatile float* Sv = S;
  const float lam = ctrl[kLam];
  // S = -S_red + blockdiag(Hcc + (lam * max(tr/6, 1e-6) + 1e-7) I), masked
  for (int q = tid; q < n * n; q += blockDim.x) {
    const int i = q / n, j = q % n;
    const int ki = i / 6, kj = j / 6;
    float v = -S_g[q];
    if (ki == kj) {
      const float* hc = hc_g + 27 * ki;
      const int a = min(i % 6, j % 6), b = max(i % 6, j % 6);
      // packed upper index of (a, b)
      const int pu = a * 6 - a * (a - 1) / 2 + (b - a);
      v += hc[pu];
      if (i == j) {
        const float tr = hc[0] + hc[6] + hc[11] + hc[15] + hc[18] + hc[20];
        v += lam * fmaxf(tr / 6.f, 1e-6f) + 1e-7f;
      }
    }
    const float fi = cam_free[ki], fj = cam_free[kj];
    S[q] = v * fi * fj + (i == j ? 1.f - fi : 0.f);
  }
  for (int i = tid; i < n; i += blockDim.x)
    x[i] = (hc_g[27 * (i / 6) + 21 + i % 6] - rhs_g[i]) * cam_free[i / 6];
  __syncthreads();
  // Cholesky, right-looking, lower triangle in place
  for (int j = 0; j < n; ++j) {
    if (tid == 0) S[j * n + j] = sqrtf(fmaxf(kGlobal ? Sv[j * n + j] : S[j * n + j], 1e-20f));
    __syncthreads();
    const float djj = kGlobal ? Sv[j * n + j] : S[j * n + j];
    for (int i = j + 1 + tid; i < n; i += blockDim.x)
      S[i * n + j] = (kGlobal ? Sv[i * n + j] : S[i * n + j]) / djj;
    __syncthreads();
    if (kGlobal) {
      // one warp per row of the trailing lower triangle
      const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
      for (int i = j + 1 + warp; i < n; i += nw) {
        const float lij = Sv[i * n + j];
        for (int c = j + 1 + lane; c <= i; c += 32) Sv[i * n + c] -= lij * Sv[c * n + j];
      }
    } else {
      const int m = n - j - 1;
      for (int q = tid; q < m * m; q += blockDim.x) {
        const int i = j + 1 + q / m, c = j + 1 + q % m;
        if (c <= i) S[i * n + c] -= S[i * n + j] * S[c * n + j];
      }
    }
    __syncthreads();
  }
  if (kGlobal) {
    // L y = rhs, then L^T x = y, column by column across the block
    for (int j = 0; j < n; ++j) {
      if (tid == 0) x[j] /= Sv[j * n + j];
      __syncthreads();
      const float xj = x[j];
      for (int i = j + 1 + tid; i < n; i += blockDim.x) x[i] -= Sv[i * n + j] * xj;
      __syncthreads();
    }
    for (int j = n - 1; j >= 0; --j) {
      if (tid == 0) x[j] /= Sv[j * n + j];
      __syncthreads();
      const float xj = x[j];
      for (int i = tid; i < j; i += blockDim.x) x[i] -= Sv[j * n + i] * xj;
      __syncthreads();
    }
  } else if (tid == 0) {
    // L y = rhs, then L^T x = y (one thread: n <= 192)
    for (int i = 0; i < n; ++i) {
      float v = x[i];
      for (int k = 0; k < i; ++k) v -= S[i * n + k] * x[k];
      x[i] = v / S[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float v = x[i];
      for (int k = i + 1; k < n; ++k) v -= S[k * n + i] * x[k];
      x[i] = v / S[i * n + i];
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    x[i] = -x[i] * cam_free[i / 6];
    dx_g[i] = x[i];
  }
  __syncthreads();
  for (int k = tid; k < K; k += blockDim.x)
    se3_left(x + 6 * k, cam_R + 9 * k, cam_t + 3 * k, cam_Rn + 9 * k, cam_tn + 3 * k);
  // clear the accumulators for the next F
  for (int q = tid; q < n * n; q += blockDim.x) S_g[q] = 0.f;
  for (int q = tid; q < 27 * K; q += blockDim.x) hc_g[q] = 0.f;
  for (int q = tid; q < n; q += blockDim.x) rhs_g[q] = 0.f;
}

__global__ void __launch_bounds__(kThreadsLm)
ba_backsub_kernel(Problem P, Cam cam, float* __restrict__ cam_R, float* __restrict__ cam_t,
                  float* __restrict__ lm, int use_huber, float* __restrict__ ctrl,
                  unsigned int* __restrict__ counter, const float* __restrict__ Wg,
                  const float* __restrict__ lmblk, const float* __restrict__ dx_g,
                  const float* __restrict__ cam_Rn, const float* __restrict__ cam_tn,
                  float* __restrict__ lmn) {
  if (ctrl[kDone] != 0.f) return;
  __shared__ float red[kThreadsLm / 32];
  __shared__ bool last;
  __shared__ bool improved;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float lam = ctrl[kLam];
  float cost = 0.f;
  if (l < P.L) {
    const float* blk = lmblk + 10 * l;
    float G[6];
    sym3_inv(blk, lam, G);
    const bool keep = !(P.lm_fixed && P.lm_fixed[l]);
    const float upd = (P.lm_valid[l] && blk[9] != 0.f && keep) ? 1.f : 0.f;
    float rp[3] = {blk[6], blk[7], blk[8]};
    for (int d = 0; d < P.D; ++d) {
      const float* Wd = Wg + (l * P.D + d) * 18;
      const float* dx = dx_g + 6 * P.obs_cam[l * P.D + d];
      for (int a = 0; a < 3; ++a) {
        float s = 0.f;
        for (int i = 0; i < 6; ++i) s += Wd[i * 3 + a] * dx[i];
        rp[a] += s;
      }
    }
    float pn[3];
    for (int a = 0; a < 3; ++a) {
      const float dp = -(sym_get(G, a, 0) * rp[0] + sym_get(G, a, 1) * rp[1] +
                         sym_get(G, a, 2) * rp[2]) * upd;
      pn[a] = lm[3 * l + a] + dp;
      lmn[3 * l + a] = pn[a];
    }
    for (int d = 0; d < P.D; ++d) {
      const int k = P.obs_cam[l * P.D + d];
      ObsTerms o;
      obs_terms(P, cam, cam_Rn + 9 * k, cam_tn + 3 * k, pn, l, d, use_huber != 0, o);
      cost += o.sq_w;
    }
  }
  for (int o = 16; o > 0; o >>= 1) cost += __shfl_down_sync(0xffffffffu, cost, o);
  if (lane == 0) red[warp] = cost;
  __threadfence();  // this thread's lmn rows, before the counter moves
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreadsLm / 32; ++w) s += red[w];
    atomicAdd(&ctrl[kCost1], s);
    __threadfence();
    const unsigned int prev = atomicInc(counter, gridDim.x - 1);
    last = prev == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's trial cost and lmn are in; decide
  __threadfence();
  if (threadIdx.x == 0) {
    const float c0 = atomicAdd(&ctrl[kCost0], 0.f);
    const float c1 = atomicAdd(&ctrl[kCost1], 0.f);
    const bool imp = c1 < c0;
    const float gain = (c0 - c1) / fmaxf(c0, 1e-12f);
    float lm_ = imp ? lam * 0.5f : lam * 4.f;
    ctrl[kLam] = fminf(fmaxf(lm_, 1e-8f), 1e4f);
    ctrl[kDone] = (imp && gain < 1e-3f) ? 1.f : 0.f;
    ctrl[kLastCost] = c1;
    ctrl[kCost0] = 0.f;
    ctrl[kCost1] = 0.f;
    improved = imp;
  }
  __syncthreads();
  if (!improved) return;
  for (int i = threadIdx.x; i < 9 * P.K; i += blockDim.x) cam_R[i] = __ldcg(cam_Rn + i);
  for (int i = threadIdx.x; i < 3 * P.K; i += blockDim.x) cam_t[i] = __ldcg(cam_tn + i);
  for (int i = threadIdx.x; i < 3 * P.L; i += blockDim.x) lm[i] = __ldcg(lmn + i);
}

// I ba_classify_kernel (grid over observations): chi-square and depth of
// every observation at the committed state. mode 0, the inliers of the
// second stage: chi2 <= thr and depth ok, or the landmark's keep flag;
// mode 1, the final outlier flags: a valid observation with chi2 > thr or
// bad depth.
__global__ void __launch_bounds__(kThreadsLm)
ba_classify_kernel(Problem P, Cam cam, const float* __restrict__ cam_R,
                   const float* __restrict__ cam_t, const float* __restrict__ lm,
                   const uint8_t* __restrict__ keep, int mode, uint8_t* __restrict__ out) {
  const int od = blockIdx.x * blockDim.x + threadIdx.x;
  if (od >= P.L * P.D) return;
  const int l = od / P.D, k = P.obs_cam[od];
  ObsResidual q;
  obs_residual(P, cam, cam_R + 9 * k, cam_t + 3 * k, lm + 3 * l, od, q);
  if (mode == 0)
    out[od] = ((q.chi2 <= q.thr && q.depth_ok) || (keep && keep[l])) ? 1 : 0;
  else
    out[od] = (P.obs_valid[od] && (q.chi2 > q.thr || !q.depth_ok)) ? 1 : 0;
}

size_t linearize_smem(int K, bool s_direct) {
  const size_t n6 = 6 * (size_t)K;
  return sizeof(float) * (27 * K + n6 + 1 + (s_direct ? 0 : n6 * n6));
}

}  // namespace

extern "C" int svt_ba_linearize(int K, int L, int D, const int* obs_cam, const float* obs_uv,
                                const float* obs_xr, const float* obs_isig,
                                const uint8_t* obs_valid, const uint8_t* inlier,
                                const uint8_t* lm_valid, const uint8_t* lm_fixed,
                                const float* cam_free, float fx, float fy, float cx, float cy,
                                float fxb, const float* cam_R, const float* cam_t,
                                const float* lm, int use_huber, float* ctrl, float* Wg,
                                float* lmblk, float* hc, float* S, float* rhs, void* stream) {
  const bool s_direct = linearize_smem(K, false) > kMaxBlockSmem;
  const size_t smem = linearize_smem(K, s_direct);
  cudaFuncSetAttribute(ba_linearize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  Problem P{K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier, lm_valid,
            lm_fixed, cam_free};
  Cam c{fx, fy, cx, cy, fxb};
  const int blocks = (L + kThreadsLm - 1) / kThreadsLm;
  if (blocks > 0)
    ba_linearize_kernel<<<blocks, kThreadsLm, smem, (cudaStream_t)stream>>>(
        P, c, cam_R, cam_t, lm, use_huber, ctrl, Wg, lmblk, hc, S, rhs, s_direct ? 1 : 0);
  return (int)cudaGetLastError();
}

extern "C" int svt_ba_solve(int K, const float* cam_free, const float* cam_R,
                            const float* cam_t, float* ctrl, float* hc, float* S, float* rhs,
                            float* dx, float* cam_Rn, float* cam_tn, float* scratch,
                            void* stream) {
  // scratch: [6K,6K] floats of device memory, read when 6K > 192
  const size_t n = 6 * (size_t)K;
  if (n <= kSolveSharedDim) {
    const size_t smem = sizeof(float) * (n * n + n);
    cudaFuncSetAttribute(ba_solve_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    ba_solve_kernel<false><<<1, kThreadsSolve, smem, (cudaStream_t)stream>>>(
        K, cam_free, cam_R, cam_t, ctrl, hc, S, rhs, dx, cam_Rn, cam_tn, nullptr);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    ba_solve_kernel<true><<<1, kThreadsSolveGlobal, sizeof(float) * n, (cudaStream_t)stream>>>(
        K, cam_free, cam_R, cam_t, ctrl, hc, S, rhs, dx, cam_Rn, cam_tn, scratch);
  }
  return (int)cudaGetLastError();
}

extern "C" int svt_ba_backsub(int K, int L, int D, const int* obs_cam, const float* obs_uv,
                              const float* obs_xr, const float* obs_isig,
                              const uint8_t* obs_valid, const uint8_t* inlier,
                              const uint8_t* lm_valid, const uint8_t* lm_fixed,
                              const float* cam_free, float fx, float fy, float cx, float cy,
                              float fxb, float* cam_R, float* cam_t, float* lm, int use_huber,
                              float* ctrl, unsigned int* counter, const float* Wg,
                              const float* lmblk, const float* dx, const float* cam_Rn,
                              const float* cam_tn, float* lmn, void* stream) {
  Problem P{K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier, lm_valid,
            lm_fixed, cam_free};
  Cam c{fx, fy, cx, cy, fxb};
  const int blocks = (L + kThreadsLm - 1) / kThreadsLm;
  if (blocks > 0)
    ba_backsub_kernel<<<blocks, kThreadsLm, 0, (cudaStream_t)stream>>>(
        P, c, cam_R, cam_t, lm, use_huber, ctrl, counter, Wg, lmblk, dx, cam_Rn, cam_tn, lmn);
  return (int)cudaGetLastError();
}

extern "C" int svt_ba_classify(int K, int L, int D, const int* obs_cam, const float* obs_uv,
                               const float* obs_xr, const float* obs_isig,
                               const uint8_t* obs_valid, float fx, float fy, float cx, float cy,
                               float fxb, const float* cam_R, const float* cam_t,
                               const float* lm, const uint8_t* keep, int mode, uint8_t* out,
                               void* stream) {
  Problem P{K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, nullptr, nullptr, nullptr,
            nullptr};
  Cam c{fx, fy, cx, cy, fxb};
  const int blocks = (L * D + kThreadsLm - 1) / kThreadsLm;
  if (blocks > 0)
    ba_classify_kernel<<<blocks, kThreadsLm, 0, (cudaStream_t)stream>>>(P, c, cam_R, cam_t, lm,
                                                                        keep, mode, out);
  return (int)cudaGetLastError();
}
