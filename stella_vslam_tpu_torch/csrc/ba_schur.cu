// Kernels F, G, H, I: one Levenberg-Marquardt iteration of Schur-complement
// bundle adjustment in four launches, with the accept / reject decision and
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
//  F ba_terms_kernel + ba_schur_sum_kernel + ba_reduce_kernel, over a pair
//    index built once per BA (ba_schur_index_kernel). The terms launch runs
//    a thread per observation: residual rows and Jacobians at the current
//    state, Huber or plain weights, the observation's Hcc / b_c terms and
//    W = Jc^T w Jp (kept for H); one thread per landmark then adds its
//    observations' Hpp / b_p and cost in slot order and forms the damped
//    inverse G = (Hpp + damp)^-1 (_sym3_inv), and each observation's
//    A = W G and W G b_p go to an L2-resident scratch. The sum launch owns
//    every entry of the camera-side system of a 128-landmark chunk with one
//    writer: a thread per (chunk, kd <= ke) pair group of the index adds
//    the group's Schur terms A_d W_e^T in (landmark, d, e) order in
//    registers and writes the 6x6 block and its mirror (S is computed on
//    one triangle), a warp per (chunk, camera) adds Hcc / b_c and
//    rhs_red[k] += W G b_p over the camera's observations in (landmark, d)
//    order, a thread per chunk adds the chunk's cost. Each chunk writes its
//    own partial (or, where the partials would outgrow F_PARTIAL_FLOATS,
//    the chunks c, c + P, ... one sum launch after another into partial
//    c % P), and the reduce kernel adds the partials in order. No barrier
//    and no atomic orders a sum: the same inputs give the same bits on
//    every launch, and landmark shards cut on chunk boundaries give the
//    unsharded partials.
//  G spd_tiled_kernel (svt_ba_solve): damps Hcc, masks fixed and invalid
//    cameras, solves the 6K x 6K reduced system by a panel-blocked Cholesky
//    on 32 x 32 tiles, forms the trial camera poses Exp(dx) * T, and clears
//    the accumulators for the next F. Up to 6K = 192 one block holds the
//    system in shared memory, up to 768 a cluster of 4 or 8 blocks shares
//    it through distributed shared memory, above (K 129 - 512) the tiles
//    sit in a device-memory scratch with one launch per panel phase (the
//    note above spd_tiled_kernel). svt_spd_solve runs the same
//    factorization on a plain SPD system (kernel P's dense solve).
//  H ba_backsub_kernel (a thread per observation, whole blocks per
//    128-landmark chunk): back-substitutes each point update, evaluates the
//    trial cost (each chunk's landmark costs into the chunk's scratch slot,
//    by the chunk's last block), and the block that completes the last
//    chunk (a fence-and-ticket handshake) adds the slots in chunk order and
//    compares the trial cost with F's: it accepts or
//    rejects the trial state, halves or quadruples lambda, sets the
//    gain < 1e-3 stop flag, and every later F, G and H launch of the stage
//    returns at once when the flag is set. The LM loop needs no host read.
//  I ba_classify_kernel (grid over observations): chi-square and depth at
//    the committed state, as the second stage's inlier mask or the final
//    outlier flags. Bound by its bytes (~25 per observation).
// Bound: at init size (K = 2, L = 4096, D = 2) an iteration moves ~0.7 MB
// (the problem, the per-observation W blocks and the trial state) and does
// ~5 MFLOP, so it is bound by latency: F's three dependent launches and
// its reduce, G's chain of dependent panels, H. F spreads its work over the
// card (a thread per observation, then per pair group) where its parent ran
// one thread per landmark on 32 SMs with a block barrier per Schur block;
// its per-observation terms (~10 MB at the local shape) stay in L2.
//
//  W ba_reduce_kernel and ba_decide_kernel (K22, the landmark-sharded global
//    BA; replaces the psums of stella_vslam_tpu/parallel/sharded_ba.py
//    :158-162 and the all-reduces GSPMD inserts into bundle_adjust): the
//    landmark rows are cut into shards on whole 128-landmark chunks, each
//    with its own replica of the cameras and ctrl, on its own device or
//    several on one. F's first launch and H's first launch run per shard;
//    W's reduce mode, on every shard's device, adds every shard's F
//    partials in (shard, block) order into its replica of Hcc / b_c, the
//    reduced system and the cost (F's own second launch is the one-shard
//    case of the same kernel); G runs on each replica on identical inputs;
//    W's decide mode adds every shard's H trial costs in (shard, block)
//    order, takes H's accept / reject on its replica's ctrl, and commits its
//    camera replica and its own shard's points. Shards on chunk boundaries
//    reduced in that order perform the unsharded BA's float additions in the
//    same order, so the result equals the unsharded one bit for bit wherever
//    F's block count is not cut. A device reads the other shards' partials
//    through peer access (over NVLink between cards, plain loads on one
//    card): no staging copy and no collective library, since one process
//    drives every shard and the fixed order is what makes the sum equal.
//    Bound by the bytes it reads: every shard's partials, once per device.
//
// F, H and I are templated on the camera model (perspective, or the
// equirectangular rows of ba.py :322-335 with camera.cuh's 2x3 Jacobian and
// no stereo row, :398-403); G does not depend on it.
//
// Every sum runs in an order fixed by the index and the launch shape (F's
// groups and chunks, H's chunks), so a launch is bit-for-bit repeatable. The chip check
// holds a whole BA to the plain version on synthetic problems (poses within
// 1e-4, points seen twice within 1e-3), each kernel to its plain version on
// the same inputs on the map slice's local problems, whose reduced systems
// are too ill-conditioned for a whole-BA bound at float32 rounding, and F
// and H against themselves (two launches, equal bits).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#include "camera.cuh"
#include "smem_limit.cuh"

namespace {

constexpr float kChi2D = 5.991f;
constexpr float kChi3D = 7.815f;
constexpr int kThreadsLm = 128;
constexpr int kThreadsSolve = 512;
constexpr int kSolveSharedDim = 192;        // largest n factored by one block
constexpr size_t kMaxBlockSmem = 232448;     // 227 KB, the most a block can opt into

using svt::reserve_smem;  // smem_limit.cuh

// ctrl[] slots
constexpr int kCost0 = 0;  // cost at the linearization point (F)
constexpr int kCost1 = 1;  // trial cost (H)
constexpr int kLam = 2;
constexpr int kDone = 3;
constexpr int kLastCost = 4;

struct Cam {
  float fx, fy, cx, cy, fxb, width, height;
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

// The partials of every shard of a sharded BA, in shard order: for F's,
// each shard's block count; for H's, each shard's trial-cost slots (kernel
// parameters, so that no device table needs copying per launch).
constexpr int kMaxShards = 64;
struct ShardParts {
  const float* ptr[kMaxShards];
  int blocks[kMaxShards];
  int count;
};

// One observation projected at a state: residual rows (row 2 the stereo
// row, counted when hs = 1; none for the equirectangular model), d(pi)/d(Xc),
// chi-square and its threshold.
struct ObsResidual {
  float x, y, z, r[3], dpi[3][3], hs, sq, chi2, thr;
  bool depth_ok;
};

template <int MODEL>
__device__ __forceinline__ void obs_residual(const Problem& P, const Cam& c, const float* R,
                                             const float* t, const float* p, int od,
                                             ObsResidual& q) {
  q.x = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + t[0];
  q.y = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + t[1];
  q.z = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + t[2];
  const float xr = P.obs_xr[od];
  if constexpr (MODEL == svt_cam::kEquirect) {
    float re[2], de[2][3];
    q.depth_ok = svt_cam::equirect_residual(q.x, q.y, q.z, P.obs_uv[2 * od],
                                            P.obs_uv[2 * od + 1], c.cx, c.cy, c.width,
                                            c.height, re, de);
    q.hs = 0.f;
    q.r[0] = re[0];
    q.r[1] = re[1];
    q.r[2] = 0.f;
    for (int j = 0; j < 3; ++j) {
      q.dpi[0][j] = de[0][j];
      q.dpi[1][j] = de[1][j];
      q.dpi[2][j] = 0.f;
    }
    q.sq = q.r[0] * q.r[0] + q.r[1] * q.r[1];
  } else {
    const float zs = fabsf(q.z) < 1e-6f ? 1e-6f : q.z;
    const float iz = 1.f / zs, iz2 = iz * iz;
    const float u = c.fx * q.x * iz + c.cx;
    const float v = c.fy * q.y * iz + c.cy;
    const float ur = u - c.fxb * iz;
    q.hs = xr > 0.f ? 1.f : 0.f;
    q.r[0] = u - P.obs_uv[2 * od];
    q.r[1] = v - P.obs_uv[2 * od + 1];
    q.r[2] = ur - xr;
    q.depth_ok = q.z > 1e-4f;
    q.sq = q.r[0] * q.r[0] + q.r[1] * q.r[1] + q.r[2] * q.r[2] * q.hs;
    const float x = q.x, y = q.y;
    const float d[3][3] = {{c.fx * iz, 0.f, -c.fx * x * iz2},
                           {0.f, c.fy * iz, -c.fy * y * iz2},
                           {c.fx * iz, 0.f, -c.fx * x * iz2 + c.fxb * iz2}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) q.dpi[i][j] = d[i][j];
  }
  q.chi2 = q.sq * P.obs_isig[od];
  q.thr = xr > 0.f ? kChi3D : kChi2D;
}

// One observation's residual rows, Jacobians and row weights.
struct ObsTerms {
  float r[3], Jc[3][6], Jp[3][3], wr[3], w_base, sq, sq_w;
  bool active;
};

template <int MODEL>
__device__ __forceinline__ void obs_terms(const Problem& P, const Cam& c, const float* R,
                                          const float* t, const float* p, int l, int d,
                                          bool use_huber, ObsTerms& o) {
  const int od = l * P.D + d;
  ObsResidual res;
  obs_residual<MODEL>(P, c, R, t, p, od, res);
  const float x = res.x, y = res.y, z = res.z, hs = res.hs;
  for (int i = 0; i < 3; ++i) o.r[i] = res.r[i];
  const bool on = P.obs_valid[od] && P.inlier[od] && res.depth_ok && P.lm_valid[l];
  o.w_base = on ? P.obs_isig[od] : 0.f;
  const float sq = res.sq, chi2 = res.chi2, thr = res.thr;
  const float chi = sqrtf(fmaxf(chi2, 1e-12f));
  const float sthr = sqrtf(thr);
  const float hw = (use_huber && chi > sthr) ? sthr / chi : 1.f;
  const float w = o.w_base * hw;
  o.sq = sq;
  o.sq_w = w * sq;
  o.wr[0] = w;
  o.wr[1] = w;
  o.wr[2] = w * hs;
  o.active = o.w_base != 0.f;
  const float(&dpi)[3][3] = res.dpi;
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

constexpr unsigned kFull = 0xffffffffu;

// per-chunk partial of F, in floats: Hcc / b_c [27K], rhs [6K], cost [1],
// S [6K, 6K]
__host__ __device__ __forceinline__ size_t f_partial_size(int K) {
  return 33 * (size_t)K + 1 + 36 * (size_t)K * K;
}

// ---------------------------------------------------------------------------
// F: the terms launch, the Schur-sum launch and the pair index (the note at
// the top of the file)
// ---------------------------------------------------------------------------
constexpr int kLmF1 = 8;             // landmarks per block of F's terms launch
constexpr int kThreadsF1 = 128;
constexpr int kThreadsF2 = 128;
constexpr int kThreadsIdx = 1024;    // the index build: one block per chunk
constexpr int kIdxWarps = kThreadsIdx / 32;
constexpr int kHcr = 33;             // per observation: 21 upper Hcc, 6 b_c, 6 W G b_p
constexpr int kObsStage = 11;        // per observation in F1's shared memory: Hpp, b_p, cost, w

// F's pair index, built once per BA (ba_schur_index_kernel). Per 128-landmark
// chunk c: the pair terms (l*D + d, l*D + e) of every landmark that is not
// fixed and every two valid observations with cam_d <= cam_e, grouped by
// (cam_d, cam_e) and in (l, d, e) order within a group, at c * cap_t; the
// groups (start, end, kd, ke; absolute term indices) at c * cap_s, nseg[c]
// of them; the valid observations l*D + d grouped by camera in (l, d)
// order at c * 128 * D, camera k's run at cam_seg[c * K + k].
struct SchurIndex {
  int2* terms;
  int4* seg;
  int* nseg;
  int* nterm;
  int* cam_obs;
  int2* cam_seg;
  long long cap_t;
  int cap_s;
};

// F's per-observation scratch: A = W G [L*D, 18], the camera-side terms
// [L*D, kHcr], and each landmark's cost [L].
struct SchurScratch {
  float* A;
  float* hcr;
  float* cost;
};

// F's first launch (kLmF1 landmarks a block, a thread per observation):
// residual rows, Jacobians and weights, each observation's Hcc / b_c terms
// and W (kept for H), Hpp / b_p and the cost summed over the landmark's
// observations in slot order by one thread a landmark, G = (Hpp + damp)^-1
// (0 for fixed points), then each observation's A = W G and W G b_p. The
// block's rows of W, of the camera-side terms and of A are contiguous in
// device memory: they are built in shared memory and written out by the
// whole block, neighbouring threads on neighbouring floats. Also clears
// the part_floats floats of partials that the sum launches add into.
template <int MODEL>
__global__ void __launch_bounds__(kThreadsF1)
ba_terms_kernel(Problem P, Cam cam, const float* __restrict__ cam_R,
                const float* __restrict__ cam_t, const float* __restrict__ lm, int use_huber,
                const float* __restrict__ ctrl, float* __restrict__ Wg,
                float* __restrict__ lmblk, SchurScratch X, float* __restrict__ part,
                long long part_floats) {
  if (ctrl[kDone] != 0.f) return;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < part_floats;
       i += (long long)gridDim.x * blockDim.x)
    part[i] = 0.f;
  extern __shared__ float sm[];
  const int D = P.D, l0 = blockIdx.x * kLmF1, n = kLmF1 * D;
  float* st = sm;                    // [n][kObsStage]: Hpp, b_p, cost, w
  float* sW = st + n * kObsStage;    // [n][18]
  float* sH = sW + n * 18;           // [n][kHcr]
  float* sA = sH + n * kHcr;         // [n][18]
  float* lmt = sA + n * 18;          // [kLmF1][9]: G, b_p
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int l = l0 + o / D, d = o - (o / D) * D;
    float* s = st + o * kObsStage;
    float* hc = sH + o * kHcr;
    float* W = sW + o * 18;
    for (int i = 0; i < kObsStage; ++i) s[i] = 0.f;
    for (int i = 0; i < kHcr; ++i) hc[i] = 0.f;
    for (int i = 0; i < 18; ++i) W[i] = 0.f;
    if (l >= P.L) continue;
    const int od = l * D + d, k = P.obs_cam[od];
    // a padded slot (or a slot of an invalid landmark) weighs 0: its terms
    // are zeros, as obs_terms would give them, without its projection
    if (!P.obs_valid[od] || !P.lm_valid[l]) continue;
    const float p[3] = {lm[3 * l], lm[3 * l + 1], lm[3 * l + 2]};
    ObsTerms ob;
    obs_terms<MODEL>(P, cam, cam_R + 9 * k, cam_t + 3 * k, p, l, d, use_huber != 0, ob);
    s[9] = ob.sq_w;
    s[10] = ob.w_base;
    if (!ob.active) continue;
    int q = 0;
    for (int i = 0; i < 6; ++i)
      for (int j = i; j < 6; ++j) {
        float v = 0.f;
        for (int r = 0; r < 3; ++r) v += ob.wr[r] * ob.Jc[r][i] * ob.Jc[r][j];
        hc[q++] = v;
      }
    for (int i = 0; i < 6; ++i) {
      float v = 0.f;
      for (int r = 0; r < 3; ++r) v += ob.wr[r] * ob.Jc[r][i] * ob.r[r];
      hc[21 + i] = v;
    }
    q = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = i; j < 3; ++j) {
        float v = 0.f;
        for (int r = 0; r < 3; ++r) v += ob.wr[r] * ob.Jp[r][i] * ob.Jp[r][j];
        s[q++] = v;
      }
    for (int i = 0; i < 3; ++i) {
      float v = 0.f;
      for (int r = 0; r < 3; ++r) v += ob.wr[r] * ob.Jp[r][i] * ob.r[r];
      s[6 + i] = v;
    }
    for (int i = 0; i < 6; ++i)
      for (int a = 0; a < 3; ++a) {
        float v = 0.f;
        for (int r = 0; r < 3; ++r) v += ob.wr[r] * ob.Jc[r][i] * ob.Jp[r][a];
        W[i * 3 + a] = v;
      }
  }
  __syncthreads();
  if (threadIdx.x < kLmF1) {
    const int t = threadIdx.x, l = l0 + t;
    float Hpp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, bp[3] = {0.f, 0.f, 0.f};
    float cost = 0.f, wsum = 0.f;
    for (int d = 0; d < D; ++d) {
      const float* s = st + (t * D + d) * kObsStage;
      for (int q = 0; q < 6; ++q) Hpp[q] += s[q];
      for (int q = 0; q < 3; ++q) bp[q] += s[6 + q];
      cost += s[9];
      wsum += s[10];
    }
    float G[6];
    sym3_inv(Hpp, ctrl[kLam], G);
    const bool keep = l < P.L && !(P.lm_fixed && P.lm_fixed[l]);
    for (int q = 0; q < 6; ++q) lmt[t * 9 + q] = keep ? G[q] : 0.f;
    for (int q = 0; q < 3; ++q) lmt[t * 9 + 6 + q] = bp[q];
    if (l < P.L) {
      float* blk = lmblk + 10 * l;
      for (int i = 0; i < 6; ++i) blk[i] = Hpp[i];
      for (int i = 0; i < 3; ++i) blk[6 + i] = bp[i];
      blk[9] = wsum > 0.f ? 1.f : 0.f;
      X.cost[l] = cost;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const float* g = lmt + (o / D) * 9;
    const float* W = sW + o * 18;
    float* A = sA + o * 18;
    for (int i = 0; i < 6; ++i)
      for (int a = 0; a < 3; ++a) {
        float v = 0.f;
        for (int b = 0; b < 3; ++b) v += W[i * 3 + b] * sym_get(g, b, a);
        A[i * 3 + a] = v;
      }
    for (int i = 0; i < 6; ++i)
      sH[o * kHcr + 27 + i] = A[i * 3 + 0] * g[6] + A[i * 3 + 1] * g[7] + A[i * 3 + 2] * g[8];
  }
  __syncthreads();
  // the block's rows, [l0 * D, (l0 + rows) * D), written out contiguously
  const int rows = min(kLmF1, P.L - l0) * D;
  const size_t o0 = (size_t)l0 * D;
  for (int i = threadIdx.x; i < rows * 18; i += blockDim.x) {
    Wg[o0 * 18 + i] = sW[i];
    X.A[o0 * 18 + i] = sA[i];
  }
  for (int i = threadIdx.x; i < rows * kHcr; i += blockDim.x) X.hcr[o0 * kHcr + i] = sH[i];
}

// Recursive halving across the warp: lane L ends with the sum over the
// lanes of v[L] (v[32] in, the lane's share in v[0] out; 31 shuffles, each
// pair of lanes adding in one fixed order).
// (one halving step per template instance, so that every index is a
// constant and v stays in registers)
template <int O>
__device__ __forceinline__ void halve(float (&v)[32], bool up) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

__device__ __forceinline__ float warp_reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  halve<16>(v, (lane & 16) != 0);
  halve<8>(v, (lane & 8) != 0);
  halve<4>(v, (lane & 4) != 0);
  halve<2>(v, (lane & 2) != 0);
  halve<1>(v, (lane & 1) != 0);
  return v[0];
}

// the sum over the warp of one value, in every lane
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// F's sum launch over the chunks c0 .. c0 + nc - 1, each into its partial
// c % nparts (cleared by the terms launch; chunks of one partial come in
// later launches, so every entry has one writer at a time). Warps
// [0, nc * cap_s): a warp per (chunk, pair group), lane j adding the
// group's Schur terms A_d W_e^T j, j + 32, ... in order in registers, the
// lanes' sums then added across the warp in a fixed pattern
// (warp_reduce_scatter32 for the block's first 32 entries, warp_allsum for
// the last 4); the 6x6 block goes to (kd, ke) and, for kd < ke, its
// transpose to (ke, kd). Warps [nc * cap_s, + nc * K): a warp per (chunk,
// camera), the same over its observations' 33 values (Hcc / b_c, then
// W G b_p). The rest: a thread per chunk adds its landmarks' costs in
// order. nb_pair and nb_cam count the blocks of the first two parts.
__global__ void __launch_bounds__(kThreadsF2)
ba_schur_sum_kernel(int K, int L, SchurIndex I, int c0, int nc, int nparts, int nb_pair,
                    int nb_cam, const float* __restrict__ A, const float* __restrict__ Wg,
                    const float* __restrict__ hcr, const float* __restrict__ cost_l,
                    const float* __restrict__ ctrl, float* __restrict__ part) {
  if (ctrl[kDone] != 0.f) return;
  const size_t psize = f_partial_size(K);
  const size_t n6 = 6 * (size_t)K;
  const int lane = threadIdx.x & 31;
  int b = blockIdx.x;
  if (b < nb_pair) {
    const long long item = (long long)b * (kThreadsF2 / 32) + (threadIdx.x >> 5);
    const int cr = (int)(item / I.cap_s), s = (int)(item - (long long)cr * I.cap_s);
    if (cr >= nc) return;
    const int c = c0 + cr;
    if (s >= I.nseg[c]) return;
    const int4 sg = I.seg[(size_t)c * I.cap_s + s];
    float acc[36];
#pragma unroll
    for (int i = 0; i < 36; ++i) acc[i] = 0.f;
    for (int t = sg.x + lane; t < sg.y; t += 32) {
      const int2 tm = I.terms[t];
      const float2* ap = reinterpret_cast<const float2*>(A + (size_t)tm.x * 18);
      const float2* wp = reinterpret_cast<const float2*>(Wg + (size_t)tm.y * 18);
      float a[18], w[18];
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const float2 u = ap[q], v = wp[q];
        a[2 * q] = u.x;
        a[2 * q + 1] = u.y;
        w[2 * q] = v.x;
        w[2 * q + 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j)
          acc[i * 6 + j] += a[i * 3 + 0] * w[j * 3 + 0] + a[i * 3 + 1] * w[j * 3 + 1] +
                            a[i * 3 + 2] * w[j * 3 + 2];
    }
    float head[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) head[i] = acc[i];
    float tail[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tail[i] = warp_allsum(acc[32 + i]);
    const float mine = warp_reduce_scatter32(head);
    float* S = part + (size_t)(c % nparts) * psize + 33 * (size_t)K + 1;
    const size_t kd = sg.z, ke = sg.w;
    // lane j holds entry j (row j / 6, column j % 6); lane 0 entries 32-35
    const int i0 = lane / 6, j0 = lane - 6 * (lane / 6);
    S[(kd * 6 + i0) * n6 + ke * 6 + j0] += mine;
    if (kd != ke) S[(ke * 6 + j0) * n6 + kd * 6 + i0] += mine;
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = (32 + q) / 6, j = (32 + q) % 6;
        S[(kd * 6 + i) * n6 + ke * 6 + j] += tail[q];
        if (kd != ke) S[(ke * 6 + j) * n6 + kd * 6 + i] += tail[q];
      }
    return;
  }
  b -= nb_pair;
  if (b < nb_cam) {
    const int item = b * (kThreadsF2 / 32) + (threadIdx.x >> 5);
    const int cr = item / K, k = item - cr * K;
    if (cr >= nc) return;
    const int c = c0 + cr;
    const int2 cs = I.cam_seg[(size_t)c * K + k];
    if (cs.x == cs.y) return;
    float v[32], v2 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.f;
    for (int t = cs.x + lane; t < cs.y; t += 32) {
      const float* h = hcr + (size_t)I.cam_obs[t] * kHcr;
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] += h[i];
      v2 += h[32];
    }
    v2 = warp_allsum(v2);
    const float mine = warp_reduce_scatter32(v);
    float* pp = part + (size_t)(c % nparts) * psize;
    if (lane < 27)
      pp[27 * k + lane] += mine;
    else
      pp[27 * K + 6 * k + lane - 27] += mine;
    if (lane == 0) pp[27 * K + 6 * k + 5] += v2;
    return;
  }
  b -= nb_cam;
  const int cr = b * kThreadsF2 + threadIdx.x;
  if (cr >= nc) return;
  const int c = c0 + cr;
  float s = 0.f;
  for (int l = c * kThreadsLm; l < min(L, (c + 1) * kThreadsLm); ++l) s += cost_l[l];
  part[(size_t)(c % nparts) * psize + 33 * (size_t)K] += s;
}

// In-place exclusive scan of the block's ints a[0, n) in shared memory;
// returns the total. Every thread of the block calls it (it holds barriers).
__device__ int block_exclusive_scan(int* a, int n, int* red) {
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (n + T - 1) / T, lo = min(n, t * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[w] = x;
  __syncthreads();
  int before = 0, total = 0;
  for (int j = 0; j < T / 32; ++j) {
    if (j < w) before += red[j];
    total += red[j];
  }
  int run = before + x - s;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// A stable counting sort of n elements into nb buckets, by the block:
// bucket(i) in [0, nb), or -1 to drop element i; move(i, pos) puts element
// i at its place pos among the kept ones; on_bucket(b, start, end) hears
// each bucket's run. Warp w counts and then places a contiguous range of
// the elements, 32 at a time in order: a lane's rank among the earlier
// lanes of its bucket (__match_any_sync) after the earlier elements of its
// warp, after the earlier warps' (the scan over (bucket, warp)). hist
// holds nb * kIdxWarps ints of shared memory. Returns the kept count.
template <class Bucket, class Move, class OnBucket>
__device__ int stable_bucket_sort(int n, int nb, int* hist, int* red, Bucket bucket, Move move,
                                  OnBucket on_bucket) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nb * kIdxWarps; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int per = (n + kIdxWarps - 1) / kIdxWarps;
  const int lo = min(n, w * per), hi = min(n, lo + per);
  for (int i = lo + lane; i < hi; i += 32) {
    const int b = bucket(i);
    if (b >= 0) atomicAdd(&hist[b * kIdxWarps + w], 1);
  }
  __syncthreads();
  const int total = block_exclusive_scan(hist, nb * kIdxWarps, red);
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    on_bucket(b, hist[b * kIdxWarps], b + 1 < nb ? hist[(b + 1) * kIdxWarps] : total);
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int b = i < hi ? bucket(i) : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    const int pos = b >= 0 ? hist[b * kIdxWarps + w] + __popc(peers & ((1u << lane) - 1u)) : 0;
    __syncwarp();
    if (b >= 0) {
      move(i, pos);
      if (lane == 31 - __clz(peers)) hist[b * kIdxWarps + w] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  return total;
}

// F's pair index (SchurIndex), one block per chunk: the chunk's pair terms
// enumerated in (l, d, e) order (a thread per observation, its place from
// a scan of the counts), sorted stably by ke and then by kd (two
// counting sorts over the K cameras, through key0 / key1 / val1), cut into
// groups where (kd, ke) changes; the chunk's valid observations sorted
// stably by camera.
__global__ void __launch_bounds__(kThreadsIdx)
ba_schur_index_kernel(int K, int L, int D, const int* __restrict__ obs_cam,
                      const uint8_t* __restrict__ obs_valid, const uint8_t* __restrict__ lm_valid,
                      const uint8_t* __restrict__ lm_fixed, SchurIndex I, int* key0, int* key1,
                      int2* val1) {
  extern __shared__ int smi[];
  const int nD = kThreadsLm * D;
  int* cam = smi;                         // [nD]: camera of each valid observation, else -1
  int* cnt_o = cam + nD;                  // [nD]: pair terms of each observation
  int* hist = cnt_o + nD;                 // [kIdxWarps * K]
  int* cnt = hist + kIdxWarps * K;        // [kThreadsIdx]
  int* red = cnt + kThreadsIdx;           // [kIdxWarps]
  const int c = blockIdx.x, t = threadIdx.x, l0 = c * kThreadsLm;
  const long long tb = (long long)c * I.cap_t;
  int2* terms = I.terms + tb;
  for (int i = t; i < nD; i += blockDim.x) {
    const int l = l0 + i / D;
    const size_t od = (size_t)l0 * D + i;
    cam[i] = (l < L && lm_valid[l] && obs_valid[od]) ? obs_cam[od] : -1;
  }
  __syncthreads();
  // a thread per observation (l, d): its terms (l, d, e) over e; a valid
  // observation has l < L, and a fixed landmark has no term
  for (int i = t; i < nD; i += blockDim.x) {
    const int tl = i / D, cd = cam[i];
    int np = 0;
    if (cd >= 0 && !(lm_fixed && lm_fixed[l0 + tl]))
      for (int e = 0; e < D; ++e) {
        const int ce = cam[tl * D + e];
        np += (ce >= 0 && cd <= ce) ? 1 : 0;
      }
    cnt_o[i] = np;
  }
  __syncthreads();
  const int nt = block_exclusive_scan(cnt_o, nD, red);
  for (int i = t; i < nD; i += blockDim.x) {
    const int tl = i / D, cd = cam[i];
    if (cd < 0 || (lm_fixed && lm_fixed[l0 + tl])) continue;
    const int od = (l0 + tl) * D + i - tl * D;
    int at = cnt_o[i];
    for (int e = 0; e < D; ++e) {
      const int ce = cam[tl * D + e];
      if (ce >= 0 && cd <= ce) {
        key0[tb + at] = cd * K + ce;
        terms[at] = make_int2(od, (l0 + tl) * D + e);
        ++at;
      }
    }
  }
  __syncthreads();
  auto none = [](int, int, int) {};
  stable_bucket_sort(nt, K, hist, red, [&](int i) { return key0[tb + i] % K; },
                     [&](int i, int pos) {
                       key1[tb + pos] = key0[tb + i];
                       val1[tb + pos] = terms[i];
                     },
                     none);
  stable_bucket_sort(nt, K, hist, red, [&](int i) { return key1[tb + i] / K; },
                     [&](int i, int pos) {
                       key0[tb + pos] = key1[tb + i];
                       terms[pos] = val1[tb + i];
                     },
                     none);
  // the groups: runs of one key, found by each thread in its own range
  const int per = (nt + kThreadsIdx - 1) / kThreadsIdx;
  const int lo = min(nt, t * per), hi = min(nt, lo + per);
  int ns = 0;
  for (int i = lo; i < hi; ++i) ns += (i == 0 || key0[tb + i] != key0[tb + i - 1]) ? 1 : 0;
  cnt[t] = ns;
  __syncthreads();
  const int nseg = block_exclusive_scan(cnt, kThreadsIdx, red);
  int4* seg = I.seg + (size_t)c * I.cap_s;
  int at = cnt[t];
  for (int i = lo; i < hi; ++i)
    if (i == 0 || key0[tb + i] != key0[tb + i - 1]) {
      const int key = key0[tb + i];
      seg[at++] = make_int4((int)(tb + i), 0, key / K, key % K);
    }
  __syncthreads();
  for (int s = t; s < nseg; s += blockDim.x)
    seg[s].y = s + 1 < nseg ? seg[s + 1].x : (int)(tb + nt);
  if (t == 0) {
    I.nseg[c] = nseg;
    I.nterm[c] = nt;
  }
  // the cameras' runs of valid observations
  const long long ob = (long long)c * nD;
  stable_bucket_sort(nD, K, hist, red, [&](int i) { return cam[i]; },
                     [&](int i, int pos) { I.cam_obs[ob + pos] = l0 * D + i; },
                     [&](int k, int start, int end) {
                       I.cam_seg[(size_t)c * K + k] = make_int2((int)(ob + start), (int)(ob + end));
                     });
}

// F's second launch and W's reduce mode: the shards' block partials added
// in (shard, block) order, one thread per entry, into Hcc / b_c, the reduced
// system, its right-hand side and the cost at the linearization point. F
// passes one shard, its own blocks. Bound by the bytes it reads (every
// partial once: 4.9 MB at K = 32 over 4 x 8 partials, 1.5 us at 3.35 TB/s).
// Each block first lays the partials' base pointers out in shared memory in
// (shard, block) order (kReduceTable at a time), so that a thread's
// addresses need no walk over the shards; a thread then issues
// kReduceInFlight loads before it adds them from registers in that order,
// waiting out the memory latency once per kReduceInFlight partials, and
// the sum keeps its bits. Loads stay scalar: F's partial stride 33K + 1 +
// 36K^2 is odd for every even K, so a partial does not start 16-byte
// aligned, and padding it would move F's writer, f_blocks and the plain
// version for no fewer bytes; neighbouring threads read neighbouring
// floats, and kReduceThreads-thread blocks give several blocks per SM (297
// at K = 32).
constexpr int kReduceThreads = 128;
constexpr int kReduceInFlight = 32;
constexpr int kReduceTable = 256;

__global__ void __launch_bounds__(kReduceThreads)
ba_reduce_kernel(int K, ShardParts T, float* __restrict__ ctrl, float* __restrict__ hc_g,
                 float* __restrict__ S_g, float* __restrict__ rhs_g) {
  if (ctrl[kDone] != 0.f) return;
  __shared__ const float* s_ptr[kMaxShards];
  __shared__ int s_start[kMaxShards + 1];
  __shared__ const float* s_part[kReduceTable];
  const size_t psize = f_partial_size(K);
  if (threadIdx.x == 0) {
    int t = 0;
    for (int sh = 0; sh < T.count; ++sh) {
      s_ptr[sh] = T.ptr[sh];
      s_start[sh] = t;
      t += T.blocks[sh];
    }
    s_start[T.count] = t;
  }
  __syncthreads();
  const int total = s_start[T.count];
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const bool live = i < psize;
  float s = 0.f;
  for (int base = 0; base < total; base += kReduceTable) {
    const int m = min(kReduceTable, total - base);
    __syncthreads();  // the previous table's reads are done
    for (int t = threadIdx.x; t < m; t += blockDim.x) {
      const int f = base + t;
      int sh = 0;
      while (s_start[sh + 1] <= f) ++sh;
      s_part[t] = s_ptr[sh] + (size_t)(f - s_start[sh]) * psize;
    }
    __syncthreads();
    if (!live) continue;
    for (int u0 = 0; u0 < m; u0 += kReduceInFlight) {
      float v[kReduceInFlight];
#pragma unroll
      for (int u = 0; u < kReduceInFlight; ++u)
        v[u] = u0 + u < m ? __ldcg(s_part[u0 + u] + i) : 0.f;
#pragma unroll
      for (int u = 0; u < kReduceInFlight; ++u)
        if (u0 + u < m) s += v[u];
    }
  }
  if (!live) return;
  if (i < 27 * (size_t)K)
    hc_g[i] = s;
  else if (i < 33 * (size_t)K)
    rhs_g[i - 27 * K] = s;
  else if (i == 33 * (size_t)K)
    ctrl[kCost0] = s;
  else
    S_g[i - 33 * K - 1] = s;
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

// ---------------------------------------------------------------------------
// G: the tiled Cholesky solve (ba_solve_kernel's successor; see the note at
// the top of the file and below)
// ---------------------------------------------------------------------------
//
// The system is cut into 32 x 32 tiles (one warp's width) and only the
// lower triangle's tiles are kept, each with a row stride of 33 floats, so
// that a warp reading a tile's row or column hits 32 banks. Sizes are padded
// with an identity diagonal (as linalg.solve_spd_blocked pads), and the
// right-hand side rides in the factor as row n: the Cholesky factor of
// [[S, .], [b^T, 1]] holds L^-1 b in its last row, so the forward solve
// costs no step of its own. Per panel p (tile column p):
//   A. one warp factors the diagonal tile in registers (lane i holds row i,
//      the column values travel by shuffles; each pivot is guarded by
//      max(a, 1e-20), the plain version's eps, and one rsqrt gives it and
//      its reciprocal);
//   B. the warps solve the panel's tiles below it (TRSM, one warp per tile,
//      lane r on row r, the diagonal factor broadcast from shared memory);
//   C. the trailing lower triangle takes the panel's rank-32 update (SYRK):
//      the panel's owners write it, transposed, into every block's [kc][N]
//      buffer and each thread updates 4 x 4 micro-tiles of its block's
//      trailing tiles (tile, micro row and column from a precomputed slot
//      map and shifts); the next diagonal tile's owner then writes it into
//      every block, which factors it in place in phase A.
// About 3 barriers per panel instead of 3 per column. Then the backward
// solve L^T x = y panel by panel: one warp on the diagonal triangle, every
// thread on the rest of x, which lives in shared memory.
//
// Storage by size:
//   n <= 192 (kSolveSharedDim, K <= 32): one block of kThreadsSolve, every
//     tile in its shared memory (28 tiles and the panel, 152 KB at n = 192);
//   192 < n <= 768 (kSolveClusterDim, K <= 128): a thread block cluster of
//     4 or 8 blocks (cudaLaunchKernelEx with a cluster-dimension attribute).
//     Tile q of the column-major lower triangle lives in block q % C's
//     shared memory; each block updates only its own tiles. The owners
//     push the panel and the next diagonal tile into every peer through
//     distributed shared memory (map_shared_rank): remote stores need no
//     round trip, and pulling them with remote loads instead made G twice
//     as slow at K = 64 on an H100 (scripts/torch_solve_probe.py: 0.27
//     against 0.14 ms). Above K = 111 the panel buffer holds
//     16 columns and the update runs in two passes. The cluster meets at
//     cluster.sync() once after the load (no block may write a peer's
//     shared memory before every block of the cluster has started), twice
//     per panel (once more per extra pass) and once before any block exits
//     (no block may leave while a peer can still read its shared memory).
//     Block 0 solves backward;
//   n > 768 (K 129 - 512): the same tiles in a device-memory scratch, one
//     launch per panel phase (A + B: one block per panel tile; C: one block
//     per trailing tile), the order between phases kept by the launch
//     boundaries and plain loads (no volatile reads: nothing is read that
//     another block of the same launch writes).
// fp32 on the CUDA cores: at these sizes the factor is bound by its chain
// of n/32 dependent panels and by barrier latency, not by operations
// (n^3/3 = 2.4 MFLOP at n = 192, ~5 us at one SM's fp32 peak), and TF32 on
// the tensor cores would give up digits that the float32 parity bounds
// hold. Every sum runs in an order fixed by the tiling (no atomics), so a
// launch repeats bit for bit and every replica of a sharded BA solves alike.
constexpr int kTileLd = 33;                   // row stride of a tile
constexpr int kTileFloats = 32 * kTileLd;     // one tile
constexpr int kSolveClusterDim = 768;         // largest n factored by a cluster
constexpr int kThreadsFinal = 1024;           // the device-memory route's last launch
constexpr int kSysBA = 0;                     // G: the damped, masked reduced system
constexpr int kSysSPD = 1;                    // svt_spd_solve: A x = b as given

// What G solves and where its result goes. kSysBA: the damped, masked
// reduced system of ctrl / hc / S / rhs, the trial poses and the cleared
// accumulators; kSysSPD: the lower triangle of A (n x n) and b, x.
struct SolveArgs {
  int n, K;
  const float* cam_free;
  const float* cam_R;
  const float* cam_t;
  const float* ctrl;
  float* hc;
  float* S;
  float* rhs;
  float* dx;
  float* cam_Rn;
  float* cam_tn;
  const float* A;
  const float* b;
  float* x;
};

// Tiles per side (rows 0..n-1 the system, row n the right-hand side) and the
// column-major numbering of the lower triangle's tiles.
struct TileGeom {
  int n, nt;
  __host__ __device__ explicit TileGeom(int n_) : n(n_), nt((n_ + 32) / 32) {}
  __host__ __device__ int colstart(int J) const { return J * nt - J * (J - 1) / 2; }
  __host__ __device__ int index(int I, int J) const { return colstart(J) + I - J; }
  __host__ __device__ int count() const { return nt * (nt + 1) / 2; }
  __device__ void coords(int q, int& I, int& J) const {
    J = 0;
    while (J + 1 < nt && colstart(J + 1) <= q) ++J;
    I = J + q - colstart(J);
  }
};

// right-hand side entry j < n, from hc (27 floats a camera) and cam_free
// wherever they are kept (device or shared memory)
template <int SYS>
__device__ __forceinline__ float rhs_entry(const SolveArgs& a, const float* hc,
                                           const float* cam_free, int j) {
  if constexpr (SYS == kSysSPD) {
    return a.b[j];
  } else {
    return (hc[27 * (j / 6) + 21 + j % 6] - a.rhs[j]) * cam_free[j / 6];
  }
}

// The device-memory value entry (i, j) starts from (S or A, lower
// triangle), 0 where there is none: loaded apart from the rest, so that a
// thread can have several of these loads in flight.
template <int SYS>
__device__ __forceinline__ float raw_entry(const SolveArgs& a, int i, int j) {
  const float* src = SYS == kSysSPD ? a.A : a.S;
  // an unconditional load from a clamped address: no branch stands between
  // a thread's loads, so a batch of them is in flight at once
  const int ic = min(i, a.n - 1), jc = min(j, ic);
  const float v = src[(size_t)ic * a.n + jc];
  return (i < a.n && j <= i) ? v : 0.f;
}

// Entry (i, j), j <= i < 32 nt, of the padded system with its right-hand
// side row, from its raw value; bvec: the right-hand side (computed from
// hc when null). kSysBA: S = -S_red + blockdiag(Hcc + (lam * max(tr/6,
// 1e-6) + 1e-7) I), fixed and invalid cameras masked to the identity.
template <int SYS>
__device__ __forceinline__ float system_entry(const SolveArgs& a, float lam, int i, int j,
                                              float raw, const float* hc,
                                              const float* cam_free, const float* bvec) {
  const int n = a.n;
  if (i > n) return i == j ? 1.f : 0.f;
  if (i == n) return j < n ? (bvec ? bvec[j] : rhs_entry<SYS>(a, hc, cam_free, j)) : 1.f;
  if constexpr (SYS == kSysSPD) {
    return raw;
  } else {
    const int ki = i / 6, kj = j / 6;
    float v = -raw;
    if (ki == kj) {
      const float* h = hc + 27 * ki;
      const int lo = min(i % 6, j % 6), hi = max(i % 6, j % 6);
      v += h[lo * 6 - lo * (lo - 1) / 2 + (hi - lo)];  // packed upper index
      if (i == j) {
        const float tr = h[0] + h[6] + h[11] + h[15] + h[18] + h[20];
        v += lam * fmaxf(tr / 6.f, 1e-6f) + 1e-7f;
      }
    }
    const float fi = cam_free[ki], fj = cam_free[kj];
    return v * fi * fj + (i == j ? 1.f - fi : 0.f);
  }
}

constexpr int kLoadBatch = 8;  // loads a thread keeps in flight in a copy loop

// One warp: the lower Cholesky factor of tile T into Lo (zeros above the
// diagonal) and the reciprocals of its diagonal into dinv. Lane i holds row
// i; entries above the diagonal are never read into the factor. The pivot
// chain (32 dependent steps) takes rsqrt once a step: the pivot and its
// reciprocal within 2 ulp, well inside the plain version's bounds.
__device__ __forceinline__ void potrf_warp(const float* T, float* Lo, float* dinv, int lane) {
  float a[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) a[c] = T[lane * kTileLd + c];
  float my_inv = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float p = fmaxf(__shfl_sync(kFull, a[j], j), 1e-20f);
    const float inv = rsqrtf(p), d = p * inv;  // one MUFU op on the chain
    a[j] = lane == j ? d : a[j] * inv;
    if (lane == j) my_inv = inv;
#pragma unroll
    for (int c = j + 1; c < 32; ++c) a[c] -= a[j] * __shfl_sync(kFull, a[j], c);
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) Lo[lane * kTileLd + c] = c <= lane ? a[c] : 0.f;
  dinv[lane] = my_inv;
}

// One warp: T <- T L^-T for the tile T below a diagonal tile with factor Lo
// (lane r solves row r by forward substitution).
__device__ __forceinline__ void trsm_warp(float* T, const float* Lo, const float* dinv,
                                          int lane) {
  float a[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) a[c] = T[lane * kTileLd + c];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    a[k] *= dinv[k];
#pragma unroll
    for (int c = k + 1; c < 32; ++c) a[c] -= a[k] * Lo[c * kTileLd + k];
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) T[lane * kTileLd + c] = a[c];
}

// T -= Pr Pc^T on the 4 x 4 micro-tile (mr, mc) of a trailing tile: Pr and
// Pc point at the tile's rows and columns in the transposed panel buffer
// (row stride ldp floats), kc panel columns.
__device__ __forceinline__ void syrk_micro(float* T, const float* Pr, const float* Pc, int ldp,
                                           int kc, int mr, int mc) {
  float acc[4][4] = {};
  const float4* pr = reinterpret_cast<const float4*>(Pr + 4 * mr);
  const float4* pc = reinterpret_cast<const float4*>(Pc + 4 * mc);
  const int ld4 = ldp / 4;
#pragma unroll 8
  for (int k = 0; k < kc; ++k) {
    const float4 u = pr[k * ld4], v = pc[k * ld4];
    const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(uu[i], vv[j], acc[i][j]);
  }
  float* t = T + 4 * mr * kTileLd + 4 * mc;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i * kTileLd + j] -= acc[i][j];
}

// One warp: the backward solve of the diagonal tile Td on x_p (x holds the
// panel's right-hand side; rows at or past n are zero and stay zero).
__device__ __forceinline__ void backward_warp(const float* Td, float* xp, int row0, int n,
                                              int lane) {
  float lcol[32];
#pragma unroll
  for (int j = 0; j < 32; ++j)
    lcol[j] = (j > lane && row0 + j < n) ? Td[j * kTileLd + lane] : 0.f;
  const bool live = row0 + lane < n;
  float yi = live ? xp[lane] : 0.f;
  const float rdi = live ? 1.f / Td[lane * kTileLd + lane] : 0.f;
  float xi = 0.f;
#pragma unroll
  for (int j = 31; j >= 0; --j) {
    const float xj = __shfl_sync(kFull, yi * rdi, j);
    if (lane == j) xi = xj;
    yi -= lcol[j] * xj;
  }
  xp[lane] = xi;
}

// The result of the solve in x (shared memory, one block): kSysBA the step
// dx = -x on the free cameras, the trial poses and the cleared accumulators
// (S is cleared by the caller); kSysSPD x itself.
template <int SYS>
__device__ void solve_finish(const SolveArgs& a, float* x) {
  const int n = a.n, tid = threadIdx.x;
  if constexpr (SYS == kSysSPD) {
    for (int i = tid; i < n; i += blockDim.x) a.x[i] = x[i];
  } else {
    for (int i = tid; i < n; i += blockDim.x) {
      x[i] = -x[i] * a.cam_free[i / 6];
      a.dx[i] = x[i];
    }
    __syncthreads();
    for (int k = tid; k < a.K; k += blockDim.x)
      se3_left(x + 6 * k, a.cam_R + 9 * k, a.cam_t + 3 * k, a.cam_Rn + 9 * k, a.cam_tn + 3 * k);
    for (int q = tid; q < 27 * a.K; q += blockDim.x) a.hc[q] = 0.f;
    for (int q = tid; q < n; q += blockDim.x) a.rhs[q] = 0.f;
  }
}

template <int SYS>
__device__ __forceinline__ bool solve_stopped(const SolveArgs& a) {
  if constexpr (SYS == kSysBA) return a.ctrl[kDone] != 0.f;
  return false;
}

// Shared memory of the one-block and cluster routes, in floats: the block's
// tile slots, the panel buffer [kc][32 nt], the diagonal factor and its
// reciprocals, x [32 nt], and the slot map (one 16-bit (I, J) per slot).
size_t solve_smem_bytes(int n, int C, int kc) {
  const TileGeom g(n);
  const size_t slots = (g.count() + C - 1) / C, N = 32 * (size_t)g.nt;
  return sizeof(float) * (slots * kTileFloats + kc * N + kTileFloats + 32 + N) +
         sizeof(unsigned short) * slots;
}

// Where tile (I, J) lives: this block's slot q / C, or its owner's through
// distributed shared memory (C > 1).
template <int C>
__device__ __forceinline__ float* tile_at(float* slots, const TileGeom& g, int rank, int I,
                                          int J) {
  const int q = g.index(I, J);
  float* p = slots + (size_t)(q / C) * kTileFloats;
  if constexpr (C == 1) {
    return p;
  } else {
    const int owner = q % C;
    return owner == rank ? p : cooperative_groups::this_cluster().map_shared_rank(p, owner);
  }
}

// The block's threads copy n floats from src (this block's shared memory)
// to dst in every block of the cluster (dst: an address in this block's
// shared memory layout, mapped to each peer's).
template <int C>
__device__ __forceinline__ void push_to_all(const float* src, float* dst, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float v = src[e];
    for (int b = 0; b < C; ++b) {
      float* d = dst;
      if constexpr (C > 1)
        if (b != (int)cooperative_groups::this_cluster().block_rank())
          d = cooperative_groups::this_cluster().map_shared_rank(dst, b);
      d[e] = v;
    }
  }
}

template <int C>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (C == 1)
    __syncthreads();
  else
    cooperative_groups::this_cluster().sync();
}

// The one-block (C = 1) and cluster (C = 4, 8) routes. kc: panel columns per
// SYRK pass (32, or 16 where the panel buffer must be smaller).
template <int SYS, int C>
__global__ void __launch_bounds__(kThreadsSolve, 1) spd_tiled_kernel(SolveArgs a, int kc) {
  if (solve_stopped<SYS>(a)) return;  // every block of the cluster returns
  extern __shared__ __align__(16) float tiled_sm[];
  const TileGeom g(a.n);
  const int n = a.n, nt = g.nt, N = 32 * nt, ntl = g.count();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cooperative_groups::this_cluster().block_rank();
  const int nslots = (ntl + C - 1) / C, nown = (ntl - rank + C - 1) / C;
  float* slots = tiled_sm;
  float* P = slots + (size_t)nslots * kTileFloats;
  float* Lo = P + (size_t)kc * N;
  float* dinv = Lo + kTileFloats;
  float* x = dinv + 32;
  unsigned short* map = reinterpret_cast<unsigned short*>(x + N);
  float lam = 0.f;
  if constexpr (SYS == kSysBA) lam = a.ctrl[kLam];
  for (int s = tid; s < nown; s += blockDim.x) {
    int I, J;
    g.coords(s * C + rank, I, J);
    map[s] = (unsigned short)((I << 8) | J);
  }
  // kSysBA: hc and cam_free staged in the panel buffer (27K + K floats,
  // free until the first panel's pushes), then the right-hand side in x
  float* hcs = P;
  float* frees = P + 27 * a.K;
  if constexpr (SYS == kSysBA) {
    for (int q = tid; q < 27 * a.K; q += blockDim.x) hcs[q] = a.hc[q];
    for (int k = tid; k < a.K; k += blockDim.x) frees[k] = a.cam_free[k];
    __syncthreads();
  }
  for (int j = tid; j < n; j += blockDim.x) x[j] = rhs_entry<SYS>(a, hcs, frees, j);
  __syncthreads();
  // this block's tiles of the padded system (zeros above the diagonal),
  // kLoadBatch device-memory loads in flight a thread
  const int total = nown * 1024;
  for (int e0 = tid; e0 < total; e0 += kLoadBatch * blockDim.x) {
    float raw[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = min(e0 + u * (int)blockDim.x, total - 1), s = e >> 10;
      raw[u] = raw_entry<SYS>(a, 32 * (map[s] >> 8) + ((e >> 5) & 31),
                              32 * (map[s] & 255) + (e & 31));
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= total) break;
      const int s = e >> 10, r = (e >> 5) & 31, c = e & 31;
      const int i = 32 * (map[s] >> 8) + r, j = 32 * (map[s] & 255) + c;
      slots[(size_t)s * kTileFloats + r * kTileLd + c] =
          j <= i ? system_entry<SYS>(a, lam, i, j, raw[u], hcs, frees, x) : 0.f;
    }
  }
  // every block has loaded its tiles, and every block of the cluster has
  // started: a peer's shared memory may be written only from here on
  cluster_barrier<C>();
  // the first diagonal tile (tile 0, block 0's slot 0) into every block's Lo
  if (rank == 0) push_to_all<C>(slots, Lo, kTileFloats);
  cluster_barrier<C>();
  int lgk = 0;
  while ((1 << lgk) < kc) ++lgk;
  for (int p = 0; p < nt; ++p) {
    // A: the diagonal tile's factor in place in Lo (every block holds its
    // copy); the tile's owner keeps the factor in its slot
    if (warp == 0) potrf_warp(Lo, Lo, dinv, lane);
    __syncthreads();
    const int cs = g.colstart(p), ce = g.colstart(p + 1);
    if (cs % C == rank)
      for (int e = tid; e < kTileFloats; e += blockDim.x)
        slots[(size_t)(cs / C) * kTileFloats + e] = Lo[e];
    // B: this block's tiles below it, one warp each
    const int q0 = cs + 1 + ((rank - (cs + 1)) % C + C) % C;
    const int npan = q0 < ce ? (ce - q0 + C - 1) / C : 0;  // this block's panel tiles
    for (int t = warp; t < npan; t += nwarps)
      trsm_warp(slots + (size_t)((q0 + t * C) / C) * kTileFloats, Lo, dinv, lane);
    __syncthreads();
    // C: the trailing update of this block's tiles, kc panel columns a pass;
    // each pass's columns are pushed, transposed, by their tiles' owners
    // into every block's panel buffer (remote stores: no round trips)
    const int first = (ce - rank + C - 1) / C;  // own slots from here lie right of p
    const int nsy = max(nown - first, 0);
    for (int k0 = 0; k0 < 32; k0 += kc) {
      if (k0 > 0) cluster_barrier<C>();  // every block has read the last pass
      for (int e = tid; e < npan * kc * 32; e += blockDim.x) {
        const int t = e >> (lgk + 5), kk = (e >> 5) & (kc - 1), r = e & 31;
        const int q = q0 + t * C, I = p + q - cs;
        const float v = slots[(size_t)(q / C) * kTileFloats + r * kTileLd + k0 + kk];
        for (int b = 0; b < C; ++b) {
          float* Pb = P;
          if constexpr (C > 1)
            if (b != rank) Pb = cooperative_groups::this_cluster().map_shared_rank(P, b);
          Pb[(size_t)kk * N + 32 * I + r] = v;
        }
      }
      cluster_barrier<C>();
      for (int w = tid; w < nsy * 64; w += blockDim.x) {
        const int s = first + (w >> 6), m = w & 63, mr = m >> 3, mc = m & 7;
        const int I = map[s] >> 8, J = map[s] & 255;
        if (I == J && mc > mr) continue;
        syrk_micro(slots + (size_t)s * kTileFloats, P + 32 * I, P + 32 * J, N, kc, mr, mc);
      }
      __syncthreads();
    }
    // the next diagonal tile, final now, into every block's Lo
    if (p + 1 < nt && ce % C == rank)
      push_to_all<C>(slots + (size_t)(ce / C) * kTileFloats, Lo, kTileFloats);
    cluster_barrier<C>();
  }
  // every block clears its share of the accumulated S (read by the builds,
  // which all ended before the first barrier)
  if constexpr (SYS == kSysBA) {
    const size_t nn = (size_t)n * n;
    for (size_t q = (size_t)rank * blockDim.x + tid; q < nn; q += (size_t)C * blockDim.x)
      a.S[q] = 0.f;
  }
  if (rank == 0) {
    // y = L^-1 b from the right-hand-side row, then L^T x = y
    const int nb = n >> 5, rb = n & 31;
    for (int j = tid; j < N; j += blockDim.x)
      x[j] = j < n ? tile_at<C>(slots, g, rank, nb, j >> 5)[rb * kTileLd + (j & 31)] : 0.f;
    __syncthreads();
    for (int p = (n - 1) >> 5; p >= 0; --p) {
      if (warp == 0) backward_warp(tile_at<C>(slots, g, rank, p, p), x + 32 * p, 32 * p, n, lane);
      __syncthreads();
      for (int r = tid; r < 32 * p; r += blockDim.x) {
        const float* T = tile_at<C>(slots, g, rank, p, r >> 5) + (r & 31);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 32; ++k) s = fmaf(T[k * kTileLd], x[32 * p + k], s);
        x[r] -= s;
      }
      __syncthreads();
    }
    solve_finish<SYS>(a, x);
  }
  if constexpr (C > 1) cooperative_groups::this_cluster().sync();
}

// ---- the device-memory route (n > kSolveClusterDim): one launch per phase ----
// scratch: the lower triangle's tiles (column-major numbering), then the nt
// factored diagonal tiles (phase A + B reads a diagonal tile that it must
// not overwrite while other blocks of the launch read it)
size_t solve_scratch_floats(int n) {
  const TileGeom g(n);
  return ((size_t)g.count() + g.nt) * kTileFloats;
}

// the tiles, and the S accumulator cleared (each block its tile's region
// and the mirror of it)
template <int SYS>
__global__ void __launch_bounds__(256) spd_build_kernel(SolveArgs a, float* tiles) {
  if (solve_stopped<SYS>(a)) return;
  const TileGeom g(a.n);
  int I, J;
  g.coords(blockIdx.x, I, J);
  float lam = 0.f;
  if constexpr (SYS == kSysBA) lam = a.ctrl[kLam];
  float* T = tiles + (size_t)blockIdx.x * kTileFloats;
  for (int e = threadIdx.x; e < 1024; e += blockDim.x) {
    const int r = e >> 5, c = e & 31, i = 32 * I + r, j = 32 * J + c;
    T[r * kTileLd + c] = j <= i ? system_entry<SYS>(a, lam, i, j, raw_entry<SYS>(a, i, j), a.hc,
                                                    a.cam_free, nullptr)
                                : 0.f;
  }
  if constexpr (SYS == kSysBA) {
    __syncthreads();
    const int n = a.n;
    for (int e = threadIdx.x; e < 1024; e += blockDim.x) {
      const int r = e >> 5, c = e & 31;
      if (32 * I + r < n && 32 * J + c < n) a.S[(size_t)(32 * I + r) * n + 32 * J + c] = 0.f;
      if (I != J && 32 * J + r < n && 32 * I + c < n)
        a.S[(size_t)(32 * J + r) * n + 32 * I + c] = 0.f;
    }
  }
}

// A + B of panel p: block b factors the diagonal tile (every block alike)
// and solves tile (p + 1 + b, p); block 0 keeps the factor in diag.
template <int SYS>
__global__ void __launch_bounds__(32) spd_panel_kernel(SolveArgs a, float* tiles, float* diag,
                                                       int p) {
  if (solve_stopped<SYS>(a)) return;
  __shared__ float Td[kTileFloats], Lo[kTileFloats], dinv[32];
  const TileGeom g(a.n);
  const int lane = threadIdx.x;
  const float* A = tiles + (size_t)g.index(p, p) * kTileFloats;
  for (int e = lane; e < kTileFloats; e += 32) Td[e] = A[e];
  __syncwarp();
  potrf_warp(Td, Lo, dinv, lane);
  __syncwarp();
  if (blockIdx.x == 0)
    for (int e = lane; e < kTileFloats; e += 32) diag[(size_t)p * kTileFloats + e] = Lo[e];
  const int I = p + 1 + blockIdx.x;
  if (I >= g.nt) return;
  float* T = tiles + (size_t)g.index(I, p) * kTileFloats;
  for (int e = lane; e < kTileFloats; e += 32) Td[e] = T[e];
  __syncwarp();
  trsm_warp(Td, Lo, dinv, lane);
  __syncwarp();
  for (int e = lane; e < kTileFloats; e += 32) T[e] = Td[e];
}

// C of panel p: block t updates trailing tile t (row-major numbering of the
// trailing triangle), one 4 x 4 micro-tile per thread
template <int SYS>
__global__ void __launch_bounds__(64) spd_update_kernel(SolveArgs a, float* tiles, int p) {
  if (solve_stopped<SYS>(a)) return;
  __shared__ __align__(16) float Pr[32 * 32], Pc[32 * 32];
  const TileGeom g(a.n);
  const int t = blockIdx.x;
  int u = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (u * (u + 1) / 2 > t) --u;
  while ((u + 1) * (u + 2) / 2 <= t) ++u;
  const int I = p + 1 + u, J = p + 1 + t - u * (u + 1) / 2;
  const float* Ti = tiles + (size_t)g.index(I, p) * kTileFloats;
  const float* Tj = tiles + (size_t)g.index(J, p) * kTileFloats;
  for (int e = threadIdx.x; e < 1024; e += blockDim.x) {
    const int r = e & 31, k = e >> 5;
    Pr[k * 32 + r] = Ti[r * kTileLd + k];
    Pc[k * 32 + r] = Tj[r * kTileLd + k];
  }
  __syncthreads();
  const int mr = threadIdx.x >> 3, mc = threadIdx.x & 7;
  if (I == J && mc > mr) return;
  syrk_micro(tiles + (size_t)g.index(I, J) * kTileFloats, Pr, Pc, 32, 32, mr, mc);
}

// the backward solve (diagonal tiles from diag) and the result
template <int SYS>
__global__ void __launch_bounds__(kThreadsFinal) spd_final_kernel(SolveArgs a,
                                                                  const float* tiles,
                                                                  const float* diag) {
  if (solve_stopped<SYS>(a)) return;
  extern __shared__ __align__(16) float final_sm[];
  float* x = final_sm;
  const TileGeom g(a.n);
  const int n = a.n, N = 32 * g.nt, tid = threadIdx.x, lane = tid & 31;
  auto tile = [&](int I, int J) {
    return I == J ? diag + (size_t)I * kTileFloats : tiles + (size_t)g.index(I, J) * kTileFloats;
  };
  const int nb = n >> 5, rb = n & 31;
  for (int j = tid; j < N; j += blockDim.x)
    x[j] = j < n ? tile(nb, j >> 5)[rb * kTileLd + (j & 31)] : 0.f;
  __syncthreads();
  for (int p = (n - 1) >> 5; p >= 0; --p) {
    if (tid < 32) backward_warp(tile(p, p), x + 32 * p, 32 * p, n, lane);
    __syncthreads();
    for (int r = tid; r < 32 * p; r += blockDim.x) {
      const float* T = tile(p, r >> 5) + (r & 31);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 32; ++k) s = fmaf(T[k * kTileLd], x[32 * p + k], s);
      x[r] -= s;
    }
    __syncthreads();
  }
  solve_finish<SYS>(a, x);
}

// The route for an n x n system: C = 1 (one block), 4 or 8 (a cluster) with
// its panel width kc, or C = 0 (the device-memory route).
struct SolvePlan {
  int C, kc;
  size_t smem;
};

SolvePlan plan_solve(int n) {
  if (n <= kSolveSharedDim) return {1, 32, solve_smem_bytes(n, 1, 32)};
  if (n <= kSolveClusterDim) {
    // 4 blocks to K = 85, 8 to 111, then 8 with half-width panel passes
    const int cand[3][2] = {{4, 32}, {8, 32}, {8, 16}};
    for (const auto& c : cand) {
      const size_t s = solve_smem_bytes(n, c[0], c[1]);
      if (s <= kMaxBlockSmem) return {c[0], c[1], s};
    }
  }
  return {0, 32, 0};
}

template <int SYS, int C>
cudaError_t launch_tiled(const SolveArgs& a, const SolvePlan& pl, cudaStream_t st) {
  auto kernel = spd_tiled_kernel<SYS, C>;
  const cudaError_t e = reserve_smem((const void*)kernel, pl.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreadsSolve);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, a, pl.kc);
}

// Every launch of one solve; scratch (scratch_floats floats of device
// memory) is read on the device-memory route only.
template <int SYS>
cudaError_t launch_solve(const SolveArgs& a, float* scratch, size_t scratch_floats,
                         cudaStream_t st) {
  if (a.n < 1) return cudaErrorInvalidValue;
  const SolvePlan pl = plan_solve(a.n);
  if (pl.C == 1) return launch_tiled<SYS, 1>(a, pl, st);
  if (pl.C == 4) return launch_tiled<SYS, 4>(a, pl, st);
  if (pl.C == 8) return launch_tiled<SYS, 8>(a, pl, st);
  const TileGeom g(a.n);
  if (scratch == nullptr || scratch_floats < solve_scratch_floats(a.n))
    return cudaErrorInvalidValue;
  float* diag = scratch + (size_t)g.count() * kTileFloats;
  spd_build_kernel<SYS><<<g.count(), 256, 0, st>>>(a, scratch);
  for (int p = 0; p < g.nt; ++p) {
    const int below = g.nt - 1 - p;
    spd_panel_kernel<SYS><<<max(below, 1), 32, 0, st>>>(a, scratch, diag, p);
    if (below > 0) spd_update_kernel<SYS><<<below * (below + 1) / 2, 64, 0, st>>>(a, scratch, p);
  }
  const size_t xs = sizeof(float) * 32 * (size_t)g.nt;
  const cudaError_t e = reserve_smem((const void*)spd_final_kernel<SYS>, xs);
  if (e != cudaSuccess) return e;
  spd_final_kernel<SYS><<<1, kThreadsFinal, xs, st>>>(a, scratch, diag);
  return cudaGetLastError();
}

// H's accept / reject of the trial state on its cost c1 against F's c0:
// lambda halved or quadrupled, the gain < 1e-3 stop flag, the stage's last
// cost; F's and H's cost slots cleared. Returns whether the trial is taken.
__device__ __forceinline__ bool lm_decide(float* ctrl, float c0, float c1, float lam) {
  const bool imp = c1 < c0;
  const float gain = (c0 - c1) / fmaxf(c0, 1e-12f);
  float lm_ = imp ? lam * 0.5f : lam * 4.f;
  ctrl[kLam] = fminf(fmaxf(lm_, 1e-8f), 1e4f);
  ctrl[kDone] = (imp && gain < 1e-3f) ? 1.f : 0.f;
  ctrl[kLastCost] = c1;
  ctrl[kCost0] = 0.f;
  ctrl[kCost1] = 0.f;
  return imp;
}

// H (svt_ba_backsub). Up to D = 3 observations a landmark (the init BA), a
// block a 128-landmark chunk and a thread a landmark, its observations in
// turn (few, so one pass with one barrier beats spreading them). Above, a
// thread an observation, lpb = 128 / D (D rounded up to a power of two)
// landmarks a block, so that L = 4096 landmarks at D = 12 run as 512
// blocks over the card: each observation's thread reads its camera's dx
// and its landmark's block, point and flags while the block's W rows
// arrive in shared memory (coalesced), forms W_d^T dx_k, then, after one
// barrier, every thread of a landmark adds the landmark's D terms to b_p in
// d order and solves dp = -G (b_p + sum_d W_d^T dx_k) (the same operations
// in the same order in each, so no thread waits on another), takes the
// trial point and its own observation's weight and squared residual there;
// the landmark's thread sums w_d sq_d in d order. A chunk's costs are added
// in the order one block of 128 threads did (a shuffle-down over each warp,
// the warps' sums in order) into the chunk's partial: by the block itself
// where it holds the whole chunk, else by the chunk's last block to finish
// (a fence and a ticket, an atomicInc that wraps to 0 for the next
// launch). So every sum keeps the single-thread-per-landmark kernel's
// order and bits, and the partials, shards cut on chunk boundaries and W's
// decide mode keep theirs. DECIDE: the block that completes the last chunk
// (a second ticket) adds the partials in chunk order (a warp loads them,
// one lane adds) and decides; on accept its threads commit the trial state,
// eight 16-byte loads in flight each. Without DECIDE the chunk partials are
// the output, for W's decide mode (shards).
__device__ __forceinline__ void copy_f32(float* __restrict__ dst, const float* src, int n) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  int i0 = 0;
  if (vec) {
    const int n4 = n / 4, bd = blockDim.x;
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < n4; i += 8 * bd) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i + u * bd < n4) v[u] = __ldcg(s4 + i + u * bd);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i + u * bd < n4) d4[i + u * bd] = v[u];
    }
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldcg(src + i);
}

// a warp's shuffle-down sum (lane 0's): the first step of a chunk's cost,
// whose warps' sums are then added in order
__device__ __forceinline__ float warp_sum_down(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

template <int MODEL, bool DECIDE>
__global__ void __launch_bounds__(kThreadsLm)
ba_backsub_kernel(Problem P, Cam cam, float* __restrict__ cam_R, float* __restrict__ cam_t,
                  float* __restrict__ lm, int use_huber, float* __restrict__ ctrl,
                  unsigned int* __restrict__ tickets, const float* __restrict__ Wg,
                  const float* __restrict__ lmblk, const float* __restrict__ dx_g,
                  const float* __restrict__ cam_Rn, const float* __restrict__ cam_tn,
                  float* __restrict__ lmn, float* __restrict__ cost_l, float* cost_part,
                  int lpb) {
  if (ctrl[kDone] != 0.f) return;
  extern __shared__ float hs[];  // at most 128 x 23 floats
  __shared__ float red[kThreadsLm / 32];
  __shared__ bool last;
  __shared__ bool improved;
  const int D = P.D, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float lam = ctrl[kLam];
  const int l0 = blockIdx.x * lpb, c = l0 / kThreadsLm;
  if (lpb == kThreadsLm) {
    // a block a chunk, a thread a landmark, its few observations in turn
    const int l = l0 + tid;
    float cost = 0.f;
    if (l < P.L) {
      const float* blk = lmblk + 10 * l;
      float G[6];
      sym3_inv(blk, lam, G);
      const bool keep = !(P.lm_fixed && P.lm_fixed[l]);
      const float upd = (P.lm_valid[l] && blk[9] != 0.f && keep) ? 1.f : 0.f;
      float rp[3] = {blk[6], blk[7], blk[8]};
      for (int d = 0; d < D; ++d) {
        const float* Wd = Wg + (l * D + d) * 18;
        const float* dx = dx_g + 6 * P.obs_cam[l * D + d];
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
      for (int d = 0; d < D; ++d) {
        const int k = P.obs_cam[l * D + d];
        ObsTerms o;
        obs_terms<MODEL>(P, cam, cam_Rn + 9 * k, cam_tn + 3 * k, pn, l, d, use_huber != 0, o);
        cost += o.sq_w;
      }
    }
    const float v = warp_sum_down(cost);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < kThreadsLm / 32; ++w) sum += red[w];
      cost_part[c] = sum;
    }
  } else {
    const int n = lpb * D;
    const int nl = min(lpb, P.L - l0), nobs = nl * D;
    float* sW = hs;              // [n][18]: the block's W rows
    float* sS = sW + n * 18;     // [n][3]: W_d^T dx_k
    float* sQ = sS + n * 3;      // [n][2]: weight, squared residual at the trial state
    const int t = tid / D, d = tid - t * D;
    const int l = l0 + t, od = l * D + d;
    const bool obs = tid < nobs;
    // read while the W rows arrive: this observation's camera step, and its
    // landmark's block, point and flags (every thread of the landmark takes
    // its update, in the same order, so that none waits for another's)
    float dx[6], blk[10], p0[3], upd = 0.f;
    int k = 0;
    if (obs) {
      k = P.obs_cam[od];
      for (int i = 0; i < 6; ++i) dx[i] = dx_g[6 * k + i];
      for (int i = 0; i < 10; ++i) blk[i] = lmblk[10 * l + i];
      for (int a = 0; a < 3; ++a) p0[a] = lm[3 * l + a];
      const bool keep = !(P.lm_fixed && P.lm_fixed[l]);
      upd = (P.lm_valid[l] && blk[9] != 0.f && keep) ? 1.f : 0.f;
    }
    const float* Wb = Wg + (size_t)l0 * D * 18;
    for (int i = tid; i < nobs * 18; i += blockDim.x) sW[i] = Wb[i];
    __syncthreads();
    if (obs) {
      const float* Wd = sW + tid * 18;
      for (int a = 0; a < 3; ++a) {
        float s = 0.f;
        for (int i = 0; i < 6; ++i) s += Wd[i * 3 + a] * dx[i];
        sS[tid * 3 + a] = s;
      }
    }
    __syncthreads();
    if (obs) {
      float G[6];
      sym3_inv(blk, lam, G);
      float rp[3] = {blk[6], blk[7], blk[8]};
      for (int e = 0; e < D; ++e)
        for (int a = 0; a < 3; ++a) rp[a] += sS[(t * D + e) * 3 + a];
      float pn[3];
      for (int a = 0; a < 3; ++a) {
        const float dp = -(sym_get(G, a, 0) * rp[0] + sym_get(G, a, 1) * rp[1] +
                           sym_get(G, a, 2) * rp[2]) * upd;
        pn[a] = p0[a] + dp;
        if (d == 0) lmn[3 * l + a] = pn[a];
      }
      ObsTerms ob;
      obs_terms<MODEL>(P, cam, cam_Rn + 9 * k, cam_tn + 3 * k, pn, l, d, use_huber != 0, ob);
      sQ[2 * tid] = ob.wr[0];
      sQ[2 * tid + 1] = ob.sq;
    }
    __syncthreads();
    if (tid < nl) {
      // the landmark's cost in d order, as one thread summed w_d sq_d
      float cost = 0.f;
      for (int e = 0; e < D; ++e) cost += sQ[2 * (tid * D + e)] * sQ[2 * (tid * D + e) + 1];
      cost_l[l0 + tid] = cost;
    }
    // the chunk's ticket: its last block adds its costs
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int in_chunk = min(kThreadsLm, P.L - c * kThreadsLm);
      const unsigned int blocks = (unsigned int)((in_chunk + lpb - 1) / lpb);
      last = atomicInc(tickets + c, blocks - 1) == blocks - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid < 32) {
      float sum = 0.f;
      for (int w = 0; w < kThreadsLm / 32; ++w) {
        const int lc = c * kThreadsLm + w * 32 + lane;
        sum += warp_sum_down(lc < P.L ? __ldcg(cost_l + lc) : 0.f);
      }
      if (lane == 0) cost_part[c] = sum;  // lane 0's: the warps' sums in order
    }
  }
  if (!DECIDE) return;
  const int C = (P.L + kThreadsLm - 1) / kThreadsLm;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicInc(tickets + C, C - 1) == (unsigned int)(C - 1);
  __syncthreads();
  if (!last) return;
  // every chunk's partial is in: add them in chunk order and decide
  __threadfence();
  if (tid < 32) {
    float c1 = 0.f;
    for (int b0 = 0; b0 < C; b0 += 32) {
      const float v = b0 + lane < C ? __ldcg(cost_part + b0 + lane) : 0.f;
      const int m = min(32, C - b0);
      for (int i = 0; i < m; ++i) {
        const float x = __shfl_sync(kFull, v, i);
        if (lane == 0) c1 += x;
      }
    }
    if (lane == 0) improved = lm_decide(ctrl, __ldcg(ctrl + kCost0), c1, lam);
  }
  __syncthreads();
  if (!improved) return;
  copy_f32(cam_R, cam_Rn, 9 * P.K);
  copy_f32(cam_t, cam_tn, 3 * P.K);
  copy_f32(lm, lmn, 3 * P.L);
}

// W's decide mode (one block): every shard's H trial costs added in
// (shard, block) order, H's decision on this replica's ctrl, and on accept
// this replica's cameras and its own shard's L points committed.
constexpr int kThreadsDecide = 1024;

__global__ void __launch_bounds__(kThreadsDecide)
ba_decide_kernel(int K, int L, ShardParts T, float* __restrict__ ctrl, float* __restrict__ cam_R,
                 float* __restrict__ cam_t, float* __restrict__ lm,
                 const float* __restrict__ cam_Rn, const float* __restrict__ cam_tn,
                 const float* __restrict__ lmn) {
  __shared__ bool improved;
  if (threadIdx.x == 0) {
    bool imp = false;
    if (ctrl[kDone] == 0.f) {
      float c1 = 0.f;
      for (int sh = 0; sh < T.count; ++sh)
        for (int b = 0; b < T.blocks[sh]; ++b) c1 += T.ptr[sh][b];
      imp = lm_decide(ctrl, ctrl[kCost0], c1, ctrl[kLam]);
    }
    improved = imp;
  }
  __syncthreads();
  if (!improved) return;
  for (int i = threadIdx.x; i < 9 * K; i += blockDim.x) cam_R[i] = cam_Rn[i];
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) cam_t[i] = cam_tn[i];
  for (int i = threadIdx.x; i < 3 * L; i += blockDim.x) lm[i] = lmn[i];
}

// I ba_classify_kernel (grid over observations): chi-square and depth of
// every observation at the committed state. mode 0, the inliers of the
// second stage: chi2 <= thr and depth ok, or the landmark's keep flag;
// mode 1, the final outlier flags: a valid observation with chi2 > thr or
// bad depth.
template <int MODEL>
__global__ void __launch_bounds__(kThreadsLm)
ba_classify_kernel(Problem P, Cam cam, const float* __restrict__ cam_R,
                   const float* __restrict__ cam_t, const float* __restrict__ lm,
                   const uint8_t* __restrict__ keep, int mode, uint8_t* __restrict__ out) {
  const int od = blockIdx.x * blockDim.x + threadIdx.x;
  if (od >= P.L * P.D) return;
  const int l = od / P.D, k = P.obs_cam[od];
  ObsResidual q;
  obs_residual<MODEL>(P, cam, cam_R + 9 * k, cam_t + 3 * k, lm + 3 * l, od, q);
  if (mode == 0)
    out[od] = ((q.chi2 <= q.thr && q.depth_ok) || (keep && keep[l])) ? 1 : 0;
  else
    out[od] = (P.obs_valid[od] && (q.chi2 > q.thr || !q.depth_ok)) ? 1 : 0;
}

// F's index and scratch pointers from the host array `f` (the order of
// ba.py _KernelState.f_ptrs)
void unpack_f(const void* const* f, long long cap_t, int cap_s, SchurIndex& I,
              SchurScratch& X) {
  I.terms = (int2*)f[0];
  I.seg = (int4*)f[1];
  I.nseg = (int*)f[2];
  I.nterm = (int*)f[3];
  I.cam_obs = (int*)f[4];
  I.cam_seg = (int2*)f[5];
  I.cap_t = cap_t;
  I.cap_s = cap_s;
  X.A = (float*)f[6];
  X.hcr = (float*)f[7];
  X.cost = (float*)f[8];
}

// F's launches without the reduce: the terms launch, then one sum launch
// per `blocks` chunks (one when every chunk has its partial); returns the
// partial count (0: no landmark) or a negative CUDA error
int launch_linearize(int model, const Problem& P, const Cam& c, const float* cam_R,
                     const float* cam_t, const float* lm, int use_huber, float* ctrl, float* Wg,
                     float* lmblk, int blocks, float* part, const SchurIndex& I,
                     const SchurScratch& X, cudaStream_t st) {
  if (model != svt_cam::kPerspective && model != svt_cam::kEquirect)
    return -(int)cudaErrorInvalidValue;
  const int K = P.K;
  auto terms = model == svt_cam::kEquirect ? ba_terms_kernel<svt_cam::kEquirect>
                                           : ba_terms_kernel<svt_cam::kPerspective>;
  const int chunks = (P.L + kThreadsLm - 1) / kThreadsLm;
  if (chunks == 0) return 0;
  if (blocks < 1 || blocks > chunks) return -(int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)kLmF1 * P.D * (kObsStage + 18 + kHcr + 18) + kLmF1 * 9);
  const cudaError_t e = reserve_smem((const void*)terms, smem);
  if (e != cudaSuccess) return -(int)e;
  terms<<<(P.L + kLmF1 - 1) / kLmF1, kThreadsF1, smem, st>>>(
      P, c, cam_R, cam_t, lm, use_huber, ctrl, Wg, lmblk, X, part,
      (long long)blocks * (long long)f_partial_size(K));
  for (int c0 = 0; c0 < chunks; c0 += blocks) {
    const int nc = min(blocks, chunks - c0);
    const int per_block = kThreadsF2 / 32;  // a warp an item
    const int nb_pair = (int)(((long long)nc * I.cap_s + per_block - 1) / per_block);
    const int nb_cam = (nc * K + per_block - 1) / per_block;
    const int nb_cost = (nc + kThreadsF2 - 1) / kThreadsF2;
    ba_schur_sum_kernel<<<nb_pair + nb_cam + nb_cost, kThreadsF2, 0, st>>>(
        K, P.L, I, c0, nc, blocks, nb_pair, nb_cam, X.A, Wg, X.hcr, X.cost, ctrl, part);
  }
  return blocks;
}

void launch_reduce(int K, const ShardParts& T, float* ctrl, float* hc, float* S, float* rhs,
                   cudaStream_t st) {
  const size_t n = f_partial_size(K);
  ba_reduce_kernel<<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
                     st>>>(K, T, ctrl, hc, S, rhs);
}

}  // namespace

// model: 0 perspective, 2 equirectangular (camera.cuh), for F, H and I
extern "C" int svt_ba_linearize(int model, int K, int L, int D, const int* obs_cam,
                                const float* obs_uv, const float* obs_xr,
                                const float* obs_isig, const uint8_t* obs_valid,
                                const uint8_t* inlier, const uint8_t* lm_valid,
                                const uint8_t* lm_fixed, const float* cam_free, float fx,
                                float fy, float cx, float cy, float fxb, float width,
                                float height, const float* cam_R, const float* cam_t,
                                const float* lm, int use_huber, float* ctrl, float* Wg,
                                float* lmblk, float* hc, float* S, float* rhs, int blocks,
                                float* part, const void* const* f, long long cap_t, int cap_s,
                                void* stream) {
  // blocks: F's partial count (at most one per landmark chunk); part:
  // blocks x (33K + 1 + 36K^2) floats of device memory; f, cap_t, cap_s:
  // the pair index and the scratch (unpack_f)
  Problem P{K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier, lm_valid,
            lm_fixed, cam_free};
  Cam c{fx, fy, cx, cy, fxb, width, height};
  SchurIndex I;
  SchurScratch X;
  unpack_f(f, cap_t, cap_s, I, X);
  cudaStream_t st = (cudaStream_t)stream;
  const int launched = launch_linearize(model, P, c, cam_R, cam_t, lm, use_huber, ctrl, Wg,
                                        lmblk, blocks, part, I, X, st);
  if (launched < 0) return -launched;
  if (launched > 0) {
    ShardParts T{};
    T.ptr[0] = part;
    T.blocks[0] = launched;
    T.count = 1;
    launch_reduce(K, T, ctrl, hc, S, rhs, st);
  }
  return (int)cudaGetLastError();
}

// F's launches without the reduce, on one shard of a sharded BA: its
// partials, which W's reduce mode adds
extern "C" int svt_ba_linearize_part(int model, int K, int L, int D, const int* obs_cam,
                                     const float* obs_uv, const float* obs_xr,
                                     const float* obs_isig, const uint8_t* obs_valid,
                                     const uint8_t* inlier, const uint8_t* lm_valid,
                                     const uint8_t* lm_fixed, const float* cam_free, float fx,
                                     float fy, float cx, float cy, float fxb, float width,
                                     float height, const float* cam_R, const float* cam_t,
                                     const float* lm, int use_huber, float* ctrl, float* Wg,
                                     float* lmblk, int blocks, float* part, const void* const* f,
                                     long long cap_t, int cap_s, void* stream) {
  Problem P{K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier, lm_valid,
            lm_fixed, cam_free};
  Cam c{fx, fy, cx, cy, fxb, width, height};
  SchurIndex I;
  SchurScratch X;
  unpack_f(f, cap_t, cap_s, I, X);
  const int launched = launch_linearize(model, P, c, cam_R, cam_t, lm, use_huber, ctrl, Wg,
                                        lmblk, blocks, part, I, X, (cudaStream_t)stream);
  if (launched < 0) return -launched;
  return (int)cudaGetLastError();
}

// F's pair index, once per BA: one block per 128-landmark chunk. f holds
// the index's pointers (unpack_f's first six); key0, key1 (ints) and val1
// (int pairs) are scratch of chunks x cap_t entries.
extern "C" int svt_ba_schur_index(int K, int L, int D, const int* obs_cam,
                                  const uint8_t* obs_valid, const uint8_t* lm_valid,
                                  const uint8_t* lm_fixed, const void* const* f, long long cap_t,
                                  int cap_s, int* key0, int* key1, int* val1, void* stream) {
  const int chunks = (L + kThreadsLm - 1) / kThreadsLm;
  if (chunks == 0) return 0;
  if (K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  SchurIndex I;
  SchurScratch X;
  unpack_f(f, cap_t, cap_s, I, X);
  const size_t smem =
      sizeof(int) * (2 * (size_t)kThreadsLm * D + (size_t)kIdxWarps * K + kThreadsIdx + kIdxWarps);
  const cudaError_t e = reserve_smem((const void*)ba_schur_index_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ba_schur_index_kernel<<<chunks, kThreadsIdx, smem, (cudaStream_t)stream>>>(
      K, L, D, obs_cam, obs_valid, lm_valid, lm_fixed, I, key0, key1, (int2*)val1);
  return (int)cudaGetLastError();
}

// G: scratch (scratch_floats floats of device memory) is read when 6K > 768
extern "C" int svt_ba_solve(int K, const float* cam_free, const float* cam_R,
                            const float* cam_t, float* ctrl, float* hc, float* S, float* rhs,
                            float* dx, float* cam_Rn, float* cam_tn, float* scratch,
                            long long scratch_floats, void* stream) {
  SolveArgs a{};
  a.n = 6 * K;
  a.K = K;
  a.cam_free = cam_free;
  a.cam_R = cam_R;
  a.cam_t = cam_t;
  a.ctrl = ctrl;
  a.hc = hc;
  a.S = S;
  a.rhs = rhs;
  a.dx = dx;
  a.cam_Rn = cam_Rn;
  a.cam_tn = cam_tn;
  const cudaError_t e =
      launch_solve<kSysBA>(a, scratch, (size_t)scratch_floats, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// G's factorization on a plain SPD system: x = A^-1 b from A's lower
// triangle (n x n, row-major) by the same routes
extern "C" int svt_spd_solve(int n, const float* A, const float* b, float* x, float* scratch,
                             long long scratch_floats, void* stream) {
  SolveArgs a{};
  a.n = n;
  a.A = A;
  a.b = b;
  a.x = x;
  const cudaError_t e =
      launch_solve<kSysSPD>(a, scratch, (size_t)scratch_floats, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// decide: 1 for one device (the block that completes the last chunk
// decides), 0 on one shard of a sharded BA (the chunk partials only; W's
// decide mode decides). tickets: C + 1 zeroed counters (C = the
// 128-landmark chunks), left at zero by every launch; cost_l: C * 128
// floats of scratch; cost_part: C floats.
extern "C" int svt_ba_backsub(int model, int K, int L, int D, const int* obs_cam,
                              const float* obs_uv, const float* obs_xr, const float* obs_isig,
                              const uint8_t* obs_valid, const uint8_t* inlier,
                              const uint8_t* lm_valid, const uint8_t* lm_fixed,
                              const float* cam_free, float fx, float fy, float cx, float cy,
                              float fxb, float width, float height, float* cam_R,
                              float* cam_t, float* lm, int use_huber, float* ctrl,
                              unsigned int* tickets, const float* Wg, const float* lmblk,
                              const float* dx, const float* cam_Rn, const float* cam_tn,
                              float* lmn, float* cost_l, float* cost_part, int decide,
                              void* stream) {
  if (model != svt_cam::kPerspective && model != svt_cam::kEquirect)
    return (int)cudaErrorInvalidValue;
  if (D < 1 || D > kThreadsLm) return (int)cudaErrorInvalidValue;
  Problem P{K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier, lm_valid,
            lm_fixed, cam_free};
  Cam c{fx, fy, cx, cy, fxb, width, height};
  // a thread a landmark up to D = 3, else lpb landmarks a block and a
  // thread an observation (ba_backsub_kernel's note)
  int lpb = kThreadsLm, threads = kThreadsLm;
  size_t smem = 0;
  if (D > 3) {
    int d2 = 1;
    while (d2 < D) d2 *= 2;
    lpb = kThreadsLm / d2;
    threads = (lpb * D + 31) / 32 * 32;
    smem = sizeof(float) * (size_t)lpb * D * 23;
  }
  const int blocks = (L + lpb - 1) / lpb;
  const bool eq = model == svt_cam::kEquirect;
  auto kernel = decide ? (eq ? ba_backsub_kernel<svt_cam::kEquirect, true>
                             : ba_backsub_kernel<svt_cam::kPerspective, true>)
                       : (eq ? ba_backsub_kernel<svt_cam::kEquirect, false>
                             : ba_backsub_kernel<svt_cam::kPerspective, false>);
  if (blocks > 0)
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        P, c, cam_R, cam_t, lm, use_huber, ctrl, tickets, Wg, lmblk, dx, cam_Rn, cam_tn, lmn,
        cost_l, cost_part, lpb);
  return (int)cudaGetLastError();
}

// W on one device of a sharded BA, for its replica (ctrl, hc, S, rhs,
// cam_R, cam_t) and its own shard's L points (lm, lmn): mode 0 adds the
// shards' F partials (parts[s]: blocks[s] partials of 33K + 1 + 36K^2
// floats), mode 1 the shards' H trial costs (parts[s]: blocks[s] floats) and
// decides. parts and blocks are host arrays of nshards entries; a part may
// lie on another device that this one has peer access to.
extern "C" int svt_ba_shard_assemble(int mode, int K, int L, int nshards, const float* const* parts,
                                     const int* blocks, float* ctrl, float* hc, float* S,
                                     float* rhs, float* cam_R, float* cam_t, float* lm,
                                     const float* cam_Rn, const float* cam_tn, const float* lmn,
                                     void* stream) {
  if (nshards < 1 || nshards > kMaxShards || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  ShardParts T{};
  for (int i = 0; i < nshards; ++i) {
    T.ptr[i] = parts[i];
    T.blocks[i] = blocks[i];
  }
  T.count = nshards;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0)
    launch_reduce(K, T, ctrl, hc, S, rhs, st);
  else
    ba_decide_kernel<<<1, kThreadsDecide, 0, st>>>(K, L, T, ctrl, cam_R, cam_t, lm, cam_Rn,
                                                   cam_tn, lmn);
  return (int)cudaGetLastError();
}

// Lets `device` read `peer`'s memory (W's reads of other cards' partials);
// an error when the two cannot reach each other. The caller's current
// device is kept.
extern "C" int svt_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)e;
}

extern "C" int svt_ba_classify(int model, int K, int L, int D, const int* obs_cam,
                               const float* obs_uv, const float* obs_xr,
                               const float* obs_isig, const uint8_t* obs_valid, float fx,
                               float fy, float cx, float cy, float fxb, float width,
                               float height, const float* cam_R, const float* cam_t,
                               const float* lm, const uint8_t* keep, int mode, uint8_t* out,
                               void* stream) {
  if (model != svt_cam::kPerspective && model != svt_cam::kEquirect)
    return (int)cudaErrorInvalidValue;
  Problem P{K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, nullptr, nullptr, nullptr,
            nullptr};
  Cam c{fx, fy, cx, cy, fxb, width, height};
  const int blocks = (L * D + kThreadsLm - 1) / kThreadsLm;
  auto kernel = model == svt_cam::kEquirect ? ba_classify_kernel<svt_cam::kEquirect>
                                            : ba_classify_kernel<svt_cam::kPerspective>;
  if (blocks > 0)
    kernel<<<blocks, kThreadsLm, 0, (cudaStream_t)stream>>>(P, c, cam_R, cam_t, lm, keep,
                                                           mode, out);
  return (int)cudaGetLastError();
}
