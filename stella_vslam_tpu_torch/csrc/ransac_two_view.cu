// Kernel E: batched two-view RANSAC for the monocular initializer.
//
// Replaces the hypothesis programs of stella_vslam_tpu/ops/solve/
// homography.py (_find_core :107, find_via_ransac :137,
// find_via_ransac_escalated :152) and fundamental.py (:73, :102, :117), with
// the sampler of ransac.py (hash_uniform :30, sample_minimal_sets :50,
// escalate_scan :84, select_best :110) and the null-vector extractor of
// linalg.py (smallest_eigvec_spd :143). The TPU form materialises a [B,k,N]
// tensor of hashed uniforms for a Gumbel-argmax, one-hot gathers, [B,9,9]
// batched matmuls for 18 squarings, a batched SVD for the rank-2 projection
// of F and a [B,N] score matrix, then selects, refits and (escalated) scans
// the chunks.
//
// And, as MODEL 2, the essential matrix on bearing vectors of
// ops/solve/essential.py (_find_core :82 with compute_E_21 :46 and
// _angular_cost :65; find_via_ransac :113, find_via_ransac_escalated :129
// and the scoring, selection and LO refits of find_via_ransac_5pt :144): the
// 8-point E fit on bearings [N,3] with no normalisation and no rank step,
// the same 18-squaring null vector, and the angular score (the sine of each
// bearing's angle to its epipolar plane, both views, inlier above
// cos(1 deg), cost 1 - worst, capped at 1 - cos(1 deg)).
//
// On Hopper a batch with its LO rounds is two launches, whatever the number
// of chunks (one, or the escalated sweep's eight), templated on the model
// (0: homography, k = 4; 1: fundamental, k = 8; 2: essential, k = 8):
//  * svt_ransac_minimal: a block of 128 threads a hypothesis, of one chunk
//    (the grid's y). The block draws the k indices in one pass over the N
//    matches (per slot the argmax of the hash, lowest index on ties,
//    invalid positions below every valid one); then warp 0 fits the model
//    alone: the Hartley normalisation (sums in point order) and A^T A (a
//    lane an entry, the FMA chain over the rows), the 18 squarings of
//    (sigma I - A^T A) / sigma with Frobenius renormalisation on its 9x9
//    in shared memory under __syncwarp only, the rank-2 projection of F (one-sided Jacobi SVD of
//    the 3x3 in double on one lane, ended by the first sweep that rotates
//    nothing) and the denormalisation; then the block scores the model on
//    all N matches (H: symmetric transfer through the adjugate inverse;
//    F: symmetric epipolar distance; chi-square cap 5.991; E: the angular
//    score) and reduces its cost and inlier count. (Four hypotheses a block
//    of 128 threads, a warp each, measured slower: F 0.131 against 0.107
//    ms; their sampler held 32 running maxima a thread.)
//  * svt_ransac_finish: a block of 1024 threads a chunk: the argmin of the
//    gated costs (count > min_inliers, first on ties), the winner's inlier
//    mask, then the LO rounds, each a nonminimal DLT over the masked rows
//    (normalisation and A^T A as block reductions, the null vector by one
//    warp) and the new mask, kept when its consensus does not shrink, and
//    the result fields; with `escalate`, the last block to finish (a ticket
//    on a per-stream counter, which it leaves at zero) carries
//    escalate_scan's rule over the chunks in order: a chunk that is valid
//    and has strictly more inliers is taken (the first of equals), from an
//    all-zero carry. No host read and no torch operation between the two.
//  * svt_ransac_score: one block per given model (E only: the 5-point
//    solver's candidates, kernel U), scored on all N matches; a candidate
//    flagged invalid scores no inlier. Its selection and LO rounds are the
//    finish launch's.
// Bound: operations. At B = 1024, N = 2872 a batch hashes B*k*N values
// (23.5 M for F, integer operations: the hash's 2 multiplies, 3 shifts, 3
// xors and an add, the argmax compare and select, ~11), which the card's
// INT32 units take at 64 lanes an SM; it scores B*N = 2.9 M pairs (~40
// flops each) and fits B models (18 9x9 products); its bytes are ~50 KB of
// points. Every [B,k,N] and [B,N] intermediate stays in registers.
//
// Float32 like the JAX version. The minimal fit rounds as the plain
// version's, which rounds as the JAX version's jitted program on the CPU
// (every sum in its order, every contraction an `__fmaf_rn`, every other
// operation rounded on its own; ops/linalg.py), up to F's rank-2 step: the
// plain takes LAPACK's sgesdd, the kernel a Jacobi SVD in double. The
// score of F rounds as the plain's too, and so do the LO refits'
// normalisation sums (XLA's windows of 32: a thread a window, then a
// thread a window of partials, then one thread; windowed_sum). H's
// transfer error and the refits' A^T A (shuffle-down trees, warps in
// order) take their own order. So models agree to a tolerance, not bit for bit; the sampled
// indices are exact (the hash is integer arithmetic and its uniforms are
// exact in f32). Where a minimal set's A^T A has a small eigen-gap the 18
// squarings do not converge, and a rounding moves the null vector
// (chip_smoke.py holds the share of hypotheses whose inlier count equals
// plain's).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ransac_sample.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kEssential = 2;
// essential.py COS_ANGLE_THR = cos(1 deg) and its cost cap 1 - cos(1 deg),
// each rounded once to f32 as the JAX version's weak-typed constants are
constexpr float kCosThr = 0.9998476951563913f;
constexpr float kCosCap = 1.5230484360873042e-4f;

// coordinates per correspondence: pixels, or bearing vectors for E
template <int MODEL>
__host__ __device__ constexpr int dim_of() {
  return MODEL == kEssential ? 3 : 2;
}

// Sum of NV values over the block; every thread gets the totals. scratch
// holds (blockDim/32 + 1) * NV floats. Warps are summed in order.
template <int NV>
__device__ void block_sum(float (&v)[NV], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
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

// The sums over rows 0..n-1 of NV values each in XLA's CPU order (its
// optimized HLO of the JAX version's masked sums, ops/linalg.sum_windowed):
// up to 32 rows one thread adds them in order from 0; above, the rows are
// padded with zeros to a multiple of 32, floor(P / 2) before and ceil(P /
// 2) after, a thread sums each window of 32 in order from 0 (the padding
// and the rows that `row` skips add nothing: a sum from +0 never holds -0),
// the same again over the partials while more than 32 remain, and one
// thread adds the last in order. row(i, v) fills row i's values and returns
// false for a row to skip. part: 2 * NV * (ceil(n / 32) + 2) floats of
// global scratch for this block. Every thread gets the totals in out.
__device__ __forceinline__ int window_pad_lo(int n) { return ((32 - (n & 31)) & 31) >> 1; }

template <int NV, class Row>
__device__ void windowed_sum(int n, Row row, float* part, float (&out)[NV], float* shared) {
  const int tid = threadIdx.x;
  if (n <= 32) {
    if (tid == 0) {
      float s[NV] = {};
      for (int i = 0; i < n; ++i) {
        float v[NV];
        if (!row(i, v)) continue;
#pragma unroll
        for (int q = 0; q < NV; ++q) s[q] = __fadd_rn(s[q], v[q]);
      }
#pragma unroll
      for (int q = 0; q < NV; ++q) shared[q] = s[q];
    }
  } else {
    int w = (n + 31) >> 5, lo = window_pad_lo(n);
    for (int j = tid; j < w; j += blockDim.x) {
      float s[NV] = {};
      const int i0 = 32 * j - lo;
      for (int i = max(i0, 0); i < min(i0 + 32, n); ++i) {
        float v[NV];
        if (!row(i, v)) continue;
#pragma unroll
        for (int q = 0; q < NV; ++q) s[q] = __fadd_rn(s[q], v[q]);
      }
#pragma unroll
      for (int q = 0; q < NV; ++q) part[j * NV + q] = s[q];
    }
    __syncthreads();
    float* src = part;
    float* dst = part + NV * (w + 2);
    while (w > 32) {
      const int w2 = (w + 31) >> 5;
      lo = window_pad_lo(w);
      for (int j = tid; j < w2; j += blockDim.x) {
        float s[NV] = {};
        const int k0 = 32 * j - lo;
        for (int k = max(k0, 0); k < min(k0 + 32, w); ++k)
#pragma unroll
          for (int q = 0; q < NV; ++q) s[q] = __fadd_rn(s[q], src[k * NV + q]);
#pragma unroll
        for (int q = 0; q < NV; ++q) dst[j * NV + q] = s[q];
      }
      __syncthreads();
      float* t = src;
      src = dst;
      dst = t;
      w = w2;
    }
    if (tid == 0) {
      float s[NV] = {};
      for (int k = 0; k < w; ++k)
#pragma unroll
        for (int q = 0; q < NV; ++q) s[q] = __fadd_rn(s[q], src[k * NV + q]);
#pragma unroll
      for (int q = 0; q < NV; ++q) shared[q] = s[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) out[q] = shared[q];
  __syncthreads();
}

// Hartley normalization: T = [[sx,0,tx],[0,sy,ty],[0,0,1]] per image, over
// the rows of mask w, its sums in XLA's windowed order (windowed_sum), the
// mean and the deviation true divisions by the count
struct Norm {
  float m1x, m1y, d1x, d1y, m2x, m2y, d2x, d2y;
};

__device__ Norm normalization(const float* p1, const float* p2, const uint8_t* w, int n,
                              float* part, float* scratch) {
  float s[5];
  windowed_sum<5>(
      n,
      [&](int i, float (&v)[5]) {
        if (!w[i]) return false;
        v[0] = 1.f;
        v[1] = p1[2 * i];
        v[2] = p1[2 * i + 1];
        v[3] = p2[2 * i];
        v[4] = p2[2 * i + 1];
        return true;
      },
      part, s, scratch);
  const float cnt = __fadd_rn(s[0], 1e-12f);
  Norm r;
  r.m1x = __fdiv_rn(s[1], cnt);
  r.m1y = __fdiv_rn(s[2], cnt);
  r.m2x = __fdiv_rn(s[3], cnt);
  r.m2y = __fdiv_rn(s[4], cnt);
  float d[4];
  windowed_sum<4>(
      n,
      [&](int i, float (&v)[4]) {
        if (!w[i]) return false;
        v[0] = fabsf(__fsub_rn(p1[2 * i], r.m1x));
        v[1] = fabsf(__fsub_rn(p1[2 * i + 1], r.m1y));
        v[2] = fabsf(__fsub_rn(p2[2 * i], r.m2x));
        v[3] = fabsf(__fsub_rn(p2[2 * i + 1], r.m2y));
        return true;
      },
      part, d, scratch);
  r.d1x = __fadd_rn(__fdiv_rn(d[0], cnt), 1e-12f);
  r.d1y = __fadd_rn(__fdiv_rn(d[1], cnt), 1e-12f);
  r.d2x = __fadd_rn(__fdiv_rn(d[2], cnt), 1e-12f);
  r.d2y = __fadd_rn(__fdiv_rn(d[3], cnt), 1e-12f);
  return r;
}

// DLT rows of one normalized correspondence (2 for H, 1 for F)
template <int MODEL>
__device__ __forceinline__ int dlt_rows(float x1, float y1, float x2, float y2,
                                        float a[2][9]) {
  if (MODEL == 0) {
    const float ra[9] = {0.f, 0.f, 0.f, -x1, -y1, -1.f, __fmul_rn(y2, x1), __fmul_rn(y2, y1), y2};
    const float rb[9] = {x1, y1, 1.f, 0.f, 0.f, 0.f, __fmul_rn(-x2, x1), __fmul_rn(-x2, y1), -x2};
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      a[0][i] = ra[i];
      a[1][i] = rb[i];
    }
    return 2;
  }
  const float r[9] = {__fmul_rn(x2, x1), __fmul_rn(x2, y1), x2, __fmul_rn(y2, x1),
                      __fmul_rn(y2, y1), y2, x1, y1, 1.f};
#pragma unroll
  for (int i = 0; i < 9; ++i) a[0][i] = r[i];
  return 1;
}

// Rank-2 projection of a 3x3 (row-major) by a one-sided Jacobi SVD in
// double: F - s3 u3 v3^T, with (s3 u3, v3) the column of F V of least norm.
__device__ void rank2_project(float* F) {
  double W[3][3], V[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) W[i][j] = F[i * 3 + j];
  // at most 12 sweeps, ended by the first that rotates no pair: a pair
  // whose columns are orthogonal to 1e-15 of their norms is left, below
  // which a rotation moves W by less than float32 can hold
  for (int sweep = 0; sweep < 12; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        double a = 0, b = 0, g = 0;
        for (int i = 0; i < 3; ++i) {
          a += W[i][p] * W[i][p];
          b += W[i][q] * W[i][q];
          g += W[i][p] * W[i][q];
        }
        if (fabs(g) <= 1e-300 || fabs(g) <= 1e-15 * sqrt(a * b)) continue;
        rotated = true;
        const double zeta = (b - a) / (2.0 * g);
        const double t = (zeta >= 0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        const double c = 1.0 / sqrt(1.0 + t * t), s = c * t;
        for (int i = 0; i < 3; ++i) {
          const double wp = W[i][p], wq = W[i][q];
          W[i][p] = c * wp - s * wq;
          W[i][q] = s * wp + c * wq;
          const double vp = V[i][p], vq = V[i][q];
          V[i][p] = c * vp - s * vq;
          V[i][q] = s * vp + c * vq;
        }
      }
    }
    if (!rotated) break;
  }
  int m = 0;
  double best = 0;
  for (int j = 0; j < 3; ++j) {
    const double nj = W[0][j] * W[0][j] + W[1][j] * W[1][j] + W[2][j] * W[2][j];
    if (j == 0 || nj < best) {
      best = nj;
      m = j;
    }
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) F[i * 3 + j] = (float)((double)F[i * 3 + j] - W[i][m] * V[j][m]);
}

// C = A B, each entry the FMA chain a_i0 b_0j, then + a_ik b_kj in k order
// (the plain version's matmul_f32, XLA's CPU dot)
__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = __fmaf_rn(A[i * 3 + 2], B[2 * 3 + j],
                               __fmaf_rn(A[i * 3 + 1], B[1 * 3 + j],
                                         __fmul_rn(A[i * 3 + 0], B[0 * 3 + j])));
}

// H = T2^-1 Hn T1, F = T2^T rank2(Fn) T1 from the normalised null vector h
template <int MODEL>
__device__ void fit_denormalise(float* h, const Norm& nm, float* model) {
  if (MODEL == 1) rank2_project(h);
  const float sx1 = __fdiv_rn(1.f, nm.d1x), sy1 = __fdiv_rn(1.f, nm.d1y);
  const float sx2 = __fdiv_rn(1.f, nm.d2x), sy2 = __fdiv_rn(1.f, nm.d2y);
  const float T1[9] = {sx1, 0.f, __fmul_rn(-nm.m1x, sx1), 0.f, sy1, __fmul_rn(-nm.m1y, sy1),
                       0.f, 0.f, 1.f};
  const float tx2 = __fmul_rn(-nm.m2x, sx2), ty2 = __fmul_rn(-nm.m2y, sy2);
  float L[9];
  if (MODEL == 0) {
    // T2^-1 as jnp.linalg.inv takes it on the CPU (homography._inverse_T):
    // the translation times the diagonal's reciprocal
    const float rx = __fdiv_rn(1.f, sx2), ry = __fdiv_rn(1.f, sy2);
    const float T2i[9] = {rx, 0.f, __fmul_rn(-tx2, rx), 0.f, ry, __fmul_rn(-ty2, ry),
                          0.f, 0.f, 1.f};
    for (int q = 0; q < 9; ++q) L[q] = T2i[q];
  } else {
    const float T2t[9] = {sx2, 0.f, 0.f, 0.f, sy2, 0.f, tx2, ty2, 1.f};
    for (int q = 0; q < 9; ++q) L[q] = T2t[q];
  }
  float tmp[9];
  matmul3(L, h, tmp);
  matmul3(tmp, T1, model);
}

// Adjugate inverse of a 3x3 (row-major)
__device__ void inverse3(const float* H, float* Hi) {
  const float a = H[0], b = H[1], c = H[2], d = H[3], e = H[4], f = H[5], g = H[6],
              h = H[7], i = H[8];
  const float A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const float A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const float A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  const float det = a * A11 + b * A21 + c * A31;
  Hi[0] = A11 / det; Hi[1] = A12 / det; Hi[2] = A13 / det;
  Hi[3] = A21 / det; Hi[4] = A22 / det; Hi[5] = A23 / det;
  Hi[6] = A31 / det; Hi[7] = A32 / det; Hi[8] = A33 / det;
}

__device__ __forceinline__ float transfer_err(const float* H, float px, float py, float qx,
                                              float qy) {
  const float x = H[0] * px + H[1] * py + H[2];
  const float y = H[3] * px + H[4] * py + H[5];
  float w = H[6] * px + H[7] * py + H[8];
  w = fabsf(w) < 1e-12f ? 1e-12f : w;
  const float dx = x / w - qx, dy = y / w - qy;
  return dx * dx + dy * dy;
}

// distance^2 of one correspondence under the model (Mi: H^-1 for model 0)
template <int MODEL>
__device__ __forceinline__ void pair_dist(const float* M, const float* Mi, float x1, float y1,
                                          float x2, float y2, float& d1, float& d2) {
  if (MODEL == 0) {
    d1 = transfer_err(M, x1, y1, x2, y2);
    d2 = transfer_err(Mi, x2, y2, x1, y1);
  } else {
    // fundamental._epipolar_cost's rounding (the JAX version's jitted
    // einsums): each epiline entry fma(F_i1, y, F_i0 x) + F_i2, the
    // residual fma(y', l1, x' l0) + l2, the denominator fma(l0, l0, l1 l1)
    float l2[3], l1[3];
    for (int i = 0; i < 3; ++i)
      l2[i] = __fadd_rn(__fmaf_rn(M[i * 3 + 1], y1, __fmul_rn(M[i * 3 + 0], x1)), M[i * 3 + 2]);
    for (int j = 0; j < 3; ++j)
      l1[j] = __fadd_rn(__fmaf_rn(M[1 * 3 + j], y2, __fmul_rn(M[0 * 3 + j], x2)), M[2 * 3 + j]);
    const auto dist = [](float x, float y, const float* l) {
      const float e = __fadd_rn(__fmaf_rn(y, l[1], __fmul_rn(x, l[0])), l[2]);
      return __fdiv_rn(__fmul_rn(e, e),
                       __fadd_rn(__fmaf_rn(l[0], l[0], __fmul_rn(l[1], l[1])), 1e-12f));
    };
    d2 = dist(x2, y2, l2);
    d1 = dist(x1, y1, l1);
  }
}

// essential.py _angular_cost of one bearing pair under E (row-major):
// whether it is an inlier, and its cost term
__device__ __forceinline__ float angular_score(const float* E, const float* b1, const float* b2,
                                               bool& inl) {
  float ep2[3], ep1[3];  // E b1 (the epipolar plane's normal in 2), E^T b2
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ep2[i] = E[3 * i] * b1[0] + E[3 * i + 1] * b1[1] + E[3 * i + 2] * b1[2];
    ep1[i] = E[i] * b2[0] + E[3 + i] * b2[1] + E[6 + i] * b2[2];
  }
  auto sine = [](const float* ep, const float* b) {
    const float c0 = ep[1] * b[2] - ep[2] * b[1];
    const float c1 = ep[2] * b[0] - ep[0] * b[2];
    const float c2 = ep[0] * b[1] - ep[1] * b[0];
    return sqrtf(c0 * c0 + c1 * c1 + c2 * c2) /
           (sqrtf(ep[0] * ep[0] + ep[1] * ep[1] + ep[2] * ep[2]) + 1e-12f);
  };
  const float cos2 = sine(ep2, b2), cos1 = sine(ep1, b1);
  // jnp.minimum: a NaN propagates (and then counts as an outlier)
  const float worst = (isnan(cos1) || isnan(cos2)) ? cos1 + cos2 : fminf(cos1, cos2);
  inl = worst > kCosThr;
  return inl ? 1.f - worst : kCosCap;
}

// One thread's share of the scores of all N matches under model M (the
// points n = threadIdx.x, + blockDim.x, ...): s[0] += cost, s[1] += 1 for
// an inlier; optionally writes the inlier mask. `none`: the model is
// invalid, every valid match is an outlier.
template <int MODEL>
__device__ void score_partial(const float* M, const float* p1, const float* p2,
                              const uint8_t* valid, int N, float thr, uint8_t* mask,
                              float (&s)[2], bool none = false) {
  constexpr int D = dim_of<MODEL>();
  float Mi[9];
  if (MODEL == 0) inverse3(M, Mi);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool inl = false;
    if (valid[n]) {
      float c;
      if constexpr (MODEL == kEssential) {
        c = angular_score(M, p1 + D * n, p2 + D * n, inl);
      } else {
        float d1, d2;
        pair_dist<MODEL>(M, Mi, p1[2 * n], p1[2 * n + 1], p2[2 * n], p2[2 * n + 1], d1, d2);
        // max(d1, d2) < thr, with a NaN counting as an outlier
        inl = d1 < thr && d2 < thr;
        c = inl ? fmaxf(d1, d2) : thr;
      }
      if (none) {
        inl = false;
        c = MODEL == kEssential ? kCosCap : thr;
      }
      s[0] += c;
      s[1] += inl ? 1.f : 0.f;
    }
    if (mask) mask[n] = inl ? 1 : 0;
  }
}

// A warp's 9x9 workspace for one null vector.
struct WarpFit {
  float ata[81];
  float M[81];
  float M2[81];
};

// The null vector of the A^T A in wf->ata (full 9x9): the body of
// warp_null_vector. Every lane of the warp calls it.
template <int MODEL>
__device__ void warp_null_vector_of_ata(const Norm& nm, WarpFit* wf, float* model) {
  const int lane = threadIdx.x & 31;
  float r = 0.f;  // the row sums in order from 0 (linalg.sum_in_order)
  if (lane < 9)
    for (int v = 0; v < 9; ++v) r = __fadd_rn(r, fabsf(wf->ata[lane * 9 + v]));
  float sigma = fmaxf(0.f, r);
  for (int o = 16; o > 0; o >>= 1) sigma = fmaxf(sigma, __shfl_xor_sync(0xffffffffu, sigma, o));
  for (int q = lane; q < 81; q += 32) {
    const int i = q / 9, j = q % 9;
    wf->M[q] = __fdiv_rn(__fsub_rn(i == j ? sigma : 0.f, wf->ata[q]), __fadd_rn(sigma, 1e-30f));
  }
  __syncwarp();
  // as the plain version (linalg.smallest_eigvec_spd_in_order) rounds it:
  // each square's entry an FMA chain over m, the squared norms FMA chains
  // from 0 in order, the roots correctly rounded
  for (int it = 0; it < 18; ++it) {
    for (int q = lane; q < 81; q += 32) {
      const int i = q / 9, j = q % 9;
      float s = __fmul_rn(wf->M[i * 9], wf->M[j]);
      for (int m = 1; m < 9; ++m) s = __fmaf_rn(wf->M[i * 9 + m], wf->M[m * 9 + j], s);
      wf->M2[q] = s;
    }
    __syncwarp();
    float s = 0.f;
    for (int q = 0; q < 81; ++q) s = __fmaf_rn(wf->M2[q], wf->M2[q], s);
    const float nrm = __fadd_rn(__fsqrt_rn(s), 1e-30f);
    for (int q = lane; q < 81; q += 32) wf->M[q] = __fdiv_rn(wf->M2[q], nrm);
    __syncwarp();
  }
  if (lane == 0) {
    int col = 0;
    float bestn = -1.f;
    for (int j = 0; j < 9; ++j) {
      float s = 0.f;
      for (int i = 0; i < 9; ++i) s = __fmaf_rn(wf->M[i * 9 + j], wf->M[i * 9 + j], s);
      if (s > bestn) {
        bestn = s;
        col = j;
      }
    }
    float h[9], nn = 0.f;
    for (int i = 0; i < 9; ++i) {
      h[i] = wf->M[i * 9 + col];
      nn = __fmaf_rn(h[i], h[i], nn);
    }
    nn = __fadd_rn(__fsqrt_rn(nn), 1e-12f);
    for (int i = 0; i < 9; ++i) h[i] = __fdiv_rn(h[i], nn);
    if (MODEL == kEssential) {
      for (int q = 0; q < 9; ++q) model[q] = h[q];
    } else {
      fit_denormalise<MODEL>(h, nm, model);
    }
  }
  __syncwarp();
}

// The null vector of A^T A (upper triangle `acc`, row by row, in every
// lane) by one warp: sigma = the largest absolute row sum, M = (sigma I -
// A^T A) / sigma squared 18 times, each square renormalised by its
// Frobenius norm (a serial chain, as one thread took it), then the column
// of largest norm (first on ties), normalised; E keeps it, H and F are
// projected (F to rank 2) and denormalised into `model` by lane 0. Every
// lane of the warp calls it.
template <int MODEL>
__device__ void warp_null_vector(const float (&acc)[45], const Norm& nm, WarpFit* wf,
                                 float* model) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    int q = 0;
    for (int u = 0; u < 9; ++u)
      for (int v = u; v < 9; ++v) {
        wf->ata[u * 9 + v] = acc[q];
        wf->ata[v * 9 + u] = acc[q];
        ++q;
      }
  }
  __syncwarp();
  warp_null_vector_of_ata<MODEL>(nm, wf, model);
}

// Lane i < n of a warp adds correspondence i's DLT rows (on normalised
// points; bearings for E) to the 45 upper-triangle sums of A^T A.
template <int MODEL>
__device__ __forceinline__ void add_ata_rows(const float* p1, const float* p2, int i,
                                             const Norm& nm, float (&acc)[45]) {
  float a[2][9];
  int nr = 1;
  if constexpr (MODEL == kEssential) {
    // rows [b2.x b1, b2.y b1, b2.z b1] (compute_E_21)
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) a[0][3 * u + v] = p2[3 * i + u] * p1[3 * i + v];
  } else {
    const float x1 = (p1[2 * i] - nm.m1x) / nm.d1x, y1 = (p1[2 * i + 1] - nm.m1y) / nm.d1y;
    const float x2 = (p2[2 * i] - nm.m2x) / nm.d2x, y2 = (p2[2 * i + 1] - nm.m2y) / nm.d2y;
    nr = dlt_rows<MODEL>(x1, y1, x2, y2, a);
  }
  for (int r = 0; r < nr; ++r) {
    int q = 0;
#pragma unroll
    for (int u = 0; u < 9; ++u)
#pragma unroll
      for (int v = u; v < 9; ++v) acc[q++] += a[r][u] * a[r][v];
  }
}

// One warp fits the model of its K points (set1, set2: D*K floats), rounded
// as the plain version's minimal fit (and the JAX version's jitted one):
// the normalisation's sums in point order from 0, times 1 / K
// (homography._normalize), the normalised coordinates true divisions, and
// each A^T A entry the FMA chain over the DLT rows in order (H's rows: the
// K first rows of every point, then the K second), a lane an entry.
template <int MODEL, int K>
__device__ void warp_fit_minimal(const float* set1, const float* set2, WarpFit* wf,
                                 float* model) {
  const int lane = threadIdx.x & 31;
  constexpr int kRows = MODEL == 0 ? 2 * K : K;
  static_assert(kRows * 9 <= 81, "the DLT rows are staged in wf->M2");
  float* a = wf->M2;  // the DLT rows [kRows][9], free until the squarings
  Norm nm{};
  if constexpr (MODEL == kEssential) {
    if (lane < K)
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          a[lane * 9 + 3 * u + v] = __fmul_rn(set2[3 * lane + u], set1[3 * lane + v]);
  } else {
    constexpr float kInv = 1.f / K;  // exact for K = 4 and 8
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; ++k) {
      s[0] = __fadd_rn(s[0], set1[2 * k]);
      s[1] = __fadd_rn(s[1], set1[2 * k + 1]);
      s[2] = __fadd_rn(s[2], set2[2 * k]);
      s[3] = __fadd_rn(s[3], set2[2 * k + 1]);
    }
    nm.m1x = __fmul_rn(s[0], kInv);
    nm.m1y = __fmul_rn(s[1], kInv);
    nm.m2x = __fmul_rn(s[2], kInv);
    nm.m2y = __fmul_rn(s[3], kInv);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; ++k) {
      d[0] = __fadd_rn(d[0], fabsf(__fsub_rn(set1[2 * k], nm.m1x)));
      d[1] = __fadd_rn(d[1], fabsf(__fsub_rn(set1[2 * k + 1], nm.m1y)));
      d[2] = __fadd_rn(d[2], fabsf(__fsub_rn(set2[2 * k], nm.m2x)));
      d[3] = __fadd_rn(d[3], fabsf(__fsub_rn(set2[2 * k + 1], nm.m2y)));
    }
    nm.d1x = __fadd_rn(__fmul_rn(d[0], kInv), 1e-12f);
    nm.d1y = __fadd_rn(__fmul_rn(d[1], kInv), 1e-12f);
    nm.d2x = __fadd_rn(__fmul_rn(d[2], kInv), 1e-12f);
    nm.d2y = __fadd_rn(__fmul_rn(d[3], kInv), 1e-12f);
    if (lane < K) {
      const float x1 = __fdiv_rn(__fsub_rn(set1[2 * lane], nm.m1x), nm.d1x);
      const float y1 = __fdiv_rn(__fsub_rn(set1[2 * lane + 1], nm.m1y), nm.d1y);
      const float x2 = __fdiv_rn(__fsub_rn(set2[2 * lane], nm.m2x), nm.d2x);
      const float y2 = __fdiv_rn(__fsub_rn(set2[2 * lane + 1], nm.m2y), nm.d2y);
      float r[2][9];
      dlt_rows<MODEL>(x1, y1, x2, y2, r);
#pragma unroll
      for (int u = 0; u < 9; ++u) {
        a[lane * 9 + u] = r[0][u];
        if (MODEL == 0) a[(K + lane) * 9 + u] = r[1][u];
      }
    }
  }
  __syncwarp();
  for (int q = lane; q < 45; q += 32) {
    int u = 0, v = q;  // the upper triangle's entry q, row by row
    while (v >= 9 - u) {
      v -= 9 - u;
      ++u;
    }
    v += u;
    float e = __fmul_rn(a[u], a[v]);
    for (int k = 1; k < kRows; ++k) e = __fmaf_rn(a[k * 9 + u], a[k * 9 + v], e);
    wf->ata[u * 9 + v] = e;
    wf->ata[v * 9 + u] = e;
  }
  __syncwarp();
  warp_null_vector_of_ata<MODEL>(nm, wf, model);
}

// The whole block fits one model over the rows of mask w (the LO refit):
// normalisation and A^T A as block reductions, the null vector by warp 0.
// The result lands in `model` (shared memory), visible to every thread.
template <int MODEL>
__device__ void block_fit_masked(const float* p1, const float* p2, const uint8_t* w, int n,
                                 float* part, float* scratch, WarpFit* wf, float* model) {
  const int tid = threadIdx.x;
  const Norm nm = MODEL == kEssential ? Norm{} : normalization(p1, p2, w, n, part, scratch);
  float acc[45];
#pragma unroll
  for (int q = 0; q < 45; ++q) acc[q] = 0.f;
  for (int i = tid; i < n; i += blockDim.x) {
    if (!w[i]) continue;
    add_ata_rows<MODEL>(p1, p2, i, nm, acc);
  }
  block_sum<45>(acc, scratch);
  if (tid < 32) warp_null_vector<MODEL>(acc, nm, wf, model);
  __syncthreads();
}

// floats of windowed_sum's scratch a chunk: two buffers of 5 sums a window
__host__ __device__ constexpr size_t part_floats(int n) { return 2 * 5 * ((size_t)(n + 31) / 32 + 2); }

constexpr int kMinThreads = 128;
constexpr int kFinishThreads = 1024;
constexpr int kMaxChunks = 16;

struct Seeds {
  uint32_t s[kMaxChunks];
};

// At most 64 registers a thread, so that 8 blocks fit an SM and B = 1024
// hypotheses run in one wave on 132 SMs: at the 66-100 the compiler takes
// unbounded, a batch ran in two (H 0.077, F 0.083, E 0.055 ms against 0.046,
// 0.061, 0.036; F spills 200 bytes a thread, in L1).
template <int MODEL>
__global__ void __launch_bounds__(kMinThreads, 8)
ransac_minimal_kernel(int N, const float* __restrict__ pts1, const float* __restrict__ pts2,
                      const uint8_t* __restrict__ valid, Seeds seeds, int B, float thr,
                      float* __restrict__ out_model, float* __restrict__ out_cost,
                      int* __restrict__ out_count) {
  constexpr int K = MODEL == 0 ? 4 : 8;
  constexpr int D = dim_of<MODEL>();
  __shared__ float scratch[(kMinThreads / 32 + 1) * 2];
  __shared__ WarpFit wf;
  __shared__ float model[9];
  __shared__ int idx[K];
  __shared__ float set1[D * K], set2[D * K];
  const int c = blockIdx.y, b = blockIdx.x;
  svt_ransac::sample_set<K>(seeds.s[c], b, N, valid, idx);
  if (threadIdx.x < D * K) {
    set1[threadIdx.x] = pts1[D * idx[threadIdx.x / D] + threadIdx.x % D];
    set2[threadIdx.x] = pts2[D * idx[threadIdx.x / D] + threadIdx.x % D];
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_fit_minimal<MODEL, K>(set1, set2, &wf, model);
  __syncthreads();
  float s[2] = {0.f, 0.f};
  score_partial<MODEL>(model, pts1, pts2, valid, N, thr, nullptr, s);
  block_sum<2>(s, scratch);
  const size_t q = (size_t)c * B + b;
  if (threadIdx.x == 0) {
    out_cost[q] = s[0];
    out_count[q] = (int)s[1];
  }
  if (threadIdx.x < 9) out_model[q * 9 + threadIdx.x] = model[threadIdx.x];
}

// One block per given model: its cost and inlier count over all N matches
// (a model with ok[b] == 0 scores every valid match as an outlier).
template <int MODEL>
__global__ void __launch_bounds__(128)
ransac_score_kernel(int N, const float* __restrict__ pts1, const float* __restrict__ pts2,
                    const uint8_t* __restrict__ valid, const float* __restrict__ models,
                    const uint8_t* __restrict__ ok, float thr, float* __restrict__ out_cost,
                    int* __restrict__ out_count) {
  __shared__ float scratch[(128 / 32 + 1) * 2];
  __shared__ float M[9];
  const int b = blockIdx.x;
  if (threadIdx.x < 9) M[threadIdx.x] = models[b * 9 + threadIdx.x];
  __syncthreads();
  float s[2] = {0.f, 0.f};
  score_partial<MODEL>(M, pts1, pts2, valid, N, thr, nullptr, s, ok[b] == 0);
  block_sum<2>(s, scratch);
  if (threadIdx.x == 0) {
    out_cost[b] = s[0];
    out_count[b] = (int)s[1];
  }
}

// A chunk's selection and LO rounds (a block each), then, with `escalate`,
// escalate_scan's carry over the chunks by the last block to finish.
// masks: [C][2][N] bytes of scratch (a chunk's mask and its refit's);
// chunk: [C][13] words (model, cost, then as ints the inlier count, the
// valid flag and which half holds the mask); ticket: a counter at zero,
// left at zero.
template <int MODEL>
__global__ void __launch_bounds__(kFinishThreads)
ransac_finish_kernel(int N, const float* __restrict__ pts1, const float* __restrict__ pts2,
                     const uint8_t* __restrict__ valid, int C, int B,
                     const float* __restrict__ models, const float* __restrict__ costs,
                     const int* __restrict__ counts, int min_inliers, float thr, int lo_rounds,
                     int escalate, uint8_t* masks, float* part, float* chunk,
                     unsigned int* ticket, float* __restrict__ out_model, uint8_t* __restrict__ out_mask,
                     float* __restrict__ out_cost, long long* __restrict__ out_n,
                     uint8_t* __restrict__ out_ok) {
  __shared__ float scratch[(kFinishThreads / 32 + 1) * 45];
  __shared__ WarpFit wf;
  __shared__ float M[9], M_re[9];
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ int best_s, ok_s, last_s;
  __shared__ float total_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, c = blockIdx.x;
  const float* mc = models + (size_t)c * B * 9;
  const float* cc = costs + (size_t)c * B;
  const int* nc = counts + (size_t)c * B;
  // argmin of the gated costs, first on ties
  float v = kBig * 2.f;
  int bi = 0x7fffffff;
  for (int b = tid; b < B; b += blockDim.x) {
    const float g = nc[b] > min_inliers ? cc[b] : kBig;
    if (g < v || (g == v && b < bi)) {
      v = g;
      bi = b;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov < v || (ov == v && oi < bi)) {
      v = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (wv[w] < v || (wv[w] == v && wi[w] < bi)) {
        v = wv[w];
        bi = wi[w];
      }
    best_s = bi;
    ok_s = v < kBig;
    total_s = v < kBig ? cc[bi] : kBig;
  }
  __syncthreads();
  if (tid < 9) M[tid] = mc[best_s * 9 + tid];
  __syncthreads();
  uint8_t* inl = masks + (size_t)c * 2 * N;
  uint8_t* alt = inl + N;
  float sc[2] = {0.f, 0.f};
  score_partial<MODEL>(M, pts1, pts2, valid, N, thr, inl, sc);
  block_sum<2>(sc, scratch);
  int n_inl = (int)sc[1];
  for (int r = 0; r < lo_rounds; ++r) {
    block_fit_masked<MODEL>(pts1, pts2, inl, N, part + (size_t)c * part_floats(N), scratch,
                            &wf, M_re);
    float sr[2] = {0.f, 0.f};
    score_partial<MODEL>(M_re, pts1, pts2, valid, N, thr, alt, sr);
    block_sum<2>(sr, scratch);
    const int n_re = (int)sr[1];
    if (n_re >= n_inl) {  // the same decision in every thread
      if (tid < 9) M[tid] = M_re[tid];
      uint8_t* t = inl;
      inl = alt;
      alt = t;
      n_inl = n_re;
    }
    __syncthreads();
  }
  if (!escalate) {
    if (tid < 9) out_model[tid] = M[tid];
    for (int n = tid; n < N; n += blockDim.x) out_mask[n] = inl[n];
    if (tid == 0) {
      *out_cost = total_s;
      *out_n = n_inl;
      *out_ok = ok_s;
    }
    return;
  }
  float* cf = chunk + (size_t)c * 13;
  if (tid < 9) cf[tid] = M[tid];
  if (tid == 0) {
    cf[9] = total_s;
    int* ci = (int*)(cf + 10);
    ci[0] = n_inl;
    ci[1] = ok_s;
    ci[2] = inl == masks + (size_t)c * 2 * N ? 0 : 1;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(ticket, 1u) == (unsigned int)(C - 1);
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid == 0) {
    // escalate_scan from an all-zero carry: a valid chunk with strictly
    // more inliers is taken, the first of equals kept
    int sel = -1, cn = 0;
    for (int k = 0; k < C; ++k) {
      const int* ck = (const int*)(chunk + (size_t)k * 13 + 10);
      const int nk = __ldcg(ck), vk = __ldcg(ck + 1);
      if (vk && (sel < 0 || nk > cn)) {
        sel = k;
        cn = nk;
      }
    }
    best_s = sel;
    *out_cost = sel >= 0 ? __ldcg(chunk + (size_t)sel * 13 + 9) : 0.f;
    *out_n = sel >= 0 ? cn : 0;
    *out_ok = sel >= 0;
    *ticket = 0u;
  }
  __syncthreads();
  const int sel = best_s;
  if (tid < 9) out_model[tid] = sel >= 0 ? __ldcg(chunk + (size_t)sel * 13 + tid) : 0.f;
  const uint8_t* src =
      sel >= 0 ? masks + ((size_t)sel * 2 + __ldcg((const int*)(chunk + (size_t)sel * 13 + 12))) * N
               : nullptr;
  for (int n = tid; n < N; n += blockDim.x) out_mask[n] = src ? __ldcg(src + n) : 0;
}

// The LO refit's normalisation alone (one block of kFinishThreads, as the
// finish launch runs it): out = m1x, m1y, d1x, d1y, m2x, m2y, d2x, d2y.
__global__ void __launch_bounds__(kFinishThreads)
ransac_normalization_kernel(int N, const float* __restrict__ pts1, const float* __restrict__ pts2,
                            const uint8_t* __restrict__ w, float* part, float* __restrict__ out) {
  __shared__ float scratch[8];
  const Norm r = normalization(pts1, pts2, w, N, part, scratch);
  if (threadIdx.x == 0) {
    const float v[8] = {r.m1x, r.m1y, r.d1x, r.d1y, r.m2x, r.m2y, r.d2x, r.d2y};
    for (int q = 0; q < 8; ++q) out[q] = v[q];
  }
}

}  // namespace

// The finish launch's refit normalisation of pixels [N,2] over mask w [N]
// (a check of its sums): part [part_floats(N)] floats, out [8].
extern "C" int svt_ransac_normalization(int N, const float* pts1, const float* pts2,
                                        const uint8_t* w, float* part, float* out, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  ransac_normalization_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(N, pts1, pts2, w,
                                                                             part, out);
  return (int)cudaGetLastError();
}

// model: 0 homography (pts [N,2]), 1 fundamental (pts [N,2]), 2 essential
// (bearings [N,3]); seeds: C chunk seeds (host memory), B hypotheses each;
// thr: the chi-square cap (H, F; E's angle is fixed). out: models [C,B,9],
// cost [C,B], count [C,B].
extern "C" int svt_ransac_minimal(int model, int N, const float* pts1, const float* pts2,
                                  const uint8_t* valid, const unsigned int* seeds, int C, int B,
                                  float thr, float* out_model, float* out_cost, int* out_count,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (model < 0 || model > kEssential || C < 1 || C > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  Seeds sd{};
  for (int k = 0; k < C; ++k) sd.s[k] = seeds[k];
  const dim3 grid(B, C);
#define SVT_MINIMAL(M)                                                                    \
  ransac_minimal_kernel<M><<<grid, kMinThreads, 0, s>>>(N, pts1, pts2, valid, sd, B, thr, \
                                                        out_model, out_cost, out_count)
  if (model == 0) SVT_MINIMAL(0);
  else if (model == 1) SVT_MINIMAL(1);
  else SVT_MINIMAL(kEssential);
#undef SVT_MINIMAL
  return (int)cudaGetLastError();
}

// The C chunks' selection (count > min_inliers), winner's mask and
// lo_rounds LO refits; escalate (C chunks) or not (C == 1, the chunk's
// result as it is). masks: [C,2,N] bytes, part: [C, part_floats(N)] floats,
// chunk: [C,13] words of scratch;
// ticket: a zero counter of this stream. out: model [9], mask [N], cost,
// inlier count (int64), valid flag.
extern "C" int svt_ransac_finish(int model, int N, const float* pts1, const float* pts2,
                                 const uint8_t* valid, int C, int B, const float* models,
                                 const float* costs, const int* counts, int min_inliers,
                                 float thr, int lo_rounds, int escalate, uint8_t* masks,
                                 float* part, float* chunk, unsigned int* ticket, float* out_model,
                                 uint8_t* out_mask, float* out_cost, long long* out_n,
                                 uint8_t* out_ok, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (model < 0 || model > kEssential || C < 1 || (!escalate && C != 1) || B <= 0)
    return (int)cudaErrorInvalidValue;
#define SVT_FINISH(M)                                                                   \
  ransac_finish_kernel<M><<<C, kFinishThreads, 0, s>>>(                                 \
      N, pts1, pts2, valid, C, B, models, costs, counts, min_inliers, thr, lo_rounds,  \
      escalate, masks, part, chunk, ticket, out_model, out_mask, out_cost, out_n, out_ok)
  if (model == 0) SVT_FINISH(0);
  else if (model == 1) SVT_FINISH(1);
  else SVT_FINISH(kEssential);
#undef SVT_FINISH
  return (int)cudaGetLastError();
}

// B given essential matrices [B,9] with their ok flags [B], each scored on
// all N bearing pairs: cost [B], inlier count [B]
extern "C" int svt_ransac_score(int N, const float* pts1, const float* pts2,
                                const uint8_t* valid, int B, const float* models,
                                const uint8_t* ok, float* out_cost, int* out_count,
                                void* stream) {
  if (B > 0)
    ransac_score_kernel<kEssential><<<B, 128, 0, (cudaStream_t)stream>>>(
        N, pts1, pts2, valid, models, ok, 0.f, out_cost, out_count);
  return (int)cudaGetLastError();
}
