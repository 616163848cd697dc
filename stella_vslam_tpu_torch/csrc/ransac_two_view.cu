// Kernel E: batched two-view RANSAC for the monocular initializer.
//
// Replaces the hypothesis programs of stella_vslam_tpu/ops/solve/
// homography.py (_find_core :107, find_via_ransac :137,
// find_via_ransac_escalated :152) and fundamental.py (:73, :102, :117), with
// the sampler of ransac.py (hash_uniform :30, sample_minimal_sets :50,
// select_best :110) and the null-vector extractor of linalg.py
// (smallest_eigvec_spd :143). The TPU form materialises a [B,k,N] tensor of
// hashed uniforms for a Gumbel-argmax, one-hot gathers, [B,9,9] batched
// matmuls for 18 squarings, a batched SVD for the rank-2 projection of F and
// a [B,N] score matrix.
//
// On Hopper, three entry points, templated on the model (0: homography,
// k = 4; 1: fundamental, k = 8):
//  * svt_ransac_minimal: one block per hypothesis. The block draws its k
//    indices (per slot the argmax over N of the hash, lowest index on ties,
//    -1.0 where invalid), gathers and normalises the k points, builds A^T A
//    (9x9), takes the null vector by the same 18 squarings of
//    (sigma I - A^T A) / sigma with Frobenius renormalisation (81 threads,
//    one entry each), projects F to rank 2 (one-sided Jacobi SVD of the 3x3
//    in double on one thread), denormalises, scores all N matches (H:
//    symmetric transfer through the adjugate inverse; F: symmetric epipolar
//    distance; chi-square cap 5.991) and reduces the cost and inlier count.
//  * svt_ransac_select: one block; argmin of the gated costs (count >
//    min_inliers, first on ties) and the winner's inlier mask.
//  * svt_ransac_refit: one block; the LO round's nonminimal DLT, whose
//    normalisation and A^T A are block reductions over the N masked rows,
//    then the new inlier mask.
// Bound: operations. At B = 1024, N = 2872 a batch hashes B*k*N values
// (23.5 M for F, ~10 integer operations each) and scores B*N = 2.9 M pairs
// (~40 flops each); its bytes are ~50 KB of points. The design keeps every
// [B,k,N] and [B,N] intermediate in registers, so device memory sees only
// the points and the per-hypothesis results; the serial part is the
// 18-squaring chain inside each block (latency, hidden by running B blocks
// at once).
//
// Float32 like the JAX version, but sums are taken in another order, so
// models agree to a tolerance, not bit for bit; the sampled indices are
// exact (the hash is integer arithmetic and its uniforms are exact in f32).
// Where a minimal set's A^T A has a small eigen-gap the 18 squarings do not
// converge, and the summation order moves the null vector: on the card
// ~78% of F and 96-99% of H hypotheses score the same inlier count as the
// plain version, and the rank-2 step accounts for under 1% (chip_smoke.py,
// F route readings).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t i) {
  uint32_t x = i + seed * 2654435761u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// argmax order: larger value first, then the lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
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

// Hartley normalization: T = [[sx,0,tx],[0,sy,ty],[0,0,1]] per image, over
// the n points (weights w in {0,1}, or all 1 when w is null)
struct Norm {
  float m1x, m1y, d1x, d1y, m2x, m2y, d2x, d2y;
};

__device__ Norm normalization(const float* p1, const float* p2, const uint8_t* w,
                              int n, float* scratch) {
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (w && !w[i]) continue;
    s[0] += 1.f;
    s[1] += p1[2 * i];
    s[2] += p1[2 * i + 1];
    s[3] += p2[2 * i];
    s[4] += p2[2 * i + 1];
  }
  block_sum<5>(s, scratch);
  // weighted: sum / (count + 1e-12); unweighted: mean (the same in f32)
  const float cnt = w ? s[0] + 1e-12f : (float)n;
  Norm r;
  r.m1x = s[1] / cnt;
  r.m1y = s[2] / cnt;
  r.m2x = s[3] / cnt;
  r.m2y = s[4] / cnt;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (w && !w[i]) continue;
    d[0] += fabsf(p1[2 * i] - r.m1x);
    d[1] += fabsf(p1[2 * i + 1] - r.m1y);
    d[2] += fabsf(p2[2 * i] - r.m2x);
    d[3] += fabsf(p2[2 * i + 1] - r.m2y);
  }
  block_sum<4>(d, scratch);
  r.d1x = d[0] / cnt + 1e-12f;
  r.d1y = d[1] / cnt + 1e-12f;
  r.d2x = d[2] / cnt + 1e-12f;
  r.d2y = d[3] / cnt + 1e-12f;
  return r;
}

// DLT rows of one normalized correspondence (2 for H, 1 for F)
template <int MODEL>
__device__ __forceinline__ int dlt_rows(float x1, float y1, float x2, float y2,
                                        float a[2][9]) {
  if (MODEL == 0) {
    const float ra[9] = {0.f, 0.f, 0.f, -x1, -y1, -1.f, y2 * x1, y2 * y1, y2};
    const float rb[9] = {x1, y1, 1.f, 0.f, 0.f, 0.f, -x2 * x1, -x2 * y1, -x2};
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      a[0][i] = ra[i];
      a[1][i] = rb[i];
    }
    return 2;
  }
  const float r[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, 1.f};
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
  for (int sweep = 0; sweep < 12; ++sweep) {
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        double a = 0, b = 0, g = 0;
        for (int i = 0; i < 3; ++i) {
          a += W[i][p] * W[i][p];
          b += W[i][q] * W[i][q];
          g += W[i][p] * W[i][q];
        }
        if (fabs(g) <= 1e-300 || fabs(g) <= 1e-17 * sqrt(a * b)) continue;
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

__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = A[i * 3 + 0] * B[0 * 3 + j] + A[i * 3 + 1] * B[1 * 3 + j] +
                     A[i * 3 + 2] * B[2 * 3 + j];
}

// Shared state of one model fit.
struct FitSmem {
  float ata[81];
  float M[81];
  float M2[81];
  float scal[2];  // sigma, then the Frobenius norm
  float model[9];
};

// The whole block fits one model from n correspondences (weights w, or all
// 1); the result lands in fs->model (row-major 3x3).
template <int MODEL>
__device__ void fit_model(const float* p1, const float* p2, const uint8_t* w, int n,
                          float* scratch, FitSmem* fs) {
  const int tid = threadIdx.x;
  const Norm nm = normalization(p1, p2, w, n, scratch);
  // A^T A: 45 upper-triangle sums over the rows
  float acc[45];
#pragma unroll
  for (int q = 0; q < 45; ++q) acc[q] = 0.f;
  for (int i = tid; i < n; i += blockDim.x) {
    if (w && !w[i]) continue;
    const float x1 = (p1[2 * i] - nm.m1x) / nm.d1x, y1 = (p1[2 * i + 1] - nm.m1y) / nm.d1y;
    const float x2 = (p2[2 * i] - nm.m2x) / nm.d2x, y2 = (p2[2 * i + 1] - nm.m2y) / nm.d2y;
    float a[2][9];
    const int nr = dlt_rows<MODEL>(x1, y1, x2, y2, a);
    for (int r = 0; r < nr; ++r) {
      int q = 0;
#pragma unroll
      for (int u = 0; u < 9; ++u)
#pragma unroll
        for (int v = u; v < 9; ++v) acc[q++] += a[r][u] * a[r][v];
    }
  }
  block_sum<45>(acc, scratch);
  if (tid == 0) {
    int q = 0;
    for (int u = 0; u < 9; ++u)
      for (int v = u; v < 9; ++v) {
        fs->ata[u * 9 + v] = acc[q];
        fs->ata[v * 9 + u] = acc[q];
        ++q;
      }
    float sigma = 0.f;
    for (int u = 0; u < 9; ++u) {
      float r = 0.f;
      for (int v = 0; v < 9; ++v) r += fabsf(fs->ata[u * 9 + v]);
      sigma = fmaxf(sigma, r);
    }
    fs->scal[0] = sigma;
  }
  __syncthreads();
  // null vector: M = (sigma I - A) / sigma, squared 18 times
  if (tid < 81) {
    const int i = tid / 9, j = tid % 9;
    const float sigma = fs->scal[0];
    fs->M[tid] = ((i == j ? sigma : 0.f) - fs->ata[tid]) / (sigma + 1e-30f);
  }
  __syncthreads();
  for (int it = 0; it < 18; ++it) {
    if (tid < 81) {
      const int i = tid / 9, j = tid % 9;
      float s = 0.f;
      for (int m = 0; m < 9; ++m) s += fs->M[i * 9 + m] * fs->M[m * 9 + j];
      fs->M2[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int q = 0; q < 81; ++q) s += fs->M2[q] * fs->M2[q];
      fs->scal[1] = sqrtf(s) + 1e-30f;
    }
    __syncthreads();
    if (tid < 81) fs->M[tid] = fs->M2[tid] / fs->scal[1];
    __syncthreads();
  }
  if (tid == 0) {
    // the column of largest norm (first on ties), normalised
    int col = 0;
    float bestn = -1.f;
    for (int j = 0; j < 9; ++j) {
      float s = 0.f;
      for (int i = 0; i < 9; ++i) s += fs->M[i * 9 + j] * fs->M[i * 9 + j];
      if (s > bestn) {
        bestn = s;
        col = j;
      }
    }
    float h[9], nn = 0.f;
    for (int i = 0; i < 9; ++i) {
      h[i] = fs->M[i * 9 + col];
      nn += h[i] * h[i];
    }
    nn = sqrtf(nn) + 1e-12f;
    for (int i = 0; i < 9; ++i) h[i] /= nn;
    if (MODEL == 1) rank2_project(h);
    // denormalise: H = T2^-1 Hn T1, F = T2^T Fn T1
    const float sx1 = 1.f / nm.d1x, sy1 = 1.f / nm.d1y;
    const float sx2 = 1.f / nm.d2x, sy2 = 1.f / nm.d2y;
    const float T1[9] = {sx1, 0.f, -nm.m1x * sx1, 0.f, sy1, -nm.m1y * sy1, 0.f, 0.f, 1.f};
    const float tx2 = -nm.m2x * sx2, ty2 = -nm.m2y * sy2;
    float L[9];
    if (MODEL == 0) {
      const float T2i[9] = {1.f / sx2, 0.f, -tx2 / sx2, 0.f, 1.f / sy2, -ty2 / sy2,
                            0.f, 0.f, 1.f};
      for (int q = 0; q < 9; ++q) L[q] = T2i[q];
    } else {
      const float T2t[9] = {sx2, 0.f, 0.f, 0.f, sy2, 0.f, tx2, ty2, 1.f};
      for (int q = 0; q < 9; ++q) L[q] = T2t[q];
    }
    float tmp[9];
    matmul3(L, h, tmp);
    matmul3(tmp, T1, fs->model);
  }
  __syncthreads();
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
    float l2[3], l1[3];
    for (int i = 0; i < 3; ++i) l2[i] = M[i * 3 + 0] * x1 + M[i * 3 + 1] * y1 + M[i * 3 + 2];
    for (int j = 0; j < 3; ++j) l1[j] = M[0 * 3 + j] * x2 + M[1 * 3 + j] * y2 + M[2 * 3 + j];
    const float e2 = x2 * l2[0] + y2 * l2[1] + l2[2];
    const float e1 = x1 * l1[0] + y1 * l1[1] + l1[2];
    d2 = e2 * e2 / (l2[0] * l2[0] + l2[1] * l2[1] + 1e-12f);
    d1 = e1 * e1 / (l1[0] * l1[0] + l1[1] * l1[1] + 1e-12f);
  }
}

// Scores all N matches under fs->model; optionally writes the inlier mask.
// Returns (cost, count) to every thread.
template <int MODEL>
__device__ void score_all(const float* M, const float* p1, const float* p2,
                          const uint8_t* valid, int N, float thr, uint8_t* mask,
                          float* scratch, float& cost, int& count) {
  float Mi[9];
  if (MODEL == 0) inverse3(M, Mi);
  float s[2] = {0.f, 0.f};
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool inl = false;
    if (valid[n]) {
      float d1, d2;
      pair_dist<MODEL>(M, Mi, p1[2 * n], p1[2 * n + 1], p2[2 * n], p2[2 * n + 1], d1, d2);
      // max(d1, d2) < thr, with a NaN counting as an outlier
      inl = d1 < thr && d2 < thr;
      s[0] += inl ? fmaxf(d1, d2) : thr;
      s[1] += inl ? 1.f : 0.f;
    }
    if (mask) mask[n] = inl ? 1 : 0;
  }
  block_sum<2>(s, scratch);
  cost = s[0];
  count = (int)s[1];
}

template <int MODEL>
__global__ void __launch_bounds__(128)
ransac_minimal_kernel(int N, const float* __restrict__ pts1, const float* __restrict__ pts2,
                      const uint8_t* __restrict__ valid, uint32_t seed, float thr,
                      float* __restrict__ out_model, float* __restrict__ out_cost,
                      int* __restrict__ out_count) {
  constexpr int K = MODEL == 0 ? 4 : 8;
  __shared__ float scratch[(128 / 32 + 1) * 45];
  __shared__ FitSmem fs;
  __shared__ float bv_s[128 / 32][K];
  __shared__ int bi_s[128 / 32][K];
  __shared__ float set1[2 * K], set2[2 * K];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // per slot: argmax of the masked hash over N
  float bv[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bv[s] = -2.f;
    bi[s] = 0x7fffffff;
  }
  for (int n = tid; n < N; n += blockDim.x) {
    const bool ok = valid[n] != 0;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const uint32_t flat = ((uint32_t)b * K + s) * (uint32_t)N + (uint32_t)n;
      const float u = ok ? hash_uniform(seed, flat) : -1.f;
      if (better(u, n, bv[s], bi[s])) {
        bv[s] = u;
        bi[s] = n;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[s], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[s], o);
      if (better(ov, oi, bv[s], bi[s])) {
        bv[s] = ov;
        bi[s] = oi;
      }
    }
    if (lane == 0) {
      bv_s[warp][s] = bv[s];
      bi_s[warp][s] = bi[s];
    }
  }
  __syncthreads();
  if (tid < K) {
    float v = bv_s[0][tid];
    int i = bi_s[0][tid];
    for (int w = 1; w < 128 / 32; ++w)
      if (better(bv_s[w][tid], bi_s[w][tid], v, i)) {
        v = bv_s[w][tid];
        i = bi_s[w][tid];
      }
    set1[2 * tid] = pts1[2 * i];
    set1[2 * tid + 1] = pts1[2 * i + 1];
    set2[2 * tid] = pts2[2 * i];
    set2[2 * tid + 1] = pts2[2 * i + 1];
  }
  __syncthreads();
  fit_model<MODEL>(set1, set2, nullptr, K, scratch, &fs);
  float cost;
  int count;
  score_all<MODEL>(fs.model, pts1, pts2, valid, N, thr, nullptr, scratch, cost, count);
  if (tid < 9) out_model[b * 9 + tid] = fs.model[tid];
  if (tid == 0) {
    out_cost[b] = cost;
    out_count[b] = count;
  }
}

template <int MODEL>
__global__ void __launch_bounds__(1024)
ransac_select_kernel(int N, const float* __restrict__ pts1, const float* __restrict__ pts2,
                     const uint8_t* __restrict__ valid, int B,
                     const float* __restrict__ models, const float* __restrict__ costs,
                     const int* __restrict__ counts, int min_inliers, float thr,
                     float* __restrict__ out_model, uint8_t* __restrict__ out_mask,
                     float* __restrict__ out_cost, uint8_t* __restrict__ out_ok) {
  __shared__ float scratch[(1024 / 32 + 1) * 2];
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ float M[9];
  __shared__ int best_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // argmin of the gated costs, first on ties
  float v = kBig * 2.f;
  int bi = 0x7fffffff;
  for (int b = tid; b < B; b += blockDim.x) {
    const float g = counts[b] > min_inliers ? costs[b] : kBig;
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
    const bool ok = v < kBig;
    *out_ok = ok ? 1 : 0;
    *out_cost = ok ? costs[bi] : kBig;
  }
  __syncthreads();
  if (tid < 9) {
    M[tid] = models[best_s * 9 + tid];
    out_model[tid] = M[tid];
  }
  __syncthreads();
  float cost;
  int count;
  score_all<MODEL>(M, pts1, pts2, valid, N, thr, out_mask, scratch, cost, count);
}

template <int MODEL>
__global__ void __launch_bounds__(1024)
ransac_refit_kernel(int N, const float* __restrict__ pts1, const float* __restrict__ pts2,
                    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ mask_in,
                    float thr, float* __restrict__ out_model, uint8_t* __restrict__ out_mask) {
  __shared__ float scratch[(1024 / 32 + 1) * 45];
  __shared__ FitSmem fs;
  fit_model<MODEL>(pts1, pts2, mask_in, N, scratch, &fs);
  float cost;
  int count;
  score_all<MODEL>(fs.model, pts1, pts2, valid, N, thr, out_mask, scratch, cost, count);
  if (threadIdx.x < 9) out_model[threadIdx.x] = fs.model[threadIdx.x];
}

}  // namespace

extern "C" int svt_ransac_minimal(int model, int N, const float* pts1, const float* pts2,
                                  const uint8_t* valid, unsigned int seed, int B, float thr,
                                  float* out_model, float* out_cost, int* out_count,
                                  void* stream) {
  if (B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (model == 0)
      ransac_minimal_kernel<0><<<B, 128, 0, s>>>(N, pts1, pts2, valid, seed, thr, out_model,
                                                 out_cost, out_count);
    else
      ransac_minimal_kernel<1><<<B, 128, 0, s>>>(N, pts1, pts2, valid, seed, thr, out_model,
                                                 out_cost, out_count);
  }
  return (int)cudaGetLastError();
}

extern "C" int svt_ransac_select(int model, int N, const float* pts1, const float* pts2,
                                 const uint8_t* valid, int B, const float* models,
                                 const float* costs, const int* counts, int min_inliers,
                                 float thr, float* out_model, uint8_t* out_mask,
                                 float* out_cost, uint8_t* out_ok, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (model == 0)
    ransac_select_kernel<0><<<1, 1024, 0, s>>>(N, pts1, pts2, valid, B, models, costs, counts,
                                               min_inliers, thr, out_model, out_mask,
                                               out_cost, out_ok);
  else
    ransac_select_kernel<1><<<1, 1024, 0, s>>>(N, pts1, pts2, valid, B, models, costs, counts,
                                               min_inliers, thr, out_model, out_mask,
                                               out_cost, out_ok);
  return (int)cudaGetLastError();
}

extern "C" int svt_ransac_refit(int model, int N, const float* pts1, const float* pts2,
                                const uint8_t* valid, const uint8_t* mask_in, float thr,
                                float* out_model, uint8_t* out_mask, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (model == 0)
    ransac_refit_kernel<0><<<1, 1024, 0, s>>>(N, pts1, pts2, valid, mask_in, thr, out_model,
                                              out_mask);
  else
    ransac_refit_kernel<1><<<1, 1024, 0, s>>>(N, pts1, pts2, valid, mask_in, thr, out_model,
                                              out_mask);
  return (int)cudaGetLastError();
}
