// Kernel N: PnP RANSAC hypotheses on bearing vectors.
//
// Replaces the hypothesis batch of stella_vslam_tpu/ops/solve/pnp.py
// find_via_ransac (:187): sample_minimal_sets (ransac.py:50), p3p_grunert
// (:50) and check_inliers (:174) over every hypothesis. The TPU form is a
// lane-major program: a [B,3,N] tensor of hashed uniforms and its argmax,
// one-hot gathers, the Newton iteration on [B,8] arrays and a [B*8,N] cosine
// matrix reduced along N.
//
//  pnp_solve_kernel (one block per minimal set): draws the set's 3 indices
//    (per slot the argmax over N of the counter hash of ransac.py, masked to
//    -1 where invalid, lowest index on ties: bit-exact), then threads 0..7
//    each run one Newton start of Grunert's quartic (24 iterations, clamp
//    [1e-4, 50], |Q'| < 1e-8 guard), recover the depths and build (R, t) by
//    the two triads.
//  pnp_score_kernel (one block per hypothesis): the cosine test of every
//    correspondence against its per-level threshold, the inlier count and
//    the total cost, reduced over the block.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// fused multiply-add) in the order of the Python expressions, so a start
// lands on the same root as in the plain version.
// Bound: operations. B = 256 sets hash 3 B N values (~12 integer operations
// each) and score 8 B N pairs at ~25 operations: ~0.18 G operations at
// N = 2872 against ~80 KB of input. The design keeps every hypothesis in
// registers and writes only (R, t, ok, cost, count) per hypothesis.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStarts = 8;
constexpr int kNewtonIters = 24;
constexpr int kThreads = 128;
__constant__ float kStartV[kStarts] = {0.2f, 0.4f, 0.7f, 1.0f, 1.4f, 2.0f, 3.2f, 5.0f};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sq(float a) { return __fsqrt_rn(a); }

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

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// orthonormal frame (e1, e2, e3) spanned by three points (pnp.py _triad)
__device__ void triad(const float* x1, const float* x2, const float* x3, float* e1, float* e2,
                      float* e3) {
  float d[3];
  for (int i = 0; i < 3; ++i) e1[i] = sub(x2[i], x1[i]);
  float n = add(sq(dot3(e1, e1)), 1e-12f);
  for (int i = 0; i < 3; ++i) e1[i] = dv(e1[i], n);
  for (int i = 0; i < 3; ++i) d[i] = sub(x3[i], x1[i]);
  cross3(e1, d, e3);
  n = add(sq(dot3(e3, e3)), 1e-12f);
  for (int i = 0; i < 3; ++i) e3[i] = dv(e3[i], n);
  cross3(e3, e1, e2);
}

struct Quartic {
  float ca, cb, cg, AC, C;
};

// q, N, D, E, Q of pnp.py terms(v)
__device__ __forceinline__ void terms(const Quartic& k, float v, float& q, float& N, float& D,
                                      float& E, float& Q) {
  q = sub(add(1.0f, mul(v, v)), mul(mul(2.0f, v), k.cb));
  N = add(sub(1.0f, mul(v, v)), mul(k.AC, q));
  D = mul(2.0f, sub(k.cg, mul(v, k.ca)));
  E = sub(1.0f, mul(k.C, q));
  Q = add(sub(mul(N, N), mul(mul(mul(2.0f, k.cg), N), D)), mul(mul(D, D), E));
}

__global__ void __launch_bounds__(kThreads)
pnp_solve_kernel(int N, const float* __restrict__ bearings, const float* __restrict__ pos_w,
                 const uint8_t* __restrict__ valid, uint32_t seed, float* __restrict__ out_R,
                 float* __restrict__ out_t, uint8_t* __restrict__ out_ok) {
  __shared__ float bv_s[kThreads / 32][3];
  __shared__ int bi_s[kThreads / 32][3];
  __shared__ float f_s[9], P_s[9];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float bv[3];
  int bi[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    bv[s] = -2.f;
    bi[s] = 0x7fffffff;
  }
  for (int n = tid; n < N; n += blockDim.x) {
    const bool ok = valid[n] != 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint32_t flat = ((uint32_t)b * 3 + s) * (uint32_t)N + (uint32_t)n;
      const float u = ok ? hash_uniform(seed, flat) : -1.f;
      if (better(u, n, bv[s], bi[s])) {
        bv[s] = u;
        bi[s] = n;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
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
  if (tid < 3) {
    float v = bv_s[0][tid];
    int i = bi_s[0][tid];
    for (int w = 1; w < kThreads / 32; ++w)
      if (better(bv_s[w][tid], bi_s[w][tid], v, i)) {
        v = bv_s[w][tid];
        i = bi_s[w][tid];
      }
    for (int j = 0; j < 3; ++j) {
      f_s[3 * tid + j] = bearings[3 * i + j];
      P_s[3 * tid + j] = pos_w[3 * i + j];
    }
  }
  __syncthreads();
  if (tid >= kStarts) return;
  const float* f1 = f_s;
  const float* f2 = f_s + 3;
  const float* f3 = f_s + 6;
  const float* P1 = P_s;
  const float* P2 = P_s + 3;
  const float* P3 = P_s + 6;
  float d23[3], d13[3], d12[3];
  for (int i = 0; i < 3; ++i) {
    d23[i] = sub(P2[i], P3[i]);
    d13[i] = sub(P1[i], P3[i]);
    d12[i] = sub(P1[i], P2[i]);
  }
  const float a2 = dot3(d23, d23), b2 = dot3(d13, d13), c2 = dot3(d12, d12);
  Quartic k;
  k.ca = dot3(f2, f3);
  k.cb = dot3(f1, f3);
  k.cg = dot3(f1, f2);
  const float A = dv(a2, add(b2, 1e-20f));
  k.C = dv(c2, add(b2, 1e-20f));
  k.AC = sub(A, k.C);
  float v = kStartV[tid];
  float q, Nn, D, E, Q;
  for (int it = 0; it < kNewtonIters; ++it) {
    terms(k, v, q, Nn, D, E, Q);
    const float qp = sub(mul(2.0f, v), mul(2.0f, k.cb));
    const float Np = add(mul(-2.0f, v), mul(k.AC, qp));
    const float Dp = mul(-2.0f, k.ca);
    const float Ep = mul(-k.C, qp);
    float Qp = add(add(sub(mul(mul(2.0f, Nn), Np),
                           mul(mul(2.0f, k.cg), add(mul(Np, D), mul(Nn, Dp)))),
                       mul(mul(mul(2.0f, D), Dp), E)),
                   mul(mul(D, D), Ep));
    if (fabsf(Qp) < 1e-8f) Qp = 1e-8f;
    const float vn = sub(v, dv(Q, Qp));
    // clamp that keeps a NaN, as torch.clamp does
    v = vn < 1e-4f ? 1e-4f : (vn > 50.0f ? 50.0f : vn);
  }
  terms(k, v, q, Nn, D, E, Q);
  const float u = dv(Nn, fabsf(D) < 1e-9f ? 1e-9f : D);
  const float qc = q < 1e-12f ? 1e-12f : q;  // max(q, 1e-12), NaN kept
  const float s1 = sq(dv(b2, qc));
  const float s2 = mul(u, s1);
  const float s3 = mul(v, s1);
  const float res_a = sub(sub(add(mul(s2, s2), mul(s3, s3)), mul(mul(mul(2.0f, s2), s3), k.ca)),
                          a2);
  const float res_scale =
      add(add(add(add(mul(s1, s1), mul(s2, s2)), mul(s3, s3)), a2), 1e-20f);
  const bool ok = u > 0.f && q > 1e-12f && fabsf(res_a) < mul(1e-3f, res_scale) &&
                  isfinite(s1) && isfinite(s2) && isfinite(s3);
  float X1[3], X2[3], X3[3];
  for (int i = 0; i < 3; ++i) {
    X1[i] = mul(s1, f1[i]);
    X2[i] = mul(s2, f2[i]);
    X3[i] = mul(s3, f3[i]);
  }
  float c1[3], c2v[3], c3[3], w1[3], w2[3], w3[3];
  triad(X1, X2, X3, c1, c2v, c3);
  triad(P1, P2, P3, w1, w2, w3);
  const int h = b * kStarts + tid;
  float R[9], t[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = add(add(mul(c1[i], w1[j]), mul(c2v[i], w2[j])), mul(c3[i], w3[j]));
  for (int i = 0; i < 3; ++i)
    t[i] = sub(X1[i], add(add(mul(R[3 * i], P1[0]), mul(R[3 * i + 1], P1[1])),
                          mul(R[3 * i + 2], P1[2])));
  for (int i = 0; i < 9; ++i) out_R[9 * h + i] = ok ? R[i] : (i % 4 == 0 ? 1.f : 0.f);
  for (int i = 0; i < 3; ++i) out_t[3 * h + i] = ok ? t[i] : 0.f;
  out_ok[h] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
pnp_score_kernel(int N, const float* __restrict__ bearings, const float* __restrict__ pos_w,
                 const float* __restrict__ max_cos, const uint8_t* __restrict__ valid,
                 const float* __restrict__ hyp_R, const float* __restrict__ hyp_t,
                 const uint8_t* __restrict__ hyp_ok, float* __restrict__ out_cost,
                 int* __restrict__ out_count) {
  __shared__ float cost_s[kThreads / 32];
  __shared__ int count_s[kThreads / 32];
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float R[9], t[3];
  for (int i = 0; i < 9; ++i) R[i] = hyp_R[9 * h + i];
  for (int i = 0; i < 3; ++i) t[i] = hyp_t[3 * h + i];
  const bool ok = hyp_ok[h] != 0;
  float cost = 0.f;
  int count = 0;
  for (int n = tid; n < N; n += blockDim.x) {
    if (!valid[n]) continue;
    const float* p = pos_w + 3 * n;
    const float* bn = bearings + 3 * n;
    float pc[3];
    for (int i = 0; i < 3; ++i)
      pc[i] = add(add(add(mul(R[3 * i], p[0]), mul(R[3 * i + 1], p[1])), mul(R[3 * i + 2], p[2])),
                  t[i]);
    const float c = dv(dot3(pc, bn), add(sq(dot3(pc, pc)), 1e-12f));
    const float mc = max_cos[n];
    const bool in = ok && c > mc;
    cost += in ? sub(1.0f, c) : sub(1.0f, mc);
    count += in ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    cost += __shfl_down_sync(0xffffffffu, cost, o);
    count += __shfl_down_sync(0xffffffffu, count, o);
  }
  if (lane == 0) {
    cost_s[warp] = cost;
    count_s[warp] = count;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      cost += cost_s[w];
      count += count_s[w];
    }
    out_cost[h] = cost;
    out_count[h] = count;
  }
}

}  // namespace

extern "C" int svt_pnp_ransac(int N, const float* bearings, const float* pos_w,
                              const float* max_cos, const uint8_t* valid, uint32_t seed, int B,
                              float* out_R, float* out_t, uint8_t* out_ok, float* out_cost,
                              int* out_count, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  pnp_solve_kernel<<<B, kThreads, 0, s>>>(N, bearings, pos_w, valid, seed, out_R, out_t, out_ok);
  pnp_score_kernel<<<B * kStarts, kThreads, 0, s>>>(N, bearings, pos_w, max_cos, valid, out_R,
                                                    out_t, out_ok, out_cost, out_count);
  return (int)cudaGetLastError();
}
