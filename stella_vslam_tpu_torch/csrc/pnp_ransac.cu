// Kernel N: PnP RANSAC hypotheses on bearing vectors.
//
// Replaces the hypothesis batch of stella_vslam_tpu/ops/solve/pnp.py
// find_via_ransac (:187): sample_minimal_sets (ransac.py:50), p3p_grunert
// (:50) and check_inliers (:174) over every hypothesis. The TPU form is a
// lane-major program: a [B,3,N] tensor of hashed uniforms and its argmax,
// one-hot gathers, the Newton iteration on [B,8] arrays and a [B*8,N] cosine
// matrix reduced along N.
//
// One launch, a block of 256 threads per minimal set:
//  * the block draws the set's 3 indices (ransac_sample.cuh, shared with
//    kernels E and U: per slot the argmax over N of the counter hash of
//    ransac.py, invalid positions below every valid one, the lowest index
//    on ties: bit-exact; an invalid position is not hashed, and a thread
//    has the validity of its 24 matches in flight at once), and in the same
//    pass lists the valid matches (a ballot a step, each warp into its own
//    region in n order; a loop validation's call holds 45-81 valid of
//    2872);
//  * lanes 0..7 of warp 0 each run one Newton start of Grunert's quartic
//    (up to 24 iterations, clamp [1e-4, 50], |Q'| < 1e-8 guard; a start
//    that reaches a fixed point stops there, which changes no bit), recover
//    the depths and build (R, t) by the two triads;
//  * every thread scores the 8 poses (broadcast reads of shared memory) on
//    its listed matches, each read once a set: per thread 8 (cost, count)
//    accumulators, then per hypothesis a shuffle-down sum in each warp and
//    the warps added in order. Past 16384 matches the list does not fit,
//    and the block scores every valid match in turn.
// Counts, R, t and ok are the two-launch kernel's bits; the costs add in
// another order (the listed matches', where the two launches took every
// 128th), within 1e-7 of
// plain's (chip_smoke.py _check_pnp).
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// fused multiply-add) in the order of the Python expressions, so a start
// lands on the same root as in the plain version. The cosine test
// c = dot / (sqrt(|pc|^2) + 1e-12) > max_cos is decided without the root
// and the division where it cannot pass: a point behind the camera
// (dot <= 0) or dot^2 < max_cos^2 (1 - 2^-16) |pc|^2 (|pc|^2 in [2^-60,
// 2^60]) lies further below the threshold than the few roundings of c can
// move it (c rounds to at most dot / |pc| (1 + 2^-22)), so its count and
// cost are the exact test's.
// Bound: operations. B = 256 sets hash 3 B V values for V valid matches
// (~12 integer operations each), run 2048 Newton solves and score 8 B V
// pairs at ~25 operations, against ~29 bytes a match read once. Each set
// writes only (R, t, ok, cost, count) per hypothesis.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ransac_sample.cuh"

namespace {

constexpr int kStarts = 8;
constexpr int kNewtonIters = 24;
constexpr int kThreads = 256;
// validity loads in flight a thread while sampling (4096 matches in one)
constexpr int kBatch = 16;
// the list of valid matches (16-bit indices): up to N = 16384 matches;
// past that the block scores every 256th match with its validity test
constexpr int kListCap = 16384;
__constant__ float kStartV[kStarts] = {0.2f, 0.4f, 0.7f, 1.0f, 1.4f, 2.0f, 3.2f, 5.0f};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sq(float a) { return __fsqrt_rn(a); }

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

// One Newton start (start 0..7) on the set's bearings f_s and points P_s
// (3 x 3 each): its pose (R row-major, t) and whether it is a root.
__device__ bool solve_start(const float* f_s, const float* P_s, int start, float* R, float* t) {
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
  float v = kStartV[start];
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
    const float next = vn < 1e-4f ? 1e-4f : (vn > 50.0f ? 50.0f : vn);
    // a step is a function of v alone: at a fixed point the remaining
    // iterations return v unchanged, so they are skipped (a NaN never
    // compares equal and runs them all)
    if (next == v) break;
    v = next;
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
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = add(add(mul(c1[i], w1[j]), mul(c2v[i], w2[j])), mul(c3[i], w3[j]));
  for (int i = 0; i < 3; ++i)
    t[i] = sub(X1[i], add(add(mul(R[3 * i], P1[0]), mul(R[3 * i + 1], P1[1])),
                          mul(R[3 * i + 2], P1[2])));
  return ok;
}

// The sampler's hook that lists the valid matches: each warp appends the
// valid n it meets, in n order, to its own region of the list (a ballot a
// step), so the list needs no pass of its own.
struct ListValid {
  uint16_t* region;
  int count;
  __device__ void operator()(int n, bool ok, unsigned live) {
    const unsigned m = __ballot_sync(live, ok);
    if (ok) region[count + __popc(m & ((1u << (threadIdx.x & 31)) - 1u))] = (uint16_t)n;
    count += __popc(m);
  }
};

// two blocks an SM (at most 128 registers a thread): B = 256 sets in one
// wave on 132 SMs
__global__ void __launch_bounds__(kThreads, 2)
pnp_ransac_kernel(int N, const float* __restrict__ bearings, const float* __restrict__ pos_w,
                  const float* __restrict__ max_cos, const uint8_t* __restrict__ valid,
                  uint32_t seed, float* __restrict__ out_R, float* __restrict__ out_t,
                  uint8_t* __restrict__ out_ok, float* __restrict__ out_cost,
                  int* __restrict__ out_count) {
  __shared__ int idx[3];
  __shared__ float f_s[9], P_s[9];
  __shared__ float pose_s[kStarts][12];
  __shared__ int ok_s[kStarts];
  __shared__ uint16_t list_s[kListCap];
  __shared__ int counts_s[kThreads / 32];
  __shared__ float cost_s[kThreads / 32][kStarts];
  __shared__ int count_s[kThreads / 32][kStarts];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp meets 32 of every 256 matches: its region holds them all
  const int region = 32 * ((N + kThreads - 1) / kThreads);
  const bool listed = (kThreads / 32) * region <= kListCap;
  if (listed) {
    ListValid hook{list_s + warp * region, 0};
    svt_ransac::sample_set<3, kBatch>(seed, b, N, valid, idx, hook);
    if (lane == 0) counts_s[warp] = hook.count;
  } else {
    svt_ransac::sample_set<3, kBatch>(seed, b, N, valid, idx);
  }
  if (tid < 9) {
    f_s[tid] = bearings[3 * idx[tid / 3] + tid % 3];
    P_s[tid] = pos_w[3 * idx[tid / 3] + tid % 3];
  }
  __syncthreads();
  if (tid < kStarts) {
    float R[9], t[3];
    const bool ok = solve_start(f_s, P_s, tid, R, t);
    const int h = b * kStarts + tid;
    for (int i = 0; i < 9; ++i) {
      const float r = ok ? R[i] : (i % 4 == 0 ? 1.f : 0.f);
      out_R[9 * h + i] = r;
      pose_s[tid][i] = r;
    }
    for (int i = 0; i < 3; ++i) {
      const float v = ok ? t[i] : 0.f;
      out_t[3 * h + i] = v;
      pose_s[tid][9 + i] = v;
    }
    out_ok[h] = ok ? 1 : 0;
    ok_s[tid] = ok;
  }
  __syncthreads();
  bool okh[kStarts];
  float cost[kStarts];
  int count[kStarts];
#pragma unroll
  for (int h = 0; h < kStarts; ++h) {
    okh[h] = ok_s[h] != 0;
    cost[h] = 0.f;
    count[h] = 0;
  }
  // the listed matches (warp 0's region first), or every match with its
  // validity test where the list would not fit
  int total = N, start[kThreads / 32];
  if (listed) {
    total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      start[w] = total;
      total += counts_s[w];
    }
  }
  for (int j = tid; j < total; j += kThreads) {
    int n = j;
    if (listed) {
      int w = 0;
#pragma unroll
      for (int q = 1; q < kThreads / 32; ++q) w += j >= start[q];
      n = list_s[w * region + j - start[w]];
    } else if (!valid[n]) {
      continue;
    }
    const float p[3] = {pos_w[3 * n], pos_w[3 * n + 1], pos_w[3 * n + 2]};
    const float bn[3] = {bearings[3 * n], bearings[3 * n + 1], bearings[3 * n + 2]};
    const float mc = max_cos[n];
    const float out_cost_n = sub(1.0f, mc);
    // the bound of the cheap rejection: max_cos^2 (1 - 2^-16), for max_cos > 0
    const bool cheap = mc > 0.f;
    const float mc2 = mul(mul(mc, mc), 0.9999847412109375f);
#pragma unroll
    for (int h = 0; h < kStarts; ++h) {
      bool in = false;
      float c = 0.f;
      if (okh[h]) {
        const float* P = pose_s[h];  // a broadcast read from shared memory
        float pc[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          pc[i] = add(add(add(mul(P[3 * i], p[0]), mul(P[3 * i + 1], p[1])), mul(P[3 * i + 2], p[2])),
                      P[9 + i]);
        const float dot = dot3(pc, bn), pp = dot3(pc, pc);
        const bool rejected = cheap && (!(dot > 0.f) ||
                                        (pp >= 8.673617e-19f && pp <= 1.1529215e18f &&
                                         mul(dot, dot) < mul(mc2, pp)));
        if (!rejected) {
          c = dv(dot, add(sq(pp), 1e-12f));
          in = c > mc;
        }
      }
      cost[h] = add(cost[h], in ? sub(1.0f, c) : out_cost_n);
      count[h] += in ? 1 : 0;
    }
  }
#pragma unroll
  for (int h = 0; h < kStarts; ++h) {
    for (int o = 16; o > 0; o >>= 1) {
      cost[h] = add(cost[h], __shfl_down_sync(0xffffffffu, cost[h], o));
      count[h] += __shfl_down_sync(0xffffffffu, count[h], o);
    }
    if (lane == 0) {
      cost_s[warp][h] = cost[h];
      count_s[warp][h] = count[h];
    }
  }
  __syncthreads();
  if (tid < kStarts) {
    float c = cost_s[0][tid];
    int k = count_s[0][tid];
    for (int w = 1; w < kThreads / 32; ++w) {
      c = add(c, cost_s[w][tid]);
      k += count_s[w][tid];
    }
    out_cost[b * kStarts + tid] = c;
    out_count[b * kStarts + tid] = k;
  }
}

}  // namespace

extern "C" int svt_pnp_ransac(int N, const float* bearings, const float* pos_w,
                              const float* max_cos, const uint8_t* valid, uint32_t seed, int B,
                              float* out_R, float* out_t, uint8_t* out_ok, float* out_cost,
                              int* out_count, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  pnp_ransac_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      N, bearings, pos_w, max_cos, valid, seed, out_R, out_t, out_ok, out_cost, out_count);
  return (int)cudaGetLastError();
}
