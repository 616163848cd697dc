// Kernel U: the five-point minimal essential solver, for a batch of hashed
// minimal sets.
//
// Replaces stella_vslam_tpu/ops/solve/essential_5pt.py solve_minimal_sets
// (:218) with the sampler of ransac.py sample_minimal_sets (:50) that feeds
// it in essential.py find_via_ransac_5pt (:144). The TPU form is a
// hidden-variable resultant in fixed-shape batched tensors: the null basis
// of each 5x9 system by a projector and Gram-Schmidt (_null_basis :193),
// the ten cubics as coefficient dictionaries (:70-136), the 10x10 M(z) at
// 257 grid points for the sign of its determinant ([B,257,10,10] through an
// unrolled one-hot elimination, _det_sign_10 :138), 28 bisection steps over
// [B,10] root slots, and the null vector of M(z*) by 18 squarings of M^T M.
//
// Here one block of 256 threads per set (the simple layout; speed is later
// work). The file compiles with -fmad=false (kernels/build.py SOURCE_FLAGS):
// every product and sum rounds on its own, as the plain version's
// elementwise torch operations do. The plain version's einsums and matmuls
// (A A^T, the projector, M^T M, the squarings) run in cuBLAS, which sums in
// its own order, so those steps agree only to float32 rounding.
//  1. the block draws the set's 5 indices with the hash sampler
//     (ransac_sample.cuh, bit-equal to the JAX version's);
//  2. thread 0 builds A (5x9), A A^T with its 1e-8 trace ridge, the unrolled
//     Cholesky, X = (A A^T)^-1 A, the projector P = I - A^T X, Y = P PROBE
//     and the modified Gram-Schmidt basis (4x9), into shared memory;
//  3. threads 0-9 each expand one cubic (det E, or one entry of
//     2 E E^T E - tr(E E^T) E) as a dense polynomial in (x, y, z), scatter
//     it into its row of M0..M3 and scale the row to a unit largest |entry|;
//  4. every thread evaluates sign det M(tan theta_g) for grid points g
//     (the grid comes from the wrapper, computed as jnp.linspace computes
//     it) by the JAX version's elimination in its own 10x10 in local
//     memory: the pivot the largest |entry| at or below the diagonal (the
//     lowest row on ties), row p becoming row_p + (row_k - row_p) as the
//     one-hot swap computes it, the pivot row scaled by 1 / |pivot|, in
//     the plain version's order of operations;
//  5. thread 0 takes the first 10 sign changes;
//  6. thread r < #roots bisects its interval 28 times in theta, then forms
//     M(z*), M^T M, its null vector (18 squarings, the largest column,
//     ops/linalg.smallest_eigvec_spd), x and y from it, and the unit-norm
//     E = x E1 + y E2 + z E3 + E4 with its valid flag.
// Bound: operations. A set costs ~285 determinant signs of ~1400 operations
// each (grid and bisection) and 10 x 18 squarings of 10x10 (~36 k
// operations per root), ~0.8 M operations; 1024 sets are ~0.8 G operations,
// ~0.012 ms at 67 T/s. The serial part (28 dependent bisection steps and
// 18 dependent squarings on one thread per root) sets the time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ransac_sample.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 256;  // intervals; kGrid + 1 points
constexpr int kBisect = 28;
constexpr int kMaxRoots = 10;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// column of each (x, y) monomial (a, b), a + b <= 3, in M(z)
// (XY_MONOS: x^3 x^2y xy^2 y^3 x^2 xy y^2 x y 1)
__device__ __forceinline__ int mono_col(int a, int b) {
  const int deg = a + b;
  if (deg == 3) return 3 - a;
  if (deg == 2) return 4 + (2 - a);
  if (deg == 1) return 7 + (1 - a);
  return 9;
}

// M(z) = ((M0 + z M1) + z^2 M2) + z^3 M3, each product and sum rounded
__device__ __forceinline__ void eval_M(const float* Mk, float z, float* M) {
  const float z2 = mul(z, z), z3 = mul(z2, z);
  for (int q = 0; q < 100; ++q)
    M[q] = add(add(add(Mk[q], mul(z, Mk[100 + q])), mul(z2, Mk[200 + q])), mul(z3, Mk[300 + q]));
}

__device__ __forceinline__ float signf(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }

// sign(det M) by the JAX version's pivot-normalised elimination (M is
// overwritten)
__device__ float det_sign_10(float* A) {
  float sign = 1.f;
  for (int k = 0; k < 10; ++k) {
    int p = k;
    float best = fabsf(A[k * 10 + k]);
    for (int i = k + 1; i < 10; ++i) {
      const float v = fabsf(A[i * 10 + k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
    if (p != k) sign = -sign;
    float row_p[10];
    for (int c = 0; c < 10; ++c) row_p[c] = A[p * 10 + c];
    // the one-hot swap: row k -> row_k + (row_p - row_k), row p -> row_p +
    // (row_k - row_p); row k is then overwritten by the scaled pivot row
    const float piv = p == k ? A[k * 10 + k] : add(A[k * 10 + k], sub(row_p[k], A[k * 10 + k]));
    if (p != k)
      for (int c = 0; c < 10; ++c) A[p * 10 + c] = add(row_p[c], sub(A[k * 10 + c], row_p[c]));
    const float sp = signf(piv);
    sign *= sp;
    const float inv = fabsf(piv) > 1e-30f ? __fdiv_rn(1.f, fabsf(piv)) : 0.f;
    for (int c = 0; c < 10; ++c) A[k * 10 + c] = mul(row_p[c], inv);
    for (int i = k + 1; i < 10; ++i) {
      const float m = mul(A[i * 10 + k], sp);
      for (int c = 0; c < 10; ++c) A[i * 10 + c] = sub(A[i * 10 + c], mul(m, A[k * 10 + c]));
    }
  }
  return sign;
}

// dense polynomials in (x, y, z) of degree <= 3, coefficient of x^a y^b z^c
// at a * 16 + b * 4 + c; a linear form l[4] is (x, y, z, 1)
__device__ __forceinline__ void lin_mul(const float* l1, const float* l2, float* q) {
  // q += l1 * l2 (quadratic)
  const int e[4][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {0, 0, 0}};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int a = e[i][0] + e[j][0], b = e[i][1] + e[j][1], c = e[i][2] + e[j][2];
      q[a * 16 + b * 4 + c] += l1[i] * l2[j];
    }
}

__device__ __forceinline__ void quad_lin_mul(const float* q, const float* l, float s, float* out) {
  // out += s * q * l (cubic); q has degree <= 2
  const int e[4][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {0, 0, 0}};
  for (int a = 0; a < 3; ++a)
    for (int b = 0; a + b < 3; ++b)
      for (int c = 0; a + b + c < 3; ++c) {
        const float v = q[a * 16 + b * 4 + c];
        if (v == 0.f) continue;
        for (int j = 0; j < 4; ++j)
          out[(a + e[j][0]) * 16 + (b + e[j][1]) * 4 + (c + e[j][2])] += s * v * l[j];
      }
}

// the null vector of the 10x10 symmetric PSD S (overwritten): M = (sigma I
// - S) / sigma squared 18 times with Frobenius renormalisation, then the
// column of largest norm (first on ties), normalised
__device__ void smallest_eigvec_10(float* S, float* W, float* v) {
  float sigma = 0.f;
  for (int i = 0; i < 10; ++i) {
    float r = 0.f;
    for (int j = 0; j < 10; ++j) r += fabsf(S[i * 10 + j]);
    sigma = fmaxf(sigma, r);
  }
  for (int i = 0; i < 10; ++i)
    for (int j = 0; j < 10; ++j)
      S[i * 10 + j] = ((i == j ? sigma : 0.f) - S[i * 10 + j]) / (sigma + 1e-30f);
  for (int it = 0; it < 18; ++it) {
    float f = 0.f;
    for (int i = 0; i < 10; ++i)
      for (int j = 0; j < 10; ++j) {
        float s = 0.f;
        for (int m = 0; m < 10; ++m) s += S[i * 10 + m] * S[m * 10 + j];
        W[i * 10 + j] = s;
        f += s * s;
      }
    f = sqrtf(f) + 1e-30f;
    for (int q = 0; q < 100; ++q) S[q] = W[q] / f;
  }
  int col = 0;
  float bestn = -1.f;
  for (int j = 0; j < 10; ++j) {
    float s = 0.f;
    for (int i = 0; i < 10; ++i) s += S[i * 10 + j] * S[i * 10 + j];
    if (s > bestn) {
      bestn = s;
      col = j;
    }
  }
  float nn = 0.f;
  for (int i = 0; i < 10; ++i) {
    v[i] = S[i * 10 + col];
    nn += v[i] * v[i];
  }
  nn = sqrtf(nn) + 1e-12f;
  for (int i = 0; i < 10; ++i) v[i] /= nn;
}

// thread 0: the orthonormal null basis [4][9] of the set's 5x9 system
__device__ void null_basis(const float* s1, const float* s2, const float* probe, float* basis) {
  float A[5][9];
  for (int r = 0; r < 5; ++r)
    for (int u = 0; u < 3; ++u)
      for (int v = 0; v < 3; ++v) A[r][3 * u + v] = s2[3 * r + u] * s1[3 * r + v];
  float G[5][5];
  float tr = 0.f;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j) {
      float s = 0.f;
      for (int k = 0; k < 9; ++k) s += A[i][k] * A[j][k];
      G[i][j] = s;
    }
  for (int i = 0; i < 5; ++i) tr += G[i][i];
  for (int i = 0; i < 5; ++i) G[i][i] += 1e-8f * tr;
  // unrolled Cholesky (eps 1e-20)
  float L[5][5] = {};
  for (int j = 0; j < 5; ++j) {
    float s = G[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    s = sqrtf(fmaxf(s, 1e-20f));
    L[j][j] = s;
    const float inv = 1.f / s;
    for (int i = j + 1; i < 5; ++i) {
      float v = G[i][j];
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v * inv;
    }
  }
  // X[m] = (A A^T)^-1 A[:, m] for each of the 9 columns
  float X[9][5];
  for (int m = 0; m < 9; ++m) {
    float y[5];
    for (int i = 0; i < 5; ++i) {
      float v = A[i][m];
      for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
      y[i] = v / L[i][i];
    }
    for (int i = 4; i >= 0; --i) {
      float v = y[i];
      for (int k = i + 1; k < 5; ++k) v -= L[k][i] * X[m][k];
      X[m][i] = v / L[i][i];
    }
  }
  // P = I - A^T X^T, Y = P probe [9][4]
  float Y[9][4];
  for (int i = 0; i < 9; ++i)
    for (int c = 0; c < 4; ++c) Y[i][c] = 0.f;
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j) {
      float s = 0.f;
      for (int k = 0; k < 5; ++k) s += A[k][i] * X[j][k];
      const float P = (i == j ? 1.f : 0.f) - s;
      for (int c = 0; c < 4; ++c) Y[i][c] += P * probe[j * 4 + c];
    }
  // modified Gram-Schmidt
  for (int c = 0; c < 4; ++c) {
    float v[9];
    for (int i = 0; i < 9; ++i) v[i] = Y[i][c];
    for (int u = 0; u < c; ++u) {
      float d = 0.f;
      for (int i = 0; i < 9; ++i) d += v[i] * basis[u * 9 + i];
      for (int i = 0; i < 9; ++i) v[i] -= d * basis[u * 9 + i];
    }
    float nn = 0.f;
    for (int i = 0; i < 9; ++i) nn += v[i] * v[i];
    nn = sqrtf(nn) + 1e-20f;
    for (int i = 0; i < 9; ++i) basis[c * 9 + i] = v[i] / nn;
  }
}

// thread e < 10: cubic e into row e of Mk [4][10][10], scaled to a unit
// largest |coefficient|
__device__ void cubic_row(const float* basis, int e, float* Mk) {
  // the linear form of E(i, j): (x, y, z, 1) coefficients
  auto lin = [&](int i, int j, float* l) {
    for (int c = 0; c < 4; ++c) l[c] = basis[c * 9 + 3 * i + j];
  };
  float out[64];
  for (int q = 0; q < 64; ++q) out[q] = 0.f;
  float la[4], lb[4], lc[4], q[64];
  if (e == 0) {
    // det = m00 (m11 m22 - m12 m21) - m01 (m10 m22 - m12 m20)
    //       + m02 (m10 m21 - m11 m20): column `col` of row 0 times its minor
    for (int col = 0; col < 3; ++col) {
      const int c0 = col == 0 ? 1 : 0, c1 = col == 2 ? 1 : 2;
      for (int w = 0; w < 64; ++w) q[w] = 0.f;
      lin(1, c0, la);
      lin(2, c1, lb);
      lin_mul(la, lb, q);
      lin(1, c1, la);
      lin(2, c0, lb);
      for (int w = 0; w < 4; ++w) lb[w] = -lb[w];
      lin_mul(la, lb, q);
      lin(0, col, lc);
      quad_lin_mul(q, lc, col == 1 ? -1.f : 1.f, out);
    }
  } else {
    const int i = (e - 1) / 3, l = (e - 1) % 3;
    // T[i][k] = sum_j m(i, j) m(k, j), tr = T00 + T11 + T22
    float tq[64];
    for (int w = 0; w < 64; ++w) tq[w] = 0.f;
    for (int k = 0; k < 3; ++k)
      for (int j = 0; j < 3; ++j) {
        lin(k, j, la);
        lin_mul(la, la, tq);
      }
    for (int k = 0; k < 3; ++k) {
      for (int w = 0; w < 64; ++w) q[w] = 0.f;
      for (int j = 0; j < 3; ++j) {
        lin(i, j, la);
        lin(k, j, lb);
        lin_mul(la, lb, q);
      }
      lin(k, l, lc);
      quad_lin_mul(q, lc, 2.f, out);
    }
    lin(i, l, lc);
    quad_lin_mul(tq, lc, -1.f, out);
  }
  float row[4][10];
  for (int c = 0; c < 4; ++c)
    for (int k = 0; k < 10; ++k) row[c][k] = 0.f;
  for (int a = 0; a <= 3; ++a)
    for (int b = 0; a + b <= 3; ++b)
      for (int c = 0; a + b + c <= 3; ++c) row[c][mono_col(a, b)] += out[a * 16 + b * 4 + c];
  float mx = 0.f;
  for (int c = 0; c < 4; ++c)
    for (int k = 0; k < 10; ++k) mx = fmaxf(mx, fabsf(row[c][k]));
  mx = fmaxf(mx, 1e-20f);
  for (int c = 0; c < 4; ++c)
    for (int k = 0; k < 10; ++k) Mk[c * 100 + e * 10 + k] = row[c][k] / mx;
}

__global__ void __launch_bounds__(kThreads)
essential_5pt_kernel(int N, const float* __restrict__ b1, const float* __restrict__ b2,
                     const uint8_t* __restrict__ valid, uint32_t seed,
                     const float* __restrict__ theta, const float* __restrict__ probe,
                     int* __restrict__ out_idx, float* __restrict__ out_E,
                     uint8_t* __restrict__ out_ok) {
  __shared__ int idx[5];
  __shared__ float s1[15], s2[15];
  __shared__ float basis[36];
  __shared__ float Mk[400];
  __shared__ float sg[kGrid + 1];
  __shared__ int start[kMaxRoots];
  __shared__ int nroots;
  const int b = blockIdx.x, tid = threadIdx.x;
  svt_ransac::sample_set<5>(seed, b, N, valid, idx);
  if (tid < 15) {
    s1[tid] = b1[3 * idx[tid / 3] + tid % 3];
    s2[tid] = b2[3 * idx[tid / 3] + tid % 3];
  }
  if (tid < 5) out_idx[5 * b + tid] = idx[tid];
  __syncthreads();
  if (tid == 0) null_basis(s1, s2, probe, basis);
  __syncthreads();
  if (tid < 10) cubic_row(basis, tid, Mk);
  __syncthreads();
  // the sign of det M(z) on the grid
  for (int g = tid; g <= kGrid; g += blockDim.x) {
    float M[100];
    eval_M(Mk, tanf(theta[g]), M);
    sg[g] = det_sign_10(M);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int g = 0; g < kGrid && n < kMaxRoots; ++g)
      if (sg[g] * sg[g + 1] < 0.f) start[n++] = g;
    nroots = n;
  }
  __syncthreads();
  const int r = tid;
  if (r >= kMaxRoots) return;
  float* E = out_E + (size_t)(b * kMaxRoots + r) * 9;
  if (r >= nroots) {
    for (int q = 0; q < 9; ++q) E[q] = 0.f;
    out_ok[b * kMaxRoots + r] = 0;
    return;
  }
  float lo = theta[start[r]], hi = theta[start[r] + 1];
  const float s_lo = sg[start[r]];
  float M[100], W[100];
  for (int it = 0; it < kBisect; ++it) {
    const float mid = mul(0.5f, add(lo, hi));
    eval_M(Mk, tanf(mid), M);
    const bool same = det_sign_10(M) * s_lo >= 0.f;
    lo = same ? mid : lo;
    hi = same ? hi : mid;
  }
  const float z = tanf(mul(0.5f, add(lo, hi)));
  eval_M(Mk, z, M);
  for (int i = 0; i < 10; ++i)
    for (int j = 0; j < 10; ++j) {
      float s = 0.f;
      for (int k = 0; k < 10; ++k) s += M[k * 10 + i] * M[k * 10 + j];
      W[i * 10 + j] = s;
    }
  float v[10];
  smallest_eigvec_10(W, M, v);
  float vn = 0.f;
  for (int i = 0; i < 10; ++i) vn += v[i] * v[i];
  const float denom = v[9];
  const bool ok_xy = fabsf(denom) > 1e-5f * sqrtf(vn);
  const float safe = fabsf(denom) < 1e-20f ? 1e-20f : denom;
  const float x = ok_xy ? v[7] / safe : 0.f, y = ok_xy ? v[8] / safe : 0.f;
  float e[9], en = 0.f;
  for (int q = 0; q < 9; ++q) {
    e[q] = x * basis[q] + y * basis[9 + q] + z * basis[18 + q] + basis[27 + q];
    en += e[q] * e[q];
  }
  en = sqrtf(en) + 1e-20f;
  for (int q = 0; q < 9; ++q) E[q] = e[q] / en;
  out_ok[b * kMaxRoots + r] = (ok_xy && isfinite(z)) ? 1 : 0;
}

}  // namespace

// B sets of 5 drawn from the valid of N bearing pairs b1, b2 [N,3] with the
// hash sampler under `seed`, each solved: out_idx [B,5], out_E [B,10,9]
// (zeros in empty slots), out_ok [B,10]. theta: the 257 grid angles; probe:
// the 9x4 Gram-Schmidt probe.
extern "C" int svt_essential_5pt(int N, const float* b1, const float* b2, const uint8_t* valid,
                                 unsigned int seed, int B, const float* theta,
                                 const float* probe, int* out_idx, float* out_E,
                                 uint8_t* out_ok, void* stream) {
  if (B > 0)
    essential_5pt_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
        N, b1, b2, valid, seed, theta, probe, out_idx, out_E, out_ok);
  return (int)cudaGetLastError();
}
