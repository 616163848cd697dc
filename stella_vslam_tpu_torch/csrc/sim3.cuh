// Sim(3) group operations for the kernels O and P, as templates over the
// scalar type: float, or Dual (a value with one forward-mode tangent).
//
// Each function follows stella_vslam_tpu/ops/lie.py (so3_exp :56, so3_log
// :69, _sim3_W :194, sim3_exp :229, sim3_log :239, sim3_compose :183,
// sim3_inverse :188) expression by expression, with the same Taylor
// switches decided on the values, so that a Dual run through them gives the
// derivative that forward-mode differentiation of that program gives
// (jax.jacfwd there, torch.func.jacfwd in the plain version): a clamp passes
// the tangent inside its range and stops it outside, a switch takes the
// tangent of the branch it selects.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace sim3 {

struct Dual {
  float v, d;
  __device__ Dual() : v(0.f), d(0.f) {}
  __device__ Dual(float v_) : v(v_), d(0.f) {}
  __device__ Dual(float v_, float d_) : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ float val(Dual a) { return a.v; }
__device__ __forceinline__ float tsin(float a) { return sinf(a); }
__device__ __forceinline__ Dual tsin(Dual a) { return Dual(sinf(a.v), cosf(a.v) * a.d); }
__device__ __forceinline__ float tcos(float a) { return cosf(a); }
__device__ __forceinline__ Dual tcos(Dual a) { return Dual(cosf(a.v), -sinf(a.v) * a.d); }
__device__ __forceinline__ float texp(float a) { return expf(a); }
__device__ __forceinline__ Dual texp(Dual a) {
  const float e = expf(a.v);
  return Dual(e, e * a.d);
}
__device__ __forceinline__ float tlog(float a) { return logf(a); }
__device__ __forceinline__ Dual tlog(Dual a) { return Dual(logf(a.v), a.d / a.v); }
__device__ __forceinline__ float tsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual tsqrt(Dual a) {
  const float r = sqrtf(a.v);
  return Dual(r, a.d / (2.f * r));
}
__device__ __forceinline__ float tacos(float a) { return acosf(a); }
__device__ __forceinline__ Dual tacos(Dual a) {
  return Dual(acosf(a.v), -a.d / sqrtf(1.f - a.v * a.v));
}
// max(a, c) and clamp(a, lo, hi) against constants: the tangent stops where
// the constant wins
__device__ __forceinline__ float tmax(float a, float c) { return a > c ? a : c; }
__device__ __forceinline__ Dual tmax(Dual a, float c) { return a.v > c ? a : Dual(c); }
__device__ __forceinline__ float tclamp(float a, float lo, float hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}
__device__ __forceinline__ Dual tclamp(Dual a, float lo, float hi) {
  return a.v < lo ? Dual(lo) : (a.v > hi ? Dual(hi) : a);
}

template <typename T>
__device__ __forceinline__ void matmul3(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <typename T>
__device__ __forceinline__ void matvec3(const T* A, const T* x, T* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

// out = a I + b K + c K^2, K = hat(phi)
template <typename T>
__device__ __forceinline__ void rodrigues_form(T a, T b, T c, const T* phi, T* out) {
  const T z = T(0.f);
  const T K[9] = {z, -phi[2], phi[1], phi[2], z, -phi[0], -phi[1], phi[0], z};
  T K2[9];
  matmul3(K, K, K2);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = (i % 4 == 0 ? a : z) + b * K[i] + c * K2[i];
}

template <typename T>
__device__ void so3_exp(const T* phi, T* R) {
  const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T theta = tsqrt(tmax(theta2, 1e-16f));
  T a, b;
  if (val(theta2) < 1e-8f) {
    a = T(1.f) - theta2 / T(6.f);
    b = T(0.5f) - theta2 / T(24.f);
  } else {
    a = tsin(theta) / theta;
    b = (T(1.f) - tcos(theta)) / theta2;
  }
  rodrigues_form(T(1.f), a, b, phi, R);
}

// W of exp([[sigma I + hat(phi), rho], [0, 0]]) = [[e^sigma R, W rho], [0, 1]]
template <typename T>
__device__ void sim3_W(T sigma, const T* phi, T* W) {
  const T one = T(1.f);
  const T s = texp(sigma);
  const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T theta = tsqrt(tmax(theta2, 1e-8f));
  const T sig2 = sigma * sigma;
  const bool small_sig = fabsf(val(sigma)) < 1e-4f;
  const bool small_th = val(theta2) < 1e-8f;
  const T safe_sig = small_sig ? one : sigma;
  const T safe_sig2 = small_sig ? one : sig2;
  const T safe_th2 = small_th ? one : theta2;
  const T c = theta2 + sig2;
  const T safe_c = val(c) < 1e-8f ? one : c;
  const T sin_t = tsin(theta), cos_t = tcos(theta);
  const T A = small_sig ? one + sigma / T(2.f) + sig2 / T(6.f) : (s - one) / safe_sig;
  T B, C;
  if (small_th) {
    B = small_sig ? T(0.5f) + sigma / T(3.f) : ((sigma - one) * s + one) / safe_sig2;
    C = small_sig ? T(1.f / 6.f) + sigma / T(8.f)
                  : (s * (T(0.5f) * sig2 - sigma + one) - one) / (safe_sig2 * safe_sig);
  } else if (small_sig) {
    B = (one - cos_t) / safe_th2;
    C = (theta - sin_t) / (safe_th2 * theta);
  } else {
    B = (sigma * s * sin_t + (one - s * cos_t) * theta) / (theta * safe_c);
    C = (A - ((s * cos_t - one) * sigma + s * sin_t * theta) / safe_c) / safe_th2;
  }
  rodrigues_form(A, B, C, phi, W);
}

// xi = (rho, phi, sigma) -> (s, R, t)
template <typename T>
__device__ void sim3_exp(const T* xi, T& s, T* R, T* t) {
  s = texp(xi[6]);
  so3_exp(xi + 3, R);
  T W[9];
  sim3_W(xi[6], xi + 3, W);
  matvec3(W, xi, t);
}

template <typename T>
__device__ void so3_log(const T* R, T* phi) {
  const T trace = R[0] + R[4] + R[8];
  const T cos_theta = tclamp((trace - T(1.f)) * T(0.5f), (float)(-1.0 + 1e-7),
                             (float)(1.0 - 1e-7));
  const T theta = tacos(cos_theta);
  const T factor = val(theta) < 1e-4f ? T(0.5f) + theta * theta / T(12.f)
                                      : theta / (T(2.f) * tsin(theta));
  phi[0] = factor * (R[7] - R[5]);
  phi[1] = factor * (R[2] - R[6]);
  phi[2] = factor * (R[3] - R[1]);
}

// closed-form 3x3 inverse (adjugate over the determinant, |det| < 1e-12
// clamped), ops/linalg.py inv3x3
template <typename T>
__device__ void inv3x3(const T* A, T* out) {
  const T a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5], g = A[6], h = A[7],
          i = A[8];
  const T A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const T A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const T A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  T det = a * A11 + b * A21 + c * A31;
  if (fabsf(val(det)) < 1e-12f) det = T(1e-12f);
  out[0] = A11 / det; out[1] = A12 / det; out[2] = A13 / det;
  out[3] = A21 / det; out[4] = A22 / det; out[5] = A23 / det;
  out[6] = A31 / det; out[7] = A32 / det; out[8] = A33 / det;
}

// (s, R, t) -> (rho, phi, sigma)
template <typename T>
__device__ void sim3_log(T s, const T* R, const T* t, T* out) {
  so3_log(R, out + 3);
  out[6] = tlog(s);
  T W[9], Wi[9];
  sim3_W(out[6], out + 3, W);
  inv3x3(W, Wi);
  matvec3(Wi, t, out);
}

// (sa, Ra, ta) * (sb, Rb, tb)
template <typename T>
__device__ void sim3_compose(T sa, const T* Ra, const T* ta, T sb, const T* Rb, const T* tb,
                             T& s, T* R, T* t) {
  T Rt[3];
  matvec3(Ra, tb, Rt);
  matmul3(Ra, Rb, R);
  s = sa * sb;
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = sa * Rt[i] + ta[i];
}

template <typename T>
__device__ void sim3_inverse(T s, const T* R, const T* t, T& si, T* Ri, T* ti) {
  si = T(1.f) / s;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Ri[3 * i + j] = R[3 * j + i];
  T Rt[3];
  matvec3(Ri, t, Rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) ti[i] = -si * Rt[i];
}

}  // namespace sim3
