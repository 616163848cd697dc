// Kernel P: one Gauss-Newton iteration of the Sim(3) pose graph, around the
// dense solve.
//
// Replaces the body of stella_vslam_tpu/ops/optim/sim3.py optimize_pose_graph
// (:165) gn_step: the per-edge residual r = log(S_meas^-1 S_i S_j^-1) (:149)
// and its [7,14] Jacobian at zero left perturbation of both ends, the sums
// into the normal equations, the gauge rows (:246-252), and the update
// S_k <- Exp(dx_k) S_k (:258). The TPU form gathers the edge ends by one-hot
// [E,K] matmuls, takes the Jacobian by jax.jacfwd under vmap, and assembles
// H [K,K,7,7] by three segment sums and a transpose.
//
//  pg_linearize_kernel (one thread per edge): the residual in float, then
//    its 14 Jacobian columns by forward-mode dual numbers through the same
//    sim3_exp / compose / inverse / sim3_log program (sim3.cuh), one pass per
//    column; the blocks J_i^T J_i, J_i^T J_j (and its transpose), J_j^T J_j
//    and J^T r are added into the dense [7K,7K] system and [7K] vector by
//    atomics, the squared residual into a scalar.
//  pg_gauge_kernel (grid over the system's entries): rows and columns of
//    fixed and invalid vertices are cleared and get a unit diagonal; every
//    diagonal entry gets 1e-6.
//  pg_update_kernel (one thread per vertex): dx = -x on the free vertices,
//    Exp(dx) composed on the left.
// The dense solve between them is the caller's.
//
// Bound: operations and latency. An edge costs ~15 passes of ~600
// operations plus 3 x 49 x 7 for its blocks; at E = 256 that is ~3 M
// operations against 4 (7K)^2 bytes of system (200 KB at K = 32): microseconds
// either way, so the kernel is bound by one thread's serial residual passes.
// The atomics sum in an order that changes from run to run, as kernel F's do.
#include <stdint.h>

#include "sim3.cuh"

namespace {

using sim3::Dual;

struct Sim3f {
  float s, R[9], t[3];
};

__device__ __forceinline__ Sim3f load_sim3(const float* s, const float* R, const float* t,
                                           int k) {
  Sim3f o;
  o.s = s[k];
  for (int i = 0; i < 9; ++i) o.R[i] = R[9 * k + i];
  for (int i = 0; i < 3; ++i) o.t[i] = t[3 * k + i];
  return o;
}

__device__ __forceinline__ void unit_tangent(float&) {}
__device__ __forceinline__ void unit_tangent(Dual& x) { x.d = 1.f; }

// r = log(S_m^-1 (Exp(xi_i) S_i) (Exp(xi_j) S_j)^-1); xi = 0 except a unit
// tangent in column `col` (0..6 end i, 7..13 end j; -1 none)
template <typename T>
__device__ void edge_residual(const Sim3f& Si, const Sim3f& Sj, const Sim3f& Sm, int col, T* r) {
  T xi_i[7], xi_j[7];
  for (int c = 0; c < 7; ++c) {
    xi_i[c] = T(0.f);
    xi_j[c] = T(0.f);
  }
  if (col >= 0 && col < 7) unit_tangent(xi_i[col]);
  if (col >= 7) unit_tangent(xi_j[col - 7]);
  T ds, dR[9], dt[3], Rk[9], tk[3];
  T si, Ri[9], ti[3], sj, Rj[9], tj[3];
  for (int c = 0; c < 9; ++c) Rk[c] = T(Si.R[c]);
  for (int c = 0; c < 3; ++c) tk[c] = T(Si.t[c]);
  sim3::sim3_exp(xi_i, ds, dR, dt);
  sim3::sim3_compose(ds, dR, dt, T(Si.s), Rk, tk, si, Ri, ti);
  for (int c = 0; c < 9; ++c) Rk[c] = T(Sj.R[c]);
  for (int c = 0; c < 3; ++c) tk[c] = T(Sj.t[c]);
  sim3::sim3_exp(xi_j, ds, dR, dt);
  sim3::sim3_compose(ds, dR, dt, T(Sj.s), Rk, tk, sj, Rj, tj);
  T sji, Rji[9], tji[3], sij, Rij[9], tij[3];
  sim3::sim3_inverse(sj, Rj, tj, sji, Rji, tji);
  sim3::sim3_compose(si, Ri, ti, sji, Rji, tji, sij, Rij, tij);
  for (int c = 0; c < 9; ++c) Rk[c] = T(Sm.R[c]);
  for (int c = 0; c < 3; ++c) tk[c] = T(Sm.t[c]);
  T smi, Rmi[9], tmi[3], se, Re[9], te[3];
  sim3::sim3_inverse(T(Sm.s), Rk, tk, smi, Rmi, tmi);
  sim3::sim3_compose(smi, Rmi, tmi, sij, Rij, tij, se, Re, te);
  sim3::sim3_log(se, Re, te, r);
}

__global__ void __launch_bounds__(64)
pg_linearize_kernel(int K, int E, const float* __restrict__ s, const float* __restrict__ R,
                    const float* __restrict__ t, const int* __restrict__ edge_i,
                    const int* __restrict__ edge_j, const float* __restrict__ edge_s,
                    const float* __restrict__ edge_R, const float* __restrict__ edge_t,
                    const uint8_t* __restrict__ edge_valid, float* __restrict__ Hd,
                    float* __restrict__ b, float* __restrict__ cost) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E || !edge_valid[e]) return;
  const int vi = edge_i[e], vj = edge_j[e];
  const Sim3f Si = load_sim3(s, R, t, vi), Sj = load_sim3(s, R, t, vj);
  const Sim3f Sm = load_sim3(edge_s, edge_R, edge_t, e);
  float r[7];
  edge_residual<float>(Si, Sj, Sm, -1, r);
  float J[7][14];
  for (int c = 0; c < 14; ++c) {
    Dual rd[7];
    edge_residual<Dual>(Si, Sj, Sm, c, rd);
    for (int p = 0; p < 7; ++p) J[p][c] = rd[p].d;
  }
  const int n = 7 * K;
  float c2 = 0.f;
  for (int p = 0; p < 7; ++p) c2 += r[p] * r[p];
  atomicAdd(cost, c2);
  for (int a = 0; a < 14; ++a) {
    const int ra = (a < 7 ? vi * 7 + a : vj * 7 + a - 7);
    float g = 0.f;
    for (int p = 0; p < 7; ++p) g += J[p][a] * r[p];
    atomicAdd(&b[ra], g);
    for (int c = 0; c < 14; ++c) {
      const int rc = (c < 7 ? vi * 7 + c : vj * 7 + c - 7);
      float h = 0.f;
      for (int p = 0; p < 7; ++p) h += J[p][a] * J[p][c];
      atomicAdd(&Hd[ra * n + rc], h);
    }
  }
}

__global__ void pg_gauge_kernel(int K, const uint8_t* __restrict__ fixed,
                                const uint8_t* __restrict__ valid, float* __restrict__ Hd,
                                float* __restrict__ b) {
  const int n = 7 * K;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n * n) return;
  const int row = q / n, col = q % n;
  const float fi = (valid[row / 7] && !fixed[row / 7]) ? 1.f : 0.f;
  const float fj = (valid[col / 7] && !fixed[col / 7]) ? 1.f : 0.f;
  float v = Hd[q] * fi * fj;
  if (row == col) {
    v = v + (1.f - fi) + 1e-6f;
    b[row] *= fi;
  }
  Hd[q] = v;
}

__global__ void pg_update_kernel(int K, const float* __restrict__ s, const float* __restrict__ R,
                                 const float* __restrict__ t, const uint8_t* __restrict__ fixed,
                                 const uint8_t* __restrict__ valid, const float* __restrict__ x,
                                 float* __restrict__ s2, float* __restrict__ R2,
                                 float* __restrict__ t2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float free = (valid[k] && !fixed[k]) ? 1.f : 0.f;
  float dx[7];
  for (int c = 0; c < 7; ++c) dx[c] = -x[7 * k + c] * free;
  const Sim3f S = load_sim3(s, R, t, k);
  float ds, dR[9], dt[3], so, Ro[9], to[3];
  sim3::sim3_exp(dx, ds, dR, dt);
  sim3::sim3_compose(ds, dR, dt, S.s, S.R, S.t, so, Ro, to);
  s2[k] = so;
  for (int i = 0; i < 9; ++i) R2[9 * k + i] = Ro[i];
  for (int i = 0; i < 3; ++i) t2[3 * k + i] = to[i];
}

}  // namespace

extern "C" int svt_pose_graph_linearize(int K, int E, const float* s, const float* R,
                                        const float* t, const uint8_t* fixed,
                                        const uint8_t* valid, const int* edge_i,
                                        const int* edge_j, const float* edge_s,
                                        const float* edge_R, const float* edge_t,
                                        const uint8_t* edge_valid, float* Hd, float* b,
                                        float* cost, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (E > 0)
    pg_linearize_kernel<<<(E + 63) / 64, 64, 0, st>>>(K, E, s, R, t, edge_i, edge_j, edge_s,
                                                      edge_R, edge_t, edge_valid, Hd, b, cost);
  const int n = 7 * K;
  if (n > 0) pg_gauge_kernel<<<(n * n + 255) / 256, 256, 0, st>>>(K, fixed, valid, Hd, b);
  return (int)cudaGetLastError();
}

extern "C" int svt_pose_graph_update(int K, const float* s, const float* R, const float* t,
                                     const uint8_t* fixed, const uint8_t* valid, const float* x,
                                     float* s2, float* R2, float* t2, void* stream) {
  if (K > 0)
    pg_update_kernel<<<(K + 63) / 64, 64, 0, (cudaStream_t)stream>>>(K, s, R, t, fixed, valid, x,
                                                                     s2, R2, t2);
  return (int)cudaGetLastError();
}
