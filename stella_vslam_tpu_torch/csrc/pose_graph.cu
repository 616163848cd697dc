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
//  pg_index_kernel (once an optimization, one thread a vertex): each
//    vertex's valid edges in edge order, the index the assembly walks (the
//    graph's topology holds for all its iterations).
//  pg_linearize_kernel (a warp an edge): lanes 0-13 each run one Jacobian
//    column's forward-mode dual pass through the sim3_exp / compose /
//    inverse / sim3_log program (sim3.cuh), lane 14 the residual in float;
//    the columns meet in shared memory and the lanes form the edge's terms
//    J^T J [14,14], J^T r [14] and |r|^2 in its row of a scratch, each entry
//    summed over p in order as one thread took it (an edge's latency is one
//    pass, where one thread an edge ran fifteen).
//  pg_assemble_kernel (a thread per entry of the dense [7K,7K] system): the
//    terms of the edges that touch both its vertices, walking its row
//    vertex's edges in edge order, each entry of the [7K] vector likewise,
//    one thread the cost over all edges in order; then the gauge: rows and
//    columns of fixed and invalid vertices are cleared and get a unit
//    diagonal, every diagonal entry gets 1e-6. No atomics: the same inputs
//    give the same bits on every launch, and each sum runs in edge order,
//    as a scan of all E edges would take it.
//  pg_update_kernel (one thread per vertex): dx = -x on the free vertices,
//    Exp(dx) composed on the left.
// The dense solve between them is the caller's.
//
// Bound: operations and latency. An edge costs ~15 passes of ~600
// operations plus 14 x 15 x 7 x 2 for its terms; at E = 128 that is ~1.5 M
// operations against 4 (7K)^2 bytes of system (200 KB at K = 32):
// microseconds either way, so the kernel is bound by one dual pass's chain
// and by its launches.
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

// per edge in the scratch: J^T J [14,14], J^T r [14], |r|^2
constexpr int kEdgeTerms = 14 * 14 + 14 + 1;

// each vertex's valid edges (an edge once) in edge order: inc[k * E + d],
// d < deg[k]
__global__ void pg_index_kernel(int K, int E, const int* __restrict__ edge_i,
                                const int* __restrict__ edge_j,
                                const uint8_t* __restrict__ edge_valid, int* __restrict__ inc,
                                int* __restrict__ deg) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  int d = 0;
  for (int e = 0; e < E; ++e)
    if (edge_valid[e] && (edge_i[e] == k || edge_j[e] == k)) inc[(size_t)k * E + d++] = e;
  deg[k] = d;
}

// the end slots (0..13) of an edge (vi, vj) that map to system row `row`:
// 0-6 vertex vi, 7-13 vertex vj; -1 where the edge does not touch it
__device__ __forceinline__ void end_slots(int row, int vi, int vj, int* a) {
  const int v = row / 7, c = row % 7;
  a[0] = v == vi ? c : -1;
  a[1] = v == vj ? 7 + c : -1;
}

constexpr int kWarpsPerBlock = 4;

// A warp an edge: lane c < 14 the dual pass of Jacobian column c, lane 14
// the residual; then the edge's terms, each entry summed over p in order.
// An edge's residual can round an ulp apart from a layout that runs all
// fifteen passes in one thread, whose compiler merges the float pass with
// the dual passes (PERF.md §6, K17b).
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pg_linearize_kernel(int E, const float* __restrict__ s, const float* __restrict__ R,
                    const float* __restrict__ t, const int* __restrict__ edge_i,
                    const int* __restrict__ edge_j, const float* __restrict__ edge_s,
                    const float* __restrict__ edge_R, const float* __restrict__ edge_t,
                    const uint8_t* __restrict__ edge_valid, float* __restrict__ terms) {
  __shared__ float Js[kWarpsPerBlock][7][15];  // J[p][c], column 14 the residual
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarpsPerBlock + warp;
  if (e >= E || !edge_valid[e]) return;  // the whole warp leaves together
  float(&J)[7][15] = Js[warp];
  const int vi = edge_i[e], vj = edge_j[e];
  const Sim3f Si = load_sim3(s, R, t, vi), Sj = load_sim3(s, R, t, vj);
  const Sim3f Sm = load_sim3(edge_s, edge_R, edge_t, e);
  if (lane < 14) {
    Dual rd[7];
    edge_residual<Dual>(Si, Sj, Sm, lane, rd);
    for (int p = 0; p < 7; ++p) J[p][lane] = rd[p].d;
  } else if (lane == 14) {
    float r[7];
    edge_residual<float>(Si, Sj, Sm, -1, r);
    for (int p = 0; p < 7; ++p) J[p][14] = r[p];
  }
  __syncwarp();
  float* out = terms + (size_t)e * kEdgeTerms;
  // 196 + 14 + 1 entries over the 32 lanes; column 14 holds r, so J^T r is
  // the row's 15th entry and |r|^2 the (14, 14) one
  for (int q = lane; q < 15 * 15; q += 32) {
    const int a = q / 15, c = q % 15;
    if (a == 14 && c < 14) continue;
    float h = 0.f;
    for (int p = 0; p < 7; ++p) h += J[p][a] * J[p][c];
    out[a == 14 ? 210 : (c == 14 ? 196 + a : a * 14 + c)] = h;
  }
}

// Each entry of the system walks its row vertex's edges (pg_index_kernel)
// and adds the terms of those that touch its column vertex, in edge order.
__global__ void pg_assemble_kernel(int K, int E, const int* __restrict__ edge_i,
                                   const int* __restrict__ edge_j,
                                   const uint8_t* __restrict__ edge_valid,
                                   const uint8_t* __restrict__ fixed,
                                   const uint8_t* __restrict__ valid,
                                   const int* __restrict__ inc, const int* __restrict__ deg,
                                   const float* __restrict__ terms, float* __restrict__ Hd,
                                   float* __restrict__ b, float* __restrict__ cost) {
  const int n = 7 * K;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n * n) return;
  const int row = q / n, col = q % n;
  const int* ie = inc + (size_t)(row / 7) * E;
  const int nd = deg[row / 7];
  float h = 0.f;
  for (int d = 0; d < nd; ++d) {
    const int e = ie[d];
    const int vi = edge_i[e], vj = edge_j[e];
    int ra[2], ca[2];
    end_slots(row, vi, vj, ra);
    end_slots(col, vi, vj, ca);
    const float* te = terms + (size_t)e * kEdgeTerms;
    for (int x = 0; x < 2; ++x)
      for (int y = 0; y < 2; ++y)
        if (ra[x] >= 0 && ca[y] >= 0) h += te[ra[x] * 14 + ca[y]];
  }
  const float fi = (valid[row / 7] && !fixed[row / 7]) ? 1.f : 0.f;
  const float fj = (valid[col / 7] && !fixed[col / 7]) ? 1.f : 0.f;
  float v = h * fi * fj;
  if (row == col) {
    v = v + (1.f - fi) + 1e-6f;
    float g = 0.f;
    for (int d = 0; d < nd; ++d) {
      const int e = ie[d];
      int ra[2];
      end_slots(row, edge_i[e], edge_j[e], ra);
      for (int x = 0; x < 2; ++x)
        if (ra[x] >= 0) g += terms[(size_t)e * kEdgeTerms + 196 + ra[x]];
    }
    b[row] = g * fi;
  }
  Hd[q] = v;
  if (q == 0) {
    float c = 0.f;
    for (int e = 0; e < E; ++e)
      if (edge_valid[e]) c += terms[(size_t)e * kEdgeTerms + 210];
    *cost = c;
  }
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

// The graph's index, once an optimization: inc [K,E], deg [K] ints.
extern "C" int svt_pose_graph_index(int K, int E, const int* edge_i, const int* edge_j,
                                    const uint8_t* edge_valid, int* inc, int* deg,
                                    void* stream) {
  if (K > 0)
    pg_index_kernel<<<(K + 63) / 64, 64, 0, (cudaStream_t)stream>>>(K, E, edge_i, edge_j,
                                                                      edge_valid, inc, deg);
  return (int)cudaGetLastError();
}

// terms: E x 211 floats of device memory; inc and deg from
// svt_pose_graph_index
extern "C" int svt_pose_graph_linearize(int K, int E, const float* s, const float* R,
                                        const float* t, const uint8_t* fixed,
                                        const uint8_t* valid, const int* edge_i,
                                        const int* edge_j, const float* edge_s,
                                        const float* edge_R, const float* edge_t,
                                        const uint8_t* edge_valid, const int* inc,
                                        const int* deg, float* Hd, float* b, float* cost,
                                        float* terms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 7 * K;
  if (E > 0)
    pg_linearize_kernel<<<(E + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0,
                          st>>>(E, s, R, t, edge_i, edge_j, edge_s, edge_R, edge_t, edge_valid,
                                terms);
  if (n > 0)
    pg_assemble_kernel<<<(n * n + 255) / 256, 256, 0, st>>>(K, E, edge_i, edge_j, edge_valid,
                                                            fixed, valid, inc, deg, terms, Hd, b,
                                                            cost);
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
