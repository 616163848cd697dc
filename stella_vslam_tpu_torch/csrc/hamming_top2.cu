// Kernel C: gated 256-bit Hamming best/second-best search.
//
// Replaces the [M,N] distance matrix of stella_vslam_tpu/match/hamming.py
// (pairwise_hamming :31, best_and_second :96) as the matchers use it:
// match/projection.py match_frame_and_landmarks (:25),
// match_current_and_last_frames (:99) and match_frame_and_keyframe (:160),
// match/robust.py brute_force_match (:92), and the initializer's
// match/area.py match_in_consistent_area (:19). The TPU form is a +/-1 int8
// matmul into an [M,N] matrix, masked by [M,N] gate tensors, then argmin
// passes over the rows.
//
// On Hopper, three kernels:
//  - cell_index_kernel (svt_cell_index): the targets sorted by a grid cell
//    of their (u, v), one block of 1024 threads per set of targets (kernel
//    C's one set; kernel L's fuse chunk, a set per keyframe, fuse.cu): each
//    thread counts its targets into shared-memory cell counters with
//    atomics, one block scan turns the counts into cell starts, and each
//    target takes its place in its cell with a second atomic, so a cell's
//    targets are in no fixed order (the walks below keep the least keys of
//    what they visit, which does not depend on it). Targets outside the
//    grid go to its border cells (the clamp of the cell coordinate), so
//    fisheye and division coordinates far outside the image are still
//    found; targets with a NaN coordinate go to a bucket after every cell,
//    which no window reaches (no window test passes for them in the dense
//    walk either). The wrapper builds the index of a window call's targets
//    over the window's image extent, then launches the walk.
//  - window_top2_kernel (the window modes: stages 1 and 3, the loop
//    rematch, the area matcher): one warp per query row. A row whose row_ok
//    is false writes what the dense walk writes at once. Otherwise the row
//    visits only the cells that meet its window, widened by a margin that
//    covers float rounding (0.01 px + 1e-5 of the coordinate's magnitude;
//    a NaN bound widens to the whole grid): in each cell row the cells
//    between its ends are one contiguous range of the sorted targets. Each
//    visited target goes through the gates with the float expressions of
//    the dense test, and the lanes keep a top-2 of the packed key
//    (dist << 16 | target), merged by shuffles. The key order does not
//    depend on the order of the visit, and the cover is conservative, so
//    the result is the dense walk's.
//  - brute_top2_kernel (no window: the keyframe fallback): 8 query rows a
//    block, one warp each (several blocks an SM, so that a 2872-row call
//    spreads evenly over the SMs); the block stages tiles of 256 targets
//    (descriptors as two uint4 planes, col_ok, the orientation fields) in
//    shared memory with cp.async, double-buffered, so the targets are read
//    from L2 once per block rather than once per row. A block whose rows
//    all fail row_ok stages nothing. (A form with the single-bit
//    m16n8k256 mma, AND and popcount, for the distances took 0.088 ms on
//    an H100 against this form's 0.047 at 2872 x 2872.)
// Bound: the window modes are bound by the pairs they visit (at 752x480 a
// 32-px cell holds ~8 of 2872 targets, a stage-3 window meets 1-4 cells)
// and the chain of dependent loads of each visit; the brute-force mode by
// the operations of its pairs (8 XOR and 8 popcounts, the gates and the
// top-2 each: 8.2 M pairs at 2872 x 2872).
//
// Exactness: masked entries take the value 257, and the key order breaks
// ties to the lowest target index, so best, best_idx, second and second_idx
// are those of jnp.min/argmin over the JAX version's masked matrix (with
// second_idx 0 when no second candidate exists, as argmin over an all-257
// row gives). A walk that visits fewer than all targets seeds its top-2
// with the keys the dense walk's targets 0 and 1 would give without a
// candidate ((257 << 16) | 0 and | 1; one key when N = 1): a row with no
// candidate then reports best 257 at index 0, second 257 at 0. Two
// orientation gates: mode 1, the tracking matchers' cosine, rounded as the
// JAX expression is (two products, one sum, no FMA); mode 2, the area
// matcher's angle test |atan2(sin d, cos d)| <= thr with d = row angle -
// col angle, evaluated literally with CUDA's accurate sinf / cosf / atan2f
// (no fast-math), which may differ from the host's in the last ulp, so a
// pair within an ulp of the threshold can gate the other way.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cells.cuh"

namespace {

constexpr uint32_t kNone = 0xffffffffu;
constexpr uint32_t kMasked = 257u << 16;
constexpr int kIndexThreads = 1024;  // cell_index_kernel's block
constexpr int kMaxCells = 1024;
constexpr int kWindowRows = 4;  // one warp each: a row's visit is a chain of loads
constexpr int kBruteRows = 8;   // one warp each
constexpr int kTile = 256;           // targets a stage

__device__ __forceinline__ void push(uint32_t key, uint32_t& k1, uint32_t& k2) {
  if (key < k1) {
    k2 = k1;
    k1 = key;
  } else if (key < k2) {
    k2 = key;
  }
}

// merge the top-2 of `width` lanes (a power of two) by a butterfly
__device__ __forceinline__ void merge(uint32_t& k1, uint32_t& k2, unsigned mask, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    const uint32_t o1 = __shfl_xor_sync(mask, k1, o, width);
    const uint32_t o2 = __shfl_xor_sync(mask, k2, o, width);
    const uint32_t n1 = min(k1, o1);
    const uint32_t n2 = min(max(k1, o1), min(k2, o2));
    k1 = n1;
    k2 = n2;
  }
}

__device__ __forceinline__ void write_top2(int* out, uint32_t k1, uint32_t k2) {
  out[0] = (int)(k1 >> 16);
  out[1] = (int)(k1 & 0xffffu);
  int second = 257, second_idx = 0;
  if (k2 != kNone && (k2 >> 16) < 257) {
    second = (int)(k2 >> 16);
    second_idx = (int)(k2 & 0xffffu);
  }
  out[2] = second;
  out[3] = second_idx;
}

// the dense walk's keys of targets 0 and 1 when neither is a candidate
__device__ __forceinline__ void seeds(int N, uint32_t& k1, uint32_t& k2) {
  k1 = N > 0 ? kMasked : kNone;
  k2 = N > 1 ? (kMasked | 1u) : kNone;
}

using svt_cells::cell_of;
using svt_cells::cell_span;

// A counting sort of N targets into G1 buckets by one block of
// kIndexThreads (bucket_of(j) in [0, G1)): each thread counts its targets
// into shared-memory counters with atomics, one block scan turns the counts
// into bucket starts, and each target takes its place in its bucket with a
// second atomic, so a bucket's targets are in no fixed order. start[c] =
// the first position of bucket c, start[G1] = N; order = the targets by
// bucket.
template <class Bucket>
__device__ void bucket_sort(int N, int G1, const Bucket& bucket_of, int* __restrict__ start,
                            int* __restrict__ order) {
  __shared__ int cnt[kMaxCells + 2];
  __shared__ int warp_sum[kIndexThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < G1; c += kIndexThreads) cnt[c] = 0;
  __syncthreads();
  for (int j = tid; j < N; j += kIndexThreads) atomicAdd(&cnt[bucket_of(j)], 1);
  __syncthreads();
  // exclusive scan of the G1 counts: each thread a run of buckets, a warp
  // scan of the runs' sums, then one of the warps' totals
  const int per = (G1 + kIndexThreads - 1) / kIndexThreads;
  const int c_lo = min(G1, tid * per), c_hi = min(G1, c_lo + per);
  int sum = 0;
  for (int c = c_lo; c < c_hi; ++c) sum += cnt[c];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kIndexThreads / 32 ? warp_sum[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < kIndexThreads / 32) warp_sum[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - sum;
  for (int c = c_lo; c < c_hi; ++c) {
    const int n = cnt[c];
    cnt[c] = run;
    start[c] = run;
    run += n;
  }
  if (tid == 0) start[G1] = N;
  __syncthreads();
  for (int j = tid; j < N; j += kIndexThreads) order[atomicAdd(&cnt[bucket_of(j)], 1)] = j;
}

// The cell indexes (svt_cell_index): one block of kIndexThreads per set b
// of N targets (blockIdx.x), target j at u[b set_stride + j stride], v[...]
// (C's separate u, v arrays: stride 1; L's interleaved [B, N, 2] keypoints
// of a fuse chunk, read in place: u = uv, v = uv + 1, stride 2). order[b N
// ..] = the targets sorted by cell, in no fixed order within a cell;
// start[b (G + 2) + c] = the first position of cell c, for c = 0..G (G = gx
// * gy; cell G holds the NaN targets), start[b (G + 2) + G + 1] = N.
__global__ void __launch_bounds__(kIndexThreads)
cell_index_kernel(int N, const float* __restrict__ u_, const float* __restrict__ v_,
                  int stride, long long set_stride, float inv, int gx, int gy,
                  int* __restrict__ start, int* __restrict__ order) {
  const int G = gx * gy;
  u_ += blockIdx.x * set_stride;
  v_ += blockIdx.x * set_stride;
  const auto cell = [&](int j) {
    const float u = u_[(size_t)j * stride], v = v_[(size_t)j * stride];
    if (isnan(u) || isnan(v)) return G;
    return cell_of(v, inv, gy) * gx + cell_of(u, inv, gx);
  };
  bucket_sort(N, G + 1, cell, start + (size_t)blockIdx.x * (G + 2),
              order + (size_t)blockIdx.x * N);
}

// The gate arrays of a call (the window's target fields are read only in
// window mode, the orientation fields per use_orient).
struct Gates {
  const uint8_t* row_ok;
  const uint8_t* col_ok;
  const float *row_u, *row_v, *row_xr, *row_rad;
  const int *row_lo, *row_hi;
  const float *col_u, *col_v, *col_xr;
  const int* col_level;
  int use_orient;
  const float *row_c, *row_s, *col_c, *col_s;
  float cos_thr;
};

// the orientation gate of a pair (modes 1 and 2), with the target's fields
__device__ __forceinline__ bool orient_ok(const Gates& g, float rc, float rs, float cc,
                                          float cs) {
  if (g.use_orient == 1)
    return __fadd_rn(__fmul_rn(rc, cc), __fmul_rn(rs, cs)) >= g.cos_thr;
  if (g.use_orient == 2) {
    const float d = __fsub_rn(rc, cc);
    return fabsf(atan2f(sinf(d), cosf(d))) <= g.cos_thr;
  }
  return true;
}

__global__ void __launch_bounds__(kWindowRows * 32)
window_top2_kernel(int M, int N, const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                   Gates g, const int* __restrict__ start, const int* __restrict__ order,
                   float inv, int gx, int gy, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWindowRows + (threadIdx.x >> 5);
  if (row >= M) return;
  uint32_t k1, k2;
  seeds(N, k1, k2);
  if (lane != 0) k1 = k2 = kNone;  // one copy of the seeds in the row's lanes
  if (g.row_ok[row] != 0) {
    uint32_t qd[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) qd[w] = q[row * 8 + w];
    const float ru = g.row_u[row], rv = g.row_v[row], rxr = g.row_xr[row];
    const float rad = g.row_rad[row];
    const int lo = g.row_lo[row], hi = g.row_hi[row];
    const float rc = g.use_orient ? g.row_c[row] : 0.f;
    const float rs = g.use_orient == 1 ? g.row_s[row] : 0.f;
    int x0, x1, y0, y1;
    cell_span(ru, rad, inv, gx, x0, x1);
    cell_span(rv, rad, inv, gy, y0, y1);
    for (int cy = y0; cy <= y1 && x0 <= x1; ++cy) {
      const int e = start[cy * gx + x1 + 1];
      for (int k = start[cy * gx + x0] + lane; k < e; k += 32) {
        const int j = order[k];
        bool cand = g.col_ok[j] != 0;
        if (cand) {
          const float cxr = g.col_xr[j];
          const int lvl = g.col_level[j];
          cand = fabsf(g.col_u[j] - ru) <= rad && fabsf(g.col_v[j] - rv) <= rad &&
                 lvl >= lo && lvl <= hi &&
                 (!(cxr > 0.f && rxr > 0.f) || fabsf(rxr - cxr) <= rad);
        }
        if (cand && g.use_orient)
          cand = orient_ok(g, rc, rs, g.col_c[j], g.use_orient == 1 ? g.col_s[j] : 0.f);
        if (cand) {
          uint32_t dist = 0;
#pragma unroll
          for (int w = 0; w < 8; ++w) dist += __popc(qd[w] ^ t[j * 8 + w]);
          push((dist << 16) | (uint32_t)j, k1, k2);
        }
      }
    }
  }
  merge(k1, k2, 0xffffffffu, 32);
  if (lane == 0) write_top2(out + row * 4, k1, k2);
}

// 16-byte asynchronous copy global -> shared; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Tile {
  uint4 lo[kTile], hi[kTile];  // descriptor words 0-3 and 4-7
  float c[kTile], s[kTile];    // orientation fields
  uint8_t ok[kTile];
};

__global__ void __launch_bounds__(kBruteRows * 32)
brute_top2_kernel(int M, int N, const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                  Gates g, int* __restrict__ out) {
  __shared__ Tile tiles[2];
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.x * kBruteRows + (tid >> 5);
  const bool live = row < M && g.row_ok[row] != 0;
  uint32_t k1, k2;
  seeds(N, k1, k2);
  if (lane != 0) k1 = k2 = kNone;
  if (__syncthreads_or(live)) {
    uint32_t qd[8];
    float rc = 0.f, rs = 0.f;
    if (live) {
#pragma unroll
      for (int w = 0; w < 8; ++w) qd[w] = q[row * 8 + w];
      if (g.use_orient) rc = g.row_c[row];
      if (g.use_orient == 1) rs = g.row_s[row];
    }
    const int n_tiles = (N + kTile - 1) / kTile;
    // one stage: 2 x 256 descriptor halves, 16 col_ok chunks, 64 + 64
    // orientation chunks of 16 bytes
    auto stage = [&](int i, Tile& d) {
      const int j0 = i * kTile, n = min(kTile, N - j0);
      for (int x = tid; x < 2 * kTile; x += kBruteRows * 32) {
        const int jj = x >> 1, h = x & 1;
        void* dst = h ? (void*)&d.hi[jj] : (void*)&d.lo[jj];
        cp_async16(dst, t + (size_t)(j0 + min(jj, n - 1)) * 8 + h * 4, jj < n ? 16 : 0);
      }
      for (int x = tid; x < kTile / 16; x += kBruteRows * 32) {
        const int b = min(16, n - x * 16);
        cp_async16(&d.ok[x * 16], g.col_ok + j0 + (b > 0 ? x * 16 : 0), max(b, 0));
      }
      for (int y = tid; g.use_orient && y < kTile / 4; y += kBruteRows * 32) {
        const int b = min(16, 4 * (n - y * 4));
        cp_async16(&d.c[y * 4], g.col_c + j0 + (b > 0 ? y * 4 : 0), max(b, 0));
        if (g.use_orient == 1)
          cp_async16(&d.s[y * 4], g.col_s + j0 + (b > 0 ? y * 4 : 0), max(b, 0));
      }
      cp_async_commit();
    };
    if (n_tiles > 0) stage(0, tiles[0]);
    for (int i = 0; i < n_tiles; ++i) {
      if (i + 1 < n_tiles) {
        stage(i + 1, tiles[(i + 1) & 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const Tile& d = tiles[i & 1];
      const int j0 = i * kTile, n = min(kTile, N - j0);
      if (live) {
        for (int jj = lane; jj < n; jj += 32) {
          bool cand = d.ok[jj] != 0;
          if (cand && g.use_orient) cand = orient_ok(g, rc, rs, d.c[jj], d.s[jj]);
          if (cand) {
            const uint4 a = d.lo[jj], b = d.hi[jj];
            const uint32_t dist = __popc(qd[0] ^ a.x) + __popc(qd[1] ^ a.y) +
                                  __popc(qd[2] ^ a.z) + __popc(qd[3] ^ a.w) +
                                  __popc(qd[4] ^ b.x) + __popc(qd[5] ^ b.y) +
                                  __popc(qd[6] ^ b.z) + __popc(qd[7] ^ b.w);
            push((dist << 16) | (uint32_t)(j0 + jj), k1, k2);
          }
        }
      }
      __syncthreads();  // the next stage overwrites this buffer
    }
  }
  merge(k1, k2, 0xffffffffu, 32);
  if (row < M && lane == 0) write_top2(out + row * 4, k1, k2);
}

// Kernel J: the epipolar-gated top-2 of match_for_triangulation.
//
// Replaces stella_vslam_tpu/match/robust.py match_for_triangulation (:22),
// which the mapping module runs once per neighbour keyframe inside
// module/mapping_kernels.py _triangulate_pair_impl (:58, vmapped over B
// neighbours in _triangulate_multi_impl :145). The TPU form builds the
// [N1,N2] distance, orientation, epipole and epipolar-residual matrices and
// reduces them.
//
// Here two launches. Every target's epipolar plane, normal n = E_12 b2 in
// the new keyframe's frame, contains the epipole e1 (the other keyframe's
// centre seen from the new one), so n lies on the circle of directions
// perpendicular to e1. The band index (epipolar_band_index_kernel, one
// block per neighbour) takes e1 from E_12 (its columns are such normals),
// an orthonormal basis (u, v) of the plane perpendicular to it, and sorts
// the neighbour's targets (bucket_sort) by the angle phi = atan2(n.v, n.u)
// mod pi of their normal, in band.bins bins; a target whose unit normal
// lies more than band.off_plane off that plane, or whose normal is shorter
// than band.min_norm, goes to a bucket every row visits; one that fails
// col_ok to a bucket none visits. The band's constants come from the
// wrapper (match/hamming.py J_BAND_*), which the plain band walk reads too. Then the walk (epipolar_top2_kernel), one warp per
// (neighbour b = blockIdx.y, query row): a row that fails row_ok writes
// the dense output (257, 0, 257, 0) at once. For a row with bearing b1 let
// s = |b1 - (b1.e1) e1| (the sine of its angle to the epipole) and psi its
// angle in (u, v): a unit normal at phi gives n.b1 = s cos(phi - psi), up to
// n's part along e1 (< off_plane) and float rounding, so a target passes
// the residual gate |n.b1| < thr only within the band |phi - psi - pi/2| <
// asin((thr + tau) / s) (mod pi): the margin tau covers the part off the
// plane and the rounding. The warp visits the bins that band meets (one
// more on each side) and the bucket every row visits; a row near the
// epipole (thr + tau >= s) visits every bin. A stereo row
// takes its band too: the residual gate is the same for it, only the
// epipole gate (a per-pair test) differs. Each visited target goes through the gates with the float
// expressions of the dense test, cheapest first: col_ok, the orientation
// (two products, one sum), the epipole gate, the residual clip(dot(E b2,
// b1) / max(|E b2|, 1e-12), -1, 1) against the row's sine with separate
// roundings (no FMA), as the JAX expression and the plain version
// (hamming.epipolar_gate_matrix) round them; the lanes keep a top-2 of
// packed keys (dist << 16 | target), merged by shuffles and seeded with the
// dense walk's keys of targets 0 and 1, so the result is the dense walk's
// bit for bit (ties to the lowest target; hamming.epipolar_band_plain holds
// the band in plain form).
// Bound: operations, on this run's data: per (live row, visited target)
// the flag, per valid pair the orientation and epipole tests, per pair
// past them the residual, per candidate the distance and the top-2 update.
constexpr int kJWarps = 4;  // rows a block of the walk
constexpr float kJPi = 3.14159265358979f;

struct JBand {
  int bins;         // angle bins over [0, pi), at most kMaxCells
  float tau;        // margin on the residual bound of the band
  float off_plane;  // |n.e1| above which a target is visited always
  float min_norm;   // |E b2| below which a target is visited always
};

struct JRows {
  const uint32_t* q;          // [N1, 8]
  const float *c, *s, *bear;  // [N1], [N1], [N1, 3]
  const float* thr;           // [N1]
  const uint8_t *ok, *stereo; // [N1]
};

struct JCols {
  const uint32_t* t;          // [B, N2, 8]
  const float *c, *s, *epl;   // [B, N2], [B, N2], [B, N2, 3]
  const float* nrm;           // [B, N2]
  const uint8_t *ok, *near;   // [B, N2]
};

// e1 and the basis (u, v) of the plane perpendicular to it, from E [9]
// (row-major, E b2 = the normal in the new keyframe's frame): e1 is the
// longest cross product of two columns of E, normalised (in double).
__device__ void epipole_basis(const float* E, float* out) {
  double col[3][3], best[3] = {0.0, 0.0, 0.0}, best_n = -1.0;
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 3; ++i) col[k][i] = E[3 * i + k];
  for (int a = 0; a < 3; ++a) {
    const int b = (a + 1) % 3;
    const double x[3] = {col[a][1] * col[b][2] - col[a][2] * col[b][1],
                         col[a][2] * col[b][0] - col[a][0] * col[b][2],
                         col[a][0] * col[b][1] - col[a][1] * col[b][0]};
    const double n = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
    if (n > best_n) {
      best_n = n;
      for (int i = 0; i < 3; ++i) best[i] = x[i];
    }
  }
  const double inv = best_n > 0.0 ? 1.0 / sqrt(best_n) : 0.0;
  double e[3] = {best[0] * inv, best[1] * inv, best[2] * inv};
  if (best_n <= 0.0) e[2] = 1.0;
  // u: e1 x the axis e1 is least along, normalised; v = e1 x u
  int ax = 0;
  for (int i = 1; i < 3; ++i)
    if (fabs(e[i]) < fabs(e[ax])) ax = i;
  double a[3] = {0.0, 0.0, 0.0};
  a[ax] = 1.0;
  double u[3] = {e[1] * a[2] - e[2] * a[1], e[2] * a[0] - e[0] * a[2], e[0] * a[1] - e[1] * a[0]};
  const double un = 1.0 / sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
  for (int i = 0; i < 3; ++i) u[i] *= un;
  const double v[3] = {e[1] * u[2] - e[2] * u[1], e[2] * u[0] - e[0] * u[2],
                       e[0] * u[1] - e[1] * u[0]};
  for (int i = 0; i < 3; ++i) {
    out[i] = (float)e[i];
    out[3 + i] = (float)u[i];
    out[6 + i] = (float)v[i];
  }
}

// the band index of neighbour b = blockIdx.x: basis [B, 9] (e1, u, v),
// start [B, bins + 3], order [B, N2]
__global__ void __launch_bounds__(kIndexThreads)
epipolar_band_index_kernel(int N2, const float* __restrict__ E, JCols C, JBand band,
                           float* __restrict__ basis, int* __restrict__ start,
                           int* __restrict__ order) {
  __shared__ float bs[9];
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    epipole_basis(E + 9 * b, bs);
    for (int i = 0; i < 9; ++i) basis[9 * b + i] = bs[i];
  }
  __syncthreads();
  const size_t cb = (size_t)b * N2;
  const int nb = band.bins;
  const float inv_bin = (float)nb / kJPi;
  const auto bucket = [&](int j) {
    if (C.ok[cb + j] == 0) return nb + 1;
    const float nrm = C.nrm[cb + j];
    const float* e = C.epl + 3 * (cb + j);
    const float n0 = e[0] / nrm, n1 = e[1] / nrm, n2 = e[2] / nrm;
    const float off = n0 * bs[0] + n1 * bs[1] + n2 * bs[2];
    if (!(nrm >= band.min_norm) || !(fabsf(off) <= band.off_plane)) return nb;
    float phi = atan2f(n0 * bs[6] + n1 * bs[7] + n2 * bs[8], n0 * bs[3] + n1 * bs[4] + n2 * bs[5]);
    if (phi < 0.f) phi += kJPi;
    return min(nb - 1, max(0, (int)(phi * inv_bin)));
  };
  bucket_sort(N2, nb + 2, bucket, start + (size_t)b * (nb + 3), order + cb);
}

__global__ void __launch_bounds__(kJWarps * 32)
epipolar_top2_kernel(int N1, int N2, JRows R, JCols C, JBand band,
                     const float* __restrict__ basis, const int* __restrict__ start,
                     const int* __restrict__ order, float cos_thr, int* __restrict__ out) {
  const int row = blockIdx.x * kJWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (row >= N1) return;
  int* o = out + ((size_t)b * N1 + row) * 4;
  if (R.ok[row] == 0) {  // the dense output of a row with no candidate
    if (lane == 0) {
      o[0] = 257; o[1] = 0; o[2] = 257; o[3] = 0;
    }
    return;
  }
  uint32_t qd[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) qd[w] = R.q[row * 8 + w];
  const float rc = R.c[row], rs = R.s[row], thr = R.thr[row];
  const float bx = R.bear[3 * row], by = R.bear[3 * row + 1], bz = R.bear[3 * row + 2];
  const bool mono = R.stereo[row] == 0;
  uint32_t k1, k2;
  seeds(N2, k1, k2);
  if (lane != 0) k1 = k2 = kNone;
  const size_t cb = (size_t)b * N2;
  const int nb = band.bins;
  const int* st = start + (size_t)b * (nb + 3);
  const int* ord = order + cb;
  const auto visit = [&](int k0, int k_end) {
    for (int k = k0 + lane; k < k_end; k += 32) {
      const int j = ord[k];
      const uint8_t near = C.near[cb + j];
      bool cand = __fadd_rn(__fmul_rn(rc, C.c[cb + j]), __fmul_rn(rs, C.s[cb + j])) >= cos_thr &&
                  !(near != 0 && mono);
      if (cand) {
        const float* e = C.epl + 3 * (cb + j);
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(e[0], bx), __fmul_rn(e[1], by)),
                                    __fmul_rn(e[2], bz));
        const float c = fminf(fmaxf(__fdiv_rn(dot, C.nrm[cb + j]), -1.f), 1.f);
        cand = fabsf(c) < thr;
      }
      if (cand) {
        const uint4* td = reinterpret_cast<const uint4*>(C.t + (cb + j) * 8);
        const uint4 lo = __ldg(td), hi = __ldg(td + 1);
        const uint32_t d = __popc(qd[0] ^ lo.x) + __popc(qd[1] ^ lo.y) + __popc(qd[2] ^ lo.z) +
                           __popc(qd[3] ^ lo.w) + __popc(qd[4] ^ hi.x) + __popc(qd[5] ^ hi.y) +
                           __popc(qd[6] ^ hi.z) + __popc(qd[7] ^ hi.w);
        push((d << 16) | (uint32_t)j, k1, k2);
      }
    }
  };
  // the band of bins this row's candidates can lie in
  const float* bs = basis + 9 * b;
  const float wu = bx * bs[3] + by * bs[4] + bz * bs[5];
  const float wv = bx * bs[6] + by * bs[7] + bz * bs[8];
  const float sn = sqrtf(wu * wu + wv * wv);
  const float bound = thr + band.tau;
  int lo = 0, hi = nb - 1;
  if (bound < sn) {
    const float inv_bin = (float)nb / kJPi;
    const float delta = asinf(bound / sn);
    float centre = atan2f(wv, wu) + 0.5f * kJPi;
    centre -= kJPi * floorf(centre / kJPi);
    lo = (int)floorf((centre - delta) * inv_bin) - 1;
    hi = (int)floorf((centre + delta) * inv_bin) + 1;
    if (hi - lo + 1 >= nb) lo = 0, hi = nb - 1;
  }
  if (lo < 0) {
    visit(st[lo + nb], st[nb]);
    visit(st[0], st[hi + 1]);
  } else if (hi >= nb) {
    visit(st[lo], st[nb]);
    visit(st[0], st[hi - nb + 1]);
  } else {
    visit(st[lo], st[hi + 1]);
  }
  visit(st[nb], st[nb + 1]);  // the targets every row visits
  merge(k1, k2, 0xffffffffu, 32);
  if (lane == 0) write_top2(o, k1, k2);
}

}  // namespace

// Kernel J's band index (one block a neighbour): E [B, 3, 3], col_epl
// [B, N2, 3], col_norm [B, N2] floats, col_ok [B, N2] bytes; bins, off_plane
// and min_norm the band's constants; writes basis [B, 9] floats, start
// [B, bins + 3] and order [B, N2] ints.
extern "C" int svt_epipolar_band_index(int B, int N2, const float* E, const float* col_epl,
                                       const float* col_norm, const uint8_t* col_ok, int bins,
                                       float off_plane, float min_norm, float* basis,
                                       int* start, int* order, void* stream) {
  if (N2 < 1 || N2 > 65535 || bins < 1 || bins > kMaxCells) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const JCols C{nullptr, nullptr, nullptr, col_epl, col_norm, col_ok, nullptr};
    epipolar_band_index_kernel<<<B, kIndexThreads, 0, (cudaStream_t)stream>>>(
        N2, E, C, JBand{bins, 0.f, off_plane, min_norm}, basis, start, order);
  }
  return (int)cudaGetLastError();
}

// Kernel J's walk: the gate terms as match/hamming.EpipolarGate holds them,
// each array contiguous (row_bear [N1, 3], col_epl [B, N2, 3]), flags one
// byte each; t [B, N2, 8] 16-byte aligned; the band index (basis, start,
// order) of svt_epipolar_band_index with the same bins; tau the band's
// margin; out [B, N1, 4].
extern "C" int svt_epipolar_top2(int B, int N1, int N2, const uint32_t* q, const float* row_c,
                                 const float* row_s, const float* row_bear,
                                 const float* row_thr, const uint8_t* row_ok,
                                 const uint8_t* row_stereo, const uint32_t* t,
                                 const float* col_c, const float* col_s, const float* col_epl,
                                 const float* col_norm, const uint8_t* col_ok,
                                 const uint8_t* col_near, float cos_thr, int bins, float tau,
                                 const float* basis, const int* start, const int* order,
                                 int* out, void* stream) {
  if (N2 < 1 || N2 > 65535 || bins < 1 || bins > kMaxCells) return (int)cudaErrorInvalidValue;
  if (N1 > 0 && B > 0) {
    const JRows R{q, row_c, row_s, row_bear, row_thr, row_ok, row_stereo};
    const JCols C{t, col_c, col_s, col_epl, col_norm, col_ok, col_near};
    const dim3 grid((N1 + kJWarps - 1) / kJWarps, B);
    epipolar_top2_kernel<<<grid, kJWarps * 32, 0, (cudaStream_t)stream>>>(
        N1, N2, R, C, JBand{bins, tau, 0.f, 0.f}, basis, start, order, cos_thr, out);
  }
  return (int)cudaGetLastError();
}

// The cell indexes of B sets of N targets (svt_cell_index): start
// [B, gx * gy + 2], order [B, N] (cell_index_kernel).
extern "C" int svt_cell_index(int B, int N, const float* u, const float* v, int stride,
                              long long set_stride, float inv_cell, int gx, int gy, int* start,
                              int* order, void* stream) {
  if (gx < 1 || gy < 1 || gx * gy > kMaxCells || N < 0 || N > 65535 || B < 0 || stride < 1)
    return (int)cudaErrorInvalidValue;
  if (B > 0)
    cell_index_kernel<<<B, kIndexThreads, 0, (cudaStream_t)stream>>>(
        N, u, v, stride, set_stride, inv_cell, gx, gy, start, order);
  return (int)cudaGetLastError();
}

// use_window: the window modes on the cell index (start, order, inv_cell,
// gx, gy); otherwise brute force (the target arrays 16-byte aligned)
extern "C" int svt_hamming_top2(int M, int N, const uint32_t* q, const uint32_t* t,
                                const uint8_t* row_ok, const uint8_t* col_ok,
                                int use_window, const float* row_u, const float* row_v,
                                const float* row_xr, const float* row_rad,
                                const int* row_lo, const int* row_hi, const float* col_u,
                                const float* col_v, const float* col_xr,
                                const int* col_level, const int* start, const int* order,
                                float inv_cell, int gx, int gy, int use_orient,
                                const float* row_c, const float* row_s, const float* col_c,
                                const float* col_s, float cos_thr, int* out, void* stream) {
  if (M > 0) {
    const Gates g{row_ok, col_ok, row_u,     row_v, row_xr, row_rad, row_lo, row_hi, col_u,
                  col_v,  col_xr, col_level, use_orient, row_c, row_s, col_c, col_s, cos_thr};
    const cudaStream_t st = (cudaStream_t)stream;
    if (use_window) {
      window_top2_kernel<<<(M + kWindowRows - 1) / kWindowRows, kWindowRows * 32, 0, st>>>(
          M, N, q, t, g, start, order, inv_cell, gx, gy, out);
    } else {
      brute_top2_kernel<<<(M + kBruteRows - 1) / kBruteRows, kBruteRows * 32, 0, st>>>(
          M, N, q, t, g, out);
    }
  }
  return (int)cudaGetLastError();
}
