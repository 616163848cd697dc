// Kernel T (K19): rectified stereo keypoint matching.
//
// Replaces stella_vslam_tpu/match/stereo.py: stereo_match (:32). The TPU
// form builds the [NL, NR] masked Hamming matrix (row band, disparity range,
// level within one, validity), takes min / argmin per row, gathers the best
// right patch with a one-hot bf16 matmul, slides an 11x11 SAD window +-5 px,
// refines by a parabola and filters by twice the masked mean SAD.
//
// On Hopper, one launch, one warp per left keypoint:
//  1. The band walk. The right keypoints lie in the extractor's fixed slot
//     layout: slot (level l, cell row cy, cell column cx) holds a keypoint at
//     level px (border + cx cs + dx, border + cy cs + dy), dx, dy < cs,
//     clamped into the level, times the level's f32 scale. For each level
//     within one of its own, the warp tests every cell row (a lane a row) by
//     the row-band gate on the two ends of the row's y interval, computed
//     with the products and clamps that place a slot, and every cell column
//     by the disparity gate on the ends of its x interval. Float subtraction
//     is monotone, so a cell whose ends fail a gate holds no pair that
//     passes it: the walk visits a superset of the pairs the dense gate
//     admits (~40 slots a valid keypoint on a rendered 752x480 pair instead
//     of 2872), one rectangle of cells a level, the (at most three)
//     rectangles walked as one run of pairs spread over the lanes, the gate's
//     inputs of a pair loaded in one round. Each visited pair goes through the
//     JAX version's gates in its float32 arithmetic, and the warp keeps the
//     packed key (distance << 16 | index): its minimum is the lowest index
//     among the smallest distances whatever the visiting order, as
//     jnp.min / jnp.argmin give; an empty row gives 257 and index 0.
//  2. A matched row (distance < 75) stages its left strip and the matched
//     right strip (11x21 blurred bytes each, kernel B's) in shared memory
//     with coalesced loads; the 121 (shift, row) sums of absolute
//     differences spread over the warp's lanes, lane d adds shift d - 5's
//     rows, and lane 0 takes the argmin (lowest shift on ties), the parabola
//     and the disparity in the JAX version's order of float32 operations.
//  3. The correlation filter, in the same launch: each block adds its
//     matched rows' integer SAD sum and count to two device counters, and
//     the last block to finish (a ticket counter) forms the mean as float32
//     / float32 (the JAX version's float32 sum is exact while it stays under
//     2^24), applies the 2x filter to every row (four rows a thread at a
//     time, their loads in flight together), writes x_right and depth (-1
//     where unmatched) and sets the three counters back to 0 for the next
//     launch. The counters belong to one stream (the wrapper keeps them).
// Bound: operations on the visited pairs (~6 compares each, 8 XOR + 8 popc
// where the gates pass) and 1331 integer operations per matched row; the
// inputs are read about once (the right keypoints stay in L2).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStripH = 11, kStripW = 21, kStripArea = kStripH * kStripW;
constexpr int kStripPad = 240;  // a strip's bytes in shared memory
constexpr int kWin = 5, kSlide = 5, kShifts = 2 * kSlide + 1;
constexpr int kTasks = kShifts * kStripH;  // (shift, row) sums of a matched row
constexpr int kWarps = 8;
constexpr int kTailRows = 4;  // rows a thread of the last block files at once
constexpr int kMaxLevels = 32;
constexpr int kTabInts = 8;  // FastPyramid.level_tab: H, W, cs, Gx, level_off, slot_off, ...
constexpr unsigned kEmptyKey = 257u << 16;
constexpr unsigned kFull = 0xffffffffu;

// a level's visited cells: the first slot of the rectangle, the level's
// grid width, the rectangle's width in cells, and the running pair count at
// its end
struct Rect {
  int first, gx, nc, end;
};

// the counters the last block reads: the SAD sum, the matched count, the ticket
struct Counters {
  unsigned long long sum;
  unsigned int count;
  unsigned int done;
};

// [first, last] of the ballots' set positions over `n` positions, lane p
// testing position base + p; first > last when none is set
template <typename Test>
__device__ __forceinline__ void ballot_range(int n, int lane, Test test, int& first, int& last) {
  first = n;
  last = -1;
  for (int base = 0; base < n; base += 32) {
    const int q = base + lane;
    const unsigned b = __ballot_sync(kFull, q < n && test(q));
    if (b) {
      first = min(first, base + __ffs(b) - 1);
      last = max(last, base + 31 - __clz(b));
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
stereo_match_kernel(int NL, int NR, int L, int border, const int* __restrict__ level_tab,
                    const float* __restrict__ level_scale, const float* __restrict__ l_xy,
                    const int* __restrict__ l_level, const uint4* __restrict__ l_desc,
                    const uint8_t* __restrict__ l_valid, const uint8_t* __restrict__ l_strip,
                    const float2* __restrict__ r_xy, const int* __restrict__ r_level,
                    const uint4* __restrict__ r_desc, const uint8_t* __restrict__ r_valid,
                    const uint8_t* __restrict__ r_strip, const float* __restrict__ scale_factors,
                    float max_disp, float focal_x_baseline, int* best_sad, float* disp,
                    Counters* ctr, float* __restrict__ x_right_out,
                    float* __restrict__ depth_out) {
  // per level: H, W, cs, Gx, Gy, first slot
  __shared__ int s_tab[kMaxLevels][6];
  __shared__ float s_scale[kMaxLevels], s_band[kMaxLevels];
  __shared__ __align__(16) uint8_t s_strip[kWarps][2][kStripPad];
  __shared__ int s_part[kWarps][kTasks];
  __shared__ unsigned long long s_sum;
  __shared__ unsigned int s_cnt;
  __shared__ bool s_last;
  if (threadIdx.x < L) {
    const int* t = level_tab + threadIdx.x * kTabInts;
    const int next = threadIdx.x + 1 < L ? t[kTabInts + 5] : NR;
    s_tab[threadIdx.x][0] = t[0];
    s_tab[threadIdx.x][1] = t[1];
    s_tab[threadIdx.x][2] = t[2];
    s_tab[threadIdx.x][3] = t[3];
    s_tab[threadIdx.x][4] = (next - t[5]) / t[3];
    s_tab[threadIdx.x][5] = t[5];
    s_scale[threadIdx.x] = level_scale[threadIdx.x];
    s_band[threadIdx.x] = 2.0f * scale_factors[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    s_sum = 0;
    s_cnt = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  if (i < NL) {
    const bool lv = l_valid[i] != 0;
    const float lx = l_xy[2 * i], ly = l_xy[2 * i + 1];
    const int ll = l_level[i];
    const uint4 la = l_desc[2 * i], lb = l_desc[2 * i + 1];
    unsigned key = kEmptyKey;
    // the cell rectangles of the levels within one of ll, then one walk
    // over their slots: a lane's pairs follow one another across levels
    Rect rect[3];
    int total = 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int rl = ll - 1 + q;
      rect[q] = Rect{0, 1, 1, total};  // none
      if (!lv || rl < 0 || rl >= L) continue;
      const int H = s_tab[rl][0], W = s_tab[rl][1], cs = s_tab[rl][2], Gx = s_tab[rl][3];
      const int Gy = s_tab[rl][4];
      const float s = s_scale[rl], band = s_band[rl];
      int r0, r1, c0, c1;
      // a cell row's y runs from its first pixel row to its last, clamped
      ballot_range(Gy, lane, [&](int cy) {
        const float ylo = __fmul_rn((float)min(border + cy * cs, H - 1), s);
        const float yhi = __fmul_rn((float)min(border + cy * cs + cs - 1, H - 1), s);
        return __fsub_rn(ylo, ly) <= band && __fsub_rn(yhi, ly) >= -band;
      }, r0, r1);
      if (r0 > r1) continue;
      ballot_range(Gx, lane, [&](int cx) {
        const float xlo = __fmul_rn((float)min(border + cx * cs, W - 1), s);
        const float xhi = __fmul_rn((float)min(border + cx * cs + cs - 1, W - 1), s);
        return __fsub_rn(lx, xlo) >= 0.0f && __fsub_rn(lx, xhi) < max_disp;
      }, c0, c1);
      if (c0 > c1) continue;
      const int nc = c1 - c0 + 1;
      total += (r1 - r0 + 1) * nc;
      rect[q] = Rect{s_tab[rl][5] + r0 * Gx + c0, Gx, nc, total};
    }
    for (int k = lane; k < total; k += 32) {
      // the rectangle of pair k, chosen in registers
      const int q = k < rect[0].end ? 0 : k < rect[1].end ? 1 : 2;
      const Rect r = q == 0 ? rect[0] : q == 1 ? rect[1] : rect[2];
      const int kk = k - (q == 0 ? 0 : q == 1 ? rect[0].end : rect[1].end);
      const int j = r.first + (kk / r.nc) * r.gx + kk % r.nc;
      // the gate's inputs in one round of loads
      const bool jv = r_valid[j] != 0;
      const int jl = r_level[j];
      const float2 rxy = r_xy[j];
      if (!jv || abs(ll - jl) > 1) continue;
      const float band = (unsigned)jl < (unsigned)L ? s_band[jl] : 2.0f * scale_factors[jl];
      if (!(fabsf(__fsub_rn(rxy.y, ly)) <= band)) continue;
      const float d = __fsub_rn(lx, rxy.x);
      if (!(d >= 0.0f && d < max_disp)) continue;
      const uint4 ra = r_desc[2 * j], rb = r_desc[2 * j + 1];
      const int dist = __popc(la.x ^ ra.x) + __popc(la.y ^ ra.y) + __popc(la.z ^ ra.z) +
                       __popc(la.w ^ ra.w) + __popc(lb.x ^ rb.x) + __popc(lb.y ^ rb.y) +
                       __popc(lb.z ^ rb.z) + __popc(lb.w ^ rb.w);
      key = min(key, ((unsigned)dist << 16) | (unsigned)j);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(kFull, key, o));
    const int best = (int)(key >> 16), best_idx = (int)(key & 0xffffu);
    const bool matched = lv && best < 75;  // (THR_LOW + THR_HIGH) / 2

    int sad = 0;
    if (matched) {
      uint8_t* sl = s_strip[warp][0];
      uint8_t* sr = s_strip[warp][1];
      const uint8_t* lp = l_strip + (size_t)i * kStripArea;
      const uint8_t* rp = r_strip + (size_t)best_idx * kStripArea;
      for (int b = lane; b < kStripArea; b += 32) {
        sl[b] = lp[b];
        sr[b] = rp[b];
      }
      __syncwarp();
      // task (row r, shift d): the window of the right strip shifted by
      // d - 5 against the left strip's centre window, on row r
      for (int task = lane; task < kTasks; task += 32) {
        const int r = task / kShifts, d = task - r * kShifts;
        const uint8_t* a = sl + r * kStripW + kSlide;
        const uint8_t* c = sr + r * kStripW + d;
        int acc = 0;
#pragma unroll
        for (int x = 0; x < 2 * kWin + 1; ++x) acc += abs((int)a[x] - (int)c[x]);
        s_part[warp][task] = acc;
      }
      __syncwarp();
      if (lane < kShifts)
#pragma unroll
        for (int r = 0; r < kStripH; ++r) sad += s_part[warp][r * kShifts + lane];
    }
    int sads[kShifts];
#pragma unroll
    for (int d = 0; d < kShifts; ++d) sads[d] = __shfl_sync(kFull, sad, d);
    if (lane == 0) {
      int out_sad = -1;  // -1: unmatched
      float out_disp = 0.0f;
      if (matched) {
        int best_d = 0, min_sad = sads[0];
#pragma unroll
        for (int d = 1; d < kShifts; ++d)
          if (sads[d] < min_sad) {
            min_sad = sads[d];
            best_d = d;
          }
        const int ds = min(max(best_d, 1), kShifts - 2);
        const float s_m = (float)sads[ds - 1], s_0 = (float)sads[ds], s_p = (float)sads[ds + 1];
        const float denom = __fsub_rn(__fadd_rn(s_m, s_p), __fmul_rn(2.0f, s_0));
        float frac = fabsf(denom) > 1e-6f
                         ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(s_m, s_p)), denom)
                         : 0.0f;
        frac = fminf(fmaxf(frac, -1.0f), 1.0f);
        const bool at_border = best_d == 0 || best_d == 2 * kSlide;
        const float delta = at_border ? (float)(best_d - kSlide)
                                      : __fadd_rn((float)(ds - kSlide), frac);
        const float x_right = __fadd_rn(r_xy[best_idx].x, delta);
        float disparity = __fsub_rn(lx, x_right);
        if (disparity <= 0.0f) disparity = 0.01f;
        if (disparity > 0.0f && disparity < max_disp) {
          out_sad = min_sad;
          out_disp = disparity;
          atomicAdd(&s_sum, (unsigned long long)min_sad);
          atomicAdd(&s_cnt, 1u);
        }
      }
      best_sad[i] = out_sad;
      disp[i] = out_disp;
      __threadfence();  // the rows before this block's ticket
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_cnt) {
      atomicAdd(&ctr->sum, s_sum);
      atomicAdd(&ctr->count, s_cnt);
    }
    __threadfence();
    s_last = atomicAdd(&ctr->done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every row and both counters are visible
  __threadfence();
  const unsigned long long total = atomicAdd(&ctr->sum, 0ull);
  const int n = (int)atomicAdd(&ctr->count, 0u);
  const float mean = __fdiv_rn((float)total, (float)max(n, 1));
  const float thr = __fmul_rn(2.0f, mean);
  // four rows a thread at a time, their loads in flight together
  for (int r0 = threadIdx.x; r0 < NL; r0 += kTailRows * blockDim.x) {
    int sr[kTailRows];
    float dr[kTailRows], lx[kTailRows];
#pragma unroll
    for (int u = 0; u < kTailRows; ++u) {
      const int r = r0 + u * blockDim.x;
      sr[u] = r < NL ? __ldcg(best_sad + r) : -1;
      dr[u] = r < NL ? __ldcg(disp + r) : 0.0f;
      lx[u] = r < NL ? l_xy[2 * r] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kTailRows; ++u) {
      const int r = r0 + u * blockDim.x;
      if (r >= NL) break;
      const bool keep = sr[u] >= 0 && (float)sr[u] <= thr;
      depth_out[r] = keep ? __fdiv_rn(focal_x_baseline, dr[u]) : -1.0f;
      x_right_out[r] = keep ? __fsub_rn(lx[u], dr[u]) : -1.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    ctr->sum = 0;
    ctr->count = 0;
    ctr->done = 0;
  }
}

}  // namespace

// level_tab [L, 8] int32 (FastPyramid.level_tab), level_scale [L] f32 and
// border place the right keypoints' slots (NR = the layout's slot count);
// scale_factors [>= L] f32. scratch: best_sad [NL] int, disp [NL] float;
// counters: 16 bytes, zero before the first launch on a stream, left zero.
extern "C" int svt_stereo_match(int NL, int NR, int L, int border, const int* level_tab,
                                const float* level_scale, const float* l_xy, const int* l_level,
                                const uint32_t* l_desc, const uint8_t* l_valid,
                                const uint8_t* l_strip, const float* r_xy,
                                const int* r_level, const uint32_t* r_desc,
                                const uint8_t* r_valid, const uint8_t* r_strip,
                                const float* scale_factors, float max_disp,
                                float focal_x_baseline, int* best_sad, float* disp,
                                void* counters, float* x_right_out, float* depth_out,
                                void* stream) {
  if (NL <= 0) return (int)cudaGetLastError();
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  stereo_match_kernel<<<(NL + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      NL, NR, L, border, level_tab, level_scale, l_xy, l_level,
      reinterpret_cast<const uint4*>(l_desc), l_valid, l_strip,
      reinterpret_cast<const float2*>(r_xy), r_level, reinterpret_cast<const uint4*>(r_desc),
      r_valid, r_strip, scale_factors, max_disp, focal_x_baseline, best_sad, disp,
      static_cast<Counters*>(counters), x_right_out, depth_out);
  return (int)cudaGetLastError();
}
