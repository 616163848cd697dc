// Kernel S (K3): the image pyramid, every level of a batch of images in one
// launch.
//
// Replaces stella_vslam_tpu/feature/orb_extractor.py: _resize_matrices
// (:118) and `img = (R @ img) @ C.T` in _extract_impl (:307). The TPU form
// is two dense matmuls per level ([h_out, h_in] and [w_out, w_in] weight
// matrices with at most two non-zero entries per row), because the MXU
// makes a dense product cheaper than a gather there.
//
// Arithmetic: each pixel of level l is formed from its two source rows and
// two source columns of level l-1 (the non-zero entries of its rows of R
// and C, given as taps (j0, j1, w0, w1); a row with one non-zero entry has
// j1 = j0 and w1 = 0): the row pass at each source column is
// tap2(rw0, a, rw1, b) = fma(rw1, b, rw0 * a), the product of the lower
// tap, then the upper tap added with one fused multiply-add, and the
// column pass forms the pixel from those two values the same way. That is
// the order and rounding of a dot product that walks the source index
// upwards with fused adds, and not what every matmul gives: torch's CPU
// matmul pyramid differs from it in 188 and 136 of the 756,407 pixels of
// levels 1-7 of two 752x480 frames (tests/test_torch_pyramid_plan.py; 324
// of 1,512,814 for the pair on the card's host, chip_smoke.py), JAX's
// jitted CPU matmul in ~20%, cuBLAS (which sums each run of 8 source
// indices apart) in ~6%, each by a few ulps. Its plain twin is
// orb_extractor.resize_level_taps_plain (the FMA emulated in float64).
//
// On Hopper: the levels form one dependent chain, so the whole pyramid is
// one launch, one block per (tile, image) of 32 x R threads. The host's
// plan (orb_extractor.pyramid_plan, the tile and R chosen by a cost model
// of measured times) cuts the coarsest level into tiles and gives each
// tile, on each level, an owned rectangle (the owned rectangles partition
// the level; a boundary is carried one level down through the first tap of
// the boundary's row or column) and a computed rectangle (it holds the
// owned one and both taps of every row and column of the computed
// rectangle one level up). Rows and columns are planned apart, so a
// rectangle is a row interval times a column interval. The block turns
// its rows' and columns' taps of every level into offsets within its
// buffers (shared memory), reads level 0's computed rectangle from the
// input in the input's dtype (u8 or f32) into shared memory and writes its
// owned pixels as f32, then computes levels 1..L-1 over their computed
// rectangles in two ping-pong buffers (even levels in one, odd in the
// other) and writes each level's owned pixels into the flat pyramid
// buffer [B, sum H*W] that kernels A and B read. A pixel computed by two
// blocks (the halos) comes from the same inputs by the same expression, so
// it carries the same bits in both: the pyramid equals
// resize_level_taps_plain level by level.
// Bound: bytes — level 0 read once in its dtype, every level written once
// as f32 (the halos' reads hit L2; the intermediate levels stay on chip).
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kTx = 32;  // threads a row of the block; its rows are a launch parameter
constexpr int kMaxThreads = 1024;
constexpr int kMaxLevels = 16;
// H, W, offset in a pyramid row, first row tap and first column tap of the level
constexpr int kLevelInts = 5;
constexpr int kPlanInts = 4;  // owned lo, hi, computed lo, hi (one axis, one level)

__device__ __forceinline__ float tap2(float w0, float a0, float w1, float a1) {
  return __fmaf_rn(w1, a1, __fmul_rn(w0, a0));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
pyramid_kernel(int L, const T* __restrict__ in, long long in_stride, float* __restrict__ out,
               long long out_stride, const int* __restrict__ level_tab,
               const int* __restrict__ row_plan, const int* __restrict__ col_plan,
               const int2* __restrict__ row_j, const float2* __restrict__ row_w,
               const int2* __restrict__ col_j, const float2* __restrict__ col_w, int odd_at,
               int buf_words, int row_taps) {
  extern __shared__ float smem[];
  __shared__ int s_tab[kMaxLevels * kLevelInts];
  __shared__ int s_rp[kMaxLevels * kPlanInts], s_cp[kMaxLevels * kPlanInts];
  // each level's first row (column) tap in the block's tap lists
  __shared__ int s_roff[kMaxLevels + 1], s_coff[kMaxLevels + 1];
  // the taps of the block's computed rows (columns) of levels 1..L-1: the
  // two source offsets in the level above's buffer, and the two weights
  int2* s_rj = reinterpret_cast<int2*>(smem + buf_words);
  float2* s_rw = reinterpret_cast<float2*>(s_rj + row_taps);
  int2* s_cj = reinterpret_cast<int2*>(s_rw + row_taps);
  float2* s_cw = nullptr;  // set below, after the column count is known
  const int tid = threadIdx.y * kTx + threadIdx.x, nthreads = kTx * blockDim.y;
  const int ty = blockDim.y;
  for (int i = tid; i < L * kLevelInts; i += nthreads) s_tab[i] = level_tab[i];
  for (int i = tid; i < L * kPlanInts; i += nthreads) {
    s_rp[i] = row_plan[(size_t)blockIdx.y * L * kPlanInts + i];
    s_cp[i] = col_plan[(size_t)blockIdx.x * L * kPlanInts + i];
  }
  __syncthreads();
  if (tid == 0) {
    int r = 0, c = 0;
    for (int l = 0; l < L; ++l) {
      s_roff[l] = r;
      s_coff[l] = c;
      if (l) {
        r += s_rp[l * kPlanInts + 3] - s_rp[l * kPlanInts + 2];
        c += s_cp[l * kPlanInts + 3] - s_cp[l * kPlanInts + 2];
      }
    }
    s_roff[L] = r;
    s_coff[L] = c;
  }
  __syncthreads();
  s_cw = reinterpret_cast<float2*>(s_cj + s_coff[L]);
  // ---- the taps of every level, as offsets into the block's buffers ----
  for (int e = tid; e < s_roff[L] + s_coff[L]; e += nthreads) {
    const bool is_row = e < s_roff[L];
    const int f = is_row ? e : e - s_roff[L];
    const int* off = is_row ? s_roff : s_coff;
    int l = 1;
    while (off[l + 1] <= f) ++l;
    const int* pl = (is_row ? s_rp : s_cp) + l * kPlanInts;
    const int* pp = (is_row ? s_rp : s_cp) + (l - 1) * kPlanInts;
    const int i = pl[2] + (f - off[l]);  // the level's row (column)
    const int first = s_tab[l * kLevelInts + (is_row ? 3 : 4)];
    const int2 j = (is_row ? row_j : col_j)[first + i];
    const float2 w = (is_row ? row_w : col_w)[first + i];
    if (is_row) {  // row offsets in the level above's buffer, its rows pw wide
      const int pw = s_cp[(l - 1) * kPlanInts + 3] - s_cp[(l - 1) * kPlanInts + 2];
      s_rj[f] = make_int2((j.x - pp[2]) * pw, (j.y - pp[2]) * pw);
      s_rw[f] = w;
    } else {
      s_cj[f] = make_int2(j.x - pp[2], j.y - pp[2]);
      s_cw[f] = w;
    }
  }
  const T* src = in + blockIdx.z * in_stride;
  float* dst = out + blockIdx.z * out_stride;
  // ---- level 0: stage the computed rectangle, write the owned pixels ----
  {
    const int W = s_tab[1];
    const int oy0 = s_rp[0], oy1 = s_rp[1], cy0 = s_rp[2], cy1 = s_rp[3];
    const int ox0 = s_cp[0], ox1 = s_cp[1], cx0 = s_cp[2], cx1 = s_cp[3];
    const int cw = cx1 - cx0;
    for (int i = cy0 + threadIdx.y; i < cy1; i += ty) {
      const bool own_row = i >= oy0 && i < oy1;
#pragma unroll 4
      for (int k = cx0 + threadIdx.x; k < cx1; k += kTx) {
        const float v = (float)src[(size_t)i * W + k];
        smem[(i - cy0) * cw + (k - cx0)] = v;
        if (own_row && k >= ox0 && k < ox1) dst[(size_t)i * W + k] = v;
      }
    }
  }
  __syncthreads();
  // ---- levels 1..L-1 from the level above, in shared memory ----
  for (int l = 1; l < L; ++l) {
    const float* prev = smem + ((l - 1) & 1) * odd_at;
    float* cur = smem + (l & 1) * odd_at;
    const int W = s_tab[l * kLevelInts + 1], off = s_tab[l * kLevelInts + 2];
    const int* rp = s_rp + l * kPlanInts;
    const int* cp = s_cp + l * kPlanInts;
    const int cw = cp[3] - cp[2];
    const int2* rj = s_rj + s_roff[l] - rp[2];
    const float2* rw = s_rw + s_roff[l] - rp[2];
    const int2* cj = s_cj + s_coff[l] - cp[2];
    const float2* cwt = s_cw + s_coff[l] - cp[2];
    for (int i = rp[2] + threadIdx.y; i < rp[3]; i += ty) {
      const int2 r = rj[i];
      const float2 w = rw[i];
      const bool own_row = i >= rp[0] && i < rp[1];
      float* crow = cur + (i - rp[2]) * cw - cp[2];
      float* orow = dst + off + (size_t)i * W;
#pragma unroll 4
      for (int k = cp[2] + threadIdx.x; k < cp[3]; k += kTx) {
        const int2 c = cj[k];
        const float2 u = cwt[k];
        const float t0 = tap2(w.x, prev[r.x + c.x], w.y, prev[r.y + c.x]);
        const float t1 = tap2(w.x, prev[r.x + c.y], w.y, prev[r.y + c.y]);
        const float v = tap2(u.x, t0, u.y, t1);
        crow[k] = v;
        if (own_row && k >= cp[0] && k < cp[1]) orow[k] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// B images, each `in_stride` elements apart (u8 when in_u8, else f32), each
// contiguous [H0, W0]; out: B flat pyramids, out_stride floats apart.
// level_tab [L, 5]: H, W, the level's offset in a pyramid row, and its
// first entry in row_j / row_w and in col_j / col_w (the taps of levels
// 1..L-1 concatenated, one (j0, j1) and one (w0, w1) per row or column).
// row_plan [nty, L, 4], col_plan [ntx, L, 4]: owned lo, hi, computed lo, hi.
// Shared memory: the even levels' buffer (odd_at floats), the odd levels'
// (buf_words - odd_at floats), then row_taps row taps and col_taps column
// taps of 16 bytes each (the most a tile's computed rectangles hold over
// levels 1..L-1). A block is 32 x block_rows threads.
extern "C" int svt_resize_pyramid(int B, int L, int in_u8, const void* in, long long in_stride,
                                  float* out, long long out_stride, const int* level_tab,
                                  const int* row_plan, int nty, const int* col_plan, int ntx,
                                  const int* row_j, const float* row_w, const int* col_j,
                                  const float* col_w, int odd_at, int buf_words, int row_taps,
                                  int col_taps, int block_rows, void* stream) {
  if (L < 1 || L > kMaxLevels || odd_at < 1 || buf_words <= odd_at || buf_words % 2 ||
      row_taps < 0 || col_taps < 0 || block_rows < 1 || block_rows * kTx > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || nty <= 0 || ntx <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)buf_words * sizeof(float) + 16 * (size_t)(row_taps + col_taps);
  const dim3 grid(ntx, nty, B), block(kTx, block_rows);
  const cudaStream_t st = (cudaStream_t)stream;
  auto kernel = in_u8 ? (const void*)pyramid_kernel<uint8_t> : (const void*)pyramid_kernel<float>;
  const cudaError_t e = svt::reserve_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (in_u8) {
    pyramid_kernel<uint8_t><<<grid, block, smem, st>>>(
        L, (const uint8_t*)in, in_stride, out, out_stride, level_tab, row_plan, col_plan,
        (const int2*)row_j, (const float2*)row_w, (const int2*)col_j, (const float2*)col_w,
        odd_at, buf_words, row_taps);
  } else {
    pyramid_kernel<float><<<grid, block, smem, st>>>(
        L, (const float*)in, in_stride, out, out_stride, level_tab, row_plan, col_plan,
        (const int2*)row_j, (const float2*)row_w, (const int2*)col_j, (const float2*)col_w,
        odd_at, buf_words, row_taps);
  }
  return (int)cudaGetLastError();
}
