// Kernel A: FAST-9/16 corner score fused with the two-threshold cell NMS,
// one launch for every level of a batch of pyramids.
//
// Replaces stella_vslam_tpu/feature/orb_extractor.py: fast_score_map (:88)
// and the NMS half of OrbExtractor._process_level (:325-373). The TPU form
// builds the full [H,W] score map from 16 shifted images and reduces a
// packed key (iscore<<12 | row<<6 | col) per cell with two reshaped maxes,
// then turns each cell's key into its slot's (px, py, valid, response).
//
// On Hopper: one grid over every (image, work item) of the flat pyramid
// (feature/orb_extractor.py fast_work_list, built once per extractor). A
// work item is a run of ncells NMS cells of one cell row of one level,
// sized by pixel count (one level-0 cell, or as many small high-level cells
// as hold about as many pixels), so that the 256 threads of a block have
// work on every level. The block stages its tile (the cells and the 3-px
// FAST ring halo) in shared memory with cp.async, then scores its pixels
// from there:
//  - exact early reject: score > t holds if and only if some 9 contiguous
//    ring pixels all have d > t (or all d < -t), min and max being exact.
//    Two neighbouring compass points (ring 0, 4, 8, 12) lie in every 9-arc,
//    so they are tested first, on every pixel; the ~8% that pass go on a
//    list in shared memory, so that the rest of the test runs on whole
//    warps of candidates: the two 16-bit masks d > t and d < -t tested for
//    a circular run of 9 by folding shifted ANDs. t is min_fast_thr: key_hi
//    needs corner_lo, so the reject decides both keys;
//  - only a pixel that passes is scored, with the JAX version's 2-4-8-+1
//    doubling tree, so its score keeps its bits;
//  - each corner's key goes into its cell's two maxima in shared memory;
//    one thread a cell writes the slot's key, px, py, valid and response
//    into [B, N] in the extractor's slot layout, px and py clamped into the
//    level as the JAX version clamps them (:367-372).
// Bound (chip_smoke.py fast_work): the compass test on each of the 913 k
// region pixels at 752x480, 8 levels, and the full test and score (~300
// operations) on the ~8% that pass it, 0.5 us at 67 T/s, against 4.5 MB
// of pyramid read once, 1.35 us at 3.35 TB/s: bytes. The work done is
// mostly 5-17 shared loads and compares a pixel.
//
// Extraction mask (the JAX version's `region & m_l`, :332-337): the
// level-0 mask nearest-resized to the level (jax.image.resize, "nearest":
// per axis the source index floor((i + 0.5) * m / n) as JAX computes it in
// float32, per-level tables concatenated over the levels, built once on
// the host, feature/orb_extractor.py nearest_index), read at the pixel's
// mapped index; a masked-out pixel is no corner.
//
// Bit-exactness: scores are differences and min/max of the same float32
// pixels as the JAX version, thresholds compare the float score, and
// iscore = clamp(rint(score), 0, 1023) (rintf rounds half to even, like
// jnp.round).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCells = 32;  // cells of a work item (fast_work_list's MAX_CELLS)
constexpr int kLevelInts = 8;  // a level table row (fast_pyramid_tables)

__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}

// a circular run of 9 set bits in a 16-bit mask
__device__ __forceinline__ bool run9(uint32_t m) {
  const uint32_t m2 = m | (m << 16);
  uint32_t r = m2 & (m2 >> 1);  // bit k: k..k+1 set
  r &= r >> 2;                  // k..k+3
  r &= r >> 4;                  // k..k+7
  r &= m2 >> 8;                 // k..k+8
  return (r & 0xffffu) != 0;
}

// two neighbouring compass points of a 4-bit mask (ring 0, 4, 8, 12)
__device__ __forceinline__ bool adjacent(uint32_t m) {
  return (m & ((m >> 1) | (m << 3)) & 15u) != 0;
}

// the largest 9-arc minimum of d: the JAX version's doubling tree
__device__ __forceinline__ float arc_min_max(const float* d) {
  float w2[16], w4[16], w8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w2[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) w4[k] = fminf(w2[k], w2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) w8[k] = fminf(w4[k], w4[(k + 4) & 15]);
  float out = fminf(w8[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) out = fmaxf(out, fminf(w8[k], d[(k + 8) & 15]));
  return out;
}

// whether two neighbouring compass points of the tile pixel at c (tile row
// width tw) are both brighter than c + t or both darker than c - t: true
// for every corner at t
__device__ __forceinline__ bool compass_pass(const float* c, int tw, float t) {
  const float v = c[0];
  const float n0 = c[-3 * tw] - v, n4 = c[3] - v, n8 = c[3 * tw] - v, n12 = c[-3] - v;
  const uint32_t bq = (n0 > t) | ((n4 > t) << 1) | ((n8 > t) << 2) | ((n12 > t) << 3);
  const uint32_t dq = (n0 < -t) | ((n4 < -t) << 1) | ((n8 < -t) << 2) | ((n12 < -t) << 3);
  return adjacent(bq) || adjacent(dq);
}

// FAST score of the tile pixel at c when it is above t, else -1 (the pixel
// is no corner at t)
__device__ __forceinline__ float fast_score_above(const float* c, int tw, float t) {
  const float v = c[0];
  float d[16];
  uint32_t mb = 0, md = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    d[k] = c[kRingDy[k] * tw + kRingDx[k]] - v;
    mb |= (uint32_t)(d[k] > t) << k;
    md |= (uint32_t)(d[k] < -t) << k;
  }
  if (!run9(mb) && !run9(md)) return -1.f;
  float s = arc_min_max(d);  // bright arcs
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = -d[k];
  s = fmaxf(s, arc_min_max(d));  // dark arcs
  return s > t ? s : -1.f;
}

__global__ void __launch_bounds__(kThreads)
fast_pyramid_kernel(const float* __restrict__ pyr, long long pyr_stride,
                    const int* __restrict__ level_tab, const int4* __restrict__ work,
                    int border, int num_slots, float ini_thr, float min_thr,
                    const uint8_t* __restrict__ mask, int mask_w,
                    const int* __restrict__ mask_rows, const int* __restrict__ mask_cols,
                    int* __restrict__ out_key, int* __restrict__ out_px,
                    int* __restrict__ out_py, uint8_t* __restrict__ out_valid,
                    float* __restrict__ out_resp) {
  extern __shared__ float tile[];  // the tile, then the candidates
  __shared__ int best_hi[kMaxCells], best_lo[kMaxCells];
  __shared__ int n_cand;
  const int4 w = work[blockIdx.x];  // level, cell row, first cell column, cells
  const int* lt = level_tab + kLevelInts * w.x;
  const int H = lt[0], W = lt[1], cs = lt[2], Gx = lt[3];
  const float* img = pyr + blockIdx.y * pyr_stride + lt[4];
  const int y0 = border + w.y * cs, x0 = border + w.z * cs, nc = w.w;
  const int tw = nc * cs + 6, th = cs + 6;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the tile from (y0 - 3, x0 - 3), a warp a row; border >= 3, so it starts
  // inside the image; pixels past its far edges are zero and never read by
  // a scored pixel (whose ring lies in the image)
  for (int ty = warp; ty < th; ty += kWarps) {
    const int y = y0 - 3 + ty;
    for (int tx = lane; tx < tw; tx += 32) {
      const int x = x0 - 3 + tx;
      const bool in = y < H && x < W;
      cp_async4(&tile[ty * tw + tx], img + (in ? y * W + x : 0), in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (threadIdx.x < kMaxCells) {
    best_hi[threadIdx.x] = -1;
    best_lo[threadIdx.x] = -1;
  }
  if (threadIdx.x == 0) n_cand = 0;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int* mrow = mask != nullptr ? mask_rows + lt[6] : nullptr;
  const int* mcol = mask != nullptr ? mask_cols + lt[7] : nullptr;
  // pass 1 over the pixels of the border region, a warp a row, a lane a
  // column: the compass test, and the pixels that pass it appended to a
  // list (a warp's in one atomic); pass 2 over the list, a thread a pixel:
  // the full test and the score, so that a warp's lanes take the same path
  uint32_t* cand = reinterpret_cast<uint32_t*>(tile + th * tw);
  const int rows = min(cs, H - border - y0), cols = min(nc * cs, W - border - x0);
  for (int ry = warp; ry < rows; ry += kWarps) {
    for (int u0 = 0; u0 < cols; u0 += 32) {  // warp-uniform: the lanes converge
      const int u = u0 + lane;
      bool pass = false;
      if (u < cols) {
        const int y = y0 + ry, x = x0 + u;
        pass = (mask == nullptr || mask[(size_t)mrow[y] * mask_w + mcol[x]] != 0)
               && compass_pass(&tile[(ry + 3) * tw + u + 3], tw, min_thr);
      }
      const unsigned b = __ballot_sync(0xffffffffu, pass);
      if (b != 0) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&n_cand, __popc(b));
        at = __shfl_sync(0xffffffffu, at, 0) + __popc(b & ((1u << lane) - 1));
        if (pass) cand[at] = ((uint32_t)ry << 16) | (uint32_t)u;
      }
    }
  }
  __syncthreads();
  // the cell of column u is floor((u + 0.5) / cs), exact in float32 for
  // these sizes (u < 2048, cs <= 63: at least 0.5 / 63 from an integer);
  // the maxima do not depend on the list's order
  const float inv_cs = 1.f / (float)cs;
  for (int i = threadIdx.x; i < n_cand; i += kThreads) {
    const int ry = (int)(cand[i] >> 16), u = (int)(cand[i] & 0xffffu);
    const float s = fast_score_above(&tile[(ry + 3) * tw + u + 3], tw, min_thr);
    if (s >= 0.f) {
      const int cell = (int)(((float)u + 0.5f) * inv_cs);
      const int iscore = (int)fminf(fmaxf(rintf(s), 0.f), 1023.f);
      const int key = (iscore << 12) | (ry << 6) | (u - cell * cs);
      atomicMax(&best_lo[cell], key);
      if (s > ini_thr) atomicMax(&best_hi[cell], key);
    }
  }
  __syncthreads();
  if (threadIdx.x < nc) {
    const int c = threadIdx.x, cx = w.z + c;
    const int key = best_hi[c] >= 0 ? best_hi[c] : best_lo[c];
    const size_t o = (size_t)blockIdx.y * num_slots + lt[5] + w.y * Gx + cx;
    out_key[o] = key;
    out_py[o] = min(max(border + w.y * cs + ((key >> 6) & 63), 0), H - 1);
    out_px[o] = min(max(border + cx * cs + (key & 63), 0), W - 1);
    out_valid[o] = key >= 0 ? 1 : 0;
    out_resp[o] = key >= 0 ? (float)(key >> 12) : 0.f;
  }
}

}  // namespace

// pyr: B flat pyramids, pyr_stride floats apart; level_tab: [L, 8] int32
// (H, W, cell size, Gx, the level's offset in a pyramid, its first slot, its
// offsets in mask_rows and mask_cols); work: [nwork] (level, cell row, first
// cell column, cells); smem_words: the largest work item's tile and
// pixels (fast_pyramid_tables); outputs
// [B, num_slots]. mask: null, or the level-0 mask [*, mask_w] (0 = excluded)
// that every image shares, read at (mask_rows[y], mask_cols[x]) of a level's
// pixel (y, x) through the level's offsets.
extern "C" int svt_fast_pyramid(int B, const float* pyr, long long pyr_stride,
                                const int* level_tab, const int* work, int nwork,
                                int smem_words, int border, int num_slots, float ini_thr,
                                float min_thr, const uint8_t* mask, int mask_w,
                                const int* mask_rows, const int* mask_cols, int* out_key,
                                int* out_px, int* out_py, uint8_t* out_valid,
                                float* out_resp, void* stream) {
  const size_t smem = sizeof(float) * (size_t)smem_words;
  if (B < 1 || nwork < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  fast_pyramid_kernel<<<dim3(nwork, B), kThreads, smem, (cudaStream_t)stream>>>(
      pyr, pyr_stride, level_tab, reinterpret_cast<const int4*>(work), border, num_slots,
      ini_thr, min_thr, mask, mask_w, mask_rows, mask_cols, out_key, out_px, out_py,
      out_valid, out_resp);
  return (int)cudaGetLastError();
}
