// Kernel C: gated 256-bit Hamming best/second-best search.
//
// Replaces the [M,N] distance matrix of stella_vslam_tpu/match/hamming.py
// (pairwise_hamming :31, best_and_second :96) as the matchers use it:
// match/projection.py match_frame_and_landmarks (:25) and
// match_current_and_last_frames (:99), match/robust.py brute_force_match
// (:92), and the initializer's match/area.py match_in_consistent_area (:19).
// The TPU form is a +/-1 int8 matmul into an [M,N] matrix, masked by [M,N]
// gate tensors, then argmin passes over the rows.
//
// On Hopper: one warp per query row. Each lane walks a strided share of the
// targets, evaluates the gates in registers (search window, level range,
// stereo x_right, target availability, orientation cosine), takes XOR and
// __popc over 8 words, and keeps a lane-local top-2 of the packed key
// (dist << 16 | target); a butterfly shuffle merges the warp's top-2. The
// [M,N] matrix never exists. Bound: 32 bytes of target descriptor plus ~24
// bytes of target gate fields per (row, target) pair, served from L2 (a
// 2872-target frame is ~160 KB); at M=4096 x N=2872 that is ~11.8 M pairs,
// ~0.6 GB of L2 traffic — the next step is staging target tiles in shared
// memory, shared by the block's warps.
//
// Exactness: masked entries take the value 257, and the key order breaks
// ties to the lowest target index, so best, best_idx, second and second_idx
// are those of jnp.min/argmin over the JAX version's masked matrix (with
// second_idx 0 when no second candidate exists, as argmin over an all-257
// row gives). Two orientation gates: mode 1, the tracking matchers' cosine,
// rounded as the JAX expression is (two products, one sum, no FMA); mode 2,
// the area matcher's angle test |atan2(sin d, cos d)| <= thr with
// d = row angle - col angle, evaluated literally with CUDA's accurate
// sinf / cosf / atan2f (no fast-math), which may differ from the host's in
// the last ulp, so a pair within an ulp of the threshold can gate the other
// way.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr uint32_t kNone = 0xffffffffu;

__device__ __forceinline__ void push(uint32_t key, uint32_t& k1, uint32_t& k2) {
  if (key < k1) {
    k2 = k1;
    k1 = key;
  } else if (key < k2) {
    k2 = key;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hamming_top2_kernel(int M, int N, const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ t, const uint8_t* __restrict__ row_ok,
                    const uint8_t* __restrict__ col_ok, int use_window,
                    const float* __restrict__ row_u, const float* __restrict__ row_v,
                    const float* __restrict__ row_xr, const float* __restrict__ row_rad,
                    const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                    const float* __restrict__ col_u, const float* __restrict__ col_v,
                    const float* __restrict__ col_xr, const int* __restrict__ col_level,
                    int use_orient, const float* __restrict__ row_c,
                    const float* __restrict__ row_s, const float* __restrict__ col_c,
                    const float* __restrict__ col_s, float cos_thr,
                    int* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  uint32_t qd[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) qd[w] = q[row * 8 + w];
  const bool rok = row_ok[row] != 0;
  float ru = 0.f, rv = 0.f, rxr = 0.f, rad = 0.f, rc = 0.f, rs = 0.f;
  int lo = 0, hi = 0;
  if (use_window) {
    ru = row_u[row];
    rv = row_v[row];
    rxr = row_xr[row];
    rad = row_rad[row];
    lo = row_lo[row];
    hi = row_hi[row];
  }
  if (use_orient) rc = row_c[row];
  if (use_orient == 1) rs = row_s[row];
  uint32_t k1 = kNone, k2 = kNone;
  for (int j = lane; j < N; j += 32) {
    bool cand = rok && col_ok[j] != 0;
    if (cand && use_window) {
      const float cxr = col_xr[j];
      const int lvl = col_level[j];
      cand = fabsf(col_u[j] - ru) <= rad && fabsf(col_v[j] - rv) <= rad &&
             lvl >= lo && lvl <= hi &&
             (!(cxr > 0.f && rxr > 0.f) || fabsf(rxr - cxr) <= rad);
    }
    if (cand && use_orient == 1)
      cand = __fadd_rn(__fmul_rn(rc, col_c[j]), __fmul_rn(rs, col_s[j])) >= cos_thr;
    if (cand && use_orient == 2) {
      const float d = __fsub_rn(rc, col_c[j]);
      cand = fabsf(atan2f(sinf(d), cosf(d))) <= cos_thr;
    }
    uint32_t dist = 257;
    if (cand) {
      dist = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) dist += __popc(qd[w] ^ t[j * 8 + w]);
    }
    push((dist << 16) | (uint32_t)j, k1, k2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t o1 = __shfl_xor_sync(0xffffffffu, k1, o);
    const uint32_t o2 = __shfl_xor_sync(0xffffffffu, k2, o);
    const uint32_t n1 = min(k1, o1);
    const uint32_t n2 = min(max(k1, o1), min(k2, o2));
    k1 = n1;
    k2 = n2;
  }
  if (lane == 0) {
    const int best = (int)(k1 >> 16), best_idx = (int)(k1 & 0xffffu);
    int second = 257, second_idx = 0;
    if (k2 != kNone && (k2 >> 16) < 257) {
      second = (int)(k2 >> 16);
      second_idx = (int)(k2 & 0xffffu);
    }
    out[row * 4 + 0] = best;
    out[row * 4 + 1] = best_idx;
    out[row * 4 + 2] = second;
    out[row * 4 + 3] = second_idx;
  }
}

// Kernel J: the epipolar-gated top-2 of match_for_triangulation.
//
// Replaces stella_vslam_tpu/match/robust.py match_for_triangulation (:22),
// which the mapping module runs once per neighbour keyframe inside
// module/mapping_kernels.py _triangulate_pair_impl (:58, vmapped over B
// neighbours in _triangulate_multi_impl :145). The TPU form builds the
// [N1,N2] distance, orientation, epipole and epipolar-residual matrices and
// reduces them. Here one warp per (neighbour b = blockIdx.y, query row): the
// lanes stride over the neighbour's N2 targets, test the gates in registers
// and keep a top-2 of packed keys, as kernel C does. The per-target terms
// (E_12 b2, its clamped norm, the near-epipole flag) and the per-row ones
// (cos / sin of the angle, the bearing, sin(0.2 deg x scale factor)) are
// computed once by the wrapper in the order the JAX version computes them,
// so the pair test is the JAX expression: clip(dot(E b2, b1) / max(|E b2|,
// 1e-12), -1, 1), its magnitude below the row's sine, with separate
// roundings (no FMA). Bound: operations, and they depend on the data: a
// row that is not unassociated needs no per-pair work, a pair that fails
// the flags or the orientation needs a few operations, and only the pairs
// past every gate need the ~30 of the Hamming distance and the top-2
// update; the inputs (~0.8 MB for 5 x 2872 targets) stay in L2. The kernel
// tests the cheap gates first so a pair leaves as early as it can, and one
// launch serves all neighbours.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
epipolar_top2_kernel(int N1, int N2, const uint32_t* __restrict__ q,
                     const float* __restrict__ row_f, const uint8_t* __restrict__ row_flag,
                     const uint32_t* __restrict__ t, const float* __restrict__ col_f,
                     const uint8_t* __restrict__ col_flag, float cos_thr,
                     int* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (row >= N1) return;
  uint32_t qd[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) qd[w] = q[row * 8 + w];
  const float* rf = row_f + 6 * row;
  const float rc = rf[0], rs = rf[1], bx = rf[2], by = rf[3], bz = rf[4], thr = rf[5];
  const uint8_t rflag = row_flag[row];
  const bool rok = (rflag & 1) != 0, rstereo = (rflag & 2) != 0;
  const uint32_t* tb = t + (size_t)b * N2 * 8;
  const float* cfb = col_f + (size_t)b * N2 * 6;
  const uint8_t* cflb = col_flag + (size_t)b * N2;
  uint32_t k1 = kNone, k2 = kNone;
  for (int j = lane; j < N2; j += 32) {
    const uint8_t cflag = cflb[j];
    bool cand = rok && (cflag & 1) != 0;
    if (cand) {
      const float* cf = cfb + 6 * j;
      cand = __fadd_rn(__fmul_rn(rc, cf[0]), __fmul_rn(rs, cf[1])) >= cos_thr &&
             !((cflag & 2) != 0 && !rstereo);
      if (cand) {
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(cf[2], bx), __fmul_rn(cf[3], by)),
                                    __fmul_rn(cf[4], bz));
        const float c = fminf(fmaxf(__fdiv_rn(dot, cf[5]), -1.f), 1.f);
        cand = fabsf(c) < thr;
      }
    }
    uint32_t dist = 257;
    if (cand) {
      dist = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) dist += __popc(qd[w] ^ tb[j * 8 + w]);
    }
    push((dist << 16) | (uint32_t)j, k1, k2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t o1 = __shfl_xor_sync(0xffffffffu, k1, o);
    const uint32_t o2 = __shfl_xor_sync(0xffffffffu, k2, o);
    const uint32_t n1 = min(k1, o1);
    const uint32_t n2 = min(max(k1, o1), min(k2, o2));
    k1 = n1;
    k2 = n2;
  }
  if (lane == 0) {
    int* o = out + ((size_t)b * N1 + row) * 4;
    o[0] = (int)(k1 >> 16);
    o[1] = (int)(k1 & 0xffffu);
    int second = 257, second_idx = 0;
    if (k2 != kNone && (k2 >> 16) < 257) {
      second = (int)(k2 >> 16);
      second_idx = (int)(k2 & 0xffffu);
    }
    o[2] = second;
    o[3] = second_idx;
  }
}

}  // namespace

extern "C" int svt_epipolar_top2(int B, int N1, int N2, const uint32_t* q, const float* row_f,
                                 const uint8_t* row_flag, const uint32_t* t, const float* col_f,
                                 const uint8_t* col_flag, float cos_thr, int* out,
                                 void* stream) {
  if (N1 > 0 && B > 0) {
    const dim3 grid((N1 + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
    epipolar_top2_kernel<<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        N1, N2, q, row_f, row_flag, t, col_f, col_flag, cos_thr, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int svt_hamming_top2(int M, int N, const uint32_t* q, const uint32_t* t,
                                const uint8_t* row_ok, const uint8_t* col_ok,
                                int use_window, const float* row_u, const float* row_v,
                                const float* row_xr, const float* row_rad,
                                const int* row_lo, const int* row_hi, const float* col_u,
                                const float* col_v, const float* col_xr,
                                const int* col_level, int use_orient, const float* row_c,
                                const float* row_s, const float* col_c,
                                const float* col_s, float cos_thr, int* out,
                                void* stream) {
  if (M > 0) {
    const int blocks = (M + kWarpsPerBlock - 1) / kWarpsPerBlock;
    hamming_top2_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        M, N, q, t, row_ok, col_ok, use_window, row_u, row_v, row_xr, row_rad, row_lo,
        row_hi, col_u, col_v, col_xr, col_level, use_orient, row_c, row_s, col_c,
        col_s, cos_thr, out);
  }
  return (int)cudaGetLastError();
}
