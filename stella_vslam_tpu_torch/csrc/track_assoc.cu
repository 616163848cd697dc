// Kernel Q: the tracking cascade's association bookkeeping, three entry
// points, each one block that keeps its per-slot or per-id state in shared
// memory.
//
// Replaces stella_vslam_tpu/module/tracking_kernels.py
// _scatter_matches_to_current (:64) and _dedup_by_landmark_id (:83), and
// stella_vslam_tpu/tracking_module.py _rebase_chain (:51). The TPU forms are
// one-hot contractions: an [M,N] match matrix summed per column, an [N,N]
// id-equality and score comparison, an [N,C] id-equality and argmax.
//
//  scatter_kernel: per current slot, how many accepted sources picked it
//    (integer atomics in shared memory, exact in any order), then each
//    accepted source whose slot was picked once writes its position and
//    landmark id there; every other slot reads (0, -1, not held).
//  dedup_kernel: among the held slots that share a landmark id, the one
//    with the least score (ties to the lowest slot, `beats` at :101-103)
//    stays: a 64-bit atomicMin of (order-preserving score bits, slot) per id
//    in an open-addressing table of the ids, then each slot compares.
//  rebase_kernel: a table of the published landmark ids (lowest row per
//    id, as argmax takes the first), then each chained slot looks its id up:
//    found -> the table row's position, not found -> invalidated; thread 0
//    re-anchors the two chained poses, T_new = T_old @ A.
//
// Bound: each call moves ~0.1-0.2 MB (the slice's N = 2872 slots, M = 4096
// sources, C = 4096 table rows), ~0.05 us at 3.35 TB/s, so it is bound by
// its launch and its few dependent barriers; one block suffices and keeps
// the tables on chip. Everything is integer or a copy, so the results are
// exact and the same on every launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t hash_slot(uint32_t key, int log_t) {
  return (key * 2654435761u) >> (32 - log_t);
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(int M, int N, const int* __restrict__ best_idx, int idx_stride,
               const uint8_t* __restrict__ accepted, const float* __restrict__ src_pos,
               int pos_stride, const int* __restrict__ src_id, int id_stride,
               float* __restrict__ pos_out,
               int* __restrict__ id_out, uint8_t* __restrict__ has_out) {
  extern __shared__ int count[];  // [N]
  for (int n = threadIdx.x; n < N; n += blockDim.x) count[n] = 0;
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int n = best_idx[m * idx_stride];
    if (accepted[m] && n >= 0 && n < N) atomicAdd(&count[n], 1);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const bool one = count[n] == 1;
    has_out[n] = one ? 1 : 0;
    if (!one) {
      pos_out[3 * n] = 0.f;
      pos_out[3 * n + 1] = 0.f;
      pos_out[3 * n + 2] = 0.f;
      id_out[n] = -1;
    }
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int n = best_idx[m * idx_stride];
    if (accepted[m] && n >= 0 && n < N && count[n] == 1) {
      const float* p = src_pos + (size_t)m * pos_stride;
      pos_out[3 * n] = p[0];
      pos_out[3 * n + 1] = p[1];
      pos_out[3 * n + 2] = p[2];
      id_out[n] = src_id[(size_t)m * id_stride];
    }
  }
}

// float -> uint32 whose unsigned order is the float order (-0 as +0)
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  if (f == 0.f) f = 0.f;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr unsigned long long kEmpty = ~0ull;

__global__ void __launch_bounds__(kThreads)
dedup_kernel(int N, int log_t, const uint8_t* __restrict__ has, const int* __restrict__ ids,
             const float* __restrict__ score, uint8_t* __restrict__ keep_out,
             int* __restrict__ ids_out) {
  extern __shared__ unsigned long long tab[];  // keys [T], best [T]
  const int T = 1 << log_t;
  unsigned long long* keys = tab;
  unsigned long long* best = tab + T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    keys[i] = kEmpty;
    best[i] = kEmpty;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (!has[n]) continue;
    const unsigned long long key = (uint32_t)ids[n];
    uint32_t h = hash_slot((uint32_t)ids[n], log_t);
    while (true) {
      const unsigned long long prev = atomicCAS(&keys[h], kEmpty, key);
      if (prev == kEmpty || prev == key) break;
      h = (h + 1) & (T - 1);
    }
    atomicMin(&best[h], ((unsigned long long)ordered_bits(score[n]) << 32) | (uint32_t)n);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool k = false;
    if (has[n]) {
      const unsigned long long key = (uint32_t)ids[n];
      uint32_t h = hash_slot((uint32_t)ids[n], log_t);
      while (keys[h] != key) h = (h + 1) & (T - 1);
      k = (uint32_t)(best[h] & 0xffffffffull) == (uint32_t)n;
    }
    keep_out[n] = k ? 1 : 0;
    ids_out[n] = k ? ids[n] : -1;
  }
}

// out = a @ b for 3x3 row-major, and a @ v + w
__device__ void mat3(const float* a, const float* b, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

__device__ void affine3(const float* a, const float* v, const float* w, float* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2] + w[i];
}

__global__ void __launch_bounds__(kThreads)
rebase_kernel(int N, int C, int log_t, const float* __restrict__ la_pos,
              const uint8_t* __restrict__ la_valid, const int* __restrict__ la_id,
              const float* __restrict__ tbl_f32, const int* __restrict__ tbl_u32,
              const float* __restrict__ A_R, const float* __restrict__ A_t,
              const float* __restrict__ R_last, const float* __restrict__ t_last,
              const float* __restrict__ R_prev, const float* __restrict__ t_prev,
              float* __restrict__ pos_out, uint8_t* __restrict__ valid_out,
              int* __restrict__ id_out, float* __restrict__ pose_out) {
  extern __shared__ int tabi[];  // keys [T], rows [T]
  const int T = 1 << log_t;
  int* keys = tabi;
  int* rows = tabi + T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    keys[i] = -1;
    rows[i] = 0x7fffffff;
  }
  __syncthreads();
  // the table's ids (column 8 of the packed u32 rows); a negative id is a
  // padding row, which no chained id (>= 0) can match
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int id = tbl_u32[10 * c + 8];
    if (id < 0) continue;
    uint32_t h = hash_slot((uint32_t)id, log_t);
    while (true) {
      const int prev = atomicCAS(&keys[h], -1, id);
      if (prev == -1 || prev == id) break;
      h = (h + 1) & (T - 1);
    }
    atomicMin(&rows[h], c);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int id = la_id[n];
    int row = -1;
    if (id >= 0) {
      uint32_t h = hash_slot((uint32_t)id, log_t);
      while (keys[h] != -1) {
        if (keys[h] == id) {
          row = rows[h];
          break;
        }
        h = (h + 1) & (T - 1);
      }
    }
    const bool found = row >= 0;
    for (int j = 0; j < 3; ++j) pos_out[3 * n + j] = found ? tbl_f32[8 * row + j] : la_pos[3 * n + j];
    valid_out[n] = (la_valid[n] && found) ? 1 : 0;
    id_out[n] = found ? id : -1;
  }
  if (threadIdx.x == 0) {
    // pose_out: R_l [9], t_l [3], R_p [9], t_p [3]
    mat3(R_last, A_R, pose_out);
    affine3(R_last, A_t, t_last, pose_out + 9);
    mat3(R_prev, A_R, pose_out + 12);
    affine3(R_prev, A_t, t_prev, pose_out + 21);
  }
}

int log2_table(int n) {
  int l = 1;
  while ((1 << l) < 2 * n) ++l;
  return l;
}

}  // namespace

// strides in elements: best_idx[m * idx_stride], src_pos rows of
// pos_stride floats (3 used), src_id[m * id_stride]
extern "C" int svt_scatter_to_current(int M, int N, const int* best_idx, int idx_stride,
                                      const uint8_t* accepted, const float* src_pos,
                                      int pos_stride, const int* src_id, int id_stride,
                                      float* pos_out, int* id_out, uint8_t* has_out,
                                      void* stream) {
  const size_t smem = sizeof(int) * (size_t)N;
  cudaFuncSetAttribute(scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (N > 0)
    scatter_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
        M, N, best_idx, idx_stride, accepted, src_pos, pos_stride, src_id, id_stride, pos_out,
        id_out, has_out);
  return (int)cudaGetLastError();
}

extern "C" int svt_dedup_by_id(int N, const uint8_t* has, const int* ids, const float* score,
                               uint8_t* keep_out, int* ids_out, void* stream) {
  const int log_t = log2_table(N);
  const size_t smem = 2 * sizeof(unsigned long long) * ((size_t)1 << log_t);
  cudaFuncSetAttribute(dedup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (N > 0)
    dedup_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(N, log_t, has, ids, score, keep_out,
                                                              ids_out);
  return (int)cudaGetLastError();
}

extern "C" int svt_rebase_chain(int N, int C, const float* la_pos, const uint8_t* la_valid,
                                const int* la_id, const float* tbl_f32, const int* tbl_u32,
                                const float* A_R, const float* A_t, const float* R_last,
                                const float* t_last, const float* R_prev, const float* t_prev,
                                float* pos_out, uint8_t* valid_out, int* id_out,
                                float* pose_out, void* stream) {
  const int log_t = log2_table(C);
  const size_t smem = 2 * sizeof(int) * ((size_t)1 << log_t);
  cudaFuncSetAttribute(rebase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  rebase_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      N, C, log_t, la_pos, la_valid, la_id, tbl_f32, tbl_u32, A_R, A_t, R_last, t_last, R_prev,
      t_prev, pos_out, valid_out, id_out, pose_out);
  return (int)cudaGetLastError();
}
