// Kernel Q: the tracking cascade's association bookkeeping, three entry
// points.
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
//    stays: a 64-bit minimum of (order-preserving score bits, slot) per id
//    (a CAS loop) in an open-addressing table of the ids, then each slot
//    compares.
//  rebase_kernel: a table of the published landmark ids (lowest row per
//    id, as argmax takes the first), then each chained slot looks its id up:
//    found -> the table row's position, not found -> invalidated; thread 0
//    re-anchors the two chained poses, T_new = T_old @ A.
//
// Bound: each call moves ~0.1-0.2 MB (the slice's N = 2872 slots, M = 4096
// sources, C = 4096 table rows), ~0.05 us at 3.35 TB/s; what it takes is
// latency: dependent rounds of global loads, barriers, and the clearing of
// its tables. So the scatter and the dedup issue every load a thread needs
// in one round before their first barrier (kPer sources or slots a thread,
// held in registers), and run on a cluster of kCluster blocks (thread-block
// clusters, distributed shared memory, as kernel D): each block owns a
// range of the slots' counts (scatter) or of the id table's entries
// (dedup) in its shared memory, the blocks clear their ranges in parallel,
// and the other blocks' atomics reach it remotely. The dedup runs as one
// block while its table fits one SM (N <= 8192: 192 KB), as the cluster
// above that. A call is one round of loads, the atomics, a cluster
// barrier, one round of reads of the counts or the table, and the stores.
// Two more barriers are split in halves that work runs between: every
// block has cleared its range before the first remote atomic (the loads
// run meanwhile), and no block exits while a peer may still read it (the
// owners' stores run meanwhile). The dedup's table has T >= 2N entries
// (12 bytes: a 32-bit id, a 64-bit best) spread over the cluster, so N
// reaches kPer x kCluster x threads = 32768 slots (MAX_DEDUP_SLOTS). The
// rebase runs twice in a run and keeps its one-block design. Everything is
// integer or a copy, so the results are exact and the same on every launch.
// Every dynamic shared-memory limit is raised through svt::reserve_smem.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 1024;   // the rebase's block
constexpr int kCluster = 8;      // blocks of the scatter's and dedup's cluster
constexpr int kAssocThreads = 512;
constexpr int kScatterPer = 4;   // sources a scatter thread holds in registers
constexpr int kDedupPer = 8;     // slots a dedup thread holds (its cap)
// the dedup's one-block route up to here: a table of 2 x 8192 entries of 12
// bytes (192 KB) fits one SM
constexpr int kOneBlockSlots = 8192;

__device__ __forceinline__ uint32_t hash_slot(uint32_t key, int log_t) {
  return (key * 2654435761u) >> (32 - log_t);
}

// the cluster of CL blocks (CL = 1: one block, no cluster)
template <int CL>
struct Cluster {
  __device__ static void sync() {
    if constexpr (CL == 1) {
      __syncthreads();
    } else {
      cooperative_groups::this_cluster().sync();
    }
  }
  // sync() split in two, so that work runs between this block's arrival
  // (its earlier stores released) and its wait for every block's
  __device__ static void arrive() {
    if constexpr (CL != 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  }
  __device__ static void wait() {
    if constexpr (CL == 1) {
      __syncthreads();
    } else {
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
  }
  __device__ static int rank() {
    if constexpr (CL == 1) {
      return 0;
    } else {
      return (int)cooperative_groups::this_cluster().block_rank();
    }
  }
  // block r's copy of this block's shared variable p
  template <class T>
  __device__ static T* at(T* p, int r) {
    if constexpr (CL == 1) {
      return p;
    } else {
      return cooperative_groups::this_cluster().map_shared_rank(p, r);
    }
  }
};

struct Src {
  int n, id;
  bool sel;
  float p0, p1, p2;
};

// source m's slot, flag, position and id, loaded in one round (the
// position and id whether or not it is accepted, so no load waits on another)
__device__ __forceinline__ Src load_src(int m, int M, int N, const int* best_idx,
                                        int idx_stride, const uint8_t* accepted,
                                        const float* src_pos, int pos_stride,
                                        const int* src_id, int id_stride) {
  Src s{-1, -1, false, 0.f, 0.f, 0.f};
  if (m < M) {
    const float* p = src_pos + (size_t)m * pos_stride;
    s.n = best_idx[(size_t)m * idx_stride];
    const bool acc = accepted[m] != 0;
    s.p0 = p[0];
    s.p1 = p[1];
    s.p2 = p[2];
    s.id = src_id[(size_t)m * id_stride];
    s.sel = acc && s.n >= 0 && s.n < N;
  }
  return s;
}

__global__ void __launch_bounds__(kAssocThreads)
scatter_kernel(int M, int N, int chunk, const int* __restrict__ best_idx, int idx_stride,
               const uint8_t* __restrict__ accepted, const float* __restrict__ src_pos,
               int pos_stride, const int* __restrict__ src_id, int id_stride,
               float* __restrict__ pos_out, int* __restrict__ id_out,
               uint8_t* __restrict__ has_out) {
  extern __shared__ int count[];  // [chunk]: slots [rank * chunk, (rank + 1) * chunk)
  using C = Cluster<kCluster>;
  constexpr int NT = kAssocThreads;
  const int rank = C::rank();
  for (int i = threadIdx.x; i < chunk; i += NT) count[i] = 0;
  constexpr int G = kCluster * NT;
  const int g = rank * NT + threadIdx.x;
  auto load = [&](int m) {
    return load_src(m, M, N, best_idx, idx_stride, accepted, src_pos, pos_stride, src_id,
                    id_stride);
  };
  auto counter = [&](int n) { return C::at(count, n / chunk) + n % chunk; };
  C::arrive();
  Src s[kScatterPer];
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j) s[j] = load(g + j * G);
  C::wait();  // every block's counts are 0 before any peer adds to them
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j)
    if (s[j].sel) atomicAdd(counter(s[j].n), 1);
  for (int m = g + kScatterPer * G; m < M; m += G) {
    const Src t = load(m);
    if (t.sel) atomicAdd(counter(t.n), 1);
  }
  C::sync();
  auto write = [&](const Src& t) {
    if (t.sel && *counter(t.n) == 1) {
      pos_out[3 * t.n] = t.p0;
      pos_out[3 * t.n + 1] = t.p1;
      pos_out[3 * t.n + 2] = t.p2;
      id_out[t.n] = t.id;
    }
  };
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j) write(s[j]);
  for (int m = g + kScatterPer * G; m < M; m += G) write(load(m));
  C::arrive();  // this block reads no peer's counts from here on
  // this block's slots: held when picked once, else cleared
  for (int i = threadIdx.x; i < chunk; i += NT) {
    const int n = rank * chunk + i;
    if (n >= N) break;
    const bool one = count[i] == 1;
    has_out[n] = one ? 1 : 0;
    if (!one) {
      pos_out[3 * n] = 0.f;
      pos_out[3 * n + 1] = 0.f;
      pos_out[3 * n + 2] = 0.f;
      id_out[n] = -1;
    }
  }
  C::wait();  // no block exits while a peer may still read it
}

// float -> uint32 whose unsigned order is the float order (-0 as +0)
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  if (f == 0.f) f = 0.f;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// an empty entry of the id table (id -1, its bits, keeps its group apart)
constexpr uint32_t kEmpty = 0xffffffffu;
constexpr unsigned long long kNoBest = ~0ull;

// *p = min(*p, v) by a CAS loop: a 64-bit atomicMin into another block's
// shared memory leaves wrong minima on the H100 (scripts/dsmem_atomics_check.cu),
// where a 64-bit atomicCAS is right
__device__ __forceinline__ void min_u64(unsigned long long* p, unsigned long long v) {
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(p);
  while (v < old) {
    const unsigned long long got = atomicCAS(p, old, v);
    if (got == old) break;
    old = got;
  }
}

template <int CL, int NT>
__global__ void __launch_bounds__(NT)
dedup_kernel(int N, int log_t, int log_tb, const uint8_t* __restrict__ has,
             const int* __restrict__ ids, const float* __restrict__ score,
             uint8_t* __restrict__ keep_out, int* __restrict__ ids_out) {
  // this block's entries [rank * Tb, (rank + 1) * Tb) of the cluster's table
  // of T = CL * Tb: the least (score bits, slot) of each, then the ids; all
  // ones when clear
  extern __shared__ uint4 tab4[];
  __shared__ unsigned long long best_neg;  // the slots of id -1 (block 0's)
  using C = Cluster<CL>;
  const int Tb = 1 << log_tb, T = 1 << log_t;
  unsigned long long* best = reinterpret_cast<unsigned long long*>(tab4);
  uint32_t* keys = reinterpret_cast<uint32_t*>(best + Tb);
  const int rank = C::rank();
  for (int i = threadIdx.x; i < 3 * Tb / 4; i += NT)
    tab4[i] = make_uint4(kEmpty, kEmpty, kEmpty, kEmpty);
  if (threadIdx.x == 0) best_neg = kNoBest;
  C::arrive();
  constexpr int G = CL * NT;
  const int g = rank * NT + threadIdx.x;
  bool held[kDedupPer];
  int id[kDedupPer];
  unsigned long long packed[kDedupPer];
#pragma unroll
  for (int j = 0; j < kDedupPer; ++j) {
    const int n = g + j * G;
    held[j] = false;
    if (n < N) {
      held[j] = has[n] != 0;
      id[j] = ids[n];
      packed[j] = ((unsigned long long)ordered_bits(score[n]) << 32) | (uint32_t)n;
    }
  }
  C::wait();  // every block's entries are clear before any peer inserts
  // each held slot's entry (-1: best_neg, for id -1), on its owner block
  int at[kDedupPer];
  auto entry = [&](int e) {
    return e < 0 ? C::at(&best_neg, 0) : C::at(best, e >> log_tb) + (e & (Tb - 1));
  };
#pragma unroll
  for (int j = 0; j < kDedupPer; ++j) {
    at[j] = -1;
    if (!held[j]) continue;
    if (id[j] != -1) {
      uint32_t h = hash_slot((uint32_t)id[j], log_t);
      while (true) {
        uint32_t* k = C::at(keys, (int)(h >> log_tb)) + (h & (Tb - 1));
        const uint32_t prev = atomicCAS(k, kEmpty, (uint32_t)id[j]);
        if (prev == kEmpty || prev == (uint32_t)id[j]) break;
        h = (h + 1) & (T - 1);
      }
      at[j] = (int)h;
    }
    if constexpr (CL == 1) {
      atomicMin(entry(at[j]), packed[j]);  // in this block's shared memory, where it is right
    } else {
      min_u64(entry(at[j]), packed[j]);
    }
  }
  C::sync();
  bool keep[kDedupPer];
#pragma unroll
  for (int j = 0; j < kDedupPer; ++j)
    keep[j] = held[j] && (uint32_t)(*entry(at[j]) & 0xffffffffull) == (uint32_t)(g + j * G);
  if constexpr (CL != 1) C::arrive();  // this block reads no peer's entries from here on
#pragma unroll
  for (int j = 0; j < kDedupPer; ++j) {
    const int n = g + j * G;
    if (n >= N) continue;
    keep_out[n] = keep[j] ? 1 : 0;
    ids_out[n] = keep[j] ? id[j] : -1;
  }
  if constexpr (CL != 1) C::wait();  // no block exits while a peer may still read it
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

template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, int cluster, int threads, size_t smem,
                           cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// strides in elements: best_idx[m * idx_stride], src_pos rows of
// pos_stride floats (3 used), src_id[m * id_stride]
extern "C" int svt_scatter_to_current(int M, int N, const int* best_idx, int idx_stride,
                                      const uint8_t* accepted, const float* src_pos,
                                      int pos_stride, const int* src_id, int id_stride,
                                      float* pos_out, int* id_out, uint8_t* has_out,
                                      void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int chunk = (N + kCluster - 1) / kCluster;
  const size_t smem = sizeof(int) * (size_t)chunk;
  const cudaError_t e = svt::reserve_smem((const void*)scatter_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_cluster(scatter_kernel, kCluster, kAssocThreads, smem,
                             (cudaStream_t)stream, M, N, chunk, best_idx, idx_stride, accepted,
                             src_pos, pos_stride, src_id, id_stride, pos_out, id_out, has_out);
}

// one block of kThreads up to kOneBlockSlots (its 2N-entry table fits one
// SM), a cluster of 8 blocks of kAssocThreads above that, up to kDedupPer x
// kCluster x kAssocThreads = MAX_DEDUP_SLOTS
extern "C" int svt_dedup_by_id(int N, const uint8_t* has, const int* ids, const float* score,
                               uint8_t* keep_out, int* ids_out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (N > kDedupPer * kCluster * kAssocThreads) return (int)cudaErrorInvalidValue;
  const bool one_block = N <= kOneBlockSlots;
  // T >= 2N entries, at least 64 a block
  const int log_t = log2_table(N) > 9 ? log2_table(N) : 9;
  const int log_tb = one_block ? log_t : log_t - 3;
  const size_t smem = 3 * sizeof(uint32_t) * ((size_t)1 << log_tb);
  const cudaStream_t st = (cudaStream_t)stream;
  if (one_block) {
    auto kernel = dedup_kernel<1, kThreads>;
    const cudaError_t e = svt::reserve_smem((const void*)kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<1, kThreads, smem, st>>>(N, log_t, log_tb, has, ids, score, keep_out, ids_out);
    return (int)cudaGetLastError();
  }
  auto kernel = dedup_kernel<kCluster, kAssocThreads>;
  const cudaError_t e = svt::reserve_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_cluster(kernel, kCluster, kAssocThreads, smem, st, N, log_t, log_tb, has,
                             ids, score, keep_out, ids_out);
}

extern "C" int svt_rebase_chain(int N, int C, const float* la_pos, const uint8_t* la_valid,
                                const int* la_id, const float* tbl_f32, const int* tbl_u32,
                                const float* A_R, const float* A_t, const float* R_last,
                                const float* t_last, const float* R_prev, const float* t_prev,
                                float* pos_out, uint8_t* valid_out, int* id_out,
                                float* pose_out, void* stream) {
  const int log_t = log2_table(C);
  const size_t smem = 2 * sizeof(int) * ((size_t)1 << log_t);
  const cudaError_t e = svt::reserve_smem((const void*)rebase_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  rebase_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      N, C, log_t, la_pos, la_valid, la_id, tbl_f32, tbl_u32, A_R, A_t, R_last, t_last, R_prev,
      t_prev, pos_out, valid_out, id_out, pose_out);
  return (int)cudaGetLastError();
}
