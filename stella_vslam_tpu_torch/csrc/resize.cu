// Kernel S (K3): the image pyramid's level-to-level INTER_LINEAR resize.
//
// Replaces stella_vslam_tpu/feature/orb_extractor.py: _resize_matrices
// (:118) and `img = (R @ img) @ C.T` in _extract_impl (:307). The TPU form
// is two dense matmuls per level ([h_out, h_in] and [w_out, w_in] weight
// matrices with at most two non-zero entries per row), because the MXU
// makes a dense product cheaper than a gather there.
//
// On Hopper: one thread per output pixel of one level, both passes fused.
// The thread forms the row pass at its two source columns exactly as the
// matmul forms that entry of R @ img (the product of the lower tap, then
// the upper tap added with one fused multiply-add: the order and rounding of
// a dot product that walks the source index upwards; the zero entries of R
// add nothing), then the column pass from those two values the same way.
// The CPU's float32 matmul rounds so; cuBLAS, on most of these shapes,
// sums each run of 8 source indices apart and adds the partial sums, so
// where the two taps straddle such a boundary (j0 % 8 == 7) it rounds the
// two products separately: ~6% of a frame's resized pixels then differ
// from it by an ulp (chip_smoke.py counts them).
// The intermediate [h_out, w_in] image is never written. Each row of R and
// of C is given as (j0, j1, w0, w1), taken from the same numpy matrices;
// a row with one non-zero entry (a clamped border, where both taps fall on
// one source index with weight (1 - f) + f) has j1 = j0 and w1 = 0.
// The levels are chained, so one launch per level: the images of a batch
// (a stereo pair) go in one launch (grid z), and the output is written
// straight into the flat pyramid buffer that kernels A and B read.
// Bound: bytes — each output pixel reads at most 4 source pixels (from
// L1/L2; ~1 from device memory) and writes one f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tap2(float w0, float a0, float w1, float a1) {
  return __fmaf_rn(w1, a1, __fmul_rn(w0, a0));
}

__global__ void resize_level_kernel(const float* __restrict__ src, long long batch_stride,
                                    int w_in, float* __restrict__ dst, int h_out,
                                    int w_out, const int* __restrict__ row_j,
                                    const float* __restrict__ row_w,
                                    const int* __restrict__ col_j,
                                    const float* __restrict__ col_w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h_out || k >= w_out) return;
  const float* s = src + blockIdx.z * batch_stride;
  const int r0 = row_j[2 * i], r1 = row_j[2 * i + 1];
  const float rw0 = row_w[2 * i], rw1 = row_w[2 * i + 1];
  const int c0 = col_j[2 * k], c1 = col_j[2 * k + 1];
  const float cw0 = col_w[2 * k], cw1 = col_w[2 * k + 1];
  // (R @ img)[i, c] at the two source columns of output column k
  const float t0 = tap2(rw0, s[r0 * w_in + c0], rw1, s[r1 * w_in + c0]);
  const float t1 = tap2(rw0, s[r0 * w_in + c1], rw1, s[r1 * w_in + c1]);
  dst[blockIdx.z * batch_stride + (long long)i * w_out + k] = tap2(cw0, t0, cw1, t1);
}

}  // namespace

// src / dst: level l-1 and level l of image 0 inside the flat pyramid
// buffer; image b's are batch_stride floats further on.
extern "C" int svt_resize_level(int B, const float* src, long long batch_stride, int w_in,
                                float* dst, int h_out, int w_out, const int* row_j,
                                const float* row_w, const int* col_j, const float* col_w,
                                void* stream) {
  if (B > 0 && h_out > 0 && w_out > 0) {
    dim3 block(32, 8);
    dim3 grid((w_out + 31) / 32, (h_out + 7) / 8, B);
    resize_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        src, batch_stride, w_in, dst, h_out, w_out, row_j, row_w, col_j, col_w);
  }
  return (int)cudaGetLastError();
}
