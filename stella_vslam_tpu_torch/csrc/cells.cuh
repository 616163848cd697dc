// The cell grid of kernel C's index (hamming_top2.cu) and kernel L's walk
// (fuse.cu): a point's cell on one axis, and the cells a window meets.
#pragma once

#include <math.h>

namespace svt_cells {

// the cell of a target coordinate on one axis: floor(x * inv), clamped to
// the grid (the border cells take what lies outside it)
__device__ __forceinline__ int cell_of(float x, float inv, int g) {
  return (int)fminf(fmaxf(floorf(__fmul_rn(x, inv)), 0.f), (float)(g - 1));
}

// the cells a window [c - rad, c + rad] meets on one axis, widened by a
// rounding margin; a NaN bound takes the grid's end
__device__ __forceinline__ void cell_span(float c, float rad, float inv, int g, int& a, int& b) {
  const float m = __fadd_rn(__fadd_rn(rad, 0.01f),
                            __fmul_rn(1e-5f, __fadd_rn(fabsf(c), fabsf(rad))));
  const float lo = floorf(__fmul_rn(__fsub_rn(c, m), inv));
  const float hi = floorf(__fmul_rn(__fadd_rn(c, m), inv));
  a = isnan(lo) ? 0 : (int)fminf(fmaxf(lo, 0.f), (float)(g - 1));
  b = isnan(hi) ? g - 1 : (int)fminf(fmaxf(hi, 0.f), (float)(g - 1));
}

}  // namespace svt_cells
