// The camera models' per-point projection arithmetic shared by kernels R, D,
// F, H, I, K and L, each templated on the model (kPerspective or kEquirect).
//
// Replaces the equirectangular branches of stella_vslam_tpu/camera/base.py
// (reproject_to_image :232-246 with undistorted_from_bearings :217) and of
// the residuals: ops/optim/residuals.py equirectangular_residual (:92-135,
// the pose optimizer's) and ops/optim/ba.py _pose_rows (:322-335, bundle
// adjustment's). The perspective model's projection stays in each kernel,
// where it is written in the order of that kernel's plain version.
//
// Equirectangular: longitude atan2(x, z) over the image width, latitude
// asin(y / |Xc|) over its height, every direction visible, "depth" the
// norm. The residual's longitude wraps: du is taken modulo the width into
// [-w/2, w/2) as a floor modulo (jnp.mod, torch.remainder). It is written as
// fmodf, which is exact, followed by the same sign fix torch.remainder and
// jnp.mod apply, so it equals theirs bit for bit (fmodf alone truncates).
#pragma once

#include <math.h>

namespace svt_cam {

// camera/base.py's CameraModel: the projections are kPerspective and
// kEquirect (fisheye and radial division project as the pinhole on their
// undistorted keypoints); kFisheye and kRadialDivision are kernel R's
// undistortion modes
constexpr int kPerspective = 0;
constexpr int kFisheye = 1;
constexpr int kEquirect = 2;
constexpr int kRadialDivision = 3;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;

// x mod w with the sign of w (floor modulo)
__device__ __forceinline__ float floor_mod(float x, float w) {
  float r = fmodf(x, w);
  if (r != 0.f && ((r < 0.f) != (w < 0.f))) r += w;
  return r;
}

// reproject_to_image's equirectangular branch for a camera-frame point:
// pixel (u, v), depth = the norm; returns visible (norm > 1e-6)
__device__ __forceinline__ bool equirect_project(float x, float y, float z, float cx, float cy,
                                                 float width, float height, float& u, float& v,
                                                 float& depth) {
  const float norm = sqrtf(x * x + y * y + z * z);
  const float n = fmaxf(norm, 1e-12f);
  const float by = y / n;
  const float lat = -asinf(fminf(fmaxf(by, -1.f), 1.f));
  const float lon = atan2f(x / n, z / n);
  u = cx + lon * width / kTwoPi;
  v = cy - lat * height / kPi;
  depth = norm;
  return norm > 1e-6f;
}

// The equirectangular residual rows and d(u, v)/d(Xc) of one observation
// at the camera-frame point (x, y, z): r = (du wrapped, dv), dpi [2][3];
// returns depth_ok (|Xc| > 1e-6).
__device__ __forceinline__ bool equirect_residual(float x, float y, float z, float ou, float ov,
                                                  float cx, float cy, float width, float height,
                                                  float r[2], float dpi[2][3]) {
  const float Ln2 = fmaxf(x * x + y * y + z * z, 1e-16f);
  const float Ln = sqrtf(Ln2);
  const float xz2 = fmaxf(x * x + z * z, 1e-12f);
  const float ku = width / kTwoPi;
  const float kv = height / kPi;
  const float u = cx + ku * atan2f(x, z);
  const float v = cy + kv * asinf(fminf(fmaxf(y / Ln, -1.f), 1.f));
  r[0] = floor_mod(u - ou + width / 2.f, width) - width / 2.f;
  r[1] = v - ov;
  const float sxz = sqrtf(xz2);
  const float denom = Ln2 * sxz;
  dpi[0][0] = ku * z / xz2;
  dpi[0][1] = 0.f;
  dpi[0][2] = -ku * x / xz2;
  dpi[1][0] = -kv * x * y / denom;
  dpi[1][1] = kv * sxz / Ln2;
  dpi[1][2] = -kv * z * y / denom;
  return Ln > 1e-6f;
}

}  // namespace svt_cam
