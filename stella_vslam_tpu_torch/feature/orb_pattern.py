"""BRIEF sampling pattern and IC-angle circular patch geometry.

Two pattern families:

* "native" (default): this framework's own deterministic pattern following
  the original BRIEF/ORB construction (pairs drawn from an isotropic Gaussian
  with sigma = patch_size/5, clipped to the patch, fixed seed). Descriptors
  are self-consistent within this framework; the shipped vocabulary
  (data/vocab_default.npz) is trained for this family.
* "opencv" (`Feature.descriptor_pattern: opencv`): the OpenCV ORB learned
  256-pair constant table (`opencv_orb_pairs.npy`, the bit_pattern_31_ data
  of OpenCV features2d/orb.cpp, 3-clause BSD). The reference embeds the same
  table (src/stella_vslam/feature/orb_point_pairs.h) — a pure data constant
  adopted interop-by-spec so descriptors are bit-comparable with maps and
  vocabularies produced by the actual stella_vslam binary (relocalization /
  loop detection against genuine reference artifacts).
"""
from __future__ import annotations

import os

import numpy as np

PATCH_SIZE = 31
HALF_PATCH = PATCH_SIZE // 2  # 15; reference orb_impl.h fast_half_patch_size_
EDGE_BORDER = 19  # reference orb_extractor.h orb_patch_radius_
NUM_PAIRS = 256
# the package's own copy of the table, beside this module
_OPENCV_PAIRS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "opencv_orb_pairs.npy")
_PATTERN_SEED = 0x5713A


def generate_brief_pattern(seed: int = _PATTERN_SEED) -> np.ndarray:
    """Returns int32 [256, 4] rows (x0, y0, x1, y1), coords in [-13, 13].

    Gaussian sigma = PATCH_SIZE/5 (original BRIEF G-II construction); clipped to
    +/-13 so that a 45-degree rotation stays inside the 19px edge border
    (13 * sqrt(2) ~ 18.4 < 19).
    """
    rng = np.random.default_rng(seed)
    sigma = PATCH_SIZE / 5.0
    pts = rng.normal(0.0, sigma, size=(NUM_PAIRS, 4))
    pts = np.clip(np.round(pts), -13, 13).astype(np.int32)
    # avoid degenerate pairs (identical endpoints give constant bits)
    for i in range(NUM_PAIRS):
        while pts[i, 0] == pts[i, 2] and pts[i, 1] == pts[i, 3]:
            pts[i, 2:] = np.clip(
                np.round(rng.normal(0.0, sigma, size=2)), -13, 13
            ).astype(np.int32)
    return pts


def opencv_brief_pattern() -> np.ndarray:
    """The OpenCV ORB bit_pattern_31_ 256-pair table, int32 [256, 4] rows
    (x0, y0, x1, y1), coords in [-13, 12] — identical numbers to the
    reference's feature/orb_point_pairs.h:47 (which quotes OpenCV orb.cpp).
    Produces descriptors bit-compatible with reference-built maps."""
    return np.load(_OPENCV_PAIRS_PATH)


def brief_pattern(name: str = "native") -> np.ndarray:
    """Pattern registry keyed by the `Feature.descriptor_pattern` config
    value: "native" (default, this framework's seeded construction) or
    "opencv" (reference-interoperable constant table)."""
    if name in (None, "", "native"):
        return generate_brief_pattern()
    if name == "opencv":
        return opencv_brief_pattern()
    raise ValueError(f"unknown descriptor_pattern {name!r} "
                     "(expected 'native' or 'opencv')")


def ic_angle_offsets() -> np.ndarray:
    """Integer (dx, dy) offsets of the circular intensity-centroid patch,
    radius = HALF_PATCH, mirroring the reference's u_max row widths
    (orb_impl.cc ic_angle): for each row v in [-15, 15], |u| <= round(sqrt(r^2 - v^2)).
    Returns int32 [P, 2]."""
    out = []
    r = HALF_PATCH
    for v in range(-r, r + 1):
        umax = int(round(np.sqrt(max(r * r - v * v, 0))))
        for u in range(-umax, umax + 1):
            out.append((u, v))
    return np.asarray(out, dtype=np.int32)


def ic_angle_moment_kernels() -> tuple[np.ndarray, np.ndarray]:
    """Dense [31,31] kernels for computing the patch moments m10 (x-weighted)
    and m01 (y-weighted) as full-image convolutions (MXU-friendly: the per-pixel
    orientation field is two 31x31 convs instead of per-keypoint gathers)."""
    r = HALF_PATCH
    k10 = np.zeros((PATCH_SIZE, PATCH_SIZE), dtype=np.float32)
    k01 = np.zeros((PATCH_SIZE, PATCH_SIZE), dtype=np.float32)
    for (u, v) in ic_angle_offsets():
        k10[v + r, u + r] = float(u)
        k01[v + r, u + r] = float(v)
    return k10, k01


def gaussian_kernel_7x7(sigma: float = 2.0) -> np.ndarray:
    """Separable 7-tap Gaussian matching cv::GaussianBlur(Size(7,7), 2, 2)."""
    xs = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)
