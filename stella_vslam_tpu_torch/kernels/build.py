"""Build the Hopper kernels of `csrc/` with nvcc and bind them with ctypes.

Every `csrc/*.cu` file compiles in its own nvcc process, all started
together (`-gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -c`),
and one more nvcc call links the objects into one shared library with a
plain C interface. No source includes PyTorch's headers, so a build takes
seconds instead of minutes. The library goes into `_build/kernels/` inside
the package (listed in .gitignore), named by a hash of the sources, and is
built at the first launch of any kernel — never at import, since machines
without nvcc import every module too.

Every C entry point takes device pointers and the CUDA stream as integers,
launches on that stream, does not synchronise, and returns
`cudaGetLastError()`; `check()` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# seconds the nvcc calls took in this process (0.0 when the library was found
# already built) and the compiler's register / shared-memory report
build_seconds = 0.0
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong

# argument types of every C entry point (pointers and the stream as void*)
_SIGNATURES = {
    # B, src, batch_stride, w_in, dst, h_out, w_out, row_j, row_w, col_j,
    # col_w, stream
    "svt_resize_level": [_I, _P, _L, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    # B, img, img_stride, H, W, border, cs, Gy, Gx, ini_thr, min_thr,
    # out_key, stream
    "svt_fast_nms": [_I, _P, _L, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P],
    # pyr, base, H, W, x, y, valid, K, taps49, m10, m01, offsets, tau,
    # out_angle, out_desc, out_strip (or NULL), stream
    "svt_orb_describe": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _F,
                         _P, _P, _P, _P],
    # NL, NR, l_xy, l_level, l_desc, l_valid, l_strip, r_xy, r_level,
    # r_desc, r_valid, r_strip, scale_factors, max_disp, focal_x_baseline,
    # best_sad, disp, matched, x_right, depth, stream
    "svt_stereo_match": [_I, _I] + [_P] * 11 + [_F, _F] + [_P] * 6,
    # M, N, q_desc, t_desc, row_ok, col_ok, use_window, row_u, row_v,
    # row_xr, row_rad, row_lo, row_hi, col_u, col_v, col_xr, col_level,
    # use_orient, row_c, row_s, col_c, col_s, cos_thr, out, stream
    "svt_hamming_top2": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _I, _P, _P, _P, _P, _F, _P, _P],
    # N, pos, uv, xr, inv_sigma_sq, valid, R0, t0, fx, fy, cx, cy, fxb,
    # num_rounds, num_robust_rounds, num_each_iter, R_out, t_out,
    # inlier_out, chi2_out, stream
    "svt_pose_lm": [_I, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F,
                    _I, _I, _I, _P, _P, _P, _P, _P],
    # model, N, pts1, pts2, valid, seed, B, thr, out_model, out_cost,
    # out_count, stream
    "svt_ransac_minimal": [_I, _I, _P, _P, _P, _U, _I, _F, _P, _P, _P, _P],
    # model, N, pts1, pts2, valid, B, models, costs, counts, min_inliers,
    # thr, out_model, out_mask, out_cost, out_ok, stream
    "svt_ransac_select": [_I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _F, _P, _P,
                          _P, _P, _P],
    # model, N, pts1, pts2, valid, mask_in, thr, out_model, out_mask, stream
    "svt_ransac_refit": [_I, _I, _P, _P, _P, _P, _F, _P, _P, _P],
    # K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier,
    # lm_valid, lm_fixed, cam_free, fx, fy, cx, cy, fxb, cam_R, cam_t, lm,
    # use_huber, ctrl, Wg, lmblk, hc, S, rhs, blocks, part, stream
    "svt_ba_linearize": [_I, _I, _I] + [_P] * 9 + [_F] * 5 + [_P] * 3
                        + [_I] + [_P] * 6 + [_I] + [_P] * 2,
    # K, cam_free, cam_R, cam_t, ctrl, hc, S, rhs, dx, cam_Rn, cam_tn, scratch,
    # stream
    "svt_ba_solve": [_I] + [_P] * 12,
    # K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier,
    # lm_valid, lm_fixed, cam_free, fx, fy, cx, cy, fxb, cam_R, cam_t, lm,
    # use_huber, ctrl, counter, Wg, lmblk, dx, cam_Rn, cam_tn, lmn, cost_part,
    # stream
    "svt_ba_backsub": [_I, _I, _I] + [_P] * 9 + [_F] * 5 + [_P] * 3
                      + [_I] + [_P] * 10,
    # K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, fx, fy, cx, cy,
    # fxb, cam_R, cam_t, lm, keep, mode, out, stream
    "svt_ba_classify": [_I, _I, _I] + [_P] * 5 + [_F] * 5 + [_P] * 4 + [_I]
                       + [_P] * 2,
    # B, N1, N2, q_desc, row_f, row_flag, t_desc, col_f, col_flag, cos_thr,
    # out, stream
    "svt_epipolar_top2": [_I, _I, _I] + [_P] * 6 + [_F] + [_P] * 2,
    # B, N1, N2, uv1, lvl1, bear1, uv2, lvl2, bear2, poses, match, accepted,
    # pair_valid, fx, fy, cx, cy, width, height, sigma_sq, scale_factors,
    # num_levels, pos_out, idx_out, ok_out, stream
    "svt_triangulate": [_I, _I, _I] + [_P] * 10 + [_F] * 6 + [_P] * 2 + [_I]
                       + [_P] * 4,
    # B, N, M, kp_uv, kp_level, kp_desc, kp_valid, kp_xr, poses, kf_valid,
    # lm_f, lm_desc, lm_valid, fx, fy, cx, cy, width, height, fxb,
    # scale_factors, sigma_sq, num_levels, log_scale, margin, out, stream
    "svt_fuse": [_I, _I, _I] + [_P] * 10 + [_F] * 7 + [_P] * 2 + [_I] + [_F] * 2
                + [_P] * 2,
    # N, desc, centers, out, stream
    "svt_bow_transform": [_I] + [_P] * 4,
    # N, bearings, pos_w, max_cos, valid, seed, B, out_R, out_t, out_ok,
    # out_cost, out_count, stream
    "svt_pnp_ransac": [_I] + [_P] * 4 + [_U, _I] + [_P] * 6,
    # N, pts1, pts2, obs1, obs2, isig1, isig2, valid, R0, t0, s0, fx, fy, cx,
    # cy, chi_sq, fix_scale, num_iter, out, inlier, stream
    "svt_sim3_transform": [_I] + [_P] * 10 + [_F] * 5 + [_I] * 2 + [_P] * 3,
    # K, E, s, R, t, fixed, valid, edge_i, edge_j, edge_s, edge_R, edge_t,
    # edge_valid, Hd, b, cost, terms, stream
    "svt_pose_graph_linearize": [_I, _I] + [_P] * 16,
    # K, s, R, t, fixed, valid, x, s2, R2, t2, stream
    "svt_pose_graph_update": [_I] + [_P] * 10,
    # M, N, best_idx, idx_stride, accepted, src_pos, pos_stride, src_id,
    # id_stride, pos_out, id_out, has_out, stream
    "svt_scatter_to_current": [_I, _I, _P, _I, _P, _P, _I, _P, _I] + [_P] * 4,
    # N, has, ids, score, keep_out, ids_out, stream
    "svt_dedup_by_id": [_I] + [_P] * 6,
    # N, C, la_pos, la_valid, la_id, tbl_f32, tbl_u32, A_R, A_t, R_last,
    # t_last, R_prev, t_prev, pos_out, valid_out, id_out, pose_out, stream
    "svt_rebase_chain": [_I, _I] + [_P] * 16,
    # M, mode, fx, fy, cx, cy, width, height, fxb, Rt, pos, tbl_u32,
    # log_scale, num_levels, uv, depth, vis, xr, scale, stream
    "svt_reproject": [_I, _I] + [_F] * 7 + [_P] * 3 + [_F, _I] + [_P] * 6,
    # N, fx, fy, cx, cy, k1, k2, p1, p2, k3, pts, out, stream
    "svt_undistort": [_I] + [_F] * 9 + [_P] * 3,
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha1()
        for s in srcs:
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        so_path = os.path.join(BUILD_DIR, f"libsvt_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cu = [s for s in srcs if s.endswith(".cu")]
            objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
            nvcc = _nvcc()
            t0 = time.monotonic()
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", o, s],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(cu, objs)]
            build_log = "".join(p.communicate()[0] for p in procs)
            failed = [s for s, p in zip(cu, procs) if p.returncode != 0]
            if not failed:
                link = subprocess.run(
                    [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                     "-o", tmp, *objs], capture_output=True, text=True)
                build_log += link.stdout + link.stderr
                if link.returncode != 0:
                    failed = ["(link)"]
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
            build_seconds = time.monotonic() - t0
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
