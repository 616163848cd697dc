"""Build the Hopper kernels of `csrc/` with nvcc and bind them with ctypes.

Every `csrc/*.cu` file compiles in its own nvcc process, all started
together (`-gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -c`,
with SOURCE_FLAGS added for single sources), and one more nvcc call links
the objects into one shared library with a plain C interface. No source includes PyTorch's headers, so a build takes
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
# flags of single sources: kernel U rounds every product and sum on its own,
# as torch's elementwise operations do (no contraction into an FMA)
SOURCE_FLAGS = {"essential_5pt.cu": ["-fmad=false"]}

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
    # B, L, in_u8, in, in_stride, out, out_stride, level_tab, row_plan, nty,
    # col_plan, ntx, row_j, row_w, col_j, col_w, odd_at, buf_words, row_taps,
    # col_taps, block_rows, stream
    "svt_resize_pyramid": [_I, _I, _I, _P, _L, _P, _L, _P, _P, _I, _P, _I] + [_P] * 4
                          + [_I] * 5 + [_P],
    # B, pyr, pyr_stride, level_tab, work, nwork, smem_words, border,
    # num_slots, ini_thr, min_thr, mask, mask_w, mask_rows, mask_cols,
    # out_key, out_px, out_py, out_valid, out_resp, stream
    "svt_fast_pyramid": [_I, _P, _L, _P, _P, _I, _I, _I, _I, _F, _F, _P, _I] + [_P] * 8,
    # pyr, base, H, W, x, y, valid, K, taps49 (host memory), m10, m01, pix,
    # npix, pidx, tau, out_angle, out_desc, out_strip (or NULL), stream
    "svt_orb_describe": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _F,
                         _P, _P, _P, _P],
    # NL, NR, L, border, level_tab, level_scale, l_xy, l_level, l_desc,
    # l_valid, l_strip, r_xy, r_level, r_desc, r_valid, r_strip,
    # scale_factors, max_disp, focal_x_baseline, best_sad, disp, counters,
    # x_right, depth, stream
    "svt_stereo_match": [_I] * 4 + [_P] * 13 + [_F, _F] + [_P] * 6,
    # M, N, q_desc, t_desc, row_ok, col_ok, use_window, row_u, row_v,
    # row_xr, row_rad, row_lo, row_hi, col_u, col_v, col_xr, col_level,
    # cell_start, cell_order, inv_cell, gx, gy, use_orient, row_c, row_s,
    # col_c, col_s, cos_thr, out, stream
    "svt_hamming_top2": [_I, _I, _P, _P, _P, _P, _I] + [_P] * 12 + [_F, _I, _I, _I]
                        + [_P] * 4 + [_F, _P, _P],
    # B, N, u, v, stride, set_stride, inv_cell, gx, gy, cell_start,
    # cell_order, stream
    "svt_cell_index": [_I, _I, _P, _P, _I, _L, _F, _I, _I, _P, _P, _P],
    # model, B, N, then pos, uv, xr, inv_sigma_sq, valid each with its batch
    # stride, R0, t0, fx, fy, cx, cy, fxb, width, height, num_rounds,
    # num_robust_rounds, num_each_iter, R_out, t_out, inlier_out, chi2_out,
    # stream
    "svt_pose_lm": [_I] * 3 + [_P, _L] * 5 + [_P] * 2 + [_F] * 7 + [_I] * 3 + [_P] * 5,
    # model, N, pts1, pts2, valid, seeds (host), C, B, thr, out_model,
    # out_cost, out_count, stream
    "svt_ransac_minimal": [_I, _I, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P],
    # model, N, pts1, pts2, valid, C, B, models, costs, counts, min_inliers,
    # thr, lo_rounds, escalate, masks, part, chunk, ticket, out_model, out_mask,
    # out_cost, out_n, out_ok, stream
    "svt_ransac_finish": [_I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _F, _I, _I, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P],
    # N, pts1, pts2, mask, part, out, stream
    "svt_ransac_normalization": [_I] + [_P] * 6,
    # N, b1, b2, valid, B, models, ok, out_cost, out_count, stream
    "svt_ransac_score": [_I, _P, _P, _P, _I] + [_P] * 5,
    # N, b1, b2, valid, seed, B, theta, probe, out_idx, out_E, out_ok, stream
    "svt_essential_5pt": [_I, _P, _P, _P, _U, _I] + [_P] * 6,
    # model, K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier,
    # lm_valid, lm_fixed, cam_free, fx, fy, cx, cy, fxb, width, height,
    # cam_R, cam_t, lm, use_huber, ctrl, Wg, lmblk, hc, S, rhs, blocks, part,
    # stream
    # (then F's index and scratch pointers as a host array, cap_t, cap_s)
    "svt_ba_linearize": [_I, _I, _I, _I] + [_P] * 9 + [_F] * 7 + [_P] * 3
                        + [_I] + [_P] * 6 + [_I] + [_P] * 2 + [_L, _I, _P],
    # the same without hc, S, rhs: F's launches without the reduce (one shard)
    "svt_ba_linearize_part": [_I, _I, _I, _I] + [_P] * 9 + [_F] * 7 + [_P] * 3
                             + [_I] + [_P] * 3 + [_I] + [_P] * 2 + [_L, _I, _P],
    # K, L, D, obs_cam, obs_valid, lm_valid, lm_fixed, F's pointers (host
    # array), cap_t, cap_s, key0, key1, val1, stream
    "svt_ba_schur_index": [_I] * 3 + [_P] * 5 + [_L, _I] + [_P] * 4,
    # K, cam_free, cam_R, cam_t, ctrl, hc, S, rhs, dx, cam_Rn, cam_tn, scratch,
    # scratch_floats, stream
    "svt_ba_solve": [_I] + [_P] * 11 + [_L, _P],
    # n, A, b, x, scratch, scratch_floats, stream
    "svt_spd_solve": [_I] + [_P] * 4 + [_L, _P],
    # model, K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, inlier,
    # lm_valid, lm_fixed, cam_free, fx, fy, cx, cy, fxb, width, height,
    # cam_R, cam_t, lm, use_huber, ctrl, tickets, Wg, lmblk, dx, cam_Rn,
    # cam_tn, lmn, cost_l, cost_part, decide, stream
    "svt_ba_backsub": [_I, _I, _I, _I] + [_P] * 9 + [_F] * 7 + [_P] * 3
                      + [_I] + [_P] * 10 + [_I, _P],
    # mode, K, L, nshards, parts (host array), blocks (host array), ctrl, hc,
    # S, rhs, cam_R, cam_t, lm, cam_Rn, cam_tn, lmn, stream
    "svt_ba_shard_assemble": [_I] * 4 + [_P] * 13,
    # device, peer
    "svt_enable_peer_access": [_I, _I],
    # model, K, L, D, obs_cam, obs_uv, obs_xr, obs_isig, obs_valid, fx, fy,
    # cx, cy, fxb, width, height, cam_R, cam_t, lm, keep, mode, out, stream
    "svt_ba_classify": [_I, _I, _I, _I] + [_P] * 5 + [_F] * 7 + [_P] * 4 + [_I]
                       + [_P] * 2,
    # B, N2, E, col_epl, col_norm, col_ok, bins, off_plane, min_norm,
    # basis, start, order, stream
    "svt_epipolar_band_index": [_I, _I] + [_P] * 4 + [_I, _F, _F] + [_P] * 4,
    # B, N1, N2, q_desc, row_c, row_s, row_bear, row_thr, row_ok,
    # row_stereo, t_desc, col_c, col_s, col_epl, col_norm, col_ok,
    # col_near, cos_thr, bins, tau, basis, start, order, out, stream
    "svt_epipolar_top2": [_I, _I, _I] + [_P] * 14 + [_F, _I, _F] + [_P] * 5,
    # model, B, N1, N2, uv1, lvl1, bear1, uv2, lvl2, bear2, poses, match,
    # accepted, pair_valid, fx, fy, cx, cy, width, height, sigma_sq,
    # scale_factors, pos_out, idx_out, ok_out, stream
    "svt_triangulate": [_I, _I, _I, _I] + [_P] * 10 + [_F] * 6 + [_P] * 6,
    # model, B, N, M, kp_uv, kp_level, kp_desc, kp_valid, kp_xr, poses,
    # kf_valid, lm_f, lm_desc, lm_valid, fx, fy, cx, cy, width, height, fxb,
    # scale_factors, sigma_sq, num_levels, inv_log_scale, dmin_scale, margin,
    # cell_start, cell_order, inv_cell, gx, gy, out, gate_out, stream
    "svt_fuse": [_I, _I, _I, _I] + [_P] * 10 + [_F] * 7 + [_P] * 2 + [_I] + [_F] * 3
                + [_P] * 2 + [_F, _I, _I] + [_P] * 3,
    # N, nblocks, m_k, max_depth, desc, centers, node_info, n_children, out,
    # stream
    "svt_fbow_transform": [_I] * 4 + [_P] * 6,
    # N, bearings, pos_w, max_cos, valid, seed, B, out_R, out_t, out_ok,
    # out_cost, out_count, stream
    "svt_pnp_ransac": [_I] + [_P] * 4 + [_U, _I] + [_P] * 6,
    # N, pts1, pts2, obs1, obs2, isig1, isig2, valid, R0, t0, s0, fx, fy, cx,
    # cy, chi_sq, fix_scale, num_iter, out, inlier, stream
    "svt_sim3_transform": [_I] + [_P] * 10 + [_F] * 5 + [_I] * 2 + [_P] * 3,
    # K, E, edge_i, edge_j, edge_valid, inc, deg, stream
    "svt_pose_graph_index": [_I, _I] + [_P] * 6,
    # K, E, s, R, t, fixed, valid, edge_i, edge_j, edge_s, edge_R, edge_t,
    # edge_valid, inc, deg, Hd, b, cost, terms, stream
    "svt_pose_graph_linearize": [_I, _I] + [_P] * 18,
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
    # model, M, mode, fx, fy, cx, cy, width, height, fxb, R, t, pos, tbl_u32,
    # last_level, last_valid, scale_factors, margin, inv_log_scale, num_levels,
    # u, v, xr, rad, lo, hi, pred, valid, stream
    "svt_window_rows": [_I, _I, _I] + [_F] * 7 + [_P] * 7 + [_F, _F, _I] + [_P] * 9,
    # model, N, fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, pts, out, bear, stream
    "svt_undistort": [_I, _I] + [_F] * 10 + [_P] * 4,
    # model, feed, N, fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, rcp_w, rcp_h,
    # fxb, xy, level, angle, valid, response, desc, xr_in, d_in, depth_map,
    # H, W, inv_factor, und, bear, xr_out, d_out, packed, stream
    "svt_frame_finish": [_I] * 3 + [_F] * 13 + [_P] * 9 + [_I, _I, _F] + [_P] * 6,
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
        h.update(" ".join(NVCC_FLAGS).encode() + repr(sorted(SOURCE_FLAGS.items())).encode())
        so_path = os.path.join(BUILD_DIR, f"libsvt_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cu = [s for s in srcs if s.endswith(".cu")]
            objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
            nvcc = _nvcc()
            t0 = time.monotonic()
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(s), []), "-I", CSRC_DIR,
                 "-c", "-o", o, s],
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
