"""Build the Hopper kernels of `csrc/` with nvcc and bind them with ctypes.

All `csrc/*.cu` files compile, in one nvcc call, into one shared library with
a plain C interface (`-gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`). No source includes PyTorch's headers, so a build takes
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# seconds the nvcc call took in this process (0.0 when the library was found
# already built) and the compiler's register / shared-memory report
build_seconds = 0.0
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument types of every C entry point (pointers and the stream as void*)
_SIGNATURES = {
    # img, H, W, border, cs, Gy, Gx, ini_thr, min_thr, out_key, stream
    "svt_fast_nms": [_P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P],
    # pyr, base, H, W, x, y, valid, K, taps49, m10, m01, offsets, tau,
    # out_angle, out_desc, stream
    "svt_orb_describe": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _F,
                         _P, _P, _P],
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
            t0 = time.monotonic()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, *cu],
                capture_output=True, text=True)
            build_seconds = time.monotonic() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{build_log}")
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
