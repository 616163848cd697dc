"""Build native/mapcore.cpp (repo root) with g++ and load it with ctypes.

Same build and bindings as stella_vslam_tpu/native/build.py; the library
goes into this package's `_build/native/` (listed in .gitignore), named by
the source hash, so the port reads and writes nothing outside its checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_cached = None
_lock = threading.Lock()


def _source_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", "mapcore.cpp")


def load_mapcore() -> ctypes.CDLL:
    with _lock:
        return _load()


def _load() -> ctypes.CDLL:
    global _cached
    if _cached is not None:
        return _cached
    src = _source_path()
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    cache_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build", "native")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"mapcore_{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)

    c = ctypes
    lib.store_create.restype = c.c_void_p
    lib.store_destroy.argtypes = [c.c_void_p]
    lib.store_clear.argtypes = [c.c_void_p]
    lib.store_add_obs.argtypes = [c.c_void_p, c.c_int64, c.c_int64, c.c_int32]
    lib.store_add_obs_bulk.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.POINTER(c.c_int32), c.c_int64,
    ]
    lib.store_erase_obs.argtypes = [c.c_void_p, c.c_int64, c.c_int64]
    lib.store_erase_obs.restype = c.c_int32
    lib.store_erase_landmark.argtypes = [c.c_void_p, c.c_int64]
    lib.store_num_obs.argtypes = [c.c_void_p, c.c_int64]
    lib.store_num_obs.restype = c.c_int32
    lib.store_num_obs_bulk.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_int32, c.POINTER(c.c_int32),
    ]
    lib.store_get_obs.argtypes = [
        c.c_void_p, c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int32,
    ]
    lib.store_get_obs.restype = c.c_int32
    lib.store_covis_counts.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_int32, c.c_int64,
        c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int32,
    ]
    lib.store_covis_counts.restype = c.c_int32
    lib.store_assemble_ba.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_int32,
        c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_uint8),
    ]
    lib.median_hamming_descriptor.argtypes = [c.POINTER(c.c_uint32), c.c_int32]
    lib.median_hamming_descriptor.restype = c.c_int32
    lib.store_register_keyframe.argtypes = [
        c.c_void_p, c.c_int64, c.POINTER(c.c_uint32), c.POINTER(c.c_int32),
        c.c_int32,
    ]
    lib.store_erase_keyframe_data.argtypes = [c.c_void_p, c.c_int64]
    lib.store_count_redundant.argtypes = [
        c.c_void_p, c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    _dp = c.POINTER(c.c_double)
    lib.store_batch_landmark_refresh.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_int32, _dp,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), _dp, c.c_int32, _dp,
        c.c_int32, c.c_int32, c.POINTER(c.c_uint32), _dp, _dp, _dp,
        c.POINTER(c.c_uint8),
    ]
    _cached = lib
    return lib
