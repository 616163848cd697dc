"""Per-frame record: device tensors for the hot path + host mirrors for policy.

Port of stella_vslam_tpu/data/frame.py. The keypoint SoA arrays (features,
undistorted keypoints, bearings, stereo/depth columns) live on the device;
landmark associations and the pose live on the host. The host mirror of all
per-keypoint columns is ONE packed [N,21] f32 buffer (`pack_host_cols`)
copied device-to-host once per frame, into pinned memory without blocking;
the first `h_*` read waits for that copy's event.

`frame_finish` is what the JAX System's jitted `_mono_preprocess` and
`_rgbd_preprocess` (stella_vslam_tpu/system.py:178-189, :486-505) compute
after the extraction, in the same program: the undistortion, the bearings,
x_right and the depths (-1, kernel T's, or sampled from the depth map) and
the packed host-mirror rows. On CUDA tensors it is one launch of kernel R's
frame finish (csrc/reproject.cu); on CPU tensors its plain version,
`frame_finish_plain`, the torch expressions.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import (
    Camera, CameraModel, f32_reciprocal, undistort_and_bearings_plain, undistortion_mode)
from stella_vslam_tpu_torch.feature.orb_extractor import FrameFeatures
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.kernels import build as kbuild


def pack_host_cols(xy, undist, bearings, level, angle, valid, response,
                   x_right, depths, desc):
    """[N,21] f32: xy(2) undist(2) bearings(3) level angle valid response
    x_right depths (1 each) + desc(8, int32 bits viewed as f32)."""
    col = lambda t: t.to(torch.float32)[:, None]
    return torch.cat([xy, undist, bearings, col(level), col(angle), col(valid),
                      col(response), col(x_right), col(depths),
                      desc.contiguous().view(torch.float32)], dim=1)


class FrameFinish(NamedTuple):
    """A frame's keypoint columns after its extraction."""

    undist_xy: torch.Tensor  # [N,2] f32 (the keypoints themselves, equirectangular)
    bearings: torch.Tensor  # [N,3] f32
    x_right: torch.Tensor  # [N] f32, -1 where none
    depths: torch.Tensor  # [N] f32, -1 where none
    packed: torch.Tensor  # [N,21] f32, pack_host_cols


def frame_finish_plain(camera: Camera, feats: FrameFeatures, *, x_right=None, depths=None,
                       depth_map=None, inv_depth_factor: float = 1.0) -> FrameFinish:
    """Plain version of kernel R's frame finish. Mono: x_right and depths
    -1; stereo: kernel T's `x_right` and `depths` as given; RGBD: the raw
    `depth_map` [H,W] f32 sampled at each keypoint's pixel (truncated, then
    clamped) times `inv_depth_factor` (raw units -> meters, reference
    image_converter.cc convert_to_true_depth), -1 unless the slot is valid
    and the depth positive, and x_right = und_x - fxb / d."""
    cam = camera.params
    und, bear = undistort_and_bearings_plain(camera.model, cam, feats.xy)
    if depth_map is not None:
        h, w = depth_map.shape
        xs = torch.clamp(feats.xy[:, 0].to(torch.int64), 0, w - 1)
        ys = torch.clamp(feats.xy[:, 1].to(torch.int64), 0, h - 1)
        d = depth_map[ys, xs] * inv_depth_factor
        neg = torch.full_like(d, -1.0)
        depths = torch.where(feats.valid & (d > 0), d, neg)
        # fxb / d a true division, as the JAX version's (its divisor
        # varies): torch's `float / tensor` would take the reciprocal
        fxb = torch.full_like(depths, cam.focal_x_baseline)
        x_right = torch.where(depths > 0, und[:, 0] - fxb / torch.clamp(depths, min=1e-6), neg)
    elif x_right is None:
        x_right = depths = torch.full((feats.num_slots,), -1.0, dtype=torch.float32,
                                      device=feats.xy.device)
    return FrameFinish(und, bear, x_right, depths, pack_host_cols(
        feats.xy, und, bear, feats.level, feats.angle, feats.valid, feats.response, x_right,
        depths, feats.desc))


_FEED_MONO, _FEED_STEREO, _FEED_RGBD = 1, 2, 3


def frame_finish(camera: Camera, feats: FrameFeatures, *, x_right=None, depths=None,
                 depth_map=None, inv_depth_factor: float = 1.0) -> FrameFinish:
    """Kernel R's frame finish on CUDA tensors, one launch a frame: the
    undistorted keypoints, the bearings, x_right and the depths, and the
    packed host-mirror rows, equal to `frame_finish_plain` on the card bit
    for bit; the plain version on CPU tensors (same arguments)."""
    xy = feats.xy
    if not xy.is_cuda:
        return frame_finish_plain(camera, feats, x_right=x_right, depths=depths,
                                  depth_map=depth_map, inv_depth_factor=inv_depth_factor)
    n, dev = feats.num_slots, xy.device
    f32, i32 = torch.float32, torch.int32
    stereo = x_right is not None
    ins = [(xy, (n, 2), f32), (feats.level, (n,), i32), (feats.angle, (n,), f32),
           (feats.valid, (n,), torch.bool), (feats.response, (n,), f32),
           (feats.desc, (n, 8), i32)]
    if stereo:
        ins += [(x_right, (n,), f32), (depths, (n,), f32)]
    if depth_map is not None:
        ins.append((depth_map, tuple(depth_map.shape), f32))
    for t, shape, dt in ins:
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"frame_finish: expects contiguous {dt} {shape} tensors on the "
                             "keypoints' device")
    if feats.desc.data_ptr() % 16 or (depth_map is not None and (stereo or depth_map.dim() != 2)):
        raise ValueError("frame_finish: a 16-byte aligned descriptor table; a 2-D depth map, "
                         "and not with stereo inputs")
    model = camera.model
    equirect = model == CameraModel.EQUIRECTANGULAR
    p = camera.params
    und = xy if equirect else torch.empty((n, 2), dtype=f32, device=dev)
    bear = torch.empty((n, 3), dtype=f32, device=dev)
    packed = torch.empty((n, 21), dtype=f32, device=dev)
    cols = None if stereo else torch.empty((2, n), dtype=f32, device=dev)
    feed = _FEED_STEREO if stereo else _FEED_RGBD if depth_map is not None else _FEED_MONO
    H, W = depth_map.shape if depth_map is not None else (0, 0)
    lib = kbuild.load()
    kbuild.check(lib.svt_frame_finish(
        undistortion_mode(model), feed, n, p.fx, p.fy, p.cx, p.cy, p.k1, p.k2, p.p1, p.p2, p.k3,
        p.k4, f32_reciprocal(p.width) if equirect else 0.0,
        f32_reciprocal(p.height) if equirect else 0.0, p.focal_x_baseline, xy.data_ptr(),
        feats.level.data_ptr(), feats.angle.data_ptr(), feats.valid.data_ptr(),
        feats.response.data_ptr(), feats.desc.data_ptr(), x_right.data_ptr() if stereo else 0,
        depths.data_ptr() if stereo else 0,
        depth_map.data_ptr() if depth_map is not None else 0, H, W,
        float(np.float32(inv_depth_factor)), 0 if equirect else und.data_ptr(),
        bear.data_ptr(), 0 if stereo else cols[0].data_ptr(),
        0 if stereo else cols[1].data_ptr(), packed.data_ptr(), kbuild.stream_ptr(dev)),
        "frame_finish")
    frame_finish.launches += 1
    if not stereo:
        x_right, depths = cols[0], cols[1]
    return FrameFinish(und, bear, x_right, depths, packed)


frame_finish.launches = 0


class Frame:
    _next_id = 0

    def __init__(self, timestamp: float, camera: Camera, orb_params: OrbParams,
                 feats: FrameFeatures, undist_xy: torch.Tensor,
                 bearings: torch.Tensor, x_right: Optional[torch.Tensor] = None,
                 depths: Optional[torch.Tensor] = None):
        self.id = Frame._next_id
        Frame._next_id += 1
        self.timestamp = timestamp
        self.camera = camera
        self.orb_params = orb_params
        self.feats = feats
        self.undist_xy = undist_xy
        self.bearings = bearings
        n = feats.num_slots
        neg1 = None
        if x_right is None or depths is None:
            neg1 = torch.full((n,), -1.0, dtype=torch.float32,
                              device=undist_xy.device)
        self.x_right = x_right if x_right is not None else neg1
        self.depths = depths if depths is not None else neg1

        # host-side state
        self.num_slots = n
        self.lm_ids = np.full(n, -1, dtype=np.int64)
        self.pose_cw: Optional[np.ndarray] = None  # 4x4
        self.ref_keyfrm_id: Optional[int] = None

        self._host_cache: dict = {}
        self._packed_host = None
        self._packed_event = None
        # the threads of the threaded System may read a keyframe's mirror
        # for the first time at once
        self._host_lock = threading.Lock()

    # ---- host mirrors (one packed copy, unpacked on first read) ----
    def attach_packed_host(self, packed: torch.Tensor):
        """Start the ONE device-to-host copy of an [N,21] host-mirror pack
        (into pinned memory, without blocking); `h_*` reads wait for it."""
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            self._packed_event = torch.cuda.Event()
            self._packed_event.record()
            self._packed_host = host
        else:
            self._packed_host = packed

    def prefetch_host(self):
        self.attach_packed_host(pack_host_cols(
            self.feats.xy, self.undist_xy, self.bearings, self.feats.level,
            self.feats.angle, self.feats.valid, self.feats.response,
            self.x_right, self.depths, self.feats.desc))

    def _unpack_host(self):
        if self._packed_event is not None:
            self._packed_event.synchronize()
        buf = self._packed_host.numpy()
        c = self._host_cache
        c["xy"] = buf[:, 0:2]
        c["undist_xy"] = buf[:, 2:4]
        c["bearings"] = buf[:, 4:7]
        c["level"] = buf[:, 7].astype(np.int32)
        c["angle"] = buf[:, 8]
        c["valid"] = buf[:, 9] > 0.5
        c["response"] = buf[:, 10]
        c["x_right"] = buf[:, 11]
        c["depths"] = buf[:, 12]
        c["desc"] = np.ascontiguousarray(buf[:, 13:21]).view(np.uint32)
        self._packed_host = None
        self._packed_event = None

    def _host(self, name):
        if name not in self._host_cache:
            with self._host_lock:
                if name not in self._host_cache:
                    if self._packed_host is None:
                        self.prefetch_host()
                    self._unpack_host()
        return self._host_cache[name]

    @property
    def h_xy(self):
        return self._host("xy")

    @property
    def h_undist_xy(self):
        return self._host("undist_xy")

    @property
    def h_bearings(self):
        return self._host("bearings")

    @property
    def h_level(self):
        return self._host("level")

    @property
    def h_angle(self):
        return self._host("angle")

    @property
    def h_valid(self):
        return self._host("valid")

    @property
    def h_desc(self):
        return self._host("desc")

    @property
    def h_x_right(self):
        return self._host("x_right")

    @property
    def h_depths(self):
        return self._host("depths")

    @property
    def h_response(self):
        return self._host("response")

    def add_landmark(self, lm_id: int, idx: int):
        self.lm_ids[idx] = lm_id

    # ---- pose helpers ----
    def set_pose_cw(self, pose_cw: np.ndarray):
        self.pose_cw = np.asarray(pose_cw, dtype=np.float64)

    @property
    def rot_cw(self) -> np.ndarray:
        return self.pose_cw[:3, :3]

    @property
    def trans_cw(self) -> np.ndarray:
        return self.pose_cw[:3, 3]

    @property
    def cam_center(self) -> np.ndarray:
        return -self.rot_cw.T @ self.trans_cw
