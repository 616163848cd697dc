"""Per-frame record: device tensors for the hot path + host mirrors for policy.

Port of stella_vslam_tpu/data/frame.py. The keypoint SoA arrays (features,
undistorted keypoints, bearings, stereo/depth columns) live on the device;
landmark associations and the pose live on the host. The host mirror of all
per-keypoint columns is ONE packed [N,21] f32 buffer (`pack_host_cols`)
copied device-to-host once per frame, into pinned memory without blocking;
the first `h_*` read waits for that copy's event.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import Camera
from stella_vslam_tpu_torch.feature.orb_extractor import FrameFeatures
from stella_vslam_tpu_torch.feature.orb_params import OrbParams


def pack_host_cols(xy, undist, bearings, level, angle, valid, response,
                   x_right, depths, desc):
    """[N,21] f32: xy(2) undist(2) bearings(3) level angle valid response
    x_right depths (1 each) + desc(8, int32 bits viewed as f32)."""
    col = lambda t: t.to(torch.float32)[:, None]
    return torch.cat([xy, undist, bearings, col(level), col(angle), col(valid),
                      col(response), col(x_right), col(depths),
                      desc.contiguous().view(torch.float32)], dim=1)


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
