"""Public system API of the port: construction, frame feeding, results.

Port of stella_vslam_tpu/system.py for the RGBD tracking and monocular
slices: `System(cfg, device, inline_mapping=True)` with startup / shutdown,
`create_monocular_frame` / `feed_monocular_frame` and `create_RGBD_frame` /
`feed_RGBD_frame` (ORB extraction on kernels A and B, undistortion,
bearings, depth sampling for RGBD and the packed host mirror, all on the
device) and `frame_poses`. The mapping module is not ported yet, so the
system runs with mapping disabled; `feed_stereo_frame` raises
NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import Camera, Setup, camera_from_yaml
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.data.frame import Frame, pack_host_cols
from stella_vslam_tpu_torch.data.map_database import MapDatabase
from stella_vslam_tpu_torch.feature.orb_extractor import OrbExtractor
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.tracking_module import TrackingModule


class System:
    def __init__(self, cfg: Config, device="cuda", inline_mapping: bool = True):
        """`device`: where every per-frame tensor lives ("cuda" runs the
        kernels; "cpu" runs their plain versions). Only the synchronous
        (inline_mapping=True) mode is ported."""
        if not inline_mapping:
            raise NotImplementedError(
                "threaded mapping is not ported yet (ROADMAP Queue 1 item 10)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.inline_mapping = inline_mapping
        self.camera: Camera = camera_from_yaml(cfg.section("Camera"))
        self.orb_params = OrbParams.from_yaml(cfg.section("Feature"))
        pre = cfg.section("Preprocessing")
        min_size = int(pre.get("min_size", 800))
        if pre.get("mask_rectangles", None):
            raise NotImplementedError(
                "extraction masks are not ported yet (ROADMAP Queue 1 item 14)")
        self.depthmap_factor = float(pre.get("depthmap_factor", 1.0))
        if self.depthmap_factor <= 0.0:
            raise ValueError("depthmap_factor must be greater than 0")
        self.map_db = MapDatabase(device=self.device)
        self.extractor = OrbExtractor(
            self.orb_params, self.camera.width, self.camera.height,
            min_area=min_size,
            descriptor_pattern=str(cfg.get("Feature", "descriptor_pattern", "native")),
            device=self.device)
        tr = cfg.section("Tracking")
        self.tracker = TrackingModule(
            self.map_db, self.camera, self.orb_params, device=self.device,
            use_fixed_seed=bool(cfg.get("Initializer", "use_fixed_seed", False)),
            margin_last_frame_projection=float(
                tr.get("margin_last_frame_projection", 20.0)),
            margin_local_map_projection=float(
                tr.get("margin_local_map_projection", 5.0)),
        )
        self._running = False
        cfg.log_collapse_report()

    # ------------------------------------------------------------------
    def startup(self):
        self._running = True

    def shutdown(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._running = False

    def disable_mapping_module(self):
        self.tracker.mapping_is_enabled = False

    def enable_mapping_module(self):
        raise NotImplementedError(
            "the mapping module is not ported yet (ROADMAP Queue 1 item 9)")

    # ------------------------------------------------------------------
    def create_monocular_frame(self, img, timestamp: float, mask=None) -> Frame:
        """Extraction, undistortion, bearings and the packed host mirror of
        one gray image (the RGBD preprocess with x_right and depth at -1)."""
        if self.camera.setup != Setup.MONOCULAR:
            raise ValueError("feed_monocular_frame needs a camera with setup monocular")
        feats, und, bear = self._extract(img, mask)
        frm = Frame(timestamp, self.camera, self.orb_params, feats, und, bear)
        frm.attach_packed_host(pack_host_cols(
            feats.xy, und, bear, feats.level, feats.angle, feats.valid,
            feats.response, frm.x_right, frm.depths, feats.desc))
        return frm

    def feed_monocular_frame(self, img, timestamp: float, mask=None):
        """Initialize or track one frame; returns its pose_cw, or None while
        initializing or lost."""
        return self.tracker.feed_frame(
            self.create_monocular_frame(img, timestamp, mask))

    def feed_stereo_frame(self, img_left, img_right, timestamp: float, mask=None):
        raise NotImplementedError(
            "stereo matching is not ported yet (ROADMAP Queue 1 item 14)")

    def create_RGBD_frame(self, img, depth, timestamp: float, mask=None) -> Frame:
        """Extraction, undistortion, bearings, depth sampling and the packed
        host mirror for one gray image and its raw depth map."""
        if self.camera.setup != Setup.RGBD:
            raise ValueError("feed_RGBD_frame needs a camera with setup RGBD")
        feats, und, bear = self._extract(img, mask)
        cam = self.camera
        depth_map = torch.from_numpy(np.asarray(depth, np.float32)).to(self.device)
        h, w = depth_map.shape
        xs = torch.clamp(feats.xy[:, 0].to(torch.int64), 0, w - 1)
        ys = torch.clamp(feats.xy[:, 1].to(torch.int64), 0, h - 1)
        # raw units -> meters (reference image_converter.cc convert_to_true_depth)
        d = depth_map[ys, xs] * (1.0 / self.depthmap_factor)
        neg = torch.full_like(d, -1.0)
        d = torch.where(feats.valid & (d > 0), d, neg)
        x_right = torch.where(
            d > 0, und[:, 0] - cam.params.focal_x_baseline / torch.clamp(d, min=1e-6),
            neg)
        frm = Frame(timestamp, cam, self.orb_params, feats, und, bear,
                    x_right=x_right, depths=d)
        frm.attach_packed_host(pack_host_cols(
            feats.xy, und, bear, feats.level, feats.angle, feats.valid,
            feats.response, x_right, d, feats.desc))
        return frm

    def feed_RGBD_frame(self, img, depth, timestamp: float, mask=None):
        """Track one frame; returns its pose_cw, or None when lost."""
        return self.tracker.feed_frame(
            self.create_RGBD_frame(img, depth, timestamp, mask))

    def _extract(self, img, mask):
        """(features, undistorted keypoints, bearings) of one image."""
        if mask is not None:
            raise NotImplementedError(
                "extraction masks are not ported yet (ROADMAP Queue 1 item 14)")
        image = torch.from_numpy(self._to_gray(img)).to(self.device, non_blocking=True)
        feats = self.extractor.extract(image)
        und = self.camera.undistort(feats.xy)
        return feats, und, self.camera.bearings(und)

    @staticmethod
    def _to_gray(img) -> np.ndarray:
        img = np.asarray(img)
        if img.ndim != 2:
            raise NotImplementedError(
                "the port accepts gray images only (color conversion needs "
                "cv2, which it does not use)")
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        return np.ascontiguousarray(img)

    # ------------------------------------------------------------------
    @property
    def frame_poses(self):
        """Per-frame results (timestamp, pose_cw|None, ref_kf, frame id);
        poses are rebuilt from the relative-to-reference-keyframe transform
        so keyframe refinements propagate into the trajectory."""
        md = self.map_db
        out = []
        for fid, ts, pose, ref, rel in self.tracker.finalized:
            if pose is not None and rel is not None and ref is not None:
                kf = md.keyframes.get(ref)
                if kf is not None and not kf.will_be_erased:
                    pose = rel @ kf.pose_cw
            out.append((ts, pose, ref, fid))
        return out
