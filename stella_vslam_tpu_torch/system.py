"""Public system API of the port: construction, frame feeding, results.

Port of stella_vslam_tpu/system.py for the RGBD tracking, monocular and
mapping slices: `System(cfg, device, inline_mapping=True)` with startup /
shutdown, `create_monocular_frame` / `feed_monocular_frame` and
`create_RGBD_frame` / `feed_RGBD_frame` (ORB extraction on kernels A and B,
undistortion, bearings, depth sampling for RGBD and the packed host mirror,
all on the device), `frame_poses`, and for a monocular camera the mapping
module, run inline after each feed (`enable_mapping_module`; the
`KeyframeInserter` and `Mapping` config sections). Mapping starts disabled;
mapping of stereo and RGBD keyframes is not ported, nor the loop closer;
`feed_stereo_frame` raises NotImplementedError naming its ROADMAP item.
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
from stella_vslam_tpu_torch.mapping_module import MappingModule
from stella_vslam_tpu_torch.module.keyframe_inserter import KeyframeInserter
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
            max_num_local_keyfrms=int(tr.get("max_num_local_keyfrms", 60)),
        )
        self.tracker.keyfrm_inserter = KeyframeInserter.from_yaml(
            self.camera, cfg.section("KeyframeInserter"))
        self.mapper = None
        if self.camera.setup == Setup.MONOCULAR:
            mp = cfg.section("Mapping")
            self.mapper = MappingModule(
                self.map_db, self.camera, self.orb_params, device=self.device,
                num_covisibilities_for_triangulation=int(
                    mp.get("num_covisibilities_for_landmark_generation", 10)),
                num_covisibilities_for_landmark_fusion=int(
                    mp.get("num_covisibilities_for_landmark_fusion", 10)),
                baseline_dist_thr_ratio=float(mp.get("baseline_dist_thr_ratio", 0.01)),
                baseline_dist_thr=(float(mp["baseline_dist_thr"])
                                   if "baseline_dist_thr" in mp else None),
                max_num_local_keyfrms=self.tracker.max_num_local_keyfrms)
            # culling thresholds live in the Mapping section (reference
            # local_map_cleaner.cc:9-14)
            cl = self.mapper.cleaner
            cl.redundant_obs_ratio_thr = float(mp.get("redundant_obs_ratio_thr", 0.9))
            cl.observed_ratio_thr = float(mp.get("observed_ratio_thr", 0.3))
            cl.num_reliable_keyfrms = int(mp.get("num_reliable_keyfrms", 2))
            self.tracker.mapper = self.mapper
            self.tracker.keyfrm_inserter.mapper = self.mapper
        self._running = False
        cfg.log_collapse_report()

    # ------------------------------------------------------------------
    def startup(self):
        self._running = True

    def shutdown(self):
        self._drain_mapper_inline()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._running = False

    def disable_mapping_module(self):
        self.tracker.mapping_is_enabled = False

    def enable_mapping_module(self):
        if self.mapper is None:
            raise NotImplementedError(
                "mapping of stereo and RGBD keyframes is not ported yet "
                "(ROADMAP Queue 1 item 14)")
        self.tracker.mapping_is_enabled = True

    def _drain_mapper_inline(self):
        """Run the keyframe events the last feed queued (inline mapping)."""
        if self.mapper is not None:
            self.mapper.drain()

    @property
    def local_ba_ms(self):
        """Wall ms of every local BA, assembly to writeback and publish."""
        return self.mapper.local_ba_ms if self.mapper is not None else []

    @property
    def keyframe_event_ms(self):
        """Per keyframe event, its phases in ms (MappingModule.event_ms)."""
        return self.mapper.event_ms if self.mapper is not None else []

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
        """Initialize or track one frame, then run the keyframe events it
        queued; returns its pose_cw, or None while initializing or lost."""
        pose = self.tracker.feed_frame(self.create_monocular_frame(img, timestamp, mask))
        self._drain_mapper_inline()
        return pose

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
        so keyframe refinements propagate into the trajectory; a culled
        reference keyframe forwards to the anchor its erasure recorded
        (reference trajectory_io.cc:40-57)."""
        md = self.map_db
        out = []
        for fid, ts, pose, ref, rel in self.tracker.finalized:
            if pose is not None and rel is not None and ref is not None:
                T_acc, cur, seen = rel, ref, set()
                while (cur is not None and cur not in md.keyframes
                       and cur in md.erased_kf_forward and cur not in seen):
                    seen.add(cur)
                    cur, T_fwd = md.erased_kf_forward[cur]
                    T_acc = T_acc @ T_fwd
                kf = md.keyframes.get(cur)
                if kf is not None and not kf.will_be_erased:
                    pose = T_acc @ kf.pose_cw
            out.append((ts, pose, ref, fid))
        return out
