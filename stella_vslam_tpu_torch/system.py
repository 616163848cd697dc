"""Public system API of the port: construction, frame feeding, results.

Port of stella_vslam_tpu/system.py for the monocular, stereo and RGBD
setups: `System(cfg, device="cuda", inline_mapping=False, vocab_path=None)`
with `startup(need_initialize, warmup)` / `shutdown`,
`create_monocular_frame` / `feed_monocular_frame`, `create_stereo_frame` /
`feed_stereo_frame` and `create_RGBD_frame` / `feed_RGBD_frame` (ORB
extraction on kernels S, A and B, for a stereo pair both images in each
launch, the row matching on kernel T, undistortion on kernel R, bearings,
depth sampling for RGBD and the packed host mirror, all on the device; a
`StereoRectifier` config section rectifies raw stereo pairs on the device
first), `frame_poses`, the publishers, the mapping module (the
`KeyframeInserter` and `Mapping` config sections) with the BoW vocabulary
and database and the global optimization module behind it (the
`LoopDetector` section; `enable_loop_detector`, `request_loop_closure`,
`loop_BA_is_running`, `abort_loop_BA`).

By default the System is threaded, as the JAX package's is: the tracker
pipelines its frames behind a finalize thread, the mapper runs keyframe
events on its own thread and the loop closer on a third, each issuing its
device work on a CUDA stream of its own, and every exception a worker
thread contains is counted in `worker_errors`. `inline_mapping=True` is the
deterministic mode the parity tests use: every frame is finalized, and the
keyframe events and loop corrections it queued run to their end, before
its feed returns. Mapping starts enabled, as in the JAX package
(`disable_mapping_module` makes a tracking-only System). Not ported: the
relocalizer, map IO, extraction masks and color input.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from stella_vslam_tpu_torch.camera.base import Camera, Setup, camera_from_yaml
from stella_vslam_tpu_torch.config import Config
from stella_vslam_tpu_torch.data.bow_database import BowDatabase
from stella_vslam_tpu_torch.data.bow_vocabulary import BowVocabulary
from stella_vslam_tpu_torch.data.frame import Frame, pack_host_cols
from stella_vslam_tpu_torch.data.map_database import MapDatabase
from stella_vslam_tpu_torch.feature.orb_extractor import OrbExtractor
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.global_optimization_module import GlobalOptimizationModule
from stella_vslam_tpu_torch.mapping_module import MappingModule
from stella_vslam_tpu_torch.match.stereo import stereo_match
from stella_vslam_tpu_torch.module.keyframe_inserter import KeyframeInserter
from stella_vslam_tpu_torch.publish.frame_publisher import FramePublisher
from stella_vslam_tpu_torch.publish.map_publisher import MapPublisher
from stella_vslam_tpu_torch.tracking_module import TrackingModule
from stella_vslam_tpu_torch.util import streams
from stella_vslam_tpu_torch.util.stereo_rectifier import StereoRectifier


class System:
    def __init__(self, cfg: Config, device="cuda", inline_mapping: bool = False,
                 vocab_path=None, *, max_inflight: int = 16, inflight_mapper_busy: int = 10,
                 max_lag_s: float = 0.15, ba_stride: int = 2):
        """`device`: where every per-frame tensor lives ("cuda" runs the
        kernels; "cpu" runs their plain versions). `inline_mapping`: False
        (the default) runs the tracker pipelined and the mapper and loop
        closer on their own threads; True runs everything on the caller's
        thread, deterministically. `vocab_path`: a BoW vocabulary in the .npz
        form (the packaged one by default). The keyword arguments are the
        JAX version's SVT_MAX_INFLIGHT, SVT_INFLIGHT_MAPPER_BUSY,
        SVT_MAX_LAG_S and SVT_BA_STRIDE, with its defaults."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.inline_mapping = inline_mapping
        threaded_cuda = not inline_mapping and self.device.type == "cuda"
        stream = lambda: streams.new_stream(self.device) if threaded_cuda else None
        self.camera: Camera = camera_from_yaml(cfg.section("Camera"))
        self.orb_params = OrbParams.from_yaml(cfg.section("Feature"))
        pre = cfg.section("Preprocessing")
        min_size = int(pre.get("min_size", 800))
        if pre.get("mask_rectangles", None):
            raise NotImplementedError(
                "extraction masks are not ported yet (ROADMAP Queue 1 item 14b)")
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
            max_inflight=max_inflight, inflight_mapper_busy=inflight_mapper_busy,
            max_lag_s=max_lag_s, stream=stream())
        self.tracker.synchronous = inline_mapping
        self.tracker.keyfrm_inserter = KeyframeInserter.from_yaml(
            self.camera, cfg.section("KeyframeInserter"))
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
            max_num_local_keyfrms=self.tracker.max_num_local_keyfrms,
            ba_stride=ba_stride, synchronous_ba=inline_mapping, stream=stream())
        # culling thresholds live in the Mapping section (reference
        # local_map_cleaner.cc:9-14)
        cl = self.mapper.cleaner
        cl.redundant_obs_ratio_thr = float(mp.get("redundant_obs_ratio_thr", 0.9))
        cl.observed_ratio_thr = float(mp.get("observed_ratio_thr", 0.3))
        cl.num_reliable_keyfrms = int(mp.get("num_reliable_keyfrms", 2))
        self.tracker.mapper = self.mapper
        self.tracker.keyfrm_inserter.mapper = self.mapper
        # stereo: the rectifier of raw pairs (reference
        # util/stereo_rectifier.cc:14-60) when the config has its section,
        # and the level scales of the row matcher's band
        self.stereo_rectifier = None
        sr = cfg.section("StereoRectifier")
        if sr and self.camera.setup == Setup.STEREO:
            self.stereo_rectifier = StereoRectifier(self.camera, sr, device=self.device)
        self._scale_factors = torch.tensor(self.orb_params.scale_factors,
                                           dtype=torch.float32, device=self.device)
        # place recognition and loop closing (reference system.cc:44-50: the
        # vocabulary is a mandatory artifact there; here the packaged one)
        self.bow_vocab = (BowVocabulary.load(vocab_path, self.device) if vocab_path
                          else BowVocabulary.default(self.device))
        self.bow_db = BowDatabase(self.bow_vocab)
        ld = cfg.section("LoopDetector")
        self.global_optimizer = GlobalOptimizationModule(
            self.map_db, self.camera, self.orb_params, self.bow_db, device=self.device,
            fix_scale=self.camera.setup != Setup.MONOCULAR,
            use_fixed_seed=bool(cfg.get("Initializer", "use_fixed_seed", False)),
            loop_detector_kwargs=dict(
                num_final_matches_thr=int(ld.get("num_final_matches_threshold", 40)),
                min_continuity=int(ld.get("min_continuity", 3)),
                reject_by_graph_distance=bool(ld.get("reject_by_graph_distance", False)),
                min_distance_on_graph=int(ld.get("min_distance_on_graph", 50))),
            stream=stream())
        if not bool(ld.get("enabled", True)):
            self.global_optimizer.disable_loop_detector()
        self.global_optimizer.mapper = self.mapper
        self.mapper.bow_db = self.bow_db
        self.mapper.global_optimizer = self.global_optimizer
        self.map_db.on_erase_keyframe.append(self.bow_db.erase_keyframe)
        self.frame_publisher = FramePublisher()
        self.map_publisher = MapPublisher(self.map_db)
        self.track_times = []
        self._running = False
        self._terminate_is_requested = False
        cfg.log_collapse_report()

    # ------------------------------------------------------------------
    def startup(self, need_initialize: bool = True, warmup: bool = True):
        """`warmup`: run every steady-state device program once before the
        first frame (System.warmup). need_initialize=False starts Lost."""
        if warmup:
            self.warmup()
        if not need_initialize:
            self.tracker.state = "Lost"
        if not self.inline_mapping:
            self.mapper.start()
            self.global_optimizer.start()
        self._running = True

    def warmup(self):
        """The card's one-time costs before the first frame: the kernel
        library's build and load, each stream's allocator pools, the
        factorization library's set-up (the pose graph's Cholesky, 936 ms in
        the first loop event without it). The CPU has none to pay."""
        if self.device.type != "cuda":
            return
        n = self.extractor.num_slots
        with streams.on(self.tracker.stream):
            blank = np.zeros((self.camera.height, self.camera.width), np.uint8)
            if self.camera.setup == Setup.STEREO:
                self.create_stereo_frame(blank, blank, 0.0)
            else:
                self._extract(blank, None)
        self.tracker.warmup(n, self.map_db.device_table.capacity)
        self.mapper.warmup(n)
        if self.global_optimizer.loop_detector_is_enabled():
            self.global_optimizer.warmup()
        torch.cuda.synchronize(self.device)

    def shutdown(self):
        """Finalize every frame, let the mapper and the loop closer finish
        what is queued (a loop sitting in the queue is not dropped), stop the
        threads."""
        self.tracker.finalize_pending()
        if self.inline_mapping:
            self._drain_mapper_inline()
        else:
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline and not (
                    self.mapper.is_idle()
                    and self.global_optimizer.is_idle()):
                time.sleep(0.01)
            self.mapper.request_terminate()
            self.global_optimizer.request_terminate()
            self.mapper.join()
            self.global_optimizer.join()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._running = False

    @property
    def worker_errors(self) -> int:
        """Exceptions the worker threads contained (finalize, mapping, loop
        closing, loop BA); each is logged, and a healthy run has none."""
        return len(self.worker_error_log)

    @property
    def worker_error_log(self) -> list:
        mods = [self.tracker, self.mapper, self.global_optimizer]
        return [e for m in mods if m is not None for e in m.errors]

    def request_terminate(self):
        """Asynchronous terminate request (reference system.h:180); honoured
        at shutdown()."""
        self._terminate_is_requested = True

    def terminate_is_requested(self) -> bool:
        return self._terminate_is_requested

    def request_reset(self):
        self.tracker.finalize_pending()
        self.tracker.reset()
        self.bow_db.clear()

    def pause_tracker(self):
        """Pause frame processing (reference system.h:159: the tracker
        blocks; here later feeds are skipped until resume_tracker)."""
        self.tracker.finalize_pending()
        self.tracker.pause_is_requested = True

    def tracker_is_paused(self) -> bool:
        return self.tracker.pause_is_requested

    def resume_tracker(self):
        self.tracker.pause_is_requested = False

    def get_frame_publisher(self):
        return self.frame_publisher

    def get_map_publisher(self):
        return self.map_publisher

    def disable_mapping_module(self):
        self.tracker.mapping_is_enabled = False

    def enable_mapping_module(self):
        self.tracker.mapping_is_enabled = True

    def mapping_module_is_enabled(self) -> bool:
        return self.tracker.mapping_is_enabled

    def enable_loop_detector(self):
        self.global_optimizer.enable_loop_detector()

    def disable_loop_detector(self):
        self.global_optimizer.disable_loop_detector()

    def loop_detector_is_enabled(self) -> bool:
        return self.global_optimizer.loop_detector_is_enabled()

    def request_loop_closure(self, keyfrm1_id: int, keyfrm2_id: int) -> bool:
        """Manual loop closure between two keyframes (reference system.h:116)."""
        return self.global_optimizer.request_loop_closure(keyfrm1_id, keyfrm2_id)

    def loop_BA_is_running(self) -> bool:
        return self.global_optimizer.loop_ba_running

    def abort_loop_BA(self):
        self.global_optimizer.abort_loop_BA()

    def pause_other_threads(self):
        """Threaded: ask the mapper to pause and wait until it has settled
        its staged event and pending BA. Inline: run what the last feed
        left queued."""
        if self.inline_mapping:
            self._drain_mapper_inline()
            return
        self.mapper.request_pause()
        while not self.mapper.is_paused() and self.mapper._thread is not None \
                and self.mapper._thread.is_alive():
            time.sleep(0.002)

    def resume_other_threads(self):
        if not self.inline_mapping:
            self.mapper.resume()

    def _drain_mapper_inline(self):
        """Run the keyframe events the last feed queued, and the loop
        detection of each (inline mapping)."""
        self.mapper.drain()

    def _yield_to_mapper(self):
        """When frames come faster than real time the caller's Python work
        can starve the mapping thread of the interpreter lock and the local
        map falls behind the motion: yield briefly while the mapper has
        work (the analogue of the reference's backpressure veto,
        keyframe_inserter.cc:59-62)."""
        if not self.mapper.is_idle():
            time.sleep(0.002)

    def _after_feed(self, img, frm, pose, t0: float, t_ext: float):
        if self.inline_mapping:
            self._drain_mapper_inline()
        else:
            self._yield_to_mapper()
        self.track_times.append(time.perf_counter() - t0)
        # references only: a viewer reads the frame's host mirror itself
        # (reference system.cc:540-543 publishes the extraction and
        # tracking wall times)
        self.frame_publisher.update(img, frm, self.tracker.state,
                                    extraction_time_ms=t_ext * 1e3,
                                    tracking_time_ms=self.track_times[-1] * 1e3)
        if pose is not None:
            self.map_publisher.set_current_cam_pose(pose)

    @property
    def local_ba_ms(self):
        """Wall ms of every local BA, assembly to writeback and publish."""
        return self.mapper.local_ba_ms

    @property
    def keyframe_event_ms(self):
        """Per keyframe event, its phases in ms (MappingModule.event_ms)."""
        return self.mapper.event_ms

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
        """Initialize or track one frame. Inline, the keyframe events it
        queued run before it returns, and it returns the frame's pose_cw
        (None while initializing or lost); threaded, see
        TrackingModule.feed_frame."""
        t0 = time.perf_counter()
        with streams.on(self.tracker.stream):
            frm = self.create_monocular_frame(img, timestamp, mask)
            t_ext = time.perf_counter() - t0
            pose = self.tracker.feed_frame(frm)
        self._after_feed(img, frm, pose, t0, t_ext)
        return pose

    def create_stereo_frame(self, img_left, img_right, timestamp: float, mask=None) -> Frame:
        """A stereo pair -> the left image's frame with row-matched x_right
        and depths (reference system.cc:426-470): both images up in one
        pinned copy, rectified on the device when the config has a
        StereoRectifier section, extracted together (kernels S, A, B), row
        matched (kernel T), the left keypoints undistorted (kernel R), then
        bearings and the packed host mirror."""
        if self.camera.setup != Setup.STEREO:
            raise ValueError("feed_stereo_frame needs a camera with setup stereo")
        if mask is not None:
            raise NotImplementedError(
                "extraction masks are not ported yet (ROADMAP Queue 1 item 14b)")
        pair = streams.upload(np.stack([self._to_gray(img_left), self._to_gray(img_right)]),
                              self.device)
        left, right = pair[0], pair[1]
        if self.stereo_rectifier is not None:
            left, right = self.stereo_rectifier.rectify(left, right)
        (fl, sl), (fr, sr) = self.extractor.extract_pair_with_patches(left, right)
        cam = self.camera
        x_right, depths = stereo_match(
            fl.xy, fl.level, fl.desc, fl.valid, sl, fr.xy, fr.level, fr.desc, fr.valid, sr,
            scale_factors=self._scale_factors,
            focal_x_baseline=cam.params.focal_x_baseline, true_baseline=cam.true_baseline)
        und = cam.undistort(fl.xy)
        bear = cam.bearings(und)
        frm = Frame(timestamp, cam, self.orb_params, fl, und, bear, x_right=x_right,
                    depths=depths)
        frm.attach_packed_host(pack_host_cols(
            fl.xy, und, bear, fl.level, fl.angle, fl.valid, fl.response, x_right, depths,
            fl.desc))
        return frm

    def feed_stereo_frame(self, img_left, img_right, timestamp: float, mask=None):
        """Track one stereo pair; inline, returns its pose_cw, or None when
        lost."""
        t0 = time.perf_counter()
        with streams.on(self.tracker.stream):
            frm = self.create_stereo_frame(img_left, img_right, timestamp, mask)
            t_ext = time.perf_counter() - t0
            pose = self.tracker.feed_frame(frm)
        self._after_feed(img_left, frm, pose, t0, t_ext)
        return pose

    def create_RGBD_frame(self, img, depth, timestamp: float, mask=None) -> Frame:
        """Extraction, undistortion, bearings, depth sampling and the packed
        host mirror for one gray image and its raw depth map."""
        if self.camera.setup != Setup.RGBD:
            raise ValueError("feed_RGBD_frame needs a camera with setup RGBD")
        feats, und, bear = self._extract(img, mask)
        cam = self.camera
        depth_map = streams.upload(np.asarray(depth, np.float32), self.device)
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
        """Track one frame; inline, returns its pose_cw, or None when lost."""
        t0 = time.perf_counter()
        with streams.on(self.tracker.stream):
            frm = self.create_RGBD_frame(img, depth, timestamp, mask)
            t_ext = time.perf_counter() - t0
            pose = self.tracker.feed_frame(frm)
        self._after_feed(img, frm, pose, t0, t_ext)
        return pose

    def _extract(self, img, mask):
        """(features, undistorted keypoints, bearings) of one image."""
        if mask is not None:
            raise NotImplementedError(
                "extraction masks are not ported yet (ROADMAP Queue 1 item 14b)")
        # through pinned memory: a copy from pageable memory would make the
        # host wait for the stream, i.e. for the frames still in flight
        image = streams.upload(self._to_gray(img), self.device)
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
