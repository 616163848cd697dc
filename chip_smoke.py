#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (stella_vslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit, which every later number is measured on;
  2. build: compiles the kernels of csrc/ with nvcc for sm_90a, one process
     per source, all at once (timed);
  3. kernels A-D of the RGBD tracking slice against their plain PyTorch
     versions at its shapes (752x480, 8 levels, N=2872 slots, C=4096 table
     rows): A (one launch a pyramid) bit for bit, keys and slot outputs, on
     five frames (fast_frames: a bench frame, a stereo pair, the
     equirectangular leg's 640x320 frame, a masked fisheye frame, a
     1280x720 frame of 7984 slots), B's descriptor bit-mismatch rate <= 5e-5 (the CPU
     test's bound against JAX), also on keypoints aimed near both edges of
     every steering bin and clamped at every image border
     (bin_edge_keypoints; angles within 1e-3, strips equal); C exactly (0 rows differing from the dense
     plain walk) in its window mode on its cell index (whose cells must
     hold the plain argsort's targets), in brute force at 2872 x 2872 with and
     without the orientation gate, and on edge cases at those widths
     (fisheye and division keypoints far outside the image, NaN
     coordinates, empty windows, all rows failing row_ok, one target, ties
     at equal distance), each window case's visited pairs printed beside
     the dense M x N; D on a batch of two problems in one launch, each pose
     within 1e-4 of its plain version with 99% of the inlier flags equal,
     and the batch of one equal to the batch's first problem bit for bit;
  4. the monocular initialization kernels at the mono slice's shapes: C's
     angle-gate mode (the area matcher, 2872x2872) against its plain
     version, with the share of rows that differ (CUDA's and torch's
     sinf/atan2f may differ in the last ulp); E (two-view RANSAC) against
     plain for H and F at 1024 hypotheses x 2872 matches: the same best
     inlier count; its escalated sweep (8 x 4096 with 3 LO refits) once;
     where E's F hypotheses part from plain (the counts of each
     hypothesis on four seeds, against plain and against plain's null
     vector projected to rank 2 in float64, the kernel's route for that
     step); the LO refit's normalisation on the card (XLA's windows of 32)
     equal to plain's bits at 2872, 1199, 700 and 33 matches; F, G, H, I
     (bundle adjustment) against the plain BA on an
     init-sized problem (K=2, L=4096, D=2) and a K=8, D=4 problem with
     stereo rows: poses within 1e-4, points seen twice within 1e-3,
     identical outlier flags;
     the times of every kernel, here and wherever a row is timed: device
     time, CUDA events around 50 back-to-back launches / 50 after the
     stream is held long enough for the host to enqueue them all
     (_device_ms; inputs a launch consumes restored outside the timed
     window), beside the one-call time (events around one synchronised
     call, the host's launch in it), the plain version's median time, the
     bound (the least time the card could take for the work: bytes over
     3.35 TB/s or operations over 67 T/s, FP32 outside the tensor cores,
     integer operations counted at the same rate) and, where one PyTorch
     call computes the same function, that call's device time (S's and A's
     rows count a frame, or a pair: one launch);
  5. the RGBD slice: System in RGBD mode, mapping disabled, 120 frames of
     the numpy plane world at 0.015 m/frame (the bench's RGBD settings):
     at most 2 frames lost after init, rigid ATE < 0.10 m, scale error
     < 5%, kernels A-D launched; then its first 30 frames at 1280x720
     (hd_world, 7984 slots): at most 2 frames lost, kernel Q's dedup
     launched for every tracked frame;
  6. the mono slice: System in monocular mode, mapping disabled, 120 frames
     of the same world (the bench's mono settings): initialized by frame 10,
     at most 2 frames lost after init, Sim3 ATE < 0.10 m, kernels A-I
     launched; frame time p50/p99 over the steady frames and the init
     frame's time by phase;
  7. the map slice: System in monocular mode with mapping enabled and
     inline, 500 frames of the same world (the bench's whole outbound leg,
     x from 0 to 7.49 m; the first 500 frames of phase 9's run, read before
     the drift is injected): at most 2 frames lost after init, Sim3 ATE
     < 0.10 m, at least 12 local BAs and 5 keyframes kept at the end, kernels
     A-L launched; frame and keyframe-event times by phase
     (util/map_slice.py);
  8. the mapping kernels on the map slice's own inputs: J (epipolar top-2:
     the band index, then the band walk) and K (DLT and checks) on its
     triangulation with the most neighbours, L (the fuse chunk's cell
     indexes, then the cell walk) on its fuse chunk with the most landmarks
     and on fuse_edge_chunk (landmarks at the image's edges, keypoints
     outside it, NaN coordinates), each at margins 3 and 4: its plain cell
     walk equal to the full-scan plain version and the kernel's outputs
     equal to it (0 rows differing; the chunk saved); J's outputs equal to
     plain's (0 rows), also with the band index given, its plain band walk
     equal to the dense walk, its band index against the plain index (the
     basis within 1e-6, targets in another bucket <= 1e-3 and the next bin
     at most), the pairs visited beside the dense pairs; K against its
     plain version (flags differing <= 1e-3, positions within 1e-4
     relative where both are ok); F-I at the local-BA shape (K=16, L=4096,
     D=12, 3 + 6 iterations, the local BA's layout of observers) against
     the plain BA with phase 4's bounds, and on every local problem of the
     slice kernel by kernel on the kernels' own state (_lockstep_ba): F's
     camera blocks, reduced system and cost no farther from plain F in
     float64 than 10x plain F's own float32 error plus 1e-4 (each entry
     relative to the sum of its terms' absolute values), G's step with a
     backward error below 1e-3 in float64 (n^2 eps for the 96 x 96 system)
     and its trial poses within 1e-5, H's trial cost within 1e-4 relative
     and each trial point within 1e-3 or, where larger, 1e-4 rad of its ray
     sensitivity (depth^2 / baseline) of H in float64 on the same step
     (plain H's own distance printed), the same accept / stop decisions
     and outlier flags wherever the deciding quantity lies more than 1e-5
     from its threshold; the whole BA of each, kernel against plain and
     each against itself, is printed; times and bounds as in phase 4, F
     also timed on the slice's largest local problem; F's pair index
     equal to its plain version and timed beside torch.argsort, and F on
     its edge cases (check_f_cases: random observers at the local shape,
     L = 4133, K = 1, K = 130, fixed rows and a chunk with no valid
     observation, the equirectangular model) with the index equal to
     plain, F's system within the bound above and two launches equal.
  9. the loop slice (phase 7 is its first 500 frames, read at frame 500):
     the bench's whole 1290-frame circuit with mapping and the loop detector
     enabled and the bench's drift injected after the outbound leg
     (util/loop_slice.py): at least one loop closed, Sim3 ATE over all
     frames < 0.10 m, at most 8 frames lost after init, at least 25 keyframes
     created and 10 kept, a loop edge in the graph, the frame after each
     correction tracked, kernels A-P launched; the loop event's time by phase;
 10. the loop kernels against their plain versions, on synthetic inputs at
     the slice's shapes and on the inputs the loop slice recorded: V on the
     .npz vocabulary's tree (BoW descent, 2872 descriptors) equal word ids;
     N (PnP RANSAC, 256 sets x 8
     starts x 2872) hypothesis by hypothesis (ok flags and inlier counts
     equal and (R, t) within 1e-4 on at least 99% of the hypotheses, costs
     within 1e-4 relative), the same winner with the same inlier set and a
     pose within 1e-5; C's keyframe-match call (2872 x 2872, margins 10 and
     3) exact; O (Sim3 refinement) s, R, t within 1e-4 and inlier flags
     differing on at most 1e-3 of the pairs; P (pose graph) per iteration on
     the kernel's own state: the system within 1e-4 and the right-hand side
     within 1e-3 of the largest entry, the update within 1e-5, and the whole 20 iterations
     within 1e-3; F-I at the global shape (K = 32 and K = 64, L = 4096,
     D = 16, and K = 128, L = 1024, D = 16; one Huber stage of 16) and on
     the slice's global BA problems kernel by kernel (_lockstep_ba, G's
     backward error below 1e-3 as at the local shape, H's trial cost within
     1e-3); times and bounds (K = 32 and 64) as in phase 4,
     the library call of P's solve (torch.linalg.cholesky + cholesky_solve)
     and of G's (torch.linalg.solve); P's dense solve through kernel G's
     spd_solve (its backward error below 1e-3 on every iteration's system)
     and spd_solve timed at the loop slice's pose graph against the
     library's Cholesky, both as device time. Then K22 on 4 landmark shards of this
     card (parallel/sharded_ba.py): kernel W's reduce mode against its
     plain version (the same adds in a Python loop, in the same order),
     exactly; whole sharded global BAs (one Huber stage of 16) against the
     unsharded BA, bit for bit, at K = 32, L = 4096, D = 16; K = 32,
     L = 8192, D = 32; K = 64, L = 4096, D = 16 and on the loop slice's
     global BA problems; at K = 64, L = 8192, D = 16, where F's block count
     is cut (64 chunks, 56 partials), poses within 1e-4 and points seen
     twice within 1e-3; make_sharded_ba_step against its plain version
     (poses within 1e-4, points within 1e-3) and equal to the one-shard
     step; dryrun_multidevice(4); W's device time (as G's) against its
     bound, its plain version and torch.sum over the stacked partials, and
     the whole sharded BA's time against the unsharded one's, its bound (F
     and H on every shard, W and G on every replica, summed over the
     iterations it ran) and its plain version's time on the card.
 11. kernels Q (csrc/track_assoc.cu: the per-slot scatter, the landmark
     dedup, the chain rebase) and R (csrc/reproject.cu: the window rows of
     the cascade's projections, the undistortion) against their plain
     versions at the slice's shapes (run with phase 3): Q exact (poses of
     the rebase within 1e-6) on synthetic inputs with slot collisions, tied
     scores, repeated and absent ids, also the scatter at 7984 slots and
     the dedup at 7984 and 12839 (1280x720; a 1920x960 equirectangular
     camera at 6 levels); R's rows of 2872 points and 4096 table rows:
     u, v, x_right and radius within 1e-5 relative (of at least 100 px),
     levels and flags equal except within 1e-6 of a threshold (counted);
     R's frame finish (data/frame.py frame_finish, one launch a frame)
     bit for bit against its plain version, every output (undistorted
     keypoints, bearings, x_right, depths, the packed host rows), for each
     camera model and feed (mono, stereo with kernel T's outputs, RGBD
     with a depth map with holes) at 2872 slots (1199 equirectangular) and
     on the world's extracted frame;
 12. the inline loop slice a second time in the same process on a fresh
     System whose global and loop BAs run sharded over 4 landmark shards of
     this card (ba_devices, kernel W; launch counts set to 0 before it and
     read after it): held to phase 9's gates, every global BA sharded,
     W and F-I launched; whether the frame poses are bit-identical to the
     first run's (the sharded route equals the unsharded one and the run
     repeats), the first frame that differs, both ATEs, and where each
     run's error sits (legs, frames whose reference keyframe was culled,
     their forward hops);
 13. kernels F-I and P twice on the same inputs (init, local and global
     shapes, the loop slice's global BA and pose graph): bit-identical;
     G, spd_solve and F, then C, D, B (both modes), A (a frame, a pair)
     and Q (the scatter; the dedup at 2872, 1199 and 12839 slots), launched
     from several host threads on their own streams beside kernel F: every
     launch gives its case's bits on the idle card, and none fails
     (check_solves_under_load, check_cascade_under_load);
 14. the threaded slice (util/threaded_slice.py): the default System —
     pipelined tracker, mapping and loop-closing threads on their own CUDA
     streams — over the bench's circuit fed as fast as the feed returns:
     at most 8 frames lost after init, a loop closed, Sim3 ATE < 0.10 m,
     local-BA skips at most 20% of the opportunities, at least 25 keyframes
     created and 10 kept, nothing left queued or pending at shutdown, no
     exception contained by a worker thread, every kernel A-R launched;
     frame time, keyframe and loop events by phase, rebases and drain
     fallbacks, the caller's waits, and the synchronising calls per steady
     dispatch (torch's sync debug mode on frames 300-340, by file:line);
     kernel D's launches per frame (at most 2.2: two a frame, stages 2 and
     1 batched, plus the loop detector's); then kernel Q against plain on
     the slice's recorded inputs (a sample of the scatters and dedups,
     every rebase), kernel C exactly on a sample of its stage 1, 2 and 3
     calls, with the pairs each window call visited, and kernel R's rows on
     a sample of its calls of both stages.
 15. kernel S (csrc/resize.cu: the whole pyramid in one launch), B's
     strip mode and kernel T (csrc/stereo_match.cu: the stereo matcher)
     against their plain versions at the stereo leg's shapes (run with
     phase 3): S one launch a call, against its two-tap plain version
     (resize_level_taps_plain) with 0 pixels differing at 752x480 (one image,
     the pair, the pair as f32), 640x320, 1280x720 and 1920x960, the pixels
     its halos compute twice; on the pair against the two torch.matmul per
     level (cuBLAS) with max |diff| <= 1e-4, the pixels that differ, the
     pixels that differ from the CPU's matmul, and kernel A's cell keys that
     move (<= 0.5%); B's strips equal; T on synthetic
     inputs at 2872 x 2872 drawn in the bench extractor's slot layout and
     on a rendered pair: matched flags equal except at a threshold
     (counted), x_right and depth within 1e-5 relative, one launch a call,
     the pairs its band walk visits counted (band_cells_plain); kernel O in
     its fixed-scale mode against plain;
 16. bench.py's stereo leg and its RGBD leg with mapping (util/
     stereo_slice.py): the default threaded System, 640 frames each (400
     out, 240 back on fresh rows), with the bench's gates (at most 8 frames
     lost after init, scale error < 5%, rigid ATE < 0.10 m), at least one
     keyframe event, nothing left at shutdown, no worker exception, the
     path's kernels launched; frame time, keyframe events by phase; then T
     against plain on every 20th call of the stereo leg, and R's rows on a
     sample of the stereo leg's calls of both stages.
 17. bench.py's equirectangular leg (util/equirect_slice.py): the default
     threaded System on the 640x320 box room, 6 levels, 250 frames on the
     1.8 m circle, with bench.py's gates (at most 10 frames lost after
     init, Sim3 ATE < 0.10 m), a keyframe event, a clean shutdown, the
     path's kernels launched (E's MODEL 2 in the bearing-vector
     initializer, the equirectangular modes of R, D, F-I, K, L); then the
     escalation run: a fresh System on the leg's first 12 frames with the
     initializer's escalation threshold above 1, so that its escalated E
     sweep and kernel U's 5-point sweep run (the leg escalates only below
     45% consensus), kernel U launched;
 18. the kernels the leg runs unchanged, at its own shapes and inputs
     (640x320, 6 levels, 1199 slots): S, A and B on one of its frames
     through its extractor with phase 3's and the stereo phase's bounds,
     V on that frame's descriptors, C's angle gate on the init pair's area
     match, J on its largest triangulation, Q on its sampled scatters and
     dedups; then the equirectangular modes against their plain versions
     on the leg's own inputs (R's rows of 1199 points and 4096 table rows
     all around the camera: u and x_right within 1e-5 relative of at least
     100 px, either edge at the seam, v too, levels and flags equal except
     within 1e-6 of a threshold; D on every 25th of the leg's pose optimizations
     within 1e-4; K and L on its largest triangulation and fuse chunk with
     phase 8's bounds; F-I kernel by kernel, _lockstep_ba, on its init BA
     and local problems, timed at the local shape), and on the leg's init
     pair E's MODEL 2 (1024 hypotheses with one LO refit: the plain model
     on >= 75% of the hypotheses, and on fewer with another seed's sets;
     the winner's count and mask equal; the escalated 8 x 4096 with 3 LO
     refits within 1%) and kernel U (1024
     sets for each of U_SEEDS: indices bit-equal, valid flags equal on
     >= 98% of the slots, candidates as sets within U_SHARE_LIMITS of
     plain's and no more than U_FLOOR_ROOM below plain on the CPU, a
     control with its bisection cut short caught by the limits; as many
     candidates satisfying their own epipolar constraints as plain's).
 19. the fisheye, radial-division and masked fisheye legs
     (util/distorted_slice.py): the mono slice's first 120 frames (752x480,
     8 levels, 2872 slots) through the default threaded System with
     mapping, rendered through each camera (the third with a 400 px
     vignette mask): initialized by frame 10, at most 2 frames lost after
     init, Sim3 ATE < 0.10 m, a clean shutdown, kernel R in the leg's own
     mode once a frame and in no other, kernel A with the mask on every
     launch of the masked leg (distorted_slice.OPEN_GATES, gates an open
     fault would only print, is empty); then
     R's Kannala-Brandt and division modes against their plain versions
     bit for bit on every keypoint of the legs and on 2872 random keypoints
     over the image, and A with a mask against plain, exactly, on every
     level of a leg frame (the half-image mask of
     tests/test_orb_extractor.py, a seeded random mask, the vignette), each
     mask keeping fewer cells' corners than no mask;
 20. the FBoW leg (util/fbow_slice.py): the threaded circuit with the
     fixture vocabulary tests/data/reference_layout_vocab.fbow: no worker
     exception, at most 8 frames lost after init, kernel V once per
     keyframe event, the loops it closed reported (with one, Sim3 ATE <
     0.10 m); then V against plain, exactly, on the fixture tree with 2872
     random descriptors and with every keyframe event's descriptors, on
     the packaged .npz vocabulary's tree (whose tables equal those the
     port's write_fbow and read_fbow give) and on synthetic trees with
     more than 16 children a block and with clamped child blocks.
Launch counts are set to 0 just before each slice and read just after it;
the kernels line's `launches` is the count on the path of the slice that
ported the kernel (the stereo leg for S, B's strip mode and T; the
equirectangular leg for the equirectangular modes and E's MODEL 2, its
escalation run for U; the fisheye leg for R's Kannala-Brandt mode and A's
masked launches, the radial-division leg for R's division mode, the FBoW
leg for V; the sharded loop slice of phase 12 for W; the threaded
slice, which runs every earlier kernel, for the rest), with every slice's
count beside it.
The line before the last is {"kernels": [...]}, the one before it
"slices: {...}" with each slice's result in short; the last line is
{"ok": true, "device": {...}}. Long logs go to chiprun_out/.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

DESC_MISMATCH_BOUND = 5e-5  # tests/test_torch_orb.py DESC_BIT_MISMATCH_MAX
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# H100 SXM's INT32 lanes: 64 an SM, 132 SMs, at the 1.98 GHz boost clock
# that 67 TFLOP/s of float32 (128 lanes, an FMA as two) assumes
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# kernels J, K, L: the mapping module's, which the mono and RGBD slices
# (mapping disabled) never launch
MAPPING_KERNELS = ("epipolar_top2", "epipolar_band_index", "triangulate", "fuse",
                   "fuse_cell_index")
# kernels V and N-P: the loop closer's (V, the vocabulary's descent, runs
# with the mapper's keyframe events)
LOOP_KERNELS = ("fbow_transform", "pnp_ransac", "sim3_transform", "pose_graph", "spd_solve",
                "match_frame_and_keyframe")
# the stereo path's own: B's strip mode and T (S runs on every path)
STEREO_KERNELS = ("orb_describe_strips", "stereo_match")
# the kernels line's rows whose launches are the stereo leg's
STEREO_PATH_ROWS = ("resize_pyramid",) + STEREO_KERNELS
# kernel U: the five-point sweep, run when the bearing-vector initializer
# escalates (the equirectangular leg's escalation run)
EQUIRECT_KERNELS = ("essential_5pt",)


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


DEVICE_TIMED_CALLS = 50
# how a row with device times reads them
DEVICE_TIMING = (f"ms and library_ms: device time, CUDA events around {DEVICE_TIMED_CALLS} "
                 f"back-to-back calls / {DEVICE_TIMED_CALLS} (a library call that waits on the "
                 "card pays for it); one_call_ms and library_one_call_ms: events around one "
                 "call, the host's part in it")


def _device_ms(fn, n: int = DEVICE_TIMED_CALLS, warmup: int = 3, before_run=None) -> float:
    """Device time per call: CUDA events around n back-to-back calls,
    divided by n, after a warm-up. The stream first sleeps for longer than
    the host takes to enqueue the n calls, so the card runs them one after
    another without waiting for the host (a call that waits on the card
    itself, as torch.linalg.cholesky does, still pays for that).
    before_run(), when given, runs before the warm-up and before each run of
    n calls (outside the timed window): fresh inputs for a call that
    consumes its own."""
    import torch

    prep = before_run or (lambda: None)
    prep()
    for _ in range(warmup):
        fn()
    prep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    prep()
    # ~2e6 cycles per ms at the card's top clock: a sleep of at least 1.5x the
    # host's enqueue time plus 1 ms
    torch.cuda._sleep(int(2e6 * (1.5 * enqueue_ms + 1.0)))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _times(fn, before_run=None, **median_kw) -> dict:
    """A row's kernel times: ms, device time per call (_device_ms), and
    one_call_ms, events around one synchronised call with the host's launch
    in it (_median_ms, with median_kw)."""
    return dict(ms=_device_ms(fn, before_run=before_run),
                one_call_ms=_median_ms(fn, **median_kw), timing=DEVICE_TIMING)


def _bound(nbytes: float, ops: float, int_ops: float = 0.0) -> dict:
    """The least time for `nbytes` of traffic, `ops` float operations and
    `int_ops` integer operations (on their own units, so the larger of the
    two times)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _describe_ops(angle, valid, tab, strips: bool = False) -> float:
    """Kernel B's operations on this run's keypoints: per valid keypoint
    the IC moments (31x31, a product and a sum for each of two), 256
    comparisons, and 49 products and sums for each distinct pixel of its
    steering bin (tab.npix; and the strip's 231 in strip mode)."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox

    bins = torch.remainder(torch.round(angle / ox._TAU).long(), ox.ANGLE_BINS)
    n = int(valid.sum())
    blurred = float(tab.npix.long()[bins][valid].sum()) + (231.0 * n if strips else 0.0)
    return n * (31 * 31 * 2 + 256 * 2) + 98.0 * blurred


def check_describe_edges(dev, tab) -> dict:
    """Kernel B on bin_edge_keypoints (every steering bin, angles near both
    its edges, patches clamped at every border and on images smaller than
    a patch) against orb_describe_plain, in both modes: angles within 1e-3,
    descriptor bits within DESC_MISMATCH_BOUND, strips equal, all 30 bins
    reached. Returns the readings."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox

    args = bin_edge_keypoints(0, dev) + (tab,)
    valid = args[6]
    ap, dp, sp = ox.orb_describe_plain(*args, strips=True)
    out = dict(keypoints=int(valid.numel()))
    for mode, res in (("describe", ox.orb_describe(*args)),
                      ("strips", ox.orb_describe_strips(*args))):
        x = (res[1] ^ dp)[valid].cpu().numpy()
        out[mode] = dict(max_abs_angle_diff=float((res[0] - ap).abs().max()),
                         desc_bit_mismatch=float(np.unpackbits(x.view(np.uint8)).sum())
                         / max(1, x.size * 32))
        if mode == "strips":
            out[mode]["strips_equal"] = bool(torch.equal(res[2], sp))
    bins = torch.remainder(torch.round(ap / ox._TAU).long(), ox.ANGLE_BINS)
    out["bins_reached"] = len(set(bins[valid].tolist()))
    print("kernel B at every bin's edges and the image borders: " + json.dumps(out))
    assert out["bins_reached"] == ox.ANGLE_BINS and out["strips"]["strips_equal"]
    assert all(out[m]["max_abs_angle_diff"] < 1e-3
               and out[m]["desc_bit_mismatch"] <= DESC_MISMATCH_BOUND
               for m in ("describe", "strips")), "kernel B disagrees at bin edges or borders"
    return out


def hd_world():
    """bench_world's plane at 1280x720 (fx = fy = 780, 458 scaled by
    1280/752): 7984 slots at 8 levels and min_size 800."""
    from stella_vslam_tpu_torch.util.synthetic import PlaneWorld

    return PlaneWorld(width=1280, height=720, fx=780.0, fy=780.0, depth=4.0, tex_size=4096,
                      meters_per_px=0.008, noise_sigma=2.0, exposure_amp=0.06)


def fast_frames(dev):
    """Kernel A's frames: (label, extractor, flat pyramid [B, P], level-0
    mask or None) for a bench frame (752x480, 8 levels, 2872 slots), a
    rendered stereo pair (B = 2), the equirectangular leg's frame (640x320,
    6 levels, 1199 slots), a masked fisheye leg frame with its vignette and
    a 1280x720 frame (7984 slots)."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.util import distorted_slice as ds
    from stella_vslam_tpu_torch.util import equirect_slice as es
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world
    from stella_vslam_tpu_torch.util.synthetic import equirect_circle

    up = lambda imgs: torch.from_numpy(np.stack(imgs)).to(dev)
    world = bench_world()
    ex = ox.OrbExtractor(OrbParams(num_levels=8), 752, 480, min_area=800, device=dev)
    out = [("bench frame 752x480", ex, ex.pyramid_flat(up([world.render(pose_at_xy(0.6, 0.0))])),
            None),
           ("stereo pair 2 x 752x480", ex, ex.pyramid_flat(
               up([world.render(pose_at_xy(x, 0.0)) for x in (0.6, 3.0)])), None)]
    ee = ox.OrbExtractor(OrbParams(num_levels=6), 640, 320, min_area=800, device=dev)
    out.append(("equirect frame 640x320", ee, ee.pyramid_flat(
        up([es.bench_world().render(equirect_circle(250)[0][0])])), None))
    fw = ds.leg_world("fisheye_masked", world)
    out.append(("masked fisheye frame 752x480", ex, ex.pyramid_flat(
        up([fw.render(pose_at_xy(0.6, 0.0))])),
        torch.from_numpy(ds.leg_mask("fisheye_masked", fw)).to(dev)))
    hw = hd_world()
    eh = ox.OrbExtractor(OrbParams(num_levels=8), hw.W, hw.H, min_area=800, device=dev)
    out.append(("1280x720 frame", eh, eh.pyramid_flat(up([hw.render(pose_at_xy(0.6, 0.0))])),
                None))
    return out


def fast_work(ex, pyr, mask=None) -> dict:
    """Kernel A's bound on one launch, counted on this launch's pixels: on
    every pixel of each level's border region that the mask keeps, the
    compass test (4 differences and 8 comparisons at min_fast_thr: ring
    points 0, 4, 8, 12, two neighbours both brighter or both darker, true
    of every corner), and on each such pixel that passes it (a plain torch
    compass test on the inputs) 300 more (the full ring's 16 differences
    and the doubling tree's 16 x 2 arcs); bytes: the pyramid read once
    (with a mask, only the kept region pixels, the mask and its index
    tables) and 17 bytes a slot written (key, px, py, response, valid)."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox

    B, b = pyr.shape[0], ex.border
    t = float(ex.params.min_fast_thr)
    n_px = n_pass = 0
    for g, off in zip(ex.levels, ex._level_off):
        if g.H <= 2 * b or g.W <= 2 * b:
            continue
        img = pyr[:, off:off + g.H * g.W].view(B, g.H, g.W)
        c = img[:, b:g.H - b, b:g.W - b]
        ring = [img[:, b + dy:g.H - b + dy, b + dx:g.W - b + dx] - c
                for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]  # ring 0, 4, 8, 12
        hit = torch.zeros_like(c, dtype=torch.bool)
        for q in ([d > t for d in ring], [d < -t for d in ring]):
            for k in range(4):
                hit |= q[k] & q[(k + 1) % 4]
        if mask is not None:
            idx = lambda n_in, n_out: torch.from_numpy(
                ox.nearest_index(n_in, n_out)[b:n_out - b].astype(np.int64)).to(mask.device)
            keep = mask[idx(mask.shape[0], g.H)[:, None], idx(mask.shape[1], g.W)[None, :]] != 0
            hit &= keep
            n_px += B * int(keep.sum())
        else:
            n_px += c.numel()
        n_pass += int(hit.sum())
    if mask is None:
        read = 4.0 * B * ex.pyramid_size
    else:
        read = 4.0 * n_px + mask.numel() + 4.0 * sum(g.H + g.W for g in ex.levels)
    return _bound(read + 17.0 * B * ex.num_slots, 12.0 * n_px + 300.0 * n_pass)


def check_fast_frames(dev, frames) -> dict:
    """Kernel A (one launch a pyramid) against fast_nms_pyramid_plain on
    each of fast_frames, bit for bit: keys and slot outputs. Returns
    {label: cells with a corner}."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox

    out = {}
    for label, ex, pyr, mask in frames:
        p = ex.params
        thr = (float(p.ini_fast_thr), float(p.min_fast_thr))
        before = ox.fast_nms_pyramid.launches
        k = ox.fast_nms_pyramid(pyr, ex._fast, *thr, mask)
        q = ox.fast_nms_pyramid_plain(pyr, ex._fast, *thr, mask)
        torch.cuda.synchronize()
        assert ox.fast_nms_pyramid.launches == before + 1
        assert all(torch.equal(a, c) for a, c in zip(k, q)), \
            f"kernel A disagrees with its plain version on the {label}"
        out[label] = int(k[3].sum())
    print(f"kernel A fast_nms_pyramid, one launch a pyramid, bit-equal to plain (keys, px, "
          f"py, valid, response); cells with a corner: {json.dumps(out)}")
    return out


def check_kernels(dev, world):
    """Kernels A-D against their plain versions on the card; returns rows
    of the kernels line (launch counts filled in after the slices)."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.match.robust import cos_30deg
    from stella_vslam_tpu_torch.ops.optim import pose as pose_mod

    rows = []
    params = OrbParams(num_levels=8)
    frames = fast_frames(dev)
    _, ex, pyr1, _ = frames[0]  # world's frame at x = 0.6 m
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    pyr_bytes = 4.0 * ex.pyramid_size

    # ---- A: FAST + NMS, one launch for every level of a frame ----
    corners = check_fast_frames(dev, frames)
    run_a = lambda fn: fn(pyr1, ex._fast, *thr)
    ka = run_a(ox.fast_nms_pyramid)
    rows.append(dict(
        name="fast_nms_pyramid", route="cuda",
        source="stella_vslam_tpu_torch/csrc/fast_nms.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:88",
        max_abs_err=0.0, shape="752x480, 8 levels, 2872 slots: one launch a frame",
        cells_with_a_corner=corners,
        **_times(lambda: run_a(ox.fast_nms_pyramid)),
        plain_ms=_median_ms(lambda: run_a(ox.fast_nms_pyramid_plain)),
        library_ms=None, **fast_work(ex, pyr1)))
    for label, exf, pyr, mask in frames[1:]:
        if mask is None:
            fn = lambda exf=exf, pyr=pyr: ox.fast_nms_pyramid(pyr, exf._fast, *thr)
            rows[-1][f"ms_{label.replace(' ', '_')}"] = _device_ms(fn)

    # ---- B: orientation + blur + steered BRIEF, one frame's slots ----
    px, py, valid = ka[1][0], ka[2][0], ka[3][0]
    args = (pyr1.reshape(-1), ex._slot_base, ex._slot_H, ex._slot_W, px, py, valid,
            ex._tables)
    ang_k, desc_k = ox.orb_describe(*args)
    ang_p, desc_p = ox.orb_describe_plain(*args)
    torch.cuda.synchronize()
    err_b = float((ang_k - ang_p).abs().max())
    x = (desc_k ^ desc_p)[valid].cpu().numpy()
    bit_rate = float(np.unpackbits(x.view(np.uint8)).sum()) / max(1, x.size * 32)
    n_valid = int(valid.sum())
    print(f"kernel B orb_describe: {n_valid} keypoints, descriptor "
          f"bit mismatch {bit_rate:.6f}, max |angle diff| {err_b:.3g} rad")
    assert bit_rate <= DESC_MISMATCH_BOUND, "kernel B descriptors disagree"
    assert err_b < 1e-3, "kernel B angles disagree"
    edge = check_describe_edges(dev, ex._tables)
    # this run's work: per valid keypoint the IC moments over the 31x31
    # disc, the 49-tap blur of its bin's distinct pixels, 256 comparisons
    rows.append(dict(
        name="orb_describe", route="cuda",
        source="stella_vslam_tpu_torch/csrc/orb_describe.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:392",
        max_abs_err=err_b, desc_bit_mismatch=bit_rate,
        **_times(lambda: ox.orb_describe(*args)),
        plain_ms=_median_ms(lambda: ox.orb_describe_plain(*args)),
        library_ms=None,
        bin_edge_cases=edge, **_bound(pyr_bytes + 36.0 * ex.num_slots,
                                      _describe_ops(ang_k, valid, ex._tables))))

    # ---- C: gated Hamming top-2 at the local-map shape (C=4096 x N) ----
    N, C = ex.num_slots, 4096
    (q_desc, kp_desc, row_ok, col_ok), wkw = window_case(dev, ex, desc_k, px, py, valid, C)
    win = wkw["window"]
    ori = H.OrientGate(torch.cos(ang_k), torch.sin(ang_k), torch.cos(ang_k),
                       torch.sin(ang_k), cos_30deg())
    cells = H.build_cell_index(win.col_u, win.col_v, 752.0, 480.0)
    ci_plain = H.build_cell_index_plain(win.col_u, win.col_v, 752.0, 480.0)
    torch.cuda.synchronize()
    assert same_cells(cells.start[None], cells.order[None], ci_plain.start[None],
                      ci_plain.order[None]), "kernel C's cell index disagrees with its plain version"
    cases = [("phase 3 window 4096 x 2872", (q_desc, kp_desc, row_ok, col_ok), wkw),
             ("brute force 2872 x 2872 with the orientation gate",
              (kp_desc, kp_desc, valid, valid), dict(orient=ori)),
             ("brute force 2872 x 2872 without a gate", (kp_desc, kp_desc, valid, valid), {})]
    cases += _cell_cases(dev)
    differ_c = check_top2_cases(cases)
    print(f"kernel C hamming_top2: {len(cases)} cases, rows differing from plain {differ_c}; "
          f"kernel C's cell index equal to plain at {N} slots")
    assert differ_c == 0, "kernel C disagrees with its plain version"
    a, kw = cases[0][1], cases[0][2]
    visited = int(H.pairs_visited(*a, **kw))
    n_cand = float(H.gate_matrix(row_ok, col_ok, win, None).sum())
    # this run's work: the gates on every visited pair (~8 operations), XOR
    # + popcount + add over 8 words and the top-2 on each candidate (~24);
    # bytes: the rows' descriptors, gate fields and outputs, the targets'
    # descriptors and fields, the index
    rows.append(dict(
        name="hamming_top2", counter="hamming_top2_window", route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/hamming.py:31", max_abs_err=float(differ_c),
        shape=f"{C}x{N} window (the local-map stage): the cell index's launch and the cell walk",
        rows_differing=differ_c,
        pairs_visited=visited, dense_pairs=C * N,
        **_times(lambda: H.hamming_top2(*a, **kw)),
        plain_ms=_median_ms(lambda: H.hamming_top2_plain(*a, **kw)),
        library_ms=None,
        **_bound(C * (32 + 25 + 16) + N * (32 + 17) + 4.0 * (cells.start.numel() + N),
                 8.0 * visited + 24.0 * n_cand)))
    a, kw = cases[1][1], cases[1][2]
    n_ok = int(valid.sum())
    n_cand = float(H.gate_matrix(valid, valid, None, ori).sum())
    rows.append(dict(
        name="hamming_top2_brute", route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/robust.py:92", max_abs_err=float(differ_c),
        shape=f"{N}x{N} brute force with the orientation gate (the keyframe fallback)",
        **_times(lambda: H.hamming_top2(*a, **kw)),
        plain_ms=_median_ms(lambda: H.hamming_top2_plain(*a, **kw)),
        library_ms=None,
        # this run's work: col_ok and the cosine gate (~4 operations) on
        # each pair of a valid row and a target; XOR + popcount + add over 8
        # words and the top-2 (~28) on each candidate
        brute_candidates=int(n_cand),
        **_bound(N * (32 + 1 + 8) * 2 + N * 16, 4.0 * n_ok * N + 28.0 * n_cand)))
    cu, cv = win.col_u, win.col_v
    rows.append(dict(
        name="cell_index", route="cuda", source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/hamming.py:31 (the windows of the [M,N] matrix)",
        max_abs_err=0.0, shape=f"N={N} slots, 752x480 in {cells.gx}x{cells.gy} cells",
        **_times(lambda: H.build_cell_index(cu, cv, 752.0, 480.0)),
        plain_ms=_median_ms(lambda: H.build_cell_index_plain(cu, cv, 752.0, 480.0)),
        library_ms=_device_ms(lambda: torch.argsort(cu, stable=True)),
        library_one_call_ms=_median_ms(lambda: torch.argsort(cu, stable=True)),
        library_call="torch.argsort(stable=True) of N keys",
        # (u, v) read, order and the cell starts written; ~20 operations a
        # target (its cell and an atomic) twice
        **_bound(N * 8.0 + N * 4.0 + 4.0 * cells.start.numel(), 40.0 * N)))

    # ---- D: motion-only pose optimization, N slots, 20% outliers ----
    rng = np.random.default_rng(3)
    dprobs = [_pose_problem(dev, rng, N, params) for _ in range(2)]
    cam = dprobs[0][-1]
    t_true = dprobs[0][-2]
    batch = [torch.stack([p[i] for p in dprobs]) for i in range(7)]
    rk = pose_mod.optimize_pose_batch(*batch, cam)
    err_d, agree = 0.0, 1.0
    for b, p in enumerate(dprobs):
        rp = pose_mod.optimize_pose_plain(*p[:7], cam)
        err_d = max(err_d, float((rk.R_cw[b] - rp.R_cw).abs().max()),
                    float((rk.t_cw[b] - rp.t_cw).abs().max()))
        agree = min(agree, float((rk.is_inlier[b] == rp.is_inlier).float().mean()))
    r1 = pose_mod.optimize_pose(*dprobs[0][:7], cam)
    same = _same(tuple(r1), tuple(f[0] for f in pose_mod.optimize_pose_batch(*batch, cam)))
    torch.cuda.synchronize()
    print(f"kernel D pose_lm: a batch of 2 problems of N={N} in one launch ({pose_mod.CLUSTER} "
          f"blocks a problem), max |pose diff| against the plain version of each {err_d:.3g}, "
          f"inlier agreement {agree:.5f}, pose error vs truth "
          f"{float(np.abs(rk.t_cw[0].cpu().numpy() - t_true).max()):.3g} m; the batch of one "
          f"equal to the batch's first problem: {same}")
    assert err_d < 1e-4 and agree >= 0.99, "kernel D disagrees with its plain version"
    assert same, "kernel D's problem changed with the batch around it"
    one = lambda: pose_mod.optimize_pose(*dprobs[0][:7], cam)
    # 2 problems x (4 rounds x 11 evaluations + 1 final pass), ~150 flops a
    # slot; 34 bytes a slot in
    rows.append(dict(
        name="pose_lm", route="cuda",
        source="stella_vslam_tpu_torch/csrc/pose_lm.cu",
        replaces="stella_vslam_tpu/ops/optim/pose.py:39",
        max_abs_err=err_d, inlier_agreement=agree,
        shape=f"a batch of 2 problems of N={N} (the cascade's stages 2 and 1), "
              f"{pose_mod.CLUSTER} blocks a problem",
        **_times(lambda: pose_mod.optimize_pose_batch(*batch, cam), reps=10),
        ms_batch_of_one=_device_ms(one), one_call_ms_batch_of_one=_median_ms(one),
        plain_ms=_median_ms(lambda: pose_mod.optimize_pose_batch_plain(*batch, cam), reps=3,
                            warmup=1),
        library_ms=None, **_bound(2 * N * 34.0, 2 * 45.0 * 150.0 * N)))
    return rows


def window_case(dev, ex, desc, px, py, valid, C: int = 4096, seed: int = 7):
    """Phase 3's window call of kernel C (the local-map stage's shape): C
    table rows, near-copies of the frame's descriptors reprojected within
    ~3 px of their keypoint, against the frame's slots (`ex`'s, with the
    descriptors and level-0 positions of kernels A and B). Returns
    hamming_top2's (args, kw)."""
    import torch

    from stella_vslam_tpu_torch.match import hamming as H

    g = torch.Generator(device="cpu").manual_seed(seed)
    N = ex.num_slots
    kp_uv = torch.stack([px.float(), py.float()], -1) * ex._slot_scale[:, None]
    src = torch.randint(0, N, (C,), generator=g).to(dev)
    flips = torch.randint(0, 2, (C, 8), generator=g, dtype=torch.int32).to(dev) \
        << torch.randint(0, 32, (C, 8), generator=g, dtype=torch.int32).to(dev)
    q_desc = (desc[src] ^ flips).contiguous()
    level = ex._slot_level
    kp_xr = torch.where(torch.rand(N, generator=g).to(dev) < 0.5,
                        kp_uv[:, 0] - 30.0, torch.full((N,), -1.0, device=dev))
    pred = level[src]
    win = H.WindowGate(
        row_u=(kp_uv[src, 0] + torch.randn(C, generator=g).to(dev) * 3).contiguous(),
        row_v=(kp_uv[src, 1] + torch.randn(C, generator=g).to(dev) * 3).contiguous(),
        row_xr=kp_xr[src].contiguous(),
        row_rad=5.0 * torch.tensor(ex.params.scale_factors, device=dev)[pred.long()],
        row_lo=torch.clamp(pred - 1, min=0), row_hi=torch.clamp(pred + 1, max=7),
        col_u=kp_uv[:, 0].contiguous(), col_v=kp_uv[:, 1].contiguous(),
        col_xr=kp_xr.contiguous(), col_level=level, extent=(752.0, 480.0))
    row_ok = torch.rand(C, generator=g).to(dev) < 0.9
    col_ok = valid & (torch.rand(N, generator=g).to(dev) < 0.8)
    return (q_desc, desc, row_ok, col_ok), dict(window=win)


def _pose_problem(dev, rng, N, params, model: str = "perspective"):
    """Phase 3's pose problem: N slots over a 752x480 stereo camera (half
    the rows stereo), or with model "equirectangular" over a 640x320
    sphere (no stereo rows); 20% of the observations moved 10-40 px, 5%
    invalid. Returns optimize_pose's seven tensors, the true translation
    and the camera."""
    import torch

    from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

    if model == "perspective":
        cam = CamScalars(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752.0,
                         height=480.0, focal_x_baseline=float(np.float32(458.0 * 0.12)))
        uv_true = np.stack([rng.uniform(10, 742, N), rng.uniform(10, 470, N)], -1)
        z = rng.uniform(2.0, 6.0, N)
        pc = np.stack([(uv_true[:, 0] - cam.cx) * z / cam.fx,
                       (uv_true[:, 1] - cam.cy) * z / cam.fy, z], -1)
    else:
        cam = CamScalars(fx=1.0, fy=1.0, cx=320.0, cy=160.0, width=640.0, height=320.0,
                         focal_x_baseline=0.0)
        d = rng.normal(size=(N, 3))
        pc = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(2.0, 6.0, (N, 1))
        lon = np.arctan2(pc[:, 0], pc[:, 2])
        lat = np.arcsin(pc[:, 1] / np.linalg.norm(pc, axis=1))
        uv_true = np.stack([cam.cx + lon * cam.width / (2 * np.pi),
                            cam.cy + lat * cam.height / np.pi], -1)
    ang = 0.05
    R_true = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
    t_true = np.array([0.1, -0.05, 0.2])
    pos_w = (pc - t_true) @ R_true  # R^T (pc - t)
    obs = uv_true + rng.normal(0, 1.0, (N, 2))
    out = rng.random(N) < 0.2
    obs[out] += rng.uniform(-40, 40, (int(out.sum()), 2))
    xr = (np.where(rng.random(N) < 0.5, obs[:, 0] - cam.focal_x_baseline / z, -1.0)
          if model == "perspective" else np.full(N, -1.0))
    lvl = rng.integers(0, 8, N)
    inv_sig = np.asarray(params.inv_level_sigma_sq)[lvl]
    f32 = lambda a_: torch.as_tensor(np.asarray(a_, np.float32), device=dev)
    tilt = np.array([[1, 0, 0], [0, np.cos(0.02), -np.sin(0.02)], [0, np.sin(0.02), np.cos(0.02)]])
    return (f32(R_true @ tilt), f32(t_true + 0.03), f32(pos_w), f32(obs), f32(xr), f32(inv_sig),
            torch.as_tensor(rng.random(N) < 0.95, device=dev), t_true, cam)


def _cell_cases(dev, seed: int = 21):
    """Kernel C's edge cases at the slice's widths (752x480, 2872 targets):
    undistorted fisheye and division keypoints far outside the image, NaN
    coordinates, rows with empty windows (negative, zero, out of the
    targets' reach), calls whose rows all fail row_ok, one target, and ties
    at equal distance. Returns [(label, args, kwargs)], each window case
    with its cell index over 752x480."""
    import torch

    from stella_vslam_tpu_torch.match import hamming as H

    rng = np.random.default_rng(seed)
    out = []

    def case(label, M, N, spread=1.0, rad=(5.0, 80.0), ok_rate=0.9, nan_rate=0.0,
             ties=False, empty=False):
        q = rng.integers(-2 ** 31, 2 ** 31, (M, 8), dtype=np.int64)
        t = rng.integers(-2 ** 31, 2 ** 31, (N, 8), dtype=np.int64)
        k = min(M, N)
        t[:k] = q[:k] ^ (rng.integers(0, 2, (k, 8)) << rng.integers(0, 32, (k, 8)))
        if ties:
            t = t[rng.integers(0, max(1, N // 8), N)]
        cu = 376.0 + (rng.uniform(0, 752, N) - 376.0) * spread
        cv = 240.0 + (rng.uniform(0, 480, N) - 240.0) * spread
        cu[rng.random(N) < nan_rate] = np.nan
        src = rng.integers(0, N, M)
        ru = np.nan_to_num(cu[src], nan=100.0) + rng.normal(0, 4, M)
        rv = cv[src] + rng.normal(0, 4, M)
        rad_r = rng.uniform(*rad, M)
        if empty:
            rad_r[::3], rad_r[1::3], ru[2::3] = -1.0, 0.0, 9000.0
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
        lo = rng.integers(0, 6, M)
        win = H.WindowGate(
            row_u=f32(ru), row_v=f32(rv), row_xr=f32(np.where(rng.random(M) < 0.5, ru - 30, -1)),
            row_rad=f32(rad_r), row_lo=i32(lo), row_hi=i32(lo + 2), col_u=f32(cu),
            col_v=f32(cv), col_xr=f32(np.where(rng.random(N) < 0.5, cu - 30, -1)),
            col_level=i32(rng.integers(0, 8, N)), extent=(752.0, 480.0))
        args = (torch.as_tensor(q.astype(np.int32), device=dev),
                torch.as_tensor(t.astype(np.int32), device=dev),
                torch.as_tensor(rng.random(M) < ok_rate, device=dev),
                torch.as_tensor(rng.random(N) < 0.9, device=dev))
        out.append((label, args, dict(window=win)))

    case("fisheye keypoints to 5x the image", 2872, 2872, spread=5.0)
    case("division keypoints to 40x the image", 1000, 2872, spread=40.0, rad=(5.0, 400.0))
    case("NaN coordinates", 2872, 2872, nan_rate=0.05)
    case("empty windows", 1500, 2872, empty=True)
    case("all rows fail row_ok", 4096, 2872, ok_rate=0.0)
    case("one target", 300, 1, rad=(50.0, 800.0))
    case("ties at equal distance", 2872, 2872, ties=True)
    label, args, kw = out[-1]
    out.append(("ties, brute force", args, {}))
    out.append(("all rows fail row_ok, brute force", out[4][1], {}))
    return out


def check_top2_cases(cases, verbose=True) -> int:
    """Kernel C against its plain version (the dense walk) on each case:
    rows differing, summed; each window case's visited pairs printed beside
    the dense count."""
    import torch

    from stella_vslam_tpu_torch.match import hamming as H

    total = 0
    for label, a, kw in cases:
        k = H.hamming_top2(*a, **kw)
        p = H.hamming_top2_plain(*a, **kw)
        differ = torch.zeros(a[0].shape[0], dtype=torch.bool, device=a[0].device)
        for u, v in zip(k, p):
            differ |= u != v
        n = int(differ.sum())
        total += n
        if verbose:
            M, N = a[0].shape[0], a[1].shape[0]
            walk = (f", pairs visited {int(H.pairs_visited(*a, **kw))} of the dense walk's "
                    f"M x N = {M * N}" if kw.get("window") is not None else "")
            print(f"  kernel C {label}: {M} x {N}, rows differing {n}{walk}")
    return total


def _two_view(dev, n, planar, seed):
    """n matches of a 752x480 camera pair with 30% outliers, 10% invalid."""
    import torch

    rng = np.random.default_rng(seed)
    fx, cx, cy = 458.0, 376.0, 240.0
    uv1 = np.stack([rng.uniform(10, 742, n), rng.uniform(10, 470, n)], -1)
    z = np.full(n, 4.0) if planar else rng.uniform(2.0, 8.0, n)
    X = np.stack([(uv1[:, 0] - cx) * z / fx, (uv1[:, 1] - cy) * z / fx, z], -1)
    Xc = X + np.array([0.3, 0.02, 0.05])
    uv2 = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    uv2 = uv2 + rng.normal(0, 0.7, uv2.shape)
    out = rng.random(n) < 0.3
    uv2[out] = np.stack([rng.uniform(0, 752, out.sum()), rng.uniform(0, 480, out.sum())], -1)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
    return f(uv1), f(uv2), torch.as_tensor(rng.random(n) < 0.9, device=dev)


def _ba_problem(dev, K, L, D, stereo, seed, spacing=0.4, ordered=False):
    """A BA problem: K cameras `spacing` m apart, L points 2.5-4.5 m away, D
    observers each, 0.5 px noise, 5% gross outliers, camera 0 fixed.
    `ordered`: the local BA's layout (runs of 64 landmarks share their
    observers in slot order, 10% of the slots padded and pointing at camera
    0), where whole warps of kernel F add into one camera block."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    rng = np.random.default_rng(seed)
    fx, cx, cy, fxb = 458.0, 376.0, 240.0, float(np.float32(458.0 * 0.12))
    t = np.stack([[-spacing * k, 0.1 * spacing * k, 0.0] for k in range(K)])
    X = np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1, 1, L),
                  rng.uniform(2.5, 4.5, L)], -1)
    oc = np.stack([rng.permutation(K)[:D] for _ in range(L)]).astype(np.int32)
    if ordered:
        oc = np.stack([(np.arange(D) + l // 64) % K for l in range(L)]).astype(np.int32)
    Xc = X[:, None, :] + t[oc]
    uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fx * Xc[..., 1] / Xc[..., 2] + cy], -1)
    xr = np.where(rng.random((L, D)) < (0.5 if stereo else 0.0),
                  uv[..., 0] - fxb / Xc[..., 2], -1.0)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.random((L, D)) < 0.05
    uv[out] += 25.0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=dev)
    cam_t = t + np.concatenate([[[0, 0, 0]], rng.normal(0, 0.01, (K - 1, 3))])
    lm_pos = X + rng.normal(0, 0.01, X.shape)
    valid = rng.random((L, D)) < (0.9 if ordered else 0.95)
    if ordered:
        oc[~valid] = 0
    prob = ba.BAProblem(
        cam_R=f(np.tile(np.eye(3), (K, 1, 1))), cam_t=f(cam_t),
        cam_fixed=b(np.arange(K) == 0), cam_valid=b(np.ones(K)),
        lm_pos=f(lm_pos), lm_valid=b(np.ones(L)),
        obs_cam=torch.as_tensor(oc, device=dev), obs_uv=f(uv), obs_x_right=f(xr),
        obs_inv_sigma_sq=f(np.ones((L, D))), obs_valid=b(valid))
    from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

    return prob, CamScalars(fx, fx, cx, cy, 752.0, 480.0, fxb)


def schur_problem(K, L, D, seed, device="cpu", fixed_share=0.1, invalid_share=0.05,
                  empty_chunk=True, model="perspective"):
    """A seeded BA problem for kernel F's edge cases: K cameras 0.1 m apart,
    L points 2.5-4.5 m away, D observer slots each drawn with repetition (a
    landmark may list a camera twice), 15% of the slots padded (invalid,
    camera 0), half the rest stereo; `fixed_share` of the landmarks fixed,
    `invalid_share` invalid; with `empty_chunk` (and L > 256), landmarks
    128-255 have no valid observation. Returns (BAProblem, CamScalars)."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars

    fx, cx, cy, fxb = 458.0, 376.0, 240.0, float(np.float32(458.0 * 0.12))
    rng = np.random.default_rng(seed)
    t = np.stack([[-0.1 * k, 0.01 * k, 0.0] for k in range(K)])
    X = np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1, 1, L),
                  rng.uniform(2.5, 4.5, L)], -1)
    oc = rng.integers(0, K, (L, D)).astype(np.int32)
    valid = rng.random((L, D)) < 0.85
    if empty_chunk and L > 256:
        valid[128:256] = False
    oc[~valid] = 0
    Xc = X[:, None, :] + t[oc]
    if model == "equirectangular":
        n = np.linalg.norm(Xc, axis=-1)
        uv = np.stack([320.0 + np.arctan2(Xc[..., 0], Xc[..., 2]) * 640.0 / (2 * np.pi),
                       160.0 + np.arcsin(Xc[..., 1] / n) * 320.0 / np.pi], -1)
        xr = -np.ones((L, D))
    else:
        uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fx * Xc[..., 1] / Xc[..., 2] + cy],
                      -1)
        xr = np.where(rng.random((L, D)) < 0.5, uv[..., 0] - fxb / Xc[..., 2], -1.0)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
    prob = ba.BAProblem(
        cam_R=f(np.tile(np.eye(3), (K, 1, 1))),
        cam_t=f(t + np.concatenate([[[0, 0, 0]], rng.normal(0, 0.01, (K - 1, 3))])),
        cam_fixed=b(np.arange(K) == 0), cam_valid=b(np.ones(K)),
        lm_pos=f(X + rng.normal(0, 0.01, X.shape)), lm_valid=b(rng.random(L) >= invalid_share),
        obs_cam=torch.as_tensor(oc, device=device), obs_uv=f(uv), obs_x_right=f(xr),
        obs_inv_sigma_sq=f(np.ones((L, D))), obs_valid=b(valid),
        lm_fixed=b(rng.random(L) < fixed_share))
    cam = CamScalars(fx, fx, cx, cy, 752.0, 480.0, fxb) if model != "equirectangular" \
        else CamScalars(0.0, 0.0, 320.0, 160.0, 640.0, 320.0, 0.0)
    return prob, cam


def bin_edge_keypoints(seed: int = 0, device="cpu"):
    """Kernel B's inputs (pyr, base, H, W, x, y, valid) for keypoints on
    their own images: for each of the 30 steering bins, intensity ramps
    aimed 0.03 rad inside both of its edges and at its centre on 64x64
    images (the keypoint at the centre), a ramp with the keypoint on each
    border and corner (the patch clamped), and a keypoint on an image
    smaller than a patch (9x7 or 31x23, like the top pyramid levels). The
    last keypoint is invalid (angle 0)."""
    import torch

    tau = 2.0 * np.pi / 30
    rng = np.random.default_rng(seed)
    imgs, kps = [], []

    def ramp(h, w, th, x, y):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        img = 128.0 + 3.0 * (np.cos(th) * (xx - x) + np.sin(th) * (yy - y))
        return np.clip(img + rng.normal(0.0, 2.0, (h, w)), 0.0, 255.0).astype(np.float32)

    for b in range(30):
        for th in ((b - 0.5) * tau + 0.03, b * tau, (b + 0.5) * tau - 0.03):
            imgs.append(ramp(64, 64, th, 32, 32))
            kps.append((32, 32))
        th = b * tau + 0.2
        for x, y in ((0, 0), (63, 0), (0, 63), (63, 63), (32, 0), (0, 32), (63, 32), (32, 63)):
            imgs.append(ramp(64, 64, th, x, y))
            kps.append((x, y))
        h, w = (7, 9) if b % 2 else (23, 31)
        imgs.append(ramp(h, w, th, w // 2, h // 2))
        kps.append((w // 2, h // 2))
    base = np.cumsum([0] + [im.size for im in imgs[:-1]])
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=device)
    valid = np.ones(len(imgs), bool)
    valid[-1] = False
    return (t(np.concatenate([im.reshape(-1) for im in imgs]), np.float32),
            t(base, np.int32), t([im.shape[0] for im in imgs], np.int32),
            t([im.shape[1] for im in imgs], np.int32), t([k[0] for k in kps], np.int32),
            t([k[1] for k in kps], np.int32), t(valid, bool))


def _f_route_readings(dev, seeds, B: int = 1024):
    """Where kernel E's F hypotheses part from the plain version. Plain
    projects each null vector to rank 2 by a float32 SVD, the kernel by a
    float64 Jacobi SVD; "plain64" projects plain's null vector in float64,
    the kernel's route for that step. Per seed (a new match set and sample
    seed each), the shares of the B hypotheses with equal inlier counts:
    kernel vs plain, kernel vs plain64, plain vs plain64; and the distance
    of the kernel's rank-2 matrix from plain64's, back in normalized
    coordinates (unit Frobenius norm, up to sign; median and 99th
    percentile). A distance near 0 means the kernel's null vector equals
    plain's up to its smallest singular component."""
    import torch

    from stella_vslam_tpu_torch.ops.solve import fundamental as Fm
    from stella_vslam_tpu_torch.ops.solve import ransac as R

    out = []
    for s in seeds:
        p1, p2, v = _two_view(dev, 2872, False, s)
        Mk, _, nk = R.minimal_hypotheses(Fm.MODEL, s, p1, p2, v, B)
        _, _, npl = R.minimal_hypotheses_plain(Fm.MODEL, s, p1, p2, v, B, 1.0)
        idx = R.sample_minimal_sets(s, v, B, 8)
        Fn, T1, T2 = Fm.null_vector_F(p1[idx], p2[idx])
        T1, T2 = T1.double(), T2.double()
        U, S, Vt = torch.linalg.svd(Fn.double())
        S[..., 2] = 0.0
        Fn64 = U @ (S[..., :, None] * Vt)
        inl, _ = Fm._epipolar_cost((T2.transpose(-1, -2) @ Fn64 @ T1).float(),
                                   p1[None], p2[None], 1.0)
        n64 = (inl & v[None]).sum(-1).to(torch.int32)
        Fnk = torch.linalg.inv(T2.transpose(-1, -2)) @ Mk.double() @ torch.linalg.inv(T1)
        unit = lambda m: m / m.flatten(1).norm(dim=1)[:, None, None]
        a, b = unit(Fnk), unit(Fn64)
        dist = torch.minimum((a - b).flatten(1).norm(dim=1), (a + b).flatten(1).norm(dim=1))
        same = lambda x, y: float((x == y).float().mean())
        gap = (nk - npl).abs()
        out.append(dict(seed=s, kernel_vs_plain=same(nk, npl), kernel_vs_plain64=same(nk, n64),
                        plain_vs_plain64=same(npl, n64), dist_p50=float(dist.median()),
                        dist_p99=float(torch.quantile(dist.float(), 0.99)),
                        count_diff_max=int(gap.max()),
                        count_diff_mean_where_differ=float(gap[gap > 0].float().mean())
                        if bool((gap > 0).any()) else 0.0))
    return out


# kernel E: the integer operations of one hashed flat index (an add, three
# shift-xor pairs, two multiplies, the final shift, the argmax's compare
# and select), and the shares of hypotheses whose inlier count equals
# plain's on check_init_kernels' pairs at seed 11 as the block-wide fit read
# them (scripts/torch_ransac_posegraph_probe.py, H100 80GB HBM3, 700.00 W)
E_HASH_INT_OPS = 12
E_SHARE_HELD = {"H": 0.9453125, "F": 0.767578125}


def check_init_kernels(dev, world):
    """C's angle gate, E and F-I against their plain versions at the mono
    slice's shapes; returns rows E, F, G, H, I."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import area
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.ops.solve import fundamental as Fm
    from stella_vslam_tpu_torch.ops.solve import homography as Hm
    from stella_vslam_tpu_torch.ops.solve import ransac as R
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    rows = []
    # ---- C, angle-gate mode: the area matcher between two bench frames ----
    ex = ox.OrbExtractor(OrbParams(num_levels=8), 752, 480, min_area=800, device=dev)
    f1 = ex.extract(torch.from_numpy(world.render(pose_at_xy(0.0, 0.0))).to(dev))
    f2 = ex.extract(torch.from_numpy(world.render(pose_at_xy(0.09, 0.0))).to(dev))
    N = ex.num_slots
    ori = H.AngleGate(f1.angle.contiguous(), f2.angle.contiguous(), area.ANGLE_THR)
    ok1 = f1.valid & (f1.level == 0)
    gate = dict(orient=ori)
    k = H.hamming_top2(f1.desc, f2.desc, ok1, f2.valid, **gate)
    p = H.hamming_top2_plain(f1.desc, f2.desc, ok1, f2.valid, **gate)
    differ = torch.zeros(N, dtype=torch.bool, device=dev)
    for u, v in zip(k, p):
        differ |= u != v
    share = float(differ.float().mean())
    idx_k, acc_k, _ = area.match_in_consistent_area(
        f1.level, f1.desc, f1.angle, f1.valid, f1.xy, f2.xy, f2.level, f2.desc,
        f2.angle, f2.valid, image_size=(752.0, 480.0))
    torch.cuda.synchronize()
    print(f"kernel C angle gate: {N}x{N}, rows differing from plain {share:.6f}; "
          f"area matcher accepted {int(acc_k.sum())} matches")
    assert share <= 1e-3, "kernel C's angle gate disagrees with its plain version"

    # ---- E: H and F RANSAC, 1024 hypotheses x N matches ----
    B = 1024
    pl = _two_view(dev, N, True, 1)
    gen = _two_view(dev, N, False, 2)
    res = {}
    for name, mod, data in (("H", Hm, pl), ("F", Fm, gen)):
        rk = R.find_core(mod.MODEL, 7 + len(name), *data, B, 1.0, 0)
        rp = R.find_core_plain(mod.MODEL, 7 + len(name), *data, B, 1.0, 0)
        n_k, n_plain = int(rk.num_inliers), int(rp.num_inliers)
        res[name] = (n_k, n_plain, abs(float(rk.cost) - float(rp.cost)))
        print(f"kernel E {name}: best inlier count {n_k} (plain {n_plain}), "
              f"cost {float(rk.cost):.6g} (plain {float(rp.cost):.6g})")
        assert bool(rk.valid) and bool(rp.valid) and n_k == n_plain, \
            f"kernel E {name} disagrees with its plain version"
    # hypothesis by hypothesis on seed 11, the share with plain's inlier
    # count, held to the block-wide fit's reading on the same data
    shares, launches = {}, {}
    for name, mod, data in (("H", Hm, pl), ("F", Fm, gen)):
        _, _, nk = R.minimal_hypotheses(mod.MODEL, 11, *data, B)
        _, _, npl = R.minimal_hypotheses_plain(mod.MODEL, 11, *data, B, 1.0)
        shares[name] = float((nk == npl).float().mean())
        n0 = R.minimal_hypotheses.launches
        rk = R.find_core(mod.MODEL, 11, *data, B, 1.0, 1)
        launches[name] = R.minimal_hypotheses.launches - n0
        rp = R.find_core_plain(mod.MODEL, 11, *data, B, 1.0, 1)
        print(f"kernel E {name} hypotheses: {shares[name]:.4f} of {B} with plain's inlier count "
              f"(the block-wide fit read {E_SHARE_HELD[name]}); a batch with 1 LO round is "
              f"{launches[name]} launches; winner {int(rk.num_inliers)} inliers (plain "
              f"{int(rp.num_inliers)})")
        assert shares[name] >= E_SHARE_HELD[name] and launches[name] == 2, \
            f"kernel E {name}'s hypotheses agree with plain less than before"
    seeds = list(range(100, 108))
    for name, mod, data in (("H", Hm, pl), ("F", Fm, gen)):
        n0 = R.minimal_hypotheses.launches
        esc = mod.find_via_ransac_escalated(seeds, *data)
        n_esc = R.minimal_hypotheses.launches - n0
        ref = R.escalate(lambda s: R.find_core_plain(mod.MODEL, s, *data, 4096, 1.0, 3),
                         seeds)
        print(f"kernel E {name} escalated 8x4096 + 3 LO: {int(esc.num_inliers)} "
              f"inliers (plain {int(ref.num_inliers)}), {n_esc} launches")
        assert bool(esc.valid) and abs(int(esc.num_inliers) - int(ref.num_inliers)) \
            <= 0.01 * int(ref.num_inliers) and n_esc == 2, f"escalated {name} disagrees"
    for r in _f_route_readings(dev, (2, 3, 4, 5)):
        print("kernel E F route: " + json.dumps(r))
    # the LO refit's normalisation (XLA's windows of 32) equals the plain's
    # bits, on the slice's matches and past the window rules' edges
    apart = {}
    for name, data in (("H", pl), ("F", gen)):
        for n in (N, 1199, 700, 33):
            mask = data[2][:n] & (torch.arange(n, device=dev) % 3 != 0)
            args = (data[0][:n].contiguous(), data[1][:n].contiguous(), mask.contiguous())
            k = R.refit_normalization(*args)
            q = R.refit_normalization(*(a.cpu() for a in args))
            apart[f"{name} N={n}"] = int((k.cpu().view(torch.int32) != q.view(torch.int32)).sum())
    print(f"kernel E LO refit normalisation, elements apart from plain's bits: {apart}")
    assert not any(apart.values()), "kernel E's refit normalisation differs from plain's bits"

    def run_e(core):
        for mod, data in ((Hm, pl), (Fm, gen)):
            core(mod.MODEL, data)
    kern = lambda m, d: R.find_core(m, 11, *d, B, 1.0, 0)
    plain = lambda m, d: R.find_core_plain(m, 11, *d, B, 1.0, 0)
    # per attempt, for H (k=4) and F (k=8): the hash of B*k*N flat indices
    # (integer: E_HASH_INT_OPS each), the score of B*N pairs (~40 flops),
    # 18 squarings of 9x9 and A^T A per hypothesis
    e_int = sum(B * k_ * N * E_HASH_INT_OPS for k_ in (4, 8))
    e_ops = sum(B * N * 40.0 + B * (18 * 729 * 2 + 2 * k_ * 81 * 2) for k_ in (4, 8))
    rows.append(dict(
        name="ransac_two_view", route="cuda",
        source="stella_vslam_tpu_torch/csrc/ransac_two_view.cu",
        replaces="stella_vslam_tpu/ops/solve/homography.py:107",
        max_abs_err=max(v[2] for v in res.values()),
        hypotheses_count_equal_plain=shares, launches_standard_batch=launches,
        **_times(lambda: run_e(kern), reps=10),
        plain_ms=_median_ms(lambda: run_e(plain), reps=5, warmup=1),
        library_ms=None, **_bound(2 * (N * 17.0 + B * 44.0), e_ops, e_int)))

    # ---- F, G, H: bundle adjustment ----
    errs = []
    for K, L, D, stereo in ((2, 4096, 2, False), (8, 4096, 4, True)):
        prob, cam = _ba_problem(dev, K, L, D, stereo, K)
        errs.append(_compare_ba(prob, cam, f"K={K} L={L} D={D}"
                                f"{' stereo' if stereo else ''}"))
    prob, cam = _ba_problem(dev, 2, 4096, 2, False, 2)
    rows += _time_ba_kernels(dev, max(errs), prob, cam)
    return rows


def _ray_sensitivity(prob, res, inlier):
    """Per landmark, how far it moves along its rays per radian of pose
    difference: depth^2 / baseline, with the baseline the farthest pair of
    its inlier observers' camera centres and the depth to the nearest."""
    import torch

    C = -(res.cam_R.transpose(1, 2) @ res.cam_t[..., None])[..., 0]  # [K,3]
    Co = C[prob.obs_cam.long().clamp(min=0)]  # [L,D,3]
    pair = inlier[:, :, None] & inlier[:, None, :]
    base = torch.where(pair, torch.linalg.norm(Co[:, :, None] - Co[:, None], dim=-1),
                       torch.zeros((), device=Co.device)).amax((1, 2))
    depth = torch.where(inlier, torch.linalg.norm(res.lm_pos[:, None] - Co, dim=-1),
                        torch.full((), float("inf"), device=Co.device)).amin(1)
    return depth * depth / base


def _compare_ba(prob, cam, label, num_first=5, num_second=10):
    """bundle_adjust (kernels F-I) against bundle_adjust_plain; fails unless
    poses agree within 1e-4, points seen twice within 1e-3 and the outlier
    flags are identical. Returns the max pose difference."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    kw = dict(num_first=num_first, num_second=num_second)
    rk = ba.bundle_adjust(prob, cam, **kw)
    rp = ba.bundle_adjust_plain(prob, cam, **kw)
    torch.cuda.synchronize()
    e_pose = max(float((rk.cam_R - rp.cam_R).abs().max()),
                 float((rk.cam_t - rp.cam_t).abs().max()))
    same = bool(torch.equal(rk.obs_is_outlier, rp.obs_is_outlier))
    good = (prob.obs_valid & ~rp.obs_is_outlier).sum(1) >= 2
    e_pts = float((rk.lm_pos - rp.lm_pos).abs().amax(-1)[good].max()) if bool(good.any()) else 0.0
    n_flag = int((rk.obs_is_outlier != rp.obs_is_outlier).sum())
    print(f"kernels F-I bundle_adjust {label}: max |pose diff| {e_pose:.3g}, points "
          f"seen twice {e_pts:.3g}, outlier flags identical {same} ({n_flag} differ), cost "
          f"{float(rk.cost):.6g} (plain {float(rp.cost):.6g})")
    assert e_pose < 1e-4 and e_pts < 1e-3 and same, \
        f"kernels F-I disagree with the plain BA at {label}"
    return e_pose


def _f_scale(prob, cam, R, t, p, inlier, lam, use_huber, model="perspective"):
    """Per entry of kernel F's outputs (Hcc, b_c, S_red, rhs_red), the sum of
    the absolute values of the terms it adds up. Float32 rounding of a sum
    is relative to that, not to the sum itself, which cancels near a
    minimum: the gradient b_c and rhs_red of a converged problem are far
    smaller than their terms."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    K = R.shape[0]
    oc = prob.obs_cam.long()
    r, Jc, Jp, depth_ok = ba._pose_rows(prob, R, t, p, cam, model)
    wr = ba._row_weights(prob, r, depth_ok, inlier, use_huber, model)[0].abs()[..., None]
    aJcw, aJpw, aJc, aJp, ar = (Jc.abs() * wr, Jp.abs() * wr, Jc.abs(), Jp.abs(), r.abs())
    _, (Hpp, _, _, _, _, _) = ba._linearize(prob, R, t, p, inlier, cam, use_huber, model)
    aW = torch.einsum("ldri,ldra->ldia", aJcw, aJp)
    aA = aW @ ba._sym3_inv(Hpp, lam).abs()[:, None]
    abp = torch.einsum("ldri,ldr->li", aJpw, ar)

    def scatter(index, terms, shape):
        out = torch.zeros(shape, dtype=R.dtype, device=R.device)
        return out.index_add_(0, index, terms.reshape((-1,) + tuple(shape[1:])))

    Hcc = scatter(oc.reshape(-1), torch.einsum("ldri,ldrj->ldij", aJcw, aJc), (K, 6, 6))
    b_c = scatter(oc.reshape(-1), torch.einsum("ldri,ldr->ldi", aJcw, ar), (K, 6))
    pair = (oc[:, :, None] * K + oc[:, None, :]).reshape(-1)
    S = scatter(pair, torch.einsum("ldia,leja->ldeij", aA, aW), (K * K, 6, 6))
    rhs = scatter(oc.reshape(-1), (aA @ abp[:, None, :, None])[..., 0], (K, 6))
    return Hcc, b_c, S.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K), \
        rhs.reshape(-1)


F_PARTS = ("Hcc", "b_c", "S_red", "rhs_red", "cost")


def _f_against_plain(st, prob, prob64, cam, R, t, p, inlier, lam, use_huber, model):
    """Kernel F's system on st (after its launch at the state R, t, p) and
    plain F's, each against plain F in float64, entry by entry relative to
    _f_scale: {f_<part>: kernel's error, f_<part>_plain: plain's, f_excess:
    the kernel's over 10x plain's plus 1e-4}; the kernel's (Hcc, b_c, S_red,
    rhs_red); (plain F's cost, landmark terms, and those in float64)."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    c0, Hcc, b_c, S_red, rhs_red, terms = ba.linearize_schur_plain(
        prob, cam, R, t, p, inlier, lam, use_huber, model)
    iu = torch.triu_indices(6, 6, device=prob.cam_R.device)
    hc = st.hc.clone()
    Hcc_k = torch.zeros_like(Hcc)
    Hcc_k[:, iu[0], iu[1]] = hc[:, :21]
    Hcc_k[:, iu[1], iu[0]] = hc[:, :21]
    b_c_k, S_k, rhs_k = hc[:, 21:], st.S.clone(), st.rhs.clone()
    c64, *f64, terms64 = ba.linearize_schur_plain(
        prob64, cam, R.double(), t.double(), p.double(), inlier, lam.double(), use_huber, model)
    scale = _f_scale(prob, cam, R, t, p, inlier, lam, use_huber, model) + (c0,)
    errs = {"f_excess": 0.0}
    for name, u, v, e, m in zip(F_PARTS, (Hcc_k, b_c_k, S_k, rhs_k, st.ctrl[ba._COST0]),
                                (Hcc, b_c, S_red, rhs_red, c0), f64 + [c64], scale):
        m = m.double().clamp(min=1e-30)
        ek = float(((u.double() - e).abs() / m).max())
        ep = float(((v.double() - e).abs() / m).max())
        errs[f"f_{name}"], errs[f"f_{name}_plain"] = ek, ep
        errs["f_excess"] = max(errs["f_excess"], ek / (10.0 * ep + 1e-4))
    return errs, (Hcc_k, b_c_k, S_k, rhs_k), (c0, terms, terms64)


def check_f_cases(dev) -> dict:
    """Kernel F on its edge cases: its pair index equal to the plain index
    (ba.schur_index_equal), one launch's system within _lockstep_ba's F
    bound of plain F (f_excess < 1) and a second launch bit-identical.
    Cases: the local shape with random observers (ordered=False), L = 4096
    + 37, one camera (K = 1, cameras repeated within a landmark), K = 130
    (S in 780 x 780), fixed rows and a chunk with no valid observation, the
    equirectangular model. Returns {case: readings}."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    cases = [("local K=16 L=4096 D=12 ordered=False",
              *_ba_problem(dev, 16, 4096, 12, False, 16, spacing=0.1), "perspective"),
             ("local K=16 L=4133 D=12",
              *_ba_problem(dev, 16, 4133, 12, False, 16, spacing=0.1, ordered=True),
              "perspective"),
             ("K=1 L=300 D=3", *schur_problem(1, 300, 3, 81, dev), "perspective"),
             ("K=130 L=1024 D=8", *schur_problem(130, 1024, 8, 82, dev), "perspective"),
             ("K=16 L=1000 D=12 fixed rows and an empty chunk",
              *schur_problem(16, 1000, 12, 83, dev, fixed_share=0.2), "perspective"),
             ("equirect K=6 L=700 D=4",
              *schur_problem(6, 700, 4, 84, dev, model="equirectangular"), "equirectangular")]
    out = {}
    for label, prob, cam, model in cases:
        st = ba._KernelState(prob, cam, model)
        same_index = ba.schur_index_equal(st.index, ba.schur_index_plain(
            prob.obs_cam, prob.obs_valid, prob.lm_valid, prob.lm_fixed, st.K))
        lam = torch.tensor(1e-4, device=dev)
        st.ctrl[ba._LAM] = lam
        inlier = torch.ones_like(prob.obs_valid)
        inl = inlier.to(torch.uint8)
        system = lambda: torch.cat([st.hc.flatten(), st.S.flatten(), st.rhs,
                                    st.ctrl[ba._COST0:ba._COST0 + 1], st.Wg.flatten(),
                                    st.lmblk.flatten()]).clone()
        ba.ba_linearize_schur(st, inl, True)
        first = system()
        prob64 = ba.BAProblem(*[v.double() if v is not None and v.is_floating_point() else v
                                for v in prob])
        errs, _, _ = _f_against_plain(st, prob, prob64, cam, prob.cam_R, prob.cam_t,
                                      prob.lm_pos, inlier, lam, True, model)
        ba.ba_linearize_schur(st, inl, True)
        out[label] = dict(index_equal=same_index, f_excess=errs["f_excess"],
                          f_S_red=errs["f_S_red"], f_S_red_plain=errs["f_S_red_plain"],
                          repeat_bit_identical=bool(torch.equal(first, system())),
                          pair_terms=st.index.n_terms)
    print("kernel F edge cases (index equal to plain, F against plain F in float64, two "
          "launches): " + json.dumps(out))
    assert all(r["index_equal"] and r["f_excess"] < 1.0 and r["repeat_bit_identical"]
               for r in out.values()), "kernel F disagrees with plain F on an edge case"
    return out


def _lockstep_ba(prob, cam, num_first, num_second, model="perspective"):
    """Kernels F-I against their plain versions on the same inputs, kernel
    by kernel through bundle_adjust's schedule on the kernels' own state
    (poses, points, lambda, inliers). F: its camera blocks, reduced system
    and cost, and plain F's, each against plain F in float64, entry by entry
    relative to the sum of the absolute values of the entry's terms
    (_f_scale); "f_excess" is the kernel's error over 10x plain's plus 1e-4.
    Plain F's own error there lies far above float32 rounding (the result
    holds it): the float32 inverse of a point's 3x3 block is off by its
    condition number times the rounding, which a point seen from a short
    baseline raises to 1e7 at small damping. G on F's system: the backward error of its step against that
    system in float64 (the step itself differs from plain G's by the
    system's condition number times float32 rounding), and its trial poses
    against Exp(step) composed by plain G. H on G's step: its trial points
    against H in float64 on the same step (a point's float32 3x3 inverse
    carries the same condition-number error as F's, in plain H as in the
    kernel, so plain H is no closer to the truth: "point_share_plain" is
    its own distance), and its trial cost against plain H's. I against
    plain I. The accept /
    stop decisions and the outlier flags count where they differ although
    their deciding quantity lies more than 1e-5 (relative) from its
    threshold. Returns the worst of each over the iterations."""
    import torch

    from stella_vslam_tpu_torch.ops import lie
    from stella_vslam_tpu_torch.ops.optim import ba

    K = prob.cam_R.shape[0]
    st = ba._KernelState(prob, cam, model)
    prob64 = ba.BAProblem(*[v.double() if v is not None and v.is_floating_point() else v
                            for v in prob])
    out = dict({f"f_{n}{w}": 0.0 for n in F_PARTS for w in ("", "_plain")}, f_excess=0.0,
               g_backward=0.0, g_backward_plain=0.0, g_pose=0.0, g_step_diff=0.0,
               point_share=0.0, point_share_plain=0.0, cost_rel=0.0, decisions=0, flags=0,
               iterations=0)
    state = lambda: (st.cam_R.reshape(K, 3, 3).clone(), st.cam_t.clone(), st.lm.clone())
    worst = lambda key, v: out.__setitem__(key, max(out[key], float(v)))

    def backward_error(S, rhs, dx):
        x = dx.double().reshape(-1)
        return float((S @ x + rhs).abs().max() / (S.abs().sum(1).max() * x.abs().max()
                                                  + rhs.abs().max()))

    def classify(final):
        R, t, p = state()
        fk = ba.ba_classify(st, final)
        fp = ba.classify_plain(prob, cam, R, t, p, final, model)
        _, chi2, _ = ba._total_cost(prob, R, t, p, torch.ones_like(prob.obs_valid), cam, False,
                                    model)
        thr = torch.where(prob.obs_x_right > 0, torch.full_like(chi2, ba.CHI_SQ_3D),
                          torch.full_like(chi2, ba.CHI_SQ_2D))
        near = (chi2 / thr - 1.0).abs() <= 1e-5
        out["flags"] += int(((fk != fp) & prob.obs_valid & ~near).sum())
        return fk

    def stage(inlier, use_huber, iters):
        st.ctrl[ba._LAM] = 1e-4
        st.ctrl[ba._DONE] = 0.0
        st.ctrl[ba._LAST_COST] = math.inf
        inl = inlier.to(torch.uint8).contiguous()
        seen = inlier & prob.obs_valid
        twice = (seen.sum(1) >= 2) & prob.lm_valid
        for _ in range(iters):
            if float(st.ctrl[ba._DONE]) != 0.0:
                break
            out["iterations"] += 1
            R, t, p = state()
            lam = st.ctrl[ba._LAM].clone()
            # F
            ba.ba_linearize_schur(st, inl, use_huber)
            errs, (Hcc_k, b_c_k, S_k, rhs_k), (c0, terms, terms64) = _f_against_plain(
                st, prob, prob64, cam, R, t, p, inlier, lam, use_huber, model)
            for key, v in errs.items():
                worst(key, v)
            # G on F's system
            ba.ba_reduced_solve(st)
            dx_p, _, _ = ba.reduced_solve_plain(prob, R, t, Hcc_k, b_c_k, S_k, rhs_k, lam)
            S64, rhs64 = ba.damped_reduced_system(prob, Hcc_k.double(), b_c_k.double(),
                                                  S_k.double(), rhs_k.double(), lam.double())
            worst("g_backward", backward_error(S64, rhs64, st.dx))
            worst("g_backward_plain", backward_error(S64, rhs64, dx_p))
            worst("g_step_diff", (st.dx - dx_p).abs().max())
            Rn, tn = lie.se3_compose(*lie.se3_exp(st.dx.clone()), R, t)
            Rn_k, tn_k = st.cam_Rn.reshape(K, 3, 3).clone(), st.cam_tn.clone()
            worst("g_pose", max(float((Rn_k - Rn).abs().max()), float((tn_k - tn).abs().max())))
            # H on G's step
            pn, cost = ba.backsub_cost_plain(prob, cam, p, terms, st.dx.clone(), Rn_k, tn_k,
                                             inlier, use_huber, model)
            ba.ba_backsub_cost(st, inl, use_huber)
            if bool(twice.any()):
                pn64, _ = ba.backsub_cost_plain(prob64, cam, p.double(), terms64,
                                                st.dx.double(), Rn_k.double(), tn_k.double(),
                                                inlier, use_huber, model)
                trial = ba.BAResult(Rn_k, tn_k, pn, None, None)
                allow = torch.clamp(1e-4 * _ray_sensitivity(prob, trial, seen), min=1e-3)
                share = lambda q: ((q.double() - pn64).abs().amax(-1) / allow)[twice].max()
                worst("point_share", share(st.lmn))
                worst("point_share_plain", share(pn))
            c0, cost = float(c0), float(cost)
            worst("cost_rel", abs(float(st.ctrl[ba._LAST_COST]) - cost) / max(cost, 1e-12))
            # kernel H halves lambda on an accepted step and multiplies it by 4
            # on a rejected one (clamped to [1e-8, 1e4]; 6 rejections from 1e-4
            # stay below 1e4)
            imp_k = float(st.ctrl[ba._LAM]) <= float(lam)
            imp_p, gain = cost < c0, (c0 - cost) / max(c0, 1e-12)
            done_k, done_p = float(st.ctrl[ba._DONE]) != 0.0, imp_p and gain < 1e-3
            if imp_k != imp_p and abs(gain) > 1e-5:
                out["decisions"] += 1
            elif imp_k == imp_p and done_k != done_p and abs(gain - 1e-3) > 1e-5:
                out["decisions"] += 1

    stage(torch.ones_like(prob.obs_valid), True, num_first)
    inlier1 = classify(False)
    if num_second > 0:
        stage(inlier1, False, num_second)
    classify(True)
    return out


def _g_device_ms(st, n: int = DEVICE_TIMED_CALLS) -> float:
    """Kernel G's device time per launch (_device_ms) on st's reduced
    system, as kernel F left it: G clears its inputs, so each of the n
    launches solves its own copy, refilled before each run."""
    import copy

    from stella_vslam_tpu_torch.ops.optim import ba

    saved = (st.hc.clone(), st.S.clone(), st.rhs.clone())
    copies = []
    for _ in range(n):
        c = copy.copy(st)
        c.hc, c.S, c.rhs = (x.clone() for x in saved)
        copies.append(c)
    at = [0]

    def refill():
        for c in copies:
            for dst, src in zip((c.hc, c.S, c.rhs), saved):
                dst.copy_(src)
        at[0] = 0

    def launch():
        ba.ba_reduced_solve(copies[at[0] % n])
        at[0] += 1

    return _device_ms(launch, n=n, warmup=0, before_run=refill)


def _valid_obs(prob) -> int:
    """The observations a BA problem holds: valid slots of valid landmarks."""
    return int((prob.obs_valid & prob.lm_valid[:, None]).sum())


def _ba_work(K: int, L: int, D: int, n_obs=None, n_terms=None) -> dict:
    """Bytes and operations of kernels F, G, H and I on a K, L, D problem
    (one LM iteration; F and H of one landmark shard where L is a shard's).
    F's operations per valid observation (n_obs, all L x D slots if not
    given): Jacobians ~60, Hcc + b_c 27x6, Hpp + b_p 9x6, W 18x6, W G 108 +
    W G b 36; per landmark its inverse ~40; per Schur term of one triangle
    of S (n_terms: the pair index's terms, every landmark's D(D+1)/2 if not
    given) 216. H: D x 108 back-substitution + D x ~60 for the trial
    residuals. G: n^3/3 + 2 n^2. I: the projection and chi-square, ~30 per
    observation."""
    n = 6 * K
    obs_bytes = L * D * 22.0
    n_obs = L * D if n_obs is None else n_obs
    n_terms = L * D * (D + 1) / 2.0 if n_terms is None else n_terms
    return {"F": (obs_bytes + L * 12 + L * D * 72 + L * 40 + n * n * 4,
                  n_obs * (60 + 162 + 54 + 108 + 144) + L * 40 + n_terms * 216.0),
            "G": (n * n * 4.0 + K * 27 * 4 + n * 4 + K * 48, n ** 3 / 3.0 + 2 * n * n),
            "H": (obs_bytes + L * D * 72 + L * 40 + L * 24, L * D * (108 + 60) + L * 30),
            "I": (obs_bytes + L * 12 + L * D, L * D * 30.0)}


def _time_ba_kernels(dev, err, prob, cam, suffix="", model="perspective"):
    """One LM iteration of `prob`, kernel by kernel, against the plain
    version of each, and one classification; rows F, G, H, I (names with
    `suffix`). Device time, n back-to-back launches / n: F with the
    accumulators cleared before each run of n (each launch adds the same
    work), G on its own copy of the system each launch (_g_device_ms), H
    after one F and G with its decision word restored before each launch
    (the restore's own time taken off), I as it is; G's library call the
    same way. one_call_ms: events around each launch of an iteration."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    K, L, D = prob.cam_R.shape[0], prob.obs_cam.shape[0], prob.obs_cam.shape[1]
    inl = torch.ones((L, D), dtype=torch.uint8, device=dev)
    st = ba._KernelState(prob, cam, model)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    times = {"F": [], "G": [], "H": [], "I": []}
    for rep in range(23):
        st.ctrl.zero_()
        st.ctrl[ba._LAM] = 1e-4
        st.hc.zero_(); st.S.zero_(); st.rhs.zero_()
        e = [ev() for _ in range(5)]
        e[0].record()
        ba.ba_linearize_schur(st, inl, True)
        e[1].record()
        ba.ba_reduced_solve(st)
        e[2].record()
        ba.ba_backsub_cost(st, inl, True)
        e[3].record()
        ba.ba_classify(st, True)
        e[4].record()
        e[4].synchronize()
        if rep >= 3:
            for j, name in enumerate("FGHI"):
                times[name].append(e[j].elapsed_time(e[j + 1]))
    lam = torch.tensor(1e-4, device=dev)
    inlb = torch.ones((L, D), dtype=torch.bool, device=dev)
    R0, t0, p0 = prob.cam_R, prob.cam_t, prob.lm_pos
    lin = lambda: ba.linearize_schur_plain(prob, cam, R0, t0, p0, inlb, lam, True, model)
    cost0, Hcc, b_c, S_red, rhs_red, terms = lin()
    solve = lambda: ba.reduced_solve_plain(prob, R0, t0, Hcc, b_c, S_red, rhs_red, lam)
    dx, Rn, tn = solve()
    back = lambda: ba.backsub_cost_plain(prob, cam, p0, terms, dx, Rn, tn, inlb, True, model)
    classify = lambda: ba.classify_plain(prob, cam, R0, t0, p0, True, model)
    # the damped reduced system, for the library solve
    S, rhs = ba.damped_reduced_system(prob, Hcc, b_c, S_red, rhs_red, lam)

    def reset():
        st.ctrl.zero_()
        st.ctrl[ba._LAM] = 1e-4
        st.hc.zero_(); st.S.zero_(); st.rhs.zero_()
    dev_ms = {"F": _device_ms(lambda: ba.ba_linearize_schur(st, inl, True), before_run=reset)}
    reset()
    ba.ba_linearize_schur(st, inl, True)
    ba.ba_reduced_solve(st)
    ctrl0 = st.ctrl.clone()
    restore = lambda: st.ctrl.copy_(ctrl0)
    dev_ms["H"] = (_device_ms(lambda: (restore(), ba.ba_backsub_cost(st, inl, True)))
                   - _device_ms(restore))
    dev_ms["I"] = _device_ms(lambda: ba.ba_classify(st, True))
    # F's system once more, for G's back-to-back launches
    reset()
    ba.ba_linearize_schur(st, inl, True)
    g_dev = dict(ms=_g_device_ms(st), one_call_ms=float(np.median(times["G"])),
                 library_ms=_device_ms(lambda: torch.linalg.solve(S, rhs)),
                 library_one_call_ms=_median_ms(lambda: torch.linalg.solve(S, rhs)),
                 library_call="torch.linalg.solve on the damped system", timing=DEVICE_TIMING)
    work = _ba_work(K, L, D, n_obs=_valid_obs(prob), n_terms=st.index.n_terms)
    rows = []
    for name, fn, plain_fn, replaces in (
            ("ba_linearize_schur", "F", lin, "stella_vslam_tpu/ops/optim/ba.py:416"),
            ("ba_reduced_solve", "G", solve, "stella_vslam_tpu/ops/optim/ba.py:610"),
            ("ba_backsub_cost", "H", back, "stella_vslam_tpu/ops/optim/ba.py:731"),
            ("ba_classify", "I", classify, "stella_vslam_tpu/ops/optim/ba.py:786")):
        nbytes, ops = work[fn]
        row = dict(
            name=name + suffix, route="cuda",
            source="stella_vslam_tpu_torch/csrc/ba_schur.cu", shape=f"K={K} L={L} D={D}",
            replaces=replaces, max_abs_err=err, ms=dev_ms.get(fn),
            one_call_ms=float(np.median(times[fn])), timing=DEVICE_TIMING,
            plain_ms=_median_ms(plain_fn, reps=10), library_ms=None, **_bound(nbytes, ops))
        rows.append(dict(row, **g_dev) if fn == "G" else row)
    return rows


def record_kernel_inputs(mapper):
    """Keep the arguments of every call of the mapper's triangulation and
    fusion entry points and of every bundle_adjust call, by reference only:
    no device work and no host read during the run. Returns (calls, undo)."""
    from stella_vslam_tpu_torch.ops.optim import ba

    calls = {"triangulate": [], "fuse": [], "bundle_adjust": [], "global_ba": []}
    kern = mapper.kernels
    triangulate, fuse, solve = kern.triangulate, kern.fuse, ba.bundle_adjust

    def tri_rec(*args):
        calls["triangulate"].append(args)
        return triangulate(*args)

    def fuse_rec(*args):
        calls["fuse"].append(args)
        return fuse(*args)

    def ba_rec(prob, *args, **kw):
        # the global BA is one Huber stage (num_second = 0)
        calls["global_ba" if kw.get("num_second", 1) == 0 else "bundle_adjust"].append(prob)
        return solve(prob, *args, **kw)

    kern.triangulate, kern.fuse, ba.bundle_adjust = tri_rec, fuse_rec, ba_rec

    def undo():
        del kern.triangulate, kern.fuse
        ba.bundle_adjust = solve

    return calls, undo


def largest_inputs(calls):
    """After the run: the triangulation with the most valid neighbours (then
    unassociated slots), the fuse chunk with the most valid keyframes (then
    landmarks) and every local BA problem (K >= 16; the init BA has K = 2),
    the one with the most landmarks first."""
    tri = max(calls["triangulate"], key=lambda a: (int(a[3].sum()), int(a[0].unassoc.sum())))
    fuse = max((a for a in calls["fuse"] if len(a) < 7 or a[6] == 3.0),
               key=lambda a: (int(a[2].sum()), int(a[5].sum())))[:6]
    local = sorted((p for p in calls["bundle_adjust"] if p.cam_R.shape[0] >= 16),
                   key=lambda p: -int(p.lm_valid.sum()))
    return tri, fuse, local


def band_index_differs(band, plain):
    """Kernel J's band index against the plain one on the same inputs: (the
    share of targets whose bucket differs, those that differ other than by
    one angle bin, mod the bins, or between an angle bin and the bucket
    every row visits). A target whose angle lies at a bin edge, or whose
    normal lies at the off-plane limit, may round into the next bucket: the
    walk visits one more bin on each side of a row's band for that."""
    import torch

    from stella_vslam_tpu_torch.match import hamming as H

    nb = H.J_BAND_BINS
    k, q = H.band_index_buckets(band), H.band_index_buckets(plain)
    differ = k != q
    step = torch.remainder(k - q, nb)
    adjacent = (k < nb) & (q < nb) & ((step == 1) | (step == nb - 1))
    always = ((k == nb) & (q < nb)) | ((q == nb) & (k < nb))
    return float(differ.float().mean()), int((differ & ~adjacent & ~always).sum())


def _check_epipolar(dev, kern, tri, name="epipolar_top2", label=""):
    """Kernel J against its plain version on one triangulation's inputs
    (`tri`: the current keyframe, its neighbours, their poses and valid
    flags); returns its rows of the kernels line: the call (band index and
    walk), and the band index alone (`epipolar_band_index`, its own
    counter)."""
    import torch

    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.match import robust
    from stella_vslam_tpu_torch.module import mapping_kernels as mk

    cur, nbrs, poses, pair_valid = tri
    B, N2 = nbrs.desc.shape[0], nbrs.desc.shape[1]
    N1 = cur.desc.shape[0]
    E_12, epl2 = mk.epipolar_terms(poses)
    gate = robust.epipolar_gate(cur.angle, cur.level, cur.bear, cur.stereo, nbrs.angle,
                                nbrs.bear, nbrs.stereo, E_12, epl2,
                                scale_factors=kern.scale_factors)
    jargs = (cur.desc, nbrs.desc, cur.unassoc, nbrs.unassoc, gate)
    outk, outp = H.epipolar_top2(*jargs), H.epipolar_top2_plain(*jargs)
    differ = torch.zeros((B, N1), dtype=torch.bool, device=dev)
    for u, v in zip(outk, outp):
        differ |= u != v
    share_j = float(differ.float().mean())
    # the band index against its plain version, and the walk on it
    band = H.epipolar_band_index(nbrs.unassoc, gate)
    band_plain = H.epipolar_band_index_plain(nbrs.unassoc, gate)
    basis_err = float((band.basis - band_plain.basis).abs().max())
    share_idx, far_idx = band_index_differs(band, band_plain)
    walk_differ = sum(int((u != v).sum()) for u, v in zip(H.epipolar_top2(*jargs, band=band),
                                                          outp))
    # the band walk in plain form: the same outputs, and the pairs it visits
    *band_out, visit = H.epipolar_band_plain(*jargs)
    band_differ = sum(int((u != v).sum()) for u, v in zip(band_out, outp))
    # this run's work: per (unassociated row, target) the target's flag;
    # per valid pair the orientation and epipole tests; per pair past them
    # the epipolar residual; per candidate XOR + popcount + add over 8 words
    # and the top-2 update. A row that is not unassociated needs no per-pair
    # work: its output is the constant (257, 0, 257, 0). Counted over every
    # pair, and over the pairs in the rows' bands (what the walk needs: a
    # pair outside its row's band cannot pass the residual gate).
    n_rowpairs = n_valid = n_orient = n_cand = n_orient_band = n_cand_targets = 0
    for b in range(B):
        n_rowpairs += int(cur.unassoc.sum()) * N2
        ok = cur.unassoc[:, None] & nbrs.unassoc[b][None, :]
        cosd = gate.row_c[:, None] * gate.col_c[b][None, :] \
            + gate.row_s[:, None] * gate.col_s[b][None, :]
        orient = ok & (cosd >= gate.cos_thr) & ~(gate.col_near[b][None, :]
                                                 & ~gate.row_stereo[:, None])
        n_valid += int(ok.sum())
        n_orient += int(orient.sum())
        n_orient_band += int((orient & visit[b]).sum())
        cand = H.epipolar_gate_matrix(b, cur.unassoc, nbrs.unassoc, gate)
        n_cand += int(cand.sum())
        n_cand_targets += int(cand.any(0).sum())
    n_band = int(visit.sum())
    n_live, n_tvalid = int(cur.unassoc.sum()), int(nbrs.unassoc.sum())
    n_acc = int(robust.match_for_triangulation(
        cur.angle, cur.level, cur.desc, cur.bear, cur.unassoc, cur.stereo, nbrs.angle,
        nbrs.desc, nbrs.bear, nbrs.unassoc, nbrs.stereo, E_12, epl2,
        scale_factors=kern.scale_factors)[1].sum())
    torch.cuda.synchronize()
    print(f"kernel J epipolar_top2{label}: {B}x{N1}x{N2}, {int(pair_valid.sum())} valid "
          f"neighbours, {n_live} unassociated rows, {n_tvalid} unassociated targets, "
          f"{n_valid} valid, {n_orient} past orientation and epipole, {n_cand} candidate "
          f"pairs on {n_cand_targets} targets, {n_acc} accepted; pairs in the rows' bands "
          f"{n_band} ({n_orient_band} past orientation and epipole); rows differing from "
          f"plain {int(differ.sum())}, the walk on a given index {walk_differ}, the plain "
          f"band walk's outputs {band_differ}; the band index: basis within {basis_err:.3g} "
          f"of plain, targets in another bucket than plain's {share_idx:.6f} ({far_idx} "
          f"farther than the next bin)")
    assert not bool(differ.any()) and walk_differ == 0, \
        f"kernel J disagrees with its plain version{label}"
    assert band_differ == 0, f"the plain band walk disagrees with the dense walk{label}"
    assert basis_err <= 1e-6 and share_idx <= 1e-3 and far_idx == 0, \
        f"kernel J's band index disagrees with its plain version{label}"
    # bytes the function needs on this run's data: every flag; a live row's
    # descriptor and gate terms (56 B); an unassociated target's gate terms
    # and near flag (25 B); a candidate target's descriptor; E; the output
    j_bytes = (N1 + n_live * 56.0 + B * N2 + n_tvalid * 25.0 + n_cand_targets * 32.0
               + B * 36.0 + B * N1 * 16.0)
    j_bytes_all = N1 * (32 + 24 + 1) + B * N2 * (32 + 24 + 1) + B * N1 * 16
    # the index: flags, an unassociated target's normal and length, E; the
    # basis, the bucket starts and the order written; ~45 operations a
    # valid target (three divisions, three dot products, atan2, the bin)
    idx_bytes = B * N2 + n_tvalid * 16.0 + B * 36.0 + B * 36.0 \
        + B * (H.J_BAND_BINS + 3) * 4.0 + B * N2 * 4.0
    bucket_ids = H.band_buckets(nbrs.unassoc, gate, band_plain.basis)
    shape = f"{B}x{N1}x{N2}"
    return [dict(
        name=name, route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/robust.py:22", max_abs_err=share_j,
        **_times(lambda: H.epipolar_top2(*jargs)),
        walk_ms=_device_ms(lambda: H.epipolar_top2(*jargs, band=band)),
        plain_ms=_median_ms(lambda: H.epipolar_top2_plain(*jargs), reps=5, warmup=1),
        library_ms=None, pairs_visited=n_band, pairs_dense=n_valid,
        bound_ms_all_pairs=_bound(j_bytes_all, 1.0 * n_rowpairs + 5.0 * n_valid
                                  + 10.0 * n_orient + 30.0 * n_cand)["bound_ms"],
        **_bound(j_bytes, 6.0 * n_band + 10.0 * n_orient_band + 30.0 * n_cand),
        timing_call="ms and one_call_ms: the call, its band index (the "
        "epipolar_band_index row) and the walk; walk_ms: the walk on a given index",
        bytes_counted="flags, live rows' fields, unassociated targets' gate terms, "
        "candidate targets' descriptors, E, the output", shape=shape), dict(
        name=name.replace("epipolar_top2", "epipolar_band_index"), route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu (epipolar_band_index_kernel)",
        replaces="stella_vslam_tpu/match/robust.py:22 (the residual mask of its [N1,N2] "
        "gates)", note="kernel J's band index, a block a neighbour",
        max_abs_err=share_idx, max_abs_err_is="the share of targets in another bucket than "
        "the plain index's (the next bin at most)", shape=f"{B} x {N2} targets, "
        f"{H.J_BAND_BINS} bins",
        **_times(lambda: H.epipolar_band_index(nbrs.unassoc, gate)),
        plain_ms=_median_ms(lambda: H.epipolar_band_index_plain(nbrs.unassoc, gate), reps=5),
        library_ms=_device_ms(lambda: torch.argsort(bucket_ids, dim=1, stable=True)),
        library_call="torch.argsort (stable) of the targets' bucket ids",
        **_bound(idx_bytes, 45.0 * n_tvalid + 2.0 * B * N2))]


def fuse_edge_yaml(model: str = "perspective") -> dict:
    """fuse_edge_chunk's camera: 752x480 perspective or 640x320
    equirectangular."""
    equirect = model == "equirectangular"
    return {"name": "edge", "setup": "monocular", "model": model,
            "cols": 640 if equirect else 752, "rows": 320 if equirect else 480,
            **({} if equirect else {"fx": 458.0, "fy": 458.0, "cx": 376.0, "cy": 240.0,
                                    "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0}),
            "fps": 20.0, "color_order": "Gray"}


def fuse_edge_chunk(dev, seed: int = 0, model: str = "perspective", B: int = 4,
                    N: int = 1500, M: int = 700):
    """A fuse chunk for kernel L's cell walk at its edges (its generator,
    shared with the CPU and card tests): a 752x480 perspective or a 640x320
    equirectangular camera, B keyframes (the last a padding one) a few
    centimetres apart, M landmarks 3-5 m away whose projections in
    keyframe 0 lie all over the image and for a third within 4 px of an
    edge, each seen by every keyframe as a keypoint at its projection with
    1 px of noise (so keypoints near an edge fall outside the image), at
    its octave 0-7, with 0-60 flipped descriptor bits; then clutter
    keypoints over the image, keypoints far outside it (valid, as fisheye
    and division keypoints can lie) and NaN coordinates in invalid slots;
    a fifth of the keypoints stereo. Returns (MappingKernels, the fuse
    arguments after cam: kfs, poses [B, 12], kf_valid, lm_f, lm_desc,
    lm_valid)."""
    import torch

    from stella_vslam_tpu_torch.camera.base import camera_from_yaml, reproject_to_image
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.module import mapping_kernels as mk

    rng = np.random.default_rng(seed)
    equirect = model == "equirectangular"
    cam = camera_from_yaml(fuse_edge_yaml(model))
    W, Hh = int(cam.params.width), int(cam.params.height)
    kern = mk.MappingKernels(cam, OrbParams(num_levels=8), device=dev)
    u = rng.uniform(0, W, M)
    v = rng.uniform(0, Hh, M)
    edge = rng.random(M) < 1 / 3
    side = rng.integers(0, 4, M)
    d = rng.uniform(0.0, 4.0, M)
    u = np.where(edge & (side == 0), d, np.where(edge & (side == 1), W - 1e-3 - d, u))
    v = np.where(edge & (side == 2), d, np.where(edge & (side == 3), Hh - 1e-3 - d, v))
    if equirect:
        lon, lat = (u - W / 2) * 2 * np.pi / W, (v - Hh / 2) * np.pi / Hh
        ray = np.stack([np.cos(lat) * np.sin(lon), np.sin(lat), np.cos(lat) * np.cos(lon)], -1)
    else:
        ray = np.stack([(u - 376.0) / 458.0, (v - 240.0) / 458.0, np.ones(M)], -1)
        ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    dist = rng.uniform(3.0, 5.0, M)
    X = ray * dist[:, None]
    level = rng.integers(0, 8, M)
    desc = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    lm_f = np.zeros((M, 8), np.float32)
    lm_f[:, :3] = X
    # the predicted octave ceil(log(dmax / dist) / log 1.2) half an octave
    # from a rounding that could move it
    lm_f[:, 4] = dist * 1.2 ** (level - 0.5)
    lm_f[:, 3] = lm_f[:, 4] / 1.2 ** 7
    lm_f[:, 5:] = ray
    poses = np.zeros((B, 12), np.float32)
    uv = np.full((B, N, 2), np.nan, np.float32)
    lvl = np.zeros((B, N), np.int32)
    kdesc = np.zeros((B, N, 8), np.uint32)
    valid = np.zeros((B, N), bool)
    for b in range(B):
        a = 0.002 * b
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([-0.02 * b, 0.01 * b, 0.0])
        poses[b, :9], poses[b, 9:] = R.reshape(9), t
        puv, _, _ = reproject_to_image(cam.model, cam.params, torch.as_tensor(R),
                                       torch.as_tensor(t), torch.as_tensor(X))
        n_lm = min(M, N // 2)
        slots = rng.permutation(N)
        own, rest = slots[:n_lm], slots[n_lm:]
        uv[b, own] = puv.numpy()[:n_lm] + rng.normal(0, 1.0, (n_lm, 2))
        lvl[b, own] = level[:n_lm]
        kd = desc[:n_lm].copy()
        for i, k in enumerate(rng.integers(0, 60, n_lm)):
            for bit in rng.choice(256, k, replace=False):
                kd[i, bit // 32] ^= np.uint32(1 << (bit % 32))
        kdesc[b, own] = kd
        valid[b, own] = True
        n_far, n_nan = len(rest) // 10, len(rest) // 10
        far, nan, clutter = rest[:n_far], rest[n_far:n_far + n_nan], rest[n_far + n_nan:]
        uv[b, clutter] = np.stack([rng.uniform(0, W, len(clutter)),
                                   rng.uniform(0, Hh, len(clutter))], -1)
        uv[b, far] = np.stack([rng.choice([-900.0, -40.0, W + 40.0, W + 900.0], len(far)),
                               rng.uniform(-600.0, Hh + 600.0, len(far))], -1)
        valid[b, clutter] = valid[b, far] = True
        uv[b, nan[: len(nan) // 2], 0] = np.nan  # the rest NaN in both coordinates
        lvl[b, rest] = rng.integers(0, 8, len(rest))
        kdesc[b, rest] = rng.integers(0, 2 ** 32, (len(rest), 8), dtype=np.uint64)
    xr = np.where(rng.random((B, N)) < 0.2, uv[..., 0] - 20.0, -1.0).astype(np.float32)
    t_ = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    kfs = mk.FuseKeyframes(t_(uv), t_(lvl), t_(kdesc.view(np.int32)), t_(valid), t_(xr))
    return kern, (kfs, t_(poses), t_(np.arange(B) < B - 1), t_(lm_f),
                  t_(desc.view(np.int32)), t_(rng.random(M) < 0.95))


def same_cells(start, order, want_start, want_order) -> bool:
    """Whether two cell indexes [B, G + 2], [B, N] hold the same points in
    each cell (the batched index of kernel L places a cell's points in no
    fixed order; the plain index in ascending order)."""
    import torch

    if not torch.equal(start.cpu(), want_start.cpu()):
        return False
    start, order = start.cpu().long(), order.cpu().long()
    N = order.shape[1]
    for b in range(order.shape[0]):
        cell = torch.repeat_interleave(torch.arange(start.shape[1] - 1),
                                       start[b, 1:] - start[b, :-1])
        key = torch.sort(cell * N + order[b]).values
        if not torch.equal(key % N, want_order[b].cpu().long()):
            return False
    return True


def fuse_work(kern, fargs, margin: float, model) -> dict:
    """Kernel L's work on one chunk, counted in plain torch: gated (keyframe,
    landmark) pairs, (landmark, keypoint) pairs in the windows, candidates
    (every gate passed), and the pairs the cell walk visits
    (fuse_cells_plain)."""
    from stella_vslam_tpu_torch.match import fuse as fuse_match
    from stella_vslam_tpu_torch.module import mapping_kernels as mk

    kfs, kf_poses, batch_valid, lm_f, lm_desc, lm_valid = fargs
    n_gated = n_window = n_cand = 0
    for b in range(kfs.uv.shape[0]):
        if not bool(batch_valid[b]):
            continue
        uv, xr, pred, g = mk.reproject_for_fuse(kern.cam, kern.log_scale,
                                                kern.scale_factors.shape[0],
                                                kf_poses[b, :9].reshape(3, 3), kf_poses[b, 9:12],
                                                lm_f, lm_valid, model)
        win, cand = fuse_match.candidate_mask(
            kfs.uv[b], kfs.level[b], kfs.valid[b], kfs.x_right[b], uv[g], xr[g], pred[g],
            g[g], scale_factors=kern.scale_factors, level_sigma_sq=kern.level_sigma_sq,
            margin=margin)
        n_gated += int(g.sum())
        n_window += int(win.sum())
        n_cand += int(cand.sum())
    *walk, visited = mk.fuse_cells_plain(*fargs, kern.cam, kern.scale_factors,
                                          kern.level_sigma_sq, kern.log_scale, margin, model)
    return dict(gated=n_gated, in_window=n_window, candidates=n_cand, visited=visited,
                walk=walk)


def check_fuse_chunk(dev, kern, fargs, model_name: str) -> list:
    """Kernel L (the cell indexes, then the walk) against fuse_scan_plain on
    a recorded fuse chunk at margins 3 (the keyframe event) and 4 (loop
    fusion), and on fuse_edge_chunk (landmarks at the image's edges,
    keypoints outside it, NaN coordinates) at both margins. The walk is
    exact: the plain cell walk (fuse_cells_plain) must equal the full scan
    with 0 outputs differing, and so must the kernel's best, index and
    gate on every (keyframe, landmark) row: its prologue rounds as the
    plain one does (the FMA chains, the reciprocals of 1.3 and of
    log(scale factor)), so a row at a gate's threshold goes the same way.
    A differing row is printed and its chunk saved to chiprun_out/, so that
    another tree's kernel can be run on it. L's max_abs_err is the largest
    share of rows differing over the four checks. Prints the pairs the walk
    visits beside gated x N. Returns the rows of L and of its cell index,
    timed on the recorded chunk at margin 3."""
    import torch

    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.module import mapping_kernels as mk

    model = kern.camera.model
    tag = "" if model_name == "perspective" else "_equirect"
    cam = kern.cam
    fixed = lambda kern_, fargs_, margin: fargs_ + (
        kern_.cam, kern_.scale_factors, kern_.level_sigma_sq, kern_.log_scale, margin,
        kern_.camera.model)
    edge_kern, edge_args = fuse_edge_chunk(dev, seed=5, model=model_name)
    stats = {}
    for label, kk, aa in (("recorded", kern, fargs), ("edge", edge_kern, edge_args)):
        for margin in (3.0, 4.0):
            largs = fixed(kk, aa, margin)
            before = mk.fuse_scan.launches, H.build_cell_index_batch.launches
            lk = mk.fuse_scan(*largs)
            torch.cuda.synchronize()
            assert (mk.fuse_scan.launches, H.build_cell_index_batch.launches) == \
                (before[0] + 1, before[1] + 1), "kernel L: one index and one walk a call"
            lp = mk.fuse_scan_plain(*largs)
            work = fuse_work(kk, aa, margin, kk.camera.model)
            rows = torch.nonzero((lk[0] != lp[0]) | (lk[1] != lp[1]) | (lk[2] != lp[2])).tolist()
            differ = len(rows)
            for b, m in rows[:20]:
                print(f"  kernel L ({model_name}, {label}, margin {margin:g}) keyframe {b} "
                      f"landmark {m}: kernel {[int(x[b, m]) for x in lk]}, plain "
                      f"{[int(x[b, m]) for x in lp]}")
            walk_differ = int(sum(int((x != y).sum()) for x, y in zip(work.pop("walk"), lp)))
            N = aa[0].uv.shape[1]
            acc, acc_p = mk.accept_fused(*lk, N), mk.accept_fused(*lp, N)
            stats[f"{label}_margin{int(margin)}"] = dict(
                chunk=f"{aa[0].uv.shape[0]}x{aa[3].shape[0]}x{N}",
                keyframes=int(aa[2].sum()), landmarks=int(aa[5].sum()),
                outputs_differing=differ,
                rows_differing_share=differ / lk[2].numel(),
                accepted_flags_differing_share=float((acc != acc_p).float().mean()),
                cell_walk_plain_differing=walk_differ,
                accepted=int(acc.sum()), gated_times_n=work["gated"] * N, **work)
            if differ:
                torch.save(dict(model=model_name, num_levels=int(kk.scale_factors.shape[0]),
                                margin=margin, rows=rows, kfs=[t.cpu() for t in aa[0]],
                                rest=[t.cpu() for t in aa[1:6]]),
                           os.path.join(OUT_DIR, f"fuse_chunk_{model_name}_{label}_margin"
                                        f"{int(margin)}_differing.pt"))
            print(f"kernel L fuse ({model_name}, {label} chunk {aa[0].uv.shape[0]}x"
                  f"{aa[3].shape[0]}, N={N}, margin {margin:g}): {work['gated']} gated, pairs "
                  f"visited {work['visited']} (of {work['gated'] * N} gated x N), "
                  f"{work['in_window']} in a window, {work['candidates']} candidates, "
                  f"{int(acc.sum())} accepted; outputs differing from the full scan {differ}, "
                  f"the plain cell walk's {walk_differ}")
            assert walk_differ == 0 and differ == 0, \
                f"kernel L disagrees with its plain version ({model_name}, {label}, {margin})"
        if label == "recorded":
            torch.save(dict(model=model_name, num_levels=int(kk.scale_factors.shape[0]),
                            kfs=[t.cpu() for t in aa[0]], rest=[t.cpu() for t in aa[1:6]]),
                       os.path.join(OUT_DIR, f"fuse_chunk_{model_name}.pt"))
    # the cell indexes against one plain index a keyframe, as sets a cell
    for label, aa, cc in (("recorded", fargs, cam), ("edge", edge_args, edge_kern.cam)):
        uv = aa[0].uv
        start, order, *_ = H.build_cell_index_batch(uv, cc.width, cc.height)
        plain = [H.build_cell_index_plain(x[:, 0], x[:, 1], cc.width, cc.height) for x in uv]
        ok = same_cells(start, order, torch.stack([p.start for p in plain]),
                        torch.stack([p.order for p in plain]))
        print(f"kernel L's cell indexes ({model_name}, {label} chunk): the same points in "
              f"each cell as the plain index: {ok}")
        assert ok, f"kernel L's cell indexes disagree with plain ({model_name}, {label})"
    # times on the recorded chunk at margin 3
    kfs, kf_poses, batch_valid, lm_f, lm_desc, lm_valid = fargs
    largs = fixed(kern, fargs, 3.0)
    Bf, N, M = kfs.uv.shape[0], kfs.uv.shape[1], lm_f.shape[0]
    work = stats["recorded_margin3"]
    cells = H.build_cell_index_batch(kfs.uv, cam.width, cam.height)
    prologue = 90.0 if model_name == "perspective" else 140.0
    # bytes: the keypoint fields (uv, level, descriptor, flag, x_right) and
    # their sorted order read once, poses, landmark rows, the output; ops:
    # the prologue per (keyframe, landmark), ~15 a visited pair's gates
    # where it lies in the window (the cell walk's rejects are not needed
    # work), 24 a candidate's Hamming distance
    l_bytes = Bf * N * 53.0 + Bf * 49.0 + M * 65.0 + Bf * M * 12.0
    l_ops = prologue * Bf * M + 15.0 * work["in_window"] + 24.0 * work["candidates"]
    rows = [dict(
        name="fuse" + tag, route="cuda",
        source="stella_vslam_tpu_torch/csrc/fuse.cu + cells.cuh"
        + ("" if model_name == "perspective" else " + camera.cuh"),
        replaces="stella_vslam_tpu/module/mapping_kernels.py:228",
        max_abs_err=max(s["rows_differing_share"] for s in stats.values()),
        max_abs_err_is="the largest share of (keyframe, landmark) rows whose outputs differ "
        "from fuse_scan_plain over the four checks",
        shape=f"{Bf}x{M}x{N}", checks=stats,
        pairs_visited=work["visited"],
        pairs_full_scan=work["gated_times_n"],
        **_times(lambda: mk.fuse_scan(*largs)),
        plain_ms=_median_ms(lambda: mk.fuse_scan_plain(*largs), reps=5, warmup=1),
        cell_walk_plain_ms=_median_ms(lambda: mk.fuse_cells_plain(*largs), reps=3, warmup=1),
        library_ms=None, timing_call="ms and one_call_ms: the call, its cell index "
        "(fuse_cell_index's row) and the walk", bound_ms_all_pairs=_bound(
            l_bytes, l_ops + 10.0 * work["gated"] * N)["bound_ms"], **_bound(l_bytes, l_ops))]
    G = cells[3] * cells[4]
    ids = torch.where(torch.isnan(kfs.uv).any(-1), G, (torch.floor(kfs.uv[..., 1] * cells[2])
                      .nan_to_num(0).clamp(0, cells[4] - 1) * cells[3]
                      + torch.floor(kfs.uv[..., 0] * cells[2]).nan_to_num(0)
                      .clamp(0, cells[3] - 1)).long())
    rows.append(dict(
        name="fuse_cell_index" + tag, route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu (cell_index_kernel) + "
        "cells.cuh",
        replaces="stella_vslam_tpu/match/fuse.py:26 (the windows of its [M,N] masks)",
        note="kernel C's cell index kernel, a block a keyframe",
        max_abs_err=0.0, shape=f"{Bf} x {N} keypoints, {G} cells",
        **_times(lambda: H.build_cell_index_batch(kfs.uv, cam.width, cam.height)),
        plain_ms=_median_ms(lambda: [H.build_cell_index_plain(
            kfs.uv[b, :, 0], kfs.uv[b, :, 1], cam.width, cam.height) for b in range(Bf)],
            reps=5),
        library_ms=_device_ms(lambda: torch.argsort(ids, dim=1, stable=True)),
        library_call="torch.argsort (stable) of the keypoints' cell ids",
        **_bound(Bf * N * (8.0 + 4.0) + Bf * (G + 2) * 4.0, 20.0 * Bf * N)))
    return rows


def tri_bits_apart(a, b) -> dict:
    """Elements whose bits differ between two TriangulationResults, by
    field (the positions as float32 bits)."""
    import torch

    return dict(pos_w=int((a.pos_w.view(torch.int32) != b.pos_w.view(torch.int32)).sum()),
                idx2=int((a.idx2 != b.idx2).sum()), ok=int((a.ok != b.ok).sum()))


def check_mapping_kernels(dev, mapper, inputs):
    """Kernels J, K and L against their plain versions on the map slice's
    own inputs (the triangulation with the most neighbours, the fuse chunk
    with the most landmarks), and F-I at the local-BA shape: a K=16, L=4096,
    D=12 problem (checked and timed) and every local problem of the slice
    (kernel by kernel, _lockstep_ba). Returns rows J, K, L and F-I local."""
    import torch

    from stella_vslam_tpu_torch.match import fuse as fuse_match
    from stella_vslam_tpu_torch.match import robust
    from stella_vslam_tpu_torch.module import mapping_kernels as mk
    from stella_vslam_tpu_torch.ops.optim import ba

    rows = []
    kern = mapper.kernels
    (cur, nbrs, poses, pair_valid), fargs, local = inputs
    B, N2 = nbrs.desc.shape[0], nbrs.desc.shape[1]
    N1 = cur.desc.shape[0]

    rows += _check_epipolar(dev, kern, (cur, nbrs, poses, pair_valid))

    # ---- K: DLT and checks on kernel J's matches ----
    E_12, epl2 = mk.epipolar_terms(poses)
    idx2, accepted, _ = robust.match_for_triangulation(
        cur.angle, cur.level, cur.desc, cur.bear, cur.unassoc, cur.stereo, nbrs.angle,
        nbrs.desc, nbrs.bear, nbrs.unassoc, nbrs.stereo, E_12, epl2,
        scale_factors=kern.scale_factors)
    kargs = (cur.uv, cur.level, cur.bear, nbrs.uv, nbrs.level, nbrs.bear, poses.contiguous(),
             idx2.contiguous(), accepted, pair_valid, kern.cam, kern.level_sigma_sq,
             kern.scale_factors)
    rk, rp = mk.triangulate_checks(*kargs), mk.triangulate_checks_plain(*kargs)
    torch.cuda.synchronize()
    share_k = float((rk.ok != rp.ok).float().mean())
    both = rk.ok & rp.ok
    rel = (torch.linalg.norm(rk.pos_w - rp.pos_w, dim=-1)
           / torch.clamp(torch.linalg.norm(rp.pos_w, dim=-1), min=1e-12))[both]
    rel_max = float(rel.max()) if rel.numel() else 0.0
    apart_k = tri_bits_apart(rk, rp)
    print(f"kernel K triangulate: {B}x{N1} slots, {int(accepted.sum())} matched, "
          f"{int(rk.ok.sum())} ok (plain {int(rp.ok.sum())}), ok flags differing "
          f"{share_k:.6f}, max relative position difference where both ok {rel_max:.3g}; "
          f"elements whose bits differ from plain {json.dumps(apart_k)}")
    assert share_k <= 1e-3 and rel_max < 1e-4, "kernel K disagrees with its plain version"
    # per slot: DLT rows and normalisation ~100, normal equations ~90, the
    # adjugate solve ~60, depth / parallax / reprojection / scale checks ~150
    rows.append(dict(
        name="triangulate", route="cuda", source="stella_vslam_tpu_torch/csrc/triangulate.cu",
        replaces="stella_vslam_tpu/module/mapping_kernels.py:58", max_abs_err=rel_max,
        ok_flags_differing=share_k, elements_differing_from_plain=apart_k,
        **_times(lambda: mk.triangulate_checks(*kargs)),
        plain_ms=_median_ms(lambda: mk.triangulate_checks_plain(*kargs), reps=10),
        library_ms=None,
        **_bound(N1 * 24.0 + B * N2 * 24.0 + B * N1 * 5.0 + (B + 1) * 48.0
                 + B * N1 * 17.0, 400.0 * B * N1)))

    # ---- L: the fuse chunk's cell indexes and walk, margins 3 and 4 ----
    rows += check_fuse_chunk(dev, kern, fargs, "perspective")

    # ---- F-I at the local-BA shape ----
    prob, cam = _ba_problem(dev, 16, 4096, 12, False, 16, spacing=0.1, ordered=True)
    e_pose = _compare_ba(prob, cam, "K=16 L=4096 D=12", num_first=3, num_second=6)
    # Every local problem of the slice, kernel by kernel on the same inputs.
    # A whole BA of such a problem cannot be held to 1e-4: its reduced
    # system is ill-conditioned enough that the order of the atomic sums
    # alone (F's, and index_add_'s in the plain BA on the card) can move its
    # poses by more than 1e-4 between two runs of the plain BA (printed
    # below). So each kernel runs on the same inputs as its plain version:
    # F's system is held against float64, G's step by its backward error,
    # and H's trial points against H in float64 on G's step. A point seen from a short baseline is nearly free along its rays: it
    # moves depth^2 / baseline per radian of pose difference (160 m/rad at
    # 4 m over 0.1 m), so each trial point is held to 1e-3 or, where larger,
    # to 1e-4 rad (the poses' own bound) of that.
    worst = {}
    for p in local:
        for k, v in _lockstep_ba(p, mapper.cam_scalars, 3, 6).items():
            worst[k] = worst.get(k, 0) + v if isinstance(v, int) else max(worst.get(k, 0.0), v)
    print(f"kernels F-I kernel by kernel against plain on the map slice's {len(local)} local "
          f"problems (K={local[0].cam_R.shape[0]}, D={local[0].obs_cam.shape[1]}): "
          + json.dumps(worst))
    assert worst["f_excess"] < 1.0 and worst["g_backward"] < 1e-3 and worst["g_pose"] < 1e-5 \
        and worst["point_share"] < 1.0 and worst["cost_rel"] < 1e-4 \
        and worst["decisions"] == 0 and worst["flags"] == 0, \
        "kernels F-I disagree with the plain BA on the map slice's local problems"
    # the whole BA of each, beside each version's spread against itself
    spread = dict(kernel_vs_plain=0.0, plain_vs_plain=0.0, kernel_vs_kernel=0.0)
    for p in local:
        k1, k2, p1, p2 = (fn(p, mapper.cam_scalars, num_first=3, num_second=6)
                          for fn in (ba.bundle_adjust,) * 2 + (ba.bundle_adjust_plain,) * 2)
        for key, (u, v) in zip(spread, ((k1, p1), (p1, p2), (k1, k2))):
            spread[key] = max(spread[key], float((u.cam_R - v.cam_R).abs().max()),
                              float((u.cam_t - v.cam_t).abs().max()))
    print(f"kernels F-I whole BA on the map slice's {len(local)} local problems, max |pose "
          f"diff| (atomics sum in another order on every run): " + json.dumps(spread))
    rows += _time_ba_kernels(dev, e_pose, prob, cam, suffix="_local")
    rows[-4]["kernel_by_kernel_on_slice"] = worst
    rows[-4]["whole_ba_pose_spread_on_slice"] = spread
    # F on the slice's largest local problem: the real observer layout
    rows += [r for r in _time_ba_kernels(dev, worst["g_pose"], local[0], mapper.cam_scalars,
                                         suffix="_map_local")
             if r["name"].startswith("ba_linearize_schur")]
    rows.append(_schur_index_row(dev, prob, cam))
    rows[-1]["f_edge_cases"] = check_f_cases(dev)
    return rows


def _schur_index_row(dev, prob, cam) -> dict:
    """Kernel F's pair index on prob against its plain version (equal
    entry by entry), timed beside torch.argsort of the terms' keys."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    st = ba._KernelState(prob, cam)
    K, (L, D) = st.K, prob.obs_cam.shape
    plain = lambda: ba.schur_index_plain(prob.obs_cam, prob.obs_valid, prob.lm_valid,
                                         prob.lm_fixed, K)
    ix = plain()
    same = ba.schur_index_equal(st.index, ix)
    torch.cuda.synchronize()
    print(f"kernel F's pair index K={K} L={L} D={D}: {ix.n_terms} pair terms in "
          f"{int(ix.nseg.sum())} groups, equal to plain {same}")
    assert same, "kernel F's pair index disagrees with its plain version"
    # the terms' (chunk, kd, ke) keys in enumeration order, for the library sort
    tod = ix.terms[torch.arange(ix.cap_t, device=dev)[None] < ix.nterm[:, None]].long()
    oc = prob.obs_cam.reshape(-1).long()
    keys = ((tod[:, 0] // (ba.LM_CHUNK * D)) * K + oc[tod[:, 0]]) * K + oc[tod[:, 1]]
    keys = keys[torch.argsort(tod[:, 0] * (L * D) + tod[:, 1])].contiguous()
    lib = lambda: torch.argsort(keys, stable=True)
    n_terms, n_obs, nseg, C = ix.n_terms, _valid_obs(prob), int(ix.nseg.sum()), ix.nterm.numel()
    return dict(
        name="schur_index", route="cuda", source="stella_vslam_tpu_torch/csrc/ba_schur.cu",
        replaces="stella_vslam_tpu/ops/optim/ba.py:416 (the camera keys of its one-hot sums)",
        max_abs_err=0.0, index_equal_plain=same,
        shape=f"K={K} L={L} D={D}: {n_terms} pair terms in {nseg} groups, once per BA",
        **_times(lambda: ba.build_schur_index(st)), plain_ms=_median_ms(plain, reps=5),
        library_ms=_device_ms(lib), library_one_call_ms=_median_ms(lib),
        library_call="torch.argsort(stable=True) of the pair terms' (chunk, kd, ke) keys",
        # obs_cam, the flags read; terms, groups, camera runs written; ~10
        # operations a slot pair, ~20 a term and a valid observation (sorts)
        **_bound(5.0 * L * D + 2.0 * L + 8.0 * n_terms + 16.0 * nseg + 4.0 * n_obs
                 + 8.0 * C * K, 10.0 * L * D * D + 20.0 * (n_terms + n_obs)))


def record_loop_inputs(slam):
    """Keep, by reference, the arguments of the loop closer's device calls:
    the BoW transform, PnP RANSAC, the keyframe rematch, the Sim3 refinement
    and the pose graph. The keyframe rematch counts its launches by its own
    name, so its count lands on its recorder and `undo` moves it back.
    Returns (calls, undo)."""
    from stella_vslam_tpu_torch.match import projection as proj
    from stella_vslam_tpu_torch.ops.optim import sim3
    from stella_vslam_tpu_torch.ops.solve import pnp

    calls = {"bow": [], "pnp": [], "kf_match": [], "transform": [], "pose_graph": []}
    vocab = slam.bow_vocab
    saved = (vocab.transform, pnp.find_via_ransac, proj.match_frame_and_keyframe,
             sim3.optimize_transform, sim3.optimize_pose_graph)

    def rec(key, fn):
        def wrapped(*args, **kw):
            calls[key].append((args, kw))
            return fn(*args, **kw)
        wrapped.launches = 0
        return wrapped

    vocab.transform = rec("bow", saved[0])
    pnp.find_via_ransac = rec("pnp", saved[1])
    proj.match_frame_and_keyframe = rec("kf_match", saved[2])
    sim3.optimize_transform = rec("transform", saved[3])
    sim3.optimize_pose_graph = rec("pose_graph", saved[4])

    def undo():
        del vocab.transform
        saved[2].launches += proj.match_frame_and_keyframe.launches
        (pnp.find_via_ransac, proj.match_frame_and_keyframe, sim3.optimize_transform,
         sim3.optimize_pose_graph) = saved[1:]

    return calls, undo


def cache_renders(world):
    """Serve world.render's images from memory, each pose rendered once: a
    PlaneWorld's image depends on its pose alone (the noise is seeded from
    it), so the inline loop slice and its sharded rerun see the same
    images either way, and the rerun renders nothing. The threaded slices
    render live: their frames are paced by it. Returns undo(), which drops
    the images."""
    images = {}
    render = world.render

    def cached(pose_cw, uv=None):
        if uv is not None:
            return render(pose_cw, uv)
        key = np.ascontiguousarray(pose_cw, np.float64).tobytes()
        if key not in images:
            images[key] = render(pose_cw)
        return images[key].copy()

    world.render = cached

    def undo():
        del world.render
        images.clear()

    return undo


def run_loop_slice(dev, world, wrappers, card):
    """The loop slice (mono, mapping and loop detector enabled, inline) over
    the bench's whole circuit, every launch count at 0 just before it and
    read just after it; its first 500 frames are the map slice. Returns
    (statistics, launches, mapper, the mapping kernels' largest inputs, the
    loop closer's recorded inputs)."""
    from stella_vslam_tpu_torch.util import loop_slice

    slam = loop_slice.make_system(world, dev)
    calls, undo = record_kernel_inputs(slam.mapper)
    loop_calls, undo_loop = record_loop_inputs(slam)
    for w in wrappers.values():
        w.launches = 0
    try:
        stats = loop_slice.run_slice(dev, world, slam=slam)
    finally:
        undo_loop()
        undo()
    launches = {k: w.launches for k, w in wrappers.items()}
    inputs = largest_inputs(calls)
    loop_calls["global_ba"] = calls["global_ba"]
    with open(os.path.join(OUT_DIR, "loop_slice.json"), "w") as f:
        json.dump(dict(stats, card=card), f, indent=1)
    ms = stats.pop("map_slice")
    print("map slice: " + json.dumps(dict(ms, card=card)))
    assert ms["lost_after_init"] <= 2, f"{ms['lost_after_init']} frames lost"
    assert ms["ate_m"] < 0.10, f"Sim3 ATE {ms['ate_m']:.4f} m"
    assert ms["local_bas"] >= 12, f"{ms['local_bas']} local BAs"
    assert ms["keyframes_kept"] >= 5, f"{ms['keyframes_kept']} keyframes kept"
    stats["map_slice_ate_m"] = ms["ate_m"]
    print("loop slice: " + json.dumps(dict(stats, card=card)))
    print("loop slice launches: " + json.dumps(launches))
    assert stats["loops_closed"] >= 1, "no loop was closed"
    assert stats["ate_m"] < 0.10, f"Sim3 ATE over the circuit {stats['ate_m']:.4f} m"
    assert stats["lost_after_init"] <= 8, f"{stats['lost_after_init']} frames lost"
    assert stats["keyframes_created"] >= 25, f"{stats['keyframes_created']} keyframes created"
    assert stats["keyframes_kept"] >= 10, f"{stats['keyframes_kept']} keyframes kept"
    assert stats["loop_edges"], "no loop edge in the graph"
    assert all(stats["frame_after_loop_tracked"]), "the frame after a correction was lost"
    for name, n in launches.items():
        assert n > 0 or name in THREADED_KERNELS + STEREO_KERNELS + EQUIRECT_KERNELS \
            + SHARDED_KERNELS, \
            f"{name} was not launched by the loop slice"
    return stats, launches, slam, inputs, loop_calls


def rerun_loop_slice(dev, world, first, wrappers, card):
    """The inline loop slice once more in the same process, on a fresh
    System whose global and loop BAs run sharded over VIRTUAL_SHARDS
    landmark shards on this card (kernel W), every launch count at 0 just
    before it and read just after it: with every device sum in a fixed order
    and the shards on chunk boundaries the frame poses are the first run's,
    bit for bit. Held to the loop slice's gates either way; prints both
    runs' ATEs, the first frame whose pose differs, and, for each run, where
    the error sits (legs, frames whose reference keyframe was culled).
    Returns (the comparison, the statistics, the launches)."""
    from stella_vslam_tpu_torch.util import loop_slice, threaded_slice

    slam2 = loop_slice.make_system(world, dev, ba_devices=[dev] * VIRTUAL_SHARDS)
    for w in wrappers.values():
        w.launches = 0
    stats2 = loop_slice.run_slice(dev, world, slam=slam2)
    launches = {k: w.launches for k, w in wrappers.items()}
    p1, p2 = first.frame_poses, slam2.frame_poses
    same = len(p1) == len(p2) and all(
        (a[1] is None and b[1] is None) or (a[1] is not None and b[1] is not None
                                            and np.array_equal(a[1], b[1]))
        for a, b in zip(p1, p2))
    first_diff = next((i for i, (a, b) in enumerate(zip(p1, p2))
                       if (a[1] is None) != (b[1] is None)
                       or (a[1] is not None and not np.array_equal(a[1], b[1]))), None)
    gt = loop_slice.circuit()
    diag = [threaded_slice.erased_forward_diagnostic(s, gt) for s in (first, slam2)]
    out = dict(poses_bit_identical=same, first_differing_frame=first_diff,
               ate_m=[None, stats2["ate_m"]], loops=[None, stats2["loops_closed"]],
               keyframes_kept=[first.map_db.num_keyframes(), stats2["keyframes_kept"]],
               global_ba_shapes=stats2["solver_shapes"].get("global_ba"),
               ate_breakdown=diag, card=card)
    print("sharded loop slice launches: " + json.dumps(launches))
    shapes = stats2["solver_shapes"].get("global_ba") or []
    assert shapes and all(g["shards"] == VIRTUAL_SHARDS for g in shapes), \
        f"the second loop slice's global BAs were not sharded: {shapes}"
    assert stats2["loops_closed"] >= 1, "second loop slice: no loop was closed"
    assert stats2["ate_m"] < 0.10, f"second loop slice: Sim3 ATE {stats2['ate_m']:.4f} m"
    assert stats2["lost_after_init"] <= 8, f"{stats2['lost_after_init']} frames lost"
    assert stats2["keyframes_created"] >= 25 and stats2["keyframes_kept"] >= 10, \
        "second loop slice: too few keyframes"
    assert stats2["loop_edges"] and all(stats2["frame_after_loop_tracked"]), \
        "second loop slice: no loop edge, or a frame after a correction lost"
    for name in SHARDED_KERNELS + ("ba_linearize_schur", "schur_index", "ba_reduced_solve",
                                   "ba_backsub_cost", "ba_classify"):
        assert launches[name] > 0, f"{name} was not launched by the sharded loop slice"
    return out, stats2, launches



def _pnp_problem(dev, n, seed):
    """n bearings of a 752x480 camera against points 2-8 m away under a
    known pose, 0.7 px noise, 30% outliers, 10% invalid, levels 0-7."""
    import torch

    rng = np.random.default_rng(seed)
    fx, cx, cy = 458.0, 376.0, 240.0
    uv = np.stack([rng.uniform(10, 742, n), rng.uniform(10, 470, n)], -1)
    z = rng.uniform(2.0, 8.0, n)
    Xc = np.stack([(uv[:, 0] - cx) * z / fx, (uv[:, 1] - cy) * z / fx, z], -1)
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.3, -0.1, 0.2])
    Xw = (Xc - t) @ R  # R^T (Xc - t)
    uv = uv + rng.normal(0, 0.7, uv.shape)
    out = rng.random(n) < 0.3
    uv[out] = np.stack([rng.uniform(0, 752, out.sum()), rng.uniform(0, 480, out.sum())], -1)
    b = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fx, np.ones(n)], -1)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev).contiguous()
    sf = f([1.2 ** i for i in range(8)])
    return (f(b), f(Xw), torch.as_tensor(rng.integers(0, 8, n).astype(np.int32), device=dev),
            torch.as_tensor(rng.random(n) < 0.9, device=dev)), sf


def _transform_problem(dev, n, seed):
    """A Sim3 refinement problem: n pairs, 0.5 px noise, 10% gross outliers,
    5% invalid, from a perturbed start."""
    import torch

    from stella_vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    fx, cx, cy = 458.0, 376.0, 240.0
    pts2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev).contiguous()
    s, R, t = lie.sim3_exp(f([0.3, -0.1, 0.2, 0.05, -0.1, 0.08, 0.1]))
    pts1 = lie.sim3_apply(s[None], R, t, f(pts2)).cpu().numpy()
    proj = lambda p: np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy], -1)
    obs1 = proj(pts1) + rng.normal(0, 0.5, (n, 2))
    obs2 = proj(pts2) + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < 0.1
    obs1[out] += rng.uniform(15, 40, (int(out.sum()), 2))
    s0, R0, t0 = lie.sim3_compose(*lie.sim3_exp(f([0.05, 0.02, -0.04, 0.01, 0.02, -0.02, -0.05])),
                                  s, R, t)
    isig = f(1.0 / 1.2 ** (2 * rng.integers(0, 4, n)))
    return (s0, R0.contiguous(), t0.contiguous(), f(pts1), f(pts2), f(obs1), f(obs2), isig, isig,
            torch.as_tensor(rng.random(n) < 0.95, device=dev), fx, fx, cx, cy)


def _graph_problem(dev, K, Kp, Ep, seed):
    """A pose graph: K keyframes on a line with odometric drift and scale
    creep, odometry and skip edges measured at the estimates, one loop edge
    (first to last) measured at the truth; padded to (Kp, Ep)."""
    import torch

    from stella_vslam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev).contiguous()
    xi_gt = np.zeros((K, 7))
    xi_gt[:, 0] = -0.3 * np.arange(K)
    xi_gt[:, 4] = 0.01 * np.arange(K)
    xi_est = xi_gt + np.cumsum(rng.normal(0, 0.004, (K, 7)), 0)
    xi_est[0] = xi_gt[0]
    sg, Rg, tg = lie.sim3_exp(f(xi_gt))
    se, Re, te = lie.sim3_exp(f(xi_est))
    edges = [(k, k - 1) for k in range(1, K)] + [(k, k - 2) for k in range(2, K)]
    meas = lambda s, R, t, i, j: lie.sim3_compose(s[i], R[i], t[i],
                                                  *lie.sim3_inverse(s[j], R[j], t[j]))
    i = torch.as_tensor([e[0] for e in edges], device=dev)
    j = torch.as_tensor([e[1] for e in edges], device=dev)
    ms, mR, mt = meas(se, Re, te, i, j)
    ls, lR, lt = meas(sg, Rg, tg, torch.as_tensor([K - 1], device=dev),
                      torch.as_tensor([0], device=dev))
    ms, mR, mt = torch.cat([ms, ls]), torch.cat([mR, lR]), torch.cat([mt, lt])
    ei = torch.cat([i, torch.as_tensor([K - 1], device=dev)]).to(torch.int32)
    ej = torch.cat([j, torch.as_tensor([0], device=dev)]).to(torch.int32)
    E = ei.shape[0]
    eye = torch.eye(3, device=dev)

    def pad(a, n, fill):
        extra = fill.expand((n - a.shape[0],) + a.shape[1:]) if torch.is_tensor(fill) \
            else torch.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype, device=dev)
        return torch.cat([a, extra]).contiguous()

    ar = lambda n: torch.arange(n, device=dev)
    return (pad(se, Kp, 1.0), pad(Re, Kp, eye), pad(te, Kp, 0.0), (ar(Kp) == 0) | (ar(Kp) >= K),
            ar(Kp) < K, pad(ei, Ep, 0), pad(ej, Ep, 0), pad(ms, Ep, 1.0), pad(mR, Ep, eye),
            pad(mt, Ep, 0.0), ar(Ep) < E)


def _check_pnp(args, scale_factors, label, seed):
    """Kernel N against its plain version on one problem; returns the worst
    readings."""
    import torch

    from stella_vslam_tpu_torch.ops.solve import pnp

    bearings, pos_w, octaves, valid = args
    mc = pnp.max_cos_errors(scale_factors, octaves)
    Rk, tk, okk, ck, nk = pnp.pnp_hypotheses(seed, bearings, pos_w, mc, valid, 256)
    Rp, tp, okp, cp, npl = pnp.pnp_hypotheses_plain(seed, bearings, pos_w, mc, valid, 256)
    torch.cuda.synchronize()
    both = okk & okp
    d = torch.maximum((Rk - Rp).abs().flatten(1).amax(1), (tk - tp).abs().amax(1))
    close = float((d[both] <= 1e-4).float().mean()) if bool(both.any()) else 1.0
    same = float(((okk == okp) & (nk == npl)).float().mean())
    cost_rel = float(((ck - cp).abs() / cp.abs().clamp(min=1e-6)).max())
    rk = pnp.find_via_ransac(seed, bearings, pos_w, octaves, valid, scale_factors=scale_factors,
                             min_num_inliers=15)
    rp = pnp.find_via_ransac(seed, bearings, pos_w, octaves, valid, scale_factors=scale_factors,
                             min_num_inliers=15, hypotheses=pnp.pnp_hypotheses_plain)
    e_pose = max(float((rk.R_cw - rp.R_cw).abs().max()), float((rk.t_cw - rp.t_cw).abs().max()))
    inl_same = bool(torch.equal(rk.is_inlier, rp.is_inlier))
    print(f"kernel N pnp_ransac {label}: N={bearings.shape[0]} ({int(valid.sum())} valid), "
          f"{int(okk.sum())} of {okk.numel()} hypotheses ok (plain {int(okp.sum())}), ok flag and "
          f"count equal {same:.4f}, (R, t) within 1e-4 where both ok {close:.4f} (max "
          f"{float(d[both].max()) if bool(both.any()) else 0.0:.3g}), cost relative "
          f"{cost_rel:.3g}; winner: valid {bool(rk.valid)} / {bool(rp.valid)}, "
          f"{int(rk.num_inliers)} / {int(rp.num_inliers)} inliers, sets equal {inl_same}, "
          f"pose diff {e_pose:.3g}")
    assert same >= 0.99 and close >= 0.99 and cost_rel < 1e-4, \
        f"kernel N's hypotheses disagree with plain ({label})"
    assert bool(rk.valid) == bool(rp.valid) and inl_same and e_pose < 1e-5, \
        f"kernel N's winner disagrees with plain ({label})"
    return 1.0 - min(same, close)


def _check_transform(args, kw, label, tol=1e-4):
    import torch

    from stella_vslam_tpu_torch.ops.optim import sim3

    rk = sim3.optimize_transform(*args, **kw)
    rp = sim3.optimize_transform_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(abs(float(rk.s_12) - float(rp.s_12)), float((rk.R_12 - rp.R_12).abs().max()),
              float((rk.t_12 - rp.t_12).abs().max()))
    differ = float((rk.is_inlier != rp.is_inlier).float().mean())
    print(f"kernel O sim3_transform {label}: N={args[3].shape[0]}, s {float(rk.s_12):.6f} "
          f"(plain {float(rp.s_12):.6f}), max |s, R, t diff| {err:.3g}, inliers "
          f"{int(rk.num_inliers)} (plain {int(rp.num_inliers)}), flags differing {differ:.6f}")
    assert err < tol and differ <= 1e-3, f"kernel O disagrees with plain ({label})"
    return err


def cholesky_solve(Hd, b):
    """The library's dense SPD solve (torch.linalg.cholesky, which waits for
    the card to check its flag, and cholesky_solve): the yardstick of kernel
    G's spd_solve, which the port calls instead."""
    import torch

    return torch.cholesky_solve(b[:, None], torch.linalg.cholesky(Hd))[:, 0]


def _check_pose_graph(args, label, num_iter=20):
    """Kernel P against plain, iteration by iteration on the kernel's own
    state (each step solved by kernel G's spd_solve, whose backward error on
    the system in float64 stays below 1e-3 as G's does; its distance to the
    library's solve printed), then the whole optimization (P and spd_solve
    against the plain linearization, update and solve)."""
    import torch

    from stella_vslam_tpu_torch.ops import linalg
    from stella_vslam_tpu_torch.ops.optim import sim3

    s, R, t = args[:3]
    g = sim3.PoseGraph(*args[3:])
    worst = dict(H=0.0, b=0.0, cost=0.0, update=0.0, solve_backward=0.0,
                 solve_backward_library=0.0, solve_vs_library=0.0)

    def backward_error(Hm, bv, xv):
        Hm, bv, xv = Hm.double(), bv.double(), xv.double()
        return float((Hm @ xv - bv).abs().max()
                     / (Hm.abs().sum(1).max() * xv.abs().max() + bv.abs().max()))

    for _ in range(num_iter):
        Hk, bk, ck = sim3.pose_graph_linearize(g, s, R, t)
        Hp, bp, cp = sim3.pose_graph_linearize_plain(g, s, R, t)
        worst["H"] = max(worst["H"], float((Hk - Hp).abs().max() / Hp.abs().max()))
        b_scale = bp.abs().max().clamp(min=1e-3 * float(Hp.abs().max()))
        worst["b"] = max(worst["b"], float((bk - bp).abs().max() / b_scale))
        worst["cost"] = max(worst["cost"], abs(float(ck) - float(cp)) / max(float(cp), 1e-12))
        x = linalg.spd_solve(Hk, bk)
        x_lib = cholesky_solve(Hk, bk)
        worst["solve_backward"] = max(worst["solve_backward"], backward_error(Hk, bk, x))
        worst["solve_backward_library"] = max(worst["solve_backward_library"],
                                              backward_error(Hk, bk, x_lib))
        worst["solve_vs_library"] = max(worst["solve_vs_library"], float(
            (x - x_lib).abs().max() / x_lib.abs().max().clamp(min=1e-30)))
        sk, Rk, tk = sim3.pose_graph_update(g, s, R, t, x)
        sp, Rp, tp = sim3.pose_graph_update_plain(g, s, R, t, x)
        worst["update"] = max(worst["update"], float((sk - sp).abs().max()),
                              float((Rk - Rp).abs().max()), float((tk - tp).abs().max()))
        s, R, t = sk, Rk, tk
    rk = sim3.optimize_pose_graph(*args, num_iter=num_iter)
    rp = sim3.optimize_pose_graph_plain(*args, num_iter=num_iter)
    torch.cuda.synchronize()
    whole = max(float((a - b).abs().max()) for a, b in zip(rk, rp))
    print(f"kernel P pose_graph {label}: K={args[0].shape[0]} ({int(args[4].sum())} valid), "
          f"E={args[5].shape[0]} ({int(args[10].sum())} valid), per iteration against plain on "
          f"the same state: {json.dumps(worst)}; whole optimization max |diff| {whole:.3g}, "
          f"final squared residual {float(ck):.4g}")
    # (b is a sum that cancels near the minimum: it is held to 1e-3 of the
    # larger of its largest entry and 1e-3 of H's)
    assert worst["H"] < 1e-4 and worst["b"] < 1e-3 and worst["cost"] < 1e-4 \
        and worst["update"] < 1e-5 and worst["solve_backward"] < 1e-3 and whole < 1e-3, \
        f"kernel P disagrees with plain ({label})"
    return max(worst["H"], worst["b"], worst["update"])


def check_loop_kernels(dev, slam, rec):
    """Kernels V (the .npz tree), N, C's keyframe-match call, O and P against their plain
    versions on synthetic inputs at the slice's shapes and on the loop
    slice's recorded inputs; F-I at the global shape. Returns their rows."""
    import torch

    from stella_vslam_tpu_torch.data import fbow_io
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.match import projection as proj
    from stella_vslam_tpu_torch.ops import linalg
    from stella_vslam_tpu_torch.ops.optim import ba, sim3
    from stella_vslam_tpu_torch.ops.solve import pnp

    rows = []
    rng = np.random.default_rng(40)
    N = 2872

    # ---- V on the .npz vocabulary's tree: the keyframe events' descent ----
    vocab = slam.bow_vocab
    tab = vocab.tables()
    rand = torch.from_numpy(rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)
    descs = [("random", rand)] + [(f"keyframe {i}", a[0][0].contiguous())
                                  for i, a in enumerate(rec["bow"][:3])]
    differ_v = 0
    for label, d in descs:
        differ_v += int((fbow_io.fbow_transform(d, tab)
                         != fbow_io.fbow_transform_plain(d, tab)).sum())
    torch.cuda.synchronize()
    print(f"kernel V fbow_transform on the .npz tree ({tab.n_children.shape[0]} blocks x "
          f"{tab.m_k}): {len(descs)} sets of {N} descriptors (random and the loop slice's "
          f"keyframes), word ids differing from plain: {differ_v}")
    assert differ_v == 0, "kernel V disagrees with its plain version on the .npz tree"
    rows.append(_fbow_row("fbow_transform_npz", descs[-1][1], tab, counter="fbow_transform"))

    # ---- N: PnP RANSAC ----
    syn, sf = _pnp_problem(dev, N, 41)
    err_n = _check_pnp(syn, sf, "synthetic", 41)
    for i, (a, kw) in enumerate(rec["pnp"][:4]):
        err_n = max(err_n, _check_pnp(tuple(x.contiguous() for x in a[1:5]), kw["scale_factors"],
                                      f"loop slice call {i}", a[0]))
    pa, psf = (tuple(x.contiguous() for x in rec["pnp"][0][0][1:5]),
               rec["pnp"][0][1]["scale_factors"]) if rec["pnp"] else (syn, sf)
    mc = pnp.max_cos_errors(psf, pa[2])
    n_pa, n_valid = pa[0].shape[0], int(pa[3].sum())
    rows.append(dict(
        name="pnp_ransac", route="cuda", source="stella_vslam_tpu_torch/csrc/pnp_ransac.cu",
        replaces="stella_vslam_tpu/ops/solve/pnp.py:187", max_abs_err=err_n,
        **_times(lambda: pnp.pnp_hypotheses(7, pa[0], pa[1], mc, pa[3], 256)),
        plain_ms=_median_ms(lambda: pnp.pnp_hypotheses_plain(7, pa[0], pa[1], mc, pa[3], 256),
                            reps=5, warmup=1),
        library_ms=None,
        # bytes: the matches once (bearing, point, max_cos, valid) and the 2048
        # hypotheses out; the hash of 3 B draws of each valid match (~12
        # integer operations), 2048 Newton solves (~24 x 60) and ~25
        # operations per (hypothesis, valid correspondence)
        **_bound(n_pa * 29.0 + 2048 * 60.0, 2048 * 24 * 60.0 + 2048 * n_valid * 25.0,
                 int_ops=256 * 3 * n_valid * 12.0)))

    # ---- C: the keyframe-match call (window mode, best only) ----
    def kf_match_inputs(margin):
        uv = torch.as_tensor(np.stack([rng.uniform(0, 752, N), rng.uniform(0, 480, N)], -1)
                             .astype(np.float32), device=dev)
        lvl = torch.as_tensor(rng.integers(0, 8, N).astype(np.int32), device=dev)
        perm = torch.as_tensor(rng.permutation(N), device=dev)
        flips = torch.as_tensor((rng.random((N, 8)) < 0.2) * (1 << rng.integers(0, 31, (N, 8))),
                                device=dev).to(torch.int32)
        ang = torch.as_tensor(rng.uniform(0, 6.28, N).astype(np.float32), device=dev)
        reproj = (uv[perm] + torch.as_tensor(rng.normal(0, 2.0, (N, 2)).astype(np.float32),
                                             device=dev)).contiguous()
        mask = lambda p: torch.as_tensor(rng.random(N) < p, device=dev)
        return ((uv, lvl, rand, mask(0.95), ang, mask(0.3), (rand[perm] ^ flips).contiguous(),
                 reproj, lvl[perm].contiguous(), (ang[perm] + 0.1).contiguous(), mask(0.8)),
                dict(scale_factors=sf, num_levels=8, image_size=(752.0, 480.0), margin=margin))

    cases = [("synthetic margin 10", *kf_match_inputs(10.0)),
             ("synthetic margin 3", *kf_match_inputs(3.0))]
    cases += [(f"loop slice call {i} margin {kw['margin']}", a, kw)
              for i, (a, kw) in enumerate(rec["kf_match"][:4])]
    differ_c = 0
    for label, a, kw in cases:
        a = tuple(x.contiguous() for x in a)
        ok, op = proj.match_frame_and_keyframe(*a, **kw), \
            proj.match_frame_and_keyframe(*a, **kw, top2=H.hamming_top2_plain)
        torch.cuda.synchronize()
        bad = int(((ok[0] != op[0]) | (ok[1] != op[1]) | (ok[2] != op[2])).sum())
        print(f"kernel C match_frame_and_keyframe {label}: {a[6].shape[0]} x {a[2].shape[0]}, "
              f"{int(ok[1].sum())} accepted (plain {int(op[1].sum())}), rows differing {bad}")
        differ_c += bad
    assert differ_c == 0, "kernel C's keyframe-match call disagrees with its plain version"
    label, ca, ckw = cases[-1]
    ca = tuple(x.contiguous() for x in ca)
    M_rows = ca[6].shape[0]
    # this run's work, as phase 3 counts kernel C's: the gates on every pair
    # the cell walk visits (~8 operations), XOR + popcount + add over 8
    # words and the top-2 on each candidate (~24), read off the matcher's
    # own kernel C call
    seen = []

    def top2_seen(*a_, **kw_):
        seen.append((a_, kw_))
        return H.hamming_top2(*a_, **kw_)

    proj.match_frame_and_keyframe(*ca, **ckw, top2=top2_seen)
    (ta, tkw), = seen
    visited = int(H.pairs_visited(*ta, window=tkw["window"]))
    n_cand = int(H.gate_matrix(ta[2], ta[3], tkw["window"], None).sum())
    rows.append(dict(
        name="hamming_top2_keyframe", counter="match_frame_and_keyframe", route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/projection.py:160", max_abs_err=float(differ_c),
        shape=f"{M_rows}x{ca[2].shape[0]} {label}", pairs_visited=visited,
        dense_pairs=M_rows * ca[2].shape[0],
        **_times(lambda: proj.match_frame_and_keyframe(*ca, **ckw)),
        plain_ms=_median_ms(lambda: proj.match_frame_and_keyframe(
            *ca, **ckw, top2=H.hamming_top2_plain), reps=5, warmup=1),
        library_ms=None,
        **_bound(M_rows * 57.0 + ca[2].shape[0] * 49.0 + M_rows * 16.0,
                 8.0 * visited + 24.0 * n_cand)))

    # ---- O: Sim3 refinement ----
    ta = _transform_problem(dev, N, 42)
    err_o = _check_transform(ta, {}, "synthetic")
    for i, (a, kw) in enumerate(rec["transform"][:4]):
        err_o = max(err_o, _check_transform(a, kw, f"loop slice call {i}"))
    oa, okw = rec["transform"][0] if rec["transform"] else (ta, {})
    n_o = oa[3].shape[0]
    rows.append(dict(
        name="sim3_transform", route="cuda",
        source="stella_vslam_tpu_torch/csrc/sim3_transform.cu",
        replaces="stella_vslam_tpu/ops/optim/sim3.py:56", max_abs_err=err_o, shape=f"N={n_o}",
        **_times(lambda: sim3.optimize_transform(*oa, **okw)),
        plain_ms=_median_ms(lambda: sim3.optimize_transform_plain(*oa, **okw), reps=5, warmup=1),
        library_ms=None,
        # 10 steps x ~700 operations per pair (two projections, 4 Jacobian
        # rows of 7, 4 x 36 products, the trial and the inlier pass)
        **_bound(n_o * 57.0 + n_o + 52.0, 10 * 700.0 * n_o)))

    # ---- P: pose graph ----
    ga = _graph_problem(dev, 30, 32, 128, 43)
    err_p = _check_pose_graph(ga, "synthetic")
    for i, (a, kw) in enumerate(rec["pose_graph"][:2]):
        err_p = max(err_p, _check_pose_graph(a, f"loop slice call {i}"))
    pga = rec["pose_graph"][0][0] if rec["pose_graph"] else ga
    g = sim3.PoseGraph(*pga[3:])
    Kp, Ep, n_e = pga[0].shape[0], pga[5].shape[0], int(pga[10].sum())
    Hd, b, _ = sim3.pose_graph_linearize(g, *pga[:3])
    x = linalg.spd_solve(Hd, b)
    # an iteration as optimize_pose_graph runs it: the buffers and the
    # graph's index are the optimization's, built once
    ws = sim3._workspace(g, *pga[:3])
    out = tuple(torch.empty_like(v) for v in pga[:3])

    def step_kernel():
        sim3._linearize(ws, g, *pga[:3])
        sim3._update(g, *pga[:3], x, out)

    def step_plain():
        sim3.pose_graph_linearize_plain(g, *pga[:3])
        sim3.pose_graph_update_plain(g, *pga[:3], x)

    n7 = 7 * Kp
    rows.append(dict(
        name="pose_graph", route="cuda", source="stella_vslam_tpu_torch/csrc/pose_graph.cu",
        replaces="stella_vslam_tpu/ops/optim/sim3.py:165", max_abs_err=err_p,
        shape=f"K={Kp} E={Ep} ({n_e} valid), one iteration without its solve",
        index_ms=_device_ms(lambda: sim3._workspace(g, *pga[:3])),
        **_times(step_kernel), plain_ms=_median_ms(step_plain, reps=5, warmup=1),
        library_ms=_device_ms(lambda: cholesky_solve(Hd, b)),
        library_one_call_ms=_median_ms(lambda: cholesky_solve(Hd, b)),
        library_call="torch.linalg.cholesky + cholesky_solve, the iteration's dense solve "
                     "(spd_solve's row: kernel G's solve on the card)",
        # bytes: vertices and edges read once, the [7K,7K] system and its
        # right-hand side written once, the solve's x read and the vertices
        # written once by the update (the kernel's zero fill and gauge pass
        # over the system are its own traffic, not the function's). Operations:
        # per valid edge 15 passes of ~600 and 14 x 15 x 7 x 2 for its blocks,
        # one gauge select per entry of the system, the update per vertex
        **_bound(Kp * 52.0 + Ep * 61.0 + n7 * n7 * 4.0 + n7 * 4.0 + n7 * 4.0 + Kp * 52.0,
                 n_e * (15 * 600.0 + 2940.0) + 1.0 * n7 * n7 + Kp * 300.0)))

    # ---- P's dense solve: kernel G's factorization (spd_solve) ----
    x_plain = linalg.solve_spd_blocked(Hd, b)
    x_lib = cholesky_solve(Hd, b)
    torch.cuda.synchronize()
    err_s = float((x - x_plain).abs().max() / x_plain.abs().max().clamp(min=1e-30))
    print(f"kernel G spd_solve at the pose graph's system ({n7} x {n7}): max |x - plain| "
          f"{err_s:.3g} of max |x|, against the library's "
          f"{float((x - x_lib).abs().max() / x_lib.abs().max().clamp(min=1e-30)):.3g}")
    rows.append(dict(
        name="spd_solve", route="cuda", source="stella_vslam_tpu_torch/csrc/ba_schur.cu",
        replaces="stella_vslam_tpu/ops/optim/sim3.py:255", max_abs_err=err_s,
        shape=f"n={n7} (the loop slice's pose graph, K={Kp})",
        ms=_device_ms(lambda: linalg.spd_solve(Hd, b)),
        one_call_ms=_median_ms(lambda: linalg.spd_solve(Hd, b)),
        plain_ms=_median_ms(lambda: linalg.solve_spd_blocked(Hd, b), reps=5, warmup=1),
        library_ms=_device_ms(lambda: cholesky_solve(Hd, b)),
        library_one_call_ms=_median_ms(lambda: cholesky_solve(Hd, b)),
        library_call="torch.linalg.cholesky + cholesky_solve", timing=DEVICE_TIMING,
        # the matrix and right-hand side read once, x written; n^3/3 + 2 n^2
        **_bound(n7 * n7 * 4.0 + 2 * n7 * 4.0, n7 ** 3 / 3.0 + 2.0 * n7 * n7)))

    # ---- F-I at the global shape ----
    cam = slam.mapper.cam_scalars
    probs = [("K=32 L=4096 D=16", *_ba_problem(dev, 32, 4096, 16, False, 44, spacing=0.1,
                                               ordered=True)),
             ("K=64 L=4096 D=16", *_ba_problem(dev, 64, 4096, 16, False, 45, spacing=0.1,
                                               ordered=True)),
             # G's device-memory route at 768 rows and F's direct atomics at
             # the largest K held here; fewer landmarks keep the plain side short
             ("K=128 L=1024 D=16", *_ba_problem(dev, 128, 1024, 16, False, 46, spacing=0.1,
                                                ordered=True))]
    probs += [(f"loop slice global BA {i} K={p.cam_R.shape[0]} L={p.obs_cam.shape[0]} "
               f"D={p.obs_cam.shape[1]}", p, cam) for i, p in enumerate(rec["global_ba"][:2])]
    e_pose = {}
    for label, p, c in probs:
        w = _lockstep_ba(p, c, 16, 0)
        rk = ba.bundle_adjust(p, c, num_first=16, num_second=0)
        rp = ba.bundle_adjust_plain(p, c, num_first=16, num_second=0)
        torch.cuda.synchronize()
        e_pose[label] = max(float((rk.cam_R - rp.cam_R).abs().max()),
                            float((rk.cam_t - rp.cam_t).abs().max()))
        print(f"kernels F-I global BA {label}: kernel by kernel against plain "
              f"{json.dumps(w)}; whole BA max |pose diff| {e_pose[label]:.3g}, cost "
              f"{float(rk.cost):.6g} (plain {float(rp.cost):.6g})")
        # H's trial cost is held to 1e-3 here: on the slice's problem, whose
        # observations across the loop sit on Huber's linear part, the trial
        # points' own differences (within their allowance) move it by 1.5e-4
        assert w["f_excess"] < 1.0 and w["g_backward"] < 1e-3 and w["g_pose"] < 1e-5 \
            and w["point_share"] < 1.0 and w["cost_rel"] < 1e-3 and w["decisions"] == 0 \
            and w["flags"] == 0, f"kernels F-I disagree with the plain BA at {label}"
    for (label, p, c), suffix in zip(probs[:2], ("_global32", "_global64")):
        rows += _time_ba_kernels(dev, e_pose[label], p, c, suffix=suffix)
    return rows


# kernel Q's chain rebase runs only in the pipelined tracker, when a table is
# published while frames are in flight: the inline slices never launch it
THREADED_KERNELS = ("rebase_chain",)


def _assoc_problem(dev, M, N, seed):
    """Matcher-like outputs at the slice's shapes: M sources, their best
    slots (a strided column, a third of them drawn from a third of the
    slots so that slots collide), 70% accepted, and table rows (positions
    in packed [M,8] rows, ids in column 8 of [M,10])."""
    import torch

    g = torch.Generator().manual_seed(seed)
    best = torch.randint(0, N, (M, 4), generator=g, dtype=torch.int32)
    best[: M // 3, 1] = torch.randint(0, max(1, N // 3), (M // 3,), generator=g,
                                      dtype=torch.int32)
    acc = torch.rand(M, generator=g) < 0.7
    tbl = torch.randn(M, 8, generator=g)
    ids = torch.randint(-1, 20000, (M, 10), generator=g, dtype=torch.int32)
    return best.to(dev), acc.to(dev), tbl.to(dev), ids.to(dev)


HD_SLOTS = 7984  # a 1280x720 camera's slots (8 levels, min_size 800)
EQ_HD_SLOTS = 12839  # a 1920x960 equirectangular camera's (6 levels)
# the rows at those slot counts: their launches are the 1280x720 slice's
HD_ROWS = ("scatter_to_current_hd", f"dedup_by_id_n{HD_SLOTS}", f"dedup_by_id_n{EQ_HD_SLOTS}")


def dedup_case(dev, N, seed):
    """Kernel Q's dedup inputs: 80% of N slots held, ids drawn from N // 3
    (repeated), scores from 8 values (ties), +inf where not held, as the
    cascade passes them."""
    import torch

    g = torch.Generator().manual_seed(seed)
    has = (torch.rand(N, generator=g) < 0.8).to(dev)
    ids = torch.randint(0, max(1, N // 3), (N,), generator=g, dtype=torch.int32).to(dev)
    score = torch.randint(0, 8, (N,), generator=g).to(torch.float32).to(dev)
    return has, ids, torch.where(has, score, torch.full_like(score, float("inf")))


def _same(a, b) -> bool:
    """Equal outputs (tuples of tensors, None where absent)."""
    import torch

    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def _check_assoc_call(kind, args, pose_tol=1e-6):
    """One call of a kernel Q entry point against its plain version: ints
    and copies exact, the re-anchored poses within pose_tol. Returns the
    largest pose difference."""
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    fn, plain = {"scatter": (tk.scatter_to_current, tk.scatter_to_current_plain),
                 "dedup": (tk.dedup_by_id, tk.dedup_by_id_plain),
                 "rebase": (tk.rebase_chain, tk.rebase_chain_plain)}[kind]
    k, p = fn(*args), plain(*args)
    n_exact = 3 if kind == "rebase" else len(k)
    assert _same(k[:n_exact], p[:n_exact]), f"kernel Q {kind} disagrees with its plain version"
    err = 0.0
    for x, y in zip(k[n_exact:], p[n_exact:]):
        err = max(err, float((x - y).abs().max()))
    assert err <= pose_tol, f"kernel Q {kind}: poses {err:.3g} apart"
    return err


def _gate_near(p, R, t, pos, table: bool, log_scale, equirect: bool = False, eps=1e-6):
    """Rows whose flag or level is decided by a quantity within eps
    (relative) of its threshold, in the plain version's float64 terms:
    there the kernel and the plain version may round to different sides.
    pos: points [M,3], or with `table` the packed table [C,8] (the gate's
    distance ratios, viewing cosine and level too). The equirectangular
    model's in-image test (norm > 1e-6) has no threshold a row sits near."""
    import torch

    R, t, x = R.double(), t.double(), pos.double()
    pc = x[:, 0:3] @ R.T + t
    near = lambda q, thr: (q - thr).abs() <= eps * max(1.0, abs(thr))
    out = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    if not equirect:
        z = pc[:, 2]
        u = p.fx * pc[:, 0] / z + p.cx
        v = p.fy * pc[:, 1] / z + p.cy
        out |= near(u, 0.0) | near(u, p.width) | near(v, 0.0) | near(v, p.height) \
            | near(z, 0.0)
    if table:
        ray = x[:, 0:3] + R.T @ t
        dist = torch.linalg.norm(ray, dim=-1)
        cosang = (ray * x[:, 3:6]).sum(-1) / dist
        lv = torch.log(x[:, 7] / dist) / log_scale
        out |= near(dist / x[:, 6], 0.8) | near(dist / x[:, 7], 1.3) | near(cosang, 0.5) \
            | ((lv - lv.round()).abs() <= eps)
    return out


def rows_case(dev, world, C: int, N: int, seed: int = 14, scale_factors=None):
    """Kernel R's inputs: a pose, a packed table of C landmarks with normals
    and distance bounds at random factors of the true distance (no gate or
    level on its threshold by construction), 90% valid, and N of its points
    as the last frame's chained landmarks (levels at random, 80%
    associated). With a world, its perspective camera with a 0.12 m
    baseline: depths 1-6 m in front, a tenth of the points 1.5-6 m behind
    (the camera frame's depth stays clear of 0, where an ulp of z is pixels
    of u), a pose near the identity; without one, the equirectangular leg's
    640x320 camera, points all around it at 0.5-5.5 m and any pose.
    Returns (params, R, t, tbl, table keywords, points, point keywords) for
    project_window_rows."""
    import torch

    from stella_vslam_tpu_torch.camera import base as cb

    g = torch.Generator().manual_seed(seed)
    if world is not None:
        p = cb.make_params(fx=world.fx, fy=world.fy, cx=world.W / 2.0, cy=world.H / 2.0,
                           width=world.W, height=world.H, focal_x_baseline=world.fx * 0.12)
        R = torch.linalg.qr(torch.eye(3) + 0.05 * torch.randn(3, 3, generator=g))[0]
        t = torch.tensor([0.1, -0.2, 0.3])
        z = torch.rand(C, 1, generator=g) * 5.0 + 1.0
        z = torch.where(torch.rand(C, 1, generator=g) < 0.1, -(z + 0.5), z)
        pos = torch.cat([torch.rand(C, 2, generator=g) * 8 - 4, z], 1)
        model = cb.CameraModel.PERSPECTIVE
    else:
        p = cb.make_params(cx=320.0, cy=160.0, width=640, height=320)
        R = torch.linalg.qr(torch.eye(3) + 0.3 * torch.randn(3, 3, generator=g))[0]
        t = torch.tensor([0.3, -0.1, 0.2])
        pos = torch.nn.functional.normalize(torch.randn(C, 3, generator=g), dim=1) \
            * (torch.rand(C, 1, generator=g) * 5.0 + 0.5)
        model = cb.CameraModel.EQUIRECTANGULAR
    R = (R * torch.sign(torch.det(R))).to(dev).contiguous()
    normal = torch.nn.functional.normalize(torch.randn(C, 3, generator=g), dim=1)
    d = torch.linalg.norm(pos, dim=1, keepdim=True)
    f = torch.rand(C, 2, generator=g)
    tbl = torch.cat([pos, normal, (0.9 + 0.6 * f[:, :1]) * d, (0.8 + 2.0 * f[:, 1:]) * d],
                    1).to(dev).contiguous()
    tu = torch.zeros(C, 10, dtype=torch.int32)
    tu[:, 9] = (torch.rand(C, generator=g) < 0.9).to(torch.int32)
    sf = [1.2 ** l for l in range(8)] if scale_factors is None else list(scale_factors)
    sf = torch.tensor(sf, dtype=torch.float32, device=dev)
    L = sf.shape[0]
    tkw = dict(tbl_u32=tu.to(dev), scale_factors=sf, margin=5.0,
               log_scale=float(np.log(np.float32(1.2))), num_levels=L, model=model)
    pkw = dict(scale_factors=sf, margin=20.0, model=model,
               last_level=torch.randint(0, L, (N,), generator=g, dtype=torch.int32).to(dev),
               last_valid=(torch.rand(N, generator=g) < 0.8).to(dev))
    return p, R, t.to(dev), tbl, tkw, tbl[:N, 0:3].contiguous(), pkw


def _check_rows_call(p, R, t, pos, kw):
    """Kernel R's window rows against their plain version on one call: u,
    v, x_right and the radius within 1e-5 relative of at least 100 px (near
    u = 0 the sum fx x / z + cx cancels, and one ulp of cx is already 3e-5
    px; an equirectangular u and x_right at the seam may land on either
    edge: the lesser way round), levels and flags equal except on rows
    whose deciding quantity lies within 1e-6 of its threshold (_gate_near;
    counted). Returns (the largest relative error, rows differing, rows
    near a threshold)."""
    import torch

    from stella_vslam_tpu_torch.camera import base as cb

    k = cb.project_window_rows(p, R, t, pos, **kw)
    q = cb.project_window_rows_plain(p, R, t, pos, **kw)
    eq = kw.get("model") == cb.CameraModel.EQUIRECTANGULAR
    table = kw.get("tbl_u32") is not None
    near = _gate_near(p, R, t, pos, table, kw.get("log_scale", 0.0), eq)
    ints = (k.valid != q.valid) | (k.lo != q.lo) | (k.hi != q.hi)
    if table:
        ints |= k.pred_scale != q.pred_scale
    same = ~ints

    def rel(a, b, seam=False):
        d = (a - b).abs()
        if seam:
            d = torch.minimum(d, (d - p.width).abs())
        return float((d / b.abs().clamp(min=100.0))[same].max()) if bool(same.any()) else 0.0

    err = max(rel(k.u, q.u, eq), rel(k.v, q.v), rel(k.xr, q.xr, eq), rel(k.rad, q.rad))
    assert not bool((ints & ~near).any()), "kernel R's rows disagree away from a threshold"
    assert err < 1e-5, f"kernel R's rows disagree with plain: {err:.3g}"
    return err, int(ints.sum()), int(near.sum())


def _rows_bound(M: int, table: bool, L: int, ops_per_row: float) -> dict:
    """Kernel R's window rows: read the pose and the scale factors once and
    per row its point, level and flag (a table row and its valid word);
    write u, v, x_right, radius, the two level bounds, the flag (and the
    predicted level)."""
    per_row = (32 + 4 + 29) if table else (12 + 4 + 1 + 25)
    return _bound(48 + 4.0 * L + M * per_row, ops_per_row * M)


def check_track_kernels(dev, world):
    """Kernels Q and R against their plain versions at the slice's shapes
    (N = 2872 slots, M = C = 4096 sources and table rows) on synthetic
    inputs with slot collisions, equal scores, repeated and absent ids;
    rows of the kernels line."""
    import torch

    from stella_vslam_tpu_torch.camera import base as cb
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    rows = []
    N, M, C = 2872, 4096, 4096
    src = "stella_vslam_tpu_torch/csrc/track_assoc.cu"
    # ---- Q: scatter (table sources) ----
    best, acc, tbl, ids = _assoc_problem(dev, M, N, 11)
    sargs = (best[:, 1], acc, tbl[:, 0:3], ids[:, 8], N)
    _check_assoc_call("scatter", sargs)
    held = int(tk.scatter_to_current(*sargs)[2].sum())
    print(f"kernel Q scatter_to_current: {M} sources -> {N} slots, {held} held, exact")
    rows.append(dict(
        name="scatter_to_current", route="cuda", source=src,
        replaces="stella_vslam_tpu/module/tracking_kernels.py:64", max_abs_err=0.0,
        shape=f"M={M} N={N}", **_times(lambda: tk.scatter_to_current(*sargs)),
        plain_ms=_median_ms(lambda: tk.scatter_to_current_plain(*sargs)), library_ms=None,
        # read: index, accept flag, 3 floats and an id per source; write: 3
        # floats, an id and a flag per slot; one count and a compare each
        **_bound(M * (4 + 1 + 12 + 4) + N * (12 + 4 + 1), 4.0 * (M + N))))
    # at the 1280x720 camera's slots (7984): kernel Q's cap was 4096 slots
    hb, ha, ht, hi = _assoc_problem(dev, M, HD_SLOTS, 15)
    hd_sargs = (hb[:, 1], ha, ht[:, 0:3], hi[:, 8], HD_SLOTS)
    _check_assoc_call("scatter", hd_sargs)
    print(f"kernel Q scatter_to_current: {M} sources -> {HD_SLOTS} slots, "
          f"{int(tk.scatter_to_current(*hd_sargs)[2].sum())} held, exact")
    rows.append(dict(
        name="scatter_to_current_hd", counter="scatter_to_current", route="cuda", source=src,
        replaces="stella_vslam_tpu/module/tracking_kernels.py:64", max_abs_err=0.0,
        shape=f"M={M} N={HD_SLOTS} (1280x720)", **_times(lambda: tk.scatter_to_current(*hd_sargs)),
        plain_ms=_median_ms(lambda: tk.scatter_to_current_plain(*hd_sargs)), library_ms=None,
        **_bound(M * (4 + 1 + 12 + 4) + HD_SLOTS * (12 + 4 + 1), 4.0 * (M + HD_SLOTS))))
    # ---- Q: dedup, at the bench's 2872 slots, 1280x720's 7984 and a
    # 1920x960 equirectangular camera's 12839 (6 levels) ----
    for n in (N, HD_SLOTS, EQ_HD_SLOTS):
        dargs = dedup_case(dev, n, 12)
        _check_assoc_call("dedup", dargs)
        kept = int(tk.dedup_by_id(*dargs)[0].sum())
        print(f"kernel Q dedup_by_id: {int(dargs[0].sum())} held slots of {n} over {n // 3} ids "
              f"with tied scores, {kept} kept, exact")
        rows.append(dict(
            name="dedup_by_id" + ("" if n == N else f"_n{n}"), counter="dedup_by_id",
            route="cuda", source=src,
            replaces="stella_vslam_tpu/module/tracking_kernels.py:83", max_abs_err=0.0,
            shape=f"N={n}", **_times(lambda: tk.dedup_by_id(*dargs)),
            plain_ms=_median_ms(lambda: tk.dedup_by_id_plain(*dargs)), library_ms=None,
            **_bound(n * (1 + 4 + 4) + n * (1 + 4), 10.0 * n)))
    # ---- Q: rebase ----
    g = torch.Generator().manual_seed(13)
    la_id = torch.randint(-1, 3 * C // 2, (N,), generator=g, dtype=torch.int32)
    tbl_u32 = torch.randint(0, 1 << 30, (C, 10), generator=g, dtype=torch.int32)
    tbl_u32[:, 8] = torch.randint(-1, C, (C,), generator=g, dtype=torch.int32)
    rot = lambda: torch.linalg.qr(torch.randn(3, 3, generator=g))[0]
    rargs = [torch.randn(N, 3, generator=g), torch.rand(N, generator=g) < 0.9, la_id,
             torch.randn(C, 8, generator=g), tbl_u32, rot(), torch.randn(3, generator=g),
             rot(), torch.randn(3, generator=g), rot(), torch.randn(3, generator=g)]
    rargs = [a.to(dev).contiguous() for a in rargs]
    err_r = _check_assoc_call("rebase", rargs)
    found = int(tk.rebase_chain(*rargs)[1].sum())
    print(f"kernel Q rebase_chain: {N} chained slots against {C} table ids (repeated, "
          f"absent, -1), {found} kept valid, ints exact, poses {err_r:.3g} apart")
    rows.append(dict(
        name="rebase_chain", route="cuda", source=src,
        replaces="stella_vslam_tpu/tracking_module.py:51", max_abs_err=err_r,
        shape=f"N={N} C={C}", **_times(lambda: tk.rebase_chain(*rargs)),
        plain_ms=_median_ms(lambda: tk.rebase_chain_plain(*rargs)), library_ms=None,
        # read: the chain (3 floats, flag, id per slot), ids and positions of
        # the table, 5 small poses; write the chain and 2 poses
        **_bound(N * 17 + C * 16 + 5 * 48 + N * 17 + 96, 12.0 * (N + C))))

    # ---- R: the cascade's window rows (table and points), undistortion ----
    srcr = "stella_vslam_tpu_torch/csrc/reproject.cu"
    p, R, t, tbl, tkw, pts, pkw = rows_case(dev, world, C, N)
    for label, args, kw, M, table in (("table", tbl, tkw, C, True),
                                      ("points", pts, pkw, N, False)):
        before = cb.project_window_rows.launches
        err, n_diff, n_near = _check_rows_call(p, R, t, args, kw)
        assert cb.project_window_rows.launches == before + 1
        print(f"kernel R project_window_rows ({label}): {M} rows, u, v, x_right and radius "
              f"within {err:.3g} relative (of at least 100 px), {n_diff} rows apart, "
              f"{n_near} within 1e-6 of a threshold; one launch")
        rows.append(dict(
            name="project_window_rows" + ("" if table else "_points"),
            counter="project_window_rows", route="cuda", source=srcr,
            replaces="stella_vslam_tpu/camera/base.py:232, module/tracking_kernels.py:266-285, "
                     "match/projection.py:53,127",
            max_abs_err=err, rows_differing=n_diff,
            shape=(f"C={M} table rows with the local-map gate" if table
                   else f"M={M} last-frame points"),
            **_times(lambda: cb.project_window_rows(p, R, t, args, **kw)),
            plain_ms=_median_ms(lambda: cb.project_window_rows_plain(p, R, t, args, **kw)),
            library_ms=None, **_rows_bound(M, table, 8, 100.0 if table else 60.0)))
    pe = cb.make_params(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
                        k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, width=752, height=480)
    g = torch.Generator().manual_seed(16)
    kp = (torch.rand(N, 2, generator=g) * torch.tensor([752.0, 480.0])).to(dev)
    rel = lambda a, b: float(((a - b).abs() / b.abs().clamp(min=100.0)).max())
    err_u = rel(cb.undistort_norm(pe, kp), cb.perspective_undistort(pe, kp))
    # with the bearings of the same launch, bit for bit: the plain version
    # rounds as the JAX version's jitted preprocessing
    (uk, bk), (up, bp) = cb.undistort_norm(pe, kp, True), cb.perspective_undistort(pe, kp, True)
    apart = int(((uk != up).any(-1) | (bk != bp).any(-1)).sum())
    print(f"kernel R undistort_norm: {N} keypoints (EuRoC's radtan), within {err_u:.3g} "
          f"relative; with bearings {apart} rows apart from plain")
    assert err_u < 1e-5 and apart == 0, "kernel R's undistortion disagrees with its plain version"
    # (the undistortion alone is the camera's entry point into the frame
    # finish's kernel; its row is the frame finish's, check_frame_finish)
    return rows


# kernel R's frame finish: the cameras of the slices and legs (EuRoC's
# radial-tangential pinhole at 752x480, the fisheye and division legs'
# cameras, the equirectangular box room at 640x320), with the feeds
FINISH_CAMERAS = ("perspective", "fisheye", "radial_division", "equirectangular")
FINISH_FEEDS = ("mono", "stereo", "RGBD")
# the kernels line's rows of the frame finish beside "frame_finish" (the
# perspective camera), and the leg whose launches each reads
FINISH_ROWS = {"fisheye": "frame_finish_fisheye", "radial_division": "frame_finish_radial",
               "equirectangular": "frame_finish_equirect"}


def finish_camera(model: str):
    """A camera of `model` as the slices and legs run it, with a stereo
    baseline (x_right of the RGBD feed)."""
    from stella_vslam_tpu_torch.camera import base as cb
    from stella_vslam_tpu_torch.util import synthetic

    if model == "equirectangular":
        p, w, h = cb.make_params(cx=320.0, cy=160.0, width=640, height=320), 640, 320
    else:
        k = (dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
                  k2=0.07395907, p1=0.00019359, p2=1.76187114e-05) if model == "perspective"
             else dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0,
                       **(dict(zip(("k1", "k2", "k3", "k4"), synthetic.FISH_D))
                          if model == "fisheye" else dict(k1=synthetic.RADIAL_K1))))
        p, w, h = cb.make_params(width=752, height=480, focal_x_baseline=50.38, **k), 752, 480
    return cb.Camera(model, cb.CameraModel[model.upper()], cb.Setup.MONOCULAR, p,
                     width=w, height=h)


def finish_case(dev, cam, feed: str, n: int, seed: int, feats=None):
    """Kernel R's frame-finish inputs: n seeded slots over the image (the
    first at the principal point; 80% valid, levels 0-7, random descriptor
    bits) or the given features; with `feed` stereo, kernel T's outputs
    (60% matched, -1 elsewhere), with RGBD a raw depth map of the image's
    size with 20% holes (zeros) and a factor of 5000. Returns (features,
    keyword arguments of frame_finish)."""
    import torch

    from stella_vslam_tpu_torch.feature.orb_extractor import FrameFeatures

    rng = np.random.default_rng(seed)
    W, H = cam.width, cam.height
    if feats is None:
        xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
        xy[0] = [cam.params.cx, cam.params.cy]
        t = lambda a: torch.as_tensor(a, device=dev)
        feats = FrameFeatures(
            xy=t(xy), response=t(rng.uniform(0, 100, n).astype(np.float32)),
            angle=t(rng.uniform(-np.pi, np.pi, n).astype(np.float32)),
            level=t(rng.integers(0, 8, n).astype(np.int32)), valid=t(rng.random(n) < 0.8),
            desc=t(rng.integers(-2**31, 2**31, (n, 8), dtype=np.int32)))
    n = feats.num_slots
    if feed == "stereo":
        d = rng.uniform(0.5, 10.0, n).astype(np.float32)
        hit = rng.random(n) < 0.6
        x = feats.xy[:, 0].cpu().numpy()
        return feats, dict(
            x_right=torch.as_tensor(np.where(hit, x - 50.38 / d, -1.0).astype(np.float32),
                                    device=dev),
            depths=torch.as_tensor(np.where(hit, d, -1.0).astype(np.float32), device=dev))
    if feed == "RGBD":
        raw = rng.integers(1, 40000, (H, W)).astype(np.float32)
        raw[rng.random((H, W)) < 0.2] = 0.0
        return feats, dict(depth_map=torch.as_tensor(raw, device=dev),
                           inv_depth_factor=1.0 / 5000.0)
    return feats, {}


def finish_bits_apart(a, b) -> dict:
    """Elements whose bits differ between two FrameFinish results, by field."""
    import torch

    bits = lambda t: t.contiguous().view(torch.int32)
    return {name: int((bits(getattr(a, name)) != bits(getattr(b, name))).sum())
            for name in a._fields}


def check_frame_finish(dev, world):
    """Kernel R's frame finish (data/frame.py frame_finish, one launch a
    frame) against its plain version on the card, bit for bit, every
    output: for each camera model and each feed (mono, stereo, RGBD) on
    2872 seeded slots (1199 for the equirectangular camera), and on the
    world's extracted frame with the perspective camera. Rows of the
    kernels line, one a model (device time of the mono feed; stereo and
    RGBD beside)."""
    import torch

    from stella_vslam_tpu_torch.data import frame as fm
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    rows = []
    ex = ox.OrbExtractor(OrbParams(num_levels=8), world.W, world.H, min_area=800, device=dev)
    real = ex.extract(torch.from_numpy(world.render(pose_at_xy(0.6, 0.0))).to(dev))
    # per slot: 53 bytes of features read, 84 of the pack written, the
    # undistorted pixel (none for the equirectangular model), the bearing
    # and x_right / depth; the undistortion's operations (10 steps of ~25
    # for radial-tangential, of ~40 with tanf for Kannala-Brandt, the
    # division model's ~16, the equirectangular model's sines and cosines)
    ops = {"perspective": 265.0, "fisheye": 445.0, "radial_division": 31.0,
           "equirectangular": 90.0}
    for model in FINISH_CAMERAS:
        cam = finish_camera(model)
        n = 1199 if model == "equirectangular" else 2872
        apart, ms = {}, {}
        cases = [(feed, None) for feed in FINISH_FEEDS]
        if model == "perspective":
            cases += [(feed + " (extracted frame)", real) for feed in ("mono", "RGBD")]
        for seed, (label, feats_in) in enumerate(cases):
            feed = label.split()[0]
            feats, kw = finish_case(dev, cam, feed, n, 40 + seed, feats_in)
            before = fm.frame_finish.launches
            k = fm.frame_finish(cam, feats, **kw)
            assert fm.frame_finish.launches == before + 1, "frame_finish: not one launch"
            q = fm.frame_finish_plain(cam, feats, **kw)
            torch.cuda.synchronize()
            apart[label] = finish_bits_apart(k, q)
            if feats_in is None:
                ms[feed] = (_times(lambda: fm.frame_finish(cam, feats, **kw)),
                            _median_ms(lambda: fm.frame_finish_plain(cam, feats, **kw)))
        print(f"kernel R frame_finish ({model}, {n} slots): elements whose bits differ "
              f"from plain by feed and output: {json.dumps(apart)}")
        assert not any(v for d in apart.values() for v in d.values()), \
            f"kernel R's frame finish ({model}) is not bit-equal to its plain version"
        und = 0.0 if model == "equirectangular" else 8.0
        # the equirectangular row's launches are its leg's (EQUIRECT_ROWS
        # maps its name), the fisheye and division rows' their legs'
        # (DISTORTED_ROWS)
        counter = {} if model == "equirectangular" else dict(counter="frame_finish")
        rows.append(dict(
            name=FINISH_ROWS.get(model, "frame_finish"), **counter, route="cuda",
            source="stella_vslam_tpu_torch/csrc/reproject.cu",
            replaces="stella_vslam_tpu/camera/base.py:89,134,160,202-232 (undistort, "
                     "bearings), system.py:178-189,486-505 (the preprocess tail), "
                     "data/frame.py:27 (pack_host_cols)",
            max_abs_err=0.0, bit_equal=True, elements_differing_from_plain=apart,
            shape=f"N={n}, the mono feed (stereo and RGBD beside)", **ms["mono"][0],
            plain_ms=ms["mono"][1], library_ms=None,
            **{f"{k}_{feed.lower()}": v for feed in ("stereo", "RGBD")
               for k, v in dict(ms=ms[feed][0]["ms"], one_call_ms=ms[feed][0]["one_call_ms"],
                                plain_ms=ms[feed][1]).items()},
            **_bound(n * (53.0 + 84.0 + und + 12.0 + 8.0), ops[model] * n)))
    return rows


def check_repeatability(dev, loop_rec, cam):
    """Kernels F-I and P twice on the same inputs: the same bits. F-I as
    whole BAs at the init, local and global shapes and on the loop slice's
    first global BA problem; P as 20-iteration pose graphs, synthetic and
    the loop slice's first."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba, sim3

    cases = [("init K=2 L=4096 D=2", *_ba_problem(dev, 2, 4096, 2, False, 51), (5, 10)),
             ("local K=16 L=4096 D=12",
              *_ba_problem(dev, 16, 4096, 12, False, 52, spacing=0.1, ordered=True), (3, 6)),
             ("global K=32 L=4096 D=16",
              *_ba_problem(dev, 32, 4096, 16, False, 53, spacing=0.1, ordered=True), (16, 0)),
             ("global K=64 L=4096 D=16",
              *_ba_problem(dev, 64, 4096, 16, False, 54, spacing=0.1, ordered=True), (16, 0))]
    for prob in loop_rec.get("global_ba", [])[:1]:
        cases.append((f"loop slice global BA K={prob.cam_R.shape[0]} "
                      f"L={prob.obs_cam.shape[0]} D={prob.obs_cam.shape[1]}", prob, cam,
                      (16, 0)))
    out = {}
    for label, prob, c, (n1, n2) in cases:
        a = ba.bundle_adjust(prob, c, num_first=n1, num_second=n2)
        b = ba.bundle_adjust(prob, c, num_first=n1, num_second=n2)
        torch.cuda.synchronize()
        out[label] = _same(a, b)
    graphs = [("synthetic K=30 E=128", _graph_problem(dev, 30, 32, 128, 61))]
    graphs += [("loop slice pose graph", a) for a, _ in loop_rec.get("pose_graph", [])[:1]]
    for label, args in graphs:
        a = sim3.optimize_pose_graph(*args)
        b = sim3.optimize_pose_graph(*args)
        torch.cuda.synchronize()
        out["P " + label] = _same(a, b)
    print("kernels F-I and P twice on the same inputs, bit-identical: " + json.dumps(out))
    assert all(out.values()), "a kernel F-I or P result changed between two launches"
    return out


def check_solves_under_load(dev, seconds: float = 6.0) -> dict:
    """Kernel G, spd_solve and kernel F launched from seven host threads,
    each on its own stream, while an eighth keeps the card busy with kernel
    F: the threaded System's mapper (local BA), loop closer (pose graph)
    and detached global BA share the card so. Cases: G at K = 16 (one
    block) and K = 64 (a cluster of 4 blocks); spd_solve at n = 224 and 448
    (the pose graph at 32 and 64 keyframes, one cluster kernel of 4 blocks
    at two shared-memory sizes) and n = 672 (a cluster of 8); F (its
    system, cost and partials) at the local shape (K = 16, L = 4096, D =
    12) and a global one (K = 64, L = 4096, D = 16). Every launch
    must give the bits its case gave on the idle card; the mismatches are
    counted on the card, so that the launches run back to back. Returns
    {case: [launches, launches whose bits differ]}."""
    import torch

    from stella_vslam_tpu_torch.ops import linalg
    from stella_vslam_tpu_torch.ops.optim import ba

    def g_case(K, seed):
        prob, cam = _ba_problem(dev, K, 1024, 16, False, seed, spacing=0.1, ordered=K <= 32)
        st = ba._KernelState(prob, cam)
        st.ctrl[ba._LAM] = 1e-4
        ba.ba_linearize_schur(st, torch.ones((1024, 16), dtype=torch.uint8, device=dev), True)
        saved = (st.hc.clone(), st.S.clone(), st.rhs.clone())

        def solve():
            for dst, src in zip((st.hc, st.S, st.rhs), saved):
                dst.copy_(src)
            ba.ba_reduced_solve(st)
            return st.dx
        return solve

    def spd_case(n, seed):
        rng = np.random.default_rng(seed)
        M = rng.normal(size=(n, n)).astype(np.float32)
        A = torch.as_tensor(M @ M.T / n + np.eye(n, dtype=np.float32), device=dev).contiguous()
        b = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
        return lambda: linalg.spd_solve(A, b)

    def f_case(K, L, D, seed):
        prob, cam = _ba_problem(dev, K, L, D, False, seed, spacing=0.1, ordered=True)
        st = ba._KernelState(prob, cam)
        st.ctrl[ba._LAM] = 1e-4
        inl = torch.ones((L, D), dtype=torch.uint8, device=dev)

        def linearize():
            ba.ba_linearize_schur(st, inl, True)
            return torch.cat([st.hc.flatten(), st.S.flatten(), st.rhs, st.ctrl[:1]])
        return linearize

    cases = {"G K=16 (one block)": g_case(16, 91), "G K=64 (cluster of 4)": g_case(64, 92),
             "spd_solve n=224 (cluster of 4)": spd_case(224, 93),
             "spd_solve n=448 (cluster of 4)": spd_case(448, 94),
             "spd_solve n=672 (cluster of 8)": spd_case(672, 96),
             "F K=16 L=4096 D=12 (local)": f_case(16, 4096, 12, 97),
             "F K=64 L=4096 D=16 (global)": f_case(64, 4096, 16, 98)}
    counts = _under_load(dev, cases, seconds)
    print(f"kernels G, spd_solve and F from {len(cases)} threads on their own streams beside "
          "kernel F, "
          "[launches, launches whose bits differ from the idle card's]: " + json.dumps(counts))
    assert all(n > 0 and bad == 0 for n, bad in counts.values()), \
        "kernel G, spd_solve or F gave other bits under concurrent launches"
    return counts


def _pair_describe_args(dev):
    """Kernel B's arguments for both images of a bench stereo-like pair
    (752x480, 8 levels, 2 x 2872 slots; the frames at x = 0.6 and 3.0 m),
    keypoints from kernel A."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    params = OrbParams(num_levels=8)
    ex = ox.OrbExtractor(params, 752, 480, min_area=800, device=dev)
    world = bench_world()
    pair = torch.stack([torch.from_numpy(world.render(pose_at_xy(x, 0.0))).to(dev)
                        for x in (0.6, 3.0)])
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    pyr = ex.pyramid_flat(pair)
    _, px, py, valid, _ = ox.fast_nms_pyramid(pyr, ex._fast, *thr)
    base, hh, ww = ex._slots(2)
    return (pyr.reshape(-1), base, hh, ww, px.reshape(-1), py.reshape(-1), valid.reshape(-1),
            ex._tables)


def check_cascade_under_load(dev, seconds: float = 6.0) -> dict:
    """Kernels C, D, B, A and Q launched from thirteen host threads, each on
    its own stream, while another keeps the card busy with kernel F: the
    threaded System's tracking thread and its loop detector share C and D
    (and D's shared-memory limit), the tracking thread and the stereo front
    end B and A, the tracking threads of two Systems Q (and its
    shared-memory limits, raised once under a lock). Cases: C's window call
    at 2872 x 2872 (keypoints to 5x the image; the call builds its cell
    index and walks it), C's brute force at 2872 x 2872, D on a batch of
    two 2872-slot problems (the cascade's first launch) and on one
    1199-slot equirectangular problem, B on a bench frame's 2872 slots and
    in strip mode on a pair, A on a bench frame and on a pair, Q's scatter
    at 4096 x 2872 and its dedup at 2872, 1199 and 12839 slots (the dedup's
    shared memory differs with N). Every launch must give the bits its case
    gave on the idle card. Returns {case: [launches, launches whose bits
    differ]}."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.module import tracking_kernels as tk
    from stella_vslam_tpu_torch.ops.optim import pose as pose_mod

    cases = {}
    cc = _cell_cases(dev, seed=23)
    for label, a, kw in (cc[0], cc[-2]):
        cases[f"C {label}"] = (lambda a=a, kw=kw: torch.stack(H.hamming_top2(*a, **kw)))
    rng = np.random.default_rng(24)
    params = OrbParams(num_levels=8)
    probs = [_pose_problem(dev, rng, 2872, params) for _ in range(2)]
    batch = [torch.stack([p[i] for p in probs]) for i in range(7)]
    flat = lambda r: torch.cat([r.R_cw.flatten(), r.t_cw.flatten(), r.chi_sq.flatten(),
                                r.is_inlier.float().flatten()])
    cases["D batch of 2, N=2872"] = lambda: flat(pose_mod.optimize_pose_batch(*batch, probs[0][-1]))
    eq = _pose_problem(dev, rng, 1199, params, "equirectangular")
    cases["D equirect, N=1199"] = lambda: flat(pose_mod.optimize_pose(
        *eq[:7], eq[-1], model="equirectangular"))
    sargs = _pair_describe_args(dev)
    n = sargs[1].numel() // 2
    fargs = tuple(a[:n].contiguous() for a in sargs[1:7])
    bits = lambda out: torch.cat([out[0].view(torch.int32), out[1].flatten()]
                                 + [x.flatten().int() for x in out[2:]])
    cases[f"B {n} slots"] = lambda: bits(ox.orb_describe(sargs[0], *fargs, sargs[7]))
    cases[f"B strips 2 x {n} slots"] = lambda: bits(ox.orb_describe_strips(*sargs))
    frames = fast_frames(dev)
    for label, ex, pyr, mask in frames[:2]:
        thr = (float(ex.params.ini_fast_thr), float(ex.params.min_fast_thr))
        cases[f"A {label}"] = (lambda ex=ex, pyr=pyr, thr=thr: torch.cat([
            x.view(torch.int32).flatten() if x.dtype == torch.float32 else x.flatten().int()
            for x in ox.fast_nms_pyramid(pyr, ex._fast, *thr)]))
    best, acc, tbl, ids = _assoc_problem(dev, 4096, 2872, 11)
    cases["Q scatter 4096 x 2872"] = lambda: torch.cat([
        t.flatten().view(torch.int32) if t.dtype == torch.float32 else t.flatten().int()
        for t in tk.scatter_to_current(best[:, 1], acc, tbl[:, 0:3], ids[:, 8], 2872)])
    for m in (2872, 1199, EQ_HD_SLOTS):
        dargs = dedup_case(dev, m, 12)
        cases[f"Q dedup N={m}"] = lambda dargs=dargs: torch.cat(
            [t.int() for t in tk.dedup_by_id(*dargs)])
    counts = _under_load(dev, cases, seconds)
    print(f"kernels C, D, B, A and Q from {len(cases)} threads on their own streams beside "
          "kernel F, [launches, launches whose bits differ from the idle card's]: "
          + json.dumps(counts))
    assert all(n > 0 and bad == 0 for n, bad in counts.values()), \
        "kernel C, D, B, A or Q gave other bits under concurrent launches"
    return counts


def _under_load(dev, cases, seconds):
    """Each case's function run in a loop by its own host thread on its own
    stream for `seconds`, beside a thread that keeps launching kernel F at
    the global shape; every result compared on the card with the case's
    result on the idle card (the host stays within 64 launches of the card).
    A launch that fails fails the check. Returns {case: [launches, launches
    whose bits differ]}."""
    import threading

    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    refs = {name: fn().clone() for name, fn in cases.items()}
    torch.cuda.synchronize()
    lprob, lcam = _ba_problem(dev, 32, 4096, 16, False, 95, spacing=0.1, ordered=True)
    load_st = ba._KernelState(lprob, lcam)
    load_in = torch.ones((4096, 16), dtype=torch.uint8, device=dev)
    stop = threading.Event()
    counts, errors = {}, []

    def load():
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            while not stop.is_set():
                for _ in range(4):
                    ba.ba_linearize_schur(load_st, load_in, True)
                torch.cuda.current_stream(dev).synchronize()

    def run(name, fn):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                n = 0
                while not stop.is_set():
                    bad += (fn() != refs[name]).any()
                    n += 1
                    if n % 64 == 0:  # the host stays within 64 launches of the card
                        torch.cuda.current_stream(dev).synchronize()
                torch.cuda.current_stream(dev).synchronize()
                counts[name] = [n, int(bad)]
        except Exception as e:  # noqa: BLE001 - reported after the join
            errors.append(f"{name}: {e!r}")

    threads = [threading.Thread(target=load)]
    threads += [threading.Thread(target=run, args=item) for item in cases.items()]
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    return counts


# kernel W: the sharded global BA's (phase 12's sharded loop slice; the
# slices' global BAs run unsharded on one card)
SHARDED_KERNELS = ("ba_shard_assemble",)
# the shards of the one-card sharded route: JAX's virtual mesh on one card
VIRTUAL_SHARDS = 4


def _shard_states(dev, prob, cam, n):
    """Kernel states of prob's n shards on `dev`, with F's first launch done
    on each (its block partials in place for W)."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.parallel import sharded_ba as shba

    shards = shba.shard_problem(prob, [dev] * n)
    states = [ba._KernelState(p, cam) for p in shards]
    for st, p in zip(states, shards):
        st.ctrl[ba._LAM] = 1e-4
        ba.ba_linearize_schur(st, torch.ones_like(p.obs_valid).to(torch.uint8), True,
                              reduce=False)
    return states


def check_sharded_ba(dev, loop_rec, cam):
    """K22 on VIRTUAL_SHARDS landmark shards on one card: kernel W's reduce
    mode against its plain version exactly; whole sharded BAs against the
    unsharded BA bit for bit at every shape whose F block count is not cut
    and on the loop slice's global BA problems, and within phase 4's bounds
    where it is cut; make_sharded_ba_step against its plain version and the
    one-shard step; the dry run. Times W, its plain version and torch.sum,
    and the whole sharded BA against the unsharded one. Returns W's row."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.parallel import sharded_ba as shba

    n = VIRTUAL_SHARDS
    devs = [dev] * n
    # ---- W's reduce mode against plain (K = 32, L = 4096, D = 16: 4 x 8 blocks) ----
    prob, pcam = _ba_problem(dev, 32, 4096, 16, False, 71, spacing=0.1, ordered=True)
    states = _shard_states(dev, prob, pcam, n)
    K = 32
    psize = 33 * K + 1 + 36 * K * K
    parts = [st.f_part[:st.f_blocks * psize] for st in states]
    table = ba.shard_table(states)
    ba.ba_shard_assemble(states[0], table, decide=False)
    hc, rhs, cost, S = ba.shard_reduce_plain(parts, K)
    torch.cuda.synchronize()
    w_same = torch.equal(states[0].hc, hc) and torch.equal(states[0].rhs, rhs) \
        and torch.equal(states[0].ctrl[0], cost) and torch.equal(states[0].S, S)
    w_err = max(float((states[0].hc - hc).abs().max()), float((states[0].S - S).abs().max()),
                float((states[0].rhs - rhs).abs().max()))
    n_blocks = sum(st.f_blocks for st in states)
    print(f"kernel W ba_shard_assemble reduce mode: {n} shards x {states[0].f_blocks} blocks "
          f"of {psize} floats (K={K}), equal to plain: {w_same} (max |diff| {w_err:.3g})")
    assert w_same, "kernel W's reduce mode disagrees with its plain version"
    stacked = torch.stack([p.reshape(-1, psize) for p in parts]).reshape(-1, psize)
    w_launch = lambda: ba.ba_shard_assemble(states[0], table, decide=False)
    row = dict(
        name="ba_shard_assemble", route="cuda", source="stella_vslam_tpu_torch/csrc/ba_schur.cu",
        replaces="stella_vslam_tpu/parallel/sharded_ba.py:158", max_abs_err=w_err,
        shape=f"reduce mode, one device's replica: {n} shards x {states[0].f_blocks} blocks, "
              f"K={K}",
        ms=_device_ms(w_launch), one_call_ms=_median_ms(w_launch),
        plain_ms=_median_ms(lambda: ba.shard_reduce_plain(parts, K), reps=10),
        library_ms=_device_ms(lambda: torch.sum(stacked, 0)),
        library_one_call_ms=_median_ms(lambda: torch.sum(stacked, 0)),
        library_call="torch.sum over the stacked partials (another order)",
        timing=DEVICE_TIMING,
        # every partial read once, one replica of the system written once;
        # one add per partial entry
        **_bound((n_blocks + 1) * psize * 4.0, n_blocks * float(psize)))

    # ---- whole BAs: sharded on one card against unsharded ----
    shapes = [(32, 4096, 16, 72), (32, 8192, 32, 73), (64, 4096, 16, 74)]
    cases = [(f"K={K_} L={L_} D={D_}", *_ba_problem(dev, K_, L_, D_, False, seed, spacing=0.1,
                                                     ordered=True)) for K_, L_, D_, seed in shapes]
    cases += [(f"loop slice global BA {i} K={p.cam_R.shape[0]} L={p.obs_cam.shape[0]} "
               f"D={p.obs_cam.shape[1]}", p, cam) for i, p in enumerate(loop_rec["global_ba"])]
    out = {}
    for label, p, c in cases:
        K_, L_ = p.cam_R.shape[0], p.obs_cam.shape[0]
        assert ba.f_blocks(K_, L_) == -(-L_ // ba.LM_CHUNK), f"F's count is cut at {label}"
        a = ba.bundle_adjust(p, c, num_first=16, num_second=0)
        b = shba.sharded_bundle_adjust(p, c, num_first=16, num_second=0, devices=devs)
        torch.cuda.synchronize()
        out[label] = _same(a, b)
    print(f"sharded BA on {n} shards of one card against the unsharded BA, bit-identical: "
          + json.dumps(out))
    assert all(out.values()), "a sharded BA differs from the unsharded one"
    # F's count cut (64 chunks > 56 partials of a K = 64 system): another order
    pc, cc = _ba_problem(dev, 64, 8192, 16, False, 75, spacing=0.1, ordered=True)
    assert ba.f_blocks(64, 8192) < 64
    a = ba.bundle_adjust(pc, cc, num_first=16, num_second=0)
    b = shba.sharded_bundle_adjust(pc, cc, num_first=16, num_second=0, devices=devs)
    torch.cuda.synchronize()
    e_pose = max(float((a.cam_R - b.cam_R).abs().max()), float((a.cam_t - b.cam_t).abs().max()))
    twice = (pc.obs_valid & ~a.obs_is_outlier).sum(1) >= 2
    e_pts = float((a.lm_pos - b.lm_pos).abs().max(1).values[twice].max())
    print(f"sharded BA K=64 L=8192 D=16 (F's count cut to {ba.f_blocks(64, 8192)} of 64): "
          f"max |pose diff| {e_pose:.3g}, points seen twice {e_pts:.3g}, flags differing "
          f"{int((a.obs_is_outlier != b.obs_is_outlier).sum())}")
    assert e_pose < 1e-4 and e_pts < 1e-3, "the sharded BA at the cut shape is out of bounds"

    # ---- the sharded GN step against its plain version and the one-shard step ----
    ps, pcs = _ba_problem(dev, 8, 1024, 4, False, 76)
    k4 = shba.make_sharded_ba_step(devs, pcs)(ps)
    k1 = shba.make_sharded_ba_step([dev], pcs)(ps)
    cpu = ba.BAProblem(*[None if x is None else x.cpu() for x in ps])
    pl = shba.make_sharded_ba_step(["cpu"] * n, pcs)(cpu)
    torch.cuda.synchronize()
    e_step = max(float((k4.cam_R.cpu() - pl.cam_R).abs().max()),
                 float((k4.cam_t.cpu() - pl.cam_t).abs().max()))
    e_step_p = float((k4.lm_pos.cpu() - pl.lm_pos).abs().max())
    step_same = _same((k4.cam_R, k4.cam_t, k4.lm_pos), (k1.cam_R, k1.cam_t, k1.lm_pos))
    print(f"make_sharded_ba_step K=8 L=1024 D=4 on {n} shards: against plain max |pose diff| "
          f"{e_step:.3g}, points {e_step_p:.3g}; equal to the one-shard step: {step_same}")
    assert e_step < 1e-4 and e_step_p < 1e-3 and step_same, "the sharded GN step disagrees"
    shba.dryrun_multidevice(n)
    torch.cuda.synchronize()

    # ---- the whole BA's time, sharded against unsharded, on one card ----
    p32, c32 = cases[0][1], cases[0][2]
    t_one = _median_ms(lambda: ba.bundle_adjust(p32, c32, num_first=16, num_second=0),
                       reps=5, warmup=1)
    t_sh = _median_ms(lambda: shba.sharded_bundle_adjust(p32, c32, num_first=16, num_second=0,
                                                         devices=devs), reps=5, warmup=1)
    row["whole_ba_ms"] = dict(shape=cases[0][0], unsharded=t_one, sharded=t_sh, shards=n,
                              **_sharded_ba_bound_and_plain(p32, c32, devs))
    print(f"whole global BA {cases[0][0]}, one Huber stage of 16: unsharded {t_one:.3f} ms, "
          f"sharded on {n} shards of one card {t_sh:.3f} ms; "
          + json.dumps({k: v for k, v in row["whole_ba_ms"].items() if k != "shape"}))
    return [row]


def _sharded_ba_bound_and_plain(prob, cam, devs) -> dict:
    """K22's bound and plain time for one sharded BA (one Huber stage of
    16): the bound sums, over the iterations the kernels ran (counted on a
    run that reads the stop flag before each iteration), the bounds of F and
    H on every shard and of W's reduce mode and G on every replica; the
    plain time is bundle_adjust_shards_plain (iteration_plain) over the
    same shards on the card, one call."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba
    from stella_vslam_tpu_torch.parallel import sharded_ba as shba

    shards = shba.shard_problem(prob, devs)
    K, D = prob.cam_R.shape[0], prob.obs_cam.shape[1]
    run, iters = ba.shard_iteration, [0]

    def counting(states, *args, **kw):
        iters[0] += float(states[0].ctrl[ba._DONE]) == 0.0
        return run(states, *args, **kw)

    ba.shard_iteration = counting
    try:
        ba.bundle_adjust_shards(shards, cam, num_first=16, num_second=0)
    finally:
        ba.shard_iteration = run
    def bound(kernel, p):
        n_terms = ba.schur_index_plain(p.obs_cam, p.obs_valid, p.lm_valid, p.lm_fixed,
                                       K).n_terms
        return _bound(*_ba_work(K, p.obs_cam.shape[0], D, n_obs=_valid_obs(p),
                                n_terms=n_terms)[kernel])["bound_ms"]
    psize = 33 * K + 1 + 36 * K * K
    w_blocks = sum(ba.f_blocks(K, p.obs_cam.shape[0]) for p in shards)
    per_iter = sum(bound("F", p) + bound("H", p) for p in shards) + len(shards) * (
        bound("G", shards[0]) + _bound((w_blocks + 1) * psize * 4.0,
                                       w_blocks * float(psize))["bound_ms"])
    plain_ms = _median_ms(lambda: ba.bundle_adjust_shards_plain(shards, cam, num_first=16,
                                                                num_second=0), reps=1, warmup=0)
    torch.cuda.synchronize()
    return dict(iterations=iters[0], bound_ms=iters[0] * per_iter, plain_ms=plain_ms,
                bound_terms="per iteration: F and H on every shard, W's reduce mode and G on "
                            "every replica (W's decide mode reads a few floats)")


def record_assoc_inputs(sample: int = 97):
    """Keep, by reference, the arguments of every `sample`-th call of kernel
    Q's scatter and dedup and of every chain rebase. The recorders replace
    the module names the callers look up; each original counts its launches
    by its own name, so its count lands on the recorder and `undo` moves it
    back. Returns (calls, undo)."""
    from stella_vslam_tpu_torch import tracking_module as tm
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    calls = {"scatter": [], "dedup": [], "rebase": []}
    seen = {"scatter": 0, "dedup": 0}
    orig = {"scatter": tk.scatter_to_current, "dedup": tk.dedup_by_id,
            "rebase": tm.rebase_chain}

    def recorder(kind):
        def rec(*args):
            n = seen.get(kind, 0)
            if kind == "rebase" or n % sample == 0:
                calls[kind].append(args)
            seen[kind] = n + 1
            return orig[kind](*args)
        rec.launches = 0
        return rec

    recs = {k: recorder(k) for k in orig}
    tk.scatter_to_current, tk.dedup_by_id = recs["scatter"], recs["dedup"]
    tm.rebase_chain = recs["rebase"]

    def undo():
        tk.scatter_to_current, tk.dedup_by_id = orig["scatter"], orig["dedup"]
        tm.rebase_chain = orig["rebase"]
        orig["scatter"].launches += recs["scatter"].launches
        orig["dedup"].launches += recs["dedup"].launches

    return calls, undo


def record_match_inputs(sample: int = 97):
    """Keep, by reference, the arguments of every `sample`-th window call
    of kernel C per stage (stage 1: the motion model's window, stage 3: the
    local map's, told apart by the table's 4096 rows) and of every
    `sample`-th brute-force call (stage 2). The recorder replaces
    `hamming.hamming_top2`, which the matchers look up by module; the
    original counts its launches by its own name, so the count lands on the
    recorder and `undo` moves it back. Returns (calls, undo)."""
    from stella_vslam_tpu_torch.match import hamming as H

    calls = {"stage1": [], "stage2": [], "stage3": []}
    seen = dict.fromkeys(calls, 0)
    orig = H.hamming_top2

    def rec(*args, **kw):
        stage = ("stage2" if kw.get("window") is None
                 else "stage3" if args[0].shape[0] == 4096 else "stage1")
        if seen[stage] % sample == sample // 2 and not isinstance(kw.get("orient"), H.AngleGate):
            calls[stage].append((args, kw))
        seen[stage] += 1
        return orig(*args, **kw)

    rec.launches = 0
    H.hamming_top2 = rec

    def undo():
        H.hamming_top2 = orig
        orig.launches += rec.launches

    return calls, undo


def record_window_rows_inputs(sample: int = 97):
    """Keep, by reference, the arguments of every `sample`-th call of kernel
    R's window rows per stage (the last frame's points; the table). The
    recorder replaces `camera.base.project_window_rows`, which the cascade
    looks up by module; the original counts its launches by its own name, so
    the count lands on the recorder and `undo` moves it back. Returns
    (calls, undo)."""
    from stella_vslam_tpu_torch.camera import base as cb

    calls = {"points": [], "table": []}
    seen = dict.fromkeys(calls, 0)
    orig = cb.project_window_rows

    def rec(p, R, t, pos, **kw):
        stage = "table" if kw.get("tbl_u32") is not None else "points"
        if seen[stage] % sample == sample // 2:
            calls[stage].append((p, R, t, pos, kw))
        seen[stage] += 1
        return orig(p, R, t, pos, **kw)

    rec.launches = 0
    cb.project_window_rows = rec

    def undo():
        cb.project_window_rows = orig
        orig.launches += rec.launches

    return calls, undo


def check_recorded_rows(calls, label):
    """Kernel R's window rows against plain on a slice's recorded calls
    (_check_rows_call's bounds), and the predicted octave of every table
    row equal to plain's, with no allowance at a ceil. Returns the largest
    relative error."""
    from stella_vslam_tpu_torch.camera import base as cb

    err, n_diff, n_near, n_rows, pred_diff = 0.0, 0, 0, 0, 0
    for recs in calls.values():
        for p, R, t, pos, kw in recs:
            e, d, n = _check_rows_call(p, R, t, pos, kw)
            err, n_diff, n_near = max(err, e), n_diff + d, n_near + n
            if kw.get("tbl_u32") is not None:
                k = cb.project_window_rows(p, R, t, pos, **kw)
                q = cb.project_window_rows_plain(p, R, t, pos, **kw)
                pred_diff += int((k.pred_scale != q.pred_scale).sum())
                n_rows += pos.shape[0]
    print(f"kernel R on the {label}'s recorded calls: "
          f"{json.dumps({k: len(v) for k, v in calls.items()})}, floats within {err:.3g} "
          f"relative, {n_diff} rows apart, {n_near} within 1e-6 of a threshold; predicted "
          f"octaves differing from plain {pred_diff} of {n_rows} table rows")
    assert all(calls.values()), f"kernel R: no recorded call of a stage on the {label}"
    assert pred_diff == 0, f"kernel R's predicted octave differs from plain on the {label}"
    return err


def octave_ceil_case(dev, sf: float = 1.2, num_levels: int = 8, ulps: int = 1500,
                     seed: int = 16):
    """Landmarks whose predicted octave sits at a ceil: on the optical axis
    of a camera at the origin, (0, 0, z) with z a power of two, so that the
    distance is z and dmax / dist a chosen float32 ratio: every float32
    ratio within `ulps` of sf^k, k = 1..L-1. Returns (pos [M,3], dmin,
    dmax) float32 tensors on dev."""
    import torch

    near = [np.arange(c - ulps, c + ulps, dtype=np.int32).view(np.float32)
            for c in (np.float32(sf ** k).view(np.int32) for k in range(1, num_levels))]
    r = np.concatenate(near)
    z = (np.float32(2.0) ** np.random.default_rng(seed).integers(0, 4, len(r))).astype(np.float32)
    pos = np.zeros((len(r), 3), np.float32)
    pos[:, 2] = z
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return f(pos), f(z / 2), f(r * z)


def check_octave_ceils(dev, tk, mk):
    """Kernels R and L against their plain versions where the predicted
    octave sits at a ceil (octave_ceil_case): R's table rows at the
    identity pose must give plain's octave on every row; L's chunk puts L
    keypoints at the landmarks' pixel, one a level, the highest level first
    and every descriptor the landmark's, so that the best index is the
    highest level the octave admits (pred + 1, clamped) and must equal
    plain's on every row. Returns the rows differing (0 required)."""
    import torch

    from stella_vslam_tpu_torch.camera import base as cb
    from stella_vslam_tpu_torch.module import mapping_kernels as mkm

    L = tk.orb.num_levels
    pos, dmin, dmax = octave_ceil_case(dev, tk.orb.scale_factor, L)
    M = pos.shape[0]
    normal = torch.zeros_like(pos)
    normal[:, 2] = 1.0
    tbl = torch.cat([pos, normal, dmin[:, None], dmax[:, None]], 1).contiguous()
    tu = torch.zeros((M, 10), dtype=torch.int32, device=dev)
    tu[:, 9] = 1
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    kw = dict(scale_factors=tk.scale_factors, margin=5.0, tbl_u32=tu, log_scale=tk.log_scale,
              num_levels=L)
    k = cb.project_window_rows(tk.camera.params, eye, zero, tbl, **kw)
    q = cb.project_window_rows_plain(tk.camera.params, eye, zero, tbl, **kw)
    r_diff = int((k.pred_scale != q.pred_scale).sum())
    p = mk.cam
    uv = torch.tensor([[p.cx, p.cy]] * L, dtype=torch.float32, device=dev)
    desc = torch.zeros((M, 8), dtype=torch.int32, device=dev)
    kfs = mkm.FuseKeyframes(
        uv[None].contiguous(), torch.arange(L - 1, -1, -1, dtype=torch.int32,
                                            device=dev)[None].contiguous(),
        torch.zeros((1, L, 8), dtype=torch.int32, device=dev),
        torch.ones((1, L), dtype=torch.bool, device=dev),
        torch.full((1, L), -1.0, device=dev))
    poses = torch.cat([eye.reshape(9), zero])[None].contiguous()
    lm_f = torch.cat([pos, dmin[:, None], dmax[:, None], normal], 1).contiguous()
    largs = (kfs, poses, torch.ones(1, dtype=torch.bool, device=dev), lm_f, desc,
             torch.ones(M, dtype=torch.bool, device=dev), mk.cam, mk.scale_factors,
             mk.level_sigma_sq, mk.log_scale, 3.0, mk.camera.model)
    lk, lp = mkm.fuse_scan(*largs), mkm.fuse_scan_plain(*largs)
    l_diff = int(((lk[0] != lp[0]) | (lk[1] != lp[1]) | (lk[2] != lp[2])).sum())
    pred = q.pred_scale.long()
    admitted = int((lp[1].long()[0] == (L - 1) - torch.clamp(pred + 1, max=L - 1)).sum())
    torch.cuda.synchronize()
    print(f"kernels R and L at octave ceils: {M} landmarks within 1500 ulps of "
          f"{tk.orb.scale_factor}^k, octaves {json.dumps(torch.bincount(pred).tolist())}; "
          f"R's octave differing from plain {r_diff}, L's rows {l_diff}; L's best index "
          f"the highest admitted level on {admitted} of {M}")
    assert admitted == M, "the octave-ceil chunk does not read L's octave from its index"
    assert r_diff == 0 and l_diff == 0, "kernel R or L rounds an octave ceil unlike plain"
    return r_diff + l_diff


def check_recorded_matches(calls):
    """Kernel C against its plain version on the threaded slice's own
    calls: rows differing (0 required), and each window call's visited
    pairs beside the dense count."""
    cases = [(f"threaded slice {stage} call {i}", a, kw)
             for stage, recs in calls.items() for i, (a, kw) in enumerate(recs)]
    differ = check_top2_cases(cases)
    print(f"kernel C on the threaded slice's recorded calls: "
          f"{json.dumps({k: len(v) for k, v in calls.items()})}, rows differing {differ}")
    assert differ == 0, "kernel C disagrees with its plain version on the slice's calls"
    return differ


class SyncProbe:
    """The synchronising CUDA calls the tracker's dispatch makes on frames
    [start, stop) of a run: torch's sync debug mode warns at each, and the
    warnings raised on the feeding thread inside TrackingModule._dispatch or
    _try_rebase_chain are counted by file:line."""

    def __init__(self, tracker, start: int, stop: int):
        import threading

        self.start, self.stop = start, stop
        self.local = threading.local()
        self.dispatches = 0
        self.sites = {}
        self.active = False
        self._cm = None
        for name in ("_dispatch", "_try_rebase_chain"):
            setattr(tracker, name, self._wrap(getattr(tracker, name), name == "_dispatch"))

    def _wrap(self, fn, counts):
        def probed(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            self.local.inside = True
            try:
                return fn(*args, **kw)
            finally:
                self.local.inside = False
                self.dispatches += counts
        return probed

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if getattr(self.local, "inside", False) and "synchroniz" in str(message):
            site = f"{os.path.relpath(filename, os.path.dirname(os.path.abspath(__file__)))}:{lineno}"
            self.sites[site] = self.sites.get(site, 0) + 1

    def on_frame(self, i: int):
        import warnings

        import torch

        if i == self.start:
            self._cm = warnings.catch_warnings()
            self._cm.__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            torch.cuda.set_sync_debug_mode("warn")
            self.active = True
        elif i == self.stop:
            self.close()

    def close(self):
        import torch

        if self._cm is not None:
            self.active = False
            torch.cuda.set_sync_debug_mode("default")
            self._cm.__exit__(None, None, None)
            self._cm = None

    def result(self) -> dict:
        total = sum(self.sites.values())
        return dict(frames=[self.start, self.stop], dispatches=self.dispatches,
                    syncs=total, per_dispatch=total / max(1, self.dispatches), sites=self.sites)


class _HeldEvent:
    """A frame's CUDA event whose `synchronize` also waits for `gate` (at
    most `hold_s`): the finalize thread sees the frame as still in flight."""

    def __init__(self, event, gate, hold_s: float):
        self.event, self.gate, self.hold_s = event, gate, hold_s

    def synchronize(self):
        self.gate.wait(self.hold_s)
        self.event.synchronize()


class InFlightPublish:
    """Frame `at` of a run stays in flight until the next feed has passed
    its table check (at most `hold_s`), as on a device that runs behind the
    host, and a table is published (the mapper's call) before that feed:
    its dispatch must rebase the chain on the device. On the H100 the
    finalize thread otherwise keeps up with the feed, so a publish of the
    slice rarely lands with a frame in flight."""

    def __init__(self, slam, at: int, hold_s: float = 1.0):
        import threading

        self.slam, self.at, self.hold_s = slam, at, hold_s
        self.in_flight_at_publish = None
        self._frame = -1
        self._gate = threading.Event()
        tr = slam.tracker
        dispatch, try_rebase = tr._dispatch, tr._try_rebase_chain

        def held(frm, snap=None):
            p = dispatch(frm, snap)
            if p is not None and p.event is not None and self._frame == self.at:
                p.event = _HeldEvent(p.event, self._gate, hold_s)
            return p

        def rebase(snap):
            try:
                return try_rebase(snap)
            finally:
                if self._frame == self.at + 1:
                    self._gate.set()

        tr._dispatch, tr._try_rebase_chain = held, rebase

    def on_frame(self, i: int):
        self._frame = i
        if i == self.at + 1:
            tr = self.slam.tracker
            self.in_flight_at_publish = len(tr._pending)
            self.slam.map_db.refresh_device_table(
                center_kf_id=tr.ref_keyfrm_id, max_local_keyframes=tr.max_num_local_keyfrms)
        elif i == self.at + 2:
            self._gate.set()


def run_threaded_slice(dev, world, wrappers, card):
    """The threaded slice (util/threaded_slice.py: the default System,
    pipelined, mapping and loop-closing threads, the bench's circuit fed as
    fast as the feed returns), every launch count at 0 just before it and
    read just after; kernel Q's inputs recorded and the dispatch's
    synchronising calls counted on frames 300-340; at frame 700 one frame is
    held in flight across a publish (InFlightPublish). Returns (statistics,
    launches, System, recorded Q inputs)."""
    from stella_vslam_tpu_torch.util import threaded_slice

    slam = threaded_slice.make_system(world, dev)
    calls, undo_assoc = record_assoc_inputs()
    match_calls, undo_match = record_match_inputs()
    row_calls, undo_rows = record_window_rows_inputs()
    probe = SyncProbe(slam.tracker, 300, 340)
    held = InFlightPublish(slam, 700)

    def on_frame(i):
        probe.on_frame(i)
        held.on_frame(i)

    for w in wrappers.values():
        w.launches = 0
    try:
        stats = threaded_slice.run_slice(dev, world, slam=slam, on_frame=on_frame)
    finally:
        probe.close()
        undo_assoc()
        undo_match()
        undo_rows()
    launches = {k: w.launches for k, w in wrappers.items()}
    calls["match"] = match_calls
    calls["rows"] = row_calls
    stats["launches"] = launches
    stats["sync_per_dispatch"] = probe.result()
    stats["forced_in_flight_publish"] = dict(frame=held.at,
                                             frames_in_flight=held.in_flight_at_publish)
    with open(os.path.join(OUT_DIR, "threaded_slice.json"), "w") as f:
        json.dump(dict(stats, card=card), f, indent=1)
    brief = {k: v for k, v in stats.items() if k not in ("loop_event_ms", "launches")}
    print("threaded slice: " + json.dumps(dict(brief, card=card)))
    print("threaded slice launches: " + json.dumps(launches))
    print("threaded slice loop events (ms, by phase, on the loop-closing threads): "
          + json.dumps(stats["loop_event_ms"]))
    # the cascade solves stages 2 and 1 in one launch of D and stage 3 in a
    # second; the loop detector's validations add their own
    d_per_frame = launches["pose_lm"] / stats["frames"]
    print(f"threaded slice: kernel D {launches['pose_lm']} launches over {stats['frames']} "
          f"frames ({d_per_frame:.3f} a frame, the loop detector's included); kernel C "
          f"{launches['hamming_top2']} launches, its cell index {launches['cell_index']}")
    assert d_per_frame <= 2.2, "the cascade launches kernel D more than twice a frame"
    sp = stats["sync_per_dispatch"]
    print(f"threaded slice dispatch: {sp['syncs']} synchronising calls in {sp['dispatches']} "
          f"steady dispatches (frames {sp['frames'][0]}-{sp['frames'][1]}), "
          f"{sp['per_dispatch']:.3f} per dispatch, sites {json.dumps(sp['sites'])}")
    print(f"threaded slice: keyframes created {stats['keyframes_created']} (limit 25; bench.py "
          f"asks 50 of the TPU threaded run), kept {stats['keyframes_kept']} (limit 10; bench.py "
          f"20); local-BA skips {stats['local_ba_skips']} of {stats['ba_opportunities']}; "
          f"rebases {stats['rebases']} (of {stats['publishes']} publishes; one forced at frame "
          f"{held.at} with {held.in_flight_at_publish} frame(s) in flight), drain fallbacks "
          f"{stats['drain_fallbacks']}; worker errors "
          f"{stats['worker_errors']}")
    for e in slam.worker_error_log:
        print("worker error:\n" + e)
    assert stats["worker_errors"] == 0, "a worker thread contained an exception"
    assert stats["lost_after_init"] <= 8, f"{stats['lost_after_init']} frames lost"
    assert stats["loops_closed"] >= 1, "no loop was closed"
    assert stats["ate_m"] < 0.10, f"Sim3 ATE over the circuit {stats['ate_m']:.4f} m"
    assert stats["ba_opportunities"] > 0 and \
        stats["local_ba_skips"] <= 0.2 * stats["ba_opportunities"], "sustained local-BA skips"
    assert stats["keyframes_created"] >= 25, f"{stats['keyframes_created']} keyframes created"
    assert stats["keyframes_kept"] >= 10, f"{stats['keyframes_kept']} keyframes kept"
    st = stats["stranded"]
    assert not st["staged_event"] and st["queued"] == 0 and not st["pending_ba"] \
        and st["loop_queue"] == 0, f"work left at shutdown: {st}"
    for name, n in launches.items():
        assert n > 0 or name in STEREO_KERNELS + EQUIRECT_KERNELS + SHARDED_KERNELS, \
            f"{name} was not launched by the threaded slice"
    # kernel S: one launch a frame, the pyramid's every level (A's launches)
    assert launches["resize_pyramid"] == launches["fast_nms_pyramid"], \
        "kernel S: not one launch a frame on the threaded slice"
    return stats, launches, slam, calls


def check_recorded_assoc(calls):
    """Kernel Q against its plain version on the threaded slice's own
    inputs: the sampled scatters and dedups and every rebase."""
    err = 0.0
    for kind in ("scatter", "dedup", "rebase"):
        for args in calls[kind]:
            err = max(err, _check_assoc_call(kind, args))
    n = {k: len(calls[k]) for k in ("scatter", "dedup", "rebase")}
    print(f"kernel Q on the threaded slice's inputs: {json.dumps(n)} calls (every rebase that "
          f"ran), ints exact, poses within {err:.3g}")
    return err



def _stereo_inputs(dev, ex, world, x=0.6):
    """A rendered stereo pair of the bench's world through the pair
    extraction: (the matcher's positional arguments, its keywords)."""
    import torch

    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.stereo_slice import BASELINE

    T = pose_at_xy(x, 0.0)
    Tb = np.eye(4)
    Tb[0, 3] = -BASELINE
    left = torch.from_numpy(world.render(T)).to(dev)
    right = torch.from_numpy(world.render(Tb @ T)).to(dev)
    (fl, sl), (fr, sr) = ex.extract_pair_with_patches(left, right)
    fxb = float(np.float32(world.fx * BASELINE))
    kw = dict(scale_factors=torch.tensor(ex.params.scale_factors, dtype=torch.float32,
                                         device=dev),
              focal_x_baseline=fxb, true_baseline=fxb / float(np.float32(world.fx)),
              layout=ex.slot_layout)
    return (fl.xy, fl.level, fl.desc, fl.valid, sl, fr.xy, fr.level, fr.desc, fr.valid, sr), kw


def grid_layout(dev, n: int, width: int = 400, height: int = 300, num_levels: int = 3):
    """(levels, SlotLayout) of n slots over a width x height image: up to
    num_levels levels (scale 1.2 each) of about half, a third and a sixth
    of the slots, each level's grid the factor pair of its count nearest to
    the image's aspect, its cell size as level_geometry sizes one (so the
    last cell row or column may reach past the level and clamp)."""
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_pattern import EDGE_BORDER as b

    shares = [0.5, 1 / 3, 1 / 6][:num_levels]
    counts = [max(1, int(round(n * f))) for f in shares[1:]]
    counts = [n - sum(counts)] + counts if n > sum(counts) else [n]
    levels = []
    for l, c in enumerate(counts):
        s = 1.2 ** l
        W, H = int(round(width / s)), int(round(height / s))
        gx = min((d for d in range(1, c + 1) if c % d == 0),
                 key=lambda d: abs(d / (c // d) - W / H))
        gy = c // gx
        cs = int(math.ceil(max((W - 2 * b) / gx, (H - 2 * b) / gy)))
        levels.append(ox._LevelGeom(H, W, cs, gy, gx, s))
    return levels, ox.slot_layout(levels, b, dev)


def bench_layout(dev):
    """(levels, SlotLayout) of the bench's extractor: 752x480, 8 levels,
    min_size 800 (2872 slots)."""
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.feature.orb_pattern import EDGE_BORDER

    levels = ox.level_geometry(OrbParams(num_levels=8), 752, 480, 800, EDGE_BORDER)
    return levels, ox.slot_layout(levels, EDGE_BORDER, dev)


def cell_pixel(border: int, cs: int, size: int, c, off):
    """The level pixel at offset `off` (0 <= off < cs) in cell c of a cell
    row or column (numpy arrays or ints), clamped into a level `size` pixels
    tall or wide: where an extractor places a slot's keypoint
    (cell_keypoints), and where a cell's interval ends (off 0 and cs - 1)."""
    return np.minimum(border + np.asarray(c) * cs + off, size - 1)


def layout_slots(rng, levels, border: int):
    """Per slot of `levels` (_LevelGeom each, in slot order): level pixel
    (px, py) at a random offset in its cell (cell_pixel), and the slot's
    level. Returns (px, py, level, scale) as numpy arrays."""
    px, py, lv, sc = [], [], [], []
    for l, g in enumerate(levels):
        k = np.arange(g.Gy * g.Gx)
        px.append(cell_pixel(border, g.cs, g.W, k % g.Gx, rng.integers(0, g.cs, k.size)))
        py.append(cell_pixel(border, g.cs, g.H, k // g.Gx, rng.integers(0, g.cs, k.size)))
        lv.append(np.full(k.size, l))
        sc.append(np.full(k.size, np.float32(g.scale)))
    return tuple(np.concatenate(a) for a in (px, py, lv, sc))


def _cell_ends(layout, l: int, dev):
    """Level l's cell rows' and cell columns' level-0 intervals, ((ylo,
    yhi) [Gy], (xlo, xhi) [Gx]) f32: a cell's first and last pixel row
    (column), clamped into the level, times the level's f32 scale, as kernel
    T computes them."""
    import torch

    g, s = layout.levels[l], layout.level_scale[l].to(dev)
    ends = lambda n, size: tuple(
        torch.as_tensor(cell_pixel(layout.border, g.cs, size, np.arange(n), off),
                        dtype=torch.float32, device=dev) * s for off in (0, g.cs - 1))
    return ends(g.Gy, g.H), ends(g.Gx, g.W)


def slot_cells(layout, dev):
    """Each slot's cell, [num_slots, 4] f32 (ylo, yhi, xlo, xhi) in level-0
    pixels: where the layout places the slot's keypoint."""
    import torch

    out = []
    for l, g in enumerate(layout.levels):
        (ylo, yhi), (xlo, xhi) = _cell_ends(layout, l, dev)
        k = torch.arange(g.Gy * g.Gx, device=dev)
        out.append(torch.stack([ylo[k // g.Gx], yhi[k // g.Gx], xlo[k % g.Gx], xhi[k % g.Gx]],
                               dim=1))
    return torch.cat(out)


def _span(ok):
    """[NL, n] bool -> the first and last set position of each row (first
    > last where none is)."""
    import torch

    idx = torch.arange(ok.shape[1], device=ok.device)
    return torch.where(ok, idx, ok.shape[1]).amin(dim=1), torch.where(ok, idx, -1).amax(dim=1)


def band_cells_plain(l_xy, l_level, l_valid, layout, scale_factors, max_disp: float):
    """Kernel T's band walk in torch: for each left keypoint and each level
    of `layout` (a SlotLayout), the cell rows [r0, r1] and columns [c0, c1]
    it visits, as int64 [NL, L, 4] (r0, r1, c0, c1); (0, -1, 0, -1) where it
    visits none. A left keypoint visits the levels within one of its own
    when it is valid; there, the cell rows whose y interval (_cell_ends)
    passes the row-band gate at its ends, and the cell columns whose x
    interval passes the disparity gate at its ends. The gates are monotone
    in the right keypoint's coordinate, so every pair the dense gate admits
    lies in a visited cell."""
    import torch

    dev = l_xy.device
    lx, ly = l_xy[:, 0, None], l_xy[:, 1, None]
    out = []
    for l in range(len(layout.levels)):
        band = 2.0 * scale_factors[l].to(dev)
        (ylo, yhi), (xlo, xhi) = _cell_ends(layout, l, dev)
        reach = l_valid & ((l_level - l).abs() <= 1)
        r0, r1 = _span(((ylo[None] - ly) <= band) & ((yhi[None] - ly) >= -band))
        c0, c1 = _span(((lx - xlo[None]) >= 0.0) & ((lx - xhi[None]) < max_disp))
        rng = torch.stack([r0, r1, c0, c1], dim=1)
        visit = reach & (r0 <= r1) & (c0 <= c1)
        out.append(torch.where(visit[:, None], rng, torch.tensor([0, -1, 0, -1], device=dev)))
    return torch.stack(out, dim=1)


def band_visited(cells, layout):
    """band_cells_plain's rectangles -> [NL, num_slots] bool, the slots each
    left keypoint visits."""
    import torch

    parts = []
    for l, g in enumerate(layout.levels):
        k = torch.arange(g.Gy * g.Gx, device=cells.device)
        cy, cx = (k // g.Gx)[None], (k % g.Gx)[None]
        r0, r1, c0, c1 = (cells[:, l, q, None] for q in range(4))
        parts.append((cy >= r0) & (cy <= r1) & (cx >= c0) & (cx <= c1))
    return torch.cat(parts, dim=1)


def band_pairs(cells) -> int:
    """The pairs band_cells_plain's rectangles hold: what kernel T visits."""
    r0, r1, c0, c1 = cells.unbind(-1)
    return int(((r1 - r0 + 1).clamp(min=0) * (c1 - c0 + 1).clamp(min=0)).sum())


def stereo_layout_case(dev, l_levels, r_levels, border: int, seed: int, max_shift=60.0,
                       scale_factors=None):
    """Matcher inputs whose keypoints lie in the slots of two layouts (the
    left image's l_levels, the right's r_levels): every slot at a random
    place in its cell, as an extractor places it. Most left keypoints get a
    true match on the right: the right slot whose cell holds the point
    0-max_shift px to the left, within 1.5 px of the row, at a level within
    one (a few flipped bits, the strip shifted by -5..5 px). Up to 100
    matched right slots get an equal descriptor in the next cell of their
    row (tied distances: the lowest index wins); right slots below 85% of
    the image are invalid (the left rows there have empty bands); 5% of
    both sides invalid. Returns (the matcher's positional arguments, its
    keywords)."""
    import torch

    from stella_vslam_tpu_torch.feature.orb_params import OrbParams

    rng = np.random.default_rng(seed)
    lpx, lpy, l_lvl, l_sc = layout_slots(rng, l_levels, border)
    rpx, rpy, r_lvl, r_sc = layout_slots(rng, r_levels, border)
    NL, NR = lpx.size, rpx.size
    l_xy = np.stack([lpx.astype(np.float32) * l_sc, lpy.astype(np.float32) * l_sc], -1)
    l_desc = rng.integers(0, 2 ** 32, (NL, 8), dtype=np.uint64).astype(np.uint32)
    l_strip = rng.integers(0, 256, (NL, 11, 21))
    r_desc = rng.integers(0, 2 ** 32, (NR, 8), dtype=np.uint64).astype(np.uint32)
    r_strip = rng.integers(0, 256, (NR, 11, 21))
    first = np.cumsum([0] + [g.Gy * g.Gx for g in r_levels])
    L = len(r_levels)
    taken = np.zeros(NR, bool)
    matched = []
    for i in rng.permutation(NL):
        rl = int(np.clip(l_lvl[i] + rng.integers(-1, 2), 0, L - 1))
        g = r_levels[rl]
        x = l_xy[i, 0] - rng.uniform(0, max_shift)
        y = l_xy[i, 1] + rng.uniform(-1.5, 1.5)
        qx, qy = int(round(x / g.scale)), int(round(y / g.scale))
        cx, cy = (qx - border) // g.cs, (qy - border) // g.cs
        if not (0 <= cx < g.Gx and 0 <= cy < g.Gy and qx < g.W and qy < g.H):
            continue
        j = first[rl] + cy * g.Gx + cx
        if taken[j]:
            continue
        taken[j] = True
        rpx[j], rpy[j] = qx, qy
        flips = np.bitwise_and.reduce(
            rng.integers(0, 2 ** 32, (3, 8), dtype=np.uint64).astype(np.uint32), axis=0)
        r_desc[j] = l_desc[i] ^ flips
        r_strip[j] = np.clip(np.roll(l_strip[i], int(rng.integers(-5, 6)), axis=1)
                             + rng.integers(-3, 4, (11, 21)), 0, 255)
        matched.append(j)
    ties = 0
    for j in matched:
        l = int(np.searchsorted(first, j, side="right") - 1)
        k = j - first[l]
        if ties < 100 and k % r_levels[l].Gx + 1 < r_levels[l].Gx and not taken[j + 1]:
            taken[j + 1] = True
            r_desc[j + 1] = r_desc[j]
            rpy[j + 1] = rpy[j]  # the same pixel row, the next cell
            ties += 1
    r_xy = np.stack([rpx.astype(np.float32) * r_sc, rpy.astype(np.float32) * r_sc], -1)
    height = max(g.H * g.scale for g in r_levels)
    r_valid = (rng.random(NR) < 0.95) & (r_xy[:, 1] < 0.85 * height)
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a).astype(dt), device=dev)
    fxb = float(np.float32(458.0 * 0.12))
    sf = scale_factors if scale_factors is not None else OrbParams(num_levels=L).scale_factors
    kw = dict(scale_factors=t(sf, np.float32), focal_x_baseline=fxb, true_baseline=fxb / 458.0)
    args = (t(l_xy, np.float32), t(l_lvl, np.int32), t(l_desc.view(np.int32), np.int32),
            t(rng.random(NL) < 0.95, bool), t(l_strip, np.uint8), t(r_xy, np.float32),
            t(r_lvl, np.int32), t(r_desc.view(np.int32), np.int32), t(r_valid, bool),
            t(r_strip, np.uint8))
    return args, kw


def _synthetic_stereo(dev, seed=5):
    """Matcher inputs at the slice's width: both images' 2872 slots in the
    bench extractor's layout (stereo_layout_case: true matches 0-60 px
    apart, ties, empty rows). Returns (args, keywords with the layout)."""
    from stella_vslam_tpu_torch.feature.orb_pattern import EDGE_BORDER

    levels, layout = bench_layout(dev)
    args, kw = stereo_layout_case(dev, levels, levels, EDGE_BORDER, seed)
    return args, dict(kw, layout=layout)


def _check_stereo_call(args, kw, label, verbose=True):
    """Kernel T against its plain version on one call: one launch; matched
    flags equal except where the deciding quantity sits at its threshold (a
    disparity within 1e-3 of 0 or of max_disp, a SAD within 1e-3 of twice
    the mean; counted); x_right and depth within 1e-5 relative; every pair
    the dense gate admits inside the band walk's cells (band_cells_plain).
    Returns (rows differing, the largest relative error, matched rows,
    candidate pairs, pairs the walk visits, rows that reach the SAD step:
    valid, with a candidate under the Hamming threshold)."""
    import torch

    from stella_vslam_tpu_torch.match import stereo as st

    before = st.stereo_match.launches
    xk, dk = st.stereo_match(*args, **kw)
    assert st.stereo_match.launches == before + 1, "kernel T: one launch a call"
    plain_kw = {k: v for k, v in kw.items() if k != "layout"}
    xp, dp = st.stereo_match_plain(*args, **plain_kw)
    pre, sad, disp = st.stereo_refine_plain(*args, **plain_kw)
    torch.cuda.synchronize()
    mk, mp = dk > 0, dp > 0
    differ = mk != mp
    max_disp = st.max_disparity(kw["focal_x_baseline"], kw["true_baseline"])
    two_mean = 2.0 * float(st.filter_mean(pre, sad))
    at_thr = differ & (((disp - max_disp).abs() < 1e-3) | (disp.abs() < 1e-3)
                       | ((sad.float() - two_mean).abs() < 1e-3))
    both = mk & mp
    rel = lambda a, b: float(((a - b).abs() / b.abs().clamp(min=1e-6))[both].max()) \
        if bool(both.any()) else 0.0
    err = max(rel(xk, xp), rel(dk, dp))
    l_xy, l_lvl, l_valid, r_xy, r_lvl, r_valid = args[0], args[1], args[3], args[5], \
        args[6], args[8]
    d = l_xy[:, None, 0] - r_xy[None, :, 0]
    cand = ((r_xy[None, :, 1] - l_xy[:, None, 1]).abs()
            <= 2.0 * kw["scale_factors"][r_lvl.long()][None]) \
        & (d >= 0) & (d < max_disp) & ((l_lvl[:, None] - r_lvl[None]).abs() <= 1) \
        & l_valid[:, None] & r_valid[None]
    cells = band_cells_plain(l_xy, l_lvl, l_valid, kw["layout"], kw["scale_factors"],
                             max_disp)
    dist = torch.where(cand, st.pairwise_hamming(args[2], args[7]), st.MAX_HAMMING_DIST + 1)
    thr = (st.HAMMING_DIST_THR_LOW + st.HAMMING_DIST_THR_HIGH) / 2
    sad_rows = int(((dist.amin(dim=1) < thr) & l_valid).sum())
    outside = int((cand & ~band_visited(cells, kw["layout"])).sum())
    n_diff, n_thr = int(differ.sum()), int(at_thr.sum())
    if verbose:
        print(f"kernel T stereo_match {label}: {int(mk.sum())} matched (plain {int(mp.sum())}), "
              f"flags differing {n_diff} ({n_thr} at a threshold), x_right / depth max rel "
              f"err {err:.3g}, candidate pairs {int(cand.sum())}, pairs visited "
              f"{band_pairs(cells)} (of {l_xy.shape[0] * r_xy.shape[0]}), "
              f"candidates outside the walk {outside}, rows at the SAD step {sad_rows}")
    assert outside == 0, f"kernel T's band walk misses admitted pairs ({label})"
    assert n_diff == n_thr, f"kernel T disagrees with plain off a threshold ({label})"
    assert err <= 1e-5, f"kernel T x_right / depth disagree ({label})"
    return n_diff, err, int(mk.sum()), int(cand.sum()), band_pairs(cells), sad_rows


def pyramid_cases(dev, ex, pair):
    """Kernel S's shapes: (label, extractor, images [B, H, W] on dev) for a
    752x480 bench frame and the stereo pair (8 levels), the pair as f32 with
    fractional values (the rectifier's dtype), the equirectangular leg's
    640x320 frame (6 levels), a 1280x720 frame (8 levels) and a seeded
    1920x960 u8 image at 6 levels (the equirectangular camera kernel Q's
    12839 slots come from)."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.util import equirect_slice as es
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.synthetic import equirect_circle

    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    g = np.random.default_rng(15)
    ee = ox.OrbExtractor(OrbParams(num_levels=6), 640, 320, min_area=800, device=dev)
    hw = hd_world()
    eh = ox.OrbExtractor(OrbParams(num_levels=8), hw.W, hw.H, min_area=800, device=dev)
    e19 = ox.OrbExtractor(OrbParams(num_levels=6), 1920, 960, min_area=800, device=dev)
    frac = pair.to(torch.float32) + up(g.random(tuple(pair.shape), np.float32))
    return [("752x480, 8 levels", ex, pair[:1]), ("stereo pair 2 x 752x480", ex, pair),
            ("stereo pair, f32 input", ex, frac.contiguous()),
            ("equirect 640x320, 6 levels", ee,
             up(es.bench_world().render(equirect_circle(250)[0][0])[None])),
            ("1280x720, 8 levels", eh, up(hw.render(pose_at_xy(0.6, 0.0))[None])),
            ("1920x960, 6 levels", e19, up(g.integers(0, 256, (1, 960, 1920), np.uint8)))]


def _pyramid_bytes(ex, images) -> float:
    """Kernel S's bytes: level 0 read once in its dtype, every level written
    once as f32."""
    B, H0, W0 = images.shape
    return B * (H0 * W0 * images.element_size() + 4.0 * ex.pyramid_size)


def check_pyramid_kernel(dev, ex, ex_cpu, imgs, pair) -> dict:
    """Kernel S against its two-tap plain version (resize_level_taps_plain
    on the CPU) at every shape of pyramid_cases, bit for bit, one launch a
    call, with the pixels its tiles' halos compute twice; on the stereo
    pair also against the two torch.matmul per level on the card (cuBLAS)
    and on the CPU, and kernel A's cell keys on its levels against the
    cuBLAS pyramid's. Returns S's row (timed on the pair)."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox

    shapes = {}
    for label, e, images in pyramid_cases(dev, ex, pair):
        before = ox.resize_pyramid.launches
        pyr = e.pyramid_flat(images)
        torch.cuda.synchronize()
        assert ox.resize_pyramid.launches == before + 1, "kernel S: one launch a call"
        pyr = pyr.cpu()
        n_diff = 0
        for b in range(images.shape[0]):
            want = torch.cat([x.reshape(-1) for x in e.pyramid_taps_plain(images[b].cpu())])
            n_diff += int((pyr[b] != want).sum())
        lvl_px = sum(g.H * g.W for g in e.levels[1:])
        plan = e.pyramid_plan_for(images.shape[0])
        shapes[label] = dict(
            pixels=images.shape[0] * e.pyramid_size, pixels_differing=n_diff,
            pixels_computed_twice=images.shape[0] * (plan.computed - lvl_px),
            tile=plan.tile, block=f"32x{plan.block_rows}",
            blocks=images.shape[0] * plan.rows.shape[0] * plan.cols.shape[0],
            smem_bytes=plan.smem_bytes,
            ms=_device_ms(lambda: e.pyramid_flat(images)),
            bound_ms=_bound(_pyramid_bytes(e, images), 0.0)["bound_ms"])
        print(f"kernel S resize_pyramid {label}: {n_diff} of {shapes[label]['pixels']} pixels "
              f"differ from the two-tap plain; {shapes[label]['pixels_computed_twice']} "
              f"pixels computed twice (halos), {shapes[label]['blocks']} blocks of "
              f"{shapes[label]['block']} (tile {plan.tile}), "
              f"{shapes[label]['ms']:.5f} ms device (bound {shapes[label]['bound_ms']:.5f})")
        assert n_diff == 0, f"kernel S disagrees with its two-tap plain version ({label})"
    # against the matmul pyramids, and kernel A's keys, on the stereo pair
    params = ex.params
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    n_px = n_diff = n_cpu_diff = keys = keys_moved = 0
    max_diff = 0.0
    for img in imgs:
        pk, pp = ex.pyramid(img), ex.pyramid_plain(img)
        pc = ex_cpu.pyramid_plain(img.cpu())
        for lvl, (a, b, c, g) in enumerate(zip(pk, pp, pc, ex.levels)):
            if lvl:
                n_px += a.numel()
                n_diff += int((a != b).sum())
                n_cpu_diff += int((a.cpu() != c).sum())
                max_diff = max(max_diff, float((a - b).abs().max()))
            ka = ox.fast_nms(a.contiguous(), g, ex.border, *thr)
            kb = ox.fast_nms(b.contiguous(), g, ex.border, *thr)
            keys += ka.numel()
            keys_moved += int((ka != kb).sum())
    torch.cuda.synchronize()
    print(f"kernel S resize_pyramid: levels 1-7 of 2 frames, {n_px} pixels: {n_diff} "
          f"({n_diff / n_px:.4%}) differ from cuBLAS's matmul, max |diff| {max_diff:.3g}; "
          f"{n_cpu_diff} differ from the CPU's matmul; kernel A's cell keys moved "
          f"{keys_moved} of {keys} ({keys_moved / keys:.4%})")
    assert max_diff <= 1e-4, "kernel S disagrees with the matmul pyramid"
    assert keys_moved <= 0.005 * keys, "kernel S moves kernel A's keys"
    plain_pair = lambda: [ex.pyramid_plain(i) for i in imgs]
    plain_ms = _median_ms(plain_pair)
    pair_case = shapes["stereo pair 2 x 752x480"]
    return dict(
        name="resize_pyramid", route="cuda", source="stella_vslam_tpu_torch/csrc/resize.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:118",
        max_abs_err=0.0, max_abs_err_cublas=max_diff, pixels_differing_cublas=n_diff,
        pixels=n_px, pixels_differing_cpu_matmul=n_cpu_diff, fast_keys_moved=keys_moved,
        fast_keys=keys, pixels_computed_twice=pair_case["pixels_computed_twice"],
        shape="2 x 752x480, 8 levels (the stereo pair), one launch for every level of both",
        shapes=shapes, **_times(lambda: ex.pyramid_flat(pair)),
        ms_one_image=_device_ms(lambda: ex.pyramid_flat(pair[:1])),
        one_call_ms_one_image=_median_ms(lambda: ex.pyramid_flat(pair[:1])),
        plain_ms=plain_ms, library_ms=_device_ms(plain_pair), library_one_call_ms=plain_ms,
        library_call="two torch.matmul a level (the plain pyramid)",
        **_bound(_pyramid_bytes(ex, pair),
                 2 * 6.0 * sum(g.H * g.W for g in ex.levels[1:])))


def check_stereo_kernels(dev, world):
    """Kernel S (the pyramid resize), B's strip mode and kernel T (the
    stereo matcher) against their plain versions at the stereo leg's
    shapes, and kernel O in its fixed-scale mode (the stereo and RGBD loop
    path). Returns rows of the kernels line."""
    import torch

    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import stereo as st
    from stella_vslam_tpu_torch.util.drift import pose_at_xy

    rows = []
    params = OrbParams(num_levels=8)
    ex = ox.OrbExtractor(params, 752, 480, min_area=800, device=dev)
    ex_cpu = ox.OrbExtractor(params, 752, 480, min_area=800, device="cpu")
    imgs = [torch.from_numpy(world.render(pose_at_xy(x, 0.0))).to(dev) for x in (0.6, 3.0)]
    pair = torch.stack(imgs)

    # ---- S: the whole pyramid in one launch, at every shape ----
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    rows.append(check_pyramid_kernel(dev, ex, ex_cpu, imgs, pair))

    # ---- B's strip mode: both images of a pair ----
    pyr = ex.pyramid_flat(pair)
    _, px, py, valid, _ = ox.fast_nms_pyramid(pyr, ex._fast, *thr)
    base, hh, ww = ex._slots(2)
    bargs = (pyr.reshape(-1), base, hh, ww, px.reshape(-1), py.reshape(-1), valid.reshape(-1),
             ex._tables)
    ak, dk, sk = ox.orb_describe_strips(*bargs)
    ap, dp, sp = ox.orb_describe_plain(*bargs, strips=True)
    torch.cuda.synchronize()
    v = bargs[6]
    strips_equal = bool(torch.equal(sk[v], sp[v]))
    x = (dk ^ dp)[v].cpu().numpy()
    bit_rate = float(np.unpackbits(x.view(np.uint8)).sum()) / max(1, x.size * 32)
    err_b = float((ak - ap).abs().max())
    print(f"kernel B orb_describe_strips: {int(v.sum())} keypoints of a pair, strips equal "
          f"{strips_equal}, descriptor bit mismatch {bit_rate:.6f}, max |angle diff| {err_b:.3g}")
    assert strips_equal, "kernel B's strips disagree with plain"
    assert bit_rate <= DESC_MISMATCH_BOUND and err_b < 1e-3, "kernel B disagrees"
    rows.append(dict(
        name="orb_describe_strips", route="cuda",
        source="stella_vslam_tpu_torch/csrc/orb_describe.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:284-296 (extract_with_patches)",
        max_abs_err=err_b, strips_equal=strips_equal, desc_bit_mismatch=bit_rate,
        shape="2 x 2872 slots",
        **_times(lambda: ox.orb_describe_strips(*bargs)),
        plain_ms=_median_ms(lambda: ox.orb_describe_plain(*bargs, strips=True), reps=5),
        library_ms=None,
        **_bound(4.0 * pyr.numel() + (36.0 + 231.0) * bargs[1].numel(),
                 _describe_ops(ak, v, ex._tables, strips=True))))

    # ---- T: the stereo matcher, synthetic and on a rendered pair ----
    ta, tkw = _synthetic_stereo(dev)
    n_diff_t, err_t, n_match, n_cand, _, _ = _check_stereo_call(ta, tkw,
                                                                "synthetic 2872 x 2872")
    ra, rkw = _stereo_inputs(dev, ex, world)
    d2, e2, m2, c2, v2, r2 = _check_stereo_call(ra, rkw, "rendered pair")
    n = ra[0].shape[0]
    plain_kw = {k: v for k, v in rkw.items() if k != "layout"}
    # each input byte the function needs read once: per keypoint xy, level,
    # descriptor and flag on both sides, the left strip and the best match's
    # strip of each row that reaches the SAD step (no other strip is read),
    # x_right and depth out; operations: ~6 gate operations a visited pair
    # (all pairs before the band walk), 8 XOR + 8 popc a candidate, 11 x 121
    # x 3 SAD operations a row that reaches the SAD step
    t_bytes = 2 * n * (8 + 4 + 32 + 1.0) + 2 * 231.0 * r2 + 8.0 * n
    t_ops = 16.0 * c2 + r2 * 11 * 121 * 3.0
    rows.append(dict(
        name="stereo_match", route="cuda", source="stella_vslam_tpu_torch/csrc/stereo_match.cu",
        replaces="stella_vslam_tpu/match/stereo.py:32", max_abs_err=max(err_t, e2),
        flags_differing=n_diff_t + d2, shape=f"{n} x {n} (rendered pair)",
        matched=m2, sad_rows=r2, candidate_pairs=c2, pairs_visited=v2,
        bound_ms_all_pairs=_bound(t_bytes, 6.0 * n * n + t_ops)["bound_ms"],
        **_times(lambda: st.stereo_match(*ra, **rkw)),
        plain_ms=_median_ms(lambda: st.stereo_match_plain(*ra, **plain_kw), reps=5),
        library_ms=None, **_bound(t_bytes, 6.0 * v2 + t_ops)))

    # ---- O in its fixed-scale mode (stereo and RGBD loop closure) ----
    err_o = _check_transform(_transform_problem(dev, 74, 7), {"fix_scale": True}, "fixed scale")
    print(f"kernel O fixed-scale mode against plain: max |s, R, t diff| {err_o:.3g}")
    return rows


def record_stereo_inputs(sample: int = 20):
    """Keep, by reference, the arguments of every `sample`-th stereo match
    of the System (the name `system.stereo_match` the stereo frame looks
    up); the matcher counts its launches on its own name. Returns (calls,
    undo)."""
    from stella_vslam_tpu_torch import system as system_mod

    calls, seen = [], [0]
    orig = system_mod.stereo_match

    def rec(*args, **kw):
        if seen[0] % sample == 0:
            calls.append((args, kw))
        seen[0] += 1
        return orig(*args, **kw)

    system_mod.stereo_match = rec

    def undo():
        system_mod.stereo_match = orig

    return calls, undo


# what the stereo leg and the RGBD leg with mapping launch
LEG_KERNELS = ("resize_pyramid", "fast_nms_pyramid", "hamming_top2", "cell_index", "pose_lm",
               "scatter_to_current", "dedup_by_id", "project_window_rows", "frame_finish",
               "epipolar_top2", "epipolar_band_index", "triangulate", "fuse", "fuse_cell_index",
               "ba_linearize_schur", "schur_index", "ba_reduced_solve", "ba_backsub_cost",
               "ba_classify", "fbow_transform")


def run_stereo_legs(dev, world, wrappers, card):
    """bench.py's stereo leg and its RGBD leg with mapping (util/
    stereo_slice.py: the default threaded System, 640 frames each), every
    launch count at 0 just before each and read just after, with the bench's
    gates; then kernel T against plain on a sample of the stereo leg's own
    calls. Returns ({leg: stats}, {leg: launches})."""
    import torch

    from stella_vslam_tpu_torch.util import stereo_slice

    stats, launches = {}, {}
    for setup in ("stereo", "RGBD"):
        calls, undo = record_stereo_inputs() if setup == "stereo" else ([], lambda: None)
        row_calls, undo_rows = record_window_rows_inputs(sample=61) if setup == "stereo" \
            else ({}, lambda: None)
        slam = stereo_slice.make_system(world, dev, setup)
        for w in wrappers.values():
            w.launches = 0
        try:
            s = stereo_slice.run_leg(dev, world, setup, slam=slam)
        finally:
            undo()
            undo_rows()
        launches[setup] = {k: w.launches for k, w in wrappers.items()}
        stats[setup] = s
        with open(os.path.join(OUT_DIR, f"{setup.lower()}_leg.json"), "w") as f:
            json.dump(dict(s, card=card), f, indent=1)
        print(f"{setup} leg: " + json.dumps(dict(
            {k: v for k, v in s.items() if k != "launches"}, card=card)))
        print(f"{setup} leg launches: " + json.dumps(launches[setup]))
        for e in slam.worker_error_log:
            print("worker error:\n" + e)
        stereo_slice.check_gates(s)
        own = STEREO_KERNELS if setup == "stereo" else ("orb_describe",)
        for name in LEG_KERNELS + own:
            assert launches[setup][name] > 0, f"{name} was not launched by the {setup} leg"
        assert launches[setup]["resize_pyramid"] == launches[setup]["fast_nms_pyramid"], \
            f"kernel S: not one launch a frame on the {setup} leg"
        if setup == "stereo":
            torch.cuda.synchronize()
            res = [_check_stereo_call(args, kw, "stereo leg call", verbose=False)
                   for args, kw in calls]
            check_recorded_rows(row_calls, "stereo leg")
            print(f"kernel T on the stereo leg's own inputs: {len(res)} calls, "
                  f"{sum(r[2] for r in res)} rows matched, flags differing "
                  f"{sum(r[0] for r in res)} (all at a threshold), x_right / depth within "
                  f"{max(r[1] for r in res):.3g}")
    return stats, launches


def run_slices(dev, world, wrappers, card):
    """The RGBD slice and the mono slice, each with every launch count at 0
    just before it and read just after it."""
    from stella_vslam_tpu_torch.util import mono_slice, rgbd_slice

    launches = {}
    for w in wrappers.values():
        w.launches = 0
    stats = rgbd_slice.run_slice(dev, world, n_frames=120, step=0.015)
    launches["rgbd"] = {k: w.launches for k, w in wrappers.items()}
    print("rgbd slice: " + json.dumps(dict(stats, card=card)))
    print("rgbd slice launches: " + json.dumps(launches["rgbd"]))
    assert stats["tracked"] > 0 and stats["landmarks"] > 0
    assert stats["lost_after_init"] <= 2, f"{stats['lost_after_init']} frames lost"
    assert stats["ate_m"] < 0.10, f"rigid ATE {stats['ate_m']:.4f} m"
    assert stats["scale_err"] < 0.05, f"scale error {stats['scale_err']:.2%}"
    for name in ("fast_nms_pyramid", "orb_describe", "hamming_top2", "cell_index", "pose_lm",
                 "scatter_to_current", "dedup_by_id", "project_window_rows", "frame_finish"):
        assert launches["rgbd"][name] > 0, f"{name} was not launched by the RGBD slice"

    for w in wrappers.values():
        w.launches = 0
    mono = mono_slice.run_slice(dev, world, n_frames=120, step=0.015)
    launches["mono"] = {k: w.launches for k, w in wrappers.items()}
    print("mono slice: " + json.dumps(dict(mono, card=card)))
    print("mono slice launches: " + json.dumps(launches["mono"]))
    assert mono["init_frame"] <= 10, f"initialized at frame {mono['init_frame']}"
    assert mono["lost_after_init"] <= 2, f"{mono['lost_after_init']} frames lost"
    assert mono["ate_m"] < 0.10, f"Sim3 ATE {mono['ate_m']:.4f} m"
    for name, n in launches["mono"].items():
        assert n > 0 or name in MAPPING_KERNELS + LOOP_KERNELS + THREADED_KERNELS \
            + STEREO_KERNELS + EQUIRECT_KERNELS + FBOW_KERNELS \
            + SHARDED_KERNELS, f"{name} was not launched by the mono slice"
    return stats, mono, launches


def run_hd_slice(dev, wrappers, card, n_frames: int = 30):
    """The RGBD slice's first n_frames at 1280x720 (hd_world, 7984 slots;
    mapping off, inline) with every launch count at 0 just before it and
    read just after it: at most 2 frames lost, kernel Q's dedup launched
    for every tracked frame after the first (the cascade's stage 3).
    Returns (stats, launches)."""
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature import orb_pattern
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.util import rgbd_slice

    for w in wrappers.values():
        w.launches = 0
    world = hd_world()
    stats = rgbd_slice.run_slice(dev, world, n_frames=n_frames, step=0.015)
    launches = {k: w.launches for k, w in wrappers.items()}
    stats["slots"] = sum(g.Gy * g.Gx for g in ox.level_geometry(
        OrbParams(num_levels=8), world.W, world.H, 800, orb_pattern.EDGE_BORDER))
    assert stats["slots"] == HD_SLOTS, stats["slots"]
    print("1280x720 rgbd slice: " + json.dumps(dict(stats, card=card)))
    print("1280x720 rgbd slice launches: " + json.dumps(launches))
    assert stats["lost_after_init"] <= 2, f"1280x720: {stats['lost_after_init']} frames lost"
    assert launches["dedup_by_id"] >= stats["tracked"] - 1, \
        f"1280x720: {launches['dedup_by_id']} dedups for {stats['tracked']} tracked frames"
    assert launches["fast_nms_pyramid"] >= n_frames  # and the System's warm-up
    return stats, launches


EQUIRECT_LEG_KERNELS = ("resize_pyramid", "fast_nms_pyramid", "orb_describe", "hamming_top2",
                        "cell_index", "pose_lm", "ransac_two_view", "scatter_to_current",
                        "dedup_by_id", "project_window_rows", "epipolar_top2",
                        "epipolar_band_index", "triangulate", "fuse", "fuse_cell_index",
                        "ba_linearize_schur", "schur_index", "ba_reduced_solve",
                        "ba_backsub_cost", "ba_classify", "fbow_transform")
# the rows of the equirectangular modes and of the kernels the leg runs
# unchanged, held at its own shapes, by the counter they read
EQUIRECT_ROWS = {"project_window_rows_equirect": "project_window_rows",
                 "project_window_rows_equirect_points": "project_window_rows",
                 "pose_lm_equirect": "pose_lm",
                 "triangulate_equirect": "triangulate", "fuse_equirect": "fuse",
                 "fuse_cell_index_equirect": "fuse_cell_index",
                 "ransac_two_view_essential": "ransac_two_view",
                 "ransac_two_view_essential_escalated": "ransac_two_view",
                 "essential_5pt": "essential_5pt", "frame_finish_equirect": "frame_finish",
                 **{f"ba_{k}_equirect": f"ba_{k}" for k in (
                     "linearize_schur", "reduced_solve", "backsub_cost", "classify")},
                 **{f"{k}_equirect_leg": k for k in (
                     "resize_pyramid", "fast_nms_pyramid", "orb_describe", "epipolar_top2",
                     "epipolar_band_index", "scatter_to_current", "dedup_by_id")},
                 "fbow_transform_npz_equirect_leg": "fbow_transform",
                 "hamming_top2_equirect_leg": "hamming_top2_window"}
# kernel U's candidates against its plain version's, as sets, up to sign:
# the share within 1e-4 / 1e-3 / 1e-2 each way (the lesser), at least this
# on every seed, and at most U_FLOOR_ROOM below the share of the plain
# version on the CPU. On the leg's init pair (H100, PERF.md) the kernel
# read 0.347-0.351 / 0.724-0.740 / 0.922-0.936 over U_SEEDS, plain on the
# CPU 0.345-0.361 / 0.739-0.749 / 0.928-0.938, and the control (plain with
# its bisection cut to U_CONTROL_BISECT steps) 0.076-0.084 / 0.605-0.627 /
# 0.920-0.930: the limits lie between kernel and control at 1e-4 and 1e-3;
# at 1e-2 the control reads as the kernel does, and the limit is a floor
U_SHARE_LIMITS = (0.30, 0.70, 0.90)
U_FLOOR_ROOM = 0.04
U_CONTROL_BISECT = 3
U_SEEDS = (12, 13, 14, 15)


def record_equirect_inputs(slam, sample: int = 25):
    """Keep, by reference, what the equirectangular leg's kernels saw: the
    initializer's area matches and its last two-view attempt (the init
    pair's bearings and matches), every `sample`-th pose optimization of
    the tracker, the mapper's triangulations, fusions and bundle
    adjustments (record_kernel_inputs) and kernel Q's sampled scatters and
    dedups (record_assoc_inputs). Returns (calls, undo)."""
    from stella_vslam_tpu_torch.match import area

    calls, undo_map = record_kernel_inputs(slam.mapper)
    assoc, undo_assoc = record_assoc_inputs(sample=53)
    calls.update(init=[], pose=[], area=[], **assoc)
    area_match = area.match_in_consistent_area

    def area_rec(*args, **kw):
        calls["area"].append((args, kw))
        return area_match(*args, **kw)
    init, kern = slam.tracker.initializer, slam.tracker.kernels
    attempt, pose_opt = init._initialize_from_aligned, kern._pose_opt
    seen = [0]

    def init_rec(ref, cur_uv, cur_bear, mvalid, n):
        calls["init"].append((ref.bearings.contiguous(), cur_bear, mvalid))
        return attempt(ref, cur_uv, cur_bear, mvalid, n)

    def pose_rec(*args):
        if seen[0] % sample == 0:
            calls["pose"].append(args)
        seen[0] += 1
        return pose_opt(*args)

    init._initialize_from_aligned, kern._pose_opt = init_rec, pose_rec
    area.match_in_consistent_area = area_rec

    def undo():
        del init._initialize_from_aligned, kern._pose_opt
        area.match_in_consistent_area = area_match
        undo_assoc()
        undo_map()

    return calls, undo


def run_equirect_leg(dev, wrappers, card):
    """bench.py's equirectangular leg (util/equirect_slice.py: the default
    threaded System, 250 frames at 640x320, 6 levels) with every launch
    count at 0 just before it and read just after, bench.py's gates, the
    path's kernels launched; then the escalation run: a fresh System on
    the leg's first 12 frames with the initializer's escalation threshold
    above 1, so that every attempt runs the escalated E sweep and the
    5-point sweep of kernel U (the leg itself escalates only when the
    standard batch's consensus is below 45% of the matches), its counts
    read as its own path's. Returns (stats, launches, escalation launches,
    recorded inputs)."""
    from stella_vslam_tpu_torch.util import equirect_slice as es
    from stella_vslam_tpu_torch.util.synthetic import equirect_circle

    world = es.bench_world()
    slam = es.make_system(world, dev)
    calls, undo = record_equirect_inputs(slam)
    try:
        s = es.run_leg(dev, world, slam=slam)
    finally:
        undo()
    launches = s.pop("launches")
    with open(os.path.join(OUT_DIR, "equirect_leg.json"), "w") as f:
        json.dump(dict(s, launches=launches, card=card), f, indent=1)
    print("equirect leg: " + json.dumps(dict(s, card=card)))
    print("equirect leg launches: " + json.dumps(launches))
    for e in slam.worker_error_log:
        print("worker error:\n" + e)
    es.check_gates(s)
    assert s["keyframes_created"] >= 1, "equirect: no keyframe event"
    for name in EQUIRECT_LEG_KERNELS:
        assert launches[name] > 0, f"{name} was not launched by the equirect leg"
    assert s["init_escalations"] > 0 or launches["essential_5pt"] == 0
    # the escalation run
    esc = es.make_system(world, dev)
    esc.tracker.initializer.escalation_ratio_thr = 1.01
    poses, centres = equirect_circle(250)
    for w in wrappers.values():
        w.launches = 0
    for i in range(12):
        esc.feed_monocular_frame(world.render(poses[i]), i * 0.05)
    esc.shutdown()
    esc_launches = {k: w.launches for k, w in wrappers.items()}
    tracked = sum(p is not None for (_, p, _, _) in esc.frame_poses)
    print(f"equirect escalation run: {esc.tracker.initializer.num_escalations} escalated init "
          f"attempts, {tracked} of 12 frames tracked, launches " + json.dumps(esc_launches))
    assert esc_launches["essential_5pt"] > 0 and esc_launches["ransac_two_view"] > 0, \
        "the escalation run launched no five-point sweep"
    assert tracked > 0, "the escalation run did not initialize"
    return s, launches, esc_launches, calls, slam


def _candidate_shares(Ea, va, Eb, vb, thrs=(1e-4, 1e-3, 1e-2)):
    """Per threshold, the share of a's valid candidates with one of b's (of
    the same set) within it, up to sign (max |entry| difference)."""
    import torch

    Ea, Eb = Ea.flatten(2), Eb.flatten(2)  # [B,10,9]
    d = torch.minimum((Ea[:, :, None] - Eb[:, None]).abs().amax(-1),
                      (Ea[:, :, None] + Eb[:, None]).abs().amax(-1))  # [B,10,10]
    d = torch.where(vb[:, None, :], d, torch.full_like(d, float("inf"))).amin(-1)[va]
    return [float((d <= t).float().mean()) if d.numel() else 1.0 for t in thrs]


def check_equirect_shapes(dev, slam_like, calls):
    """The kernels the equirectangular leg runs unchanged, against their
    plain versions at its own shapes: S, A and B on one of its frames
    through its extractor (640x320, 6 levels, min_size 800: 1199 slots on
    a grid unlike the 752x480 slices'), with phase 3's and the stereo
    phase's bounds; V on that frame's descriptors (.npz tree, exact); C's angle-gate
    mode on the init pair's last area match and J on the leg's largest
    triangulation (rows differing <= 1e-3, as phases 4 and 8); Q on the
    leg's sampled scatters and dedups (exact). Returns their rows."""
    import torch

    from stella_vslam_tpu_torch.data import fbow_io
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.match import area
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.module import tracking_kernels as tk
    from stella_vslam_tpu_torch.util import equirect_slice as es
    from stella_vslam_tpu_torch.util.synthetic import equirect_circle

    rows = []
    ex, params = slam_like.extractor, slam_like.extractor.params
    L = len(ex.levels)
    img = torch.from_numpy(es.bench_world().render(equirect_circle(250)[0][0])).to(dev)
    shape = f"{ex.width}x{ex.height}, {L} levels, {ex.num_slots} slots"
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))

    # ---- S: the pyramid, against its two-tap plain and the matmul pyramid ----
    pk, pp = ex.pyramid(img), ex.pyramid_plain(img)
    pt = ex.pyramid_taps_plain(img.cpu())
    n_taps = sum(int((a.cpu() != b).sum()) for a, b in zip(pk, pt))
    n_px = sum(a.numel() for a in pk[1:])
    n_diff = sum(int((a != b).sum()) for a, b in zip(pk[1:], pp[1:]))
    max_s = max(float((a - b).abs().max()) for a, b in zip(pk[1:], pp[1:]))
    keys = moved = 0
    for a, b, g in zip(pk, pp, ex.levels):
        ka = ox.fast_nms(a.contiguous(), g, ex.border, *thr)
        keys += ka.numel()
        moved += int((ka != ox.fast_nms(b.contiguous(), g, ex.border, *thr)).sum())
    torch.cuda.synchronize()
    print(f"kernel S resize_pyramid at the equirect leg's shape ({shape}): {n_taps} pixels "
          f"differ from the two-tap plain; {n_px} pixels of levels 1-{L - 1}, {n_diff} differ "
          f"from the matmul's, max |diff| {max_s:.3g}; kernel A's cell keys moved {moved} of "
          f"{keys}")
    assert n_taps == 0, "kernel S disagrees with its two-tap plain version at the leg's shape"
    assert max_s <= 1e-4 and moved <= 0.005 * keys, "kernel S disagrees at the leg's shape"
    plain_s = _median_ms(lambda: ex.pyramid_plain(img))
    rows.append(dict(
        name="resize_pyramid_equirect_leg", route="cuda",
        source="stella_vslam_tpu_torch/csrc/resize.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:118", max_abs_err=0.0,
        max_abs_err_cublas=max_s, pixels_differing_cublas=n_diff, pixels=n_px,
        fast_keys_moved=moved, fast_keys=keys,
        pixels_computed_twice=ex.pyramid_plan_for(1).computed - n_px,
        shape=shape + ", one launch for every level", **_times(lambda: ex.pyramid(img)),
        plain_ms=plain_s, library_ms=_device_ms(lambda: ex.pyramid_plain(img)),
        library_one_call_ms=plain_s, library_call="two torch.matmul a level (the plain pyramid)",
        **_bound(_pyramid_bytes(ex, img[None]), 6.0 * n_px)))

    # ---- A: FAST + NMS on every level, one launch ----
    pyr = torch.cat([l.reshape(-1) for l in pk])[None]
    run_a = lambda fn: fn(pyr, ex._fast, *thr)
    ka, pa = run_a(ox.fast_nms_pyramid), run_a(ox.fast_nms_pyramid_plain)
    torch.cuda.synchronize()
    assert all(torch.equal(k, p) for k, p in zip(ka, pa)), \
        "kernel A disagrees with its plain version at the leg's shape"
    print(f"kernel A fast_nms_pyramid at the equirect leg's shape: "
          f"{int(ka[3].sum())}/{ex.num_slots} cells with a corner, bit-equal to plain")
    rows.append(dict(
        name="fast_nms_pyramid_equirect_leg", route="cuda",
        source="stella_vslam_tpu_torch/csrc/fast_nms.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:88", max_abs_err=0.0,
        shape=shape + ", one launch a frame", **_times(lambda: run_a(ox.fast_nms_pyramid)),
        plain_ms=_median_ms(lambda: run_a(ox.fast_nms_pyramid_plain)), library_ms=None,
        **fast_work(ex, pyr)))

    # ---- B: orientation, blur and steered BRIEF of the frame's slots ----
    px, py, valid = ka[1][0], ka[2][0], ka[3][0]
    bargs = (pyr.reshape(-1), ex._slot_base, ex._slot_H, ex._slot_W, px, py, valid,
             ex._tables)
    pyr_bytes = 4.0 * pyr.numel()
    ang_k, desc_k = ox.orb_describe(*bargs)
    ang_p, desc_p = ox.orb_describe_plain(*bargs)
    torch.cuda.synchronize()
    err_b = float((ang_k - ang_p).abs().max())
    x = (desc_k ^ desc_p)[valid].cpu().numpy()
    bit_rate = float(np.unpackbits(x.view(np.uint8)).sum()) / max(1, x.size * 32)
    n_valid = int(valid.sum())
    print(f"kernel B orb_describe at the equirect leg's shape: {n_valid} keypoints, "
          f"descriptor bit mismatch {bit_rate:.6f}, max |angle diff| {err_b:.3g} rad")
    assert bit_rate <= DESC_MISMATCH_BOUND and err_b < 1e-3, \
        "kernel B disagrees with its plain version at the leg's shape"
    rows.append(dict(
        name="orb_describe_equirect_leg", route="cuda",
        source="stella_vslam_tpu_torch/csrc/orb_describe.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:392", max_abs_err=err_b,
        desc_bit_mismatch=bit_rate, shape=shape,
        **_times(lambda: ox.orb_describe(*bargs)),
        plain_ms=_median_ms(lambda: ox.orb_describe_plain(*bargs)), library_ms=None,
        **_bound(pyr_bytes + 36.0 * ex.num_slots, _describe_ops(ang_k, valid, ex._tables))))

    # ---- V: the .npz vocabulary's descent of the frame's descriptors ----
    tab = slam_like.bow_vocab.tables()
    d_v = desc_k.contiguous()
    differ_v = int((fbow_io.fbow_transform(d_v, tab) != fbow_io.fbow_transform_plain(d_v, tab))
                   .sum())
    torch.cuda.synchronize()
    print(f"kernel V fbow_transform on the .npz tree at the equirect leg's shape: "
          f"{ex.num_slots} descriptors, word ids differing from plain: {differ_v}")
    assert differ_v == 0, "kernel V disagrees with its plain version at the leg's shape"
    rows.append(_fbow_row("fbow_transform_npz_equirect_leg", d_v, tab))

    # ---- C, angle-gate mode: the init pair's area match ----
    a_args, a_kw = calls["area"][-1]
    cargs, ckw = area.top2_args(*a_args, margin=a_kw.get("margin", 100.0),
                                image_size=a_kw["image_size"])
    k, p = H.hamming_top2(*cargs, **ckw), H.hamming_top2_plain(*cargs, **ckw)
    differ = torch.zeros_like(k[0], dtype=torch.bool)
    for u, v in zip(k, p):
        differ |= u != v
    share_c = float(differ.float().mean())
    Mc, Nc = cargs[0].shape[0], cargs[1].shape[0]
    n_cand = float(H.gate_matrix(cargs[2], cargs[3], ckw["window"], ckw["orient"]).sum())
    visited = int(H.pairs_visited(*cargs, **ckw))
    torch.cuda.synchronize()
    print(f"kernel C angle gate on the equirect leg's init pair: {Mc}x{Nc}, "
          f"{int(cargs[2].sum())} level-0 rows, {int(n_cand)} candidate pairs, rows differing "
          f"from plain {share_c:.6f}")
    assert share_c <= 1e-3, "kernel C's angle gate disagrees with plain on the leg's init pair"
    rows.append(dict(
        name="hamming_top2_equirect_leg", route="cuda",
        source="stella_vslam_tpu_torch/csrc/hamming_top2.cu",
        replaces="stella_vslam_tpu/match/area.py:19", max_abs_err=share_c,
        shape=f"{Mc}x{Nc}, window and angle gate", pairs_visited=visited,
        dense_pairs=Mc * Nc, **_times(lambda: H.hamming_top2(*cargs, **ckw)),
        plain_ms=_median_ms(lambda: H.hamming_top2_plain(*cargs, **ckw)), library_ms=None,
        # this run's work, as phase 3 counts it: the gates on every pair the
        # cell walk visits, XOR + popcount and the top-2 on each candidate
        **_bound(Mc * (32 + 24 + 16) + Nc * (32 + 17), 8.0 * visited + 24.0 * n_cand)))

    # ---- J: the leg's largest triangulation ----
    tri, _, _ = largest_inputs(calls)
    rows += _check_epipolar(dev, slam_like.mapper.kernels, tri,
                            name="epipolar_top2_equirect_leg",
                            label=" on the equirect leg's largest triangulation")

    # ---- Q: the leg's sampled scatters and dedups ----
    err_q = 0.0
    for kind in ("scatter", "dedup", "rebase"):
        for args in calls[kind]:
            err_q = max(err_q, _check_assoc_call(kind, args))
    n = {k_: len(calls[k_]) for k_ in ("scatter", "dedup", "rebase")}
    print(f"kernel Q on the equirect leg's inputs: {json.dumps(n)} calls, ints exact, poses "
          f"within {err_q:.3g}")
    assert n["scatter"] > 0 and n["dedup"] > 0, "no kernel Q call recorded on the leg"
    sargs, dargs = calls["scatter"][-1], calls["dedup"][-1]
    Ms, Ns, Nd = sargs[0].shape[0], int(sargs[4]), dargs[0].shape[0]
    src_q = "stella_vslam_tpu_torch/csrc/track_assoc.cu"
    rows.append(dict(
        name="scatter_to_current_equirect_leg", route="cuda", source=src_q,
        replaces="stella_vslam_tpu/module/tracking_kernels.py:64", max_abs_err=0.0,
        shape=f"M={Ms} N={Ns}", **_times(lambda: tk.scatter_to_current(*sargs)),
        plain_ms=_median_ms(lambda: tk.scatter_to_current_plain(*sargs)), library_ms=None,
        **_bound(Ms * (4 + 1 + 12 + 4) + Ns * (12 + 4 + 1), 4.0 * (Ms + Ns))))
    rows.append(dict(
        name="dedup_by_id_equirect_leg", route="cuda", source=src_q,
        replaces="stella_vslam_tpu/module/tracking_kernels.py:83", max_abs_err=0.0,
        shape=f"N={Nd}", **_times(lambda: tk.dedup_by_id(*dargs)),
        plain_ms=_median_ms(lambda: tk.dedup_by_id_plain(*dargs)), library_ms=None,
        **_bound(Nd * (1 + 4 + 4) + Nd * (1 + 4), 10.0 * Nd)))
    return rows


def check_equirect_kernels(dev, slam_like, calls):
    """The equirectangular modes against their plain versions: R on
    synthetic points and table rows all around the camera (C = 4096), D on
    the leg's recorded pose optimizations, K and L on the leg's largest
    triangulation and fuse chunk, F-I kernel by kernel (_lockstep_ba) on the
    leg's init and local bundle adjustments and timed at the local shape;
    E's MODEL 2 (the 1024-hypothesis batch with one LO refit, and the
    escalated 8 x 4096 with 3 LO refits) and U (1024 five-point sets) on
    the leg's init pair. Returns their rows of the kernels line."""
    import torch

    from stella_vslam_tpu_torch.camera import base as cb
    from stella_vslam_tpu_torch.module import mapping_kernels as mk
    from stella_vslam_tpu_torch.module.tracking_kernels import make_cam_scalars
    from stella_vslam_tpu_torch.ops.optim import pose as pose_mod
    from stella_vslam_tpu_torch.ops.solve import essential as Em
    from stella_vslam_tpu_torch.ops.solve import essential_5pt as U
    from stella_vslam_tpu_torch.ops.solve import ransac as R

    rows = []
    cam = slam_like.camera
    p, model = cam.params, cam.model
    kern = slam_like.mapper.kernels
    cs = make_cam_scalars(cam)
    EQ = cb.CameraModel.EQUIRECTANGULAR

    # ---- R: window rows of points and table rows all around the camera ----
    C, N_eq, L = 4096, slam_like.extractor.num_slots, slam_like.orb_params.num_levels
    _, Rm, t, tbl, tkw, pts, pkw = rows_case(dev, None, C, N_eq, seed=15,
                                             scale_factors=slam_like.orb_params.scale_factors)
    for label, args, kw, M, table in (("table", tbl, tkw, C, True),
                                      ("points", pts, pkw, N_eq, False)):
        err, n_diff, n_near = _check_rows_call(p, Rm, t, args, kw)
        print(f"kernel R project_window_rows (equirectangular, {label}): {M} rows all around "
              f"the camera, u, v, x_right and radius within {err:.3g} relative (of at least "
              f"100 px; u either edge at the seam), {n_diff} rows apart, {n_near} within 1e-6 "
              f"of a threshold")
        rows.append(dict(
            name="project_window_rows_equirect" + ("" if table else "_points"), route="cuda",
            source="stella_vslam_tpu_torch/csrc/reproject.cu + camera.cuh",
            replaces="stella_vslam_tpu/camera/base.py:232, module/tracking_kernels.py:266-285, "
                     "match/projection.py:53,127",
            max_abs_err=err, rows_differing=n_diff,
            shape=(f"C={M} table rows with the local-map gate, 640x320" if table
                   else f"M={M} last-frame points, 640x320"),
            **_times(lambda: cb.project_window_rows(p, Rm, t, args, **kw)),
            plain_ms=_median_ms(lambda: cb.project_window_rows_plain(p, Rm, t, args, **kw)),
            library_ms=None,
            # ~150 operations a row with atan2 and asin
            **_rows_bound(M, table, L, 150.0 if table else 110.0)))

    # ---- D: the leg's own pose optimizations ----
    kern_t = slam_like.tracker.kernels
    err_d, n_in = 0.0, 0
    n_probs = 0
    for problems, uv, xr, level in calls["pose"]:
        # the cascade's batch (stages 2 and 1, or stage 3) as it launched it
        R0, t0, pos_, has = (torch.stack(f) for f in zip(*problems))
        isig = kern_t.inv_sigma_sq[level.long()]
        k = pose_mod.optimize_pose_batch(R0, t0, pos_, uv, xr, isig, has, cs,
                                         model="equirectangular")
        for b in range(R0.shape[0]):
            q = pose_mod.optimize_pose_plain(R0[b], t0[b], pos_[b], uv, xr, isig, has[b], cs,
                                             model="equirectangular")
            err_d = max(err_d, float((k.R_cw[b] - q.R_cw).abs().max()),
                        float((k.t_cw[b] - q.t_cw).abs().max()))
            n_in = max(n_in, int((k.is_inlier[b] != q.is_inlier).sum()))
            n_probs += 1
    torch.cuda.synchronize()
    N = calls["pose"][0][1].shape[0]
    print(f"kernel D optimize_pose_batch (equirectangular): {len(calls['pose'])} of the leg's "
          f"launches ({n_probs} problems, N={N}), poses within {err_d:.3g}, inlier flags apart "
          f"at most {n_in}")
    assert err_d < 1e-4, "kernel D's equirectangular mode disagrees with its plain version"
    problems, uv, xr, level = calls["pose"][-1]
    R0, t0, pos_, has = problems[0]
    a = (R0.contiguous(), t0.contiguous(), pos_.contiguous(), uv.contiguous(), xr.contiguous(),
         kern_t.inv_sigma_sq[level.long()].contiguous(), has.contiguous())
    rows.append(dict(
        name="pose_lm_equirect", route="cuda", source="stella_vslam_tpu_torch/csrc/pose_lm.cu "
        "+ camera.cuh", replaces="stella_vslam_tpu/ops/optim/pose.py:39 (residuals.py:92)",
        max_abs_err=err_d, shape=f"N={N}",
        **_times(lambda: pose_mod.optimize_pose(*a, cs, model="equirectangular")),
        plain_ms=_median_ms(lambda: pose_mod.optimize_pose_plain(*a, cs, model="equirectangular"),
                            reps=3, warmup=1),
        library_ms=None,
        # 45 passes over the slots (44 evaluations, the final classification),
        # ~250 operations a slot each with the trigonometry; inputs read once
        **_bound(N * (12 + 8 + 4 + 4 + 1) + 48, 45.0 * 250.0 * N)))

    # ---- K, L: the leg's largest triangulation and fuse chunk ----
    from stella_vslam_tpu_torch.match import fuse as fuse_match
    from stella_vslam_tpu_torch.match import robust

    tri, fargs, local = largest_inputs(calls)
    cur, nbrs, poses, pair_valid = tri
    B, N1 = nbrs.desc.shape[0], cur.desc.shape[0]
    E_12, epl2 = mk.epipolar_terms(poses)
    idx2, accepted, _ = robust.match_for_triangulation(
        cur.angle, cur.level, cur.desc, cur.bear, cur.unassoc, cur.stereo, nbrs.angle,
        nbrs.desc, nbrs.bear, nbrs.unassoc, nbrs.stereo, E_12, epl2,
        scale_factors=kern.scale_factors)
    kargs = (cur.uv, cur.level, cur.bear, nbrs.uv, nbrs.level, nbrs.bear, poses.contiguous(),
             idx2.contiguous(), accepted, pair_valid, kern.cam, kern.level_sigma_sq,
             kern.scale_factors, model)
    rk, rp = mk.triangulate_checks(*kargs), mk.triangulate_checks_plain(*kargs)
    torch.cuda.synchronize()
    share_k = float((rk.ok != rp.ok).float().mean())
    both = rk.ok & rp.ok
    rel = (torch.linalg.norm(rk.pos_w - rp.pos_w, dim=-1)
           / torch.clamp(torch.linalg.norm(rp.pos_w, dim=-1), min=1e-12))[both]
    rel_max = float(rel.max()) if rel.numel() else 0.0
    apart_k = tri_bits_apart(rk, rp)
    print(f"kernel K triangulate (equirectangular): {B}x{N1} slots, {int(accepted.sum())} "
          f"matched, {int(rk.ok.sum())} ok (plain {int(rp.ok.sum())}), ok flags differing "
          f"{share_k:.6f}, positions within {rel_max:.3g} relative where both ok; elements "
          f"whose bits differ from plain {json.dumps(apart_k)}")
    assert share_k <= 1e-3 and rel_max < 1e-4, "kernel K's equirectangular mode disagrees"
    rows.append(dict(
        name="triangulate_equirect", route="cuda",
        source="stella_vslam_tpu_torch/csrc/triangulate.cu + camera.cuh",
        replaces="stella_vslam_tpu/module/mapping_kernels.py:58", max_abs_err=rel_max,
        ok_flags_differing=share_k, elements_differing_from_plain=apart_k, shape=f"{B}x{N1}",
        **_times(lambda: mk.triangulate_checks(*kargs)),
        plain_ms=_median_ms(lambda: mk.triangulate_checks_plain(*kargs), reps=10),
        library_ms=None,
        **_bound(N1 * 24.0 + B * nbrs.desc.shape[1] * 24.0 + B * N1 * 5.0 + (B + 1) * 48.0
                 + B * N1 * 17.0, 450.0 * B * N1)))
    rows += check_fuse_chunk(dev, kern, fargs, "equirectangular")

    # ---- F-I: the leg's init and local bundle adjustments ----
    probs = [q for q in calls["bundle_adjust"] if q.cam_R.shape[0] == 2][:1] + local[:4]
    worst = {}
    for q in probs:
        for k_, v in _lockstep_ba(q, cs, 3 if q.cam_R.shape[0] > 2 else 5,
                                  6 if q.cam_R.shape[0] > 2 else 10,
                                  model="equirectangular").items():
            worst[k_] = worst.get(k_, 0) + v if isinstance(v, int) else max(worst.get(k_, 0.0), v)
    print(f"kernels F-I (equirectangular) kernel by kernel against plain on the leg's init BA "
          f"and {len(probs) - 1} local problems: " + json.dumps(worst))
    assert worst["f_excess"] < 1.0 and worst["g_backward"] < 1e-3 and worst["g_pose"] < 1e-5 \
        and worst["point_share"] < 1.0 and worst["cost_rel"] < 1e-4 \
        and worst["decisions"] == 0 and worst["flags"] == 0, \
        "kernels F-I's equirectangular mode disagrees with the plain BA on the leg's problems"
    ba_rows = _time_ba_kernels(dev, worst["g_pose"], local[0], cs, suffix="_equirect",
                               model="equirectangular")
    ba_rows[0]["kernel_by_kernel_on_leg"] = worst
    rows += ba_rows

    # ---- E's MODEL 2 and U on the leg's init pair ----
    b1, b2, mv = calls["init"][-1]
    Nm = b1.shape[0]
    Bh = 1024
    # hypothesis by hypothesis: a set drawn differently gives an unrelated
    # model (the sampler, shared with kernel U, is held bit for bit below)
    mk_, _, nk = R.minimal_hypotheses(Em.MODEL, 11, b1, b2, mv, Bh)
    mp_, _, np_ = R.minimal_hypotheses_plain(Em.MODEL, 11, b1, b2, mv, Bh, 1.0)
    same_count = float((nk == np_).float().mean())
    model_share = lambda a_, b_: float((torch.minimum(
        (a_ - b_).abs().amax((1, 2)), (a_ + b_).abs().amax((1, 2))) <= 1e-3).float().mean())
    same_model = model_share(mk_, mp_)
    # the control: plain's models of another seed's sets
    other_seed = model_share(mk_, R.minimal_hypotheses_plain(Em.MODEL, 12, b1, b2, mv, Bh,
                                                             1.0)[0])
    rk = Em.find_via_ransac(11, b1, b2, mv, num_hypotheses=Bh)
    rp = R.find_core_plain(Em.MODEL, 11, b1, b2, mv, Bh, 1.0, 1)
    seeds = list(range(100, 108))
    n0 = R.minimal_hypotheses.launches
    ek = Em.find_via_ransac_escalated(seeds, b1, b2, mv)
    n_esc = R.minimal_hypotheses.launches - n0
    ep = R.escalate(lambda sd: R.find_core_plain(Em.MODEL, sd, b1, b2, mv, 4096, 1.0, 3), seeds)
    torch.cuda.synchronize()
    print(f"kernel E essential (MODEL 2): {Bh} x {Nm} ({int(mv.sum())} matches of the leg's "
          f"init pair), {same_model:.4f} of the hypotheses with the plain model (within 1e-3, "
          f"up to sign; of another seed's sets {other_seed:.4f}), {same_count:.4f} with the plain "
          f"inlier count; winner {int(rk.num_inliers)} inliers (plain "
          f"{int(rp.num_inliers)}), masks equal {bool(torch.equal(rk.is_inlier, rp.is_inlier))}; "
          f"escalated 8x4096 + 3 LO {int(ek.num_inliers)} (plain {int(ep.num_inliers)}) in "
          f"{n_esc} launches")
    # the leg's init pair read 0.8799 on the H100 (70 matches: many sets
    # nearly degenerate, whose null vectors part in rounding)
    assert same_model >= 0.75 > other_seed, "kernel E's MODEL 2 hypotheses disagree with plain"
    assert bool(rk.valid) and int(rk.num_inliers) == int(rp.num_inliers), \
        "kernel E's MODEL 2 winner disagrees with its plain version"
    assert bool(ek.valid) and abs(int(ek.num_inliers) - int(ep.num_inliers)) \
        <= 0.01 * int(ep.num_inliers) and n_esc == 2, "kernel E's escalated MODEL 2 disagrees"
    # per hypothesis: the hash of 8 x N (~10 integer ops each), 8 rows of
    # A^T A (8 x 45 x 2), 18 squarings of 9x9 (18 x 729 x 2), the angular
    # score of N pairs (~60 flops); the LO refit: N rows of A^T A and a score
    e_ops = Bh * (8 * 90 + 18 * 1458 + Nm * 60.0) + Nm * (90 + 60.0)
    e_int = Bh * 8 * Nm * E_HASH_INT_OPS
    rows.append(dict(
        name="ransac_two_view_essential", route="cuda",
        source="stella_vslam_tpu_torch/csrc/ransac_two_view.cu",
        replaces="stella_vslam_tpu/ops/solve/essential.py:113", max_abs_err=1.0 - same_count,
        hypotheses_with_plain_model=same_model,
        shape=f"{Bh} x {Nm}, 1 LO refit",
        **_times(lambda: Em.find_via_ransac(11, b1, b2, mv, num_hypotheses=Bh), reps=10),
        plain_ms=_median_ms(lambda: R.find_core_plain(Em.MODEL, 11, b1, b2, mv, Bh, 1.0, 1),
                            reps=5, warmup=1),
        library_ms=None, **_bound(Nm * 25.0 + Bh * 44.0, e_ops, e_int)))
    esc_ops = 8 * (4096 * (8 * 90 + 18 * 1458 + Nm * 60.0) + 3 * Nm * (90 + 60.0))
    esc_int = 8 * 4096 * 8 * Nm * E_HASH_INT_OPS
    rows.append(dict(
        name="ransac_two_view_essential_escalated", route="cuda",
        source="stella_vslam_tpu_torch/csrc/ransac_two_view.cu",
        replaces="stella_vslam_tpu/ops/solve/essential.py:129",
        max_abs_err=abs(int(ek.num_inliers) - int(ep.num_inliers)),
        shape=f"8 x 4096 x {Nm}, 3 LO refits",
        **_times(lambda: Em.find_via_ransac_escalated(seeds, b1, b2, mv), reps=5),
        plain_ms=_median_ms(lambda: R.escalate(
            lambda sd: R.find_core_plain(Em.MODEL, sd, b1, b2, mv, 4096, 1.0, 3), seeds),
            reps=3, warmup=1),
        library_ms=None, **_bound(8 * (Nm * 25.0 + 4096 * 44.0), esc_ops, esc_int)))
    # U: 1024 five-point sets for each seed, against plain on the card;
    # beside it the plain version on the CPU (one algorithm under two
    # float32 roundings) and a control that the limits must catch: plain on
    # the card with its bisection cut to U_CONTROL_BISECT steps
    both_ways = lambda Ea, va, Eb, vb: [min(x, y) for x, y in zip(
        _candidate_shares(Ea, va, Eb, vb), _candidate_shares(Eb, vb, Ea, va))]
    reads = dict(kernel=[], plain_cpu=[], control=[])
    flags = []
    for sd in U_SEEDS:
        idx_u, E_k, v_k = U.solve_sampled_sets(sd, b1, b2, mv, Bh)
        idx_q, E_p, v_p = U.solve_sampled_sets_plain(sd, b1, b2, mv, Bh)
        assert bool(torch.equal(idx_u, idx_q)), "kernel U's sampled indices differ"
        _, E_c, v_c = U.solve_sampled_sets_plain(sd, b1.cpu(), b2.cpu(), mv.cpu(), Bh)
        full, U.BISECT_ITERS = U.BISECT_ITERS, U_CONTROL_BISECT
        try:
            _, E_x, v_x = U.solve_sampled_sets_plain(sd, b1, b2, mv, Bh)
        finally:
            U.BISECT_ITERS = full
        reads["kernel"].append(both_ways(E_k, v_k, E_p, v_p))
        reads["plain_cpu"].append(both_ways(E_c.to(dev), v_c.to(dev), E_p, v_p))
        reads["control"].append(both_ways(E_x, v_x, E_p, v_p))
        flags.append(float((v_k == v_p).float().mean()))
    idx_u, E_k, v_k = U.solve_sampled_sets(U_SEEDS[0], b1, b2, mv, Bh)
    _, E_p, v_p = U.solve_sampled_sets_plain(U_SEEDS[0], b1, b2, mv, Bh)
    s1, s2 = b1[idx_u], b2[idx_u]
    # each candidate on its own five pairs (a set whose pairs are nearly
    # dependent, or that drew one match twice, yields loose candidates:
    # the share that holds is compared with plain's)
    res = lambda E: torch.einsum("bni,brij,bnj->brn", s2, E, s1).abs().amax(-1)
    tight_k = float((res(E_k)[v_k] < 5e-4).float().mean()) if bool(v_k.any()) else 1.0
    tight_p = float((res(E_p)[v_p] < 5e-4).float().mean()) if bool(v_p.any()) else 1.0
    r5k = Em.find_via_ransac_5pt(12, b1, b2, mv, num_hypotheses=Bh)
    cst, cnt = R.score_models_plain(Em.MODEL, E_p.reshape(-1, 3, 3), v_p.reshape(-1), b1, b2,
                                    mv, 1.0 - Em.COS_ANGLE_THR)
    n5p = int(cnt[R.select_best(cst, cnt, 5)[0]])
    torch.cuda.synchronize()
    worst = [min(r[i] for r in reads["kernel"]) for i in range(3)]
    caught = [any(r[i] < U_SHARE_LIMITS[i] for i in range(3)) for r in reads["control"]]
    print(f"kernel U essential_5pt: {Bh} sets of the leg's init pair for each of seeds "
          f"{list(U_SEEDS)}, sampled indices equal, valid flags equal on {flags} of the slots; "
          f"candidates within 1e-4 / 1e-3 / 1e-2 of plain's on the card (up to sign, the lesser "
          f"of both ways), per seed: kernel {reads['kernel']}, plain on the CPU "
          f"{reads['plain_cpu']}, control ({U_CONTROL_BISECT} bisection steps) "
          f"{reads['control']}; limits {list(U_SHARE_LIMITS)}; candidates with their five "
          f"epipolar residuals under 5e-4: {tight_k:.4f} (plain {tight_p:.4f}); the 5-point "
          f"RANSAC's best candidate {int(r5k.num_inliers)} inliers after 2 LO refits, plain's "
          f"best candidate {n5p} before them")
    assert min(flags) >= 0.98 and all(w >= lim for w, lim in zip(worst, U_SHARE_LIMITS)), \
        "kernel U's candidates disagree with its plain version past the float32 floor"
    assert all(k_ >= c_ - U_FLOOR_ROOM for rk_, rc_ in zip(reads["kernel"], reads["plain_cpu"])
               for k_, c_ in zip(rk_, rc_)), \
        "kernel U agrees with plain on the card less than plain on the CPU does"
    assert all(caught), "the control passes kernel U's limits: they would catch no fault"
    assert tight_k >= tight_p - 0.02, \
        "fewer kernel U candidates satisfy their own epipolar constraints than plain's"
    n_roots = int(v_k.sum())
    u_ops = Bh * (257 * 1400.0 + 25000.0) + n_roots * (28 * 1400.0 + 18 * 2000.0 + 300.0)
    rows.append(dict(
        name="essential_5pt", route="cuda", source="stella_vslam_tpu_torch/csrc/essential_5pt.cu",
        replaces="stella_vslam_tpu/ops/solve/essential_5pt.py:218",
        max_abs_err=1.0 - worst[1], candidates_within=dict(zip(("1e-4", "1e-3", "1e-2"), worst)),
        readings=reads,
        shape=f"{Bh} sets, N={Nm}",
        **_times(lambda: U.solve_sampled_sets(12, b1, b2, mv, Bh), reps=10),
        plain_ms=_median_ms(lambda: U.solve_sampled_sets_plain(12, b1, b2, mv, Bh), reps=3,
                            warmup=1),
        library_ms=None,
        **_bound(Nm * 25.0 + Bh * (20 + 10 * 37.0) + 257 * 4 + 144, u_ops)))
    return rows


# kernel V's row on the FBoW leg's fixture tree (its launches are that leg's;
# the .npz tree's rows read the threaded slice's and the equirect leg's)
FBOW_KERNELS = ("fbow_transform",)
# what every distorted leg launches (kernel R's frame finish in its model)
DISTORTED_LEG_KERNELS = ("frame_finish", "resize_pyramid", "fast_nms_pyramid", "orb_describe",
                         "hamming_top2", "cell_index", "pose_lm", "ransac_two_view",
                         "scatter_to_current", "dedup_by_id", "project_window_rows",
                         "epipolar_top2", "epipolar_band_index", "triangulate", "fuse",
                         "fuse_cell_index", "ba_linearize_schur", "schur_index",
                         "ba_reduced_solve", "ba_backsub_cost", "ba_classify", "fbow_transform")
# the rows whose launches are a distorted leg's (and its counter there)
DISTORTED_ROWS = {"frame_finish_fisheye": ("fisheye", "frame_finish"),
                  "frame_finish_radial": ("radial_division", "frame_finish"),
                  "fast_nms_pyramid_masked": ("fisheye_masked", "fast_nms_pyramid_masked")}


def record_frame_keypoints(slam):
    """Keep, by reference, every monocular frame's raw keypoints (kernel R's
    undistortion input) and the first frame's image as fed. Returns
    (calls, undo)."""
    calls = dict(xy=[], image=[])
    create = slam.create_monocular_frame

    def rec(img, timestamp, mask=None):
        frm = create(img, timestamp, mask)
        calls["xy"].append(frm.feats.xy)
        if not calls["image"]:
            calls["image"].append(np.array(img))
        return frm

    slam.create_monocular_frame = rec

    def undo():
        del slam.create_monocular_frame

    return calls, undo


def run_distorted_legs(dev, world, wrappers, card):
    """The fisheye and radial-division legs (util/distorted_slice.py): the
    mono slice's first 120 frames through the default threaded System with
    mapping, each through its camera (the fisheye with its vignette mask),
    every launch count at 0 just before each and read just after it, with
    the legs' gates. Returns ({leg: stats}, {leg: launches}, {leg:
    recorded keypoints and image})."""
    from stella_vslam_tpu_torch.util import distorted_slice as ds

    stats, launches, recs = {}, {}, {}
    for leg in ds.LEGS:
        dworld = ds.leg_world(leg, world)
        slam = ds.make_system(dworld, dev)
        calls, undo = record_frame_keypoints(slam)
        for w in wrappers.values():
            w.launches = 0
        try:
            s = ds.run_leg(dev, leg, world=dworld, slam=slam)
        finally:
            undo()
        la = s.pop("launches")
        stats[leg], launches[leg], recs[leg] = s, la, calls
        with open(os.path.join(OUT_DIR, f"{leg}_leg.json"), "w") as f:
            json.dump(dict(s, launches=la, card=card), f, indent=1)
        print(f"{leg} leg: " + json.dumps(dict(s, card=card)))
        print(f"{leg} leg launches: " + json.dumps(la))
        for e in slam.worker_error_log:
            print("worker error:\n" + e)
        for msg in ds.check_gates(dict(s, launches=la)):
            print(f"{leg} leg: open fault (ROADMAP Queue 3), gate missed: {msg}")
        assert s["keyframes_created"] >= 1, f"{leg}: no keyframe event"
        for name in DISTORTED_LEG_KERNELS:
            assert la[name] > 0, f"{name} was not launched by the {leg} leg"
        assert la["frame_finish"] == s["frames"], \
            f"{leg}: {la['frame_finish']} launches of frame_finish for {s['frames']} frames"
        masked = la["fast_nms_pyramid_masked"]
        assert masked == (la["fast_nms_pyramid"] if s["masked"] else 0), \
            f"{leg}: {masked} masked launches of kernel A of {la['fast_nms_pyramid']}"
    return stats, launches, recs


def check_distorted_kernels(dev, world, recs):
    """Kernel R's Kannala-Brandt and division modes (the undistortion alone,
    the camera's entry point into the frame finish's kernel) against their
    plain versions on the card, bit for bit, on every keypoint of the legs'
    frames and on 2872 random keypoints over the whole image (the frame
    finish's rows are check_frame_finish's); kernel A with a mask
    against its plain version, exactly, on every level of a fisheye leg
    frame (752x480, 8 levels) with the half-image mask of
    tests/test_orb_extractor.py, a seeded random mask and the leg's
    vignette. Returns rows of the kernels line."""
    import torch

    from stella_vslam_tpu_torch.camera import base as cb
    from stella_vslam_tpu_torch.feature import orb_extractor as ox
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.util import distorted_slice as ds

    rows = []
    N = 2872
    rng = np.random.default_rng(17)
    rand = torch.as_tensor(np.stack([rng.uniform(0, world.W, N), rng.uniform(0, world.H, N)],
                                    -1).astype(np.float32), device=dev)
    modes = {"fisheye": (cb.undistort_fisheye, cb.fisheye_undistort),
             "radial_division": (cb.undistort_radial, cb.radial_division_undistort)}
    for model, (kern, plain) in modes.items():
        p = cb.camera_from_yaml(ds.leg_world(model, world).camera_yaml()).params
        legs = [leg for leg in ds.LEGS if ds.MODEL[leg] == model]
        leg_kp = torch.cat([xy for leg in legs for xy in recs[leg]["xy"]]).contiguous()
        differ = {}
        for label, pts in (("leg keypoints", leg_kp), ("random keypoints", rand)):
            k, q = kern(p, pts), plain(p, pts)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(k).all()), f"{kern.__name__}: a non-finite keypoint"
            differ[label] = int((k != q).any(-1).sum())
        print(f"kernel R {kern.__name__}: {leg_kp.shape[0]} keypoints of the {legs} legs' "
              f"{sum(len(recs[leg]['xy']) for leg in legs)} frames and {N} random ones over "
              f"the image; keypoints "
              f"not bit-equal to plain: {differ}")
        assert not any(differ.values()), f"{kern.__name__} is not bit-equal to its plain version"

    # ---- kernel A with an extraction mask ----
    params = OrbParams(num_levels=8)
    ex = ox.OrbExtractor(params, world.W, world.H, min_area=800, device=dev)
    img = torch.from_numpy(recs["fisheye"]["image"][0]).to(dev)
    levels = ex.pyramid(img)
    thr = (float(params.ini_fast_thr), float(params.min_fast_thr))
    half = np.ones((world.H, world.W), np.uint8)
    half[:, : world.W // 2] = 0
    masks = {"half": half,
             "random": (np.random.default_rng(19).random((world.H, world.W)) > 0.3)
             .astype(np.uint8),
             "vignette": ds.leg_mask("fisheye_masked", world)}

    pyr = torch.cat([l.reshape(-1) for l in levels])[None]

    def run_a(fn, m):
        return fn(pyr, ex._fast, *thr, m)

    unmasked = int(run_a(ox.fast_nms_pyramid, None)[3].sum())
    counts = {}
    for label, m in masks.items():
        mt = torch.from_numpy(m).to(dev)
        ka, pa = run_a(ox.fast_nms_pyramid, mt), run_a(ox.fast_nms_pyramid_plain, mt)
        torch.cuda.synchronize()
        assert all(torch.equal(k, q) for k, q in zip(ka, pa)), \
            f"kernel A with the {label} mask disagrees with its plain version"
        counts[label] = int(ka[3].sum())
    print(f"kernel A fast_nms_pyramid with a mask: cells with a corner over 8 levels {counts} "
          f"(unmasked {unmasked}), each bit-equal to plain")
    assert all(0 < c < unmasked for c in counts.values()), (counts, unmasked)
    mt = torch.from_numpy(half).to(dev)
    rows.append(dict(
        name="fast_nms_pyramid_masked", counter="fast_nms_pyramid", route="cuda",
        source="stella_vslam_tpu_torch/csrc/fast_nms.cu",
        replaces="stella_vslam_tpu/feature/orb_extractor.py:332", max_abs_err=0.0,
        shape="752x480, 8 levels, the half-image mask, one launch a frame",
        **_times(lambda: run_a(ox.fast_nms_pyramid, mt)),
        plain_ms=_median_ms(lambda: run_a(ox.fast_nms_pyramid_plain, mt)), library_ms=None,
        **fast_work(ex, pyr, mt)))
    return rows


def _fbow_work(desc, tab):
    """(popcount words, distinct blocks visited) of the descent of `desc`
    through the tables `tab`: what kernel V's loop runs for these
    descriptors."""
    import torch

    from stella_vslam_tpu_torch.data.fbow_io import _POPCOUNT8

    nblocks, m_k = tab.n_children.shape[0], tab.m_k
    N = desc.shape[0]
    pop = torch.from_numpy(_POPCOUNT8).to(desc.device)
    d8 = desc.view(torch.uint8).reshape(N, 1, 32)
    c8 = tab.centers.view(torch.uint8).reshape(nblocks, m_k, 32)
    info = tab.node_info.reshape(nblocks, m_k)
    kidx = torch.arange(m_k, device=desc.device)
    blk = torch.zeros(N, dtype=torch.int64, device=desc.device)
    done = torch.zeros(N, dtype=torch.bool, device=desc.device)
    words, seen = 0, []
    for _ in range(tab.max_depth):
        nc = tab.n_children[blk].clamp(max=m_k)
        words += int((nc * ~done).sum()) * 8
        seen.append(blk[~done])
        dist = pop[torch.bitwise_xor(d8, c8[blk]).long()].sum(-1)
        dist = torch.where(kidx[None] < nc[:, None], dist, torch.full_like(dist, 257))
        node = info[blk, torch.argmin(dist, -1)]
        leaf = node < 0
        blk = torch.where(done | leaf, blk, torch.clamp((node & 0x7FFFFFFF).long(),
                                                        max=nblocks - 1))
        done = done | leaf
    return words, int(torch.unique(torch.cat(seen)).numel())


def _fbow_row(name, desc, tab, **extra) -> dict:
    """Kernel V's kernels-line row on descriptors `desc` and tables `tab`:
    times, plain time, and the bound of this run's descent (bytes: the
    descriptors in, the word ids out, each visited block's centres,
    node_info and child count once; integer operations: XOR, popcount and
    add per word of every present child of every visited block)."""
    from stella_vslam_tpu_torch.data import fbow_io

    words, blocks = _fbow_work(desc, tab)
    nblocks, m_k, N = tab.n_children.shape[0], tab.m_k, desc.shape[0]
    return dict(
        name=name, route="cuda", source="stella_vslam_tpu_torch/csrc/bow_fbow.cu",
        replaces="stella_vslam_tpu/data/fbow_io.py:128 and "
                 "stella_vslam_tpu/data/bow_vocabulary.py:76", max_abs_err=0.0,
        shape=f"N={N}, {nblocks} blocks x {m_k}, depth {tab.max_depth}",
        blocks_visited=blocks, **extra,
        **_times(lambda: fbow_io.fbow_transform(desc, tab)),
        plain_ms=_median_ms(lambda: fbow_io.fbow_transform_plain(desc, tab), reps=10),
        library_ms=None,
        **_bound(36.0 * N + blocks * (m_k * 36.0 + 4.0), 0.0, int_ops=3.0 * words))


def synthetic_fbow_tables(dev, case: str, seed: int):
    """FBoW tables that the fixture and the .npz tree do not reach: "m_k=20"
    and "m_k=40" (blocks of up to 20 or 40 children, 1 to m_k present, three
    levels), "clamped" (m_k = 10, some interior children naming blocks past
    the last, which read the last block; a block with no child; the last
    block's children its own block, so a descent that reaches it ends
    without a leaf after max_depth rounds)."""
    import torch

    from stella_vslam_tpu_torch.data.fbow_io import FbowTables

    rng = np.random.default_rng(seed)
    m_k = {"m_k=20": 20, "m_k=40": 40, "clamped": 10}[case]
    depth = 3
    n_children, info, levels, word = [], [], [0], 0
    b = 0
    while b < len(levels):
        nc = m_k if b == 0 else int(rng.integers(1, m_k + 1))
        row = np.zeros(m_k, np.uint32)
        for k in range(m_k):
            if levels[b] + 1 < depth and k < nc and rng.random() < 0.7 and len(levels) < 300:
                row[k] = len(levels)
                levels.append(levels[b] + 1)
            else:
                row[k] = 0x80000000 | word
                word += 1
        n_children.append(nc)
        info.append(row)
        b += 1
    info, n_children = np.stack(info), np.array(n_children, np.int32)
    nblocks = len(levels)
    if case == "clamped":
        interior = np.nonzero((info[0] & 0x80000000) == 0)[0]
        info[0, interior[:2]] = nblocks + np.array([5, 1000])  # past the last block
        n_children[1] = 0
        info[-1] = nblocks - 1  # the last block: children its own block
    centers = rng.integers(0, 2 ** 32, (nblocks * m_k, 8), dtype=np.uint64).astype(np.uint32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
    return FbowTables(centers=up(centers), node_info=up(info.reshape(-1)),
                      n_children=torch.from_numpy(n_children).to(dev), m_k=m_k,
                      max_depth=depth + (1 if case == "clamped" else 0))


def check_fbow_kernels(dev, recorded):
    """Kernel V against its plain version on the card, exactly: on the
    fixture tree (tests/data/reference_layout_vocab.fbow) with 2872 random
    descriptors and with the descriptors of every keyframe event of the
    FBoW leg; on the .npz vocabulary's tree through BowVocabulary.transform
    (one launch), whose tables must equal those read_fbow gives for the
    same tree written by write_fbow; on synthetic trees with more than 16
    children a block and with clamped child blocks. Returns the kernels
    line's row of the fixture tree."""
    import tempfile

    import torch

    from stella_vslam_tpu_torch.data import fbow_io
    from stella_vslam_tpu_torch.data.bow_vocabulary import BowVocabulary
    from stella_vslam_tpu_torch.util.fbow_slice import FIXTURE

    vocab = fbow_io.read_fbow(FIXTURE, dev)
    tab = vocab.tables()
    N = 2872
    rand = torch.as_tensor(np.random.default_rng(23).integers(
        0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32).view(np.int32), device=dev)
    leg = torch.cat(recorded).contiguous()
    checked = {}
    for label, d in (("random", rand), ("FBoW leg keyframes", leg)):
        k, q = fbow_io.fbow_transform(d, tab), fbow_io.fbow_transform_plain(d, tab)
        torch.cuda.synchronize()
        checked[label] = (d.shape[0], int((k != q).sum()), int(torch.unique(k).numel()))
    npz = BowVocabulary.default(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "default.fbow")
        npz.save_fbow(path)
        full = fbow_io.read_fbow(path, dev)
    ftab, ntab = full.tables(), npz.tables()
    same_tables = all(torch.equal(a, b) for a, b in zip(ftab[:3], ntab[:3])) \
        and (ftab.m_k, ftab.max_depth) == (ntab.m_k, ntab.max_depth)
    before = fbow_io.fbow_transform.launches
    m = npz.transform(rand)
    one_launch = fbow_io.fbow_transform.launches == before + 1
    q = fbow_io.fbow_transform_plain(rand, ntab)
    torch.cuda.synchronize()
    checked[".npz tree"] = (N, int((m != q).sum()), int(torch.unique(m).numel()))
    for case in ("m_k=20", "m_k=40", "clamped"):
        stab = synthetic_fbow_tables(dev, case, seed=17)
        k, q = fbow_io.fbow_transform(rand, stab), fbow_io.fbow_transform_plain(rand, stab)
        torch.cuda.synchronize()
        checked[f"synthetic {case}"] = (N, int((k != q).sum()), int(torch.unique(k).numel()))
    print(f"kernel V fbow_transform (descriptors, word ids differing from plain, distinct "
          f"words): {checked}; the .npz tree's tables equal read_fbow(write_fbow()): "
          f"{same_tables}, its transform one launch: {one_launch}")
    assert not any(v[1] for v in checked.values()), "kernel V disagrees with its plain version"
    assert same_tables and one_launch, "kernel V's .npz route is not the FBoW tables' one launch"
    return [_fbow_row("fbow_transform", rand, tab)]


def save_bow_pnp_inputs(loop_rec, fbow_desc, path=None):
    """Save kernels V's and N's recorded inputs for
    scripts/torch_bow_pnp_probe.py (chiprun_out/bow_pnp_inputs.pt): the loop
    slice's keyframe descriptors and PnP calls, the FBoW leg's keyframe
    descriptors."""
    import torch

    cpu = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t
    torch.save(dict(
        loop_desc=[cpu(a[0][0]) for a in loop_rec["bow"][:8]],
        pnp=[(int(a[0]),) + tuple(cpu(x) for x in a[1:5]) + (cpu(kw["scale_factors"]),)
             for a, kw in loop_rec["pnp"][:4]],
        fbow_desc=[cpu(d) for d in fbow_desc[:8]]),
        path or os.path.join(OUT_DIR, "bow_pnp_inputs.pt"))


def run_fbow_leg(dev, world, wrappers, card):
    """The FBoW leg (util/fbow_slice.py): the threaded circuit with the
    fixture .fbow vocabulary, every launch count at 0 just before it and read
    just after it, with the leg's gates: kernel V once per keyframe event.
    Returns (stats, launches, the recorded descriptors of
    every keyframe event)."""
    from stella_vslam_tpu_torch.util import fbow_slice as fs

    slam = fs.make_system(world, dev)
    recorded = []
    vocab = slam.bow_vocab
    transform = vocab.transform

    def rec(desc):
        recorded.append(desc)
        return transform(desc)

    vocab.transform = rec
    for w in wrappers.values():
        w.launches = 0
    try:
        s = fs.run_leg(dev, world, slam=slam)
    finally:
        del vocab.transform
    launches = {k: w.launches for k, w in wrappers.items()}
    s.pop("launches")
    with open(os.path.join(OUT_DIR, "fbow_leg.json"), "w") as f:
        json.dump(dict(s, launches=launches, card=card), f, indent=1)
    brief = {k: v for k, v in s.items() if k not in ("loop_event_ms",)}
    print("fbow leg: " + json.dumps(dict(brief, card=card)))
    print("fbow leg launches: " + json.dumps(launches))
    for e in slam.worker_error_log:
        print("worker error:\n" + e)
    try:
        fs.check_gates(dict(s, launches=launches))
    except AssertionError:
        # the leg's statistics beside the failure, on the error stream too
        print("fbow leg failed its gates: " + json.dumps(dict(
            {k: s[k] for k in ("ate_m", "ate_breakdown", "sim3_scale", "lost_after_init",
                               "loops_closed", "keyframes_created", "keyframes_kept",
                               "worker_errors")},
            loop_pairs=[e.get("keyframes") for e in s["loop_event_ms"]],
            pose_graph=slam.global_optimizer._last_pose_graph_edges)), file=sys.stderr)
        raise
    assert launches["fbow_transform"] == s["keyframes_created"] > 0, \
        f"fbow: {launches['fbow_transform']} launches of V, {s['keyframes_created']} events"
    assert len(recorded) == s["keyframes_created"]
    return s, launches, recorded


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "main path runs on the GPU only", file=sys.stderr)
        return 1
    from stella_vslam_tpu_torch.kernels import build as kbuild
    from stella_vslam_tpu_torch.util import map_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t_run = t0 = time.monotonic()
    kbuild.load()
    print(f"build: {time.monotonic() - t0:.2f} s (nvcc {kbuild.build_seconds:.2f} s, "
          f"one process per source) [{card}]")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(kbuild.build_log)
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # wall-clock seconds of each phase (host clock, the card synchronised by
    # the phases' own reads), printed before the slices line
    phase_s, t_lap = {}, [t_run]

    def lap(name):
        now = time.monotonic()
        phase_s[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    lap("build")
    world = bench_world()
    rows = check_kernels(dev, world) + check_init_kernels(dev, world)
    rows += check_track_kernels(dev, world)
    rows += check_frame_finish(dev, world)
    rows += check_stereo_kernels(dev, world)
    lap("kernel_checks")
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}) "
              f"[{card}]")

    wrappers = map_slice.kernel_wrappers()
    rgbd, mono, launches = run_slices(dev, world, wrappers, card)
    hd, launches["hd"] = run_hd_slice(dev, wrappers, card)
    lap("rgbd_mono_hd_slices")
    undo_cache = cache_renders(world)
    loop, launches["loop"], slam, inputs, loop_rec = run_loop_slice(dev, world, wrappers, card)
    lap("loop_slice")
    twice, _, launches["sharded"] = rerun_loop_slice(dev, world, slam, wrappers, card)
    undo_cache()
    lap("sharded_loop_slice")
    twice["ate_m"][0], twice["loops"][0] = loop["ate_m"], loop["loops_closed"]
    print("loop slice twice in one process (the second sharded): " + json.dumps(twice))
    map_rows = check_mapping_kernels(dev, slam.mapper, inputs)
    check_octave_ceils(dev, slam.tracker.kernels, slam.mapper.kernels)
    map_rows += check_loop_kernels(dev, slam, loop_rec)
    map_rows += check_sharded_ba(dev, loop_rec, slam.mapper.cam_scalars)
    repeat = check_repeatability(dev, loop_rec, slam.mapper.cam_scalars)
    check_solves_under_load(dev)
    check_cascade_under_load(dev)
    lap("mapping_loop_sharded_checks")
    threaded, launches["threaded"], tslam, assoc_rec = run_threaded_slice(
        dev, world, wrappers, card)
    check_recorded_assoc(assoc_rec)
    check_recorded_matches(assoc_rec["match"])
    check_recorded_rows(assoc_rec["rows"], "threaded slice")
    lap("threaded_slice")
    legs, leg_launches = run_stereo_legs(dev, world, wrappers, card)
    lap("stereo_rgbd_legs")
    eq, eq_launches, esc_launches, eq_calls, eslam = run_equirect_leg(dev, wrappers, card)
    map_rows += check_equirect_shapes(dev, eslam, eq_calls)
    map_rows += check_equirect_kernels(dev, eslam, eq_calls)
    lap("equirect_leg_and_checks")
    dist, dist_launches, dist_recs = run_distorted_legs(dev, world, wrappers, card)
    map_rows += check_distorted_kernels(dev, world, dist_recs)
    lap("distorted_legs_and_checks")
    fbow, fbow_launches, fbow_desc = run_fbow_leg(dev, world, wrappers, card)
    map_rows += check_fbow_kernels(dev, fbow_desc)
    save_bow_pnp_inputs(loop_rec, fbow_desc)
    lap("fbow_leg_and_checks")
    for r in map_rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}) "
              f"[{card}]")
    rows += map_rows
    for row in rows:
        row_name = row["name"]
        name = row.pop("counter", row_name)
        equirect = name in EQUIRECT_ROWS
        name = EQUIRECT_ROWS.get(name, name)
        for suffix in ("_map_local", "_local", "_global32", "_global64"):
            name = name.removesuffix(suffix)
        # `launches`: on the path of the slice that ported the kernel (the
        # stereo leg for S, B's strip mode and T; the equirectangular leg
        # for the equirectangular modes and E's MODEL 2, its escalation run
        # for U; the threaded slice for the rest), every slice's beside it
        row["launches"] = (esc_launches if name in EQUIRECT_KERNELS
                           else eq_launches if equirect
                           else leg_launches["stereo"] if name in STEREO_PATH_ROWS
                           else launches["threaded"])[name]
        # the distorted legs' rows (R's modes, A with a mask) and V: their
        # own leg's count
        if row_name in DISTORTED_ROWS:
            leg, counter = DISTORTED_ROWS[row_name]
            row["launches"] = dist_launches[leg][counter]
        elif row_name in FBOW_KERNELS:
            row["launches"] = fbow_launches[name]
        elif name in SHARDED_KERNELS:
            row["launches"] = launches["sharded"][name]
        elif row_name in HD_ROWS:
            row["launches"] = launches["hd"][name]
        row["launches_hd_rgbd_slice"] = launches["hd"][name]
        row["launches_sharded_loop_slice"] = launches["sharded"][name]
        row["launches_fisheye_leg"] = dist_launches["fisheye"][name]
        row["launches_radial_division_leg"] = dist_launches["radial_division"][name]
        row["launches_fisheye_masked_leg"] = dist_launches["fisheye_masked"][name]
        row["launches_fbow_leg"] = fbow_launches[name]
        row["launches_equirect_leg"] = eq_launches[name]
        row["launches_equirect_escalation_run"] = esc_launches[name]
        row["launches_stereo_leg"] = leg_launches["stereo"][name]
        row["launches_rgbd_mapping_leg"] = leg_launches["RGBD"][name]
        row["launches_threaded_slice"] = launches["threaded"][name]
        row["launches_loop_slice"] = launches["loop"][name]
        row["launches_mono_slice"] = launches["mono"][name]
        row["launches_rgbd_slice"] = launches["rgbd"][name]
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump({"card": card, "kernels": rows}, f, indent=1)
    # the slices in short, near the end of the output
    print("slices: " + json.dumps(dict(
        card=card, rgbd_ate_m=rgbd["ate_m"], mono_ate_m=mono["ate_m"],
        mono_init_frame=mono["init_frame"], map_ate_m=loop["map_slice_ate_m"],
        **{"loop_" + k: loop[k] for k in (
            "ate_m", "tracked", "lost_after_init", "loops_closed", "loop_frames",
            "keyframes_created", "keyframes_kept", "loop_event_ms", "solver_shapes",
            "frame_ms")},
        loop_twice_bit_identical=twice["poses_bit_identical"], loop_twice_ate_m=twice["ate_m"],
        loop_twice_first_differing_frame=twice["first_differing_frame"],
        sharded_loop_w_launches=launches["sharded"]["ba_shard_assemble"],
        **{"hd_rgbd_" + k: hd[k] for k in (
            "slots", "tracked", "lost_after_init", "ate_m", "frame_ms_p50", "frame_ms_p99")},
        hd_rgbd_dedup_launches=launches["hd"]["dedup_by_id"],
        f_p_repeat_bit_identical=all(repeat.values()),
        **{"threaded_" + k: threaded[k] for k in (
            "ate_m", "tracked", "lost_after_init", "loops_closed", "keyframes_created",
            "keyframes_kept", "local_bas", "local_ba_skips", "frame_ms", "keyframe_event_ms",
            "loop_event_phase_ms", "rebases", "drain_fallbacks", "feed_wait_s",
            "worker_errors", "fps", "frames_per_wall_s")},
        threaded_sync_per_dispatch=threaded["sync_per_dispatch"]["per_dispatch"],
        **{f"{leg.lower()}_leg_" + k: legs[leg][k] for leg in legs for k in (
            "ate_m", "scale_err", "tracked", "lost_after_init", "keyframes_created",
            "keyframes_kept", "local_bas", "loops_closed", "frame_ms", "keyframe_event_ms",
            "worker_errors", "fps", "frames_per_wall_s")},
        **{"equirect_leg_" + k: eq[k] for k in (
            "init_frame", "tracked", "lost_after_init", "ate_m", "keyframes_created",
            "keyframes_kept", "local_bas", "loops_closed", "init_escalations", "frame_ms",
            "fps", "frames_per_wall_s", "worker_errors")},
        equirect_escalation_run_u_launches=esc_launches["essential_5pt"],
        **{f"{leg}_leg_" + k: dist[leg][k] for leg in dist for k in (
            "init_frame", "tracked", "lost_after_init", "ate_m", "keyframes_created",
            "keyframes_kept", "local_bas", "frame_ms", "fps", "worker_errors")},
        fisheye_masked_leg_masked_launches=dist_launches["fisheye_masked"][
            "fast_nms_pyramid_masked"],
        **{"fbow_leg_" + k: fbow[k] for k in (
            "ate_m", "tracked", "lost_after_init", "loops_closed", "keyframes_created",
            "keyframes_kept", "local_bas", "frame_ms", "fps", "worker_errors", "vocab_words")},
        fbow_leg_v_launches=fbow_launches["fbow_transform"])))
    print("phase seconds: " + json.dumps(phase_s))
    print(f"chip_smoke: {time.monotonic() - t_run:.1f} s from the build on [{card}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
