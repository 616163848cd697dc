"""Ground-truth poses of the synthetic plane world, and synthetic odometric
drift for loop-closure runs.

Copy of stella_vslam_tpu/util/drift.py (numpy only). The renderers are
geometrically perfect, so an out-and-back run accumulates almost no drift
and a revisit stays covisible: the loop detector rightly never fires.
`inject_segment_drift` makes the state a drifted monocular run reaches at
revisit time: an SE3 offset applied to the old segment of the map, with the
observations across the two segments severed, so that only the loop-closing
path (BoW candidates -> Sim3 validation -> correction -> pose graph ->
global BA) can stitch the map together again. Used by util/loop_slice.py and
the loop tests.
"""
import numpy as np


def pose_at_x(x: float) -> np.ndarray:
    """Camera at world (x, 0, 0), looking +Z at the plane (R = I)."""
    T = np.eye(4)
    T[:3, 3] = [-x, 0.0, 0.0]
    return T


def pose_at_xy(x: float, y: float) -> np.ndarray:
    """Camera at world (x, y, 0), looking +Z at the plane (R = I)."""
    T = np.eye(4)
    T[:3, 3] = [-x, -y, 0.0]
    return T


def make_drift_se3(tx: float, yaw_deg: float) -> np.ndarray:
    c, s = np.cos(np.deg2rad(yaw_deg)), np.sin(np.deg2rad(yaw_deg))
    T = np.eye(4)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[0, 3] = tx
    return T


def inject_segment_drift(slam, tx_metric: float, yaw_deg: float,
                         cutoff_frac: float, gt_span_metric: float):
    """Move the old map segment (keyframes in the first `cutoff_frac` of the
    map's x-span, plus the landmarks they first observed) by an SE3 drift,
    severing cross-segment observations first. Leaves the live tracking state
    (recent segment) untouched; the tracker re-anchors itself on the next
    dispatch via the device-table version bump.

    The monocular map lives at an arbitrary gauge scale (median-depth
    normalized at init), so the metric drift translation is converted to map
    units via the estimated scale before being applied. Returns the moved
    keyframe ids and the applied transform."""
    slam.tracker.finalize_pending()
    md = slam.map_db
    with md.lock:
        span_map = max(
            kf.cam_center[0] for kf in md.keyframes.values()
            if not kf.will_be_erased
        )
    scale = span_map / gt_span_metric
    T_s = make_drift_se3(tx_metric * scale, yaw_deg)
    cutoff_x = cutoff_frac * span_map
    R_s, t_s = T_s[:3, :3], T_s[:3, 3]
    S_inv = np.linalg.inv(T_s)
    with md.lock:
        old_kfs = {
            k for k, kf in md.keyframes.items()
            if not kf.will_be_erased and kf.cam_center[0] <= cutoff_x
        }
        assert len(old_kfs) >= 3, "world/trajectory too small for the test"
        # partition landmarks by the keyframe that created them
        moved = [
            lm_id for lm_id, lm in md.landmarks.items()
            if not lm.will_be_erased and lm.first_keyfrm_id in old_kfs
        ]
        # sever cross-segment observations (both directions), then move
        for lm_id in moved:
            lm = md.landmarks.get(lm_id)
            if lm is None:
                continue
            for kf_id in [k for k in lm.observations if k not in old_kfs]:
                idx = lm.observations[kf_id]
                lm.erase_observation(kf_id)
                md.keyframes[kf_id].erase_landmark_with_index(idx)
            if lm.num_observations() < 2:
                md.erase_landmark(lm_id)
                continue
            lm.pos_w = R_s @ lm.pos_w + t_s
        moved_set = set(moved)
        for lm_id, lm in list(md.landmarks.items()):
            if lm_id in moved_set or lm.will_be_erased:
                continue
            for kf_id in [k for k in lm.observations if k in old_kfs]:
                idx = lm.observations[kf_id]
                lm.erase_observation(kf_id)
                md.keyframes[kf_id].erase_landmark_with_index(idx)
            if lm.num_observations() < 2:
                md.erase_landmark(lm_id)
        for k in old_kfs:
            kf = md.keyframes.get(k)
            if kf is not None:
                kf.set_pose_cw(kf.pose_cw @ S_inv)
        # symmetrize slot <-> observation state BEFORE rebuilding the
        # covisibility graph: any keyframe slot whose landmark does not list
        # that exact (keyframe, slot) observation is stale and must drop,
        # otherwise covisibility counting resurrects severed cross-seam edges
        for k, kf in md.keyframes.items():
            if kf.will_be_erased:
                continue
            for idx in np.nonzero(kf.lm_ids >= 0)[0]:
                lm = md.landmarks.get(int(kf.lm_ids[idx]))
                if lm is None or lm.observations.get(k) != int(idx):
                    kf.lm_ids[idx] = -1
        for lm in md.landmarks.values():
            for k in [k for k, idx in lm.observations.items()
                      if k not in md.keyframes
                      or int(md.keyframes[k].lm_ids[idx]) != lm.id]:
                lm.erase_observation(k)
        # rebuild covisibility for everyone (connections crossing the seam
        # must drop so the loop detector's reject set is honest)
        for kf in md.keyframes.values():
            if not kf.will_be_erased:
                kf.graph_node.connections = {}
                kf.graph_node._ordered_ids = []
        for kf in md.keyframes.values():
            if not kf.will_be_erased:
                kf.graph_node.update_connections(md)
        for lm in md.landmarks.values():
            if not lm.will_be_erased:
                lm.compute_descriptor(md)
                lm.update_mean_normal_and_obs_scale_variance(md)
        # sanity: the two segments must share no observation after severing
        moved_alive = {m for m in moved_set if m in md.landmarks}
        for lm_id, lm in md.landmarks.items():
            obs_old = {k for k in lm.observations if k in old_kfs}
            if lm_id in moved_alive:
                assert len(obs_old) == len(lm.observations), \
                    f"moved lm {lm_id} still observed by new keyframes"
            else:
                assert not obs_old, f"unmoved lm {lm_id} still observed by old keyframes"
        # repair keyframe slots that still reference the moved segment
        # (guards against any stale slot left by replace/fusion tombstones)
        for k, kf in md.keyframes.items():
            if k in old_kfs or kf.will_be_erased:
                continue
            for idx in np.nonzero(kf.lm_ids >= 0)[0]:
                if int(kf.lm_ids[idx]) in moved_alive:
                    kf.lm_ids[idx] = -1
    # purge the live tracking chain of associations into the moved segment —
    # under real accumulated drift those associations would never have formed
    # (stale ones would otherwise flow into the next keyframe and bridge the
    # two segments through the covisibility graph)
    tr = slam.tracker
    if tr.last_frm is not None:
        ids = tr.last_frm.lm_ids
        for i in np.nonzero(ids >= 0)[0]:
            if int(ids[i]) in moved_alive:
                ids[i] = -1
    md.refresh_device_table(center_kf_id=slam.tracker.ref_keyfrm_id)
    slam._injected_moved = moved_alive  # for tests/diagnostics
    return old_kfs, T_s
