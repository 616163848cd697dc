"""Carry state from the JAX package into the port.

Tests feed both implementations identical state: these functions read the
JAX objects' arrays through `np.asarray` only (this module imports no jax)
and return the port's tensors.

* `extractor_tables`: an OrbExtractor's constant tables (resize matrices,
  blur taps, moment masks, steered BRIEF offsets) in the form
  `feature.orb_extractor.OrbExtractor(tables=...)` takes;
* `table_snap`: a TableSnap's packed device landmark table;
* `frame_features`: a frame's FrameFeatures;
* `frame`: a whole frame (features, undistorted keypoints, bearings), the
  input of the initializer;
* `ba_problem`: a BAProblem;
* `map_database`: a whole MapDatabase (keyframes with their frames' arrays,
  poses and covisibility graph, landmarks with their fields and counters,
  the native store's observations in the store's own order, the device
  table's pending counters), and `mapper_state`, a MappingModule's
  carried state, so both packages can run a keyframe event from one state;
* `bow_vocabulary`: a BowVocabulary with the JAX vocabulary's centers,
  `fbow_vocabulary`: an FbowVocabulary with a JAX FBoW vocabulary's tables,
  and `bow_database`: a BowDatabase with its BoW vectors and inverted index, so
  both can detect and close a loop from one state (`map_database` carries
  the loop edges and spanning roots).
"""
from __future__ import annotations

import numpy as np
import torch

from stella_vslam_tpu_torch.feature.orb_extractor import (
    ANGLE_BINS, FrameFeatures, _DESC_R, _DESC_W, _MOM_OFF, _RAW_W)


def extractor_tables(jax_extractor) -> dict:
    ex = jax_extractor
    resize = [(np.array(R, np.float32), np.array(C, np.float32))
              for R, C in ex._resize_mats]
    blur = np.asarray(ex._blur_matrix, np.float32)  # [39*39, 45*45]
    taps = blur[0].reshape(_RAW_W, _RAW_W)[:7, :7].copy()
    mom = np.asarray(ex._moment_vecs, np.float32).reshape(_RAW_W, _RAW_W, 2)
    k10 = mom[_MOM_OFF:_MOM_OFF + 31, _MOM_OFF:_MOM_OFF + 31, 0].copy()
    k01 = mom[_MOM_OFF:_MOM_OFF + 31, _MOM_OFF:_MOM_OFF + 31, 1].copy()
    # each bit-matrix row holds +1 at pair endpoint 1 and -1 at endpoint 0;
    # a pair whose rotated endpoints coincide has an all-zero row and a bit
    # that is always 0, which equal endpoints reproduce
    W = np.asarray(ex._bit_matrix).astype(np.float32).reshape(ANGLE_BINS, 256, -1)
    centre = _DESC_R * _DESC_W + _DESC_R
    i1 = np.where((W == 1).any(-1), np.argmax(W == 1, -1), centre)
    i0 = np.where((W == -1).any(-1), np.argmax(W == -1, -1), centre)
    offsets = np.stack([i0 % _DESC_W, i0 // _DESC_W, i1 % _DESC_W, i1 // _DESC_W],
                       -1).astype(np.int8)
    return {"resize": resize, "taps": taps, "k10": k10, "k01": k01,
            "offsets": offsets}


def table_snap(snap, device="cuda"):
    """-> (tbl_f32 [C,8] f32, tbl_u32 [C,10] int32 with the uint32 bits)."""
    f32 = np.asarray(snap.tbl_f32, np.float32)
    u32 = np.ascontiguousarray(np.asarray(snap.tbl_u32, np.uint32))
    return (torch.from_numpy(f32.copy()).to(device),
            torch.from_numpy(u32.view(np.int32).copy()).to(device))


def frame_features(feats, device="cuda") -> FrameFeatures:
    desc = np.ascontiguousarray(np.asarray(feats.desc, np.uint32)).view(np.int32)
    t = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt)).to(device)
    return FrameFeatures(
        xy=t(feats.xy, np.float32), response=t(feats.response, np.float32),
        angle=t(feats.angle, np.float32), level=t(feats.level, np.int32),
        valid=t(feats.valid, bool), desc=torch.from_numpy(desc.copy()).to(device))


def frame(jax_frame, camera, orb_params, device="cuda"):
    """A port Frame with the JAX frame's features, undistorted keypoints,
    bearings, x_right and depths (and its timestamp); landmarks and pose
    start empty."""
    from stella_vslam_tpu_torch.data.frame import Frame, pack_host_cols

    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    feats = frame_features(jax_frame.feats, device)
    frm = Frame(jax_frame.timestamp, camera, orb_params, feats,
                t(jax_frame.undist_xy), t(jax_frame.bearings),
                x_right=t(jax_frame.x_right), depths=t(jax_frame.depths))
    frm.attach_packed_host(pack_host_cols(
        feats.xy, frm.undist_xy, frm.bearings, feats.level, feats.angle,
        feats.valid, feats.response, frm.x_right, frm.depths, feats.desc))
    return frm


def ba_problem(jax_prob, device="cuda"):
    """The port's BAProblem with the same arrays (optional fields kept)."""
    from stella_vslam_tpu_torch.ops.optim.ba import BAProblem

    return BAProblem(**{
        name: None if v is None else torch.from_numpy(np.array(v)).to(device)
        for name, v in jax_prob._asdict().items()})


def map_database(jax_map_db, camera, orb_params, device="cuda"):
    """The port's MapDatabase holding the JAX database's state."""
    from stella_vslam_tpu_torch.data.keyframe import Keyframe
    from stella_vslam_tpu_torch.data.landmark import Landmark
    from stella_vslam_tpu_torch.data.map_database import MapDatabase

    j = jax_map_db
    md = MapDatabase(min_num_shared_lms=j.min_num_shared_lms,
                     device_table_capacity=j.device_table.capacity, device=device)
    md._next_keyfrm_id, md._next_landmark_id = j._next_keyfrm_id, j._next_landmark_id
    md.spanning_roots = list(j.spanning_roots)
    md.fixed_keyframe_id_threshold = j.fixed_keyframe_id_threshold
    md.replaced_ids = dict(j.replaced_ids)
    md.erased_kf_forward = {k: (p, np.array(T)) for k, (p, T) in j.erased_kf_forward.items()}
    for kid in sorted(j.keyframes):
        jk = j.keyframes[kid]
        frm = frame(jk._frame_ref, camera, orb_params, device)
        frm.set_pose_cw(jk.pose_cw)
        kf = Keyframe(frm, md, keyfrm_id=kid)
        kf.src_frm_id = jk.src_frm_id
        kf.lm_ids = np.array(jk.lm_ids, np.int64)
        kf._pose_at_creation = np.array(jk._pose_at_creation)
        kf.will_be_erased, kf._not_to_be_erased = jk.will_be_erased, jk._not_to_be_erased
        g, jg = kf.graph_node, jk.graph_node
        g.connections, g._ordered_ids = dict(jg.connections), list(jg._ordered_ids)
        g.spanning_parent = jg.spanning_parent
        g.spanning_children, g.loop_edges = set(jg.spanning_children), set(jg.loop_edges)
        md.keyframes[kid] = kf
        md.assoc_store.register_keyframe(kid, kf.h_desc, kf.h_level)
    store = j.assoc_store
    for lid in sorted(j.landmarks):
        jl = j.landmarks[lid]
        lm = Landmark(lid, jl.pos_w, jl.ref_keyfrm_id)
        lm.descriptor = np.array(jl.descriptor, np.uint32)
        lm.mean_normal = np.array(jl.mean_normal)
        lm.min_valid_dist, lm.max_valid_dist = jl.min_valid_dist, jl.max_valid_dist
        for name in ("num_observable", "num_observed", "first_keyfrm_id", "replaced_id",
                     "num_observations_when_created"):
            setattr(lm, name, getattr(jl, name))
        lm.observations = dict(jl.observations)
        md.landmarks[lid] = lm
        lm._store = md.assoc_store
        md.fields.attach(lm)
        # the native store's own order of this landmark's observations
        kfs, idxs = store.get_obs(lid)
        md.assoc_store.add_bulk(np.full(len(kfs), lid, np.int64), kfs, idxs)
    # the observability counts not yet folded into the landmarks; the
    # table itself is published by the next refresh
    jt, t = j.device_table, md.device_table
    t.version = jt.version
    t._pend_observable = np.array(jt._pend_observable)
    t._pend_observed = np.array(jt._pend_observed)
    return md


def mapper_state(jax_mapper, mapper):
    """Carry a JAX MappingModule's state between events into the port's
    (whose map must be `map_database` of the JAX one)."""
    md = mapper.map_db
    mapper.cleaner.fresh_landmark_ids = list(jax_mapper.cleaner.fresh_landmark_ids)
    mapper._dirty_stats = {i: md.landmarks[i] for i in jax_mapper._dirty_stats
                           if i in md.landmarks}
    mapper._fresh_fuse = None
    if jax_mapper._fresh_fuse is not None:
        kf, ids = jax_mapper._fresh_fuse
        mapper._fresh_fuse = (md.keyframes[kf.id], list(ids))


def bow_vocabulary(jax_vocab, device="cuda"):
    """The port's BowVocabulary with the JAX vocabulary's centers."""
    from stella_vslam_tpu_torch.data.bow_vocabulary import BowVocabulary

    v = BowVocabulary(device=device)
    v.set_centers([np.array(c, np.float32) for c in jax_vocab.centers])
    return v


def fbow_vocabulary(jax_vocab, device="cuda"):
    """The port's FbowVocabulary with a JAX FbowVocabulary's tables
    (numpy arrays, carried across as they are)."""
    from stella_vslam_tpu_torch.data.fbow_io import FbowVocabulary

    v = FbowVocabulary(np.array(jax_vocab.centers_pm1, np.float32),
                       np.array(jax_vocab.node_info, np.uint32),
                       np.array(jax_vocab.n_children, np.int32), jax_vocab.max_depth,
                       jax_vocab.desc_name, device=device)
    v.weights = None if jax_vocab.weights is None else np.array(jax_vocab.weights)
    v.num_words = int(jax_vocab.num_words)
    return v


def bow_database(jax_bow_db, vocab):
    """The port's BowDatabase with the JAX database's BoW vectors and
    inverted index (word -> keyframe ids)."""
    from stella_vslam_tpu_torch.data.bow_database import BowDatabase

    db = BowDatabase(vocab)
    db.bow_vecs = {int(k): dict(v) for k, v in jax_bow_db.bow_vecs.items()}
    db.keyfrms_in_word = {int(w): set(ids) for w, ids in jax_bow_db.keyfrms_in_word.items()}
    return db
