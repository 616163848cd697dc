"""Keyframe inverted index for place recognition.

Reference: src/stella_vslam/data/bow_database.{h,cc} — word-id -> keyframe
lists; acquire_keyframes: shared-word counting -> min common words =
ratio * max -> L1 similarity scores above min_score -> covisibility-
accumulated score filtering (sum each candidate's score over its top-10
covisibility cluster, keep clusters >= 0.75 x best cluster, return the
best-scoring keyframe of each surviving cluster) — bow_database.cc:58-162.

Host only: a copy of stella_vslam_tpu/data/bow_database.py (the port imports
nothing of that package).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set


class BowDatabase:
    def __init__(self, vocab):
        self.vocab = vocab
        self.keyfrms_in_word: Dict[int, Set[int]] = {}
        self.bow_vecs: Dict[int, dict] = {}  # keyframe id -> bow vector

    def add_keyframe(self, kf_id: int, bow_vec: dict):
        self.bow_vecs[kf_id] = bow_vec
        for w in bow_vec:
            self.keyfrms_in_word.setdefault(w, set()).add(kf_id)

    def erase_keyframe(self, kf_id: int):
        vec = self.bow_vecs.pop(kf_id, None)
        if vec is None:
            return
        for w in vec:
            s = self.keyfrms_in_word.get(w)
            if s is not None:
                s.discard(kf_id)

    def clear(self):
        self.keyfrms_in_word = {}
        self.bow_vecs = {}

    # ------------------------------------------------------------------
    def acquire_keyframes(
        self,
        bow_vec: dict,
        min_score: float = 0.0,
        num_common_words_thr_ratio: float = 0.8,
        reject: Set[int] = frozenset(),
        keyframes: Optional[dict] = None,
    ) -> List[int]:
        """Returns candidate keyframe ids, best first.

        When `keyframes` (id -> Keyframe with .graph_node) is given, apply
        the reference's covisibility-accumulated score filtering
        (bow_database.cc:99-162): each candidate's score is summed over its
        top-10 covisibilities that are themselves candidates; only clusters
        with accumulated score >= 0.75 x the best cluster survive, and each
        surviving cluster contributes its single best-scoring keyframe.
        """
        common: Dict[int, int] = {}
        for w in bow_vec:
            for kf_id in self.keyfrms_in_word.get(w, ()):
                if kf_id in reject:
                    continue
                common[kf_id] = common.get(kf_id, 0) + 1
        if not common:
            return []
        max_common = max(common.values())
        thr = num_common_words_thr_ratio * max_common
        scored: Dict[int, float] = {}
        for kf_id, n in common.items():
            if n <= thr:
                continue
            s = self.vocab.score(bow_vec, self.bow_vecs.get(kf_id, {}))
            if s >= min_score:
                scored[kf_id] = s
        if not scored:
            return []
        if keyframes is None:
            return [k for k, _ in sorted(scored.items(), key=lambda kv: -kv[1])]

        # covisibility-accumulated filtering (bow_database.cc:99-162)
        clusters = []  # (accumulated score, best score in cluster, best id)
        best_accum = 0.0
        for kf_id, s in scored.items():
            kf = keyframes.get(kf_id)
            if kf is None or kf.will_be_erased:
                continue
            accum, best_s, best_id = s, s, kf_id
            for cov_id in kf.graph_node.get_top_n_covisibilities(10):
                cs = scored.get(cov_id)
                if cs is None:
                    continue
                cov_kf = keyframes.get(cov_id)
                if cov_kf is None or cov_kf.will_be_erased:
                    continue
                accum += cs
                if cs > best_s:
                    best_s, best_id = cs, cov_id
            clusters.append((accum, best_s, best_id))
            best_accum = max(best_accum, accum)
        cluster_thr = 0.75 * best_accum
        best_of: Dict[int, float] = {}
        for accum, best_s, best_id in clusters:
            if accum >= cluster_thr:
                if best_s > best_of.get(best_id, -1.0):
                    best_of[best_id] = best_s
        return [k for k, _ in sorted(best_of.items(), key=lambda kv: -kv[1])]
