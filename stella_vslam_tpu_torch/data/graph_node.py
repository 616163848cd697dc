"""Covisibility graph node + spanning tree.

Reference: src/stella_vslam/data/graph_node.{h,cc} — weighted connections
(>= min shared landmarks, default 15), ordered covisibility lists, spanning
tree parent/children. Copy of the part of stella_vslam_tpu/data/graph_node.py
the RGBD tracking slice calls (update_connections at map creation).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set


class GraphNode:
    def __init__(self, owner_keyfrm, min_num_shared_lms: int = 15):
        self.owner = owner_keyfrm
        self.min_num_shared_lms = min_num_shared_lms
        self.connections: Dict[int, int] = {}  # keyfrm id -> weight
        self._ordered_ids: List[int] = []
        self.spanning_parent: Optional[int] = None
        self.spanning_children: Set[int] = set()
        self.loop_edges: Set[int] = set()

    # ------------------------------------------------------------------
    def update_connections(self, map_db):
        """Count shared landmarks with other keyframes; keep those above the
        threshold (or at least the best one) and mirror the edges
        (reference graph_node.cc update_connections)."""
        kf = self.owner
        # covisibility counting in the native map core (mapcore.cpp)
        kf_ids, cnts = map_db.assoc_store.covis_counts(kf.lm_ids, kf.id)
        counts: Dict[int, int] = {
            int(k): int(c) for k, c in zip(kf_ids, cnts)
            if int(k) in map_db.keyframes
        }
        if not counts:
            return
        best_id = max(counts, key=lambda k: (counts[k], -k))
        kept = {
            kid: w for kid, w in counts.items() if w >= self.min_num_shared_lms
        }
        if not kept:
            kept = {best_id: counts[best_id]}
        self.connections = kept
        self._sort_connections()
        # mirror
        for kid, w in kept.items():
            other = map_db.keyframes.get(kid)
            if other is not None:
                other.graph_node.connections[kf.id] = w
                other.graph_node._sort_connections()
        # spanning tree: attach to the strongest connection once (component
        # roots never get a parent — they anchor their spanning tree)
        if self.spanning_parent is None and kf.id not in map_db.spanning_roots:
            parent = map_db.keyframes.get(best_id)
            if parent is not None:
                self.spanning_parent = best_id
                parent.graph_node.spanning_children.add(kf.id)

    def _sort_connections(self):
        self._ordered_ids = sorted(
            self.connections, key=lambda k: (-self.connections[k], k)
        )
