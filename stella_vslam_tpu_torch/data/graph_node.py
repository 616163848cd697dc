"""Covisibility graph node + spanning tree.

Reference: src/stella_vslam/data/graph_node.{h,cc} — weighted connections
(>= min shared landmarks, default 15), ordered covisibility lists, spanning
tree parent/children. Copy of the part of stella_vslam_tpu/data/graph_node.py
the tracking, mapping and loop-closing slices call: update_connections, the
covisibility queries, loop edges, and the edge and spanning-tree repair of a
keyframe erasure.
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

    def get_covisibilities(self) -> List[int]:
        return list(self._ordered_ids)

    def get_top_n_covisibilities(self, n: int) -> List[int]:
        return self._ordered_ids[:n]

    def erase_connection(self, keyfrm_id: int):
        if self.connections.pop(keyfrm_id, None) is not None:
            self._sort_connections()

    def erase_all_connections(self, map_db):
        for kid in list(self.connections):
            other = map_db.keyframes.get(kid)
            if other is not None:
                other.graph_node.erase_connection(self.owner.id)
        self.connections = {}
        self._ordered_ids = []

    def add_loop_edge(self, keyfrm_id: int):
        self.loop_edges.add(keyfrm_id)

    def recompute_spanning_parent_on_erase(self, map_db):
        """Children of an erased node reattach to its parent."""
        parent_id = self.spanning_parent
        pkf = map_db.keyframes.get(parent_id) if parent_id is not None else None
        for child_id in list(self.spanning_children):
            child = map_db.keyframes.get(child_id)
            if child is None:
                continue
            child.graph_node.spanning_parent = parent_id
            if pkf is not None:
                pkf.graph_node.spanning_children.add(child_id)
        if pkf is not None:
            pkf.graph_node.spanning_children.discard(self.owner.id)

    def _sort_connections(self):
        self._ordered_ids = sorted(
            self.connections, key=lambda k: (-self.connections[k], k)
        )
