"""YAML configuration, compatible with the reference's config files.

Copy of stella_vslam_tpu/config.py without jax; yaml is imported only by
the file-reading entry point.

Reference: src/stella_vslam/config.{h,cc} — a thin wrapper keeping the raw
YAML node; every component reads its own section with defaults
(util/yaml.h yaml_optional_ref). Sections: Camera, Feature, Preprocessing,
Tracking, Mapping, KeyframeInserter, Initializer, ... (EuRoC_mono.yaml:1-70).

Unlike the reference (which silently ignores unknown keys), every read is
RECORDED, and `log_collapse_report()` — called once at System construction —
logs which keys of the user's YAML are live, which are deliberately collapsed
into this framework's single JAX/XLA engine (e.g. the g2o/gtsam `backend`
selectors), and which are unknown and ignored. A user porting a reference
YAML gets an explicit signal about every knob.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Set, Tuple

_log = logging.getLogger(__name__)

# keys the reference exposes that this framework deliberately collapses:
# accepted, not an error, but the user should know the knob is not live
_COLLAPSED_KEYS: Dict[Tuple[str, str], str] = {
    ("Tracking", "backend"):
        "one JAX/XLA optimization engine (g2o/gtsam selector collapses)",
    ("Mapping", "backend"):
        "one JAX/XLA optimization engine (g2o/gtsam selector collapses)",
    ("LoopDetector", "backend"):
        "one JAX/XLA optimization engine (g2o/gtsam selector collapses)",
    ("KeyframeInserter", "wait_for_local_bundle_adjustment"):
        "local BA runs as a deferred device program overlapped with "
        "tracking; insertion never blocks on it",
    ("Mapping", "enable_interruption_of_landmark_generation"):
        "triangulation is ONE batched device program, not an interruptible "
        "host loop",
    ("Mapping", "enable_interruption_before_local_BA"):
        "local BA dispatch is already skipped under queue backpressure",
    ("System", "num_grid_cols"): "grid geometry is derived from the image",
    ("System", "num_grid_rows"): "grid geometry is derived from the image",
    ("Mapping", "erase_temporal_keyframes"):
        "temporal eviction is armed by System.enable_temporal_mapping(); "
        "ephemeral keyframes are always bounded by num_temporal_keyframes",
    ("Relocalizer", "search_neighbor"):
        "the relocalization cascade always refines against the covisibility "
        "neighborhood (refine_pose_by_local_map)",
}

# keys read lazily AFTER construction (save/load, runner loops) — counted
# as live even when unread at report time
_DEFERRED_KEYS = {("System", "map_format"), ("Camera", "fps"),
                  ("Camera", "setup")}

# whole sections that belong to binaries/plugins outside the core library
_COLLAPSED_SECTIONS: Dict[str, str] = {
    "PangolinViewer": "viewer plugin (reference: separate pangolin_viewer "
                      "package); use publish.frame_publisher/map_publisher",
    "SocketPublisher": "viewer plugin (reference: separate socket_publisher "
                       "package); use publish.frame_publisher/map_publisher",
    "IrisViewer": "viewer plugin; use the publishers",
}


class _TrackedSection(dict):
    """Dict view of one YAML section that records key reads."""

    def __init__(self, data: Dict[str, Any], accessed: Set[Tuple[str, str]],
                 name: str):
        super().__init__(data)
        self._accessed = accessed
        self._name = name

    def get(self, key, default=None):
        self._accessed.add((self._name, key))
        return super().get(key, default)

    def __getitem__(self, key):
        self._accessed.add((self._name, key))
        return super().__getitem__(key)

    def __contains__(self, key):
        self._accessed.add((self._name, key))
        return super().__contains__(key)


class Config:
    def __init__(self, node: Optional[Dict[str, Any]] = None, path: Optional[str] = None):
        if path is not None:
            node = Config.from_yaml_file(path).node
        self.node: Dict[str, Any] = node or {}
        self._accessed: Set[Tuple[str, str]] = set()
        self._sections_read: Set[str] = set()

    def section(self, name: str) -> Dict[str, Any]:
        self._sections_read.add(name)
        v = self.node.get(name)
        return _TrackedSection(v if isinstance(v, dict) else {},
                               self._accessed, name)

    def get(self, section: str, key: str, default=None):
        self._sections_read.add(section)
        self._accessed.add((section, key))
        s = self.node.get(section)
        return s.get(key, default) if isinstance(s, dict) else default

    # ------------------------------------------------------------------
    def collapse_report(self) -> Dict[str, List[str]]:
        """Classify every key of the raw YAML against what was actually read:
        'live' (read by a component), 'collapsed' (deliberately mapped into
        this framework's design), 'ignored' (unknown — no component reads
        it). Reading a section at all marks its unread keys as candidates;
        an entirely-unread section is reported as one unit."""
        live, collapsed, ignored = [], [], []
        for sec, val in self.node.items():
            if not isinstance(val, dict):
                ignored.append(f"{sec} (non-mapping top-level entry)")
                continue
            if sec in _COLLAPSED_SECTIONS:
                collapsed.append(f"{sec}.* — {_COLLAPSED_SECTIONS[sec]}")
                continue
            if sec not in self._sections_read:
                ignored.append(f"{sec}.* ({len(val)} keys; section unread)")
                continue
            for key in val:
                if (sec, key) in self._accessed or (sec, key) in _DEFERRED_KEYS:
                    live.append(f"{sec}.{key}")
                elif (sec, key) in _COLLAPSED_KEYS:
                    collapsed.append(
                        f"{sec}.{key} — {_COLLAPSED_KEYS[(sec, key)]}")
                else:
                    ignored.append(f"{sec}.{key}")
        return {"live": live, "collapsed": collapsed, "ignored": ignored}

    def log_collapse_report(self):
        rep = self.collapse_report()
        for entry in rep["collapsed"]:
            _log.info("config: %s", entry)
        for entry in rep["ignored"]:
            _log.warning("config: ignored key %s (not used by this "
                         "framework)", entry)
        return rep

    @staticmethod
    def from_yaml_file(path: str) -> "Config":
        import yaml  # the only yaml use; the card's machine has no yaml

        with open(path) as f:
            return Config(node=yaml.safe_load(f))

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        return Config(node=d)
