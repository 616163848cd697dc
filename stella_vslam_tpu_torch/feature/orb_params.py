"""ORB pyramid hyper-parameters and precomputed scale tables.

Reference: src/stella_vslam/feature/orb_params.h:11-54 (scale_factor 1.2,
8 levels, FAST thresholds 20/7, precomputed scale / sigma^2 tables).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class OrbParams:
    name: str = "default ORB feature extraction setting"
    scale_factor: float = 1.2
    num_levels: int = 8
    ini_fast_thr: int = 20
    min_fast_thr: int = 7

    scale_factors: List[float] = field(default_factory=list)
    inv_scale_factors: List[float] = field(default_factory=list)
    level_sigma_sq: List[float] = field(default_factory=list)
    inv_level_sigma_sq: List[float] = field(default_factory=list)

    def __post_init__(self):
        self.scale_factors = self.calc_scale_factors(self.num_levels, self.scale_factor)
        self.inv_scale_factors = [1.0 / s for s in self.scale_factors]
        # sigma^2 at level l = (scale^l)^2 — reference orb_params.cc calc_level_sigma_sq
        self.level_sigma_sq = [s * s for s in self.scale_factors]
        self.inv_level_sigma_sq = [1.0 / s for s in self.level_sigma_sq]

    @staticmethod
    def calc_scale_factors(num_levels: int, scale_factor: float) -> List[float]:
        return [scale_factor**lvl for lvl in range(num_levels)]

    @staticmethod
    def from_yaml(node: dict) -> "OrbParams":
        return OrbParams(
            name=node.get("name", "default ORB feature extraction setting"),
            scale_factor=float(node.get("scale_factor", 1.2)),
            num_levels=int(node.get("num_levels", 8)),
            ini_fast_thr=int(node.get("ini_fast_threshold", 20)),
            min_fast_thr=int(node.get("min_fast_threshold", 7)),
        )

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "scale_factor": self.scale_factor,
            "num_levels": self.num_levels,
            "ini_fast_threshold": self.ini_fast_thr,
            "min_fast_threshold": self.min_fast_thr,
        }

    @staticmethod
    def from_json(d: dict) -> "OrbParams":
        return OrbParams(
            name=d.get("name", "default"),
            scale_factor=float(d.get("scale_factor", 1.2)),
            num_levels=int(d.get("num_levels", 8)),
            ini_fast_thr=int(d.get("ini_fast_threshold", 20)),
            min_fast_thr=int(d.get("min_fast_threshold", 7)),
        )
