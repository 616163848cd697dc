"""Ground-truth camera poses of the synthetic plane world.

Copy of `pose_at_x` / `pose_at_xy` from stella_vslam_tpu/util/drift.py (the
drift-injection helpers there drive the mapping and loop-closing modules,
which this package does not have yet).
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
