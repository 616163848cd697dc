"""The port's RGBD frame finish against the JAX System's jitted
`_rgbd_preprocess`, bit for bit.

The JAX System samples the depth map, converts it to meters and computes
x_right inside one `jax.jit` with the extraction, the undistortion, the
bearings and the host-mirror pack (stella_vslam_tpu/system.py:486-505):
`d = depth_map[ys, xs] * inv_factor` (the float32 of the double 1 /
depthmap_factor), -1 unless the slot is valid and d > 0, and x_right = und_x
- fxb / max(d, 1e-6), a true division (its divisor varies). The port's
finish (data/frame.py frame_finish, kernel R's launch on the card,
`frame_finish_plain` here) computes the same; a Python float divided by a
tensor would take torch's reciprocal and a product, two roundings (7442 of
200 000 seeded rows apart). Held here: x_right, the depths and every packed
row equal the jitted tail's, on seeded keypoints over a depth map with
zeros (holes) and through `System.create_RGBD_frame` on a rendered frame.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu.data.frame import pack_host_cols as jax_pack
from stella_vslam_tpu_torch.camera import base as tcam
from stella_vslam_tpu_torch.data import frame as tframe
from stella_vslam_tpu_torch.feature.orb_extractor import FrameFeatures

torch.set_num_threads(1)

N = 2872
W, H = 752, 480
FACTOR = 5000.0
# the RGBD leg's pinhole camera (fx 458, a 0.12 m baseline) and EuRoC's
# radial-tangential one with the same baseline
CAMERAS = {
    "bench": dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0),
    "euroc": dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
                  k2=0.07395907, p1=0.00019359, p2=1.76187114e-05),
}


def jitted_rgbd_tail(params: dict, depthmap_factor: float):
    """JAX's `_rgbd_preprocess` after its extraction, for a perspective
    camera of `params` (as the System builds it: the camera's
    focal_x_baseline and 1 / depthmap_factor as Python floats)."""
    M, p = jcam.CameraModel.PERSPECTIVE, jcam.make_params(**params)
    fxb = float(p.focal_x_baseline)
    inv_factor = 1.0 / depthmap_factor

    @jax.jit
    def tail(xy, level, angle, valid, response, desc, depth_map):
        und = jcam.undistort_keypoints(M, p, xy)
        bear = jcam.bearings_from_undistorted(M, p, und)
        h, w = depth_map.shape
        xs = jnp.clip(xy[:, 0].astype(jnp.int32), 0, w - 1)
        ys = jnp.clip(xy[:, 1].astype(jnp.int32), 0, h - 1)
        d = depth_map[ys, xs].astype(jnp.float32) * inv_factor
        d = jnp.where(valid & (d > 0), d, -1.0)
        x_right = jnp.where(d > 0, und[:, 0] - fxb / jnp.maximum(d, 1e-6), -1.0)
        return x_right, d, jax_pack(xy, und, bear, level, angle, valid, response, x_right, d,
                                    desc)
    return tail


def camera(name: str) -> tcam.Camera:
    p = tcam.make_params(width=W, height=H, focal_x_baseline=458.0 * 0.12, **CAMERAS[name])
    return tcam.Camera(name, tcam.CameraModel.PERSPECTIVE, tcam.Setup.RGBD, p, width=W, height=H)


def depth_map(seed: int) -> np.ndarray:
    """Raw depths (TUM's 5000 a meter, 0.2-8 m) with 30% holes (zeros)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(1000, 40000, (H, W)).astype(np.float32)
    raw[rng.random((H, W)) < 0.3] = 0.0
    return raw


def seeded_features(seed: int) -> FrameFeatures:
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], -1).astype(np.float32)
    xy[:4] = [[0.0, 0.0], [W - 0.5, H - 0.5], [376.0, 240.0], [0.999, 479.999]]
    t = torch.from_numpy
    return FrameFeatures(
        xy=t(xy), response=t(rng.uniform(0, 100, N).astype(np.float32)),
        angle=t(rng.uniform(-np.pi, np.pi, N).astype(np.float32)),
        level=t(rng.integers(0, 8, N).astype(np.int32)), valid=t(rng.random(N) < 0.8),
        desc=t(rng.integers(-2**31, 2**31, (N, 8), dtype=np.int32)))


def jax_outputs(tail, feats: FrameFeatures, raw: np.ndarray):
    a = lambda x: jnp.asarray(x.numpy())
    out = tail(a(feats.xy), a(feats.level), a(feats.angle), a(feats.valid),
               a(feats.response), jnp.asarray(feats.desc.numpy().view(np.uint32)),
               jnp.asarray(raw))
    return [np.asarray(x) for x in out]


def rows_apart(j: np.ndarray, t: torch.Tensor) -> int:
    bits = lambda x: np.ascontiguousarray(x).view(np.int32)
    d = bits(j) != bits(t.numpy())
    return int(np.sum(d if d.ndim == 1 else np.any(d, axis=-1)))


@pytest.mark.parametrize("cam_name", ["bench", "euroc"])
def test_rgbd_finish_matches_jax_jit(cam_name):
    cam = camera(cam_name)
    tail = jitted_rgbd_tail(dict(CAMERAS[cam_name], width=W, height=H,
                                 focal_x_baseline=458.0 * 0.12), FACTOR)
    counts = []
    for seed in range(3):
        feats, raw = seeded_features(seed), depth_map(10 + seed)
        xr_j, d_j, pack_j = jax_outputs(tail, feats, raw)
        fin = tframe.frame_finish(cam, feats, depth_map=torch.from_numpy(raw),
                                  inv_depth_factor=1.0 / FACTOR)
        assert int((d_j > 0).sum()) > N // 2 and int((d_j < 0).sum()) > N // 10
        counts.append((rows_apart(xr_j, fin.x_right), rows_apart(d_j, fin.depths),
                       rows_apart(pack_j, fin.packed)))
    print(f"{cam_name}: rows apart from JAX's jitted _rgbd_preprocess (x_right, depths, "
          f"packed) per seed {counts} of {N}")
    assert counts == [(0, 0, 0)] * 3


def test_rgbd_system_frame_matches_jax_jit():
    """System.create_RGBD_frame on a rendered frame of the RGBD leg's world:
    its x_right, depths and packed host rows against JAX's jitted tail on
    the frame's own features."""
    from stella_vslam_tpu_torch.config import Config
    from stella_vslam_tpu_torch.system import System
    from stella_vslam_tpu_torch.util.drift import pose_at_xy
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    world = bench_world()
    cam = dict(world.camera_yaml(), setup="RGBD", focal_x_baseline=world.fx * 0.12)
    slam = System(Config.from_dict({"Camera": cam, "Feature": {"num_levels": 8},
                                    "Preprocessing": {"depthmap_factor": FACTOR}}),
                  device="cpu")
    raw = depth_map(7)
    frm = slam.create_RGBD_frame(world.render(pose_at_xy(0.3, 0.0)), raw.astype(np.uint16), 0.0)
    p = slam.camera.params
    tail = jitted_rgbd_tail(dict(fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, width=W, height=H,
                                 focal_x_baseline=p.focal_x_baseline), FACTOR)
    xr_j, d_j, pack_j = jax_outputs(tail, frm.feats, raw.astype(np.uint16).astype(np.float32))
    assert int(frm.feats.valid.sum()) > 500
    assert rows_apart(xr_j, frm.x_right) == 0 and rows_apart(d_j, frm.depths) == 0
    assert rows_apart(pack_j, frm._packed_host) == 0
