"""Kernel L's cell walk (the duplicate scan over a cell index of each
keyframe's keypoints) in plain form, on the CPU.

`fuse_cells_plain` (each gated landmark scans only the keypoints in the
cells of its window, on the keyframe's cell index over the image extent,
as the kernel walks them) against `fuse_scan_plain` (every keypoint) and
JAX's `MappingKernels.fuse_multi` (`_fuse_multi_impl`), exactly, at the
keyframe event's margin 3 and loop fusion's margin 4:
- on test_torch_fuse.py's plane-world fixture (three keyframes and a
  padding one);
- on chip_smoke.fuse_edge_chunk, perspective and equirectangular: a third
  of the landmarks within 4 px of an edge, keypoints that fall outside the
  image near them, keypoints far outside it and NaN coordinates in invalid
  slots.
Also the batched cell index's CPU path against one index a keyframe.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stella_vslam_tpu.camera import base as jcam
from stella_vslam_tpu.feature.orb_params import OrbParams as JaxOrbParams
from stella_vslam_tpu.module.mapping_kernels import MappingKernels as JMappingKernels
from stella_vslam_tpu_torch.match import hamming as H
from stella_vslam_tpu_torch.module import mapping_kernels as mkm
from tests.test_torch_fuse import FRAMES, _desc_t, _lm_f, data  # noqa: F401 (fixture)

torch.set_num_threads(1)


def jax_fuse(jmk, kfs, poses, kf_valid, lm_f, lm_desc, lm_valid, margin):
    n = lambda t: jnp.asarray(t.numpy())
    P = poses.numpy()
    best, acc = jmk.fuse_multi(
        n(kfs.uv), n(kfs.level), jnp.asarray(kfs.desc.numpy().view(np.uint32)), n(kfs.valid),
        n(kfs.x_right), jnp.asarray(P[:, :9].reshape(-1, 3, 3)), jnp.asarray(P[:, 9:12]),
        n(kf_valid), jnp.asarray(lm_f.numpy()[:, :3]),
        jnp.asarray(lm_desc.numpy().view(np.uint32)), jnp.asarray(lm_f.numpy()[:, 3]),
        jnp.asarray(lm_f.numpy()[:, 4]), jnp.asarray(lm_f.numpy()[:, 5:8]), n(lm_valid),
        margin=margin)
    return np.asarray(best), np.asarray(acc)


def check_walk(kern, args, jmk, margin):
    """fuse_cells_plain == fuse_scan_plain == JAX on one chunk; returns
    (pairs visited, the plain scan's outputs)."""
    model = kern.camera.model
    largs = args[:6] + (kern.cam, kern.scale_factors, kern.level_sigma_sq, kern.log_scale,
                        margin, model)
    cb, ci, cg, visited = mkm.fuse_cells_plain(*largs)
    sb, si, sg = mkm.fuse_scan_plain(*largs)
    assert torch.equal(cb, sb) and torch.equal(ci, si) and torch.equal(cg, sg)
    N = args[0].uv.shape[1]
    acc = mkm.accept_fused(cb, ci, cg, N)
    jbest, jacc = jax_fuse(jmk, *args, margin)
    np.testing.assert_array_equal(acc.numpy(), jacc)
    valid_kf = args[2].numpy()
    np.testing.assert_array_equal(ci.numpy()[valid_kf], jbest[valid_kf])
    assert int(acc.sum()) > 50
    return visited, (sb, si, sg, acc)


@pytest.mark.parametrize("margin", [3.0, 4.0])
def test_cells_walk_on_plane_world(data, margin):  # noqa: F811
    idx = [0, 1, 2, 0]
    pf, lm = data["pfr"], data["lm"]
    st = lambda fn: torch.stack([fn(pf[i]) for i in idx])
    kfs = mkm.FuseKeyframes(st(lambda f: f.undist_xy), st(lambda f: f.feats.level),
                            st(lambda f: f.feats.desc), st(lambda f: f.feats.valid),
                            torch.from_numpy(np.stack([data["xr"][i] for i in idx])))
    P = np.stack([np.concatenate([data["poses"][i][:3, :3].reshape(9),
                                  data["poses"][i][:3, 3]]) for i in idx]).astype(np.float32)
    kern = mkm.MappingKernels(data["cam"], data["orb"], device="cpu")
    args = (kfs, torch.from_numpy(P), torch.tensor([True, True, True, False]), _lm_f(lm),
            _desc_t(lm["desc"]), torch.from_numpy(lm["valid"]))
    jmk = JMappingKernels(data["jslam"].camera, data["jslam"].orb_params)
    visited, _ = check_walk(kern, args, jmk, margin)
    assert 0 < visited < 0.1 * 3 * len(lm["valid"]) * kfs.uv.shape[1]


@pytest.mark.parametrize("margin", [3.0, 4.0])
@pytest.mark.parametrize("model", ["perspective", "equirectangular"])
def test_cells_walk_at_the_edges(model, margin):
    kern, args = chip_smoke.fuse_edge_chunk("cpu", seed=5, model=model)
    jmk = JMappingKernels(jcam.camera_from_yaml(chip_smoke.fuse_edge_yaml(model)),
                          JaxOrbParams(num_levels=8))
    visited, (best, idx, gate, acc) = check_walk(kern, args, jmk, margin)
    kfs = args[0]
    B, N = kfs.uv.shape[:2]
    assert visited < 0.1 * B * args[3].shape[0] * N
    # accepted matches with keypoints outside the image, which only the
    # border cells hold
    u = kfs.uv[..., 0].gather(1, idx.long())
    v = kfs.uv[..., 1].gather(1, idx.long())
    W, Hh = kern.cam.width, kern.cam.height
    outside = acc & ((u < 0) | (u >= W) | (v < 0) | (v >= Hh))
    assert int(outside.sum()) >= 5
    # NaN coordinates lie only in invalid slots, and some exist
    nan = torch.isnan(kfs.uv).any(-1)
    assert int(nan.sum()) > 0 and not bool((nan & kfs.valid).any())


def test_batched_cell_index_cpu_path():
    _, (kfs, *_rest) = chip_smoke.fuse_edge_chunk("cpu", seed=2)
    start, order, inv, gx, gy = H.build_cell_index_batch(kfs.uv, 752.0, 480.0)
    for b in range(kfs.uv.shape[0]):
        one = H.build_cell_index_plain(kfs.uv[b, :, 0], kfs.uv[b, :, 1], 752.0, 480.0)
        assert torch.equal(start[b], one.start) and torch.equal(order[b], one.order)
        assert (inv, gx, gy) == (one.inv_cell, one.gx, one.gy)


def test_same_cells_ignores_the_order_within_a_cell():
    """chip_smoke.same_cells, which holds the card's batched index (a cell's
    points in no fixed order) to the plain one: a permutation within each
    cell passes, a point moved to another cell fails."""
    _, (kfs, *_rest) = chip_smoke.fuse_edge_chunk("cpu", seed=3)
    start, order, *_ = H.build_cell_index_batch(kfs.uv, 752.0, 480.0)
    g = torch.Generator().manual_seed(0)
    shuffled = order.clone()
    for b in range(order.shape[0]):
        for c in range(start.shape[1] - 1):
            a, e = int(start[b, c]), int(start[b, c + 1])
            shuffled[b, a:e] = order[b, a:e][torch.randperm(e - a, generator=g)]
    assert not torch.equal(shuffled, order)
    assert chip_smoke.same_cells(start, shuffled, start, order)
    moved = start.clone()
    moved[0, 1] += 1
    assert not chip_smoke.same_cells(moved, order, start, order)
    swapped = order.clone()
    b, a = 0, int(start[0, 5])
    e = int(torch.nonzero(start[0] > a)[0])  # the first position of a later cell
    swapped[b, a], swapped[b, int(start[0, e])] = order[b, int(start[0, e])], order[b, a]
    assert not chip_smoke.same_cells(start, swapped, start, order)
