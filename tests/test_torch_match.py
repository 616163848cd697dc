"""Matching core of the port (kernel C's plain CPU version and the three
tracking matchers) against the JAX matchers, exact, on identical inputs.

Inputs come from a numpy seed: N=600 keypoints at 4 levels, M=500 query
descriptors that are bit-flipped copies of random keypoints (so gates,
ratio tests and duplicate resolution all fire), noisy reprojections, half
of the slots with a stereo x_right. Indices, accept flags and distances
must be equal — the port's contract for integer outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.match import hamming as jH
from stella_vslam_tpu.match import projection as jP
from stella_vslam_tpu.match import robust as jR
from stella_vslam_tpu_torch.camera.base import WindowRows
from stella_vslam_tpu_torch.match import hamming as H
from stella_vslam_tpu_torch.match import projection as P
from stella_vslam_tpu_torch.match import robust as R

torch.set_num_threads(1)

N, M, L = 600, 500, 4
SF = np.asarray([1.2 ** l for l in range(L)], np.float32)
IMAGE = (400.0, 400.0)  # the keypoints' image (the windows' extent)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    kp_desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.integers(0, N, M)
    flips = np.zeros((M, 8), np.uint32)
    for i in range(M):
        for _ in range(rng.integers(0, 60)):
            b = rng.integers(0, 256)
            flips[i, b // 32] ^= np.uint32(1 << (b % 32))
    q_desc = kp_desc[src] ^ flips
    kp_uv = rng.uniform(0, 400, (N, 2)).astype(np.float32)
    # cluster a third of the keypoints near others: ratio tests must decide
    near = rng.integers(0, N, N // 3)
    kp_uv[: N // 3] = kp_uv[near] + rng.normal(0, 2, (N // 3, 2)).astype(np.float32)
    kp_level = rng.integers(0, L, N).astype(np.int32)
    kp_angle = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    kp_xr = np.where(rng.random(N) < 0.5, kp_uv[:, 0] - 20.0, -1.0).astype(np.float32)
    d = dict(
        kp_desc=kp_desc, kp_uv=kp_uv, kp_level=kp_level, kp_angle=kp_angle,
        kp_xr=kp_xr, kp_valid=rng.random(N) < 0.9, kp_has_lm=rng.random(N) < 0.2,
        q_desc=q_desc,
        q_uv=(kp_uv[src] + rng.normal(0, 3, (M, 2))).astype(np.float32),
        q_level=kp_level[src], q_pred=np.clip(kp_level[src] + rng.integers(-1, 2, M),
                                             0, L - 1).astype(np.int32),
        q_angle=(kp_angle[src] + rng.normal(0, 0.4, M)).astype(np.float32),
        q_xr=np.where(rng.random(M) < 0.5, kp_xr[src] + rng.normal(0, 2, M),
                      -1.0).astype(np.float32),
        q_valid=rng.random(M) < 0.85,
    )
    return d


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _eq(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy().astype(np.int64))


def test_pairwise_hamming_exact(data):
    a = jH.pairwise_hamming(jnp.asarray(data["q_desc"]), jnp.asarray(data["kp_desc"]))
    b = H.pairwise_hamming(_t(data["q_desc"]), _t(data["kp_desc"]))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _window_rows(d, level, margin, clamp):
    """The query rows as kernel R writes them (camera.base.WindowRows):
    radius margin * SF[level], levels level -+ 1 (clamped to [0, L-1] for
    the table's rows)."""
    lvl = torch.from_numpy(d[level])
    lo, hi = lvl - 1, lvl + 1
    if clamp:
        lo, hi = torch.clamp(lo, min=0), torch.clamp(hi, max=L - 1)
    uv = _t(d["q_uv"])
    return WindowRows(u=uv[:, 0].contiguous(), v=uv[:, 1].contiguous(), xr=_t(d["q_xr"]),
                      rad=margin * torch.from_numpy(SF)[lvl.long()], lo=lo, hi=hi,
                      valid=_t(d["q_valid"]), pred_scale=lvl if clamp else None)


def test_match_frame_and_landmarks_exact(data):
    d = data
    out_j = jP.match_frame_and_landmarks(
        d["kp_uv"], d["kp_level"], d["kp_desc"], d["kp_valid"], d["kp_has_lm"],
        d["kp_xr"], d["q_desc"], d["q_uv"], d["q_xr"], d["q_pred"], d["q_valid"],
        scale_factors=jnp.asarray(SF), num_levels=L, margin=5.0, lowe_ratio=0.6)
    out_t = P.match_frame_and_landmarks(
        *[_t(d[k]) for k in ("kp_uv", "kp_level", "kp_desc", "kp_valid",
                             "kp_has_lm", "kp_xr", "q_desc")],
        _window_rows(d, "q_pred", 5.0, clamp=True), image_size=IMAGE, lowe_ratio=0.6)
    assert int(np.asarray(out_j[1]).sum()) > 20  # matches really happen
    _eq(out_j, out_t)


def test_match_current_and_last_frames_exact(data):
    d = data
    args = ("kp_uv", "kp_level", "kp_desc", "kp_valid", "kp_angle", "kp_xr",
            "q_desc", "q_level", "q_angle", "q_uv", "q_xr", "q_valid")
    out_j = jP.match_current_and_last_frames(
        *[d[k] for k in args], scale_factors=jnp.asarray(SF), num_levels=L,
        margin=20.0)
    out_t = P.match_current_and_last_frames(
        *[_t(d[k]) for k in ("kp_uv", "kp_level", "kp_desc", "kp_valid", "kp_angle",
                             "kp_xr", "q_desc", "q_angle")],
        _window_rows(d, "q_level", 20.0, clamp=False), image_size=IMAGE)
    assert int(np.asarray(out_j[1]).sum()) > 20
    _eq(out_j, out_t)


def test_brute_force_match_exact(data):
    d = data
    args = ("kp_angle", "kp_desc", "kp_valid", "q_angle", "q_desc", "q_valid")
    out_j = jR.brute_force_match(*[d[k] for k in args], lowe_ratio=0.75)
    out_t = R.brute_force_match(*[_t(d[k]) for k in args], lowe_ratio=0.75)
    assert int(np.asarray(out_j[1]).sum()) > 20
    _eq(out_j, out_t)


@pytest.mark.parametrize("margin", [100.0, 15.0])
def test_match_in_consistent_area_exact(data, margin):
    """The initializer's area matcher: kernel C with the window centred on
    the previous matches and the angle gate (plain version here)."""
    from stella_vslam_tpu.match import area as jA
    from stella_vslam_tpu_torch.match import area as A

    d = data
    # most keypoints at level 0: the matcher only pairs level-0 keypoints
    kp_level = np.where(np.arange(N) % 4 == 3, d["kp_level"], 0).astype(np.int32)
    q_level = kp_level[np.arange(M) % N]
    args = [q_level, d["q_desc"], d["q_angle"], d["q_valid"],
            d["q_uv"], d["kp_uv"], kp_level, d["kp_desc"], d["kp_angle"],
            d["kp_valid"]]
    out_j = jA.match_in_consistent_area(*[jnp.asarray(a) for a in args],
                                        margin=margin, lowe_ratio=0.9)
    out_t = A.match_in_consistent_area(*[_t(a) for a in args], margin=margin,
                                       lowe_ratio=0.9, image_size=IMAGE)
    assert int(np.asarray(out_j[1]).sum()) > 20
    _eq(out_j, out_t)


@pytest.mark.parametrize("margin", [10.0, 3.0])
def test_match_frame_and_keyframe_exact(data, margin):
    """The loop detector's rematch (kernel C's window mode through a new
    wrapper): window by the predicted level, levels within +-1, keypoints
    that hold a landmark excluded, best only, orientation on the winner."""
    d = data
    kw = dict(num_levels=L, margin=margin)
    jo = jP.match_frame_and_keyframe(
        *[jnp.asarray(d[k]) for k in ("kp_uv", "kp_level", "kp_desc", "kp_valid", "kp_angle",
                                      "kp_has_lm", "q_desc", "q_uv", "q_pred", "q_angle",
                                      "q_valid")], scale_factors=jnp.asarray(SF), **kw)
    t = lambda k: torch.from_numpy(d[k].view(np.int32) if d[k].dtype == np.uint32 else d[k])
    to = P.match_frame_and_keyframe(
        *[t(k) for k in ("kp_uv", "kp_level", "kp_desc", "kp_valid", "kp_angle", "kp_has_lm",
                         "q_desc", "q_uv", "q_pred", "q_angle", "q_valid")],
        scale_factors=torch.from_numpy(SF), image_size=IMAGE, **kw)
    assert np.array_equal(np.asarray(jo[1]), to[1].numpy())
    acc = to[1].numpy()
    assert acc.sum() > 20
    assert np.array_equal(np.asarray(jo[0])[acc], to[0].numpy()[acc])
    assert np.array_equal(np.asarray(jo[2]), to[2].numpy())
    # no accepted match lands on a keypoint that already holds a landmark
    assert not d["kp_has_lm"][to[0].numpy()[acc]].any()
