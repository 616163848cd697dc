"""Kernel J's band walk in plain form (match/hamming.epipolar_band_plain)
against the dense plain version (epipolar_top2_plain), on the CPU.

The band walk sorts each neighbour's targets by the angle of their
epipolar plane about the epipole and lets a row test only the targets
whose plane can pass its residual gate (plus those every row visits), as
kernel J does on the card. Its cover is conservative, so every output must
equal the dense walk's (best, index, second, second index), on:
* the synthetic plane world's triangulation (tests/test_torch_triangulation's
  frames 10, 0 and 5: a new keyframe and two neighbours, a fifth of the
  keypoints associated, a tenth stereo), where the band must also visit
  under 5% of the dense pairs (about 2% on these frames);
* a seeded multi-view scene (points 3.5-4.5 m away, keyframes 0.1 m apart,
  bearing noise 1e-4, a few flipped descriptor bits) with B = 1..5
  neighbours, padded ones, N2 not a multiple of 256, targets moved to the
  epipole, rows moved to the epipole (a band wider than the bins) and
  stereo rows.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu_torch.match import hamming as H
from stella_vslam_tpu_torch.match import robust
from stella_vslam_tpu_torch.module import mapping_kernels as mk
from stella_vslam_tpu_torch.module.mapping_kernels import TriKeyframe
from tests.test_torch_triangulation import _port_geometry, _tri_keyframes, make_data

torch.set_num_threads(1)

SF = torch.tensor([1.2 ** i for i in range(4)], dtype=torch.float32)


def _gate(cur, nbrs, poses, sf):
    E_12, epl2 = mk.epipolar_terms(poses)
    return robust.epipolar_gate(cur.angle, cur.level, cur.bear, cur.stereo, nbrs.angle,
                                nbrs.bear, nbrs.stereo, E_12, epl2, scale_factors=sf)


def _assert_band_equals_dense(args):
    dense = H.epipolar_top2_plain(*args)
    *band, visit = H.epipolar_band_plain(*args)
    for a, b in zip(band, dense):
        assert torch.equal(a, b)
    assert not bool((visit & ~args[2][None, :, None]).any())
    return dense, int(visit.sum())


def test_band_walk_equals_dense_on_the_plane_world():
    d = make_data()
    P, _, _ = _port_geometry(d)
    cur = TriKeyframe(*[x[0] for x in _tri_keyframes(d, [0])])
    nbrs = _tri_keyframes(d, [1, 2])
    sf = torch.tensor(d["orb"].scale_factors, dtype=torch.float32)
    args = (cur.desc, nbrs.desc, cur.unassoc, nbrs.unassoc, _gate(cur, nbrs, P, sf))
    dense, visited = _assert_band_equals_dense(args)
    live = int(cur.unassoc.sum()) * nbrs.desc.shape[0] * nbrs.desc.shape[1]
    assert int((dense[0] <= H.HAMMING_DIST_THR_LOW).sum()) > 100
    assert 0 < visited < 0.05 * live, (visited, live)


def _scene(B, N1, N2, seed, near=0.0, near_rows=0.0, stereo=0.1, pad=False):
    """A new keyframe and B neighbours 0.1 m apart facing P points 3.5-4.5 m
    away (N1 / N2 views each, bearing noise 1e-4, up to two flipped
    descriptor bits, angles within 0.05 rad, octaves 0-3, 90% unassociated);
    a share `near` of each neighbour's targets and `near_rows` of the rows
    moved to within ~0.06 degrees of the epipole, a share `stereo` of the
    rows stereo, with `pad` the last neighbour without unassociated
    targets. Returns J's arguments."""
    rng = np.random.default_rng(seed)
    P = max(600, N1 + 100, N2 + 100)
    X = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1.0, 1.0, P),
                  rng.uniform(3.5, 4.5, P)], -1)
    desc = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint64).astype(np.uint32)
    angle = rng.uniform(-np.pi, np.pi, P)
    level = rng.integers(0, 4, P)
    poses = np.zeros((B + 1, 12), np.float32)
    views = []
    for k in range(B + 1):
        a = 0.01 * k
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([-0.1 * k, 0.01 * k, 0.0])
        poses[k, :9], poses[k, 9:] = R.reshape(9), t
        n = N1 if k == 0 else N2
        ids = rng.permutation(P)[:n]
        xc = X[ids] @ R.T + t
        bear = xc / np.linalg.norm(xc, axis=1, keepdims=True) + rng.normal(0, 1e-4, (n, 3))
        bear /= np.linalg.norm(bear, axis=1, keepdims=True)
        dd = desc[ids].copy()
        for _ in range(2):
            dd[np.arange(n), rng.integers(0, 8, n)] ^= (
                rng.random(n) < 0.5).astype(np.uint32) << rng.integers(0, 32, n).astype(np.uint32)
        views.append(dict(level=level[ids], desc=dd.view(np.int32), bear=bear,
                          angle=angle[ids] + rng.normal(0, 0.05, n), unassoc=rng.random(n) < 0.9,
                          stereo=rng.random(n) < 0.1))
    poses = torch.from_numpy(poses)
    R, t = poses[:, :9].reshape(-1, 3, 3).double(), poses[:, 9:12].double()
    centre = lambda i: -(R[i].T @ t[i])
    f = lambda x, dt: torch.from_numpy(np.asarray(x).astype(dt))
    v0 = views[0]
    bear1 = f(v0["bear"], np.float64)
    # rows at the epipole of neighbour 1 (the direction of its centre)
    e1 = R[0] @ (centre(1) - centre(0))
    sel = f(rng.random(N1) < near_rows, bool)
    moved = torch.nn.functional.normalize(e1 / e1.norm() + 1e-3 * f(rng.normal(size=(N1, 3)),
                                                                    np.float64), dim=-1)
    bear1 = torch.where(sel[:, None], moved, bear1)
    cur = TriKeyframe(torch.zeros(N1, 2), f(v0["level"], np.int32), f(v0["desc"], np.int32),
                      bear1.float(), f(v0["angle"], np.float32), f(v0["unassoc"], bool),
                      f(rng.random(N1) < stereo, bool))
    nb = [views[k] for k in range(1, B + 1)]
    st = lambda key, dt: torch.stack([f(v[key], dt) for v in nb])
    bear2 = st("bear", np.float64)
    for k in range(B):
        # targets at the epipole in neighbour k + 1 (the new keyframe's centre)
        ep = R[k + 1] @ (centre(0) - centre(k + 1))
        sel = f(rng.random(N2) < near, bool)
        moved = torch.nn.functional.normalize(ep / ep.norm() + 1e-3 * f(
            rng.normal(size=(N2, 3)), np.float64), dim=-1)
        bear2[k] = torch.where(sel[:, None], moved, bear2[k])
    unassoc = st("unassoc", bool)
    if pad:
        unassoc[-1] = False
    nbrs = TriKeyframe(torch.zeros(B, N2, 2), st("level", np.int32), st("desc", np.int32),
                       bear2.float(), st("angle", np.float32), unassoc, st("stereo", bool))
    return cur.desc, nbrs.desc, cur.unassoc, nbrs.unassoc, _gate(cur, nbrs, poses, SF)


@pytest.mark.parametrize("B,N1,N2,near,near_rows,stereo,pad", [
    (1, 300, 517, 0.0, 0.0, 0.1, False),
    (2, 300, 256, 0.0, 0.0, 0.1, False),
    (3, 400, 700, 0.3, 0.0, 0.1, False),
    (3, 300, 517, 0.0, 0.2, 0.1, False),
    (3, 300, 517, 0.1, 0.0, 0.6, False),
    (4, 300, 999, 0.0, 0.0, 0.1, True),
    (5, 300, 517, 0.1, 0.1, 0.3, True)])
def test_band_walk_equals_dense(B, N1, N2, near, near_rows, stereo, pad):
    args = _scene(B, N1, N2, seed=B * 11 + N2, near=near, near_rows=near_rows, stereo=stereo,
                  pad=pad)
    dense, visited = _assert_band_equals_dense(args)
    assert int((dense[0] <= H.HAMMING_DIST_THR_LOW).sum()) > 50
    if pad:
        assert bool((dense[0][-1] == 257).all())
    assert visited > 0


def test_band_basis_is_perpendicular_to_every_normal():
    """epipole_basis: (e1, u, v) orthonormal, and every target's unit
    epipolar normal E b2 within 1e-5 of the plane perpendicular to e1."""
    *_, gate = _scene(3, 300, 517, seed=3)
    basis = H.epipole_basis(gate.E).double()
    e1, u, v = basis[:, 0:3], basis[:, 3:6], basis[:, 6:9]
    eye = torch.stack([torch.stack([(a * b).sum(-1) for b in (e1, u, v)], -1)
                       for a in (e1, u, v)], -2)
    assert float((eye - torch.eye(3, dtype=torch.float64)).abs().max()) < 1e-6
    n = gate.col_epl.double() / gate.col_norm.double()[..., None]
    assert float((n * e1[:, None, :]).sum(-1).abs().max()) < 1e-5


@pytest.mark.parametrize("B,N2,pad", [(1, 517, False), (4, 999, True)])
def test_band_index_sorts_every_target_into_its_bucket(B, N2, pad):
    """The band index in plain form (what epipolar_band_index returns for
    CPU tensors): start rises from 0 to N2 over J_BAND_BINS + 2 buckets,
    order is a permutation of the targets, every target sits in the bucket
    band_buckets gives it, and the targets that fail col_ok (padding
    included) in the last one."""
    _, _, _, col_ok, gate = _scene(B, 300, N2, seed=B + N2, near=0.1, pad=pad)
    band = H.epipolar_band_index(col_ok, gate)
    assert torch.equal(band.basis, H.epipole_basis(gate.E))
    bucket = H.band_buckets(col_ok, gate, band.basis)
    assert band.start.shape == (B, H.J_BAND_BINS + 3) and band.order.shape == (B, N2)
    for b in range(B):
        st, order = band.start[b].long(), band.order[b].long()
        assert int(st[0]) == 0 and int(st[-1]) == N2 and bool((st[1:] >= st[:-1]).all())
        assert torch.equal(torch.sort(order).values, torch.arange(N2))
    at = H.band_index_buckets(band)
    assert torch.equal(at, bucket)
    assert torch.equal(at == H.J_BAND_BINS + 1, ~col_ok)
    if pad:
        assert int(band.start[-1, -2]) == 0
