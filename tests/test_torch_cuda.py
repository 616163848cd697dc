"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when torch sees no GPU (the check runs inside
the fixture, never at import). On a machine with an H100 and nvcc, without
jax (tests/conftest.py imports it), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes here are small and ragged (sizes that are not multiples of the block
or warp width, a single row, a single target) — chip_smoke.py checks the
slice's full shapes. Integer outputs must be equal; poses within 1e-4.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu_torch.feature import orb_extractor as ox
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.match import hamming as H
from stella_vslam_tpu_torch.ops.optim import pose as pose_mod
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld, lateral_trajectory

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def frame(dev):
    params = OrbParams(num_levels=4)
    ex = ox.OrbExtractor(params, 400, 300, min_area=400, device=dev)
    img = PlaneWorld(noise_sigma=2.0).render(lateral_trajectory(2)[1])
    return ex, ex.pyramid(torch.from_numpy(img).to(dev))


def test_fast_nms_kernel_matches_plain(dev, frame):
    ex, levels = frame
    before = ox.fast_nms.launches
    for img, g in zip(levels, ex.levels):
        k = ox.fast_nms(img.contiguous(), g, ex.border, 20.0, 7.0)
        p = ox.fast_nms_plain(img, g, ex.border, 20.0, 7.0)
        assert torch.equal(k, p)
    assert ox.fast_nms.launches == before + len(levels)


def test_orb_describe_kernel_matches_plain(dev, frame):
    ex, levels = frame
    pts = [ex.cell_keypoints(ox.fast_nms(l.contiguous(), g, ex.border, 20.0, 7.0), g)
           for l, g in zip(levels, ex.levels)]
    px, py, valid, _ = (torch.cat(c) for c in zip(*pts))
    args = (torch.cat([l.reshape(-1) for l in levels]), ex._slot_base, ex._slot_H,
            ex._slot_W, px.to(torch.int32), py.to(torch.int32), valid, ex._tables)
    ak, dk = ox.orb_describe(*args)
    ap, dp = ox.orb_describe_plain(*args)
    assert float((ak - ap).abs().max()) < 1e-5
    x = (dk ^ dp)[valid].cpu().numpy()
    assert np.unpackbits(x.view(np.uint8)).sum() <= 5e-5 * x.size * 32


@pytest.mark.parametrize("M,N", [(1, 1), (1, 40), (37, 1), (130, 33), (257, 1000)])
def test_hamming_top2_kernel_matches_plain(dev, M, N):
    g = torch.Generator().manual_seed(M * 1000 + N)
    r = lambda *s: torch.rand(*s, generator=g)
    q = torch.randint(-2 ** 31, 2 ** 31, (M, 8), generator=g, dtype=torch.int64)
    t = torch.randint(-2 ** 31, 2 ** 31, (N, 8), generator=g, dtype=torch.int64)
    # near-copies make small distances and ties
    t[: min(M, N)] = q[: min(M, N)] ^ (torch.randint(0, 2, (min(M, N), 8), generator=g) << 3)
    q, t = q.to(torch.int32).to(dev), t.to(torch.int32).to(dev)
    f = lambda x: x.to(dev).contiguous()
    win = H.WindowGate(
        row_u=f(r(M) * 50), row_v=f(r(M) * 50),
        row_xr=f(torch.where(r(M) < 0.5, r(M) * 50, -torch.ones(M))),
        row_rad=f(5 + r(M) * 20), row_lo=f(torch.randint(0, 2, (M,), generator=g).int()),
        row_hi=f(torch.randint(1, 4, (M,), generator=g).int()),
        col_u=f(r(N) * 50), col_v=f(r(N) * 50),
        col_xr=f(torch.where(r(N) < 0.5, r(N) * 50, -torch.ones(N))),
        col_level=f(torch.randint(0, 4, (N,), generator=g).int()))
    ang_q, ang_t = f(r(M) * 6.28 - 3.14), f(r(N) * 6.28 - 3.14)
    ori = H.OrientGate(torch.cos(ang_q), torch.sin(ang_q), torch.cos(ang_t),
                       torch.sin(ang_t), 0.8660254)
    row_ok, col_ok = f(r(M) < 0.9), f(r(N) < 0.9)
    for kw in ({}, {"window": win}, {"orient": ori}, {"window": win, "orient": ori}):
        k = H.hamming_top2(q, t, row_ok, col_ok, **kw)
        p = H.hamming_top2_plain(q, t, row_ok, col_ok, **kw)
        for a, b in zip(k, p):
            assert torch.equal(a, b), kw


@pytest.mark.parametrize("N", [5, 800])
def test_pose_lm_kernel_matches_plain(dev, N):
    rng = np.random.default_rng(N)
    fx, cx, cy = 320.0, 200.0, 150.0
    fxb = float(np.float32(fx * 0.12))
    uv = np.stack([rng.uniform(5, 395, N), rng.uniform(5, 295, N)], -1)
    z = rng.uniform(2.0, 6.0, N)
    pos = np.stack([(uv[:, 0] - cx) * z / fx, (uv[:, 1] - cy) * z / fx, z], -1)
    obs = uv + rng.normal(0, 1.0, (N, 2))
    xr = np.where(rng.random(N) < 0.5, obs[:, 0] - fxb / z, -1.0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    args = (f(np.eye(3)), f([0.02, -0.01, 0.03]), f(pos), f(obs), f(xr),
            f(np.ones(N)), torch.ones(N, dtype=torch.bool, device=dev),
            CamScalars(fx, fx, cx, cy, 400.0, 300.0, fxb))
    rk = pose_mod.optimize_pose(*args)
    rp = pose_mod.optimize_pose_plain(*args)
    assert float((rk.R_cw - rp.R_cw).abs().max()) < 1e-4
    assert float((rk.t_cw - rp.t_cw).abs().max()) < 1e-4
    assert float((rk.is_inlier != rp.is_inlier).float().mean()) <= 0.01


def test_hamming_top2_angle_gate_matches_plain(dev):
    """Kernel C's angle-gate mode (the area matcher) against the plain
    version: CUDA's sinf / atan2f may differ from torch's in the last ulp,
    so a pair within an ulp of the 30 degree threshold may gate the other
    way; at most 0.5% of the rows may differ."""
    from stella_vslam_tpu_torch.match import area

    g = torch.Generator().manual_seed(3)
    M, N = 700, 900
    q = torch.randint(-2 ** 31, 2 ** 31, (M, 8), generator=g, dtype=torch.int64)
    t = torch.randint(-2 ** 31, 2 ** 31, (N, 8), generator=g, dtype=torch.int64)
    t[:M] = q ^ (torch.randint(0, 2, (M, 8), generator=g) << 5)
    q, t = q.to(torch.int32).to(dev), t.to(torch.int32).to(dev)
    ang = lambda n: (torch.rand(n, generator=g) * 12.0 - 6.0).to(dev)
    ori = H.AngleGate(ang(M), ang(N), area.ANGLE_THR)
    ok_q = (torch.rand(M, generator=g) < 0.9).to(dev)
    ok_t = (torch.rand(N, generator=g) < 0.9).to(dev)
    k = H.hamming_top2(q, t, ok_q, ok_t, orient=ori)
    p = H.hamming_top2_plain(q, t, ok_q, ok_t, orient=ori)
    differ = torch.zeros(M, dtype=torch.bool, device=dev)
    for a, b in zip(k, p):
        differ |= a != b
    assert float(differ.float().mean()) <= 0.005


def _two_view_dev(dev, n, planar, seed):
    rng = np.random.default_rng(seed)
    fx, cx, cy = 458.0, 376.0, 240.0
    uv1 = np.stack([rng.uniform(10, 742, n), rng.uniform(10, 470, n)], -1)
    z = np.full(n, 4.0) if planar else rng.uniform(2.0, 8.0, n)
    X = np.stack([(uv1[:, 0] - cx) * z / fx, (uv1[:, 1] - cy) * z / fx, z], -1)
    Xc = X + np.array([0.3, 0.02, 0.05])
    uv2 = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    uv2 = uv2 + rng.normal(0, 0.5, uv2.shape)
    out = rng.random(n) < 0.3
    uv2[out] = rng.uniform(0, 700, (int(out.sum()), 2))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
    return f(uv1), f(uv2), torch.as_tensor(rng.random(n) < 0.9, device=dev)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("which", ["H", "F"])
def test_ransac_kernel_matches_plain(dev, which, seed):
    """Kernel E's three entry points against their plain versions: the same
    hashed sets, models within f32 tolerance, the same best inlier count."""
    from stella_vslam_tpu_torch.ops.solve import fundamental as Fm
    from stella_vslam_tpu_torch.ops.solve import homography as Hm
    from stella_vslam_tpu_torch.ops.solve import ransac as R

    mod = Hm if which == "H" else Fm
    p1, p2, v = _two_view_dev(dev, 517, which == "H", seed)
    Mk, ck, nk = R.minimal_hypotheses(mod.MODEL, 1233 + seed, p1, p2, v, 200)
    Mp, cp, np_ = R.minimal_hypotheses_plain(mod.MODEL, 1233 + seed, p1, p2, v, 200, 1.0)
    # Where a minimal set's A^T A has a small eigen-gap, 18 squarings do not
    # converge, and the kernel's float32 sums (in another order than
    # torch's) give another null vector. Most hypotheses, not all, score the
    # same count. Measured on the card (H100 80GB HBM3, seeds 1-4): H 0.985,
    # 0.970, 0.990, 0.965; F 0.890, 0.895, 0.965, 0.915. Both versions are
    # deterministic, so the bounds keep a margin of 0.015 and 0.04 under the
    # lowest reading. chip_smoke.py's F route readings locate F's
    # divergence in the null vector, not in the rank-2 step.
    share = float((nk == np_).float().mean())
    assert share >= (0.95 if which == "H" else 0.85), share
    rk = R.find_core(mod.MODEL, 98 + seed, p1, p2, v, 300, 1.0, 1)
    rp = R.find_core_plain(mod.MODEL, 98 + seed, p1, p2, v, 300, 1.0, 1)
    assert bool(rk.valid) and bool(rp.valid)
    assert int(rk.num_inliers) == int(rp.num_inliers)
    assert float((rk.is_inlier == rp.is_inlier).float().mean()) >= 0.99


def _ba_problem(dev, K, L, D, stereo, keep=False, spacing=0.4, ordered=False):
    """K cameras `spacing` m apart, L points 2.5-4.5 m away seen by D of
    them, 0.5 px noise, 5% gross outliers, camera 0 fixed; with `keep`, a
    third of the landmarks marked lm_keep_inlier. `ordered`: the local BA's
    layout (runs of 64 landmarks share their observers in slot order, 10% of
    the slots padded and pointing at camera 0), where whole warps of kernel
    F add into one camera block."""
    from stella_vslam_tpu_torch.ops.optim import ba

    rng = np.random.default_rng(K * 10 + D)
    fx, cx, cy, fxb = 458.0, 376.0, 240.0, float(np.float32(458.0 * 0.12))
    t = np.stack([[-spacing * k, 0.1 * spacing * k, 0.0] for k in range(K)])
    X = np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1, 1, L),
                  rng.uniform(2.5, 4.5, L)], -1)
    oc = np.stack([rng.permutation(K)[:D] for _ in range(L)]).astype(np.int32)
    if ordered:
        oc = np.stack([(np.arange(D) + l // 64) % K for l in range(L)]).astype(np.int32)
    Xc = X[:, None, :] + t[oc]
    uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fx * Xc[..., 1] / Xc[..., 2] + cy], -1)
    xr = np.where(rng.random((L, D)) < (0.5 if stereo else 0.0),
                  uv[..., 0] - fxb / Xc[..., 2], -1.0)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.random((L, D)) < 0.05
    uv[out] += 25.0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=dev)
    cam_t = t + np.concatenate([[[0, 0, 0]], rng.normal(0, 0.01, (K - 1, 3))])
    lm_pos = X + rng.normal(0, 0.01, X.shape)
    valid = rng.random((L, D)) < (0.9 if ordered else 0.95)
    if ordered:
        oc[~valid] = 0
    prob = ba.BAProblem(
        cam_R=f(np.tile(np.eye(3), (K, 1, 1))), cam_t=f(cam_t),
        cam_fixed=b(np.arange(K) == 0), cam_valid=b(np.ones(K)),
        lm_pos=f(lm_pos), lm_valid=b(np.ones(L)),
        obs_cam=torch.as_tensor(oc, device=dev), obs_uv=f(uv), obs_x_right=f(xr),
        obs_inv_sigma_sq=f(np.ones((L, D))), obs_valid=b(valid),
        lm_keep_inlier=b(rng.random(L) < 1 / 3) if keep else None)
    return prob, CamScalars(fx, fx, cx, cy, 752.0, 480.0, fxb)


@pytest.mark.parametrize("K,L,D,stereo", [(2, 1000, 2, False), (4, 300, 3, True)])
def test_ba_kernels_match_plain(dev, K, L, D, stereo):
    """Kernels F, G, H, I against the plain BA: poses within 1e-4, points
    seen twice within 1e-3 (chip_smoke.py measured 4.7e-5 at L=4096; the
    atomics' summation order moves them), outlier flags identical, every
    kernel launched."""
    from stella_vslam_tpu_torch.ops.optim import ba

    prob, cam = _ba_problem(dev, K, L, D, stereo)
    before = ba.ba_reduced_solve.launches, ba.ba_classify.launches
    rk = ba.bundle_adjust(prob, cam)
    rp = ba.bundle_adjust_plain(prob, cam)
    assert ba.ba_reduced_solve.launches > before[0]
    assert ba.ba_classify.launches == before[1] + 2
    assert float((rk.cam_R - rp.cam_R).abs().max()) < 1e-4
    assert float((rk.cam_t - rp.cam_t).abs().max()) < 1e-4
    good = (prob.obs_valid & ~rp.obs_is_outlier).sum(1) >= 2
    assert float((rk.lm_pos - rp.lm_pos)[good].abs().max()) < 1e-3
    assert torch.equal(rk.obs_is_outlier, rp.obs_is_outlier)


@pytest.mark.parametrize("final", [False, True])
def test_ba_classify_kernel_matches_plain(dev, final):
    """Kernel I at the initial state of a stereo problem with lm_keep_inlier
    rows: the same masks as its plain version (the same float32 expression
    per observation, so equal up to a chi-square within an ulp of its
    threshold: at most 0.1% of the observations)."""
    from stella_vslam_tpu_torch.ops.optim import ba

    prob, cam = _ba_problem(dev, 4, 777, 3, True, keep=True)
    k = ba.ba_classify(ba._KernelState(prob, cam), final)
    p = ba.classify_plain(prob, cam, prob.cam_R, prob.cam_t, prob.lm_pos, final)
    assert k.dtype == torch.bool and k.shape == p.shape
    assert float((k != p).float().mean()) <= 1e-3


def test_ba_kernels_match_plain_at_local_shape(dev):
    """F-I at the mapping module's local-BA shape (K=16 cameras 0.1 m apart,
    D=12 observers per landmark in the local BA's ordered layout, 3 + 6
    iterations), against the plain BA with the bounds above."""
    from stella_vslam_tpu_torch.ops.optim import ba

    prob, cam = _ba_problem(dev, 16, 1500, 12, False, spacing=0.1, ordered=True)
    rk = ba.bundle_adjust(prob, cam, num_first=3, num_second=6)
    rp = ba.bundle_adjust_plain(prob, cam, num_first=3, num_second=6)
    assert float((rk.cam_R - rp.cam_R).abs().max()) < 1e-4
    assert float((rk.cam_t - rp.cam_t).abs().max()) < 1e-4
    good = (prob.obs_valid & ~rp.obs_is_outlier).sum(1) >= 2
    assert float((rk.lm_pos - rp.lm_pos)[good].abs().max()) < 1e-3
    assert torch.equal(rk.obs_is_outlier, rp.obs_is_outlier)


def _mapping_scene(dev, B=3, N1=300, N2=517, P=600, seed=0):
    """A new keyframe (row 0) and B neighbours 0.1 m apart facing points
    3.5-4.5 m away: N1 / N2 keypoints per view, each a view of one of P
    points (bearing noise 1e-4, 0-2 flipped descriptor bits, angle within 5
    degrees, the point's octave 0-3); 90% unassociated, 10% stereo. Returns
    (MappingKernels, cur, nbrs, poses [B+1,12], the points, their
    descriptors and octaves)."""
    from stella_vslam_tpu_torch.camera.base import camera_from_yaml
    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.module.mapping_kernels import MappingKernels, TriKeyframe

    rng = np.random.default_rng(seed)
    cam = camera_from_yaml({
        "name": "test", "setup": "monocular", "model": "perspective", "fx": 458.0,
        "fy": 458.0, "cx": 376.0, "cy": 240.0, "k1": 0.0, "k2": 0.0, "p1": 0.0,
        "p2": 0.0, "k3": 0.0, "fps": 20.0, "cols": 752, "rows": 480,
        "color_order": "Gray"})
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
        uv = np.stack([458.0 * xc[:, 0] / xc[:, 2] + 376.0, 458.0 * xc[:, 1] / xc[:, 2] + 240.0],
                      -1) + rng.normal(0, 0.5, (n, 2))
        d = desc[ids].copy()
        for _ in range(2):
            d[np.arange(n), rng.integers(0, 8, n)] ^= (
                rng.random(n) < 0.5).astype(np.uint32) << rng.integers(0, 32, n).astype(np.uint32)
        views.append((uv, level[ids], d.view(np.int32), bear,
                      angle[ids] + rng.normal(0, 0.05, n), rng.random(n) < 0.9,
                      rng.random(n) < 0.1))

    def tk(vs):
        f = lambda i, dt: torch.as_tensor(np.stack([v[i] for v in vs]).astype(dt), device=dev)
        return TriKeyframe(f(0, np.float32), f(1, np.int32), f(2, np.int32),
                           f(3, np.float32), f(4, np.float32), f(5, bool), f(6, bool))

    cur = TriKeyframe(*[x[0] for x in tk(views[:1])])
    mk = MappingKernels(cam, OrbParams(num_levels=4), device=dev)
    return mk, cur, tk(views[1:]), torch.as_tensor(poses, device=dev), X, desc, level


def test_epipolar_top2_and_triangulate_kernels_match_plain(dev):
    """Kernel J against its plain version on the same gate terms (rows
    differing <= 1e-3), then kernel K on J's matches (ok flags differing
    <= 1e-3, positions within 1e-4 relative where both are ok), a padding
    neighbour masked."""
    from stella_vslam_tpu_torch.match import robust
    from stella_vslam_tpu_torch.module import mapping_kernels as mkm

    mk, cur, nbrs, poses, _, _, _ = _mapping_scene(dev)
    E_12, epl2 = mkm.epipolar_terms(poses)
    gate = robust.epipolar_gate(cur.angle, cur.level, cur.bear, cur.stereo, nbrs.angle,
                                nbrs.bear, nbrs.stereo, E_12, epl2,
                                scale_factors=mk.scale_factors)
    args = (cur.desc, nbrs.desc, cur.unassoc, nbrs.unassoc, gate)
    before = H.epipolar_top2.launches
    k, p = H.epipolar_top2(*args), H.epipolar_top2_plain(*args)
    assert H.epipolar_top2.launches == before + 1
    differ = torch.zeros_like(k[0], dtype=torch.bool)
    for a, b in zip(k, p):
        differ |= a != b
    assert float(differ.float().mean()) <= 1e-3
    idx2, accepted, _ = robust.match_for_triangulation(
        cur.angle, cur.level, cur.desc, cur.bear, cur.unassoc, cur.stereo, nbrs.angle,
        nbrs.desc, nbrs.bear, nbrs.unassoc, nbrs.stereo, E_12, epl2,
        scale_factors=mk.scale_factors)
    assert int(accepted.sum()) > 100
    pair_valid = torch.tensor([True, True, False], device=dev)
    kargs = (cur.uv, cur.level, cur.bear, nbrs.uv, nbrs.level, nbrs.bear, poses,
             idx2.contiguous(), accepted, pair_valid, mk.cam, mk.level_sigma_sq,
             mk.scale_factors)
    rk, rp = mkm.triangulate_checks(*kargs), mkm.triangulate_checks_plain(*kargs)
    assert int(rp.ok.sum()) > 100 and not bool(rk.ok[2].any())
    assert float((rk.ok != rp.ok).float().mean()) <= 1e-3
    assert torch.equal(rk.idx2[rk.ok & rp.ok], rp.idx2[rk.ok & rp.ok])
    both = rk.ok & rp.ok
    rel = torch.linalg.norm(rk.pos_w - rp.pos_w, dim=-1) / torch.linalg.norm(rp.pos_w, dim=-1)
    assert float(rel[both].max()) < 1e-4


def test_fuse_kernel_matches_plain(dev):
    """Kernel L against its plain version: B keyframes (one padding) x M
    landmarks (the scene's points with their ranges and normals, a tail of
    padding rows): accepted flags differing <= 1e-3."""
    from stella_vslam_tpu_torch.module import mapping_kernels as mkm

    mk, _, nbrs, poses, X, desc, level = _mapping_scene(dev, seed=1)
    B, N = nbrs.uv.shape[0], nbrs.uv.shape[1]
    rng = np.random.default_rng(2)
    P, M = len(X), len(X) + 77
    dist = np.linalg.norm(X, axis=1)  # from the new keyframe's centre, the origin
    lm_f = np.zeros((M, 8), np.float32)
    lm_f[:P, :3] = X + rng.normal(0, 1e-3, X.shape)
    lm_f[:P, 4] = dist * 1.2 ** level
    lm_f[:P, 3] = lm_f[:P, 4] / 1.2 ** 3
    lm_f[:P, 5:] = X / dist[:, None]
    lm_desc = np.zeros((M, 8), np.uint32)
    lm_desc[:P] = desc
    xr = torch.where(nbrs.stereo, nbrs.uv[..., 0] - 20.0, torch.full_like(nbrs.uv[..., 0], -1.0))
    kfs = mkm.FuseKeyframes(nbrs.uv, nbrs.level, nbrs.desc, nbrs.unassoc, xr.contiguous())
    t = lambda a: torch.as_tensor(a, device=dev)
    args = (kfs, poses[1:].contiguous(), t(np.arange(B) < B - 1), t(lm_f),
            t(lm_desc.view(np.int32)), t(np.arange(M) < P - 20), mk.cam, mk.scale_factors,
            mk.level_sigma_sq, mk.log_scale)
    before = mkm.fuse_scan.launches
    k, p = mkm.fuse_scan(*args), mkm.fuse_scan_plain(*args)
    assert mkm.fuse_scan.launches == before + 1
    acc_k, acc_p = mkm.accept_fused(*k, N), mkm.accept_fused(*p, N)
    assert int(acc_p.sum()) > 100 and not bool(acc_k[B - 1].any())
    assert float((acc_k != acc_p).float().mean()) <= 1e-3


# ---------------------------------------------------------------------------
# the loop closer's kernels M, N, O, P, and F-I at the global shape
# (problem builders shared with chip_smoke.py, at small and ragged sizes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N", [1, 130, 2872])
def test_bow_transform_kernel_matches_plain(dev, N):
    from stella_vslam_tpu_torch.data import bow_vocabulary as bow

    vocab = bow.BowVocabulary.default(dev)
    rng = np.random.default_rng(N)
    d = torch.from_numpy(rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
                         .view(np.int32)).to(dev)
    before = bow.bow_transform.launches
    k = vocab.transform(d)
    assert bow.bow_transform.launches == before + 1
    assert torch.equal(k, bow.bow_transform_plain(d, vocab.packed_centers()))
    assert int(k.min()) >= 0 and int(k.max()) < vocab.num_words


@pytest.mark.parametrize("N", [40, 700])
def test_pnp_kernel_matches_plain(dev, N):
    import chip_smoke

    args, sf = chip_smoke._pnp_problem(dev, N, N)
    chip_smoke._check_pnp(args, sf, f"N={N}", seed=N)


@pytest.mark.parametrize("N,fix_scale", [(15, False), (500, False), (500, True)])
def test_sim3_transform_kernel_matches_plain(dev, N, fix_scale):
    import chip_smoke

    args = chip_smoke._transform_problem(dev, N, N)
    # 13 inliers leave the scale weakly observed: the order of the sums moves
    # it by 2e-4, so the smallest problem is held to 1e-3
    chip_smoke._check_transform(args, dict(fix_scale=fix_scale), f"N={N} fix_scale={fix_scale}",
                                tol=1e-3 if N < 50 else 1e-4)


@pytest.mark.parametrize("K,Kp,Ep", [(12, 16, 32), (30, 32, 128)])
def test_pose_graph_kernel_matches_plain(dev, K, Kp, Ep):
    import chip_smoke

    args = chip_smoke._graph_problem(dev, K, Kp, Ep, K)
    chip_smoke._check_pose_graph(args, f"K={K}")


@pytest.mark.parametrize("K", [32, 40, 64, 128])
def test_ba_kernels_match_plain_at_global_shape(dev, K):
    """One Huber stage of 16 at D = 16: K = 32 factors in shared memory and
    sums the Schur terms in a block's copy, K = 40 sums them in device
    memory (every K from 39 on), K = 64 and 128 factor there too."""
    import chip_smoke

    prob, cam = chip_smoke._ba_problem(dev, K, 1024, 16, False, K, spacing=0.1, ordered=True)
    w = chip_smoke._lockstep_ba(prob, cam, 16, 0)
    assert w["f_excess"] < 1.0 and w["g_backward"] < 1e-3 and w["g_pose"] < 1e-5
    assert w["point_share"] < 1.0 and w["cost_rel"] < 1e-4
    assert w["decisions"] == 0 and w["flags"] == 0


@pytest.mark.parametrize("M,N", [(1, 1), (37, 20), (2872, 2872), (4096, 2872)])
def test_scatter_to_current_kernel_matches_plain(dev, M, N):
    """Kernel Q's scatter: strided slot indices and ids, table rows as they
    are packed; every output equal to the plain version's."""
    import chip_smoke
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    best, acc, tbl, ids = chip_smoke._assoc_problem(dev, M, N, M + N)
    before = tk.scatter_to_current.launches
    k = tk.scatter_to_current(best[:, 1], acc, tbl[:, 0:3], ids[:, 8], N)
    p = tk.scatter_to_current_plain(best[:, 1], acc, tbl[:, 0:3], ids[:, 8], N)
    assert tk.scatter_to_current.launches == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [1, 50, 2872, 4096])
def test_dedup_by_id_kernel_matches_plain(dev, N):
    """Kernel Q's dedup with repeated ids, equal scores (ties to the lowest
    slot), id -1 among the held slots and all-invalid rows."""
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    g = torch.Generator().manual_seed(N)
    has = (torch.rand(N, generator=g) < 0.8).to(dev)
    ids = torch.randint(-1, max(2, N // 4), (N,), generator=g, dtype=torch.int32).to(dev)
    score = torch.randint(0, 6, (N,), generator=g).to(torch.float32).to(dev)
    score = torch.where(has, score, torch.full_like(score, float("inf")))
    for h in (has, torch.zeros_like(has)):
        k = tk.dedup_by_id(h, ids, score)
        p = tk.dedup_by_id_plain(h, ids, score)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("N,C", [(8, 8), (2872, 4096)])
def test_rebase_chain_kernel_matches_plain(dev, N, C):
    """Kernel Q's rebase: ids absent from the table, ids repeated in it
    (the lowest row wins), -1 ids on both sides; ints equal, poses within
    1e-6."""
    from stella_vslam_tpu_torch.module import tracking_kernels as tk

    g = torch.Generator().manual_seed(C)
    la_id = torch.randint(-1, 3 * C // 2, (N,), generator=g, dtype=torch.int32)
    tbl_u32 = torch.randint(0, 1 << 30, (C, 10), generator=g, dtype=torch.int32)
    tbl_u32[:, 8] = torch.randint(-1, C, (C,), generator=g, dtype=torch.int32)
    args = [torch.randn(N, 3, generator=g), torch.rand(N, generator=g) < 0.9, la_id,
            torch.randn(C, 8, generator=g), tbl_u32] + \
        [torch.linalg.qr(torch.randn(3, 3, generator=g))[0] if i % 2 == 0
         else torch.randn(3, generator=g) for i in range(6)]
    args = [a.to(dev).contiguous() for a in args]
    k = tk.rebase_chain(*args)
    p = tk.rebase_chain_plain(*args)
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a, b)
    for a, b in zip(k[3:], p[3:]):
        assert float((a - b).abs().max()) < 1e-6


@pytest.mark.parametrize("M", [1, 300, 4096])
def test_reproject_gate_kernel_matches_plain(dev, M):
    """Kernel R's projection of points and of a packed table: uv and x_right
    within 1e-5 relative (of at least 100 px); flags and predicted levels equal except where
    the deciding quantity lies within 1e-6 of its threshold (none here)."""
    from stella_vslam_tpu_torch.camera import base as cb

    g = torch.Generator().manual_seed(M)
    p = cb.make_params(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752, height=480,
                       focal_x_baseline=458.0 * 0.12)
    R = torch.linalg.qr(torch.eye(3) + 0.05 * torch.randn(3, 3, generator=g))[0]
    R = R * torch.sign(torch.det(R))
    t = torch.tensor([0.1, -0.2, 0.3])
    # depths 1-6 m in front, a tenth of the points 1.5-6 m behind the camera
    # (a depth near 0 turns an ulp of z into pixels: no tracked point sits there)
    z = torch.rand(M, 1, generator=g) * 5.0 + 1.0
    z = torch.where(torch.rand(M, 1, generator=g) < 0.1, -(z + 0.5), z)
    pos = torch.cat([torch.rand(M, 2, generator=g) * 8 - 4, z], 1)
    normal = torch.nn.functional.normalize(torch.randn(M, 3, generator=g), dim=1)
    dist = torch.linalg.norm(pos, dim=1, keepdim=True)
    # min / max distances at random factors of the true distance, so that no
    # gate or level sits on its threshold by construction
    f = torch.rand(M, 2, generator=g)
    tbl = torch.cat([pos, normal, (0.9 + 0.6 * f[:, :1]) * dist, (0.8 + 2.0 * f[:, 1:]) * dist], 1)
    tbl_u32 = torch.zeros(M, 10, dtype=torch.int32)
    tbl_u32[:, 9] = (torch.rand(M, generator=g) < 0.9).to(torch.int32)
    R, t, pos, tbl, tbl_u32 = (a.to(dev).contiguous() for a in (R, t, pos, tbl, tbl_u32))
    for a, kw in (((pos,), {}), ((tbl, tbl_u32), dict(log_scale=float(np.log(np.float32(1.2))),
                                                     num_levels=8))):
        k = cb.reproject_gate(p, R, t, *a, **kw)
        q = cb.reproject_gate_plain(p, R, t, *a, **kw)
        # relative to the value, at least 100 px (near u = 0, fx x / z + cx
        # cancels and an ulp of cx is 3e-5 px)
        assert float(((k[0] - q[0]).abs() / q[0].abs().clamp(min=100.0)).max()) < 1e-5
        assert float(((k[3] - q[3]).abs() / q[3].abs().clamp(min=100.0)).max()) < 1e-5
        assert torch.equal(k[2], q[2])
        if k[4] is not None:
            assert torch.equal(k[4], q[4])


def test_undistort_norm_kernel_matches_plain(dev):
    from stella_vslam_tpu_torch.camera import base as cb

    p = cb.make_params(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
                       k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, width=752, height=480)
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(2872, 2, generator=g) * torch.tensor([752.0, 480.0])).to(dev)
    k, q = cb.undistort_norm(p, pts), cb.perspective_undistort(p, pts)
    assert float(((k - q).abs() / q.abs().clamp(min=100.0)).max()) < 1e-5


@pytest.mark.parametrize("distorted", [False, True])
def test_undistort_norm_kernel_equals_plain_bit_for_bit(dev, distorted):
    """Kernel R's undistortion rounds every operation as the torch
    expressions do on the card (a scalar divisor through its float32
    reciprocal, no FMA): with a true division and an FMA in `x * fx + cx`
    the bench camera's keypoints moved by an ulp and the mono slice
    initialized a frame earlier (ROADMAP Queue 3)."""
    from stella_vslam_tpu_torch.camera import base as cb

    k = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05) \
        if distorted else {}
    p = cb.make_params(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, **k)
    g = torch.Generator().manual_seed(1)
    pts = (torch.rand(2872, 2, generator=g) * torch.tensor([752.0, 480.0])).to(dev)
    assert torch.equal(cb.undistort_norm(p, pts), cb.perspective_undistort(p, pts))


@pytest.mark.parametrize("K,L,D", [(2, 4096, 2), (16, 4096, 12), (32, 1024, 16), (64, 1024, 16)])
def test_ba_kernels_repeat_bit_for_bit(dev, K, L, D):
    """Kernels F-I twice on the same problem: the same bits (F's sums and H's
    trial cost run in a fixed order)."""
    from stella_vslam_tpu_torch.ops.optim import ba

    prob, cam = _ba_problem(dev, K, L, D, False, spacing=0.1, ordered=K > 2)
    a = ba.bundle_adjust(prob, cam, num_first=5, num_second=5)
    b = ba.bundle_adjust(prob, cam, num_first=5, num_second=5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pose_graph_kernel_repeats_bit_for_bit(dev):
    import chip_smoke
    from stella_vslam_tpu_torch.ops.optim import sim3

    args = chip_smoke._graph_problem(dev, 30, 32, 128, 5)
    a = sim3.optimize_pose_graph(*args)
    b = sim3.optimize_pose_graph(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_resize_level_kernel_matches_matmul_pyramid(dev):
    """Kernel S: a pair's pyramid (one launch per level) equals the two
    images' single pyramids bit for bit, and the matmul pyramid to a few
    ulps (cuBLAS splits its sums differently on some entries)."""
    params = OrbParams(num_levels=5)
    ex = ox.OrbExtractor(params, 401, 299, min_area=400, device=dev)
    world = PlaneWorld(width=401, height=299, noise_sigma=2.0)
    imgs = torch.stack([torch.from_numpy(world.render(T)) for T in lateral_trajectory(2)]).to(dev)
    before = ox.resize_level.launches
    pair = ex.level_views(ex.pyramid_flat(imgs))
    assert ox.resize_level.launches == before + len(ex.levels) - 1
    for b in range(2):
        one = ex.pyramid(imgs[b])
        plain = ex.pyramid_plain(imgs[b])
        for lvl, (a, s, p) in enumerate(zip(pair, one, plain)):
            assert torch.equal(a[b], s)
            assert float((s - p).abs().max()) <= 1e-4, lvl


def test_fast_nms_kernel_batch_matches_plain(dev, frame):
    ex, levels = frame
    for img, g in zip(levels, ex.levels):
        batch = torch.stack([img, img.flip(1).contiguous()])
        k = ox.fast_nms(batch, g, ex.border, 20.0, 7.0)
        assert torch.equal(k, torch.stack([ox.fast_nms_plain(x, g, ex.border, 20.0, 7.0)
                                           for x in batch]))


def test_orb_describe_strips_kernel_matches_plain(dev, frame):
    ex, levels = frame
    pts = [ex.cell_keypoints(ox.fast_nms(l.contiguous(), g, ex.border, 20.0, 7.0), g)
           for l, g in zip(levels, ex.levels)]
    px, py, valid, _ = (torch.cat(c) for c in zip(*pts))
    args = (torch.cat([l.reshape(-1) for l in levels]), ex._slot_base, ex._slot_H,
            ex._slot_W, px.to(torch.int32), py.to(torch.int32), valid, ex._tables)
    before = ox.orb_describe_strips.launches
    ak, dk, sk = ox.orb_describe_strips(*args)
    ap, dp, sp = ox.orb_describe_plain(*args, strips=True)
    assert ox.orb_describe_strips.launches == before + 1
    assert torch.equal(sk[valid], sp[valid])
    assert float((ak - ap).abs().max()) < 1e-5


def _stereo_inputs(dev, NL, NR, seed):
    """Seeded matcher inputs: most right keypoints a shifted copy of a left
    one (a few flipped bits, the strip shifted by -5..5 px), some ties."""
    rng = np.random.default_rng(seed)
    l_xy = np.stack([rng.uniform(20, 380, NL), rng.choice([40.0, 90.0, 91.0, 150.0], NL)], -1)
    l_desc = rng.integers(0, 2 ** 32, (NL, 8), dtype=np.uint64).astype(np.uint32)
    l_strip = rng.integers(0, 256, (NL, 11, 21))
    l_lvl = rng.integers(0, 4, NL)
    r_xy = np.stack([rng.uniform(0, 400, NR), rng.choice([40.0, 90.0, 150.0], NR)], -1)
    r_desc = rng.integers(0, 2 ** 32, (NR, 8), dtype=np.uint64).astype(np.uint32)
    r_strip = rng.integers(0, 256, (NR, 11, 21))
    r_lvl = rng.integers(0, 4, NR)
    for j in range(min(NL, NR) * 3 // 4):
        i = j % NL
        r_xy[j] = (l_xy[i, 0] - rng.uniform(0, 30), l_xy[i, 1] + rng.uniform(-1, 1))
        r_lvl[j] = l_lvl[i]
        r_desc[j] = l_desc[i] ^ np.bitwise_and.reduce(
            rng.integers(0, 2 ** 32, (3, 8), dtype=np.uint64).astype(np.uint32), axis=0)
        r_strip[j] = np.clip(np.roll(l_strip[i], int(rng.integers(-5, 6)), axis=1)
                             + rng.integers(-2, 3, (11, 21)), 0, 255)
    if NR > 4:
        r_xy[-2:], r_desc[-2:], r_lvl[-2:] = r_xy[:2], r_desc[:2], r_lvl[:2]
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a).astype(dt), device=dev)
    sf = t(OrbParams(num_levels=4).scale_factors, np.float32)
    args = (t(l_xy, np.float32), t(l_lvl, np.int32), t(l_desc.view(np.int32), np.int32),
            t(rng.random(NL) < 0.95, bool), t(l_strip, np.uint8), t(r_xy, np.float32),
            t(r_lvl, np.int32), t(r_desc.view(np.int32), np.int32),
            t(rng.random(NR) < 0.95, bool), t(r_strip, np.uint8))
    return args, dict(scale_factors=sf, focal_x_baseline=38.4, true_baseline=0.12)


@pytest.mark.parametrize("NL,NR", [(1, 1), (37, 50), (300, 260), (2872, 2872)])
def test_stereo_match_kernel_matches_plain(dev, NL, NR):
    from stella_vslam_tpu_torch.match import stereo as st

    args, kw = _stereo_inputs(dev, NL, NR, NL + NR)
    before = st.stereo_match.launches
    xk, dk = st.stereo_match(*args, **kw)
    xp, dp = st.stereo_match_plain(*args, **kw)
    assert st.stereo_match.launches == before + 1
    m = dp > 0
    assert torch.equal(dk > 0, m)
    torch.testing.assert_close(xk[m], xp[m], rtol=1e-5, atol=0)
    torch.testing.assert_close(dk[m], dp[m], rtol=1e-5, atol=0)
