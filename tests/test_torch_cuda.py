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
