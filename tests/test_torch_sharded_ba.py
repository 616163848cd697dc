"""The port's sharded global BA (parallel/sharded_ba.py, K22) on the CPU.

The port's `sharded_bundle_adjust` on ["cpu"] * n (the plain version shard
by shard: F's terms on each shard's rows, added in shard order, G once, H
on each shard) against the JAX package's `sharded_bundle_adjust` on the
8-device virtual mesh of tests/conftest.py, on tests/test_ba.py's
build_problem(K=6, L=1024, D=6): 8 chunks of 128 landmarks, so each of 8
shards holds one (JAX's own test uses L = 64, less than one chunk); and at
L = 1000, a row count that is neither a multiple of 128 nor of the shard
count (JAX pads it, the port's last shard takes the rest).

Bounds, tighter than JAX's own (test_sharded_ba.py: 5e-3 absolute, 1e-3
relative, median point 1e-2): against JAX, poses and points within 1e-4
absolute (measured 8.6e-6 poses, 2.6e-5 points, for every n) and the
outlier flags equal; against the port's unsharded plain BA, poses and
points within 1e-5 relative to the largest entry (measured 4.7e-6: the
same arithmetic, with the camera-side sums of each shard's index_add_
added in shard order instead of one index_add_ over all rows). The
one-shard route is the unsharded BA exactly. The sharded GN step against
JAX's make_sharded_ba_step within 1e-4 (measured 1.8e-5).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from stella_vslam_tpu.ops.optim import ba as jba
from stella_vslam_tpu.parallel import sharded_ba as jsh
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.ops.optim import ba as tba
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars
from stella_vslam_tpu_torch.parallel import sharded_ba as tsh
from tests.test_ba import CAM, build_problem, reproj_rmse
from tests.test_torch_equirect_optim import MODEL as EQ_MODEL, TC as EQ_CAM, \
    _ba_problem as equirect_problem

torch.set_num_threads(1)

TCAM = CamScalars(*[float(np.float32(getattr(CAM, f))) for f in CamScalars._fields])
FIELDS = ("cam_R", "cam_t", "lm_pos")


def _mesh():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual devices"
    return Mesh(np.array(devs[:8]), axis_names=("data",))


def _abs(a, b):
    return {f: float(np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max())
            for f in FIELDS}


def _rel(a, b):
    return {f: float(np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max()
                     / np.abs(np.asarray(getattr(b, f))).max()) for f in FIELDS}


@pytest.fixture(scope="module", params=[1024, 1000], ids=["L1024", "L1000"])
def problem(request):
    L = request.param
    prob, poses, pts, _, _ = build_problem(K=6, L=L, D=6, rng=np.random.default_rng(3))
    rj = jsh.sharded_bundle_adjust(prob, CAM, mesh=_mesh())
    tprob = convert.ba_problem(prob, device="cpu")
    return dict(prob=prob, poses=poses, pts=pts, L=L, rj=rj, tprob=tprob,
                unsharded=tba.bundle_adjust(tprob, TCAM))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_ba_matches_jax_mesh(problem, n):
    rs = tsh.sharded_bundle_adjust(problem["tprob"], TCAM, devices=["cpu"] * n)
    assert rs.lm_pos.shape == (problem["L"], 3)
    d = _abs(rs, problem["rj"])
    assert max(d.values()) < 1e-4, d
    np.testing.assert_array_equal(rs.obs_is_outlier.numpy(),
                                  np.asarray(problem["rj"].obs_is_outlier))
    prob = problem["prob"]
    rmse = reproj_rmse(rs, problem["poses"], problem["pts"], np.array(prob.obs_valid),
                       np.array(prob.obs_cam), np.array(prob.obs_uv), problem["L"])
    assert rmse < 0.6, f"sharded reprojection RMSE {rmse}"


@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_ba_matches_unsharded(problem, n):
    rs = tsh.sharded_bundle_adjust(problem["tprob"], TCAM, devices=["cpu"] * n)
    r = _rel(rs, problem["unsharded"])
    assert max(r.values()) < 1e-5, r
    np.testing.assert_array_equal(rs.obs_is_outlier.numpy(),
                                  problem["unsharded"].obs_is_outlier.numpy())


def test_one_shard_is_the_unsharded_ba(problem):
    rs = tsh.sharded_bundle_adjust(problem["tprob"], TCAM, devices=["cpu"])
    for f in FIELDS + ("obs_is_outlier", "cost"):
        assert torch.equal(getattr(rs, f), getattr(problem["unsharded"], f)), f


def test_shards_are_whole_chunks():
    assert tsh.shard_bounds(1000, 8) == [(i * 128, min((i + 1) * 128, 1000))
                                         for i in range(8)]
    assert tsh.shard_bounds(4096, 4) == [(i * 1024, (i + 1) * 1024) for i in range(4)]
    # 8 chunks over 3 shards: 3, 3 and the rest
    assert tsh.shard_bounds(1024, 3) == [(0, 384), (384, 768), (768, 1024)]
    # fewer chunks than shards: the later shards are empty
    assert tsh.shard_bounds(32, 4) == [(0, 32), (32, 32), (32, 32), (32, 32)]


def test_no_cards_means_the_unsharded_ba():
    """Here no card is visible: default_devices() is None and devices=None
    runs the one-device bundle_adjust (JAX's own rule)."""
    assert tsh.default_devices() is None
    prob, _, _, _, _ = build_problem(K=4, L=256, D=4, rng=np.random.default_rng(5))
    tprob = convert.ba_problem(prob, device="cpu")
    a = tsh.sharded_bundle_adjust(tprob, TCAM, num_first=3, num_second=3)
    b = tba.bundle_adjust(tprob, TCAM, num_first=3, num_second=3)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_sharded_equirectangular_ba_matches_unsharded():
    """The sharded route takes the equirectangular model too: K = 8, D = 4,
    L = 512 (4 chunks) on 4 shards against the unsharded plain BA: poses
    within 1e-5 relative (measured 4.5e-7 of the largest entry), the same
    outlier flags; of the points seen twice (a point seen once is free
    along its ray) 99% within 1e-5 of the scene's size (measured 6.0e-7),
    and the worst no farther than twice what a 1e-7 relative change of the
    observations moves it in the unsharded BA (measured 4.0e-4 against a
    spread of 9.0e-4: an ill-conditioned point in a 4 m room)."""
    p = equirect_problem(8, 512, 4, seed=8)
    to_t = lambda q: tba.BAProblem(**{k: torch.from_numpy(v) for k, v in q.items()})
    ru = tba.bundle_adjust(to_t(p), EQ_CAM, model=EQ_MODEL)
    rs = tsh.sharded_bundle_adjust(to_t(p), EQ_CAM, model=EQ_MODEL, devices=["cpu"] * 4)
    rq = tba.bundle_adjust(to_t(dict(p, obs_uv=(p["obs_uv"] * (1 + 1e-7)).astype(np.float32))),
                           EQ_CAM, model=EQ_MODEL)
    for f in ("cam_R", "cam_t"):
        d = float((getattr(rs, f) - getattr(ru, f)).abs().max())
        assert d < 1e-5 * float(getattr(ru, f).abs().max()), (f, d)
    assert torch.equal(rs.obs_is_outlier, ru.obs_is_outlier)
    twice = torch.from_numpy((p["obs_valid"] & ~ru.obs_is_outlier.numpy()).sum(1) >= 2)
    assert int(twice.sum()) > 400
    d = (rs.lm_pos - ru.lm_pos).abs().max(1).values[twice]
    spread = float((rq.lm_pos - ru.lm_pos).abs().max(1).values[twice].max())
    assert float(torch.quantile(d, 0.99)) < 1e-5 * float(ru.lm_pos.abs().max())
    assert float(d.max()) <= 2 * spread, (float(d.max()), spread)


@pytest.fixture(scope="module")
def gn_step():
    prob, _, _, _, _ = build_problem(K=4, L=1024, D=4, noise=0.05,
                                     rng=np.random.default_rng(4))
    return prob, jsh.make_sharded_ba_step(_mesh(), CAM)(prob)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_sharded_gn_step_matches_jax(gn_step, n):
    prob, out_j = gn_step
    out_t = tsh.make_sharded_ba_step(["cpu"] * n, TCAM)(convert.ba_problem(prob, device="cpu"))
    d = {f: float(np.abs(np.asarray(getattr(out_j, f)) - getattr(out_t, f).numpy()).max())
         for f in FIELDS}
    assert max(d.values()) < 1e-4, d
    # the step moved the free cameras
    assert float((out_t.cam_t - convert.ba_problem(prob, device="cpu").cam_t).abs().max()) > 1e-4


def test_dryrun_multidevice_on_the_cpu():
    out = tsh.dryrun_multidevice(4, device="cpu")
    assert out.lm_pos.shape == (32, 3) and bool(torch.isfinite(out.cam_t).all())
    # the same step unsharded
    prob, cam = tsh.dryrun_problem(4)
    one = tsh.make_sharded_ba_step(["cpu"], cam)(prob)
    assert float((one.cam_t - out.cam_t).abs().max()) <= 1e-5 * float(one.cam_t.abs().max())


def test_shard_reduce_plain_adds_in_shard_and_block_order():
    """W's plain version: partials of K = 2 cameras (67 + 144 floats each),
    two shards of 3 and 2 blocks, added one by one from zero."""
    K, n = 2, 33 * 2 + 1 + 36 * 4
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(3 * n, generator=g), torch.randn(2 * n, generator=g)]
    hc, rhs, cost, S = tba.shard_reduce_plain(parts, K)
    acc = torch.zeros(n)
    for blk in torch.cat(parts).reshape(5, n):
        acc = acc + blk
    assert torch.equal(hc.reshape(-1), acc[:54]) and torch.equal(rhs, acc[54:66])
    assert torch.equal(cost, acc[66]) and torch.equal(S.reshape(-1), acc[67:])
