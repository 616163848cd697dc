"""The port's mapping triangulation against the JAX package's, on the CPU.

Three frames of the test plane world (400x300, 4 levels, min_size 400;
frames 0, 5 and 10 of lateral_trajectory at 0.02 m/frame, ground-truth
poses) stand in for a new keyframe (frame 10) and two covisible neighbours:
the JAX frames come from the JAX System's preprocess and the port's are
built from the same arrays (convert.frame). A seeded fifth of the keypoints
counts as already associated, and a tenth as stereo. Both packages get the
same inputs:

* match_for_triangulation (kernel J's plain version, batched over the
  neighbours) against the JAX matcher pair by pair: best distance, best
  index, second distance and accepted flags exact;
* create_E_21 within 1e-6 and triangulate_dlt within 1e-4 relative;
* MappingKernels.triangulate (J then K's plain version) against
  MappingKernels.triangulate_multi with a padding neighbour: idx2 and ok
  exact; pos_w, where ok, with a median within 1e-4 relative (|dX| / |X|)
  on both pairs, and a maximum within 1.2e-4 on the 0.2 m-baseline pair
  (frames 10 and 0) and within 1e-3 on the 0.1 m pair (frames 10 and 5,
  ~1.4 deg of parallax at 4 m). Those maxima are the float32 DLT's own
  floor, not a looser port: JAX's jitted and eager triangulate_dlt differ
  from each other by up to 1.11e-4 on the 0.2 m pair and 5.5e-4 on the
  0.1 m pair, and the port differs from the jitted one by 1.11e-4 and
  5.4e-4 (`python -m tests.test_torch_triangulation` prints them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.config import Config as JConfig
from stella_vslam_tpu.match import hamming as jH
from stella_vslam_tpu.match import robust as jR
from stella_vslam_tpu.module.mapping_kernels import MappingKernels as JMappingKernels
from stella_vslam_tpu.ops import triangulation as jtri
from stella_vslam_tpu.ops.solve import essential as jE
from stella_vslam_tpu.system import System as JSystem
from stella_vslam_tpu_torch import convert
from stella_vslam_tpu_torch.camera.base import camera_from_yaml
from stella_vslam_tpu_torch.feature.orb_params import OrbParams
from stella_vslam_tpu_torch.match import hamming as H
from stella_vslam_tpu_torch.match import robust as R
from stella_vslam_tpu_torch.module.mapping_kernels import MappingKernels, TriKeyframe
from stella_vslam_tpu_torch.ops import triangulation as tri
from stella_vslam_tpu_torch.ops.solve.essential import create_E_21
from tests.synthetic_world import PlaneWorld, lateral_trajectory
from tests.test_torch_initializer import cfg_dict

torch.set_num_threads(1)

FRAMES = (10, 0, 5)  # the new keyframe, then its neighbours


def make_data():
    world = PlaneWorld()
    gt = lateral_trajectory(11)
    jslam = JSystem(JConfig.from_dict(cfg_dict(world)), inline_mapping=True)
    jfr = [jslam.create_monocular_frame(world.render(gt[i]), i * 0.05) for i in FRAMES]
    cam = camera_from_yaml(world.camera_yaml())
    orb = OrbParams(num_levels=4)
    pfr = [convert.frame(f, cam, orb, device="cpu") for f in jfr]
    rng = np.random.default_rng(5)
    n = pfr[0].num_slots
    unassoc = [f.h_valid & (rng.random(n) < 0.8) for f in pfr]
    stereo = [rng.random(n) < 0.1 for _ in pfr]
    poses = [gt[i].astype(np.float32) for i in FRAMES]
    return dict(jslam=jslam, jfr=jfr, pfr=pfr, cam=cam, orb=orb, unassoc=unassoc,
                stereo=stereo, poses=poses)


@pytest.fixture(scope="module")
def data():
    return make_data()


def _j(f, i):
    """JAX keyframe tensors of frame i (angle, level, desc, bearing)."""
    return f[i].feats.angle, f[i].feats.level, f[i].feats.desc, f[i].bearings


def _geometry_jax(R1, t1, R2, t2):
    E_12 = jE.create_E_21(R2, t2, R1, t1)
    C1 = -R1.T @ t1
    ep = R2 @ C1 + t2
    return E_12, ep / jnp.maximum(jnp.linalg.norm(ep), 1e-12)


def _jax_match(d, b):
    """JAX match_for_triangulation of frame 10 against neighbour b, and
    the second-best distance of its gated matrix (robust.py:48-81)."""
    P = d["poses"]
    R1, t1 = jnp.asarray(P[0][:3, :3]), jnp.asarray(P[0][:3, 3])
    R2, t2 = jnp.asarray(P[b][:3, :3]), jnp.asarray(P[b][:3, 3])
    E_12, ep = _geometry_jax(R1, t1, R2, t2)
    f, un, st = d["jfr"], d["unassoc"], d["stereo"]
    a1, l1, d1, b1 = _j(f, 0)
    a2, _, d2, b2 = _j(f, b)
    sf = jnp.asarray(d["orb"].scale_factors, jnp.float32)
    idx, acc, best = jR.match_for_triangulation(
        a1, l1, d1, b1, jnp.asarray(un[0]), jnp.asarray(st[0]),
        a2, d2, b2, jnp.asarray(un[b]), jnp.asarray(st[b]), E_12, ep, True,
        scale_factors=sf)
    cand = jnp.asarray(un[0])[:, None] & jnp.asarray(un[b])[None, :]
    cosd = jnp.cos(a1)[:, None] * jnp.cos(a2)[None, :] + jnp.sin(a1)[:, None] * jnp.sin(a2)[None, :]
    cand = cand & (cosd >= jnp.cos(jnp.deg2rad(30.0)))
    near = jnp.einsum("j,nj->n", ep, b2) > jR._COS_EPIPOLE_THR
    cand = cand & ~((~jnp.asarray(st[0]))[:, None] & (~jnp.asarray(st[b]))[None, :]
                    & near[None, :])
    cand = cand & jH.check_epipolar_constraint(
        b1[:, None, :], b2[None, :, :], E_12, 0.2 * jnp.pi / 180.0,
        jH.take_small_table(sf, l1)[:, None])
    dist = jnp.where(cand, jH.pairwise_hamming(d1, d2), jH.MAX_HAMMING_DIST + 1)
    _, _, second = jH.best_and_second(dist, axis=1)
    return [np.asarray(x).astype(np.int64) for x in (best, idx, second, acc)]


def _port_geometry(d):
    P = torch.from_numpy(np.stack([np.concatenate([p[:3, :3].reshape(9), p[:3, 3]])
                                   for p in d["poses"]]).astype(np.float32))
    R, t = P[:, :9].reshape(-1, 3, 3), P[:, 9:12]
    return P, R, t


def _tri_keyframes(d, idx):
    f = d["pfr"]
    field = lambda fn: torch.stack([fn(f[i]) for i in idx])
    return TriKeyframe(
        field(lambda x: x.undist_xy), field(lambda x: x.feats.level),
        field(lambda x: x.feats.desc), field(lambda x: x.bearings),
        field(lambda x: x.feats.angle),
        torch.from_numpy(np.stack([d["unassoc"][i] for i in idx])),
        torch.from_numpy(np.stack([d["stereo"][i] for i in idx])))


def test_create_E_21_matches_jax(data):
    _, Rp, tp = _port_geometry(data)
    E = create_E_21(Rp[1:], tp[1:], Rp[0][None], tp[0][None]).numpy()
    for b in (1, 2):
        Ej = np.asarray(jE.create_E_21(jnp.asarray(Rp[b].numpy()), jnp.asarray(tp[b].numpy()),
                                       jnp.asarray(Rp[0].numpy()), jnp.asarray(tp[0].numpy())))
        np.testing.assert_allclose(E[b - 1], Ej, atol=1e-6)


def test_match_for_triangulation_exact(data):
    _, Rp, tp = _port_geometry(data)
    E_12 = create_E_21(Rp[1:], tp[1:], Rp[0][None], tp[0][None])
    C1 = -(Rp[0].T @ tp[0])
    ep = (Rp[1:] @ C1[:, None])[..., 0] + tp[1:]
    ep = ep / torch.clamp(torch.linalg.norm(ep, dim=-1, keepdim=True), min=1e-12)
    cur, nb = _tri_keyframes(data, [0]), _tri_keyframes(data, [1, 2])
    sf = torch.tensor(data["orb"].scale_factors, dtype=torch.float32)
    idx, acc, best = R.match_for_triangulation(
        cur.angle[0], cur.level[0], cur.desc[0], cur.bear[0], cur.unassoc[0], cur.stereo[0],
        nb.angle, nb.desc, nb.bear, nb.unassoc, nb.stereo, E_12, ep, scale_factors=sf)
    # the second-best distances through the same gates (kernel J's plain version)
    gate = R.epipolar_gate(cur.angle[0], cur.level[0], cur.bear[0], cur.stereo[0],
                           nb.angle, nb.bear, nb.stereo, E_12, ep, scale_factors=sf)
    _, _, second, _ = H.epipolar_top2_plain(cur.desc[0], nb.desc, cur.unassoc[0],
                                            nb.unassoc, gate)
    n_acc = 0
    for b in (1, 2):
        jb, jidx, jsecond, jacc = _jax_match(data, b)
        np.testing.assert_array_equal(best[b - 1].numpy(), jb)
        np.testing.assert_array_equal(idx[b - 1].numpy(), jidx)
        np.testing.assert_array_equal(second[b - 1].numpy(), jsecond)
        np.testing.assert_array_equal(acc[b - 1].numpy(), jacc)
        n_acc += int(jacc.sum())
    assert n_acc > 100, n_acc


def test_triangulate_dlt_matches_jax(data):
    rng = np.random.default_rng(2)
    X = np.stack([rng.uniform(-2, 2, 500), rng.uniform(-1.5, 1.5, 500),
                  rng.uniform(3, 6, 500)], -1)
    P = [p[:3, :].astype(np.float32) for p in data["poses"][:2]]
    bear = []
    for p in P:
        xc = X @ p[:, :3].T + p[:, 3]
        xc += rng.normal(0, 1e-3, xc.shape)
        bear.append((xc / np.linalg.norm(xc, axis=1, keepdims=True)).astype(np.float32))
    ours = tri.triangulate_dlt(torch.from_numpy(bear[0]), torch.from_numpy(bear[1]),
                               torch.from_numpy(P[0]), torch.from_numpy(P[1])).numpy()
    ref = np.asarray(jtri.triangulate_dlt(jnp.asarray(bear[0]), jnp.asarray(bear[1]),
                                          jnp.asarray(P[0]), jnp.asarray(P[1])))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_triangulate_matches_jax(data):
    """Neighbours 0 and 5 and a padding copy of 0 (pair_valid false)."""
    P, Rp, tp = _port_geometry(data)
    nb_idx = [1, 2, 1]
    P3 = torch.cat([P, P[1:2]])
    cur, nb = _tri_keyframes(data, [0]), _tri_keyframes(data, nb_idx)
    pair_valid = torch.tensor([True, True, False])
    mk = MappingKernels(data["cam"], data["orb"], device="cpu")
    ours = mk.triangulate(TriKeyframe(*[x[0] for x in cur]), nb, P3, pair_valid)

    jmk = JMappingKernels(data["jslam"].camera, data["jslam"].orb_params)
    f = data["jfr"]
    st = lambda fn: jnp.stack([fn(f[i]) for i in nb_idx])
    xr = jnp.full((len(nb_idx), f[0].num_slots), -1.0, jnp.float32)
    jres = jmk.triangulate_multi(
        f[0].undist_xy, f[0].feats.level, f[0].feats.desc, f[0].bearings, f[0].feats.angle,
        jnp.asarray(data["unassoc"][0]), jnp.asarray(data["stereo"][0]), xr[0],
        st(lambda x: x.undist_xy), st(lambda x: x.feats.level), st(lambda x: x.feats.desc),
        st(lambda x: x.bearings), st(lambda x: x.feats.angle),
        jnp.asarray(np.stack([data["unassoc"][i] for i in nb_idx])),
        jnp.asarray(np.stack([data["stereo"][i] for i in nb_idx])), xr,
        jnp.asarray(Rp[0].numpy()), jnp.asarray(tp[0].numpy()),
        jnp.asarray(P3[1:, :9].reshape(-1, 3, 3).numpy()), jnp.asarray(P3[1:, 9:12].numpy()),
        jnp.asarray(pair_valid.numpy()))
    ok_j = np.asarray(jres.ok)
    np.testing.assert_array_equal(ours.ok.numpy(), ok_j)
    np.testing.assert_array_equal(ours.idx2.numpy(), np.asarray(jres.idx2))
    assert ok_j[:2].sum() > 50 and not ok_j[2].any()
    pos_j = np.asarray(jres.pos_w)
    # neighbour 0 is the 0.2 m pair, neighbour 1 the 0.1 m pair
    for b, max_rel in ((0, 1.2e-4), (1, 1e-3)):
        pj = pos_j[b][ok_j[b]]
        rel = (np.linalg.norm(ours.pos_w.numpy()[b][ok_j[b]] - pj, axis=1)
               / np.linalg.norm(pj, axis=1))
        assert np.median(rel) < 1e-4 and rel.max() < max_rel, (b, np.median(rel), rel.max())


def dlt_spreads(d):
    """Per neighbour pair, on the slots the port triangulates: the largest
    relative position difference (|dX| / |X|) between the port's
    triangulate_dlt and JAX's jitted one, and between JAX's jitted and
    eager ones (the float32 DLT's own floor)."""
    import jax

    P, _, _ = _port_geometry(d)
    cur, nb = _tri_keyframes(d, [0]), _tri_keyframes(d, [1, 2])
    mk = MappingKernels(d["cam"], d["orb"], device="cpu")
    res = mk.triangulate(TriKeyframe(*[x[0] for x in cur]), nb, P, torch.tensor([True, True]))
    rel = lambda a, r: float((np.linalg.norm(a - r, axis=1) / np.linalg.norm(r, axis=1)).max())
    out = {}
    for b, name in ((0, "0.2 m pair"), (1, "0.1 m pair")):
        ok = res.ok[b].numpy()
        args = (cur.bear[0].numpy()[ok], nb.bear[b].numpy()[res.idx2[b].numpy()[ok]],
                d["poses"][0][:3, :].astype(np.float32),
                d["poses"][b + 1][:3, :].astype(np.float32))
        port = tri.triangulate_dlt(*[torch.from_numpy(a) for a in args]).numpy()
        jit = np.asarray(jax.jit(jtri.triangulate_dlt)(*[jnp.asarray(a) for a in args]))
        with jax.disable_jit():
            eager = np.asarray(jtri.triangulate_dlt(*[jnp.asarray(a) for a in args]))
        out[name] = dict(slots=int(ok.sum()), port_vs_jit=rel(port, jit),
                         jit_vs_eager=rel(jit, eager))
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_triangulation: the float32 DLT floor
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(dlt_spreads(make_data()))
