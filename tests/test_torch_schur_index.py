"""Kernel F's pair index (ba.schur_index_plain, the plain version of
csrc/ba_schur.cu ba_schur_index_kernel) and the plain sum over it
(ba.linearize_schur_indexed_plain), on the CPU.

The index must equal a brute-force enumeration of every landmark's pair
terms and every camera's observations, grouped and ordered as the kernel
groups them, on seeded observer tables (chip_smoke.schur_problem) with
padded slots, repeated cameras within a landmark, fixed and invalid
landmarks, a chunk with no valid observation and a ragged last chunk. The sum over it, chunk by chunk, must
give linearize_schur_plain's system within the float32 tolerance that
tests/test_torch_ba.py holds plain F to (1e-5 of the largest entry).
tests/test_torch_cuda.py holds the kernel's index to the plain one on the
same generator.
"""
import numpy as np
import pytest
import torch

from stella_vslam_tpu_torch.ops.optim import ba
from chip_smoke import schur_problem

torch.set_num_threads(1)


def brute_index(prob, K):
    """Per chunk: the pair terms as (kd, ke, od, oe) sorted by (kd, ke), the
    camera runs as {k: [od, ...]}, by plain loops."""
    oc = prob.obs_cam.numpy()
    L, D = oc.shape
    v = prob.obs_valid.numpy() & prob.lm_valid.numpy()[:, None]
    fixed = prob.lm_fixed.numpy() if prob.lm_fixed is not None else np.zeros(L, bool)
    out = []
    for c in range(-(-L // ba.LM_CHUNK)):
        terms, runs = [], {k: [] for k in range(K)}
        for l in range(c * ba.LM_CHUNK, min(L, (c + 1) * ba.LM_CHUNK)):
            for d in range(D):
                if v[l, d]:
                    runs[int(oc[l, d])].append(l * D + d)
                if fixed[l]:
                    continue
                for e in range(D):
                    if v[l, d] and v[l, e] and oc[l, d] <= oc[l, e]:
                        terms.append((int(oc[l, d]), int(oc[l, e]), l * D + d, l * D + e))
        terms.sort(key=lambda x: (x[0], x[1]))  # stable: (l, d, e) within a group
        out.append((terms, runs))
    return out


def check_index(ix, prob, K):
    """Asserts that `ix` equals brute_index(prob, K) entry by entry."""
    L, D = prob.obs_cam.shape
    nD = ba.LM_CHUNK * D
    assert (ix.cap_t, ix.cap_s) == ba.schur_index_caps(K, D)
    terms_flat = ix.terms.reshape(-1, 2)
    for c, (terms, runs) in enumerate(brute_index(prob, K)):
        n = int(ix.nterm[c])
        assert n == len(terms)
        got = ix.terms[c, :n].tolist()
        assert got == [[t[2], t[3]] for t in terms]
        groups = {}
        for t in terms:
            groups.setdefault((t[0], t[1]), []).append([t[2], t[3]])
        segs = ix.seg[c, :int(ix.nseg[c])].tolist()
        assert [(s[2], s[3]) for s in segs] == sorted(groups)
        for s in segs:
            assert terms_flat[s[0]:s[1]].tolist() == groups[(s[2], s[3])]
        for k in range(K):
            a, b = ix.cam_seg[c, k].tolist()
            assert c * nD <= a <= b <= (c + 1) * nD
            assert ix.cam_obs.reshape(-1)[a:b].tolist() == runs[k]


@pytest.mark.parametrize("K,L,D,seed", [(1, 200, 3, 1), (2, 300, 2, 2), (5, 4133 // 8, 4, 3),
                                        (16, 700, 12, 4), (130, 300, 8, 5)])
def test_schur_index_equals_brute_force(K, L, D, seed):
    prob, _ = schur_problem(K, L, D, seed)
    ix = ba.schur_index_plain(prob.obs_cam, prob.obs_valid, prob.lm_valid, prob.lm_fixed, K)
    check_index(ix, prob, K)
    assert ix.n_terms > 0
    if L > 256:  # the empty chunk has no term and no camera run
        assert int(ix.nterm[1]) == 0 and int(ix.nseg[1]) == 0
        assert bool((ix.cam_seg[1, :, 0] == ix.cam_seg[1, :, 1]).all())


def test_schur_index_without_fixed_rows_and_with_every_slot_repeated():
    """lm_fixed None; every slot of a landmark on one camera (the D^2 worst
    case the index's capacity is sized for)."""
    prob, _ = schur_problem(3, 260, 5, 7, empty_chunk=False)
    oc = prob.obs_cam.clone()
    oc[:64] = 2
    prob = prob._replace(lm_fixed=None, obs_cam=oc,
                         obs_valid=prob.obs_valid | (torch.arange(260) < 64)[:, None])
    ix = ba.schur_index_plain(prob.obs_cam, prob.obs_valid, prob.lm_valid, None, 3)
    check_index(ix, prob, 3)
    assert int(ix.terms.shape[1]) == ix.cap_t == ba.LM_CHUNK * 25


@pytest.mark.parametrize("K,L,D,model,huber", [(4, 300, 3, "perspective", True),
                                               (16, 600, 12, "perspective", False),
                                               (1, 200, 2, "perspective", True),
                                               (6, 333, 4, "equirectangular", True)])
def test_indexed_sum_equals_plain_linearize(K, L, D, model, huber):
    """The chunk-by-chunk sum over the index (one triangle of S mirrored)
    against linearize_schur_plain: cost, Hcc, b_c, S_red and rhs_red within
    1e-5 of each one's largest entry, the landmark terms equal."""
    prob, cam = schur_problem(K, L, D, 11 + K, model=model)
    inlier = torch.ones_like(prob.obs_valid)
    lam = torch.tensor(1e-4)
    a = ba.linearize_schur_plain(prob, cam, prob.cam_R, prob.cam_t, prob.lm_pos, inlier, lam,
                                 huber, model)
    b = ba.linearize_schur_indexed_plain(prob, cam, prob.cam_R, prob.cam_t, prob.lm_pos,
                                         inlier, lam, huber, model)
    for x, y in zip(a[:5], b[:5]):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) <= 1e-5 * max(float(x.abs().max()), 1e-30)
    S = b[3]
    n = 6 * K
    blocks = S.reshape(K, 6, K, 6).permute(0, 2, 1, 3)
    off = ~torch.eye(K, dtype=torch.bool)
    # off-diagonal blocks are exact mirrors: S is computed on one triangle
    assert torch.equal(blocks[off], blocks.transpose(0, 1)[off].transpose(-1, -2))
    assert S.shape == (n, n)
    for x, y in zip(a[5], b[5]):
        assert torch.equal(x, y)
