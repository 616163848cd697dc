"""Kernel Q's plain versions against the JAX package, on the CPU.

The port's chain rebase (tracking_kernels.rebase_chain, the plain version on
CPU tensors) against stella_vslam_tpu/tracking_module.py `_rebase_chain`, on
tests/test_chain_rebase.py's inputs and on seeded cases with ids absent from
the table, ids the table holds twice (the lowest row wins, as argmax takes
the first) and -1 ids on both sides; the per-slot scatter and the landmark
dedup against `_scatter_matches_to_current` and `_dedup_by_landmark_id`
(stella_vslam_tpu/module/tracking_kernels.py:64,83) on seeded inputs with
slots several sources pick, equal scores and all-invalid rows, also past
the 4096 slots kernel Q's dedup once took (N = 5000 for the scatter, 4999
for the dedup: the JAX [N,N] contraction under 25 M elements). Ints,
flags and gathered positions exact; the re-anchored poses within 1e-6
(two float32 products of another summation order). And a static check of
the kernels' sources: only csrc/smem_limit.cuh sets a shared-memory limit.
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.module.tracking_kernels import (
    _dedup_by_landmark_id, _scatter_matches_to_current)
from stella_vslam_tpu.tracking_module import _rebase_chain
from stella_vslam_tpu_torch.module import tracking_kernels as tk

torch.set_num_threads(1)


def _packed_table(tbl_ids, tbl_pos):
    """The port's packed device table: positions in columns 0-2 of the f32
    rows, ids in column 8 of the int32 rows."""
    C = len(tbl_ids)
    f32 = np.zeros((C, 8), np.float32)
    f32[:, 0:3] = tbl_pos
    u32 = np.zeros((C, 10), np.int32)
    u32[:, 8] = tbl_ids
    u32[:, 9] = tbl_ids >= 0
    return torch.from_numpy(f32), torch.from_numpy(u32)


def _rand_rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _case_from_chain_rebase_test():
    """tests/test_chain_rebase.py's positions-and-invalidations inputs with
    its pose re-anchoring inputs."""
    rng = np.random.default_rng(3)
    N, C = 64, 128
    la_id = np.full(N, -1, np.int32)
    la_id[:20] = rng.choice(500, 20, replace=False).astype(np.int32)
    la_pos = rng.normal(size=(N, 3)).astype(np.float32)
    tbl_ids = np.full(C, -1, np.int32)
    tbl_ids[:12] = la_id[:12]
    tbl_ids[12:40] = 1000 + np.arange(28)
    tbl_pos = rng.normal(size=(C, 3)).astype(np.float32)
    rng = np.random.default_rng(7)
    T_ref_old, T_ref_new, T_last, T_prev = (
        (_rand_rot(rng), rng.normal(size=3)) for _ in range(4))
    A = np.linalg.inv(_se3(*T_ref_old)) @ _se3(*T_ref_new)
    return (la_pos, la_id >= 0, la_id, tbl_ids, tbl_pos, A[:3, :3], A[:3, 3],
            *T_last, *T_prev)


def _se3(R, t):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _seeded_case(seed, N, C):
    """Chained ids partly absent from the table, a table that holds some
    ids twice and pads with -1, chained -1 ids, random poses."""
    rng = np.random.default_rng(seed)
    tbl_ids = rng.integers(-1, C, C).astype(np.int32)
    tbl_ids[rng.random(C) < 0.1] = -1
    la_id = np.where(rng.random(N) < 0.6, rng.choice(tbl_ids, N),
                     rng.integers(-1, 3 * C, N)).astype(np.int32)
    la_valid = (la_id >= 0) & (rng.random(N) < 0.9)
    pose = lambda: (_rand_rot(rng), rng.normal(size=3))
    return (rng.normal(size=(N, 3)).astype(np.float32), la_valid, la_id, tbl_ids,
            rng.normal(size=(C, 3)).astype(np.float32), *pose(), *pose(), *pose())


CASES = {"chain_rebase_test": _case_from_chain_rebase_test,
         "seeded_small": lambda: _seeded_case(1, 50, 40),
         "seeded_slice": lambda: _seeded_case(2, 2872, 4096)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rebase_chain_matches_jax(case):
    la_pos, la_valid, la_id, tbl_ids, tbl_pos, A_R, A_t, R_l, t_l, R_p, t_p = CASES[case]()
    f = lambda a: np.asarray(a, np.float32)
    j = _rebase_chain(jnp.asarray(la_pos), jnp.asarray(la_valid), jnp.asarray(la_id),
                      jnp.asarray(tbl_ids), jnp.asarray(tbl_pos),
                      *(jnp.asarray(f(a)) for a in (A_R, A_t, R_l, t_l, R_p, t_p)))
    tbl_f32, tbl_u32 = _packed_table(tbl_ids, tbl_pos)
    t = tk.rebase_chain(torch.from_numpy(la_pos), torch.from_numpy(la_valid),
                        torch.from_numpy(la_id), tbl_f32, tbl_u32,
                        *(torch.from_numpy(f(a)) for a in (A_R, A_t, R_l, t_l, R_p, t_p)))
    for a, b in zip(t[:3], j[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(t[3:], j[3:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def _matcher_output(seed, M, N):
    """best slot per source (a third of the sources drawn from a tenth of
    the slots: collisions), acceptance, positions and ids."""
    rng = np.random.default_rng(seed)
    best = rng.integers(0, N, M).astype(np.int32)
    crowd = rng.random(M) < 1 / 3
    best[crowd] = rng.integers(0, max(1, N // 10), int(crowd.sum()))
    acc = rng.random(M) < 0.7
    return best, acc, rng.normal(size=(M, 3)).astype(np.float32), \
        rng.integers(0, 10 * N, M).astype(np.int32)


@pytest.mark.parametrize("seed,M,N,all_invalid", [(4, 60, 40, False), (5, 4096, 2872, False),
                                                  (6, 300, 200, True), (10, 4096, 5000, False)])
def test_scatter_to_current_matches_jax(seed, M, N, all_invalid):
    best, acc, pos, ids = _matcher_output(seed, M, N)
    if all_invalid:
        acc[:] = False
    jp, ji, jh = _scatter_matches_to_current(jnp.asarray(best), jnp.asarray(acc),
                                             jnp.asarray(pos), jnp.asarray(ids), N)
    tp, ti, th = tk.scatter_to_current(torch.from_numpy(best), torch.from_numpy(acc),
                                       torch.from_numpy(pos), torch.from_numpy(ids), N)
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert 0 < int(th.sum()) < N or all_invalid


@pytest.mark.parametrize("seed,N,all_invalid", [(7, 50, False), (8, 2872, False), (9, 100, True),
                                               (11, 4999, False)])
def test_dedup_by_id_matches_jax(seed, N, all_invalid):
    """Repeated ids, scores drawn from 5 values (ties go to the lowest
    slot), not-held slots at +inf as the cascade passes them."""
    rng = np.random.default_rng(seed)
    has = (rng.random(N) < 0.8) & (not all_invalid)
    ids = rng.integers(0, max(2, N // 4), N).astype(np.int32)
    score = np.where(has, rng.integers(0, 5, N), np.inf).astype(np.float32)
    jh, ji = _dedup_by_landmark_id(jnp.asarray(has), jnp.asarray(ids), jnp.asarray(score))
    th, ti = tk.dedup_by_id(torch.from_numpy(has), torch.from_numpy(ids),
                            torch.from_numpy(score))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def test_only_smem_limit_sets_a_kernel_attribute():
    """A wrapper that sets its kernel's shared-memory limit on every launch
    races with a thread that launches it at another size (kernel Q's dedup
    from two Systems' tracking threads): every kernel raises its limit
    through svt::reserve_smem, under a lock and never lowering it."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "stella_vslam_tpu_torch", "csrc")
    sources = glob.glob(os.path.join(csrc, "*.cu")) + glob.glob(os.path.join(csrc, "*.cuh"))
    assert len(sources) > 10
    callers = [os.path.basename(p) for p in sources
               if "cudaFuncSetAttribute(" in open(p).read()]
    assert callers == ["smem_limit.cuh"], callers
    with open(os.path.join(csrc, "track_assoc.cu")) as f:
        text = f.read()
    # one reservation before each launch of kernel Q's
    launches = text.count("<<<") + text.count("return (int)launch_cluster(")
    assert text.count("svt::reserve_smem(") == launches == 4
