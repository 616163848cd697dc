"""The Python around kernel G's tiled solve and kernel W's shard table, on the CPU.

`linalg.spd_solve` (kernel G's plain SPD entry on CUDA tensors, the pose
graph's dense solve) takes the plain `solve_spd_blocked` for CPU tensors:
held here against the JAX package's `solve_spd_blocked`
(stella_vslam_tpu/ops/linalg.py:72) on seeded SPD systems, within 1e-5 of
the solution's largest entry (float32 on both sides, the same blocked
order), and its argument checks, which run before the device is looked at.
`solve_scratch_floats` sizes G's device-memory route (the tile count of the
padded system with its right-hand side as an extra row, plus the factored
diagonal tiles), and `_KernelState` allocates it only above a cluster's
reach. `shard_table` is kernel W's view of a sharded BA, built once per BA:
the same pointers and counts the C entry took per call before. The pose
graph on CPU tensors runs its plain version, solve and all.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stella_vslam_tpu.ops import linalg as jlinalg
from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.ops.optim import ba, sim3
from stella_vslam_tpu_torch.parallel import sharded_ba
from tests.test_torch_sim3 import _GKEYS, circle_graph

torch.set_num_threads(1)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n)).astype(np.float32)
    A = (M @ M.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    return A, rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 32, 70, 210])
def test_spd_solve_on_cpu_matches_jax(n):
    A, b = _spd(n, n)
    before = linalg.spd_solve.launches
    x = linalg.spd_solve(torch.from_numpy(A), torch.from_numpy(b))
    assert linalg.spd_solve.launches == before  # the plain version, no launch
    assert torch.equal(x, linalg.solve_spd_blocked(torch.from_numpy(A), torch.from_numpy(b)))
    xj = np.asarray(jlinalg.solve_spd_blocked(jnp.asarray(A), jnp.asarray(b)))
    assert x.shape == (n,) and x.dtype == torch.float32
    assert np.abs(x.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()


def test_spd_solve_checks_its_arguments():
    A, b = (torch.from_numpy(a) for a in _spd(6, 0))
    bad = [(A[:, :5], b), (A, b[:5]), (A.double(), b), (A, b.double()), (A.T, b),
           (A, b[None]), (A[None], b), (A, b.to("meta")), (torch.zeros((0, 0)), torch.zeros(0))]
    for a_, b_ in bad:
        with pytest.raises(ValueError, match="spd_solve"):
            linalg.spd_solve(a_, b_)


def test_solve_scratch_floats():
    """0 while one block or a cluster holds the system (n <= 768, K <= 128);
    above, (nt (nt + 1) / 2 + nt) tiles of 32 x 33 floats with nt =
    ceil((n + 1) / 32)."""
    assert linalg.solve_scratch_floats(1) == 0
    assert linalg.solve_scratch_floats(768) == 0
    assert linalg.solve_scratch_floats(774) == (325 + 25) * 1056
    assert linalg.solve_scratch_floats(3072) == (97 * 98 // 2 + 97) * 1056
    for n in range(769, 3100, 37):
        nt = -(-(n + 1) // 32)
        assert linalg.solve_scratch_floats(n) == (nt * (nt + 1) // 2 + nt) * 32 * 33


@pytest.mark.parametrize("K", [32, 128, 129])
def test_kernel_state_allocates_g_scratch_beyond_a_cluster(K):
    prob, cam = sharded_ba.dryrun_problem(1)
    prob = prob._replace(
        cam_R=torch.eye(3).expand(K, 3, 3).contiguous(), cam_t=torch.zeros(K, 3),
        cam_fixed=torch.arange(K) == 0, cam_valid=torch.ones(K, dtype=torch.bool),
        obs_cam=prob.obs_cam % K)
    st = ba._KernelState(prob, cam)
    floats = linalg.solve_scratch_floats(6 * K)
    assert (st.factor is None) == (K <= 128)
    assert st.factor is None or (st.factor.numel() == floats and st.factor.dtype == torch.float32)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_shard_table_equals_the_per_call_arrays(n):
    """Built once from the states: each shard's F-partial and H-cost
    pointers and counts in shard order, as the wrapper passed them per call
    before (L = 1000 over n shards: a ragged last chunk, empty shards at 4)."""
    prob, cam = sharded_ba.dryrun_problem(125)
    shards = sharded_ba.shard_problem(prob, ["cpu"] * n)
    states = [ba._KernelState(p, cam) for p in shards]
    t = ba.shard_table(states)
    assert t.count == n
    assert list(t.f_parts) == [st.f_part.data_ptr() for st in states]
    assert list(t.f_blocks) == [st.f_blocks for st in states]
    assert list(t.h_parts) == [st.h_part.data_ptr() for st in states]
    assert list(t.h_blocks) == [st.h_blocks for st in states]
    assert sum(t.f_blocks) == -(-1000 // ba.LM_CHUNK) and sum(t.h_blocks) == sum(t.f_blocks)
    with pytest.raises(ValueError, match="shard_table"):
        ba.shard_table([])
    with pytest.raises(ValueError, match="shard_table"):
        ba.shard_table(states[:1] * (ba.MAX_SHARDS + 1))


def test_pose_graph_on_cpu_solves_with_the_plain_version():
    """optimize_pose_graph on CPU tensors is the plain version with
    solve_spd_blocked, bit for bit, and launches no kernel."""
    g = circle_graph()
    args = [torch.from_numpy(np.array(g[k])) for k in _GKEYS]
    before = linalg.spd_solve.launches, sim3.pose_graph_linearize.launches
    rt = sim3.optimize_pose_graph(*args)
    rp = sim3.optimize_pose_graph_plain(*args, solve=linalg.solve_spd_blocked)
    for a, b in zip(rt, rp):
        assert torch.equal(a, b)
    assert (linalg.spd_solve.launches, sim3.pose_graph_linearize.launches) == before
