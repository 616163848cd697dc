"""Batched two-view RANSAC: the hashed sampler and kernel E.

Port of stella_vslam_tpu/ops/solve/ransac.py (`hash_uniform` :30,
`sample_minimal_sets` :50, `escalate_scan` :84,
`select_best` :110) and of the `_find_core` shared by homography.py (:107),
fundamental.py (:73) and essential.py (:82; on bearing vectors [N,3]).
Every hypothesis of a batch is evaluated at once: B minimal sets are
drawn by a Gumbel-argmax over a counter-based hash of
(seed, flat index), each set is solved by the normalised DLT with the
18-squaring null vector (ops/linalg.smallest_eigvec_spd), every model scores
all N matches with a chi-square capped cost, and the lowest cost among
models with more than `set_size` inliers wins.

Seeds are plain uint32 integers chosen by the caller (the JAX version derives
them from jax.random keys, `_seed_from_key` :21). The hash is reproduced bit
for bit: uint32 wraparound in int64 with `& 0xFFFFFFFF`, argmax ties to the
lowest index, invalid positions at -1.0.

Kernel E (csrc/ransac_two_view.cu) runs a batch on CUDA tensors in two
launches: `minimal_hypotheses` (a block a hypothesis: sample, one warp to
fit, score, reduce; one launch for all the chunks of an escalated sweep)
and `finish_core` (a block a chunk: the argmin, the winner's inlier
mask and the LO refits over masked sets, and an escalated sweep's carry
over the chunks); `score_models` scores given essential matrices (the
5-point solver's candidates), whose selection and LO rounds are
finish_core's. On CPU tensors the same functions run their plain versions
below.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Callable, NamedTuple, Sequence

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild

_M32 = 0xFFFFFFFF
_BIG = 3.0e38
# hypotheses per chunk of the plain sampler: bounds its [b, k, N] int64 hash
_PLAIN_CHUNK = 256
# chunk seeds of one minimal launch (the escalated sweep takes 8)
MAX_CHUNKS = 16


class TwoViewModel(NamedTuple):
    """A model family for kernel E: its template index (0 homography,
    1 fundamental, 2 essential), minimal set size (the winner needs more
    inliers than it), DLT solver and cost function (the plain versions the
    kernel reproduces)."""

    kind: int
    set_size: int
    compute: Callable  # (pts1 [..., k, D], pts2, valid=None) -> [..., 3, 3]
    cost: Callable  # (M [..., 3, 3], pts1 [..., N, D], pts2, sigma) -> (inlier, cost)

    @property
    def dim(self) -> int:
        """Coordinates per correspondence: pixels, or bearings for E."""
        return 3 if self.kind == 2 else 2


class TwoViewResult(NamedTuple):
    model: torch.Tensor  # [3,3]
    is_inlier: torch.Tensor  # [N] bool
    cost: torch.Tensor  # scalar f32 (3e38 when no model is valid)
    num_inliers: torch.Tensor  # scalar i64
    valid: torch.Tensor  # scalar bool


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_uniform(seed: int, start: int, count: int, device) -> torch.Tensor:
    """Uniform [0,1) f32 of flat indices start..start+count-1 under `seed`:
    the xorshift-multiply hash of the JAX version, bit for bit."""
    x = torch.arange(start, start + count, dtype=torch.int64, device=device)
    x = (x + _mul32(torch.tensor(int(seed) & _M32, dtype=torch.int64), 2654435761)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_minimal_sets(seed: int, valid: torch.Tensor, num_hypotheses: int,
                        set_size: int) -> torch.Tensor:
    """[B, k] int64 indices drawn uniformly from the valid positions: per
    (hypothesis, slot) the argmax of the hashed uniforms over N, masked to
    -1.0 where invalid (index 0 when nothing is valid)."""
    n = valid.shape[0]
    out = []
    for b0 in range(0, num_hypotheses, _PLAIN_CHUNK):
        b1 = min(num_hypotheses, b0 + _PLAIN_CHUNK)
        g = hash_uniform(seed, b0 * set_size * n, (b1 - b0) * set_size * n,
                         valid.device).reshape(b1 - b0, set_size, n)
        masked = torch.where(valid[None, None, :], g, torch.full_like(g, -1.0))
        out.append(torch.argmax(masked, dim=-1))
    return torch.cat(out)


def select_best(cost: torch.Tensor, num_inliers: torch.Tensor, min_inliers: int):
    """Lowest cost among hypotheses with more than min_inliers inliers
    (first on ties). Returns (best_idx, valid)."""
    gated = torch.where(num_inliers > min_inliers, cost, torch.full_like(cost, _BIG))
    best = torch.argmin(gated)
    return best, gated[best] < _BIG


# ---------------------------------------------------------------------------
# kernel E wrappers: the CUDA kernel on CUDA tensors, the plain version on CPU
# ---------------------------------------------------------------------------


def _chi_thr(sigma: float) -> float:
    return 5.991 * sigma * sigma


def minimal_hypotheses_plain(model: TwoViewModel, seed: int, pts1, pts2,
                             match_valid, num_hypotheses: int, sigma: float):
    idx = sample_minimal_sets(seed, match_valid, num_hypotheses, model.set_size)
    M = model.compute(pts1[idx], pts2[idx])
    inlier, cost = model.cost(M, pts1[None], pts2[None], sigma)
    inlier = inlier & match_valid[None, :]
    cost = torch.where(match_valid[None, :], cost, torch.zeros_like(cost))
    return M, cost.sum(-1), inlier.sum(-1).to(torch.int32)


def _check(t, shape, dtype, dev, name):
    if t.shape != shape or t.dtype != dtype or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"ransac_two_view: {name} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)} on {dev}")


def check_points(dim: int, pts1, pts2, match_valid):
    """The device and count of N correspondences [N, dim]; raises unless
    they are contiguous float32 on one device with a bool validity mask."""
    dev, N = pts1.device, pts1.shape[0]
    _check(pts1, (N, dim), torch.float32, dev, "pts1")
    _check(pts2, (N, dim), torch.float32, dev, "pts2")
    _check(match_valid, (N,), torch.bool, dev, "match_valid")
    if N == 0:
        raise ValueError("ransac_two_view: no correspondences")
    return dev, N


def minimal_hypotheses(model: TwoViewModel, seed, pts1, pts2, match_valid,
                       num_hypotheses: int, sigma: float = 1.0):
    """B models from hashed minimal sets, each scored on all N matches:
    (models [B,3,3] f32, total cost [B] f32, inlier count [B] i32). A
    sequence of C seeds draws C chunks of B in one launch: [C,B,...]."""
    chunked = hasattr(seed, "__len__")
    seeds = [int(x) for x in seed] if chunked else [int(seed)]
    if not pts1.is_cuda:
        outs = [minimal_hypotheses_plain(model, x, pts1, pts2, match_valid, num_hypotheses,
                                         sigma) for x in seeds]
        return tuple(torch.stack(o) for o in zip(*outs)) if chunked else outs[0]
    dev, N = check_points(model.dim, pts1, pts2, match_valid)
    B, C = int(num_hypotheses), len(seeds)
    if B * model.set_size * N >= 1 << 32:
        raise ValueError("ransac_two_view: B*k*N must stay below 2^32")
    if not 1 <= C <= MAX_CHUNKS:
        raise ValueError(f"ransac_two_view: 1 to {MAX_CHUNKS} chunk seeds")
    models = torch.empty((C, B, 3, 3), dtype=torch.float32, device=dev)
    cost = torch.empty((C, B), dtype=torch.float32, device=dev)
    count = torch.empty((C, B), dtype=torch.int32, device=dev)
    seed_arr = (ctypes.c_uint32 * C)(*[x & _M32 for x in seeds])
    lib = kbuild.load()
    kbuild.check(lib.svt_ransac_minimal(
        model.kind, N, pts1.data_ptr(), pts2.data_ptr(), match_valid.data_ptr(),
        ctypes.addressof(seed_arr), C, B, _chi_thr(sigma), models.data_ptr(), cost.data_ptr(),
        count.data_ptr(), kbuild.stream_ptr(dev)), "ransac_minimal")
    minimal_hypotheses.launches += 1
    return (models, cost, count) if chunked else (models[0], cost[0], count[0])


def _chunk_plain(model: TwoViewModel, models, cost, count, pts1, pts2, match_valid,
                 sigma: float, lo_rounds: int, min_inliers: int) -> TwoViewResult:
    """One chunk's selection, winner's mask and LO rounds (a refit is kept
    when its consensus does not shrink)."""
    best, ok = select_best(cost, count, min_inliers)
    M = models[best]
    inl = model.cost(M, pts1, pts2, sigma)[0] & match_valid
    for _ in range(lo_rounds):
        M_re = model.compute(pts1, pts2, valid=inl)
        in_re = model.cost(M_re, pts1, pts2, sigma)[0] & match_valid
        better = in_re.sum() >= inl.sum()
        M = torch.where(better, M_re, M)
        inl = torch.where(better, in_re, inl)
    total = torch.where(ok, cost[best], torch.full_like(cost[best], _BIG))
    return TwoViewResult(M, inl, total, inl.sum(), ok)


def finish_core_plain(model: TwoViewModel, models, cost, count, pts1, pts2, match_valid,
                      sigma: float = 1.0, lo_rounds: int = 0,
                      min_inliers: int | None = None) -> TwoViewResult:
    """Plain version of finish_core: each chunk through _chunk_plain, then
    (chunked input) escalate's carry over them."""
    min_in = model.set_size if min_inliers is None else min_inliers
    run = lambda m, c, n: _chunk_plain(model, m, c, n, pts1, pts2, match_valid, sigma,
                                       lo_rounds, min_in)
    if models.dim() == 3:
        return run(models, cost, count)
    return _carry([run(m, c, n) for m, c, n in zip(models, cost, count)])


def refit_normalization(pts1, pts2, mask) -> torch.Tensor:
    """The LO refit's normalisation of pixels [N,2] over `mask` [N] bool:
    [8] = mean x, mean y, deviation x, deviation y of pts1, then of pts2.
    On CUDA tensors the finish launch's device code alone (a check of its
    windowed sums), on CPU tensors homography.masked_mean_dev."""
    if not pts1.is_cuda:
        from stella_vslam_tpu_torch.ops.solve.homography import masked_mean_dev

        m1, d1 = masked_mean_dev(pts1, mask)
        m2, d2 = masked_mean_dev(pts2, mask)
        return torch.cat([m1[0], d1[0], m2[0], d2[0]])
    dev, N = check_points(2, pts1, pts2, mask)
    part = torch.empty(_part_floats(N), dtype=torch.float32, device=dev)
    out = torch.empty(8, dtype=torch.float32, device=dev)
    kbuild.check(kbuild.load().svt_ransac_normalization(
        N, pts1.data_ptr(), pts2.data_ptr(), mask.data_ptr(), part.data_ptr(), out.data_ptr(),
        kbuild.stream_ptr(dev)), "ransac_normalization")
    return out


def _part_floats(n: int) -> int:
    """Floats of the finish launch's windowed-sum scratch a chunk
    (csrc/ransac_two_view.cu part_floats)."""
    return 2 * 5 * ((n + 31) // 32 + 2)


# the finish launch's ticket, one int32 per (device, stream): the last block
# of an escalated sweep leaves it zero for the next launch on its stream
_tickets = {}
_tickets_lock = threading.Lock()


def _stream_ticket(dev, stream: int):
    key = (dev.index, stream)
    with _tickets_lock:
        if key not in _tickets:
            _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
        return _tickets[key]


def finish_core(model: TwoViewModel, models, cost, count, pts1, pts2, match_valid,
                sigma: float = 1.0, lo_rounds: int = 0,
                min_inliers: int | None = None) -> TwoViewResult:
    """The rest of a RANSAC batch in one launch of kernel E: the lowest cost
    among hypotheses with more than `min_inliers` inliers (the model's set
    size by default), its inlier mask and `lo_rounds` LO refits. Chunked
    hypotheses ([C,B,...], minimal_hypotheses of C seeds) are escalated:
    the valid chunk with the most inliers, the first of equals. Stays on the
    device: no host reads."""
    if not pts1.is_cuda:
        return finish_core_plain(model, models, cost, count, pts1, pts2, match_valid, sigma,
                                 lo_rounds, min_inliers)
    dev, N = check_points(model.dim, pts1, pts2, match_valid)
    escalated = models.dim() == 4
    C, B = (models.shape[0], models.shape[1]) if escalated else (1, models.shape[0])
    lead = (C, B) if escalated else (B,)
    _check(models, lead + (3, 3), torch.float32, dev, "models")
    _check(cost, lead, torch.float32, dev, "cost")
    _check(count, lead, torch.int32, dev, "count")
    out_f = torch.empty(10, dtype=torch.float32, device=dev)  # model, cost
    n = torch.empty((), dtype=torch.int64, device=dev)
    mask = torch.empty(N, dtype=torch.bool, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    masks = torch.empty((C, 2, N), dtype=torch.uint8, device=dev)
    part = torch.empty((C, _part_floats(N)), dtype=torch.float32, device=dev)
    chunk = torch.empty((C, 13), dtype=torch.float32, device=dev) if escalated else out_f
    stream = kbuild.stream_ptr(dev)
    ticket = _stream_ticket(dev, stream).data_ptr() if escalated else 0
    min_in = model.set_size if min_inliers is None else min_inliers
    lib = kbuild.load()
    kbuild.check(lib.svt_ransac_finish(
        model.kind, N, pts1.data_ptr(), pts2.data_ptr(), match_valid.data_ptr(), C, B,
        models.data_ptr(), cost.data_ptr(), count.data_ptr(), int(min_in), _chi_thr(sigma),
        int(lo_rounds), int(escalated), masks.data_ptr(), part.data_ptr(), chunk.data_ptr(),
        ticket,
        out_f.data_ptr(), mask.data_ptr(), out_f[9:].data_ptr(), n.data_ptr(), ok.data_ptr(),
        stream), "ransac_finish")
    minimal_hypotheses.launches += 1
    return TwoViewResult(out_f[:9].view(3, 3), mask, out_f[9], n, ok)


def score_models_plain(model: TwoViewModel, models, model_ok, pts1, pts2, match_valid,
                       outlier_cost: float, sigma: float = 1.0, chunk: int = 1024):
    """Plain version of score_models (in chunks of models)."""
    costs, counts = [], []
    for b0 in range(0, models.shape[0], chunk):
        M, ok = models[b0:b0 + chunk], model_ok[b0:b0 + chunk]
        inlier, cost = model.cost(M, pts1[None], pts2[None], sigma)
        inlier = inlier & match_valid[None, :] & ok[:, None]
        cost = torch.where(inlier, cost, torch.where(
            match_valid[None, :], torch.full_like(cost, outlier_cost), torch.zeros_like(cost)))
        costs.append(cost.sum(-1))
        counts.append(inlier.sum(-1).to(torch.int32))
    return torch.cat(costs), torch.cat(counts)


def score_models(model: TwoViewModel, models, model_ok, pts1, pts2, match_valid,
                 outlier_cost: float, sigma: float = 1.0):
    """Given models [B,3,3] with their ok flags [B], each scored on all N
    matches: (total cost [B] f32, inlier count [B] i32); a model that is not
    ok counts no inlier and `outlier_cost` for every valid match. Kernel E
    (essential models only, whose outlier cost is fixed) on CUDA tensors,
    the plain version on CPU tensors."""
    if not pts1.is_cuda:
        return score_models_plain(model, models, model_ok, pts1, pts2, match_valid,
                                  outlier_cost, sigma)
    if model.kind != 2:
        raise ValueError("score_models: kernel E scores given essential matrices only")
    dev, N = check_points(model.dim, pts1, pts2, match_valid)
    B = models.shape[0]
    _check(models, (B, 3, 3), torch.float32, dev, "models")
    _check(model_ok, (B,), torch.bool, dev, "model_ok")
    cost = torch.empty(B, dtype=torch.float32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_ransac_score(
        N, pts1.data_ptr(), pts2.data_ptr(), match_valid.data_ptr(), B, models.data_ptr(),
        model_ok.data_ptr(), cost.data_ptr(), count.data_ptr(), kbuild.stream_ptr(dev)),
        "ransac_score")
    minimal_hypotheses.launches += 1
    return cost, count


# one count for kernel E, whichever of its four entry points launched
minimal_hypotheses.launches = 0


def find_core(model: TwoViewModel, seed: int, pts1, pts2, match_valid,
              num_hypotheses: int, sigma: float, lo_rounds: int) -> TwoViewResult:
    """One RANSAC batch plus `lo_rounds` LO refits (a refit is kept when its
    consensus does not shrink): two launches of kernel E, no host reads."""
    return finish_core(model, *minimal_hypotheses(model, seed, pts1, pts2, match_valid,
                                                  num_hypotheses, sigma),
                       pts1, pts2, match_valid, sigma, lo_rounds)


def find_escalated(model: TwoViewModel, seeds: Sequence[int], pts1, pts2, match_valid,
                   num_hypotheses: int, sigma: float, lo_rounds: int) -> TwoViewResult:
    """find_core per chunk seed, the valid result with the most inliers (the
    first of equals) kept, as escalate_scan's lax.scan does from an
    all-zero carry: two launches of kernel E for every chunk."""
    return finish_core(model, *minimal_hypotheses(model, list(seeds), pts1, pts2, match_valid,
                                                  num_hypotheses, sigma),
                       pts1, pts2, match_valid, sigma, lo_rounds)


def find_core_plain(model: TwoViewModel, seed: int, pts1, pts2, match_valid,
                    num_hypotheses: int, sigma: float, lo_rounds: int) -> TwoViewResult:
    """find_core through the plain versions on any device (the reference
    kernel E is held against on the card)."""
    return finish_core_plain(model, *minimal_hypotheses_plain(
        model, seed, pts1, pts2, match_valid, num_hypotheses, sigma), pts1, pts2, match_valid,
        sigma, lo_rounds)


def _carry(results: Sequence[TwoViewResult]) -> TwoViewResult:
    """escalate_scan's carry over chunk results in order, from all zeros:
    a valid result with strictly more inliers is taken."""
    carry = None
    for res in results:
        if carry is None:
            carry = TwoViewResult(*(torch.zeros_like(x) for x in res))
        take = res.valid & (~carry.valid | (res.num_inliers > carry.num_inliers))
        carry = TwoViewResult(*(torch.where(take, a, b) for a, b in zip(res, carry)))
    return carry


def escalate(core: Callable[[int], TwoViewResult], seeds: Sequence[int]) -> TwoViewResult:
    """Run `core(seed)` per chunk seed and keep the valid result with the
    most inliers (the first of equals), as escalate_scan's lax.scan does
    from an all-zero carry (the plain reference of find_escalated)."""
    return _carry([core(s) for s in seeds])
