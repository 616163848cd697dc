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

Kernel E (csrc/ransac_two_view.cu) runs the batch on CUDA tensors in three
launches: `minimal_hypotheses` (one block per hypothesis: sample, fit, score,
reduce), `select_best_model` (argmin and the winner's inlier mask) and
`refit_model` (the nonminimal LO refit over a masked set); `score_models`
scores given essential matrices (the 5-point solver's candidates). On CPU
tensors the same functions run their plain versions below.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from stella_vslam_tpu_torch.kernels import build as kbuild

_M32 = 0xFFFFFFFF
_BIG = 3.0e38
# hypotheses per chunk of the plain sampler: bounds its [b, k, N] int64 hash
_PLAIN_CHUNK = 256


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


def minimal_hypotheses(model: TwoViewModel, seed: int, pts1, pts2, match_valid,
                       num_hypotheses: int, sigma: float = 1.0):
    """B models from hashed minimal sets, each scored on all N matches:
    (models [B,3,3] f32, total cost [B] f32, inlier count [B] i32)."""
    if not pts1.is_cuda:
        return minimal_hypotheses_plain(model, seed, pts1, pts2, match_valid,
                                        num_hypotheses, sigma)
    dev, N = check_points(model.dim, pts1, pts2, match_valid)
    B = int(num_hypotheses)
    if B * model.set_size * N >= 1 << 32:
        raise ValueError("ransac_two_view: B*k*N must stay below 2^32")
    models = torch.empty((B, 3, 3), dtype=torch.float32, device=dev)
    cost = torch.empty(B, dtype=torch.float32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_ransac_minimal(
        model.kind, N, pts1.data_ptr(), pts2.data_ptr(), match_valid.data_ptr(),
        int(seed) & _M32, B, _chi_thr(sigma), models.data_ptr(), cost.data_ptr(),
        count.data_ptr(), kbuild.stream_ptr(dev)), "ransac_minimal")
    minimal_hypotheses.launches += 1
    return models, cost, count


def select_best_model(model: TwoViewModel, models, cost, count, pts1, pts2,
                      match_valid, sigma: float = 1.0):
    """The winner of a scored batch: (model [3,3], inlier mask [N] bool,
    its total cost or 3e38, valid)."""
    if not pts1.is_cuda:
        best, ok = select_best(cost, count, model.set_size)
        M = models[best]
        inlier, _ = model.cost(M, pts1, pts2, sigma)
        return (M, inlier & match_valid,
                torch.where(ok, cost[best], torch.full_like(cost[best], _BIG)), ok)
    dev, N = check_points(model.dim, pts1, pts2, match_valid)
    B = models.shape[0]
    _check(models, (B, 3, 3), torch.float32, dev, "models")
    _check(cost, (B,), torch.float32, dev, "cost")
    _check(count, (B,), torch.int32, dev, "count")
    M = torch.empty((3, 3), dtype=torch.float32, device=dev)
    mask = torch.empty(N, dtype=torch.bool, device=dev)
    best_cost = torch.empty((), dtype=torch.float32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_ransac_select(
        model.kind, N, pts1.data_ptr(), pts2.data_ptr(), match_valid.data_ptr(),
        B, models.data_ptr(), cost.data_ptr(), count.data_ptr(), model.set_size,
        _chi_thr(sigma), M.data_ptr(), mask.data_ptr(), best_cost.data_ptr(),
        ok.data_ptr(), kbuild.stream_ptr(dev)), "ransac_select")
    minimal_hypotheses.launches += 1
    return M, mask, best_cost, ok


def refit_model(model: TwoViewModel, pts1, pts2, match_valid, inlier,
                sigma: float = 1.0):
    """Nonminimal DLT over the rows of `inlier`, rescored on all N:
    (model [3,3], inlier mask [N] bool)."""
    if not pts1.is_cuda:
        M = model.compute(pts1, pts2, valid=inlier)
        in_re, _ = model.cost(M, pts1, pts2, sigma)
        return M, in_re & match_valid
    dev, N = check_points(model.dim, pts1, pts2, match_valid)
    _check(inlier, (N,), torch.bool, dev, "inlier")
    M = torch.empty((3, 3), dtype=torch.float32, device=dev)
    mask = torch.empty(N, dtype=torch.bool, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_ransac_refit(
        model.kind, N, pts1.data_ptr(), pts2.data_ptr(), match_valid.data_ptr(),
        inlier.data_ptr(), _chi_thr(sigma), M.data_ptr(), mask.data_ptr(),
        kbuild.stream_ptr(dev)), "ransac_refit")
    minimal_hypotheses.launches += 1
    return M, mask


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
    consensus does not shrink). Stays on the device: no host reads."""
    models, cost, count = minimal_hypotheses(model, seed, pts1, pts2, match_valid,
                                             num_hypotheses, sigma)
    M, inl, total, ok = select_best_model(model, models, cost, count, pts1, pts2,
                                          match_valid, sigma)
    for _ in range(lo_rounds):
        M_re, in_re = refit_model(model, pts1, pts2, match_valid, inl, sigma)
        better = in_re.sum() >= inl.sum()
        M = torch.where(better, M_re, M)
        inl = torch.where(better, in_re, inl)
    return TwoViewResult(M, inl, total, inl.sum(), ok)


def find_core_plain(model: TwoViewModel, seed: int, pts1, pts2, match_valid,
                    num_hypotheses: int, sigma: float, lo_rounds: int) -> TwoViewResult:
    """find_core through the plain versions on any device (the reference
    kernel E is held against on the card)."""
    models, cost, count = minimal_hypotheses_plain(model, seed, pts1, pts2, match_valid,
                                                   num_hypotheses, sigma)
    best, ok = select_best(cost, count, model.set_size)
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


def escalate(core: Callable[[int], TwoViewResult], seeds: Sequence[int]) -> TwoViewResult:
    """Run `core(seed)` per chunk seed and keep the valid result with the
    most inliers (the first of equals), as escalate_scan's lax.scan does
    from an all-zero carry."""
    carry = None
    for s in seeds:
        res = core(s)
        if carry is None:
            carry = TwoViewResult(torch.zeros_like(res.model),
                                  torch.zeros_like(res.is_inlier),
                                  torch.zeros_like(res.cost),
                                  torch.zeros_like(res.num_inliers),
                                  torch.zeros_like(res.valid))
        take = res.valid & (~carry.valid | (res.num_inliers > carry.num_inliers))
        carry = TwoViewResult(*(torch.where(take, a, b) for a, b in zip(res, carry)))
    return carry
