"""Five-point minimal essential solver: kernel U.

Port of stella_vslam_tpu/ops/solve/essential_5pt.py `solve_minimal_sets`
(:218), the hidden-variable resultant: the 4D null space of each 5x9
epipolar system by the projector I - A^T (A A^T)^-1 A and Gram-Schmidt
against a fixed probe (`_null_basis` :193); E(x, y, z) = x E1 + y E2 +
z E3 + E4 and its ten cubics, det E = 0 and 2 E E^T E - tr(E E^T) E = 0
(`_ten_cubics` :70), grouped over the ten (x, y) monomials into
M(z) = M0 + z M1 + z^2 M2 + z^3 M3 (`_assemble_Mk` :121, rows scaled to a
unit largest coefficient); the sign of det M(z) on a 257-point grid in
tan(theta) by pivot-normalised elimination (`_det_sign_10` :138, its pivot
order kept: the largest |entry| at or below the diagonal, the lowest row on
ties, the pivot row rescaled by 1 / |pivot|), 28 bisection steps in theta
for each of the first 10 sign changes, (x, y) from the null vector of
M(z*) (18 squarings of M^T M, ops/linalg.smallest_eigvec_spd), and up to
ten unit-norm E per set with their valid flags.

`solve_minimal_sets` is the plain version, in torch, for given sets.
`solve_sampled_sets` draws the sets with the RANSAC hash sampler and solves
them: on CUDA tensors in one launch of kernel U (csrc/essential_5pt.cu, one
block per set), on CPU tensors through ops/solve/ransac.sample_minimal_sets
and `solve_minimal_sets`. The roots are found by the same algorithm in the
same order, so candidates agree up to float32 rounding; where det M(z)
passes within rounding of zero at a grid point, a sign can differ and a
root can move slots or appear in one version only.
"""
from __future__ import annotations

import numpy as np
import torch

from stella_vslam_tpu_torch.kernels import build as kbuild
from stella_vslam_tpu_torch.ops import linalg
from stella_vslam_tpu_torch.ops.solve import ransac

# x,y-monomial columns of M(z) (Nister's hidden-variable grouping)
XY_MONOS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
_COL_X, _COL_Y, _COL_1 = 7, 8, 9
GRID_N = 256
BISECT_ITERS = 28
MAX_ROOTS = 10

# the fixed Gram-Schmidt probe: the JAX version's
# np.random.default_rng(7).normal(size=(9, 4)).astype(np.float32), copied
PROBE = np.array([
    [0.001230153371579945, 0.2987455427646637, -0.27413785457611084, -0.8905918598175049],
    [-0.454670786857605, -0.9916465282440186, 0.0601436011493206, 1.3402152061462402],
    [-0.49220651388168335, -0.6204748749732971, 0.4898420572280884, 0.35688701272010803],
    [0.1054142490029335, -0.9304680228233337, -0.02925182320177555, 0.695303201675415],
    [-1.3442145586013794, -0.45761576294898987, -1.9012227058410645, -1.289537787437439],
    [-1.8417350053787231, -0.23509113490581512, -1.267446517944336, 0.27126434445381165],
    [0.15675108134746552, -0.18693093955516815, -2.5167596340179443, -0.5386928915977478],
    [-0.048500943928956985, 0.11330898851156235, -1.5301357507705688, -0.47775328159332275],
    [-0.978519082069397, -0.8088372349739075, 1.0608986616134644, -0.8075346946716309],
], dtype=np.float32)


def theta_grid() -> np.ndarray:
    """jnp.linspace(-pi/2 (1 - 1/G), pi/2 (1 - 1/G), G + 1) in float32, as
    JAX computes it: start (1 - s) + stop s with s = i / G, the product and
    sum fused, and the endpoint exact."""
    f32 = np.float32
    lo = f32(-0.5 * np.pi * (1 - 1.0 / GRID_N))
    hi = f32(0.5 * np.pi * (1 - 1.0 / GRID_N))
    s = (np.arange(GRID_N, dtype=f32) / f32(GRID_N)).astype(f32)
    head = (np.float64(hi) * s + np.float64((lo * (f32(1) - s)).astype(f32))).astype(f32)
    return np.concatenate([head, [hi]]).astype(f32)


# ---------------------------------------------------------------------------
# polynomial bookkeeping (dicts {(a, b, c): coefficient tensor}, the JAX
# version's order of terms)
# ---------------------------------------------------------------------------


def _pmul(p, q):
    out = {}
    for ea, ca in p.items():
        for eb, cb in q.items():
            e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            t = ca * cb
            out[e] = out[e] + t if e in out else t
    return out


def _padd(p, q, s=1.0):
    out = dict(p)
    for e, c in q.items():
        out[e] = out[e] + s * c if e in out else s * c
    return out


def _ten_cubics(basis):
    """det(E) and the nine trace constraints, basis [B,4,3,3]."""
    def m(i, j):
        return {(1, 0, 0): basis[:, 0, i, j], (0, 1, 0): basis[:, 1, i, j],
                (0, 0, 1): basis[:, 2, i, j], (0, 0, 0): basis[:, 3, i, j]}

    det = _padd(
        _padd(_pmul(m(0, 0), _padd(_pmul(m(1, 1), m(2, 2)), _pmul(m(1, 2), m(2, 1)), -1.0)),
              _pmul(m(0, 1), _padd(_pmul(m(1, 0), m(2, 2)), _pmul(m(1, 2), m(2, 0)), -1.0)),
              -1.0),
        _pmul(m(0, 2), _padd(_pmul(m(1, 0), m(2, 1)), _pmul(m(1, 1), m(2, 0)), -1.0)))
    T = {}
    for i in range(3):
        for k in range(i, 3):
            acc = _pmul(m(i, 0), m(k, 0))
            acc = _padd(acc, _pmul(m(i, 1), m(k, 1)))
            acc = _padd(acc, _pmul(m(i, 2), m(k, 2)))
            T[(i, k)] = acc
            T[(k, i)] = acc
    tr = _padd(_padd(T[(0, 0)], T[(1, 1)]), T[(2, 2)])
    eqs = [det]
    for i in range(3):
        for l in range(3):
            acc = _pmul(T[(i, 0)], m(0, l))
            acc = _padd(acc, _pmul(T[(i, 1)], m(1, l)))
            acc = _padd(acc, _pmul(T[(i, 2)], m(2, l)))
            acc = {e: 2.0 * c for e, c in acc.items()}
            eqs.append(_padd(acc, _pmul(tr, m(i, l)), -1.0))
    return eqs


def _assemble_Mk(eqs, B, dev):
    zero = torch.zeros(B, dtype=torch.float32, device=dev)
    Mk = [[[zero] * 10 for _ in range(10)] for _ in range(4)]
    for r, eq in enumerate(eqs):
        for (a, b, c), coeff in eq.items():
            col = XY_MONOS.index((a, b))
            Mk[c][r][col] = Mk[c][r][col] + coeff
    return [torch.stack([torch.stack(row, -1) for row in Mk[c]], -2) for c in range(4)]


# ---------------------------------------------------------------------------
# determinant sign, evaluation, null basis
# ---------------------------------------------------------------------------


def det_sign_10(M: torch.Tensor) -> torch.Tensor:
    """sign(det M) of [..., 10, 10] by pivot-normalised elimination: per
    column, the pivot is the largest |entry| at or below the diagonal (the
    lowest row on ties); rows k and p swap by the one-hot updates of the JAX
    version (row p becomes row_p + (row_k - row_p)); the pivot row is
    rescaled by 1 / |pivot|, a positive factor that keeps the sign."""
    A = M.clone()
    sign = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    rows = torch.arange(10, device=M.device)
    for k in range(10):
        col = torch.where(rows >= k, torch.abs(A[..., :, k]), torch.full_like(A[..., :, k], -1.0))
        p = torch.argmax(col, dim=-1)
        sign = sign * torch.where(p != k, -1.0, 1.0)
        row_p = torch.gather(A, -2, p[..., None, None].expand(p.shape + (1, 10)))[..., 0, :]
        row_k = A[..., k, :].clone()
        oh_p = (rows == p[..., None]).to(A.dtype)
        oh_k = (rows == k).to(A.dtype)
        A = (A + oh_k[..., :, None] * (row_p - row_k)[..., None, :]
             + oh_p[..., :, None] * (row_k - row_p)[..., None, :])
        piv = A[..., k, k]
        sign = sign * torch.sign(piv)
        inv = torch.where(torch.abs(piv) > 1e-30, 1.0 / torch.abs(piv), torch.zeros_like(piv))
        rowk_n = row_p * inv[..., None]
        A = torch.where(oh_k[..., :, None] > 0, rowk_n[..., None, :], A)
        mult = A[..., :, k] * (rows > k).to(A.dtype) * torch.sign(piv)[..., None]
        A = A - mult[..., :, None] * rowk_n[..., None, :]
    return sign


def eval_M(Mks, z: torch.Tensor) -> torch.Tensor:
    """M(z) = M0 + z M1 + z^2 M2 + z^3 M3 for z [...] (broadcast against the
    coefficient matrices)."""
    M0, M1, M2, M3 = Mks
    zz = z[..., None, None]
    return M0 + zz * M1 + (zz * zz) * M2 + (zz * zz * zz) * M3


def null_basis(A: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis [B,4,9] of the null space of A [B,5,9]: the
    projector I - A^T (A A^T)^-1 A (unrolled Cholesky with a 1e-8 trace
    ridge) applied to the probe, then modified Gram-Schmidt."""
    AAt = A @ A.transpose(-1, -2)
    eye5 = torch.eye(5, dtype=A.dtype, device=A.device)
    AAt = AAt + 1e-8 * torch.diagonal(AAt, dim1=-2, dim2=-1).sum(-1)[..., None, None] * eye5
    L = linalg._cholesky_matrix(AAt)
    rhs = A.transpose(-1, -2)  # [B,9,5]
    y = linalg.solve_lower_unrolled(L[:, None], rhs)
    X = linalg.solve_upper_from_lower_unrolled(L[:, None], y)  # [B,9,5]
    P = torch.eye(9, dtype=A.dtype, device=A.device) - torch.einsum("bki,bjk->bij", A, X)
    Y = P @ torch.as_tensor(PROBE, device=A.device)  # [B,9,4]
    cols = []
    for c in range(4):
        v = Y[..., c]
        for u in cols:
            v = v - torch.sum(v * u, dim=-1, keepdim=True) * u
        v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-20)
        cols.append(v)
    return torch.stack(cols, dim=1)


def solve_minimal_sets(b1_sets: torch.Tensor, b2_sets: torch.Tensor):
    """[B,5,3] bearing pairs -> (E [B,10,3,3], valid [B,10]): up to ten
    essential-matrix candidates per minimal set (the plain version of
    kernel U's solver)."""
    A = torch.cat([b2_sets[..., 0:1] * b1_sets, b2_sets[..., 1:2] * b1_sets,
                   b2_sets[..., 2:3] * b1_sets], dim=-1)  # [B,5,9]
    return solve_from_basis(null_basis(A).reshape(-1, 4, 3, 3))


def solve_from_basis(basis: torch.Tensor):
    """The candidates of E = x E1 + y E2 + z E3 + E4 over a null basis
    [B,4,3,3]: (E [B,10,3,3], valid [B,10])."""
    B, dev = basis.shape[0], basis.device
    Mks = _assemble_Mk(_ten_cubics(basis), B, dev)
    row_max = torch.clamp(torch.amax(torch.abs(torch.stack(Mks, 0)), dim=(0, -1)),
                          min=1e-20)[..., None]  # [B,10,1]
    Mks = [M / row_max for M in Mks]
    Mks_b = [M[:, None] for M in Mks]
    theta = torch.as_tensor(theta_grid(), device=dev)
    sg = det_sign_10(eval_M(Mks_b, torch.tan(theta)[None, :]))  # [B,G+1]
    change = (sg[:, :-1] * sg[:, 1:]) < 0
    slot = torch.cumsum(change.to(torch.int32), dim=-1) - 1
    gi = torch.arange(GRID_N, device=dev)
    root_slots = torch.arange(MAX_ROOTS, device=dev)
    sel = (slot[:, None, :] == root_slots[None, :, None]) & change[:, None, :]
    has_root = torch.any(sel, dim=-1)  # [B,R]
    start = torch.sum(torch.where(sel, gi, torch.zeros_like(gi)), dim=-1)  # [B,R]
    lo, hi = theta[start], theta[start + 1]
    s_lo = torch.gather(sg, -1, start)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        same = (det_sign_10(eval_M(Mks_b, torch.tan(mid))) * s_lo) >= 0
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
    z_root = torch.tan(0.5 * (lo + hi))  # [B,R]
    Mr = eval_M(Mks_b, z_root)  # [B,R,10,10]
    v = linalg.smallest_eigvec_spd(torch.einsum("brki,brkj->brij", Mr, Mr))
    denom = v[..., _COL_1]
    ok_xy = torch.abs(denom) > 1e-5 * torch.linalg.norm(v, dim=-1)
    safe = torch.where(torch.abs(denom) < 1e-20, torch.full_like(denom, 1e-20), denom)
    x = torch.where(ok_xy, v[..., _COL_X] / safe, torch.zeros_like(denom))
    y = torch.where(ok_xy, v[..., _COL_Y] / safe, torch.zeros_like(denom))
    E = (x[..., None, None] * basis[:, None, 0] + y[..., None, None] * basis[:, None, 1]
         + z_root[..., None, None] * basis[:, None, 2] + basis[:, None, 3])
    E = E / (torch.linalg.norm(E.reshape(B, MAX_ROOTS, 9), dim=-1)[..., None, None] + 1e-20)
    return E, has_root & ok_xy & torch.isfinite(z_root)


# ---------------------------------------------------------------------------
# kernel U
# ---------------------------------------------------------------------------


def solve_sampled_sets_plain(seed: int, b1, b2, match_valid, num_sets: int):
    idx = ransac.sample_minimal_sets(seed, match_valid, num_sets, 5)
    E, valid = solve_minimal_sets(b1[idx], b2[idx])
    return idx, E, valid


def solve_sampled_sets(seed: int, b1, b2, match_valid, num_sets: int):
    """`num_sets` 5-point sets drawn by the RANSAC hash sampler from the
    valid matches of bearings b1, b2 [N,3], each solved: (idx [B,5] i64,
    E [B,10,3,3] f32, valid [B,10] bool). Kernel U on CUDA tensors, the
    plain version on CPU tensors."""
    if not b1.is_cuda:
        return solve_sampled_sets_plain(seed, b1, b2, match_valid, num_sets)
    dev, N = ransac.check_points(3, b1, b2, match_valid)
    B = int(num_sets)
    if B * 5 * N >= 1 << 32:
        raise ValueError("solve_sampled_sets: B*5*N must stay below 2^32")
    theta = torch.as_tensor(theta_grid(), device=dev)
    probe = torch.as_tensor(PROBE, device=dev).contiguous()
    idx = torch.empty((B, 5), dtype=torch.int32, device=dev)
    E = torch.empty((B, MAX_ROOTS, 3, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((B, MAX_ROOTS), dtype=torch.bool, device=dev)
    lib = kbuild.load()
    kbuild.check(lib.svt_essential_5pt(
        N, b1.data_ptr(), b2.data_ptr(), match_valid.data_ptr(), int(seed) & 0xFFFFFFFF, B,
        theta.data_ptr(), probe.data_ptr(), idx.data_ptr(), E.data_ptr(), ok.data_ptr(),
        kbuild.stream_ptr(dev)), "essential_5pt")
    solve_sampled_sets.launches += 1
    return idx.to(torch.int64), E, ok


solve_sampled_sets.launches = 0
