"""Batched minimal solvers (port of ``ops/solvers.py``).

- Nister's five-point essential solver (five-point.cpp:260-455 run5Point):
  QR nullspace of the 5x9 epipolar system, the ten cubic constraints
  recovered by interpolation at 20 fixed points (seeded numpy constants,
  identical to the JAX package's), Gauss-Jordan elimination to the
  degree-10 polynomial det B(z), real roots by a sign scan + bisection,
  x, y by 2x2 least squares, then a Gauss-Newton polish.
- Stewenius's five-point solver (opengv fivept_stewenius): the same
  constraints in the Stewenius monomial order, Gauss-Jordan elimination
  to the 10x10 action matrix M_z, its Householder reduction to Hessenberg
  form, real eigenvalues by a sign scan of Hyman's determinant on a tan
  grid + bisection, eigenvectors from Hyman's recurrence, then the same
  polish.
- the (weighted) 8-point solver, the 7-point fundamental solver, and the
  homography DLT with its transfer error, which the degeneracy check
  scores;
- ``solve_small`` / ``det_small``: unrolled partial-pivot elimination for
  tiny batched systems.

Each minimal sample yields a fixed number of candidate models plus a
validity mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from matchinglib_poselib_torch.ops import smalllinalg
from matchinglib_poselib_torch.ops.geometry import (
    normalize_points, to_homogeneous, topk_stable,
)

# ---------------------------------------------------------------------------
# seeded interpolation constants (host-side numpy, as in the JAX package)
# ---------------------------------------------------------------------------

# Stewenius ordering (also used to pick the interpolation points): the 10
# degree-3 monomials, then the 10 of degree <= 2 (the quotient-ring basis
# [x^2, xy, y^2, xz, yz, z^2, x, y, z, 1]).
_MONOMIALS = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1),
    (1, 1, 1), (0, 2, 1), (1, 0, 2), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]

# Nister ordering: every monomial nonlinear in (x, y) first; the remaining
# basis [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1] is linear in x and y.
_MONOMIALS_NISTER = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _eval_monomial_list(pts: np.ndarray, monomials) -> np.ndarray:
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack(
        [x**px * y**py * z**pz for (px, py, pz) in monomials], axis=1
    )


def pick_interpolation_points(seed_trials: int = 400) -> np.ndarray:
    """The 20 generic points minimizing the Vandermonde condition number
    (float64 numpy, seeds 1234.., as in the JAX package)."""
    best_pts, best_cond = None, np.inf
    for s in range(seed_trials):
        rng = np.random.default_rng(1234 + s)
        pts = rng.uniform(-1.0, 1.0, size=(20, 3))
        c = np.linalg.cond(_eval_monomial_list(pts, _MONOMIALS))
        if c < best_cond:
            best_cond, best_pts = c, pts
    return best_pts


def nister_vinv_t(pts64: np.ndarray) -> np.ndarray:
    """(20, 20) float64 transposed inverse Vandermonde, Nister ordering."""
    return np.linalg.inv(_eval_monomial_list(pts64, _MONOMIALS_NISTER)).T


def stewenius_vinv_t(pts64: np.ndarray) -> np.ndarray:
    """(20, 20) float64 transposed inverse Vandermonde, Stewenius
    ordering."""
    return np.linalg.inv(_eval_monomial_list(pts64, _MONOMIALS)).T


class SolverTables:
    """The 5pt interpolation constants on one device (float32).

    Each table is taken from the array passed in
    (``convert.tables_from_numpy``), else regenerated from the seeded
    numpy code.
    """

    def __init__(self, interp_pts=None, vinv_t_nister=None,
                 vinv_t_stewenius=None, device: torch.device | str = "cpu"):
        if any(a is None for a in (interp_pts, vinv_t_nister,
                                   vinv_t_stewenius)):
            pts64 = pick_interpolation_points()
            if interp_pts is None:
                interp_pts = pts64.astype(np.float32)
            if vinv_t_nister is None:
                vinv_t_nister = nister_vinv_t(pts64).astype(np.float32)
            if vinv_t_stewenius is None:
                vinv_t_stewenius = stewenius_vinv_t(pts64).astype(np.float32)

        def put(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        self.interp_pts = put(interp_pts)
        self.vinv_t_nister = put(vinv_t_nister)
        self.vinv_t_stewenius = put(vinv_t_stewenius)
        # the Stewenius root scan's theta grid, on the device once
        self.theta_hess = put(_theta_grid_np())


_TABLES: dict[str, SolverTables] = {}


def default_tables(device) -> SolverTables:
    """SolverTables for `device`, built once per device."""
    key = str(torch.device(device))
    if key not in _TABLES:
        base = _TABLES.get("cpu")
        if base is None:
            base = _TABLES["cpu"] = SolverTables()
        _TABLES[key] = SolverTables(
            base.interp_pts.numpy(), base.vinv_t_nister.numpy(),
            base.vinv_t_stewenius.numpy(), device=device)
    return _TABLES[key]


# ---------------------------------------------------------------------------
# nullspace helpers
# ---------------------------------------------------------------------------


def solve_small_lanes(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched Gauss-Jordan solve A X = B with partial pivoting.

    A: (..., n, n), B: (..., n, m). Singular systems yield inf/nan (the
    caller checks finiteness).
    """
    n = A.shape[-1]
    m = B.shape[-1]
    batch = A.shape[:-2]
    M = torch.cat([A, B], dim=-1)
    M = torch.movedim(M.reshape((-1,) + M.shape[-2:]), 0, -1)  # (n, n+m, Bt)
    iota = torch.arange(n, device=A.device)
    for k in range(n):
        col = torch.abs(M[:, k, :])
        col = torch.where(iota[:, None] >= k, col, -1.0)
        piv = torch.argmax(col, dim=0)
        sel = iota[:, None] == piv[None, :]
        pivrow = torch.sum(torch.where(sel[:, None, :], M, 0.0), dim=0)
        rowk = M[k]
        is_k = (iota == k)[:, None, None]
        M = torch.where(sel[:, None, :], rowk[None], M)
        rk = pivrow / pivrow[k]
        M = torch.where(is_k, rk[None], M)
        f = torch.where((iota == k)[:, None], 0.0, M[:, k, :])
        M = M - f[:, None, :] * rk[None, :, :]
        M = torch.where(is_k, rk[None], M)
    X = torch.movedim(M[:, n:, :], -1, 0)
    return X.reshape(batch + (n, m))


def solve_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched dense solve A X = B for tiny systems by unrolled Gaussian
    elimination with partial pivoting, then back substitution.

    A: (..., n, n), B: (..., n, m). The pivot of column k is the first
    row at or below k of largest |value| (``argmax``, first maximum wins).
    Singular systems yield inf/nan (the caller checks finiteness).
    """
    n = A.shape[-1]
    M = torch.cat([A, B], dim=-1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        col = torch.where(rows >= k, torch.abs(M[..., :, k]), -1.0)
        p = torch.argmax(col, dim=-1)
        # swap rows k <-> p by a permuted gather: idx[k] = p, idx[p] = k
        idx = torch.where(rows == k, p[..., None],
                          torch.where(rows == p[..., None], k, rows))
        M = torch.take_along_dim(M, idx[..., :, None], dim=-2)
        piv = M[..., k, k]
        piv = torch.where(torch.abs(piv) > 1e-30, piv, 1e-30)
        factor = torch.where(rows > k, M[..., :, k] / piv[..., None], 0.0)
        M = M - factor[..., :, None] * M[..., k:k + 1, :]
    X = torch.zeros(A.shape[:-2] + (n, B.shape[-1]), dtype=A.dtype,
                    device=A.device)
    for k in reversed(range(n)):
        acc = torch.einsum("...j,...jm->...m", M[..., k, k + 1:n],
                           X[..., k + 1:, :])
        piv = M[..., k, k]
        piv = torch.where(torch.abs(piv) > 1e-30, piv, 1e-30)
        X[..., k, :] = (M[..., k, n:] - acc) / piv[..., None]
    return X


def det_small(A: torch.Tensor) -> torch.Tensor:
    """Batched determinant of tiny (n, n) matrices by unrolled elimination
    with partial pivoting (the pivots of ``solve_small``) and sign
    tracking."""
    n = A.shape[-1]
    M = A
    rows = torch.arange(n, device=A.device)
    det = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    for k in range(n):
        col = torch.where(rows >= k, torch.abs(M[..., :, k]), -1.0)
        p = torch.argmax(col, dim=-1)
        idx = torch.where(rows == k, p[..., None],
                          torch.where(rows == p[..., None], k, rows))
        M = torch.take_along_dim(M, idx[..., :, None], dim=-2)
        det = det * torch.where(p == k, 1.0, -1.0)
        piv = M[..., k, k]
        det = det * piv
        safe = torch.where(torch.abs(piv) > 1e-30, piv, 1e-30)
        factor = torch.where(rows > k, M[..., :, k] / safe[..., None], 0.0)
        M = M - factor[..., :, None] * M[..., k:k + 1, :]
    return det


def nullspace_from_ata(A: torch.Tensor, k: int,
                       pairs: bool = False) -> torch.Tensor:
    """k smallest-eigenvalue eigenvectors of A^T A -> (..., N, k).

    The k = 1 case of one system uses the closed-form inverse iteration
    (smalllinalg.min_eigvec_spd), as in the JAX package; so does one
    system per pair (`pairs`: the leading dims are a pair axis, which the
    JAX package's ``vmap`` hides from its code). Batches of samples keep
    eigh, as there. On the card that eigh runs in float64 and casts back:
    cuSOLVER's batched float32 eigh lands far from the nullspace of the
    ill-conditioned normal matrices of near-degenerate samples, where
    LAPACK's float32 eigh (the CPU path, and the JAX package's) does not.
    """
    AtA = A.transpose(-1, -2) @ A
    if k == 1 and (AtA.ndim == 2 or pairs):
        return smalllinalg.min_eigvec_spd(AtA)[..., None]
    if AtA.is_cuda:
        _, vecs = torch.linalg.eigh(AtA.double())
        return vecs[..., :, :k].to(AtA.dtype)
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, :k]


def nullspace_qr(A: torch.Tensor) -> torch.Tensor:
    """Orthonormal nullspace basis of a batched wide (M < N) matrix via
    Householder QR of A^T -> (..., N, N - M)."""
    m, n = A.shape[-2], A.shape[-1]
    dtype, dev = A.dtype, A.device
    R = A.transpose(-1, -2)
    iota = torch.arange(n, device=dev)
    vs = []
    for j in range(m):
        x = torch.where(iota >= j, R[..., :, j], 0.0)
        alpha = torch.sqrt(torch.sum(x * x, dim=-1))
        sign = torch.where(x[..., j] >= 0, 1.0, -1.0)
        e_j = (iota == j).to(dtype)
        v = x + (sign * alpha)[..., None] * e_j
        inv = 2.0 / torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                                min=1e-30)
        vtR = torch.einsum("...i,...ij->...j", v, R)
        R = R - (inv[..., None] * v[..., :, None]) * vtR[..., None, :]
        vs.append((v, inv))
    C = torch.eye(n, dtype=dtype, device=dev)[:, m:].expand(
        A.shape[:-2] + (n, n - m))
    for v, inv in reversed(vs):
        vtC = torch.einsum("...i,...ij->...j", v, C)
        C = C - (inv[..., None] * v[..., :, None]) * vtC[..., None, :]
    return C


def epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rows of x2^T E x1 = 0 for row-major vec(E): (..., N, 2) -> (..., N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1
    )


# ---------------------------------------------------------------------------
# 5-point solver (Nister)
# ---------------------------------------------------------------------------


def _constraint_values(Ebasis: torch.Tensor, interp_pts: torch.Tensor):
    """The 10 cubic constraints at the 20 interpolation points.

    Ebasis: (..., 4, 3, 3) with E(x,y,z) = x E0 + y E1 + z E2 + E3.
    Returns (..., 10, 20).
    """
    wx, wy, wz = interp_pts[:, 0], interp_pts[:, 1], interp_pts[:, 2]
    e = [
        [
            Ebasis[..., 0, i, j, None] * wx
            + Ebasis[..., 1, i, j, None] * wy
            + Ebasis[..., 2, i, j, None] * wz
            + Ebasis[..., 3, i, j, None]
            for j in range(3)
        ]
        for i in range(3)
    ]
    s = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for l in range(i, 3):
            s[i][l] = s[l][i] = (
                e[i][0] * e[l][0] + e[i][1] * e[l][1] + e[i][2] * e[l][2]
            )
    tr = s[0][0] + s[1][1] + s[2][2]
    M = [
        [
            2.0 * (s[i][0] * e[0][j] + s[i][1] * e[1][j] + s[i][2] * e[2][j])
            - tr * e[i][j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    detE = (
        e[0][0] * (e[1][1] * e[2][2] - e[1][2] * e[2][1])
        - e[0][1] * (e[1][0] * e[2][2] - e[1][2] * e[2][0])
        + e[0][2] * (e[1][0] * e[2][1] - e[1][1] * e[2][0])
    )
    rows = [detE] + [M[i][j] for i in range(3) for j in range(3)]
    return torch.stack(rows, dim=-2)


def _polish_xyz(Ebasis: torch.Tensor, xyz: torch.Tensor, iters: int = 3):
    """Damped Gauss-Newton on the 10 algebraic constraints with analytic
    Jacobians (dE/dp_k = Ebasis_k). Ebasis: (..., 4, 3, 3); xyz: (..., R, 3).
    """
    Bc = [
        [[Ebasis[..., k, i, j, None] for j in range(3)] for i in range(3)]
        for k in range(4)
    ]
    p = xyz
    for _ in range(iters):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        e = [
            [
                Bc[0][i][j] * x + Bc[1][i][j] * y + Bc[2][i][j] * z
                + Bc[3][i][j]
                for j in range(3)
            ]
            for i in range(3)
        ]
        s = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for l in range(i, 3):
                s[i][l] = s[l][i] = (
                    e[i][0] * e[l][0] + e[i][1] * e[l][1] + e[i][2] * e[l][2]
                )
        tr = s[0][0] + s[1][1] + s[2][2]
        M = [
            [
                2.0
                * (s[i][0] * e[0][j] + s[i][1] * e[1][j] + s[i][2] * e[2][j])
                - tr * e[i][j]
                for j in range(3)
            ]
            for i in range(3)
        ]
        detE = (
            e[0][0] * (e[1][1] * e[2][2] - e[1][2] * e[2][1])
            - e[0][1] * (e[1][0] * e[2][2] - e[1][2] * e[2][0])
            + e[0][2] * (e[1][0] * e[2][1] - e[1][1] * e[2][0])
        )
        cof = [[None] * 3 for _ in range(3)]
        for i in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            for j in range(3):
                j1, j2 = (j + 1) % 3, (j + 2) % 3
                cof[i][j] = e[i1][j1] * e[i2][j2] - e[i1][j2] * e[i2][j1]

        ddet = [None] * 3
        dM = [[[None] * 3 for _ in range(3)] for _ in range(3)]
        for k in range(3):
            d = Bc[k]
            ddet[k] = sum(
                cof[i][j] * d[i][j] for i in range(3) for j in range(3)
            )
            ds = [[None] * 3 for _ in range(3)]
            for i in range(3):
                for l in range(i, 3):
                    ds[i][l] = ds[l][i] = sum(
                        d[i][j] * e[l][j] + e[i][j] * d[l][j]
                        for j in range(3)
                    )
            dtr = ds[0][0] + ds[1][1] + ds[2][2]
            for i in range(3):
                for j in range(3):
                    dM[k][i][j] = (
                        2.0
                        * (
                            ds[i][0] * e[0][j]
                            + ds[i][1] * e[1][j]
                            + ds[i][2] * e[2][j]
                            + s[i][0] * d[0][j]
                            + s[i][1] * d[1][j]
                            + s[i][2] * d[2][j]
                        )
                        - dtr * e[i][j]
                        - tr * d[i][j]
                    )

        def dot_rows(ka, kb):
            acc = ddet[ka] * ddet[kb]
            for i in range(3):
                for j in range(3):
                    acc = acc + dM[ka][i][j] * dM[kb][i][j]
            return acc

        def dot_res(k):
            acc = ddet[k] * detE
            for i in range(3):
                for j in range(3):
                    acc = acc + dM[k][i][j] * M[i][j]
            return acc

        a00 = dot_rows(0, 0) + 1e-8
        a11 = dot_rows(1, 1) + 1e-8
        a22 = dot_rows(2, 2) + 1e-8
        a01 = dot_rows(0, 1)
        a02 = dot_rows(0, 2)
        a12 = dot_rows(1, 2)
        b0, b1, b2 = dot_res(0), dot_res(1), dot_res(2)
        c00 = a11 * a22 - a12 * a12
        c01 = a02 * a12 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c11 = a00 * a22 - a02 * a02
        c12 = a01 * a02 - a00 * a12
        c22 = a00 * a11 - a01 * a01
        det = a00 * c00 + a01 * c01 + a02 * c02
        inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / det, 0.0)
        dx = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
        dy = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det
        dz = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
        dp = torch.stack([dx, dy, dz], dim=-1)
        dp = torch.where(torch.isfinite(dp), dp, torch.zeros_like(dp))
        p = p - dp
    return p


def det3(E: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of batched 3x3 matrices."""
    return (
        E[..., 0, 0] * (E[..., 1, 1] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 1])
        - E[..., 0, 1] * (E[..., 1, 0] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 0])
        + E[..., 0, 2] * (E[..., 1, 0] * E[..., 2, 1] - E[..., 1, 1] * E[..., 2, 0])
    )


def _adjugate_t(E: torch.Tensor) -> torch.Tensor:
    """Transposed adjugate (cofactor matrix) of 3x3: d det(E) / dE."""
    a, b, c = E[..., 0, 0], E[..., 0, 1], E[..., 0, 2]
    d, e, f = E[..., 1, 0], E[..., 1, 1], E[..., 1, 2]
    g, h, i = E[..., 2, 0], E[..., 2, 1], E[..., 2, 2]
    row0 = torch.stack([e * i - f * h, f * g - d * i, d * h - e * g], dim=-1)
    row1 = torch.stack([c * h - b * i, a * i - c * g, b * g - a * h], dim=-1)
    row2 = torch.stack([b * f - c * e, c * d - a * f, a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _polymul(a: list, b: list) -> list:
    """Coefficient lists (ascending powers) -> product."""
    out = [None] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = ai * bj
            out[i + j] = t if out[i + j] is None else out[i + j] + t
    return out


def _polysub(a: list, b: list) -> list:
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        ai = a[i] if i < len(a) else None
        bi = b[i] if i < len(b) else None
        if ai is None:
            out.append(-bi)
        elif bi is None:
            out.append(ai)
        else:
            out.append(ai - bi)
    return out


_N_THETA_N = 257  # sign-scan resolution over the projective line
_MAX_ROOTS = 10
_N_BISECT = 14
_THETA_NP = np.linspace(-np.pi / 2, np.pi / 2, _N_THETA_N)
_SCAN_TABLE_NP = np.stack(
    [np.sin(_THETA_NP) ** k * np.cos(_THETA_NP) ** (10 - k)
     for k in range(11)]
)  # (11, S) homogeneous monomials of the scan grid


def _real_roots_poly10(a: torch.Tensor):
    """Real roots of batched degree-10 polynomials (ascending coeffs).

    a: (..., 11). Homogeneous evaluation in (sin th, cos th), z = tan th;
    sign-change scan ranked by bracket strength + fixed bisection.
    Returns (roots, valid): (..., 10) each.
    """
    dtype, dev = a.dtype, a.device
    scale = torch.amax(torch.abs(a), dim=-1, keepdim=True)
    a = a / torch.clamp(scale, min=1e-30)
    theta = torch.linspace(-math.pi / 2, math.pi / 2, _N_THETA_N,
                           dtype=dtype, device=dev)

    def peval(th):
        s, c = torch.sin(th), torch.cos(th)
        sp = [torch.ones_like(th)]
        cp = [torch.ones_like(th)]
        for _ in range(10):
            sp.append(sp[-1] * s)
            cp.append(cp[-1] * c)
        r = torch.zeros_like(th)
        for k in range(11):
            r = r + a[..., k, None] * (sp[k] * cp[10 - k])
        return r

    tbl = torch.as_tensor(_SCAN_TABLE_NP, dtype=dtype, device=dev)
    g = a @ tbl
    sign = torch.sign(g)
    flips = sign[..., :-1] * sign[..., 1:] < 0
    strength = torch.where(
        flips, torch.abs(g[..., :-1]) + torch.abs(g[..., 1:]), -1.0
    )
    top, cand = topk_stable(strength, _MAX_ROOTS)
    valid = top > 0
    cand = torch.clamp(cand, max=_N_THETA_N - 2)
    lo = theta[cand]
    hi = theta[cand + 1]
    g_lo = peval(lo)
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        g_mid = peval(mid)
        left = g_lo * g_mid <= 0
        hi = torch.where(left, mid, hi)
        lo, g_lo = torch.where(left, lo, mid), torch.where(left, g_lo, g_mid)
    mid = 0.5 * (lo + hi)
    roots = torch.tan(mid)
    valid = valid & (torch.abs(torch.abs(mid) - math.pi / 2) > 1e-5)
    return roots, valid


def solve_5pt_nister(x1: torch.Tensor, x2: torch.Tensor,
                     tables: SolverTables | None = None):
    """Batched five-point solver, Nister's closed form.

    x1, x2 (..., 5, 2) -> (E (..., 10, 3, 3) Frobenius-normalized,
    valid (..., 10)); invalid slots hold the identity.
    """
    if tables is None:
        tables = default_tables(x1.device)
    A = epipolar_rows(x1, x2)
    ns = nullspace_qr(A)
    Ebasis = ns.transpose(-1, -2).reshape(ns.shape[:-2] + (4, 3, 3))

    Fv = _constraint_values(Ebasis, tables.interp_pts)
    C = Fv @ tables.vinv_t_nister
    Bm = solve_small_lanes(C[..., :, :10], C[..., :, 10:])
    okA = torch.all(torch.isfinite(Bm).flatten(-2), dim=-1)
    Bm = torch.where(okA[..., None, None], Bm, torch.zeros_like(Bm))

    # pairs (hi, lo) with z * m_lo = m_hi: rows (4,5), (6,7), (8,9) give
    # b_x(z) x + b_y(z) y + b_c(z) = 0
    def row_polys(h, l):
        Bh = Bm[..., h, :]
        Bl = Bm[..., l, :]
        bx = [Bh[..., 2], Bh[..., 1] - Bl[..., 2], Bh[..., 0] - Bl[..., 1],
              -Bl[..., 0]]
        by = [Bh[..., 5], Bh[..., 4] - Bl[..., 5], Bh[..., 3] - Bl[..., 4],
              -Bl[..., 3]]
        bc = [Bh[..., 9], Bh[..., 8] - Bl[..., 9], Bh[..., 7] - Bl[..., 8],
              Bh[..., 6] - Bl[..., 7], -Bl[..., 6]]
        return bx, by, bc

    (b11, b12, b13), (b21, b22, b23), (b31, b32, b33) = (
        row_polys(4, 5), row_polys(6, 7), row_polys(8, 9)
    )
    p1 = _polysub(_polymul(b22, b33), _polymul(b23, b32))
    p2 = _polysub(_polymul(b23, b31), _polymul(b21, b33))
    p3 = _polysub(_polymul(b21, b32), _polymul(b22, b31))
    det_terms = _polymul(b11, p1)
    for i, t in enumerate(_polymul(b12, p2)):
        det_terms[i] = det_terms[i] + t
    for i, t in enumerate(_polymul(b13, p3)):
        det_terms[i] = det_terms[i] + t
    roots, rvalid = _real_roots_poly10(torch.stack(det_terms, dim=-1))

    def eval_poly(coeffs: list, z):
        r = torch.zeros_like(z)
        for k, ck in enumerate(coeffs):
            r = r + ck[..., None] * z**k
        return r

    z = roots
    M11, M12, M13 = eval_poly(b11, z), eval_poly(b12, z), eval_poly(b13, z)
    M21, M22, M23 = eval_poly(b21, z), eval_poly(b22, z), eval_poly(b23, z)
    M31, M32, M33 = eval_poly(b31, z), eval_poly(b32, z), eval_poly(b33, z)
    g11 = M11 * M11 + M21 * M21 + M31 * M31
    g12 = M11 * M12 + M21 * M22 + M31 * M32
    g22 = M12 * M12 + M22 * M22 + M32 * M32
    h1 = M11 * M13 + M21 * M23 + M31 * M33
    h2 = M12 * M13 + M22 * M23 + M32 * M33
    det_g = g11 * g22 - g12 * g12
    det_safe = torch.where(torch.abs(det_g) > 1e-30, det_g, 1e-30)
    x = -(g22 * h1 - g12 * h2) / det_safe
    y = -(g11 * h2 - g12 * h1) / det_safe
    ok = rvalid & (torch.abs(det_g) > 1e-25)

    return _models_from_xyz(Ebasis, torch.stack([x, y, roots], dim=-1), ok,
                            okA)


def _models_from_xyz(Ebasis, xyz, ok, okA):
    """Both five-point solvers' last step: the polish of (x, y, z), the
    essential matrices x E0 + y E1 + z E2 + E3 Frobenius-normalized, the
    validity mask; invalid slots hold the identity."""
    xyz = _polish_xyz(Ebasis, xyz)
    # runaway solutions overflow ||E||^2 to inf in f32, making E / ||E|| a
    # zero matrix that would pass the finiteness checks: bound xyz first
    ok = ok & torch.all(torch.abs(xyz) < 1e4, dim=-1) & torch.all(
        torch.isfinite(xyz), dim=-1
    )
    xyz = torch.clamp(torch.nan_to_num(xyz), -1e4, 1e4)
    coeffs = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)
    E = torch.einsum("...rb,...bij->...rij", coeffs, Ebasis)
    nrm = torch.linalg.norm(E.flatten(-2), dim=-1)
    E = E / torch.clamp(nrm, min=1e-12)[..., None, None]
    valid = ok & okA[..., None] & (nrm > 1e-9) & torch.isfinite(nrm) & (
        torch.all(torch.isfinite(E).flatten(-2), dim=-1)
    )
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    return torch.where(valid[..., None, None], E, eye), valid


# ---------------------------------------------------------------------------
# 5-point solver (Stewenius)
# ---------------------------------------------------------------------------

# quotient-basis indices (within the last 10 monomials) of x, y, z, 1
_BASIS_X, _BASIS_Y, _BASIS_Z, _BASIS_1 = 6, 7, 8, 9
# rows of M_z: z * {x^2, xy, y^2, xz, yz, z^2} are the eliminated degree-3
# monomials 4..9, z * {x, y, z, 1} = {xz, yz, z^2, z} the basis monomials
# 3, 4, 5 and 8 (slices, so that no index list is copied to the device)
_Z_TIMES_BASIS_HI = slice(4, 10)
_Z_TIMES_BASIS_LO = (slice(3, 6), slice(8, 9))

_N_THETA = 129  # sign-scan resolution
_N_BISECT_HESS = 16  # fixed bisection steps (theta space)
_THETA_EPS = 1e-3


def _theta_grid_np() -> np.ndarray:
    """The scan grid linspace(-pi/2 + 1e-3, pi/2 - 1e-3, 129) in float32,
    evaluated as the JAX package's ``jnp.linspace`` is: start (1 - s) +
    stop s with s = i / 128, the second product fused into the add, the
    stop exact."""
    start = np.float32(-np.pi / 2 + _THETA_EPS)
    stop = np.float32(np.pi / 2 - _THETA_EPS)
    step = np.arange(_N_THETA - 1, dtype=np.float32) / np.float32(
        _N_THETA - 1)
    head = (start * (np.float32(1.0) - step)).astype(np.float32)
    fused = (np.float64(stop) * step.astype(np.float64)
             + head.astype(np.float64)).astype(np.float32)
    return np.append(fused, stop).astype(np.float32)


def _action_matrix(C: torch.Tensor):
    """Gauss-Jordan elimination of the degree-3 monomials: C (..., 10, 20)
    in Stewenius order -> (M_z (..., 10, 10), ok (...)), ok where the
    elimination stayed finite."""
    B = solve_small_lanes(C[..., :, :10], C[..., :, 10:])
    ok = torch.all(torch.isfinite(B).flatten(-2), dim=-1)
    B = torch.where(ok[..., None, None], B, torch.zeros_like(B))
    top = -B[..., _Z_TIMES_BASIS_HI, :]
    eye = torch.eye(10, dtype=C.dtype, device=C.device)
    bottom = torch.cat([eye[r] for r in _Z_TIMES_BASIS_LO]).expand(
        C.shape[:-2] + (4, 10))
    return torch.cat([top, bottom], dim=-2), ok


def hessenberg(M: torch.Tensor):
    """Householder reduction to upper Hessenberg form: M (..., n, n) ->
    (H, Q) with M = Q H Q^T; n - 2 reflections, each a handful of batched
    tensor ops."""
    n = M.shape[-1]
    H = M
    Q = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    rows = torch.arange(n, device=M.device)
    for k in range(n - 2):
        # the entries below the pivot row k + 1
        xm = torch.where(rows > k, H[..., :, k], 0.0)
        normx = torch.linalg.norm(xm, dim=-1)
        x0 = H[..., k + 1, k]
        alpha = -torch.sign(torch.where(x0 == 0, 1.0, x0)) * normx
        v = xm - alpha[..., None] * (rows == (k + 1)).to(M.dtype)
        vn = torch.linalg.norm(v, dim=-1, keepdim=True)
        v = v / torch.where(vn > 1e-20, vn, 1.0)
        # H <- P H P with P = I - 2 v v^T
        Hv = torch.einsum("...ij,...j->...i", H, v)
        vH = torch.einsum("...i,...ij->...j", v, H)
        vHv = torch.sum(v * Hv, dim=-1)
        H = (H - 2.0 * v[..., :, None] * vH[..., None, :]
             - 2.0 * Hv[..., :, None] * v[..., None, :]
             + 4.0 * vHv[..., None, None] * v[..., :, None]
             * v[..., None, :])
        Qv = torch.einsum("...ij,...j->...i", Q, v)
        Q = Q - 2.0 * Qv[..., :, None] * v[..., None, :]
    return H, Q


def _hyman(H: torch.Tensor, lam: torch.Tensor):
    """Hyman's method on upper Hessenberg H (..., n, n) at shifts lam
    (...): (r, x) with det(H - lam I) = r * prod(subdiagonal) *
    (-1)^(n-1), so that r's sign changes over lam locate the eigenvalues,
    and x (..., n) solving rows 2..n of (H - lam I) x = 0 with x_{n-1} =
    1 (the eigenvector, in the Hessenberg basis, at an eigenvalue).

    The back substitution carries x as one (..., n) vector whose entries
    not yet defined are 0: row i's sum is one reduction over it, each
    positive renormalization (which bounds the magnitudes and keeps the
    signs) one division, so a call is O(n) tensor ops. The JAX package
    sums each row term by term, in another order.
    """
    n = H.shape[-1]
    x = torch.zeros(lam.shape + (n,), dtype=H.dtype, device=H.device)
    x[..., n - 1] = 1.0
    sub = torch.diagonal(H, offset=-1, dim1=-2, dim2=-1)
    sub = torch.where(torch.abs(sub) > 1e-25, sub, 1e-25)
    for i in range(n - 1, 0, -1):
        # row i: sum_{j >= i} H[i, j] x_j - lam x_i + H[i, i-1] x_{i-1} = 0
        s = torch.sum(H[..., i, :] * x, dim=-1) - lam * x[..., i]
        xi = -s / sub[..., i - 1]
        m = torch.clamp(torch.abs(xi), min=1.0)
        x = x / m[..., None]
        x[..., i - 1] = xi / m
    r = torch.sum(H[..., 0, :] * x, dim=-1) - lam * x[..., 0]
    return r, x


def _real_eigenvalues_hess(H: torch.Tensor, theta: torch.Tensor):
    """Real eigenvalues of upper Hessenberg matrices (..., 10, 10): sign
    scan of Hyman's r on the tan grid of theta (129,), then fixed
    bisection in theta. Returns (roots, valid) (..., 10). Complex
    eigenvalues are skipped, and so is a tight double root without a sign
    change (that hypothesis is simply not produced)."""
    batch = H.shape[:-2]
    Hr = H[..., None, :, :]
    g, _ = _hyman(Hr, torch.tan(theta).expand(batch + (_N_THETA,)))
    sign = torch.sign(g)
    flips = sign[..., :-1] * sign[..., 1:] < 0
    # the first up-to-10 flip intervals (S - 1 pads: invalid)
    iota = torch.arange(_N_THETA - 1, device=H.device)
    cand = torch.sort(torch.where(flips, iota, _N_THETA - 1),
                      dim=-1).values[..., :_MAX_ROOTS]
    valid = cand < (_N_THETA - 1)
    cand = torch.clamp(cand, max=_N_THETA - 2)
    lo = theta[cand]
    hi = theta[cand + 1]
    g_lo, _ = _hyman(Hr, torch.tan(lo))
    for _ in range(_N_BISECT_HESS):
        mid = 0.5 * (lo + hi)
        g_mid, _ = _hyman(Hr, torch.tan(mid))
        left = g_lo * g_mid <= 0
        hi = torch.where(left, mid, hi)
        lo, g_lo = torch.where(left, lo, mid), torch.where(left, g_lo, g_mid)
    return torch.tan(0.5 * (lo + hi)), valid


def _eigenvector_xy_hess(H, Q, z, valid):
    """x, y of each eigenvalue z (..., R) from the quotient-basis
    eigenvector of M_z: Hyman's back-substituted vector at z, rotated back
    by Q. Returns x, y, ok (..., R); ok also requires the eigenvector's z
    entry to agree with z."""
    _, xh = _hyman(H[..., None, :, :], z)
    v = torch.einsum("...ij,...rj->...ri", Q, xh)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                        min=1e-20)
    w = v[..., _BASIS_1]
    ok = valid & (torch.abs(w) > 1e-6) & torch.all(torch.isfinite(v), dim=-1)
    w_safe = torch.where(torch.abs(w) > 1e-12, w, 1.0)
    x = v[..., _BASIS_X] / w_safe
    y = v[..., _BASIS_Y] / w_safe
    z_hat = v[..., _BASIS_Z] / w_safe
    ok = ok & (torch.abs(z_hat - z) <= 0.05 * (1.0 + torch.abs(z)))
    return x, y, ok


def solve_5pt(x1: torch.Tensor, x2: torch.Tensor,
              tables: SolverTables | None = None):
    """Batched five-point solver, Stewenius's action matrix.

    x1, x2 (..., 5, 2) -> (E (..., 10, 3, 3) Frobenius-normalized,
    valid (..., 10)); invalid slots hold the identity.
    """
    if tables is None:
        tables = default_tables(x1.device)
    A = epipolar_rows(x1, x2)
    ns = nullspace_qr(A)
    Ebasis = ns.transpose(-1, -2).reshape(ns.shape[:-2] + (4, 3, 3))
    C = _constraint_values(Ebasis, tables.interp_pts) @ tables.vinv_t_stewenius
    Mz, okA = _action_matrix(C)
    Hm, Qm = hessenberg(Mz)
    roots, rvalid = _real_eigenvalues_hess(Hm, tables.theta_hess)
    x, y, ok = _eigenvector_xy_hess(Hm, Qm, roots, rvalid)
    return _models_from_xyz(Ebasis, torch.stack([x, y, roots], dim=-1), ok,
                            okA)


# ---------------------------------------------------------------------------
# 8-point / nonminimal weighted solver
# ---------------------------------------------------------------------------


def solve_8pt(x1, x2, mask=None, weights=None, essential: bool = True,
              pairs: bool = False):
    """Batched (weighted) Hartley-normalized 8-point solver on N >= 8
    correspondences; projected to the essential manifold (or to rank 2
    with essential=False). `pairs`: the leading dims are a pair axis
    (``nullspace_from_ata``). Returns (E, valid)."""
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    w = mask.to(x1.dtype)
    if weights is not None:
        w = w * weights
    x1n, T1 = normalize_points(x1, mask)
    x2n, T2 = normalize_points(x2, mask)
    A = epipolar_rows(x1n, x2n) * w[..., None]
    ns = nullspace_from_ata(A, 1, pairs)[..., 0]
    En = ns.reshape(ns.shape[:-1] + (3, 3))
    E = T2.transpose(-1, -2) @ En @ T1
    U, s, Vt = torch.linalg.svd(E)
    if essential:
        m = 0.5 * (s[..., 0] + s[..., 1])
        s_new = torch.stack([m, m, torch.zeros_like(m)], dim=-1)
    else:
        s_new = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:3])], dim=-1)
    E = (U * s_new[..., None, :]) @ Vt
    nrm = torch.linalg.norm(E.flatten(-2), dim=-1)
    E = E / torch.clamp(nrm, min=1e-12)[..., None, None]
    valid = torch.all(torch.isfinite(E).flatten(-2), dim=-1) & (
        torch.sum(mask.to(torch.int32), dim=-1) >= 8
    )
    return E, valid


# ---------------------------------------------------------------------------
# 7-point fundamental solver
# ---------------------------------------------------------------------------


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root, negative for negative x."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_7pt(x1: torch.Tensor, x2: torch.Tensor):
    """Batched 7-point fundamental-matrix solver.

    x1, x2: (..., 7, 2) pixel or normalized coords. F spans the 2-D
    nullspace of the 7 epipolar rows: F = F1 + lam F2 with det(F1 + lam
    F2) = 0, a cubic in lam whose coefficients come from its values at
    lam in {0, 1, -1, 2}, solved in closed form (trigonometric for three
    real roots, Cardano for one; branch-free). Returns ((..., 3, 3, 3)
    unit-norm models, (..., 3) validity): up to 3 real solutions per
    sample (usac FundmatrixEstimator's minimal solver).

    The nullspace basis (F1, F2) is any orthonormal pair of the 2-D
    space, so another eigensolver gives the same models in another order;
    a sample with disc ~ 0 may switch between one and three roots.
    """
    msk = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    x1n, T1 = normalize_points(x1, msk)
    x2n, T2 = normalize_points(x2, msk)
    ns = nullspace_from_ata(epipolar_rows(x1n, x2n), 2)  # (..., 9, 2)
    F1 = ns[..., 0].reshape(ns.shape[:-2] + (3, 3))
    F2 = ns[..., 1].reshape(ns.shape[:-2] + (3, 3))

    d0 = det_small(F1)
    d1 = det_small(F1 + F2)
    dm1 = det_small(F1 - F2)
    d2 = det_small(F1 + 2.0 * F2)
    c0 = d0
    c2 = 0.5 * (d1 + dm1) - d0
    c3 = (d2 - 2.0 * d1 + d0 - 2.0 * c2) / 6.0
    c1 = d1 - d0 - c2 - c3

    # roots of c3 x^3 + c2 x^2 + c1 x + c0; a vanishing c3 is clamped
    eps = 1e-12
    c3_safe = torch.where(torch.abs(c3) < eps,
                          torch.where(c3 < 0, -eps, eps), c3)
    a = c2 / c3_safe
    b = c1 / c3_safe
    c = c0 / c3_safe
    # depressed cubic t^3 + p t + q, x = t - a / 3
    p = b - a * a / 3.0
    q = 2.0 * a**3 / 27.0 - a * b / 3.0 + c
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # three real roots (trigonometric)
    pm = torch.clamp(p, max=-eps)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    theta = torch.arccos(torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    t_tri = torch.stack([
        m * torch.cos(theta),
        m * torch.cos(theta - two_pi_3),
        m * torch.cos(theta - 2.0 * two_pi_3),
    ], dim=-1)
    # one real root (Cardano)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_car = (_cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq))[..., None].expand(
        t_tri.shape)

    three_real = disc <= 0.0
    lam = torch.where(three_real[..., None], t_tri, t_car) - (a / 3.0)[
        ..., None]
    valid = torch.cat([
        torch.ones_like(three_real[..., None]),
        three_real[..., None].expand(three_real.shape + (2,)),
    ], dim=-1)

    Fn = F1[..., None, :, :] + lam[..., None, None] * F2[..., None, :, :]
    F = T2.transpose(-1, -2)[..., None, :, :] @ Fn @ T1[..., None, :, :]
    nrm = torch.linalg.norm(F.flatten(-2), dim=-1)
    F = F / torch.clamp(nrm, min=1e-12)[..., None, None]
    valid = valid & torch.all(torch.isfinite(F).flatten(-2), dim=-1)
    return F, valid


# ---------------------------------------------------------------------------
# homography DLT
# ---------------------------------------------------------------------------


def homography_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per correspondence for x2 ~ H x1: -> (..., 2N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, one, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([z, z, z, u1, v1, one, -v2 * u1, -v2 * v1, -v2], dim=-1)
    rows = torch.stack([r1, r2], dim=-2)
    return rows.reshape(rows.shape[:-3] + (2 * rows.shape[-3], 9))


def solve_homography(x1, x2, mask=None, weights=None, pairs: bool = False):
    """Batched (weighted) Hartley-normalized homography DLT on N >= 4
    correspondences; minimal samples take the QR nullspace. `pairs`: the
    leading dims are a pair axis (``nullspace_from_ata``). Returns (H,
    valid) with H[2, 2] = 1 where possible."""
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    w = mask.to(x1.dtype)
    if weights is not None:
        w = w * weights
    x1n, T1 = normalize_points(x1, mask)
    x2n, T2 = normalize_points(x2, mask)
    A = homography_rows(x1n, x2n) * torch.repeat_interleave(w, 2, dim=-1)[
        ..., None]
    if A.shape[-2] == A.shape[-1] - 1:
        ns = nullspace_qr(A)[..., 0]
    else:
        ns = nullspace_from_ata(A, 1, pairs)[..., 0]
    Hn = ns.reshape(ns.shape[:-1] + (3, 3))
    H = torch.linalg.solve(T2, Hn @ T1)
    scale = H[..., 2, 2]
    safe = torch.abs(scale) > 1e-8
    H = torch.where(
        safe[..., None, None],
        H / torch.where(safe, scale, 1.0)[..., None, None],
        H,
    )
    valid = torch.all(torch.isfinite(H).flatten(-2), dim=-1) & (
        torch.sum(mask.to(torch.int32), dim=-1) >= 4
    )
    return H, valid


def homography_transfer_error(H, x1, x2):
    """Squared forward transfer error |x2 - H x1|^2 (..., N)."""
    p = to_homogeneous(x1) @ H.transpose(-1, -2)
    w = p[..., 2]
    w_safe = torch.where(torch.abs(w) > 1e-12, w, 1e-12)
    err = torch.sum((p[..., :2] / w_safe[..., None] - x2) ** 2, dim=-1)
    return torch.where(torch.abs(w) > 1e-12, err, torch.inf)
