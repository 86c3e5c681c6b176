"""Closed-form tiny linear algebra (port of ``ops/smalllinalg.py``).

The JAX package replaced ``jnp.linalg.{svd,eigh,solve}`` on the sequential
IRLS/LM chains with branch-free closed forms; the port keeps the same
closed forms so that both packages project, solve and pick eigenvectors
with the same arithmetic:

- ``eigh_sym3x3``: Cardano eigenvalues + cross-product eigenvectors of a
  symmetric 3x3 (ascending order, the ``eigh`` convention).
- ``svd3x3``: unrolled one-sided Jacobi SVD of a 3x3.
- ``chol_solve_unrolled`` / ``min_eigvec_spd``: unrolled Cholesky solve and
  shifted inverse iteration for the smallest eigenvector of a small PSD
  matrix.

Every function works on tensors of any leading batch shape on the device
they live on.
"""

from __future__ import annotations

import math

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def eigh_sym3x3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of a symmetric 3x3 (batched over leading dims).

    Returns (w, V): ascending eigenvalues (..., 3), eigenvectors in the
    columns of V (..., 3, 3).
    """
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-38))
    Bn = B / p[..., None, None]
    detBn = torch.linalg.det(Bn)
    r = torch.clamp(detBn / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w0 = q + 2.0 * p * torch.cos(phi)
    w2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w2, w1, w0], dim=-1)

    def eigvec(wk):
        M = A - wk[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01 = _cross(r0, r1)
        c02 = _cross(r0, r2)
        c12 = _cross(r1, r2)
        n01 = torch.sum(c01 * c01, dim=-1)
        n02 = torch.sum(c02 * c02, dim=-1)
        n12 = torch.sum(c12 * c12, dim=-1)
        best = torch.stack([n01, n02, n12], dim=-1)
        idx = torch.argmax(best, dim=-1)
        v = torch.where(
            (idx == 0)[..., None], c01,
            torch.where((idx == 1)[..., None], c02, c12),
        )
        nrm = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-38))
        return v / nrm[..., None], torch.amax(best, dim=-1)

    v0, q0 = eigvec(w[..., 0])
    v2, q2 = eigvec(w[..., 2])
    v1 = _cross(v2, v0)
    n1 = torch.sqrt(torch.clamp(torch.sum(v1 * v1, dim=-1), min=1e-38))
    v1 = v1 / n1[..., None]

    def complete_frame(a):
        # rows of eye, made on the device (no host-to-device copy)
        ex, ey = eye[0], eye[1]
        e = torch.where(torch.abs(a[..., 0:1]) < 0.9, ex.expand(a.shape),
                        ey.expand(a.shape))
        b = _cross(a, e)
        b = b / torch.sqrt(
            torch.clamp(torch.sum(b * b, dim=-1, keepdim=True), min=1e-38)
        )
        c = _cross(a, b)
        return b, c

    bad0 = q0 < 1e-20
    bad2 = q2 < 1e-20
    f1, f2 = complete_frame(v0)
    v1 = torch.where(bad2[..., None], f1, v1)
    v2 = torch.where(bad2[..., None], f2, v2)
    g1, g0 = complete_frame(v2)
    sel = (bad0 & ~bad2)[..., None]
    v1 = torch.where(sel, g1, v1)
    v0 = torch.where(sel, g0, v0)
    V = torch.stack([v0, v1, v2], dim=-1)
    return w, V


def svd3x3(
    A: torch.Tensor, sweeps: int = 4
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD of a general 3x3 (batched): A = U diag(s) Vt, s descending.

    Unrolled one-sided Jacobi on the columns of A, with an orthonormal
    cross-product completion of a (near-)null third column.
    """
    G = A
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)

    def rotate(G, V, i, j):
        gi, gj = G[..., :, i], G[..., :, j]
        a = torch.sum(gi * gi, dim=-1)
        b = torch.sum(gj * gj, dim=-1)
        c = torch.sum(gi * gj, dim=-1)
        scale = torch.clamp(a + b, min=1e-30)
        tau = (a - b) / torch.maximum(2.0 * torch.abs(c), 1e-30 * scale)
        sgn_tau = torch.where(tau >= 0, 1.0, -1.0)
        t = torch.where(
            torch.abs(c) > 1e-30 * scale,
            sgn_tau * torch.sign(c)
            / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau)),
            torch.zeros_like(c),
        )
        cs = 1.0 / torch.sqrt(1.0 + t * t)
        sn = cs * t
        cs = cs[..., None]
        sn = sn[..., None]
        gi_new = cs * gi + sn * gj
        gj_new = -sn * gi + cs * gj
        vi, vj = V[..., :, i], V[..., :, j]
        vi_new = cs * vi + sn * vj
        vj_new = -sn * vi + cs * vj
        cols_g = [G[..., :, k] for k in range(3)]
        cols_v = [V[..., :, k] for k in range(3)]
        cols_g[i], cols_g[j] = gi_new, gj_new
        cols_v[i], cols_v[j] = vi_new, vj_new
        return torch.stack(cols_g, dim=-1), torch.stack(cols_v, dim=-1)

    for _ in range(sweeps):
        for (i, j) in ((0, 1), (0, 2), (1, 2)):
            G, V = rotate(G, V, i, j)

    s = torch.sqrt(torch.clamp(torch.sum(G * G, dim=-2), min=0.0))

    def order2(s, G, V, i, j):
        swap = s[..., i] < s[..., j]
        si = torch.where(swap, s[..., j], s[..., i])
        sj = torch.where(swap, s[..., i], s[..., j])
        gi = torch.where(swap[..., None], G[..., :, j], G[..., :, i])
        gj = torch.where(swap[..., None], G[..., :, i], G[..., :, j])
        vi = torch.where(swap[..., None], V[..., :, j], V[..., :, i])
        vj = torch.where(swap[..., None], V[..., :, i], V[..., :, j])
        svals = [s[..., k] for k in range(3)]
        svals[i], svals[j] = si, sj
        cols_g = [G[..., :, k] for k in range(3)]
        cols_g[i], cols_g[j] = gi, gj
        cols_v = [V[..., :, k] for k in range(3)]
        cols_v[i], cols_v[j] = vi, vj
        return (
            torch.stack(svals, dim=-1),
            torch.stack(cols_g, dim=-1),
            torch.stack(cols_v, dim=-1),
        )

    for (i, j) in ((0, 1), (0, 2), (1, 2)):
        s, G, V = order2(s, G, V, i, j)

    U = G / torch.clamp(s[..., None, :], min=1e-38)
    u2_c = _cross(U[..., :, 0], U[..., :, 1])
    u2_c = u2_c / torch.sqrt(
        torch.clamp(torch.sum(u2_c * u2_c, dim=-1, keepdim=True), min=1e-38)
    )
    null3 = s[..., 2] <= 1e-6 * torch.clamp(s[..., 0], min=1e-30)
    u2 = torch.where(null3[..., None], u2_c, U[..., :, 2])
    U = torch.cat([U[..., :, :2], u2[..., :, None]], dim=-1)
    return U, s, V.transpose(-1, -2)


def chol_solve_unrolled(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for SPD A (static NxN, N small) via unrolled Cholesky.

    A: (N, N); B: (N,) or (N, K).
    """
    n = A.shape[0]
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = d
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / d
    Y = [None] * n
    for i in range(n):
        s = B[i]
        for k in range(i):
            s = s - L[i][k] * Y[k]
        Y[i] = s / L[i][i]
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * X[k]
        X[i] = s / L[i][i]
    out = torch.stack(X)
    return out[:, 0] if vec else out


def min_eigvec_spd(
    A: torch.Tensor, iterations: int = 4, v0: torch.Tensor | None = None
) -> torch.Tensor:
    """Smallest eigenvector of a PSD NxN (static N) by inverse iteration.

    v0: optional warm start, blended with the all-ones start so that a
    near-orthogonal all-ones vector cannot stall the iteration.
    """
    n = A.shape[0]
    ridge = 1e-6 * torch.trace(A) / n + 1e-30
    As = A + ridge * torch.eye(n, dtype=A.dtype, device=A.device)
    ones = torch.ones((n,), dtype=A.dtype, device=A.device) / math.sqrt(n)
    if v0 is None:
        v = ones
    else:
        v0n = v0 / torch.sqrt(torch.clamp(torch.sum(v0 * v0), min=1e-38))
        v = v0n + 0.125 * ones
        v = torch.where(torch.all(torch.isfinite(v)), v, ones)
        v = v / torch.sqrt(torch.clamp(torch.sum(v * v), min=1e-38))
    for _ in range(iterations):
        v = chol_solve_unrolled(As, v)
        v = v / torch.sqrt(torch.clamp(torch.sum(v * v), min=1e-38))
    return v
