"""Kneip eigensolver: relative pose by rotation-only optimization (port of
``ops/eigensolver.py``).

Kneip & Lynen (ICCV'13), OpenGV's ``eigensolver`` (the reference's Kneip
RefineAlg rows, pose_estim.h:67-77): every epipolar plane normal
n_i = f2_i x (R f1_i) is orthogonal to t, so M(R) = sum w_i n_i n_i^T has
(noise-free) a zero eigenvalue with eigenvector t. The solver minimizes
lambda_min(M(R)) over a Cayley vector around the current rotation with a
fixed count of saddle-free Newton steps and a 6-scale line search.

The JAX package differentiates lambda_min through ``jnp.linalg.eigh``
with ``jax.grad`` / ``jax.hessian``. Here M's first and second
derivatives in the Cayley vector are closed forms (M is a rational
function of it), and the eigenvalue's follow from those of a simple
eigenvalue: g_k = v0^T M_k v0 and
H_kl = v0^T M_kl v0 + 2 sum_{m>0} (v_m^T M_k v0)(v_m^T M_l v0) /
(lambda_0 - lambda_m). Every 3x3 eigen-solve is the closed form
``smalllinalg.eigh_sym3x3``, and the best line-search scale is picked with
a gather: the loop reads nothing on the host. Every function takes an
optional leading pair axis (``jax.vmap`` of the JAX package's): the
line search picks its scale per pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops import smalllinalg, solvers

# line-search scales of every Newton step, "no move" included
_SCALES = (2.0, 1.0, 0.5, 0.25, 0.1, 0.0)


def _cayley_to_rot(c: torch.Tensor) -> torch.Tensor:
    """Cayley vector (..., 3) -> rotation (..., 3, 3); singularity-free for
    |angle| < pi."""
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    s = 1.0 + c1 * c1 + c2 * c2 + c3 * c3
    R = torch.stack(
        [
            1.0 + c1 * c1 - c2 * c2 - c3 * c3,
            2.0 * (c1 * c2 - c3),
            2.0 * (c1 * c3 + c2),
            2.0 * (c1 * c2 + c3),
            1.0 - c1 * c1 + c2 * c2 - c3 * c3,
            2.0 * (c2 * c3 - c1),
            2.0 * (c1 * c3 - c2),
            2.0 * (c2 * c3 + c1),
            1.0 - c1 * c1 - c2 * c2 + c3 * c3,
        ],
        dim=-1,
    ).reshape(c.shape[:-1] + (3, 3))
    return R / s[..., None, None]


def _m_matrix(R, b1, b2, w):
    """M(R) = sum_i w_i n_i n_i^T with n_i = b2_i x (R b1_i). (..., 3, 3)."""
    Rb1 = torch.einsum("...ij,...nj->...ni", R, b1)
    n = torch.linalg.cross(b2.expand_as(Rb1), Rb1, dim=-1)
    return torch.einsum("...ni,...nj->...ij", n * w[..., None], n)


def _lambda_min(M: torch.Tensor) -> torch.Tensor:
    return smalllinalg.eigh_sym3x3(M)[0][..., 0]


class EigensolverResult(NamedTuple):
    # each field carries the inputs' pair axis, if any, in front
    R: torch.Tensor  # (3, 3) rotation cam1 -> cam2
    t: torch.Tensor  # (3,) unit translation (sign by cheirality vote)
    E: torch.Tensor  # (3, 3) essential matrix [t]x R
    eigenvalue: torch.Tensor  # final smallest eigenvalue (residual energy)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[..., i, :] (or a[..., i] for a vector per pair) for an index per
    pair i (...), without reading it on the host."""
    if a.ndim == i.ndim + 1:
        return torch.take_along_dim(a, i[..., None], dim=-1)[..., 0]
    return torch.take_along_dim(a, i[..., None, None], dim=-2)[..., 0, :]


def _m_derivatives(Rbase, b1, b2, w):
    """M(Rbase cay(c)) and its first and second derivatives in the Cayley
    vector c at c = 0: (..., 3, 3), (..., 3, 3, k), (..., 3, 3, k, l). At
    c = 0, d cay / dc_k b = 2 e_k x b and d2 cay / dc_k dc_l b =
    2 (e_k b_l + e_l b_k) - 4 delta_kl b."""
    eye = torch.eye(3, dtype=b1.dtype, device=b1.device)
    batch, N = b1.shape[:-2], b1.shape[-2]
    Rt = Rbase.transpose(-1, -2)
    n = torch.linalg.cross(b2, b1 @ Rt, dim=-1)  # (..., N, 3)
    v1 = 2.0 * torch.linalg.cross(
        eye[:, None, :].expand(batch + (3, N, 3)),
        b1[..., None, :, :].expand(batch + (3, N, 3)), dim=-1)
    n1 = torch.linalg.cross(b2[..., None, :, :].expand(v1.shape),
                            v1 @ Rt[..., None, :, :], dim=-1)  # (k, N, 3)
    v2 = (2.0 * (torch.einsum("kj,...il->...klij", eye, b1)
                 + torch.einsum("lj,...ik->...klij", eye, b1))
          - 4.0 * torch.einsum("kl,...ij->...klij", eye, b1))
    n2 = torch.linalg.cross(b2[..., None, None, :, :].expand(v2.shape),
                            v2 @ Rt[..., None, None, :, :],
                            dim=-1)  # (k, l, N, 3)
    nw = n * w[..., None]
    M = n.transpose(-1, -2) @ nw
    dM = torch.einsum("...kia,...ib->...abk", n1, nw)
    dM = dM + dM.transpose(-3, -2)
    ddM = (torch.einsum("...klia,...ib->...abkl", n2, nw)
           + torch.einsum("...kia,...lib,...i->...abkl", n1, n1, w))
    ddM = ddM + ddM.transpose(-4, -3)
    return M, dM, ddM


def _grad_hess(Rbase, b1, b2, w):
    """Gradient (..., 3) and Hessian (..., 3, 3) of lambda_min(M(Rbase
    cay(c))) in the Cayley vector c at c = 0."""
    M, dM, ddM = _m_derivatives(Rbase, b1, b2, w)
    lam, V = smalllinalg.eigh_sym3x3(M)
    v0 = V[..., :, 0]
    # a_mk = v_m^T M_k v0
    a = torch.einsum("...im,...ijk,...j->...mk", V, dM, v0)
    g = a[..., 0, :]
    gap = lam[..., :1] - lam[..., 1:]
    H = (torch.einsum("...i,...ijkl,...j->...kl", v0, ddM, v0)
         + 2.0 * torch.einsum("...mk,...ml,...m->...kl", a[..., 1:, :],
                              a[..., 1:, :], 1.0 / gap))
    return g, 0.5 * (H + H.transpose(-1, -2))


def _newton_step(Rbase, b1, b2, w):
    """One saddle-free Newton step with its line search, the scale picked
    per pair. Returns the new rotation and its energy."""
    g, H = _grad_hess(Rbase, b1, b2, w)
    # saddle-free Newton: |H| in its eigenbasis escapes the saddles the
    # plain damped Newton stalls in
    evals, VH = smalllinalg.eigh_sym3x3(H)
    scale = torch.maximum(
        torch.abs(evals),
        1e-3 * torch.amax(torch.abs(evals), dim=-1, keepdim=True))
    scale = torch.clamp(scale, min=1e-9)
    step = -(VH @ ((VH.transpose(-1, -2) @ g[..., None])
                   / scale[..., None]))[..., 0]
    ok = torch.isfinite(step).all(dim=-1)
    gd = -g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                          min=1e-9) * 0.05
    step = torch.where(ok[..., None], step, gd)
    cands = torch.stack([s * step for s in _SCALES], dim=-2)  # (..., 6, 3)
    vals = _lambda_min(_m_matrix(Rbase[..., None, :, :]
                                 @ _cayley_to_rot(cands),
                                 b1[..., None, :, :], b2[..., None, :, :],
                                 w[..., None, :]))
    best = torch.argmin(vals, dim=-1)
    return Rbase @ _cayley_to_rot(_take(cands, best)), _take(vals, best)


def solve_eigensolver(
    x1: torch.Tensor,
    x2: torch.Tensor,
    weights: torch.Tensor,
    R0: torch.Tensor | None = None,
    iterations: int = 12,
) -> EigensolverResult:
    """Relative pose by eigenvalue minimization over rotations.

    x1, x2: (N, 2) normalized coords; weights: (N,) >= 0 (0 = masked out);
    R0: initial rotation, else the weighted 8pt solution's
    cheirality-voted rotation (identity if the 8pt solve fails). Takes an
    optional leading pair axis on every input: the Newton loop has a fixed
    count and steps every pair at once.
    """
    dt, dev = x1.dtype, x1.device
    b1 = geo.normalize_vec(geo.to_homogeneous(x1))
    b2 = geo.normalize_vec(geo.to_homogeneous(x2))
    w = weights.to(dt)
    if R0 is None:
        E8, ok8 = solvers.solve_8pt(x1, x2, mask=w, pairs=True)
        R8, _, _, _, _ = geo.recover_pose(E8, x1, x2, w > 0.0)
        R0 = torch.where(ok8[..., None, None], R8,
                         torch.eye(3, dtype=dt, device=dev))
    R = R0
    lam = _lambda_min(_m_matrix(R0, b1, b2, w))
    for _ in range(iterations):
        R, lam = _newton_step(R, b1, b2, w)

    # translation: eigenvector of the smallest eigenvalue of M(R*)
    _, evecs = smalllinalg.eigh_sym3x3(_m_matrix(R, b1, b2, w))
    t = evecs[..., :, 0]
    # the eigenvector's sign is arbitrary and the epipolar residual cannot
    # tell: count points in front of both cameras for +t and -t
    maskb = w > 0.0
    n_pos, _, _ = geo.cheirality_counts(R, t, x1, x2, maskb)
    n_neg, _, _ = geo.cheirality_counts(R, -t, x1, x2, maskb)
    t = torch.where((n_neg > n_pos)[..., None], -t, t)
    return EigensolverResult(R=R, t=t, E=geo.essential_from_rt(R, t),
                             eigenvalue=lam)


def refine_essential_kneip(
    E0: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    inlier_mask: torch.Tensor,
    weights: torch.Tensor | None = None,
    iterations: int = 12,
) -> EigensolverResult:
    """Kneip nonminimal refinement of E0 on its inliers: the rotation seed
    is E0's cheirality-voted decomposition, then the eigensolver polishes R
    on the inlier set (per pair with a leading pair axis)."""
    w = inlier_mask.to(x1.dtype)
    if weights is not None:
        w = w * weights
    R0, _, _, _, _ = geo.recover_pose(E0, x1, x2, inlier_mask)
    return solve_eigensolver(x1, x2, w, R0=R0, iterations=iterations)
