"""Bundle adjustment: Levenberg-Marquardt with per-point Schur elimination
(port of ``ops/ba.py``).

- ``bundle_adjust`` == SBAdriver::perform_sba (BA_driver.cpp:1878) with the
  modes BA_MOTSTRUCT / BA_MOT / BA_STRUCT / BA_MOT_MOTSTRUCT and the
  least-squares or pseudo-Huber cost (BA_driver.h:69-82).
- ``refine_stereo_ba`` == refineStereoBA (pose_estim.cpp:1083-1383): cam0
  fixed at the origin, restore guards dR > 1.25 deg or |d||t||| > 0.05
  (pose_estim.h:239-240).
- ``refine_multi_cam_ba`` == refineMultCamBA (pose_estim.cpp:1384-1736).

The observations are a dense masked (P points, C cameras, 2) tensor; the
3x3 point blocks are eliminated by their LU inverses and the reduced
(C D)^2 camera system is solved by a column Cholesky. The
per-observation Jacobians are the analytic derivatives of ``_residual``
(``_jacobians``), the same derivatives the JAX package takes with
``jax.jacfwd`` per observation under ``jax.vmap`` over (P, C). The LM loop
has a fixed count and reads nothing on the host.

``bundle_adjust`` and ``refine_stereo_ba`` take an optional leading pair
axis in front of every per-problem input (``jax.vmap`` of the JAX
package's function): residuals, Jacobians, point blocks, the reduced
camera system and its Cholesky columns carry it, and each pair accepts or
rejects its own LM step with its own damping. One LM step launches as
many kernels for any number of pairs.

Fixed cameras and intrinsics are gauge-fixed by zeroing their Jacobian
columns; the two-view scale gauge is removed afterwards (||t|| = 1).

``bundle_adjust(..., group=...)`` is the JAX package's ``axis_name``:
each rank of a ``torch.distributed`` group holds a block of the points
and their observations, and every sum over points (the cost's numerator
and denominator, U, g_c, the Schur sum and the rhs sum) is all-reduced
over the group, at the JAX package's ``psum`` points. The reduced camera
system is then the same on every rank, and so is its solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from matchinglib_poselib_torch.config import BAConfig
from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.parallel import mesh as pmesh

# camera parameter block (local deltas around the current estimate):
#   [0:3]   so(3) rotation delta (right-multiplied: R <- R expm[w])
#   [3:6]   translation delta
#   [6:11]  intrinsics delta [fx fy cx cy skew]     (if refine_intrinsics)
#   [11:16] distortion delta [k1 k2 p1 p2 k3]       (if refine_intrinsics)
DOF_POSE = 6
DOF_FULL = 16


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues map so(3) -> SO(3), (..., 3) -> (..., 3, 3), with the
    Taylor guard at ||w|| -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    K = geo.skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _k_delta(K: torch.Tensor, dK: torch.Tensor) -> torch.Tensor:
    """K + the intrinsics delta dK (..., 5) = [fx fy cx cy skew]."""
    fx, fy, cx, cy, sk = dK.unbind(-1)
    z = torch.zeros_like(fx)
    return K + torch.stack([torch.stack([fx, sk, cx], dim=-1),
                            torch.stack([z, fy, cy], dim=-1),
                            torch.stack([z, z, z], dim=-1)], dim=-2)


def _apply_cam_delta(delta, R, t, K, dist, refine_intrinsics: bool):
    """Apply local parameter deltas (..., C, D) to cameras (..., C)."""
    Rn = R @ exp_so3(delta[..., 0:3])
    tn = t + delta[..., 3:6]
    if refine_intrinsics:
        return (Rn, tn, _k_delta(K, delta[..., 6:11]),
                dist + delta[..., 11:16])
    return Rn, tn, K, dist


def _project(X, R, t, K, dist):
    """Points (..., P, 3) -> pixels (..., P, C, 2) through cameras
    (..., C, ...), Oulu distortion included."""
    Xc = torch.einsum("...cij,...pj->...pci", R, X) + t[..., None, :, :]
    z = torch.where(torch.abs(Xc[..., 2]) > 1e-9, Xc[..., 2], 1e-9)
    xd = geo.distort_oulu(Xc[..., :2] / z[..., None], dist[..., None, :, :])
    Ko = K[..., None, :, :, :]
    u = Ko[..., 0, 0] * xd[..., 0] + Ko[..., 0, 1] * xd[..., 1] + Ko[..., 0, 2]
    v = Ko[..., 1, 1] * xd[..., 1] + Ko[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def _residual(dcam, dX, X, obs, R, t, K, dist, refine_intrinsics: bool):
    """(..., P, C, 2) reprojection residuals after the camera deltas dcam
    (..., C, D) and point deltas dX (..., P, 3)."""
    Rn, tn, Kn, distn = _apply_cam_delta(dcam, R, t, K, dist,
                                         refine_intrinsics)
    return _project(X + dX, Rn, tn, Kn, distn) - obs


def _jacobians(X, obs, R, t, K, dist, refine_intrinsics: bool):
    """Residuals (..., P, C, 2) and their Jacobians in the camera block
    (..., P, C, 2, D) and the point (..., P, C, 2, 3) at a zero delta
    (a leading pair axis optional): the derivatives of
    ``_residual`` (what the JAX package's ``jax.jacfwd`` takes per
    observation), by the chain rule through the pose, the perspective
    division (constant depth where it is clamped), the Oulu distortion
    and K."""
    Xc = torch.einsum("...cij,...pj->...pci", R, X) + t[..., None, :, :]
    zc = Xc[..., 2]
    front = torch.abs(zc) > 1e-9
    z = torch.where(front, zc, 1e-9)
    x, y = Xc[..., 0] / z, Xc[..., 1] / z
    k1, k2, p1, p2, k3 = (dist[..., None, :, i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    Ko = K[..., None, :, :, :]
    fx, s, cx = Ko[..., 0, 0], Ko[..., 0, 1], Ko[..., 0, 2]
    fy, cy = Ko[..., 1, 1], Ko[..., 1, 2]
    r = torch.stack([fx * xd + s * yd + cx, fy * yd + cy], dim=-1) - obs

    # d(xd, yd) / d(x, y)
    drad = 2.0 * (k1 + r2 * (2.0 * k2 + 3.0 * r2 * k3))  # d radial / d r2 * 2
    xy_t = 2.0 * p1 * x + 2.0 * p2 * y
    dxd_dx = radial + x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
    dxd_dy = x * y * drad + xy_t
    dyd_dx = x * y * drad + xy_t
    dyd_dy = radial + y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
    # d(u, v) / d(x, y) = [[fx, s], [0, fy]] @ d(xd, yd) / d(x, y)
    J_n = torch.stack([
        torch.stack([fx * dxd_dx + s * dyd_dx, fx * dxd_dy + s * dyd_dy],
                    dim=-1),
        torch.stack([fy * dyd_dx, fy * dyd_dy], dim=-1),
    ], dim=-2)  # (..., P, C, 2, 2)
    # d(x, y) / d Xc, with the depth held where it is clamped
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    D_n = torch.stack([
        torch.stack([inv_z, zero, torch.where(front, -x * inv_z, 0.0)],
                    dim=-1),
        torch.stack([zero, inv_z, torch.where(front, -y * inv_z, 0.0)],
                    dim=-1),
    ], dim=-2)  # (..., P, C, 2, 3)
    J_Xc = J_n @ D_n
    # Xc = R exp(w) (X + dX) + t + dt: d/dw = -R [X]x, d/dt = I, d/dX = R
    Ro = R[..., None, :, :, :]
    J_w = -J_Xc @ (Ro @ geo.skew(X)[..., :, None, :, :])
    J_x = J_Xc @ Ro
    blocks = [J_w, J_Xc]
    if refine_intrinsics:
        one, nul = torch.ones_like(xd), torch.zeros_like(xd)
        J_k = torch.stack([torch.stack([xd, nul, one, nul, yd], dim=-1),
                           torch.stack([nul, yd, nul, one, nul], dim=-1)],
                          dim=-2)
        # d(xd, yd) / d[k1 k2 p1 p2 k3]
        dxd = torch.stack([x * r2, x * r2 * r2, 2.0 * x * y,
                           r2 + 2.0 * x * x, x * r2 * r2 * r2], dim=-1)
        dyd = torch.stack([y * r2, y * r2 * r2, r2 + 2.0 * y * y,
                           2.0 * x * y, y * r2 * r2 * r2], dim=-1)
        J_d = torch.stack([fx[..., None] * dxd + s[..., None] * dyd,
                           fy[..., None] * dyd], dim=-2)
        blocks += [J_k, J_d]
    return r, torch.cat(blocks, dim=-1), J_x


class BAResult(NamedTuple):
    # each field carries the inputs' pair axis, if any, in front
    R: torch.Tensor  # (C, 3, 3)
    t: torch.Tensor  # (C, 3)
    K: torch.Tensor  # (C, 3, 3)
    dist: torch.Tensor  # (C, 5)
    points: torch.Tensor  # (P, 3)
    initial_cost: torch.Tensor  # mean robust cost before
    final_cost: torch.Tensor  # mean robust cost after
    n_iterations: torch.Tensor  # accepted LM steps


def _robust_weights(r2, delta2, robust: bool):
    """IRLS weight of the pseudo-Huber cost 2 b^2 (sqrt(1 + r^2/b^2) - 1):
    1 / sqrt(1 + r^2/b^2) (BA_driver.h cost choice)."""
    if not robust:
        return torch.ones_like(r2)
    return 1.0 / torch.sqrt(1.0 + r2 / delta2)


def _robust_cost(r2, delta2, robust: bool):
    if not robust:
        return r2
    return 2.0 * delta2 * (torch.sqrt(1.0 + r2 / delta2) - 1.0)


def _chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD systems A (..., n, n), b (..., n):
    Cholesky column by column, then the two triangular solves, each a
    loop of vector ops over every system at once."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    dot = torch.linalg.vecdot
    for j in range(n):
        s = A[..., j:, j] - dot(L[..., j:, :j], L[..., j, None, :j])
        d = torch.sqrt(torch.clamp(s[..., :1], min=1e-30))
        L[..., j:, j] = s / d
    y = torch.zeros_like(b)
    for i in range(n):
        y[..., i] = (b[..., i] - dot(L[..., i, :i], y[..., :i])) / L[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[..., i] = (y[..., i] - dot(L[..., i + 1:, i], x[..., i + 1:])
                     ) / L[..., i, i]
    return x


def _diag_floor(A: torch.Tensor) -> torch.Tensor:
    """diag(max(diag(A), 1)) for a batch of square blocks."""
    return torch.diag_embed(torch.clamp(
        torch.diagonal(A, dim1=-2, dim2=-1), min=1.0))


def bundle_adjust(
    obs: torch.Tensor,  # (P, C, 2) pixel observations
    vis: torch.Tensor,  # (P, C) visibility / validity mask
    R: torch.Tensor,  # (C, 3, 3)
    t: torch.Tensor,  # (C, 3)
    K: torch.Tensor,  # (C, 3, 3)
    dist: torch.Tensor,  # (C, 5)
    X: torch.Tensor,  # (P, 3) initial structure
    free_cams: torch.Tensor,  # (C,) 1 = camera pose is optimized
    iterations: int = 20,
    robust: bool = True,
    huber_delta=1.0,
    refine_intrinsics: bool = False,
    refine_structure: bool = True,
    refine_motion: bool = True,
    intrinsics_cols: tuple[int, ...] | None = None,
    group=None,
) -> BAResult:
    """Masked dense-block sparse BA (Schur-eliminated LM).

    Modes: BA_MOTSTRUCT = (refine_motion, refine_structure) = (True, True),
    BA_MOT = (True, False), BA_STRUCT = (False, True); BA_MOT_MOTSTRUCT
    also sets refine_intrinsics (BA_driver.h:69-82). intrinsics_cols: with
    refine_intrinsics, the free columns among 6..15 of the camera block
    (None: all), the reference's optimInternals subsets
    (pose_estim.cpp:1599-1617). huber_delta: a number or a tensor, shared
    or per pair. Pair axis: obs (Q, P, C, 2), vis (Q, P, C), R, t, K,
    dist (Q, C, ...), X (Q, P, 3) give every field of the result per
    pair; free_cams stays (C,).

    group: a ``torch.distributed`` process group over which the points
    are sharded (this rank's obs, vis and X are its block; the cameras
    are the same on every rank). Each sum over points is all-reduced
    over it (5 all-reduces per LM iteration, 2 for the initial cost),
    and the cameras come out the same on every rank; ``points`` stays
    this rank's block. None: no collective, the single-process result.
    """
    P, C = vis.shape[-2:]
    batch = vis.shape[:-2]
    D = DOF_FULL if refine_intrinsics else DOF_POSE
    dt, dev = obs.dtype, obs.device
    visf = vis.to(dt)
    if isinstance(huber_delta, torch.Tensor):
        delta2 = huber_delta.to(dt) ** 2
    else:
        delta2 = torch.full((), huber_delta ** 2, dtype=dt, device=dev)
    delta2 = delta2.expand(batch)[..., None, None]

    # free parameter columns per camera (C, D): pose columns follow
    # free_cams (gauge), intrinsic / distortion columns are free on every
    # camera (pose_estim.cpp:1585-1623)
    cam_free = free_cams.to(dt)[:, None]
    if not refine_motion:
        cam_free = cam_free * 0.0
    param_free = cam_free.expand(C, D)
    if refine_intrinsics:
        intr = torch.zeros(DOF_FULL - DOF_POSE, dtype=dt, device=dev)
        for i in range(DOF_POSE, DOF_FULL):
            if intrinsics_cols is None or i in intrinsics_cols:
                intr[i - DOF_POSE] = 1.0
        param_free = torch.cat(
            [param_free[:, :DOF_POSE],
             intr[None, :].expand(C, DOF_FULL - DOF_POSE)], dim=1)

    def allsum(x):
        """x summed over the group's ranks; x itself without a group."""
        return x if group is None else pmesh.all_reduce(x, group)

    n_vis = torch.clamp(allsum(torch.sum(visf, dim=(-2, -1))), min=1.0)

    def cost_at(Rc, tc, Kc, distc, Xc):
        r = _project(Xc, Rc, tc, Kc, distc) - obs
        c = _robust_cost(torch.sum(r * r, dim=-1), delta2, robust) * visf
        return allsum(torch.sum(c, dim=(-2, -1))) / n_vis

    def pick(accept, new, old):
        return torch.where(accept.reshape(accept.shape + (1,) * (
            new.ndim - accept.ndim)), new, old)

    eye_c = torch.eye(C, dtype=dt, device=dev)
    Rc, tc, Kc, distc, Xc = R, t, K, dist, X
    init_cost = cost_at(R, t, K, dist, X)
    cost = init_cost
    lam = torch.full(batch, 1e-3, dtype=dt, device=dev)
    n_acc = torch.zeros(batch, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        r, Jc, Jx = _jacobians(Xc, obs, Rc, tc, Kc, distc,
                               refine_intrinsics)
        w = _robust_weights(torch.sum(r * r, dim=-1), delta2, robust) * visf
        Jc = Jc * param_free[:, None, :]
        if not refine_structure:
            Jx = Jx * 0.0
        # normal-equation blocks, weighted by w. The three reductions
        # that torch.einsum would arrange otherwise for a single pair than
        # for a batch are products of matrices laid out once, so that each
        # pair's sums run in the same order for any number of pairs
        U = allsum(torch.einsum("...pcri,...pc,...pcrj->...cij", Jc, w, Jc))
        V = torch.einsum("...pcri,...pc,...pcrj->...pij", Jx, w, Jx)
        Wb = torch.einsum("...pcri,...pc,...pcrj->...pcij", Jc, w, Jx)
        rw = r * w[..., None]
        g_c = -allsum((Jc.transpose(-4, -3).reshape(batch + (C, P * 2, D))
                       .transpose(-1, -2)
                       @ rw.transpose(-3, -2).reshape(batch + (C, P * 2, 1)))[
                           ..., 0])
        g_x = -torch.einsum("...pcri,...pc,...pcr->...pi", Jx, w, r)
        # Marquardt damping lam * diag(max(diag, 1)): scale-invariant over
        # mixed-magnitude parameters, and fixed (zeroed) columns stay
        # positive definite
        lam_b = lam[..., None, None, None]
        Ud = U + lam_b * _diag_floor(U)
        # LU with partial pivoting, as the JAX package's jnp.linalg.inv: an
        # adjugate loses ill-conditioned point blocks (condition ~1e5) to
        # f32 cancellation, and the Schur complement then is not positive
        # definite. No error read: nothing waits on the host
        Vinv = torch.linalg.inv_ex(V + lam_b * _diag_floor(V))[0]
        # Schur complement S = blockdiag(Ud) - sum_p W_p V_p^-1 W_p^T: the
        # point sum is reduced over the group before Ud joins it
        WVi = torch.einsum("...pcij,...pjk->...pcik", Wb, Vinv)
        S_off = allsum(torch.einsum("...pcik,...pdlk->...cidl", WVi, Wb))
        S = (torch.einsum("cd,...cij->...cidj", eye_c, Ud) - S_off).reshape(
            batch + (C * D, C * D))
        nb = len(batch)
        WVi_u = WVi.permute(*range(nb), nb + 1, nb + 2, nb + 3, nb).reshape(
            batch + (C * D, 3 * P))  # (c i, k p)
        rhs = g_c.reshape(batch + (C * D,)) - allsum(
            (g_x.transpose(-1, -2).reshape(batch + (1, 3 * P))
             @ WVi_u.transpose(-1, -2))[..., 0, :])
        dcam = _chol_solve(S, rhs).reshape(batch + (C, D)) * param_free
        Wb_u = Wb.permute(*range(nb), nb, nb + 3, nb + 1, nb + 2).reshape(
            batch + (P * 3, C * D))  # (p j, c i)
        WtD = (dcam.reshape(batch + (1, C * D)) @ Wb_u.transpose(-1, -2))[
            ..., 0, :].reshape(batch + (P, 3))
        dX = torch.einsum("...pij,...pj->...pi", Vinv, g_x - WtD)
        if not refine_structure:
            dX = dX * 0.0
        Rn, tn, Kn, dn = _apply_cam_delta(dcam, Rc, tc, Kc, distc,
                                          refine_intrinsics)
        Xn = Xc + dX
        new_cost = cost_at(Rn, tn, Kn, dn, Xn)
        # each pair accepts or rejects its own step
        accept = new_cost < cost
        lam = torch.clamp(torch.where(accept, lam * 0.33, lam * 4.0),
                          1e-10, 1e6)
        Rc, tc, Kc = pick(accept, Rn, Rc), pick(accept, tn, tc), pick(
            accept, Kn, Kc)
        distc, Xc = pick(accept, dn, distc), pick(accept, Xn, Xc)
        cost = torch.minimum(new_cost, cost)
        n_acc = n_acc + accept.to(torch.int32)
    return BAResult(R=Rc, t=tc, K=Kc, dist=distc, points=Xc,
                    initial_cost=init_cost, final_cost=cost,
                    n_iterations=n_acc)


# ---------------------------------------------------------------------------
# the reference's entry points
# ---------------------------------------------------------------------------


class StereoBAResult(NamedTuple):
    # each field carries the inputs' pair axis, if any, in front
    R: torch.Tensor  # (3, 3) refined (or restored) relative rotation
    t: torch.Tensor  # (3,) unit translation
    K1: torch.Tensor
    K2: torch.Tensor
    points: torch.Tensor  # (P, 3)
    restored: torch.Tensor  # bool: the guards rejected the BA update
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def refine_stereo_ba(
    R: torch.Tensor,
    t: torch.Tensor,
    x1: torch.Tensor,  # (P, 2) coords in camera 1
    x2: torch.Tensor,  # (P, 2) coords in camera 2
    X: torch.Tensor,  # (P, 3) triangulated points (camera-1 frame)
    mask: torch.Tensor,  # (P,) valid-observation mask
    K1: torch.Tensor,
    K2: torch.Tensor,
    cfg: BAConfig = BAConfig(),
    dist1: torch.Tensor | None = None,
    dist2: torch.Tensor | None = None,
    huber_delta=None,
) -> StereoBAResult:
    """Two-view BA with cam0 fixed at the origin, then the restore guards
    of refineStereoBA: the input pose comes back if the rotation moved by
    more than cfg.angle_thresh_deg, ||t|| by more than cfg.t_norm_thresh,
    or the cost did not drop. huber_delta overrides cfg.huber_delta (for
    observations in normalized rather than pixel units). Pair axis: R
    (Q, 3, 3), t (Q, 3), x1, x2 (Q, P, 2), X (Q, P, 3) and mask (Q, P)
    with shared K1, K2, dist1, dist2 (and huber_delta shared or (Q,)) run
    the Q problems in one LM loop, each restored on its own."""
    dt, dev = x1.dtype, x1.device
    batch = x1.shape[:-2]
    zeros5 = torch.zeros(5, dtype=dt, device=dev)
    dist1 = zeros5 if dist1 is None else dist1
    dist2 = zeros5 if dist2 is None else dist2
    t_unit = geo.normalize_vec(t)

    def cams(a, b):
        """Cameras 0 (a, shared) and 1 (b, shared or per pair) on the
        camera axis of every pair."""
        b = b.expand(batch + a.shape)
        return torch.stack([a.expand(b.shape), b], dim=len(batch))

    res = bundle_adjust(
        torch.stack([x1, x2], dim=-2), torch.stack([mask, mask], dim=-1),
        cams(torch.eye(3, dtype=dt, device=dev), R),
        cams(torch.zeros(3, dtype=dt, device=dev), t_unit),
        cams(K1.to(dt), K2.to(dt)), cams(dist1.to(dt), dist2.to(dt)),
        X, torch.arange(2, device=dev).to(dt),
        iterations=cfg.iterations, robust=cfg.robust,
        huber_delta=cfg.huber_delta if huber_delta is None else huber_delta,
        refine_intrinsics=not cfg.fix_intrinsics,
    )
    R_new, t_new = res.R[..., 1, :, :], res.t[..., 1, :]
    rdiff, _, _ = geo.compare_poses(R, t_unit, R_new, t_new)
    t_norm = torch.linalg.norm(t_new, dim=-1)
    dtn = torch.abs(t_norm - 1.0)
    restore = ((rdiff > cfg.angle_thresh_deg) | (dtn > cfg.t_norm_thresh)
               | (res.final_cost >= res.initial_cost))
    scale = torch.clamp(t_norm, min=1e-12)
    r2, r1 = restore[..., None, None], restore[..., None]
    return StereoBAResult(
        R=torch.where(r2, R, R_new),
        t=torch.where(r1, t_unit, t_new / scale[..., None]),
        K1=res.K[..., 0, :, :], K2=res.K[..., 1, :, :],
        points=torch.where(r2, X, res.points / scale[..., None, None]),
        restored=restore,
        initial_cost=res.initial_cost, final_cost=res.final_cost,
    )


# the reference's optimInternals codes (pose_estim.cpp:1599-1617) as free
# intrinsic / distortion columns of the camera block
_INTRINSICS_MODES: dict[str, tuple[int, ...] | None] = {
    "none": None,
    "all": tuple(range(6, 16)),  # optimInternals = 2 (+ dists when given)
    "focal": (6, 7),  # optimInternals = 4 (optimFocalOnly)
    "dist": tuple(range(11, 16)),  # optimInternals = 5 (fixCamMat + dists)
}


def refine_multi_cam_ba(
    obs: torch.Tensor,  # (P, C, 2)
    vis: torch.Tensor,  # (P, C)
    R: torch.Tensor,  # (C, 3, 3)
    t: torch.Tensor,  # (C, 3)
    K: torch.Tensor,  # (C, 3, 3)
    X: torch.Tensor,  # (P, 3)
    iterations: int = 20,
    robust: bool = True,
    refine_intrinsics: bool = False,
    angle_thresh_deg: float = 1.25,
    t_norm_thresh: float = 0.05,
    dist: torch.Tensor | None = None,  # (C, 5) [k1 k2 p1 p2 k3]
    intrinsics_mode: str = "all",
    motion_only: bool = False,
    huber_delta: float = 1.0,
):
    """Multi-camera windowed BA with cam0 fixed (refineMultCamBA,
    pose_estim.cpp:1384-1735).

    - distortion is refined with the intrinsics only when ``dist`` is
      given; ``intrinsics_mode`` picks the optimInternals subset "all"
      (2), "focal" (4), "dist" (5) or "none";
    - ``motion_only`` is BA_MOT: structure held and not written back;
    - restore is all or nothing: if any camera moved beyond the guards
      (relaxed by the relative focal change when focals were refined:
      t-norm by min(1.5 min(f_rel, 2), 2), angle by max(1, 0.9 min(f_rel,
      2))), or the cost did not drop, everything is restored;
    - the translation guard compares the normalized old and new t.

    Returns (BAResult with the refined or restored parameters, restored
    flag (C,): all True or all False, cam0 always False).
    """
    C = R.shape[0]
    dt, dev = obs.dtype, obs.device
    have_dist = dist is not None
    if dist is None:
        dist = torch.zeros((C, 5), dtype=dt, device=dev)
    mode = intrinsics_mode if refine_intrinsics else "none"
    if mode != "none" and not have_dist and mode != "focal":
        # without distortion inputs only K moves (the reference refines
        # dists only when they are given)
        cols: tuple[int, ...] | None = tuple(range(6, 11))
    else:
        cols = _INTRINSICS_MODES[mode]
    free = torch.ones(C, dtype=dt, device=dev)
    free[0] = 0.0
    res = bundle_adjust(
        obs, vis, R, t, K, dist, X, free,
        iterations=iterations, robust=robust, huber_delta=huber_delta,
        refine_intrinsics=mode != "none", refine_structure=not motion_only,
        intrinsics_cols=cols,
    )
    rdiff, _, _ = geo.compare_poses(R, t, res.R, res.t)  # (C,) degrees
    t_diff = torch.linalg.norm(geo.normalize_vec(res.t)
                               - geo.normalize_vec(t), dim=-1)
    if mode in ("all", "focal"):
        f_new, f_old = res.K[:, 0, 0], K[:, 0, 0]
        f_rel = torch.maximum(f_new, f_old) / torch.clamp(
            torch.minimum(f_new, f_old), min=1e-9)
        tf = torch.clamp(1.5 * torch.clamp(f_rel, max=2.0), max=2.0)
        rf = torch.clamp(0.9 * torch.clamp(f_rel, max=2.0), min=1.0)
    else:
        tf = rf = torch.ones(C, dtype=dt, device=dev)
    bad = (torch.abs(rdiff) > rf * angle_thresh_deg) | (
        t_diff > tf * t_norm_thresh)
    bad[0] = False
    failed = torch.any(bad) | (res.final_cost >= res.initial_cost)
    restore = failed.expand(C).clone()
    restore[0] = False
    return (
        res._replace(
            R=torch.where(failed, R, res.R),
            t=torch.where(failed, t, res.t),
            K=torch.where(failed, K, res.K),
            dist=torch.where(failed, dist, res.dist),
            points=X if motion_only else torch.where(failed, X, res.points),
        ),
        restore,
    )
