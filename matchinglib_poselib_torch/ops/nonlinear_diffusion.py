"""KAZE/AKAZE: nonlinear-diffusion scale space, Hessian detection, and the
M-SURF / MLDB descriptors (port of ``ops/nonlinear_diffusion.py``).

- Detection (features.cpp:812-815 'KAZE' / 'AKAZE'): a Perona-Malik scale
  space built by explicit diffusion steps (6 per level, each split into
  sub-steps of tau <= 0.22: 186 steps in all), every step with its own
  sigma = 1 blur and Sobel; then the scale-normalized Hessian determinant
  on each level and 3x3x3 extrema across adjacent levels.
- M-SURF (the SURF and KAZE descriptor rows): a 4x4 grid of (sum dx, sum
  |dx|, sum dy, sum |dy|) over gradients rotated into the keypoint frame,
  Gaussian weighted, L2-normalized -> (K, 64) float32.
- MLDB (AKAZE): grid means of (intensity, dx, dy) over 2x2, 3x3 and 4x4
  cells compared pairwise, 486 bits padded to 512 -> (K, 16) int32 words.

Every step is plain PyTorch on the inputs' device (on the card about
10^4 small kernels per image for the scale space).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from matchinglib_poselib_torch.ops import features as feat
from matchinglib_poselib_torch.ops import scale_space as S
from matchinglib_poselib_torch.ops.features import pack_bits, scatter_rows


# ---------------------------------------------------------------------------
# nonlinear (Perona-Malik) scale space via explicit diffusion steps
# ---------------------------------------------------------------------------


def _pm_g2(gx: torch.Tensor, gy: torch.Tensor, k: torch.Tensor):
    """Perona-Malik g2 conductivity 1 / (1 + |grad|^2 / k^2)."""
    return 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))


def _edge_shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with edge replication (zero flux at the border)."""
    H, W = x.shape
    p = F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def _diffusion_step(L: torch.Tensor, c: torch.Tensor, tau: float):
    """One explicit step of div(c grad L): 4-neighbour fluxes with the
    faces' averaged conductivity, edge-replicated shifts."""
    sh = _edge_shift
    cE = 0.5 * (c + sh(c, 0, -1))
    cW = 0.5 * (c + sh(c, 0, 1))
    cS = 0.5 * (c + sh(c, -1, 0))
    cN = 0.5 * (c + sh(c, 1, 0))
    upd = (cE * (sh(L, 0, -1) - L) + cW * (sh(L, 0, 1) - L)
           + cS * (sh(L, -1, 0) - L) + cN * (sh(L, 1, 0) - L))
    return L + tau * upd


def _kcontrast(img: torch.Tensor, percentile: float = 0.7) -> torch.Tensor:
    """Contrast factor k: the `percentile` of the significant gradient
    magnitudes (> 1% of the largest) of the sigma = 1 smoothed image, with
    the /8-normalized Sobel of the diffusion loop. The rank is taken in
    f32, as the JAX package's weakly typed ``percentile * (n_valid - 1)``
    is (the floor can differ in f64)."""
    g = S.gaussian_blur(img, 1.0)
    gx, gy = feat.sobel(g)
    mag = (torch.sqrt(gx * gx + gy * gy) / 8.0).reshape(-1)
    valid = mag > 0.01 * torch.amax(mag)
    n_valid = torch.clamp(torch.sum(valid.to(torch.int32)), min=1)
    srt = torch.sort(torch.where(valid, mag, torch.inf)).values
    rank = torch.tensor(percentile, dtype=torch.float32, device=img.device) \
        * (n_valid - 1).to(torch.float32)
    idx = torch.clamp(rank.to(torch.int64), 0, mag.shape[0] - 1)
    return torch.clamp(srt[idx], min=1e-4)


_EVOLUTION_TIMES = (1.2, 2.4, 4.8, 9.6, 19.2, 38.4)  # diffusion times
_STEPS_PER_LEVEL = 6  # explicit steps between levels


def nonlinear_scale_space(img: torch.Tensor):
    """The evolution levels L_i: a list of (L, sigma_eff)."""
    k = _kcontrast(img)
    L = S.gaussian_blur(img, 1.0)
    levels = [(L, 1.0)]
    t_prev = 0.5  # t = sigma^2 / 2 for sigma = 1
    for t in _EVOLUTION_TIMES:
        tau = (t - t_prev) / _STEPS_PER_LEVEL
        # explicit diffusion is stable for tau <= 0.25: split further
        n_sub = max(1, int(np.ceil(tau / 0.22)))
        tau_s = tau / n_sub
        for _ in range(_STEPS_PER_LEVEL * n_sub):
            gx, gy = feat.sobel(S.gaussian_blur(L, 1.0))
            c = _pm_g2(gx / 8.0, gy / 8.0, k)
            L = _diffusion_step(L, c, tau_s)
        levels.append((L, float(np.sqrt(2.0 * t))))
        t_prev = t
    return levels


def kaze_keypoints(img: torch.Tensor, max_keypoints: int,
                   grid_cells: int = 0) -> feat.Keypoints:
    """KAZE/AKAZE detector: sigma^4-normalized Hessian determinant of each
    level blurred at its own sigma, extrema across adjacent levels."""
    levels = nonlinear_scale_space(img)
    dets = []
    for L, sigma in levels:
        G = S.gaussian_blur(L, sigma)
        dxx = S._roll(G, 0, 1) + S._roll(G, 0, -1) - 2 * G
        dyy = S._roll(G, 1, 0) + S._roll(G, -1, 0) - 2 * G
        dxy = 0.25 * (S._roll(G, 1, 1) + S._roll(G, -1, -1)
                      - S._roll(G, 1, -1) - S._roll(G, -1, 1))
        dets.append((sigma**2) ** 2 * (dxx * dyy - dxy * dxy))
    maps = torch.stack(dets)
    mx = S._win_max(maps)
    out = []
    per_level_k = max(32, max_keypoints // max(1, len(levels) - 2))
    for i in range(1, len(levels) - 1):
        c = maps[i]
        ok = (c >= mx[i - 1]) & (c >= mx[i + 1]) & (c >= mx[i]) & (c > 1e-8)
        out.append(S._select_level(torch.where(ok, c, 0.0), per_level_k, 1.0,
                                   float(levels[i][1]), border=16,
                                   grid_cells=grid_cells))
    return S._merge_levels(out, max_keypoints)


# ---------------------------------------------------------------------------
# M-SURF descriptor (KAZE float, 64-d)
# ---------------------------------------------------------------------------


def msurf_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                     oriented: bool = True) -> torch.Tensor:
    """M-SURF 64-d: 4x4 grid of (sum dx, sum |dx|, sum dy, sum |dy|).

    patches: (K, P, P). Cells use hard assignment (truncation toward zero,
    as ``astype(int32)``); the per-cell sums are a scatter-add in a fixed
    order where the JAX package contracts a one-hot tensor.
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = torch.zeros_like(angles)
    gx = 0.5 * (torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2))
    gy = 0.5 * (torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1))
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    rx = ca * gx + sa * gy  # gradient in the keypoint frame
    ry = -sa * gx + ca * gy

    c = (P - 1) / 2.0
    ys = (torch.arange(P, dtype=torch.float32, device=patches.device) - c) / c
    yy, xx = torch.meshgrid(ys, ys, indexing="ij")
    # coords into the keypoint frame: rotate by -angle
    xr = ca * xx[None] + sa * yy[None]
    yr = -sa * xx[None] + ca * yy[None]
    w = torch.exp(-(xx**2 + yy**2) / (2 * 0.55**2))[None]
    bx = torch.clamp(((xr + 1.0) * 2.0).to(torch.int32), 0, 3)
    by = torch.clamp(((yr + 1.0) * 2.0).to(torch.int32), 0, 3)
    cell = by * 4 + bx
    feats = torch.stack(
        [rx, torch.abs(rx), ry, torch.abs(ry)], dim=-1
    ).reshape(K, -1, 4) * w.reshape(1, -1, 1)
    desc = scatter_rows(cell.reshape(K, -1), feats, 16).reshape(K, 64)
    return desc / torch.clamp(
        torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-9)



# ---------------------------------------------------------------------------
# MLDB descriptor (AKAZE binary, 486 bits -> 16 words)
# ---------------------------------------------------------------------------


def _grid_cell_ids(P: int, g: int) -> np.ndarray:
    idx = np.minimum((np.arange(P) * g) // P, g - 1)
    return (idx[:, None] * g + idx[None, :]).astype(np.int32)  # (P, P)


def mldb_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                    oriented: bool = True) -> torch.Tensor:
    """AKAZE MLDB: per-cell means of (L, dx, dy) over 2x2 / 3x3 / 4x4 grids
    in the keypoint frame, all pairs within a grid compared per channel:
    3 (6 + 36 + 120) = 486 bits, zero-padded to 512 -> (K, 16) int32.
    Cells truncate rotated coordinates toward zero (``astype(int32)``);
    the per-cell sums are a scatter-add in a fixed order where the JAX
    package contracts a one-hot tensor."""
    K, P, _ = patches.shape
    if not oriented:
        angles = torch.zeros_like(angles)
    gx = 0.5 * (torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2))
    gy = 0.5 * (torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1))
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    rx = ca * gx + sa * gy
    ry = -sa * gx + ca * gy
    chans = torch.stack([patches, rx, ry], dim=-1).reshape(K, -1, 3)

    c = (P - 1) / 2.0
    ys = (torch.arange(P, dtype=torch.float32, device=patches.device) - c) / c
    yy, xx = torch.meshgrid(ys, ys, indexing="ij")
    xr = ca * xx[None] + sa * yy[None]
    yr = -sa * xx[None] + ca * yy[None]
    inside = ((torch.abs(xr) <= 1.0) & (torch.abs(yr) <= 1.0)).reshape(K, -1)
    ones = torch.ones((K, P * P, 1), dtype=patches.dtype,
                      device=patches.device)
    bits = []
    for g in (2, 3, 4):
        bxi = torch.clamp(((xr + 1.0) * 0.5 * g).to(torch.int32), 0, g - 1)
        byi = torch.clamp(((yr + 1.0) * 0.5 * g).to(torch.int32), 0, g - 1)
        n_cells = g * g
        # pixels outside the unit square go to a spill bin n_cells
        cell = torch.where(inside, (byi * g + bxi).reshape(K, -1), n_cells)
        sums = scatter_rows(cell, chans, n_cells + 1)[:, :n_cells]
        cnt = scatter_rows(cell, ones, n_cells + 1)[:, :n_cells, 0]
        means = sums / torch.clamp(cnt, min=1.0)[..., None]
        iu, ju = np.triu_indices(n_cells, k=1)
        cmp = means[:, iu, :] > means[:, ju, :]
        bits.append(cmp.reshape(K, -1))
    allbits = torch.cat(bits, dim=1)
    pad = torch.zeros((K, 512 - allbits.shape[1]), dtype=torch.bool,
                      device=patches.device)
    return pack_bits(torch.cat([allbits, pad], dim=1))
