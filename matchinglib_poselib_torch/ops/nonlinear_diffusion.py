"""KAZE's M-SURF descriptor (port of ``ops/nonlinear_diffusion.py``,
``msurf_descriptor`` only).

The SURF and KAZE descriptor rows: a 4x4 grid of (sum dx, sum |dx|, sum
dy, sum |dy|) over gradients rotated into the keypoint frame, Gaussian
weighted, L2-normalized -> (K, 64) float32. KAZE/AKAZE detection (the
nonlinear scale space) and the MLDB descriptor are not ported yet.
"""

from __future__ import annotations

import torch

from matchinglib_poselib_torch.ops.features import scatter_rows


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
