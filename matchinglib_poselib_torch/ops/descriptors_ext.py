"""Extended descriptor family: ring-pattern binary, RIFF, BOLD (port of
``ops/descriptors_ext.py``).

- ``ring_pattern_descriptor``: concentric-ring sampling with
  short-distance pairwise comparisons, the BRISK / FREAK rows
  (features.cpp:849-971): 512 bits from smoothed ring samples -> (K, 16)
  int32 words; FREAK's layout is the log-spaced ring variant.
- ``riff_descriptor``: the retina-inspired float descriptor
  (descriptor-RIFF/riff.cpp:20-53): per ring x sector cell the mean
  intensity and radial-gradient energy in the keypoint frame -> (K, 128)
  float32.
- ``bold_descriptor`` / ``bold_distance_matrix`` / ``match_bold``: BOLD
  (descriptor-BOLD/bold.cpp:146): per-patch bit stability masks from
  rotated re-tests, matched by the two-way masked Hamming distance, one
  dense product of signed / masked embeddings. Its operands are small
  integers, so the fp32 product (TF32 off) is exact.

The pattern tables come from the JAX package's numpy code and seeds (a
copy here: the port imports nothing of the JAX package). The samplers
run on the extracted (K, P, P) patches: bilinear gathers batched over
keypoints.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from matchinglib_poselib_torch.ops.features import pack_bits
from matchinglib_poselib_torch.ops.geometry import topk_stable
from matchinglib_poselib_torch.ops.matching import MatchResult


# ---------------------------------------------------------------------------
# ring sampling pattern (BRISK / FREAK class)
# ---------------------------------------------------------------------------


@functools.lru_cache()
def ring_pattern(n_rings: int = 5, log_spacing: bool = False):
    """Sampling points on concentric rings (unit-radius patch frame), their
    smoothing sigmas, and the 512 shortest-distance point pairs (BRISK's
    comparison rule): (pts (n, 2) f32, sigmas (n,) f32, pairs (512, 2))."""
    rng = np.random.default_rng(7)
    pts = [(0.0, 0.0)]
    sigmas = [0.05]
    for r in range(1, n_rings + 1):
        if log_spacing:  # FREAK-like retinal layout
            rad = 0.95 * (np.exp(r / n_rings * 1.1) - 1.0) / (np.e**1.1 - 1.0)
        else:  # BRISK-like linear rings
            rad = 0.95 * r / n_rings
        n_pts = 6 + 4 * r
        phase = rng.uniform(0, 2 * np.pi)
        for i in range(n_pts):
            a = phase + 2 * np.pi * i / n_pts
            pts.append((rad * np.cos(a), rad * np.sin(a)))
            sigmas.append(0.03 + 0.12 * rad)
    pts = np.asarray(pts, np.float32)
    sigmas = np.asarray(sigmas, np.float32)
    n = len(pts)
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            d = float(np.hypot(*(pts[i] - pts[j])))
            pairs.append((d, i, j))
    pairs.sort()
    sel = np.asarray([(i, j) for _, i, j in pairs[:512]], np.int32)
    return pts, sigmas, sel


# the 5-tap binomial kernel as the JAX package's f32 array / 16.0
_BINOMIAL = tuple(float(v) for v in
                  np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
                  / np.float32(16.0))


def _smooth_patches(patches: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur of each patch, wrapping at the patch border
    (``jnp.roll``), rows then columns."""
    def conv(x, dim):
        out = torch.zeros_like(x)
        for i, ki in enumerate(_BINOMIAL):
            out = out + ki * torch.roll(x, i - 2, dims=dim)
        return out

    return conv(conv(patches, 1), 2)


def _sample_pattern(patches: torch.Tensor, angles: torch.Tensor,
                    pts: torch.Tensor, oriented: bool) -> torch.Tensor:
    """(K, P, P) patches, pattern points (n, 2) in [-1, 1] -> (K, n)
    bilinear samples in the keypoint frame."""
    K, P, _ = patches.shape
    c = (P - 1) / 2.0
    if not oriented:
        angles = torch.zeros_like(angles)
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    px = pts[:, 0][None, :] * c
    py = pts[:, 1][None, :] * c
    gx = torch.clamp(c + ca * px - sa * py, 0.0, P - 1.001)
    gy = torch.clamp(c + sa * px + ca * py, 0.0, P - 1.001)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    fx = gx - x0
    fy = gy - y0
    flat = patches.reshape(K, P * P)

    def tk(yy, xx):
        return torch.gather(flat, 1, yy * P + xx)

    return (tk(y0, x0) * (1 - fy) * (1 - fx)
            + tk(y0, x0 + 1) * (1 - fy) * fx
            + tk(y0 + 1, x0) * fy * (1 - fx)
            + tk(y0 + 1, x0 + 1) * fy * fx)


def _pattern_tensors(device, log_spacing: bool = False):
    pts, _, sel = ring_pattern(log_spacing=log_spacing)
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(sel.astype(np.int64)).to(device))


def _ring_bits(samples: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return samples[:, sel[:, 0]] < samples[:, sel[:, 1]]


def ring_pattern_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                            oriented: bool = True,
                            log_spacing: bool = False) -> torch.Tensor:
    """BRISK / FREAK-class 512-bit ring descriptor -> (K, 16) int32."""
    pts, sel = _pattern_tensors(patches.device, log_spacing)
    samples = _sample_pattern(_smooth_patches(patches), angles, pts,
                              oriented)
    return pack_bits(_ring_bits(samples, sel))


# ---------------------------------------------------------------------------
# RIFF: retina-inspired float descriptor
# ---------------------------------------------------------------------------


def riff_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                    oriented: bool = True) -> torch.Tensor:
    """(K, 128) float32 retina descriptor: 8 rings x 8 sectors in the
    keypoint frame, each cell's (mean intensity, mean radial-gradient
    energy), mean-centred, L2-normalized with Lowe-style clamping at 0.3.
    The sector of a pixel comes from ``atan2`` of its rotated coordinates
    (truncated toward zero, as ``astype(int32)``); the cell sums are a
    scatter-add in a fixed order where the JAX package contracts a one-hot
    tensor."""
    from matchinglib_poselib_torch.ops.features import scatter_rows

    K, P, _ = patches.shape
    dev = patches.device
    if not oriented:
        angles = torch.zeros_like(angles)
    c = (P - 1) / 2.0
    ys = (torch.arange(P, dtype=torch.float32, device=dev) - c) / c
    yy, xx = torch.meshgrid(ys, ys, indexing="ij")
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    rx = ca * xx[None] + sa * yy[None]
    ry = -sa * xx[None] + ca * yy[None]
    rad = torch.sqrt(rx * rx + ry * ry)
    theta = torch.atan2(ry, rx)

    n_rings, n_sect = 8, 8
    ring_idx = torch.clamp((rad * n_rings).to(torch.int32), 0, n_rings - 1)
    sect_idx = ((theta + math.pi) / (2 * math.pi) * n_sect).to(
        torch.int32) % n_sect
    n_cells = n_rings * n_sect
    # pixels outside the unit disc go to a spill cell n_cells
    cell = torch.where(rad <= 1.0, ring_idx * n_sect + sect_idx, n_cells)

    gx = 0.5 * (torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2))
    gy = 0.5 * (torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1))
    ur = torch.where(rad > 1e-6, rx / torch.clamp(rad, min=1e-6), 0.0)
    vr = torch.where(rad > 1e-6, ry / torch.clamp(rad, min=1e-6), 0.0)
    gr = torch.abs(gx * (ca * ur - sa * vr) + gy * (sa * ur + ca * vr))

    vals = torch.stack([torch.ones_like(patches), patches, gr],
                       dim=-1).reshape(K, P * P, 3)
    sums = scatter_rows(cell.reshape(K, -1), vals, n_cells + 1)[:, :n_cells]
    counts = torch.clamp(sums[..., 0], min=1.0)
    desc = torch.cat([sums[..., 1] / counts, sums[..., 2] / counts], dim=1)
    desc = desc - torch.mean(desc, dim=1, keepdim=True)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True),
                              min=1e-6)
    desc = torch.clamp(desc, max=0.3)
    return desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True),
                              min=1e-6)


# ---------------------------------------------------------------------------
# BOLD: binary online-learned descriptor with per-patch masks
# ---------------------------------------------------------------------------

# 15 deg in f32 as the JAX package's deg2rad of an f32 15.0 takes it
_BOLD_ROT = float(np.float32(15.0) * np.float32(np.pi / 180))


def bold_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                    oriented: bool = True):
    """(bits (K, 16) int32, mask (K, 16) int32): the ring test at the
    keypoint's angle and re-tested 15 deg either side; a bit is kept in
    the mask only where all three views agree. The three views always
    sample oriented, at 0 and +-15 deg when `oriented` is off (the JAX
    package's closure reads the zeroed angles)."""
    pts, sel = _pattern_tensors(patches.device)
    smoothed = _smooth_patches(patches)
    if not oriented:
        angles = torch.zeros_like(angles)

    def bits_at(extra):
        s = _sample_pattern(smoothed, angles + extra, pts, True)
        return _ring_bits(s, sel)

    b0 = bits_at(0.0)
    bp = bits_at(_BOLD_ROT)
    bm = bits_at(-_BOLD_ROT)
    stable = (b0 == bp) & (b0 == bm)
    return pack_bits(b0), pack_bits(stable)


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words -> (N, 32 W) {0, 1} float32, bit i of word w at
    32 w + i."""
    n, w = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.to(torch.float32).reshape(n, w * 32)


def _signed_masked(bits: torch.Tensor, mask: torch.Tensor):
    signs = _unpack_bits(bits) * 2.0 - 1.0
    m = _unpack_bits(mask)
    return signs * m, torch.sum(m, dim=1), signs


def bold_distance_matrix(bits1: torch.Tensor, mask1: torch.Tensor,
                         bits2: torch.Tensor,
                         mask2: torch.Tensor) -> torch.Tensor:
    """Two-way masked Hamming: d(a, b) = ham(a, b | mask_a) + ham(a, b |
    mask_b) (bold.cpp's matching rule), as one product u . v / 2 of the
    embeddings u = [-s_a m_a, -s_a, sum m_a, 1], v = [s_b, s_b m_b, 1, sum
    m_b] (s in {-1, +1}, m in {0, 1}). Every partial sum is an integer of
    magnitude <= 2048, so the fp32 product is exact in any order."""
    sm1, c1, s1 = _signed_masked(bits1, mask1)
    sm2, c2, s2 = _signed_masked(bits2, mask2)
    u = torch.cat([-sm1, -s1, c1[:, None], torch.ones_like(c1)[:, None]],
                  dim=1)
    v = torch.cat([s2, sm2, torch.ones_like(c2)[:, None], c2[:, None]],
                  dim=1)
    return 0.5 * (u @ v.T)


def match_bold(bits1, mask1, bits2, mask2, valid1, valid2,
               ratio_test: bool = True, ratio: float = 0.8,
               cross_check: bool = True) -> MatchResult:
    """2-NN + ratio test + cross-check over the masked BOLD distance.
    Distances are integers, so ties are common: the top-2 puts the lowest
    column first (``lax.top_k``), the cross-check takes the first
    minimum of each column (``argmin``)."""
    dist = bold_distance_matrix(bits1, mask1, bits2, mask2)
    big = 1e9
    v1 = valid1.to(torch.bool)
    v2 = valid2.to(torch.bool)
    dist = torch.where(v2[None, :], dist, big)
    dist = torch.where(v1[:, None], dist, big)
    neg, idx = topk_stable(-dist, 2)
    d_best, d_second = -neg[:, 0], -neg[:, 1]
    keep = v1 & (d_best < big * 0.5)
    if ratio_test:
        keep = keep & (d_best < ratio * d_second)
    if cross_check:
        col_best = torch.argmin(dist, dim=0)
        keep = keep & (col_best[idx[:, 0]]
                       == torch.arange(dist.shape[0], device=dist.device))
    return MatchResult(idx=idx[:, 0].to(torch.int32), distance=d_best,
                       second_distance=d_second, mask=keep)
