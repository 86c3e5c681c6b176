"""Learned-family descriptors: LATCH, BoostDesc (BGM, LBGM, BINBOOST), VGG,
and the DAISY and SURF-64 float descriptors (port of
``ops/descriptors_learned.py``).

The reference's xfeatures2d rows (features.cpp:849-971) ship trained
tables; the JAX package keeps each descriptor's structure, width and
metric and draws its selection tables and projections from fixed numpy
seeds. The port keeps its own copy of that numpy code, so both packages
build the same tables. The weak-learner and pooling contractions of
BoostDesc and VGG take bf16-rounded operands with f32 accumulation, as
the JAX package's einsums do: both operands are rounded to bf16 here and
multiplied in fp32 (TF32 off), so every product is exact and only the
order of the sums differs.

All functions take (K, P, P) extracted patches and per-keypoint angles.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from matchinglib_poselib_torch.ops.features import pack_bits
from matchinglib_poselib_torch.ops.geometry import floor_mod
from matchinglib_poselib_torch.ops.scale_space import conv_sep_zero


def _rotated_grads(patches: torch.Tensor, angles: torch.Tensor):
    """Central-difference gradients rotated into the keypoint frame."""
    gx = 0.5 * (torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2))
    gy = 0.5 * (torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1))
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    return ca * gx + sa * gy, -sa * gx + ca * gy


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _f32(x) -> float:
    """A numpy scalar or array as the JAX package casts it (f32)."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# LATCH: learned arrangements of three patch codes
# ---------------------------------------------------------------------------

_LATCH_BITS = 256
_LATCH_HALF_SSD = 3  # mini-patch radius (7x7 windows)


@functools.lru_cache(maxsize=None)
def latch_triplets(patch: int, seed: int = 11) -> np.ndarray:
    """(bits, 3, 2) anchor / positive / negative mini-patch centres as
    (dx, dy)."""
    rng = np.random.default_rng(seed)
    r = patch // 2 - _LATCH_HALF_SSD - 1
    return rng.uniform(-r, r, size=(_LATCH_BITS, 3, 2)).astype(np.float32)


def latch_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                     oriented: bool = True) -> torch.Tensor:
    """LATCH-256: bit = the positive mini-patch's moment distance to the
    anchor below the negative's (the JAX package's documented moment
    approximation of the SSD). 7x7 window sums are zero-padded separable
    box sums ("SAME" convolutions there); the three centres are rotated by
    the keypoint angle and rounded (half to even) -> (K, 8) int32."""
    K, P, _ = patches.shape
    if not oriented:
        angles = torch.zeros_like(angles)
    trip = torch.from_numpy(latch_triplets(P)).to(patches.device)
    c = (P - 1) / 2.0
    ca, sa = torch.cos(angles), torch.sin(angles)
    px = trip[None, :, :, 0]
    py = trip[None, :, :, 1]
    gx = c + ca[:, None, None] * px - sa[:, None, None] * py
    gy = c + sa[:, None, None] * px + ca[:, None, None] * py

    w = 2 * _LATCH_HALF_SSD + 1
    ones = np.ones((w,), np.float32)
    box = conv_sep_zero(patches, ones)
    box2 = conv_sep_zero(patches * patches, ones)

    xi = torch.clamp(torch.round(gx), 0, P - 1).to(torch.int64)
    yi = torch.clamp(torch.round(gy), 0, P - 1).to(torch.int64)
    idx = (yi * P + xi).reshape(K, -1)

    def sample(maps):
        return torch.gather(maps.reshape(K, P * P), 1, idx).reshape(gx.shape)

    mu = sample(box) / (w * w)
    var = torch.clamp(sample(box2) / (w * w) - mu * mu, min=0.0)
    da = (mu[:, :, 1] - mu[:, :, 0]) ** 2 + (var[:, :, 1] - var[:, :, 0]) ** 2
    db = (mu[:, :, 2] - mu[:, :, 0]) ** 2 + (var[:, :, 2] - var[:, :, 0]) ** 2
    return pack_bits(da < db)


# ---------------------------------------------------------------------------
# BoostDesc family: boosted gradient-orientation-map weak learners
# ---------------------------------------------------------------------------

_N_ORI = 8  # gradient orientation bins


def gradient_maps(patches: torch.Tensor, angles: torch.Tensor):
    """(K, P, P, 8) oriented gradient energy maps: each pixel's magnitude
    split linearly between its two nearest orientation bins."""
    rx, ry = _rotated_grads(patches, angles)
    mag = torch.sqrt(rx * rx + ry * ry)
    ori = torch.atan2(ry, rx)
    two_pi = 2.0 * np.pi
    b = floor_mod(ori, two_pi) / two_pi * _N_ORI
    b0 = torch.floor(b)
    frac = b - b0
    b0i = b0.to(torch.int64) % _N_ORI
    b1i = (b0i + 1) % _N_ORI
    oh0 = F.one_hot(b0i, _N_ORI).to(patches.dtype)
    oh1 = F.one_hot(b1i, _N_ORI).to(patches.dtype)
    return mag[..., None] * (oh0 * (1.0 - frac[..., None])
                             + oh1 * frac[..., None])


@functools.lru_cache(maxsize=None)
def boost_rects(n_weak: int, patch: int, seed: int) -> np.ndarray:
    """Weak-learner pooling regions: (n_weak, 5) = (y0, x0, y1, x1, ori)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_weak):
        h = rng.integers(3, patch // 2)
        w_ = rng.integers(3, patch // 2)
        y0 = rng.integers(0, patch - h)
        x0 = rng.integers(0, patch - w_)
        out.append((y0, x0, y0 + h, x0 + w_, rng.integers(0, _N_ORI)))
    return np.asarray(out, np.int32)


@functools.lru_cache(maxsize=None)
def boost_masks(n_weak: int, patch: int, seed: int) -> np.ndarray:
    """(n_weak, P*P*8) region x orientation pooling masks (region means)."""
    rects = boost_rects(n_weak, patch, seed)
    m = np.zeros((n_weak, patch, patch, _N_ORI), np.float32)
    for i, (y0, x0, y1, x1, o) in enumerate(rects):
        m[i, y0:y1, x0:x1, o] = 1.0 / ((y1 - y0) * (x1 - x0))
    return m.reshape(n_weak, -1)


@functools.lru_cache(maxsize=None)
def _bf16_masks(n_weak: int, patch: int, seed: int, device: str):
    """(P*P*8, n_weak) pooling masks rounded to bf16, on `device`."""
    m = torch.from_numpy(boost_masks(n_weak, patch, seed))
    return _bf16(m).T.contiguous().to(device)


def _weak_responses(patches: torch.Tensor, angles: torch.Tensor,
                    n_weak: int, seed: int) -> torch.Tensor:
    """(K, n_weak) pooled gradient responses, mean-centred per patch."""
    K, P, _ = patches.shape
    gm = gradient_maps(patches, angles).reshape(K, -1)
    resp = _bf16(gm) @ _bf16_masks(n_weak, P, seed, str(patches.device))
    return resp - torch.mean(resp, dim=1, keepdim=True)


@functools.lru_cache(maxsize=None)
def boost_projection(variant: str) -> np.ndarray:
    """The seeded f32 projection of BINBOOST_d ((256, d) / 16) and LBGM
    ((512, 64))."""
    if variant == "LBGM":
        return np.random.default_rng(37).normal(size=(512, 64)).astype(
            np.float32)
    d = int(variant.split("_")[1])
    rng = np.random.default_rng(29 + d)
    return rng.normal(size=(256, d)).astype(np.float32) / np.float32(16.0)


def boostdesc_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                         variant: str = "BGM", oriented: bool = True):
    """BoostDesc family (features.cpp BGM / LBGM / BINBOOST rows).

    BGM: 256 weak learners -> 256-bit (K, 8) int32. BINBOOST_{64,128,256}:
    d bits, each the sign of a seeded combination of 256 weak learners ->
    (K, d / 32) int32. LBGM: 512 weak responses projected to 64-d,
    L2-normalized (K, 64) float32.
    """
    if not oriented:
        angles = torch.zeros_like(angles)
    v = variant.upper()
    if v == "BGM":
        return pack_bits(_weak_responses(patches, angles, 256, seed=21) > 0.0)
    if v.startswith("BINBOOST"):
        resp = _weak_responses(patches, angles, 256, seed=23)
        z = resp @ torch.from_numpy(boost_projection(v)).to(patches.device)
        return pack_bits(z > 0.0)
    if v == "LBGM":
        resp = _weak_responses(patches, angles, 512, seed=31)
        z = resp @ torch.from_numpy(boost_projection(v)).to(patches.device)
        return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                               min=1e-9)
    raise ValueError(f"unknown BoostDesc variant {variant}")


# ---------------------------------------------------------------------------
# VGG: pooled gradient features x linear projection
# ---------------------------------------------------------------------------


def _vgg_centers():
    centers = [(0.0, 0.0)]
    for r, n in ((0.4, 8), (0.8, 8)):
        for i in range(n):
            th = 2 * np.pi * i / n
            centers.append((_f32(r * np.cos(th)), _f32(r * np.sin(th))))
    return centers


def vgg_descriptor(patches: torch.Tensor, angles: torch.Tensor, dims: int,
                   oriented: bool = True) -> torch.Tensor:
    """VGG-{120, 80, 64, 48} (features.cpp VGG rows): the oriented
    gradient maps pooled over 17 Gaussian regions (centre + 2 rings x 8),
    bf16 operands with f32 sums, then a seeded projection to `dims`,
    L2-normalized float32."""
    K, P, _ = patches.shape
    dev = patches.device
    if not oriented:
        angles = torch.zeros_like(angles)
    gm = gradient_maps(patches, angles)
    c = (P - 1) / 2.0
    ys = (torch.arange(P, dtype=torch.float32, device=dev) - c) / c
    yy, xx = torch.meshgrid(ys, ys, indexing="ij")
    pools = torch.stack([
        torch.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)) / (2 * 0.25**2))
        for cx, cy in _vgg_centers()])  # (17, P, P)
    feats = torch.einsum("khwo,rhw->kro", _bf16(gm),
                         _bf16(pools)).reshape(K, -1)
    rng = np.random.default_rng(41 + dims)
    proj = torch.from_numpy(
        (rng.normal(size=(feats.shape[1], dims)) / 12.0).astype(np.float32)
    ).to(dev)
    z = feats @ proj
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                           min=1e-9)


# ---------------------------------------------------------------------------
# DAISY: ring-sampled orientation maps
# ---------------------------------------------------------------------------


def _daisy_kernel(sigma: float) -> np.ndarray:
    r = max(1, int(np.ceil(2.5 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def daisy_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                     oriented: bool = True) -> torch.Tensor:
    """DAISY (features.cpp DAISY row): the 8 orientation maps blurred at
    sigma 1.5, 3 and 5 (zero-padded separable blurs), sampled at the centre
    and 3 rings x 8 rotated into the keypoint frame (nearest pixel, half to
    even), each sample's 8-bin histogram L2-normalized -> (K, 200)
    float32."""
    K, P, _ = patches.shape
    if not oriented:
        angles = torch.zeros_like(angles)
    gm = gradient_maps(patches, angles).permute(0, 3, 1, 2)  # (K, 8, P, P)
    levels = [conv_sep_zero(gm, _daisy_kernel(s)).permute(0, 2, 3, 1)
              .reshape(K, P * P, 8) for s in (1.5, 3.0, 5.0)]
    c = (P - 1) / 2.0
    ca, sa = torch.cos(angles), torch.sin(angles)
    locs = [(0.0, 0.0, 0)]
    for li, r in enumerate((0.35, 0.65, 0.95)):
        for i in range(8):
            th = 2 * np.pi * i / 8
            locs.append((_f32(r * np.cos(th)), _f32(r * np.sin(th)), li))
    out = []
    for lx, ly, li in locs:
        sx = c + (ca * lx - sa * ly) * c
        sy = c + (sa * lx + ca * ly) * c
        xi = torch.clamp(torch.round(sx), 0, P - 1).to(torch.int64)
        yi = torch.clamp(torch.round(sy), 0, P - 1).to(torch.int64)
        idx = (yi * P + xi)[:, None, None].expand(K, 1, 8)
        h = torch.gather(levels[li], 1, idx)[:, 0]
        out.append(h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                                   min=1e-9))
    return torch.cat(out, dim=-1)


def surf64_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                      oriented: bool = True) -> torch.Tensor:
    """SURF 64-d (features.cpp SURF row): the M-SURF descriptor."""
    from matchinglib_poselib_torch.ops.nonlinear_diffusion import (
        msurf_descriptor,
    )

    return msurf_descriptor(patches, angles, oriented)
