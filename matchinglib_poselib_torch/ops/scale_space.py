"""Scale-space keypoint detectors, SIFT and SURF rows (port of
``ops/scale_space.py``).

- Gaussian pyramids via separable convolutions with static taps and
  edge-replicate padding.
- Scale-space extrema via 3x3 window max/min comparisons.
- Per-level keypoints come from the grid-capped top-k of the base scale,
  merged with a global top-k (responseFilterGridBased, features.cpp:506).

The separable blur is a fixed-order loop of shifted multiply-adds, so the
CPU and the card round every pixel alike (a convolution library may pick
an FFT or Winograd algorithm whose rounding moves DoG extrema). STAR, MSD,
MSER and pyramid FAST are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from matchinglib_poselib_torch.ops import features as feat
from matchinglib_poselib_torch.ops.geometry import topk_stable


# ---------------------------------------------------------------------------
# separable convolution helpers
# ---------------------------------------------------------------------------


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_sep(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 2D convolution with a static 1D kernel, edge-replicate
    padding (zero padding would fabricate border responses at coarse
    scales). Rows first, then columns; each pass sums its taps in order,
    one multiply and one add per tap."""
    taps = [float(v) for v in k1d]
    r = len(taps) // 2
    H, W = img.shape
    x = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    acc = x[0:H] * taps[0]
    for i in range(1, len(taps)):
        acc = acc + x[i:i + H] * taps[i]
    out = acc[:, 0:W] * taps[0]
    for i in range(1, len(taps)):
        out = out + acc[:, i:i + W] * taps[i]
    return out


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    if sigma <= 0.0:
        return img
    return _conv_sep(img, _gauss_kernel1d(sigma))


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    return img[::2, ::2]


def _win_max(x: torch.Tensor) -> torch.Tensor:
    """3x3 window max over the last two axes, -inf outside the image."""
    return F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]


def _roll(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, shifts=(dy, dx), dims=(0, 1))


# ---------------------------------------------------------------------------
# grid selection shared across octaves
# ---------------------------------------------------------------------------


def _select_level(score: torch.Tensor, k: int, coord_scale: float,
                  kp_scale: float, border: int, grid_cells: int = 0):
    """Grid top-k at one pyramid level, coords mapped to base resolution."""
    xy, sc, mask = feat.select_keypoints_grid(score, k, grid_cells, border)
    xy = feat.refine_subpixel(score, xy, mask)
    xy = xy * coord_scale
    scale = torch.full_like(sc, kp_scale)
    return xy, sc, scale, mask


def _merge_levels(levels, max_keypoints: int) -> feat.Keypoints:
    """Concatenate per-level candidates, keep the global top max_keypoints
    (ties to the lowest index, as ``lax.top_k``)."""
    xy = torch.cat([lv[0] for lv in levels])
    sc = torch.cat([lv[1] for lv in levels])
    scale = torch.cat([lv[2] for lv in levels])
    mask = torch.cat([lv[3] for lv in levels])
    dev = xy.device
    vals = torch.where(mask, sc, -torch.inf)
    k = min(max_keypoints, vals.shape[0])
    top, idx = topk_stable(vals, k)
    out_mask = torch.isfinite(top) & (top > 0.0)
    kps = feat.Keypoints(
        xy=xy[idx], score=torch.where(out_mask, sc[idx], 0.0),
        angle=torch.zeros((k,), device=dev), scale=scale[idx], mask=out_mask,
    )
    if k < max_keypoints:
        pad = max_keypoints - k
        kps = feat.Keypoints(
            xy=torch.cat([kps.xy, torch.zeros((pad, 2), device=dev)]),
            score=torch.cat([kps.score, torch.zeros((pad,), device=dev)]),
            angle=torch.cat([kps.angle, torch.zeros((pad,), device=dev)]),
            scale=torch.cat([kps.scale, torch.ones((pad,), device=dev)]),
            mask=torch.cat([kps.mask, torch.zeros((pad,), dtype=torch.bool,
                                                  device=dev)]),
        )
    return kps


def _n_octaves(h: int, w: int, min_size: int = 32, cap: int = 4) -> int:
    n = 1
    while min(h, w) // (2**n) >= min_size and n < cap:
        n += 1
    return n


# ---------------------------------------------------------------------------
# SIFT: difference-of-Gaussians extrema
# ---------------------------------------------------------------------------

_SIFT_SCALES = 3  # intervals per octave (OpenCV SIFT nOctaveLayers)
_SIFT_SIGMA0 = 1.6
_SIFT_CONTRAST_TH = 0.04 / _SIFT_SCALES  # OpenCV contrastThreshold scheme
_SIFT_EDGE_R = 10.0  # edge-response ratio threshold


def _dog_octave_score(gauss: list[torch.Tensor], contrast_th: float):
    """Scale-space extrema scores for one octave.

    gauss: S+3 blurred images. Returns S response maps: |DoG| where the
    pixel is a 26-neighbourhood extremum passing the contrast and edge
    tests, else 0.
    """
    dogs = [g1 - g0 for g0, g1 in zip(gauss[:-1], gauss[1:])]
    D = torch.stack(dogs)
    mx = _win_max(D)
    mn = -_win_max(-D)
    outs = []
    for i in range(1, len(dogs) - 1):
        c = D[i]
        is_max = (c >= mx[i - 1]) & (c >= mx[i + 1]) & (c >= mx[i]) & (c > 0)
        is_min = (c <= mn[i - 1]) & (c <= mn[i + 1]) & (c <= mn[i]) & (c < 0)
        # edge suppression: DoG Hessian trace^2/det test (Lowe sec. 4.1)
        dxx = _roll(c, 0, 1) + _roll(c, 0, -1) - 2 * c
        dyy = _roll(c, 1, 0) + _roll(c, -1, 0) - 2 * c
        dxy = 0.25 * (_roll(c, 1, 1) + _roll(c, -1, -1) - _roll(c, 1, -1)
                      - _roll(c, -1, 1))
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        r = _SIFT_EDGE_R
        edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
        ok = (is_max | is_min) & (torch.abs(c) > contrast_th) & edge_ok
        outs.append(torch.where(ok, torch.abs(c), 0.0))
    return outs


def sift_dog_keypoints(img: torch.Tensor, max_keypoints: int,
                       contrast_th: float = _SIFT_CONTRAST_TH,
                       grid_cells: int = 0) -> feat.Keypoints:
    """SIFT detector: DoG scale-space extrema over a Gaussian pyramid
    (features.cpp:816-819 'SIFT' row)."""
    H, W = img.shape
    n_oct = _n_octaves(H, W)
    base = gaussian_blur(img, np.sqrt(max(_SIFT_SIGMA0**2 - 0.25, 0.01)))
    levels = []
    per_level_k = max(32, max_keypoints // max(1, n_oct))
    k_step = [
        np.sqrt(max(
            (_SIFT_SIGMA0 * 2 ** ((i + 1) / _SIFT_SCALES)) ** 2
            - (_SIFT_SIGMA0 * 2 ** (i / _SIFT_SCALES)) ** 2, 1e-4))
        for i in range(_SIFT_SCALES + 2)
    ]
    cur = base
    for o in range(n_oct):
        gauss = [cur]
        for i in range(_SIFT_SCALES + 2):
            gauss.append(gaussian_blur(gauss[-1], float(k_step[i])))
        scores = _dog_octave_score(gauss, contrast_th)
        for i, sc in enumerate(scores):
            sigma = _SIFT_SIGMA0 * 2 ** ((i + 1) / _SIFT_SCALES) * (2**o)
            levels.append(_select_level(
                sc, per_level_k, float(2**o), float(sigma / _SIFT_SIGMA0),
                border=8, grid_cells=grid_cells,
            ))
        cur = _downsample2(gauss[_SIFT_SCALES])  # the sigma-doubled layer
    return _merge_levels(levels, max_keypoints)


# ---------------------------------------------------------------------------
# SURF: determinant-of-Hessian over scales
# ---------------------------------------------------------------------------


def _hessian_det(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalized determinant of the Gaussian Hessian."""
    g = gaussian_blur(img, sigma)
    dxx = _roll(g, 0, 1) + _roll(g, 0, -1) - 2 * g
    dyy = _roll(g, 1, 0) + _roll(g, -1, 0) - 2 * g
    dxy = 0.25 * (_roll(g, 1, 1) + _roll(g, -1, -1) - _roll(g, 1, -1)
                  - _roll(g, -1, 1))
    return (sigma**2) ** 2 * (dxx * dyy - 0.81 * dxy * dxy)


_SURF_SIGMAS = (1.2, 1.6, 2.2, 3.0, 4.2, 6.0, 8.5)


def surf_hessian_keypoints(img: torch.Tensor, max_keypoints: int,
                           grid_cells: int = 0) -> feat.Keypoints:
    """SURF detector: Gaussian-Hessian blobs, extrema across adjacent
    scales (features.cpp:820-823 'SURF' row; 0.81 is SURF's dxy weight)."""
    maps = torch.stack([_hessian_det(img, s) for s in _SURF_SIGMAS])
    mx = _win_max(maps)
    levels = []
    per_level_k = max(32, max_keypoints // (len(_SURF_SIGMAS) - 2))
    for i in range(1, len(_SURF_SIGMAS) - 1):
        c = maps[i]
        ok = (c >= mx[i - 1]) & (c >= mx[i + 1]) & (c >= mx[i]) & (c > 1e-7)
        levels.append(_select_level(
            torch.where(ok, c, 0.0), per_level_k, 1.0,
            float(_SURF_SIGMAS[i] / 1.2), border=16, grid_cells=grid_cells,
        ))
    return _merge_levels(levels, max_keypoints)
