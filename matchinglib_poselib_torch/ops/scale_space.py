"""Scale-space keypoint detectors: DoG (SIFT), fast-Hessian (SURF),
stable DoG blobs (MSER), CenSurE (STAR), MSD and pyramid FAST (ORB,
BRISK); port of ``ops/scale_space.py``.

- Gaussian pyramids via separable convolutions with static taps and
  edge-replicate padding; box filters the same way.
- Scale-space extrema via 3x3 window max/min comparisons.
- Per-level keypoints come from the grid-capped top-k of the base scale,
  merged with a global top-k (responseFilterGridBased, features.cpp:506).
- Pyramid FAST resizes with the JAX package's antialiased linear
  resize (``resize_weights``: the same per-axis weight matrices, applied
  as two products in the same order) and scores each level with the fused
  FAST+NMS kernel on the card.

The separable blur is a fixed-order loop of shifted multiply-adds, so the
CPU and the card round every pixel alike (a convolution library may pick
an FFT or Winograd algorithm whose rounding moves DoG extrema).
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


def conv_sep_zero(x: torch.Tensor, k1d) -> torch.Tensor:
    """Separable correlation over the last two axes with a static odd 1D
    kernel, zero padding (``conv_general_dilated`` with "SAME" padding in
    the JAX package): rows first, then columns, one multiply and one add
    per tap in order."""
    taps = [float(v) for v in k1d]
    r = len(taps) // 2
    H, W = x.shape[-2:]
    p = F.pad(x, (r, r, r, r))
    acc = p[..., 0:H, :] * taps[0]
    for i in range(1, len(taps)):
        acc = acc + p[..., i:i + H, :] * taps[i]
    out = acc[..., 0:W] * taps[0]
    for i in range(1, len(taps)):
        out = out + acc[..., i:i + W] * taps[i]
    return out


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean filter over a (2r+1)^2 window (separable uniform taps, edge
    replication)."""
    w = 2 * radius + 1
    return _conv_sep(img, np.full((w,), 1.0 / w, np.float32))


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


def mser_blob_keypoints(img: torch.Tensor, max_keypoints: int,
                        grid_cells: int = 0) -> feat.Keypoints:
    """MSER registry row: DoG blob extrema at a quarter of SIFT's contrast
    threshold (the JAX package's documented substitution for the
    reference's 'MSER' row, features.cpp:800-803)."""
    return sift_dog_keypoints(img, max_keypoints,
                              contrast_th=0.25 * _SIFT_CONTRAST_TH,
                              grid_cells=grid_cells)


# ---------------------------------------------------------------------------
# STAR (CenSurE): bi-level center-surround filters
# ---------------------------------------------------------------------------

_STAR_SIZES = (1, 2, 3, 4, 6, 8, 11)


def censure_keypoints(img: torch.Tensor, max_keypoints: int,
                      grid_cells: int = 0) -> feat.Keypoints:
    """STAR / CenSurE (features.cpp:824-827 'STAR'): inner-box minus
    surround-annulus means at seven sizes, a Harris-ratio line suppressor,
    extrema of |response| across adjacent sizes."""
    responses = []
    for s in _STAR_SIZES:
        inner = box_filter(img, s)
        outer = box_filter(img, 2 * s)
        wi = (2 * s + 1) ** 2
        wo = (4 * s + 1) ** 2
        ann = (outer * wo - inner * wi) / (wo - wi)
        responses.append(inner - ann)
    stack = torch.stack(responses)
    amx = _win_max(torch.abs(stack))
    gx, gy = feat.sobel(img)
    a = box_filter(gx * gx, 2)
    b = box_filter(gy * gy, 2)
    c = box_filter(gx * gy, 2)
    tr = a + b
    det = a * b - c * c
    not_line = det * 10.0 >= tr * tr
    levels = []
    per_level_k = max(32, max_keypoints // max(1, len(_STAR_SIZES) - 2))
    for i in range(1, len(_STAR_SIZES) - 1):
        r = torch.abs(stack[i])
        ok = ((r >= amx[i - 1]) & (r >= amx[i + 1]) & (r >= amx[i])
              & (r > 1e-4) & not_line)
        levels.append(_select_level(
            torch.where(ok, r, 0.0), per_level_k, 1.0,
            float(_STAR_SIZES[i]), border=16, grid_cells=grid_cells))
    return _merge_levels(levels, max_keypoints)


# ---------------------------------------------------------------------------
# MSD: maximal self-dissimilarity
# ---------------------------------------------------------------------------


def _msd_offsets(r_ignore: int = 2, r_search: int = 5) -> np.ndarray:
    """Every other offset of the ring r_ignore < |o| <= r_search."""
    offs = []
    for dy in range(-r_search, r_search + 1):
        for dx in range(-r_search, r_search + 1):
            d2 = dy * dy + dx * dx
            if r_ignore**2 < d2 <= r_search**2:
                offs.append((dy, dx))
    return np.array(offs[::2], np.int32)


def msd_keypoints(img: torch.Tensor, max_keypoints: int,
                  patch_radius: int = 3,
                  grid_cells: int = 0) -> feat.Keypoints:
    """MSD (features.cpp:828-831 'MSD'): saliency = min over the ring
    offsets o of the patch SSD between p and p + o (a box filter of the
    squared difference to the wrapped shift), NMS, grid top-k."""
    w = (2 * patch_radius + 1) ** 2
    sal = None
    for dy, dx in _msd_offsets():
        d = img - _roll(img, int(dy), int(dx))
        ssd = box_filter(d * d, patch_radius) * w
        sal = ssd if sal is None else torch.minimum(sal, ssd)
    score = feat.nms(sal, 3)
    xy, sc, mask = feat.select_keypoints_grid(score, max_keypoints,
                                              grid_cells, border=16)
    xy = feat.refine_subpixel(score, xy, mask)
    return feat.Keypoints(xy=xy, score=sc, angle=torch.zeros_like(sc),
                          scale=torch.ones_like(sc), mask=mask)


# ---------------------------------------------------------------------------
# pyramid FAST (ORB / BRISK-AGAST)
# ---------------------------------------------------------------------------


def resize_weights(in_size: int, out_size: int,
                   device=None) -> torch.Tensor:
    """(in_size, out_size) float32 weights of the JAX package's
    ``jax.image.resize(..., "linear")`` along one axis (antialias on:
    the triangle kernel widened by 1 / scale when downsampling, each
    output sample's weights normalised to sum 1, zero outside the input;
    ``compute_weight_mat`` of ``jax/_src/image/scale.py`` as XLA compiles
    it), in f32 in the same operations. The column sums may round apart
    from XLA's (another order): ~1 ulp on a few entries."""
    f32 = torch.float32
    # the JAX package's scale is a Python float: 1 / scale is taken in
    # double precision and rounded to f32 where it meets the f32 arrays;
    # XLA contracts the sample positions' multiply-add into one FMA (one
    # rounding: exact in f64 here, then rounded to f32) and turns the
    # division by the kernel scale into a multiplication by its f32
    # reciprocal
    inv_scale = float(np.float32(1.0 / (out_size / in_size)))
    kernel_scale = np.float32(max(inv_scale, 1.0))
    inv_kernel = float(np.float32(1.0) / kernel_scale)
    sample_f = ((torch.arange(out_size, dtype=torch.float64, device=device)
                 + 0.5) * inv_scale - 0.5).to(f32)
    x = torch.abs(sample_f[None, :] - torch.arange(
        in_size, dtype=f32, device=device)[:, None]) * inv_kernel
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(img, (out_h, out_w), "linear")`` of an (H, W)
    image: the rows' weights, then the columns', as two fp32 products in
    the JAX package's order (TF32 is off); an axis whose size stays is
    left as it is, as there."""
    H, W = img.shape
    out = img
    if H != out_h:
        out = resize_weights(H, out_h, img.device).T @ out
    if W != out_w:
        out = out @ resize_weights(W, out_w, img.device)
    return out


def pyramid_fast_keypoints(img: torch.Tensor, max_keypoints: int,
                           threshold: float, n_levels: int = 1,
                           scale_factor: float = 1.25,
                           harris_rank: bool = False,
                           grid_cells: int = 0) -> feat.Keypoints:
    """Multi-scale FAST (features.cpp:804-811 'ORB' / 'BRISK'): each level
    of an antialiased linear pyramid is scored by the fused FAST+NMS kernel
    on the card (its plain version on the CPU): BRISK at NMS radius 3; ORB
    at radius 0 (the raw score), re-ranked by the Harris response and then
    suppressed at radius 3. The kernel reads pixels outside the image as
    0 where the JAX package's score wraps; the two agree further than 3 +
    radius from the border, and ``_select_level`` keeps 16 px clear of
    it."""
    from matchinglib_poselib_torch.ops.kernels import fast_nms

    H, W = img.shape
    levels = []
    per_level_k = max(64, max_keypoints // max(1, n_levels))
    cur = img
    for lv in range(n_levels):
        s = scale_factor**lv
        if lv > 0:
            nh, nw = max(32, int(round(H / s))), max(32, int(round(W / s)))
            cur = resize_linear(img, nh, nw)
        if harris_rank:
            score = fast_nms.fast_nms_score(cur[None].contiguous(),
                                            threshold, 0)[0]
            h = feat.harris_score(cur)
            score = feat.nms(torch.where(score > 0.0,
                                         torch.clamp(h, min=1e-12), 0.0), 3)
        else:
            score = fast_nms.fast_nms_score(cur[None].contiguous(),
                                            threshold, 3)[0]
        levels.append(_select_level(score, per_level_k, float(s), float(s),
                                    border=16, grid_cells=grid_cells))
    return _merge_levels(levels, max_keypoints)
