"""Feature front end (port of ``ops/features.py``): the FAST/ORB path
and the SIFT and SURF rows.

FAST-9/16 segment-test scores with window-max NMS, column-band keypoint
selection with quadratic subpixel refinement, intensity-centroid
orientation, steered BRIEF-256 with ORB-style discretized rotations, and
the SIFT gradient-histogram float descriptor. SIFT and SURF detection live
in ``ops/scale_space.py``, the M-SURF descriptor in
``ops/nonlinear_diffusion.py``. Everything is fixed-shape: exactly
``max_keypoints`` slots per image with a validity mask; images are (H, W)
float32 grayscale in [0, 1].

On a CUDA tensor ``detect_keypoints`` runs the fused FAST+NMS kernel
(``ops/kernels/fast_nms.py``) where the JAX package runs its Pallas kernel;
on a CPU tensor it runs ``nms(fast_score(.))``, the kernel's plain version.
``detect_keypoints_batch`` scores a stack of images in one kernel call
(the batched pipeline's pairs) and selects keypoints image by image.
Binary descriptors are (K, 8) int32 words holding the same bit patterns as
the JAX package's (K, 8) uint32 words; float descriptors are (K, 128) or
(K, 64) float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from matchinglib_poselib_torch.config import DescriptorConfig, DetectorConfig
from matchinglib_poselib_torch.ops.geometry import floor_mod, topk_stable


class Keypoints(NamedTuple):
    xy: torch.Tensor  # (K, 2) float32 pixel coords (x, y)
    score: torch.Tensor  # (K,) detector response
    angle: torch.Tensor  # (K,) orientation in radians
    scale: torch.Tensor  # (K,) pyramid scale factor (1.0 = base)
    mask: torch.Tensor  # (K,) bool validity

    @property
    def n(self):
        return torch.sum(self.mask.to(torch.int32))


# ---------------------------------------------------------------------------
# FAST score + NMS (the plain version of the fused kernel)
# ---------------------------------------------------------------------------

# FAST 16-pixel Bresenham circle offsets (dy, dx), radius 3.
FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_score(img: torch.Tensor, threshold: float = 20.0 / 255.0):
    """FAST-9/16 segment-test corner response over the last two axes.

    A pixel is a corner if >= 9 contiguous ring pixels are all brighter
    than c + t or all darker than c - t; the response is the larger of the
    bright and dark relu sums. Ring samples wrap at the border
    (``torch.roll``, as ``jnp.roll`` in the JAX package).
    """
    diffs = [
        torch.roll(img, shifts=(dy, dx), dims=(-2, -1)) - img
        for dy, dx in FAST_RING
    ]
    score_b = diffs[0] * 0.0
    score_d = diffs[0] * 0.0
    for d in diffs:
        score_b = score_b + torch.clamp(d - threshold, min=0.0)
        score_d = score_d + torch.clamp(-d - threshold, min=0.0)

    def arc9(f):
        a2 = [f[s] & f[(s + 1) % 16] for s in range(16)]
        a4 = [a2[s] & a2[(s + 2) % 16] for s in range(16)]
        a8 = [a4[s] & a4[(s + 4) % 16] for s in range(16)]
        acc = a8[0] & f[8]
        for s in range(1, 16):
            acc = acc | (a8[s] & f[(s + 8) % 16])
        return acc

    is_corner = arc9([d > threshold for d in diffs]) | arc9(
        [d < -threshold for d in diffs]
    )
    score = torch.maximum(score_b, score_d)
    return torch.where(is_corner, score, 0.0)


def nms(score: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Keep local maxima within (2r+1)^2 windows over the last two axes.

    ``F.max_pool2d`` pads with -inf, like the JAX package's SAME
    ``reduce_window`` with a -inf init.
    """
    w = 2 * radius + 1
    s4 = score.reshape((-1, 1) + score.shape[-2:])
    mx = F.max_pool2d(s4, w, stride=1, padding=radius).reshape(score.shape)
    return torch.where((score >= mx) & (score > 0.0), score, 0.0)


# ---------------------------------------------------------------------------
# keypoint selection
# ---------------------------------------------------------------------------


def _border_zero(score: torch.Tensor, border: int) -> torch.Tensor:
    H, W = score.shape
    ys = torch.arange(H, device=score.device)[:, None]
    xs = torch.arange(W, device=score.device)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (
        xs < W - border
    )
    return torch.where(inb, score, 0.0)


def _topk_small(x: torch.Tensor, k: int):
    """Exact top-k along the last axis, ties to the lowest index."""
    if k > 8:
        return topk_stable(x, k)
    cols = torch.arange(x.shape[-1], device=x.device).expand(x.shape)
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        i = torch.argmax(cur, dim=-1)
        v = torch.gather(cur, -1, i[..., None])[..., 0]
        vals.append(v)
        idxs.append(i)
        cur = torch.where(cols == i[..., None], -math.inf, cur)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def select_keypoints_grid(
    score: torch.Tensor, max_keypoints: int, grid_cells: int = 0,
    border: int = 16,
):
    """Grid-capped global top-k selection (responseFilterGridBased,
    features.cpp:506). Returns (xy, score, mask)."""
    H, W = score.shape
    dev = score.device
    score = _border_zero(score, border)
    if grid_cells <= 0:
        grid_cells = max(2, int(np.sqrt(max_keypoints / 2.0)))
    gh = max(1, H // grid_cells)
    gw = max(1, W // grid_cells)
    Hp = ((H + gh - 1) // gh) * gh
    Wp = ((W + gw - 1) // gw) * gw
    sp = F.pad(score, (0, Wp - W, 0, Hp - H))
    ncy, ncx = Hp // gh, Wp // gw
    cells = sp.reshape(ncy, gh, ncx, gw).permute(0, 2, 1, 3).reshape(
        ncy * ncx, gh * gw
    )
    per_cell = min(
        max(1, int(np.ceil(2.0 * max_keypoints / (ncy * ncx)))), gh * gw
    )
    vals, idx = _topk_small(cells, per_cell)
    cid = torch.arange(ncy * ncx, device=dev)
    gy = (cid // ncx)[:, None] * gh + idx // gw
    gx = (cid % ncx)[:, None] * gw + idx % gw
    flat_vals = vals.reshape(-1)
    k = min(max_keypoints, flat_vals.shape[0])
    top_vals, top_i = topk_stable(flat_vals, k)
    xy = torch.stack(
        [gx.reshape(-1)[top_i], gy.reshape(-1)[top_i]], dim=-1
    ).to(torch.float32)
    mask = top_vals > 0.0
    if k < max_keypoints:
        pad = max_keypoints - k
        xy = torch.cat([xy, torch.zeros((pad, 2), device=dev)])
        top_vals = torch.cat([top_vals, torch.zeros((pad,), device=dev)])
        mask = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool,
                                            device=dev)])
    return xy, top_vals, mask


def band_width(width: int, bands: int) -> int:
    """Pixel width of one column band, aligned up to a multiple of 4."""
    return ((width + bands - 1) // bands + 3) // 4 * 4


def select_keypoints_banded(
    score: torch.Tensor,
    max_keypoints: int,
    bands: int = 16,
    border: int = 16,
    nms_radius: int = 3,
):
    """Per-band top-C keypoint selection, output grouped by column band.

    Slot b*C..(b+1)*C-1 holds band b's keypoints (C = max_keypoints /
    bands). A blk x blk max/argmax pre-reduction (exact for blk <=
    nms_radius + 1) shrinks the top-k operand. Returns (xy, score, mask).
    """
    H, W = score.shape
    dev = score.device
    score = _border_zero(score, border)
    C = max_keypoints // bands
    gw = band_width(W, bands)
    blk = 4 if nms_radius >= 3 else (2 if nms_radius >= 1 else 1)
    Wq = bands * gw
    Hb = ((H + blk - 1) // blk) * blk
    sp = torch.zeros((Hb, Wq), dtype=score.dtype, device=dev)
    wc = min(W, Wq)
    sp[:H, :wc] = score[:, :wc]
    nby, ngx = Hb // blk, Wq // blk
    blocks = sp.reshape(nby, blk, ngx, blk).permute(0, 2, 1, 3).reshape(
        nby, ngx, blk * blk
    )
    bmax = torch.amax(blocks, dim=-1)
    barg = torch.argmax(blocks, dim=-1)
    gwr = gw // blk
    bm = bmax.reshape(nby, bands, gwr).permute(1, 0, 2).reshape(
        bands, nby * gwr
    )
    ba = barg.reshape(nby, bands, gwr).permute(1, 0, 2).reshape(
        bands, nby * gwr
    )
    vsel, ridx = topk_stable(bm, C)
    inblk = torch.gather(ba, 1, ridx)
    ysel = (ridx // gwr) * blk + inblk // blk
    xsel = torch.arange(bands, device=dev)[:, None] * gw + torch.clamp(
        (ridx % gwr) * blk + inblk % blk, max=gw - 1
    )
    xy = torch.stack(
        [xsel.reshape(-1), ysel.reshape(-1)], dim=-1
    ).to(torch.float32)
    sc = vsel.reshape(-1)
    mask = sc > 0.0
    slot = torch.arange(max_keypoints, device=dev)
    fill = torch.stack(
        [(slot // C) * gw + gw // 2, torch.full_like(slot, H // 2)], dim=-1
    ).to(torch.float32)
    xy = torch.where(mask[:, None], xy, fill)
    return xy, sc, mask


def refine_subpixel(score: torch.Tensor, xy: torch.Tensor, mask: torch.Tensor):
    """Quadratic 3x3 subpixel refinement of keypoint locations."""
    H, W = score.shape
    x = torch.clamp(xy[:, 0].to(torch.int64), 1, W - 2)
    y = torch.clamp(xy[:, 1].to(torch.int64), 1, H - 2)

    def g(dy, dx):
        return score[y + dy, x + dx]

    dx = 0.5 * (g(0, 1) - g(0, -1))
    dy = 0.5 * (g(1, 0) - g(-1, 0))
    dxx = g(0, 1) + g(0, -1) - 2.0 * g(0, 0)
    dyy = g(1, 0) + g(-1, 0) - 2.0 * g(0, 0)
    ox = torch.where(torch.abs(dxx) > 1e-9, -dx / dxx, 0.0)
    oy = torch.where(torch.abs(dyy) > 1e-9, -dy / dyy, 0.0)
    ox = torch.clamp(ox, -0.5, 0.5)
    oy = torch.clamp(oy, -0.5, 0.5)
    out = torch.stack(
        [x.to(torch.float32) + ox, y.to(torch.float32) + oy], dim=-1
    )
    return torch.where(mask[:, None], out, xy)


# ---------------------------------------------------------------------------
# patches + orientation
# ---------------------------------------------------------------------------


def _bf16_round(img: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the JAX package samples patches from a bf16
    image (its one-hot selection einsums run in bf16)."""
    return img.to(torch.bfloat16).to(torch.float32)


def extract_patches(
    img: torch.Tensor, xy: torch.Tensor, patch: int = 31, bands: int = 0
) -> torch.Tensor:
    """(K, patch, patch) patches centred on integer keypoint locations,
    sampled from the bf16-rounded image.

    bands > 0 (keypoints from select_keypoints_banded with the same band
    count): column indices follow the banded window arithmetic of the JAX
    package, including its clamps, so contract violations give the same
    clamped patches there and here.
    """
    if bands > 0 and xy.shape[0] % bands == 0:
        return _extract_patches_banded(img, xy, patch, bands)
    H, W = img.shape
    r = patch // 2
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - r, 0, W - patch)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - r, 0, H - patch)
    d = torch.arange(patch, device=img.device)
    rows = (y0[:, None] + d)[:, :, None]
    cols = (x0[:, None] + d)[:, None, :]
    return _bf16_round(img)[rows, cols]


def _extract_patches_banded(
    img: torch.Tensor, xy: torch.Tensor, patch: int, B: int
) -> torch.Tensor:
    H, W = img.shape
    K = xy.shape[0]
    C = K // B
    r = patch // 2
    gw = band_width(W, B)
    Wb = ((gw + patch + 16 + 127) // 128) * 128
    Wpad = max(W, Wb)
    imgp = F.pad(_bf16_round(img), (0, Wpad - W))
    starts = torch.tensor(
        [min(max(b * gw - r, 0), Wpad - Wb) for b in range(B)],
        dtype=torch.int64, device=img.device,
    )
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - r, 0, W - patch)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - r, 0, H - patch)
    relx = torch.clamp(x0.reshape(B, C) - starts[:, None], 0, Wb - patch)
    d = torch.arange(patch, device=img.device)
    cols = (starts[:, None] + relx).reshape(K)[:, None] + d
    rows = y0[:, None] + d
    return imgp[rows[:, :, None], cols[:, None, :]]


def orientation_ic(patches: torch.Tensor) -> torch.Tensor:
    """ORB intensity-centroid orientation per patch (K,) radians."""
    P = patches.shape[-1]
    r = P // 2
    ax = torch.arange(P, device=patches.device) - r
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    circ = (yy**2 + xx**2 <= r * r).to(patches.dtype)
    m01 = torch.sum(patches * (yy * circ)[None], dim=(-1, -2))
    m10 = torch.sum(patches * (xx * circ)[None], dim=(-1, -2))
    return torch.atan2(m01, m10)


# ---------------------------------------------------------------------------
# steered BRIEF-256 (ORB-style discretized rotations)
# ---------------------------------------------------------------------------

N_ANGLE_BINS = 30
PATCH_FOR_TABLE = 31


def brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 3):
    """Fixed Gaussian BRIEF test pattern (n_bits, 2 points, 2 coords)."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    r = patch // 2 - 2
    pts = rng.normal(scale=sigma, size=(n_bits, 2, 2))
    return np.clip(pts, -r, r).astype(np.float32)


def orb_selection_tables(patch: int = PATCH_FOR_TABLE) -> np.ndarray:
    """(BINS, 512) flat patch indices of the rotated, rounded pattern."""
    pts = brief_pattern(patch=patch).reshape(-1, 2)
    r = patch // 2
    tables = []
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        gx = np.clip(np.rint(ca * pts[:, 0] - sa * pts[:, 1]), -r, r) + r
        gy = np.clip(np.rint(sa * pts[:, 0] + ca * pts[:, 1]), -r, r) + r
        tables.append((gy * patch + gx).astype(np.int32))
    return np.stack(tables)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 32*W) {0,1} -> (K, W) int32 words, bit i of word w = bit 32w+i."""
    words = bits.to(torch.int64).reshape(bits.shape[0], -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    packed = torch.sum(words << shifts, dim=-1)
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32)


def brief_descriptor_orb(
    patches: torch.Tensor, angles: torch.Tensor, orb_idx: torch.Tensor,
    oriented: bool = True,
) -> torch.Tensor:
    """Steered BRIEF-256 via ORB-style discretized rotations -> (K, 8) int32.

    The angle is quantized to one of 30 bins; each bit compares two patch
    samples at the bin's precomputed offsets (orb_idx: (BINS, 512)).
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = torch.zeros_like(angles)
    pf = patches.reshape(K, P * P)
    two_pi = 2.0 * math.pi
    binf = floor_mod(angles, two_pi) / two_pi * N_ANGLE_BINS
    bin_idx = torch.round(binf).to(torch.int64) % N_ANGLE_BINS
    vals = torch.gather(pf, 1, orb_idx[bin_idx]).reshape(K, 256, 2)
    return pack_bits(vals[..., 0] < vals[..., 1])


# ---------------------------------------------------------------------------
# SIFT-like float descriptor
# ---------------------------------------------------------------------------


def sift_descriptor(patches: torch.Tensor, angles: torch.Tensor,
                    oriented: bool = True) -> torch.Tensor:
    """4x4 x 8-bin gradient-orientation histogram -> (K, 128) float32.

    Gradients are rotated into the keypoint frame; spatial bins use hard
    assignment (truncation toward zero, as ``astype(int32)``) with Gaussian
    radial weighting; the result is L2-normalized, clamped at 0.2 and
    renormalized (Lowe's scheme). The histogram is a scatter-add in a
    fixed order where the JAX package contracts a one-hot tensor.
    """
    K, P, _ = patches.shape
    dev = patches.device
    if not oriented:
        angles = torch.zeros_like(angles)
    gx = 0.5 * (torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2))
    gy = 0.5 * (torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1))
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx) - angles[:, None, None]

    c = (P - 1) / 2.0
    ys = (torch.arange(P, dtype=torch.float32, device=dev) - c) / c
    yy, xx = torch.meshgrid(ys, ys, indexing="ij")
    ca = torch.cos(-angles)[:, None, None]
    sa = torch.sin(-angles)[:, None, None]
    xr = ca * xx[None] - sa * yy[None]
    yr = sa * xx[None] + ca * yy[None]
    w_gauss = torch.exp(-(xx**2 + yy**2) / (2 * 0.6**2))[None]

    bx = torch.clamp(((xr + 1.0) * 2.0).to(torch.int32), 0, 3)
    by = torch.clamp(((yr + 1.0) * 2.0).to(torch.int32), 0, 3)
    two_pi = 2.0 * math.pi
    ob = torch.clamp(
        (floor_mod(ori, two_pi) / two_pi * 8.0).to(torch.int32), 0, 7)
    bin_idx = (by * 4 + bx) * 8 + ob
    desc = scatter_rows(bin_idx.reshape(K, -1), (mag * w_gauss).reshape(
        K, -1, 1), 128).reshape(K, 128)
    desc = desc / torch.clamp(
        torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc, max=0.2)
    return desc / torch.clamp(
        torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-9)


def scatter_rows(bins: torch.Tensor, vals: torch.Tensor, n_bins: int):
    """Per-row histogram: out[k, b] = sum of vals[k, p] over p with
    bins[k, p] == b. bins (K, P) int, vals (K, P, F) -> (K, n_bins, F).

    ``index_put_`` with accumulation adds in element order on the CPU and
    (sorting the indices stably) on the card, so both take the same sums.
    """
    K, P, Fd = vals.shape
    flat = (torch.arange(K, device=bins.device)[:, None] * n_bins
            + bins.to(torch.int64)).reshape(-1)
    out = torch.zeros((K * n_bins, Fd), dtype=vals.dtype, device=vals.device)
    out.index_put_((flat,), vals.reshape(K * P, Fd), accumulate=True)
    return out.reshape(K, n_bins, Fd)


# ---------------------------------------------------------------------------
# top-level detect + describe
# ---------------------------------------------------------------------------

# registry aliases: reference detector names -> implemented families
# (features.cpp:792-847; README.md:47-66)
DETECTOR_ALIASES = {
    "FAST": "FAST", "ORB": "ORB", "HARRIS": "HARRIS", "GFTT": "SHITOMASI",
    "SHITOMASI": "SHITOMASI", "BRISK": "BRISK", "AKAZE": "AKAZE",
    "KAZE": "KAZE", "SIFT": "SIFT", "SURF": "SURF",
    "STAR": "STAR", "MSD": "MSD", "MSER": "MSER",
}

DESCRIPTOR_ALIASES = {
    # steered-BRIEF family
    "ORB": "BRIEF",
    "LATCH": "LATCH",
    # AKAZE MLDB / KAZE M-SURF (nonlinear_diffusion module)
    "AKAZE": "MLDB", "KAZE_BIN": "MLDB", "KAZE": "MSURF",
    # BoostDesc family
    "BGM": "BGM", "BGM_HARD": "BGM", "BGM_BILINEAR": "BGM",
    "LBGM": "LBGM",
    "BINBOOST_64": "BINBOOST_64", "BINBOOST_128": "BINBOOST_128",
    "BINBOOST_256": "BINBOOST_256",
    # ring-pattern family
    "BRISK": "RING", "FREAK": "RING_LOG",
    # BOLD: per-patch stability masks + masked-Hamming matching
    "BOLD": "BOLD",
    # float family
    "SIFT": "SIFT", "SURF": "SURF64", "DAISY": "DAISY",
    "VGG_120": "VGG_120", "VGG_80": "VGG_80", "VGG_64": "VGG_64",
    "VGG_48": "VGG_48",
    "RIFF": "RIFF",
}

# LBGM is the float member of the BoostDesc family; all others here are
# Hamming
_BINARY_KINDS = (
    "BRIEF", "RING", "RING_LOG", "BOLD", "MLDB", "LATCH", "BGM",
    "BINBOOST_64", "BINBOOST_128", "BINBOOST_256",
)

_SCALE_SPACE_KINDS = ("SIFT", "SURF", "STAR", "MSD", "MSER", "KAZE", "AKAZE")
_FAST_KINDS = ("FAST", "ORB", "BRISK")
# descriptor families the port computes (others raise)
_PORTED_DESCRIPTORS = ("BRIEF", "SIFT", "SURF64", "MSURF")


def is_binary_descriptor(name: str) -> bool:
    kind = DESCRIPTOR_ALIASES.get(name.upper(), "BRIEF")
    return kind in _BINARY_KINDS


def is_bold_descriptor(name: str) -> bool:
    return DESCRIPTOR_ALIASES.get(name.upper(), "BRIEF") == "BOLD"


def detector_bands(cfg: DetectorConfig) -> int:
    """Band count of cfg's keypoint layout, or 0 when not banded (the
    scale-space detectors never band)."""
    kind = DETECTOR_ALIASES.get(cfg.kind.upper(), "FAST")
    scale_space = kind in _SCALE_SPACE_KINDS or (
        kind in ("ORB", "BRISK") and cfg.pyramid_levels > 1)
    if (
        scale_space
        or cfg.column_bands <= 0
        or cfg.max_keypoints % cfg.column_bands != 0
    ):
        return 0
    return cfg.column_bands


def _scale_space_kind(cfg: DetectorConfig) -> str | None:
    """The scale-space row of cfg ("SIFT" or "SURF"), or None for the FAST
    rows; every other detector of the JAX package is not ported yet and
    raises."""
    kind = DETECTOR_ALIASES.get(cfg.kind.upper(), "FAST")
    if kind in ("SIFT", "SURF"):
        return kind
    if kind not in _FAST_KINDS or cfg.pyramid_levels > 1:
        raise NotImplementedError(
            f"detector {cfg.kind!r} (pyramid_levels={cfg.pyramid_levels}) "
            "is not ported; single-scale FAST/ORB/BRISK, SIFT and SURF only"
        )
    return None


def _scale_space_keypoints(img: torch.Tensor, cfg: DetectorConfig,
                           kind: str) -> Keypoints:
    from matchinglib_poselib_torch.ops import scale_space

    fn = (scale_space.sift_dog_keypoints if kind == "SIFT"
          else scale_space.surf_hessian_keypoints)
    return fn(img, cfg.max_keypoints, grid_cells=cfg.grid_cells)


def fast_scores(imgs: torch.Tensor, cfg: DetectorConfig) -> torch.Tensor:
    """FAST score with fused NMS of a stack of images (B, H, W) -> (B, H,
    W): one launch of the fused kernel on the card for the whole stack."""
    from matchinglib_poselib_torch.ops.kernels import fast_nms

    return fast_nms.fast_nms_score(imgs, cfg.fast_threshold / 255.0,
                                   cfg.nms_radius)


def select_fast_keypoints(score: torch.Tensor,
                          cfg: DetectorConfig) -> Keypoints:
    """One image's keypoints from its FAST + NMS score (H, W): banded (or
    grid) top-k, then subpixel refinement."""
    bands = detector_bands(cfg)
    if bands:
        xy, sc, mask = select_keypoints_banded(
            score, cfg.max_keypoints, bands=bands, nms_radius=cfg.nms_radius,
        )
    else:
        xy, sc, mask = select_keypoints_grid(
            score, cfg.max_keypoints, cfg.grid_cells
        )
    xy = refine_subpixel(score, xy, mask)
    return Keypoints(
        xy=xy, score=sc, angle=torch.zeros_like(sc),
        scale=torch.ones_like(sc), mask=mask,
    )


def detect_keypoints(img: torch.Tensor, cfg: DetectorConfig) -> Keypoints:
    """getKeypoints equivalent (features.cpp:145): FAST score -> NMS ->
    banded (or grid) top-k -> subpixel refinement; SIFT and SURF dispatch
    to ``ops/scale_space.py``.

    Ported rows: single-scale FAST/ORB/BRISK, SIFT, SURF. Every other
    detector of the JAX package is not ported yet and raises. The image
    runs as a stack of one through ``detect_keypoints_batch``.
    """
    return detect_keypoints_batch(img[None], cfg)[0]


def detect_keypoints_batch(imgs: torch.Tensor,
                           cfg: DetectorConfig) -> list[Keypoints]:
    """``detect_keypoints`` of every image of a stack (B, H, W): the FAST
    rows score the whole stack in one call of the fused kernel and select
    per image; the scale-space rows detect image by image."""
    kind = _scale_space_kind(cfg)
    if kind is not None:
        return [_scale_space_keypoints(img, cfg, kind) for img in imgs]
    return [select_fast_keypoints(score, cfg)
            for score in fast_scores(imgs.contiguous(), cfg)]


class DescriptorTables:
    """The seeded ORB selection table on one device.

    Built from numpy with the JAX package's seed, or from arrays passed in
    (``convert.tables_from_numpy``).
    """

    def __init__(self, orb_idx: np.ndarray | None = None,
                 device: torch.device | str = "cpu"):
        if orb_idx is None:
            orb_idx = orb_selection_tables()
        self.orb_idx = torch.tensor(
            np.asarray(orb_idx, np.int64), device=device
        )


_TABLES: dict[str, DescriptorTables] = {}


def default_descriptor_tables(device) -> DescriptorTables:
    """DescriptorTables from the seeded numpy code, built once per device."""
    key = str(torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = DescriptorTables(device=device)
    return _TABLES[key]


def compute_descriptors(
    img: torch.Tensor, kps: Keypoints, cfg: DescriptorConfig,
    bands: int = 0, tables: DescriptorTables | None = None,
) -> tuple[torch.Tensor, Keypoints]:
    """getDescriptors equivalent (features.cpp:397): the steered-BRIEF
    (ORB), SIFT and M-SURF (SURF, KAZE) rows.

    Returns (descriptors, keypoints with orientation): (K, 8) int32 words
    for ORB, (K, 128) float32 for SIFT, (K, 64) float32 for M-SURF. Every
    other descriptor of the JAX package is not ported yet and raises.
    """
    kind = DESCRIPTOR_ALIASES.get(cfg.kind.upper(), "BRIEF")
    if kind not in _PORTED_DESCRIPTORS:
        raise NotImplementedError(
            f"descriptor {cfg.kind!r} is not ported; ORB, SIFT and "
            "SURF/KAZE (M-SURF) only"
        )
    patches = extract_patches(img, kps.xy, cfg.patch_size, bands=bands)
    angles = orientation_ic(patches) if cfg.oriented else torch.zeros(
        patches.shape[0], dtype=img.dtype, device=img.device
    )
    if kind == "BRIEF":
        if tables is None:
            tables = default_descriptor_tables(img.device)
        desc = brief_descriptor_orb(patches, angles, tables.orb_idx,
                                    cfg.oriented)
    elif kind == "SIFT":
        desc = sift_descriptor(patches, angles, cfg.oriented)
    else:
        from matchinglib_poselib_torch.ops import nonlinear_diffusion

        desc = nonlinear_diffusion.msurf_descriptor(patches, angles,
                                                    cfg.oriented)
    return desc, kps._replace(angle=angles)
