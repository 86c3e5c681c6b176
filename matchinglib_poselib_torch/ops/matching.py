"""Exact descriptor matching (port of ``ops/matching.py``).

2-NN search with the Lowe ratio test, the low-texture ratio fallback, an
optional mutual cross-check and the GMbSOF radius gate. The search is a
fused 2-NN kernel (``ops/kernels/knn2.py``): Hamming for binary words
(``knn2``), squared L2 for float descriptors (``knn2_l2``); on CUDA
tensors the hand-written CUDA kernels, on CPU tensors their plain versions
— the JAX package's Pallas (knn2) branch of ``match_descriptors``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from matchinglib_poselib_torch.config import LOWE_RATIO
from matchinglib_poselib_torch.ops.kernels import knn2 as _knn2

_BIG = 1e9


class MatchResult(NamedTuple):
    """Fixed-shape match set: one slot per query keypoint."""

    idx: torch.Tensor  # (N1,) int32 index into set 2 (valid slots only)
    distance: torch.Tensor  # (N1,) best distance
    second_distance: torch.Tensor  # (N1,) 2nd-best distance
    mask: torch.Tensor  # (N1,) bool — match kept

    @property
    def n_matches(self):
        return torch.sum(self.mask.to(torch.int32))


def bits_to_signs(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack (N, W) int32 bit-packed descriptors to (N, 32*W) +-1 values."""
    n, w = desc.shape
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[:, :, None] >> shifts) & 1
    return (bits.to(dtype) * 2.0 - 1.0).reshape(n, w * 32)


def hamming_distance_matrix(d1: torch.Tensor, d2: torch.Tensor):
    """(N1, W) x (N2, W) packed words -> (N1, N2) float32 Hamming distances
    via the +-1 product identity ham = (bits - <s1, s2>) / 2 (exact)."""
    s1 = bits_to_signs(d1)
    s2 = bits_to_signs(d2)
    return 0.5 * (s1.shape[-1] - s1 @ s2.T)


def l2_distance_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N1, D) x (N2, D) float -> (N1, N2) squared L2 distances."""
    d1 = d1.to(torch.float32)
    d2 = d2.to(torch.float32)
    sq1 = torch.sum(d1 * d1, dim=-1, keepdim=True)
    sq2 = torch.sum(d2 * d2, dim=-1, keepdim=True)
    return torch.clamp(sq1 + sq2.T - 2.0 * (d1 @ d2.T), min=0.0)


def _top2(dist: torch.Tensor):
    """Row-wise two smallest distances + argmin (ties to the lowest id)."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., 0], vals[..., 1], idx[..., 0]


def _ratio_fallback_keep(keep, keep_no_ratio, d_best, d_second):
    """Best-ratio fallback for low-texture frames
    (ratioMatches_Flann.cpp:91-110): with fewer than 30 ratio-test
    survivors keep the best-ratio candidates instead — half of them when
    60 < n <= 120, 60 when n > 120, never one with ratio > 0.85."""
    n_kept = torch.sum(keep.to(torch.int32))
    ratios = torch.where(
        keep_no_ratio & (d_second > 1e-12),
        d_best / torch.clamp(d_second, min=1e-12),
        torch.inf,
    )
    n_base = torch.sum(keep_no_ratio.to(torch.int32))
    target = torch.where(
        n_base > 120, 60, torch.where(n_base > 60, n_base // 2, n_base)
    )
    target = torch.minimum(target, torch.sum((ratios <= 0.85).to(torch.int32)))
    rank = torch.argsort(torch.argsort(ratios, stable=True), stable=True)
    keep_fb = keep_no_ratio & (rank < target)
    return torch.where(n_kept < 30, keep_fb, keep)


def match_descriptors(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    binary: bool = True,
    ratio_test: bool = True,
    ratio: float = LOWE_RATIO,
    cross_check: bool = True,
    max_distance: float | None = None,
    guide_pred: torch.Tensor | None = None,
    guide_rad: torch.Tensor | None = None,
    pts2_xy: torch.Tensor | None = None,
    ratio_fallback: bool = True,
) -> MatchResult:
    """Exact 2-NN matching with ratio test and optional mutual cross-check.

    desc1: (N1, 8), desc2: (N2, 8) int32 words (binary) or (N1, D), (N2, D)
    float descriptors (binary=False, squared L2 distances); valid1/valid2
    mask padded slots. Guided matching (GMbSOF guidedMatching,
    match_statOptFlow.cpp:4410): pass guide_pred (N1, 2), guide_rad (N1,)
    and pts2_xy (N2, 2) to restrict query i's candidates to a circle
    around its predicted position.
    """
    guided = guide_pred is not None
    v1 = valid1.to(torch.bool)
    v2 = valid2.to(torch.bool)
    rad2 = guide_rad * guide_rad if guided else None
    if binary:
        search = _knn2.knn2
    else:
        search = _knn2.knn2_l2
        desc1 = desc1.to(torch.float32).contiguous()
        desc2 = desc2.to(torch.float32).contiguous()
    d_best, d_second, idx = search(
        desc1, desc2, v2, guide_pred, rad2, pts2_xy,
        xy_mode=1 if guided else 0,
    )
    idx = torch.clamp(idx, min=0)
    keep = v1 & (d_best < _BIG * 0.5)
    if max_distance is not None:
        keep = keep & (d_best <= max_distance)
    if cross_check:
        # backward top-1 under the mirrored gate
        _, _, back = search(
            desc2, desc1, v1, pts2_xy, rad2, guide_pred,
            xy_mode=2 if guided else 0,
        )
        n1 = desc1.shape[0]
        keep = keep & (
            back[idx.long()] == torch.arange(n1, device=desc1.device)
        )
    if ratio_test:
        keep_no_ratio = keep
        keep = keep & (d_best < ratio * d_second)
        if ratio_fallback:
            keep = _ratio_fallback_keep(keep, keep_no_ratio, d_best, d_second)
    return MatchResult(
        idx=idx.to(torch.int32), distance=d_best, second_distance=d_second,
        mask=keep,
    )


def estimate_inlier_ratio_from_ratios(result: MatchResult) -> torch.Tensor:
    """Inlier-ratio estimate from the distance-ratio distribution
    (ratioMatches_Flann.cpp:150-200): the share of kept matches with ratio
    < 0.6, clipped to [0.05, 0.95]."""
    r = result.distance / torch.clamp(result.second_distance, min=1e-12)
    good = (r < 0.6) & result.mask
    n = torch.clamp(torch.sum(result.mask.to(torch.float32)), min=1.0)
    return torch.clamp(torch.sum(good.to(torch.float32)) / n, 0.05, 0.95)


# All names accepted by the reference's getMatches dispatch
# (matchers.cpp:137-527); each maps to the exact engine, GMBSOF adds the
# SOF-guided second pass (models/pipeline.py).
SUPPORTED_MATCHERS = (
    "GMBSOF", "CASHASH", "SWGRAPH", "HNSW", "VPTREE", "MVPTREE", "GHTREE",
    "LISTCLU", "SATREE", "BRUTEFORCENMS", "ANNOY", "HIRCLUIDX", "HIRKMEANS",
    "LINEAR", "LSHIDX", "RANDKDTREE", "LKOF", "LKOFT", "ALKOF", "ALKOFT",
)


def is_matcher_supported(name: str) -> bool:
    return name.upper() in SUPPORTED_MATCHERS
