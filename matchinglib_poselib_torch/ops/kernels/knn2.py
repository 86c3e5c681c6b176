"""Fused 2-NN search: CUDA kernel wrappers and their plain versions.

Two kernels replace the two bodies of ``matchinglib_poselib_tpu/ops/
pallas/knn.py`` (``knn2``):

- ``knn2`` (``csrc/knn2.cu``), the packed binary body
  (``_knn2_kernel_packed``): descriptors are (N, 8) int32 words (256
  bits, the bit patterns of the JAX package's uint32 words); Hamming
  distances. ``knn2_plain`` is the dense Hamming matrix + validity penalty
  + radius gate + lowest-index top-2, with the same outputs bit for bit.
- ``knn2_l2`` (``csrc/knn2_l2.cu``), the general body (``_knn2_kernel``):
  (N, D) float32 descriptors, squared L2 distances in true fp32.
  ``knn2_l2_plain`` is the dense distance matrix + penalties + the same
  top-2 rule; the kernel sums its dot products in another order, so the
  two agree to f32 rounding.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. xy_mode 0: no gate; 1: pred (N1, 2), rad2
(N1,) squared radius per query, pts2 (N2, 2); 2: the mirrored gate of the
cross-check direction, rad2 (N2,) per candidate. Returns (d_best,
d_second, idx), each (N1,): float32 distances (BIG = 1e9 when no valid
candidate lies inside the gate) and int32 columns (-1 then).
"""

from __future__ import annotations

import torch

from matchinglib_poselib_torch.ops.kernels import _build

BIG = 1e9
WORDS = 8
_PENALTY = 1 << 16  # added to the distance field of invalid / gated keys


def knn2_plain(desc1, desc2, valid2, pred=None, rad2=None, pts2=None,
               xy_mode: int = 0):
    """Dense reference: (hamming + penalty, column) keys, min and masked
    second min per row."""
    from matchinglib_poselib_torch.ops.matching import bits_to_signs

    n1, n2 = desc1.shape[0], desc2.shape[0]
    dev = desc1.device
    if n2 == 0:
        return (torch.full((n1,), BIG, device=dev),
                torch.full((n1,), BIG, device=dev),
                torch.full((n1,), -1, dtype=torch.int32, device=dev))
    s1 = bits_to_signs(desc1)
    s2 = bits_to_signs(desc2)
    bits = s1.shape[-1]
    # +-1 products summed in f32 are exact integers (|dot| <= bits)
    ham = ((bits - s1 @ s2.T) * 0.5).to(torch.int64)
    pen = torch.where(valid2.to(torch.bool), 0, _PENALTY)[None, :]
    if xy_mode:
        dx = pred[:, None, 0] - pts2[None, :, 0]
        dy = pred[:, None, 1] - pts2[None, :, 1]
        d2 = dx * dx + dy * dy
        r2 = rad2[:, None] if xy_mode == 1 else rad2[None, :]
        pen = pen + torch.where(d2 <= r2, 0, _PENALTY)
    col = torch.arange(n2, dtype=torch.int64, device=dev)
    key = ((ham + pen) << 32) | col
    m1 = torch.amin(key, dim=1)
    m2 = torch.amin(
        key.masked_fill(key == m1[:, None], torch.iinfo(torch.int64).max),
        dim=1,
    )
    h1 = m1 >> 32
    h2 = m2 >> 32
    ok1 = h1 < _PENALTY
    d_best = torch.where(ok1, h1.to(torch.float32), BIG)
    d_second = torch.where(h2 < _PENALTY, h2.to(torch.float32), BIG)
    idx = torch.where(ok1, m1 & 0xFFFFFFFF, -1).to(torch.int32)
    return d_best, d_second, idx


def _check(t, name, dtype, shape, fn="knn2"):
    if t is None:
        raise ValueError(f"{fn}: {name} is required for this xy_mode")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{fn}: {name} must be {dtype} {shape}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_args(fn, desc1, desc2, valid2, pred, rad2, pts2, xy_mode,
                dtype, depth):
    """Validate a launch's inputs: dtype, shape, contiguity, one device."""
    if xy_mode not in (0, 1, 2):
        raise ValueError(f"{fn}: xy_mode {xy_mode} not in (0, 1, 2)")
    n1, n2 = desc1.shape[0], desc2.shape[0]
    _check(desc1, "desc1", dtype, (n1, depth), fn)
    _check(desc2, "desc2", dtype, (n2, depth), fn)
    _check(valid2, "valid2", torch.bool, (n2,), fn)
    args = [desc1, desc2, valid2]
    if xy_mode:
        _check(pred, "pred", torch.float32, (n1, 2), fn)
        _check(rad2, "rad2", torch.float32, (n1 if xy_mode == 1 else n2,),
               fn)
        _check(pts2, "pts2", torch.float32, (n2, 2), fn)
        args += [pred, rad2, pts2]
    if any(a.device != desc1.device for a in args):
        raise ValueError(f"{fn}: all inputs must be on one device")


def knn2(desc1, desc2, valid2, pred=None, rad2=None, pts2=None,
         xy_mode: int = 0):
    """Two nearest neighbours (Hamming) of every desc1 row among valid
    desc2 rows."""
    if xy_mode not in (0, 1, 2):
        raise ValueError(f"knn2: xy_mode {xy_mode} not in (0, 1, 2)")
    if desc1.device.type == "cpu":
        return knn2_plain(desc1, desc2, valid2, pred, rad2, pts2, xy_mode)
    if desc1.device.type != "cuda":
        raise ValueError(f"knn2: unsupported device {desc1.device}")
    _check_args("knn2", desc1, desc2, valid2, pred, rad2, pts2, xy_mode,
                torch.int32, WORDS)
    dev = desc1.device
    n1, n2 = desc1.shape[0], desc2.shape[0]
    d_best = torch.empty((n1,), dtype=torch.float32, device=dev)
    d_second = torch.empty((n1,), dtype=torch.float32, device=dev)
    idx = torch.empty((n1,), dtype=torch.int32, device=dev)
    if n1 == 0:
        return d_best, d_second, idx
    lib = _build.load("knn2")

    def ptr(t):
        return None if t is None or not xy_mode else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn2_launch(
            desc1.data_ptr(), desc2.data_ptr(), valid2.data_ptr(),
            ptr(pred), ptr(rad2), ptr(pts2), n1, n2, xy_mode,
            d_best.data_ptr(), d_second.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(lib, "knn2", rc)
    knn2.launches += 1
    return d_best, d_second, idx


knn2.launches = 0


# ---------------------------------------------------------------------------
# float descriptors: squared L2 (the general body)
# ---------------------------------------------------------------------------

_BN = 64  # candidate columns per tile of csrc/knn2_l2.cu
_BM = 64  # query rows per block


def _gate(dist, pred, rad2, pts2, xy_mode):
    """+BIG where the candidate lies outside the query's circle."""
    if not xy_mode:
        return dist
    dx = pred[:, None, 0] - pts2[None, :, 0]
    dy = pred[:, None, 1] - pts2[None, :, 1]
    d2 = dx * dx + dy * dy
    r2 = rad2[:, None] if xy_mode == 1 else rad2[None, :]
    return torch.where(d2 <= r2, dist, dist + BIG)


def knn2_l2_plain(desc1, desc2, valid2, pred=None, rad2=None, pts2=None,
                  xy_mode: int = 0):
    """Dense reference: max(|a|^2 + |b|^2 - 2<a, b>, 0) + penalties, then
    the top-2 of each row with a running pair that starts at (BIG,
    column -1) and wins ties (the TPU body's ``run_first = d1 <= t1``)."""
    n1, n2 = desc1.shape[0], desc2.shape[0]
    dev = desc1.device
    if n2 == 0:
        return (torch.full((n1,), BIG, device=dev),
                torch.full((n1,), BIG, device=dev),
                torch.full((n1,), -1, dtype=torch.int32, device=dev))
    a = desc1.to(torch.float32)
    b = desc2.to(torch.float32)
    sq1 = torch.sum(a * a, dim=1)
    sq2 = torch.sum(b * b, dim=1)
    dist = torch.clamp((sq1[:, None] + sq2[None, :]) - 2.0 * (a @ b.T),
                       min=0.0)
    dist = dist + torch.where(valid2.to(torch.bool), 0.0, BIG)[None, :]
    dist = _gate(dist, pred, rad2, pts2, xy_mode)
    m1 = torch.amin(dist, dim=1)
    col = torch.arange(n2, device=dev)
    i1 = torch.amin(torch.where(dist == m1[:, None], col, n2), dim=1)
    m2 = torch.amin(dist.masked_fill(col == i1[:, None], torch.inf), dim=1)
    ok = m1 < BIG
    d_best = torch.where(ok, m1, BIG)
    d_second = torch.clamp(m2, max=BIG)
    idx = torch.where(ok, i1, -1).to(torch.int32)
    return d_best, d_second, idx


def _splits(n1: int, n2: int, sm_count: int) -> tuple[int, int]:
    """(splits, columns per split) of the column sweep: enough slices that
    the grid holds >= 2 blocks per SM, each slice a whole number of
    64-column tiles."""
    row_blocks = max(1, -(-n1 // _BM))
    want = max(1, -(-2 * sm_count // row_blocks))
    tiles = max(1, -(-n2 // _BN))
    per = -(-tiles // min(want, tiles)) * _BN
    return max(1, -(-n2 // per)), per


def knn2_l2(desc1, desc2, valid2, pred=None, rad2=None, pts2=None,
            xy_mode: int = 0):
    """Two nearest neighbours (squared L2) of every desc1 row among valid
    desc2 rows; (N, D) contiguous float32 descriptors, D >= 1, on any
    device."""
    depth = desc1.shape[1] if desc1.dim() == 2 else -1
    if depth < 1:
        raise ValueError("knn2_l2: descriptors must be (N, D) with D >= 1")
    _check_args("knn2_l2", desc1, desc2, valid2, pred, rad2, pts2, xy_mode,
                torch.float32, depth)
    if desc1.device.type == "cpu":
        return knn2_l2_plain(desc1, desc2, valid2, pred, rad2, pts2,
                             xy_mode)
    if desc1.device.type != "cuda":
        raise ValueError(f"knn2_l2: unsupported device {desc1.device}")
    dev = desc1.device
    n1, n2 = desc1.shape[0], desc2.shape[0]
    d_best = torch.empty((n1,), dtype=torch.float32, device=dev)
    d_second = torch.empty((n1,), dtype=torch.float32, device=dev)
    idx = torch.empty((n1,), dtype=torch.int32, device=dev)
    if n1 == 0:
        return d_best, d_second, idx
    lib = _build.load("knn2_l2")
    splits, per = _splits(
        n1, n2, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_d1 = torch.empty((splits, n1), dtype=torch.float32, device=dev)
    part_i1 = torch.empty((splits, n1), dtype=torch.int32, device=dev)
    part_d2 = torch.empty((splits, n1), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None or not xy_mode else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn2_l2_launch(
            desc1.data_ptr(), desc2.data_ptr(), valid2.data_ptr(),
            ptr(pred), ptr(rad2), ptr(pts2), n1, n2, depth, xy_mode,
            splits, per, part_d1.data_ptr(), part_i1.data_ptr(),
            part_d2.data_ptr(), d_best.data_ptr(), d_second.data_ptr(),
            idx.data_ptr(), stream,
        )
    _build.check(lib, "knn2_l2", rc)
    knn2_l2.launches += 1
    return d_best, d_second, idx


knn2_l2.launches = 0
