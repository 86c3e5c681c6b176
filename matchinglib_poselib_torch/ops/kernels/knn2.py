"""Fused 2-NN search: CUDA kernel wrappers and their plain versions.

Two kernels replace the two bodies of ``matchinglib_poselib_tpu/ops/
pallas/knn.py`` (``knn2``):

- ``knn2`` (``csrc/knn2.cu``), the packed binary body
  (``_knn2_kernel_packed``): descriptors are (N, W) int32 words (32 W
  bits, the bit patterns of the JAX package's uint32 words); Hamming
  distances from the tensor cores' b1 AND-popc product
  (``mma.sync.m16n8k256``), exact. The kernel is built for 8 and 16
  words (256 and 512 bits); on the card the wrapper pads 1 <= W < 8 to 8
  and 8 < W < 16 to 16 with zero words, which change no distance, and
  refuses W > 16 (no descriptor row is wider: BOLD's 32 words go
  through its own masked matcher). ``knn2_plain`` is the dense Hamming
  matrix + validity penalty + radius gate + lowest-index top-2 at any
  width, with the same outputs bit for bit. On the card n2 <=
  ``max_columns(W)`` (2^21 at 8 words, 2^20 at 16: the column field of
  the kernel's 32-bit key) and the descriptors are 16-byte aligned.
- ``knn2_l2`` (``csrc/knn2_l2.cu``), the general body (``_knn2_kernel``):
  (N, D) float32 descriptors, squared L2 distances in true fp32.
  ``knn2_l2_plain`` is the dense distance matrix + penalties + the same
  top-2 rule; the kernel sums its dot products in another order, so the
  two agree to f32 rounding. On the card D <= 640 (the kernel keeps its
  query tile in shared memory at full depth).

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
# descriptor widths (32-bit words) csrc/knn2.cu is built for
KERNEL_WORDS = (8, 16)
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


def max_columns(words: int) -> int:
    """Most candidates the kernel takes at `words` (padded) words: the
    column field of csrc/knn2.cu's 32-bit key, 21 bits at 256 bits and 20
    at 512 (the distance field needs 11 bits there)."""
    return 1 << (21 if words <= 8 else 20)


def kernel_words(words: int) -> int:
    """The width the kernel runs `words`-word descriptors at (zero words
    padded), or ValueError for a width it does not take."""
    for w in KERNEL_WORDS:
        if 1 <= words <= w:
            return w
    raise ValueError(f"knn2: {words} words per descriptor; the kernel takes "
                     f"1..{KERNEL_WORDS[-1]}")


def knn2(desc1, desc2, valid2, pred=None, rad2=None, pts2=None,
         xy_mode: int = 0):
    """Two nearest neighbours (Hamming) of every desc1 row among valid
    desc2 rows; (N, W) int32 words, 1 <= W <= 16 on the card."""
    if xy_mode not in (0, 1, 2):
        raise ValueError(f"knn2: xy_mode {xy_mode} not in (0, 1, 2)")
    if desc1.device.type == "cpu":
        return knn2_plain(desc1, desc2, valid2, pred, rad2, pts2, xy_mode)
    if desc1.device.type != "cuda":
        raise ValueError(f"knn2: unsupported device {desc1.device}")
    words = desc1.shape[1] if desc1.dim() == 2 else -1
    _check_args("knn2", desc1, desc2, valid2, pred, rad2, pts2, xy_mode,
                torch.int32, words)
    padded = kernel_words(words)
    if padded != words:
        desc1 = torch.nn.functional.pad(desc1, (0, padded - words))
        desc2 = torch.nn.functional.pad(desc2, (0, padded - words))
    dev = desc1.device
    n1, n2 = desc1.shape[0], desc2.shape[0]
    if n2 > max_columns(padded):
        raise ValueError(f"knn2: {n2} candidates, the kernel takes at most "
                         f"{max_columns(padded)} at {padded} words")
    if desc1.data_ptr() % 16 or desc2.data_ptr() % 16:
        raise ValueError("knn2: descriptors must be 16-byte aligned")
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
            ptr(pred), ptr(rad2), ptr(pts2), n1, n2, padded, xy_mode,
            d_best.data_ptr(), d_second.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(lib, "knn2", rc)
    knn2.launches += 1
    return d_best, d_second, idx


knn2.launches = 0


# ---------------------------------------------------------------------------
# float descriptors: squared L2 (the general body)
# ---------------------------------------------------------------------------

MAX_DEPTH = 640  # csrc/knn2_l2.cu keeps the query tile at full depth


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
    if depth > MAX_DEPTH:
        raise ValueError(f"knn2_l2: depth {depth}, the kernel takes at most "
                         f"{MAX_DEPTH}")
    dev = desc1.device
    n1, n2 = desc1.shape[0], desc2.shape[0]
    d_best = torch.empty((n1,), dtype=torch.float32, device=dev)
    d_second = torch.empty((n1,), dtype=torch.float32, device=dev)
    idx = torch.empty((n1,), dtype=torch.int32, device=dev)
    if n1 == 0:
        return d_best, d_second, idx
    lib = _build.load("knn2_l2")

    def ptr(t):
        return None if t is None or not xy_mode else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn2_l2_launch(
            desc1.data_ptr(), desc2.data_ptr(), valid2.data_ptr(),
            ptr(pred), ptr(rad2), ptr(pts2), n1, n2, depth, xy_mode,
            d_best.data_ptr(), d_second.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(lib, "knn2_l2", rc)
    knn2_l2.launches += 1
    return d_best, d_second, idx


knn2_l2.launches = 0
