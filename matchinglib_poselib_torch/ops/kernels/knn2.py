"""Fused 2-NN search: CUDA kernel wrappers and their plain versions.

Two kernels replace the two bodies of ``matchinglib_poselib_tpu/ops/
pallas/knn.py`` (``knn2``):

- ``knn2`` (``csrc/knn2.cu``), the packed binary body
  (``_knn2_kernel_packed``): descriptors are (N, W) int32 words (32 W
  bits, the bit patterns of the JAX package's uint32 words); Hamming
  distances from the tensor cores' b1 AND-popc product
  (``mma.sync.m16n8k256``), exact. The kernel is built for 8 and 16
  words (256 and 512 bits) and for a runtime width, a multiple of 8
  words; on the card the wrapper pads 1 <= W < 8 to 8, 8 < W < 16 to 16
  and a wider W to the next multiple of 8 with zero words, which change
  no distance. One launch takes ``max_columns(W)`` candidates (8 column
  slices, each within the column field of the kernel's 32-bit key: 2^24
  at 8 words, 2^23 at 16); past that the wrapper launches once per chunk
  of candidates and merges the chunks' results (``merge_top2``): such a
  call counts its launches as ``knn2.chunks`` and times the merge (the
  columns made global, ``merge_top2``) as the span ``knn2.chunk_merge``
  (``utils/profiling``; ``knn2_l2.chunks`` and ``knn2_l2.chunk_merge``
  on the float path). A call of one launch does neither.
  Descriptors that are not 16-byte aligned are copied first.
  ``knn2_plain`` is the dense Hamming matrix + validity penalty + radius
  gate + lowest-index top-2 at any width, with the same outputs bit for
  bit.
- ``knn2_l2`` (``csrc/knn2_l2.cu``), the general body (``_knn2_kernel``):
  (N, D) float32 descriptors, squared L2 distances in true fp32, any
  D >= 1 (the query tile stays in shared memory at D <= 640 and streams
  through it in depth chunks past that). ``knn2_l2_plain`` is the dense
  distance matrix + penalties + the same top-2 rule; the kernel sums its
  dot products in another order, so the two agree to f32 rounding.

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
from matchinglib_poselib_torch.utils import profiling

BIG = 1e9
# descriptor widths (32-bit words) csrc/knn2.cu has fixed instantiations
# for; wider descriptors take its runtime-width kernel at a multiple of 8
KERNEL_WORDS = (8, 16)
# widest descriptor the kernel's key holds (csrc/knn2.cu, kMaxWords)
MAX_WORDS = (1 << 25) - 8
_SPLITS = 8  # column slices per launch (the kernel's cluster)
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


def key_column_bits(words: int) -> int:
    """Bits of the column field of csrc/knn2.cu's 32-bit key at `words`
    (padded) words: what 31 bits leave beside the distance field, which
    holds 0..2 * 32 words."""
    return 31 - (64 * words).bit_length()


def max_columns(words: int) -> int:
    """Most candidates one launch takes at `words` (padded) words: 8
    column slices of 2^key_column_bits each (2^24 at 8 words, 2^23 at
    16)."""
    return _SPLITS << key_column_bits(words)


def kernel_words(words: int) -> int:
    """The width the kernel runs `words`-word descriptors at (zero words
    padded): 8, 16 or the next multiple of 8."""
    if words < 1:
        raise ValueError(f"knn2: {words} words per descriptor")
    for w in KERNEL_WORDS:
        if words <= w:
            return w
    padded = -(-words // 8) * 8
    if padded > MAX_WORDS:
        raise ValueError(f"knn2: {words} words per descriptor, past the "
                         f"{MAX_WORDS} whose distances fill the kernel's key")
    return padded


def merge_top2(d_best, d_second, idx):
    """Merge the top-2 results of consecutive column chunks, (C, N1)
    each, idx global (-1 where a chunk had no candidate): the best of the
    chunks' bests, ties to the earlier chunk (its columns are the lower
    ones), and the second-best as the smaller of the winner's second and
    the other chunks' bests. Returns (d_best, d_second, idx), (N1,)."""
    n_chunks = d_best.shape[0]
    best = torch.amin(d_best, dim=0)
    order = torch.arange(n_chunks, device=d_best.device)[:, None]
    first = torch.amin(torch.where(d_best == best, order, n_chunks), dim=0,
                       keepdim=True)
    second = torch.minimum(
        torch.gather(d_second, 0, first)[0],
        torch.amin(torch.where(order == first, BIG, d_best), dim=0))
    return best, second, torch.gather(idx, 0, first)[0]


def _chunked(launch, n2, cap, fn):
    """One `launch(sl)` per chunk of `cap` candidate columns (sl the
    chunk's slice), then the chunks' columns made global and the chunks
    merged by ``merge_top2``; one launch when n2 <= cap. Past one launch,
    the launches count as ``<fn>.chunks`` and the merge is the span
    ``<fn>.chunk_merge``."""
    if n2 <= cap:
        return launch(slice(0, n2))
    outs = [launch(slice(c0, min(n2, c0 + cap)))
            for c0 in range(0, n2, cap)]
    profiling.count(f"{fn}.chunks", len(outs))
    with profiling.span(f"{fn}.chunk_merge", outs[-1]):
        d1, d2, idx = (torch.stack(x) for x in zip(*outs))
        c0 = torch.arange(0, n2, cap, dtype=idx.dtype, device=idx.device)
        idx = torch.where(idx >= 0, idx + c0[:, None], -1)
        return merge_top2(d1, d2, idx)


def _empty(dev):
    return (torch.empty((0,), dtype=torch.float32, device=dev),
            torch.empty((0,), dtype=torch.float32, device=dev),
            torch.empty((0,), dtype=torch.int32, device=dev))


def _ptr(t, xy_mode):
    return None if t is None or not xy_mode else t.data_ptr()


def _launch(lib, fn, desc1, desc2, valid2, pred, rad2, pts2, xy_mode,
            depth):
    """One kernel launch of `fn` on (desc1, desc2) and its outputs,
    counted as ``<fn>.launches``."""
    dev = desc1.device
    n1, n2 = desc1.shape[0], desc2.shape[0]
    out = (torch.empty((n1,), dtype=torch.float32, device=dev),
           torch.empty((n1,), dtype=torch.float32, device=dev),
           torch.empty((n1,), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{fn}_launch")(
            desc1.data_ptr(), desc2.data_ptr(), valid2.data_ptr(),
            _ptr(pred, xy_mode), _ptr(rad2, xy_mode), _ptr(pts2, xy_mode),
            n1, n2, depth, xy_mode, *(o.data_ptr() for o in out), stream,
        )
    _build.check(lib, fn, rc)
    profiling.count(f"{fn}.launches")
    return out


def _columns(sl, valid2, rad2, pts2, xy_mode):
    """The candidate-side inputs of one chunk of columns."""
    return (valid2[sl], rad2[sl] if xy_mode == 2 else rad2,
            pts2[sl] if xy_mode else pts2)


def knn2(desc1, desc2, valid2, pred=None, rad2=None, pts2=None,
         xy_mode: int = 0):
    """Two nearest neighbours (Hamming) of every desc1 row among valid
    desc2 rows; (N, W) int32 words, any W >= 1 and N2 up to int32's
    range."""
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
    descs = []
    for d in (desc1, desc2):
        if padded != words:
            d = torch.nn.functional.pad(d, (0, padded - words))
        elif d.data_ptr() % 16:
            d = d.clone()  # a fresh allocation: 16-byte aligned
        descs.append(d)
    desc1, desc2 = descs
    n1, n2 = desc1.shape[0], desc2.shape[0]
    if n1 == 0:
        return _empty(desc1.device)
    lib = _build.load("knn2")

    def chunk(sl):
        v, r, p = _columns(sl, valid2, rad2, pts2, xy_mode)
        return _launch(lib, "knn2", desc1, desc2[sl], v, pred, r, p, xy_mode,
                       padded)
    return _chunked(chunk, n2, max_columns(padded), "knn2")


# ---------------------------------------------------------------------------
# float descriptors: squared L2 (the general body)
# ---------------------------------------------------------------------------

# candidates per K2b launch: the wrapper launches once per chunk of this
# many columns and merges the chunks (``merge_top2``), so the kernel's
# int32 column arithmetic (2 x column into pts2) never overflows
L2_MAX_COLUMNS = 1 << 30


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
    n1, n2 = desc1.shape[0], desc2.shape[0]
    if n1 == 0:
        return _empty(desc1.device)
    lib = _build.load("knn2_l2")

    def chunk(sl):
        v, r, p = _columns(sl, valid2, rad2, pts2, xy_mode)
        return _launch(lib, "knn2_l2", desc1, desc2[sl], v, pred, r, p,
                       xy_mode, depth)
    return _chunked(chunk, n2, L2_MAX_COLUMNS, "knn2_l2")
