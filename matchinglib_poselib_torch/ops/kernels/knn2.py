"""Fused binary 2-NN search: CUDA kernel wrapper and its plain version.

Replaces the packed binary body of ``matchinglib_poselib_tpu/ops/pallas/
knn.py`` (``knn2``, ``_knn2_kernel_packed``). The kernel is
``csrc/knn2.cu``; ``knn2_plain`` is the dense Hamming matrix + validity
penalty + radius gate + lowest-index top-2, with the same outputs bit for
bit. On a CPU tensor the wrapper runs the plain version; on a CUDA tensor
it launches the kernel or raises.

Descriptors are (N, 8) int32 words (256 bits, the bit patterns of the JAX
package's uint32 words). xy_mode 0: no gate; 1: pred (N1, 2), rad2 (N1,)
squared radius per query, pts2 (N2, 2); 2: the mirrored gate of the
cross-check direction, rad2 (N2,) per candidate. Returns (d_best, d_second,
idx), each (N1,): float32 Hamming distances (BIG = 1e9 when no valid
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


def _check(t, name, dtype, shape):
    if t is None:
        raise ValueError(f"knn2: {name} is required for this xy_mode")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"knn2: {name} must be {dtype} {shape}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"knn2: {name} must be contiguous")


def knn2(desc1, desc2, valid2, pred=None, rad2=None, pts2=None,
         xy_mode: int = 0):
    """Two nearest neighbours of every desc1 row among valid desc2 rows."""
    if xy_mode not in (0, 1, 2):
        raise ValueError(f"knn2: xy_mode {xy_mode} not in (0, 1, 2)")
    if desc1.device.type == "cpu":
        return knn2_plain(desc1, desc2, valid2, pred, rad2, pts2, xy_mode)
    if desc1.device.type != "cuda":
        raise ValueError(f"knn2: unsupported device {desc1.device}")
    n1, n2 = desc1.shape[0], desc2.shape[0]
    _check(desc1, "desc1", torch.int32, (n1, WORDS))
    _check(desc2, "desc2", torch.int32, (n2, WORDS))
    _check(valid2, "valid2", torch.bool, (n2,))
    args = [desc1, desc2, valid2]
    if xy_mode:
        _check(pred, "pred", torch.float32, (n1, 2))
        _check(rad2, "rad2", torch.float32, (n1 if xy_mode == 1 else n2,))
        _check(pts2, "pts2", torch.float32, (n2, 2))
        args += [pred, rad2, pts2]
    if any(a.device != desc1.device for a in args):
        raise ValueError("knn2: all inputs must be on one device")
    dev = desc1.device
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
