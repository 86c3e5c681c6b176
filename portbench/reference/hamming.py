"""Plain exact binary 2-NN matching: the reference of the map cells.

Descriptors are (N, W) int32 words, 32 W bits. The Hamming distance of
two descriptors is (bits - s . t) / 2 for their bits as +-1 vectors s and
t; every partial sum of that dot product is an integer of magnitude at
most `bits`, exact in float16 (integers to 2048) and in float32, so the
product on the device's matrix units is exact.

``match`` is the semantics the configuration states (upstream
matchinglib's ratio test at LOWE_RATIO and cross-check, matchers.cpp):
each valid query's best and second-best valid database row (ties to the
lowest row), kept when best < ratio * second and the best row's own best
valid query (ties to the lowest query) is that query. Imports nothing of
the program.
"""

from __future__ import annotations

import torch

BIG = 1e9
BLOCK = 1 << 16        # database rows per block (16 column bits of a key)
_NONE = 511            # distance field of an invalid pair (> any distance)
_I64_MAX = torch.iinfo(torch.int64).max


def signs(words: torch.Tensor, bits: int | None = None,
          dtype=torch.float32) -> torch.Tensor:
    """(N, W) int32 words -> (N, bits) +-1 (bit set -> -1), the first
    `bits` bits (all 32 W by default)."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    b = (words[..., None] >> shifts) & 1
    b = b.reshape(words.shape[0], -1)
    if bits is not None:
        b = b[:, :bits]
    return (1 - 2 * b).to(dtype)


def _dtype(device) -> torch.dtype:
    return torch.float16 if device.type == "cuda" else torch.float32


def hamming(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) int32 Hamming distances of +-1 rows."""
    dot = (sa @ sb.T).to(torch.float32)
    return ((sa.shape[1] - dot) * 0.5).round().to(torch.int32)


def top2(q: torch.Tensor, db: torch.Tensor, valid_db: torch.Tensor,
         bits: int | None = None, block: int = BLOCK):
    """Each query's best and second-best valid database row, ties to the
    lowest row: (d1, d2, idx), float32 distances (BIG where there is no
    such row) and int64 rows (-1 where there is none)."""
    dt = _dtype(q.device)
    sq = signs(q, bits, dt)
    n1 = q.shape[0]
    best = torch.full((n1,), _I64_MAX, dtype=torch.int64, device=q.device)
    second = best.clone()
    for c0 in range(0, db.shape[0], block):
        rows = db[c0:c0 + block]
        ham = hamming(sq, signs(rows, bits, dt))
        ham = torch.where(valid_db[c0:c0 + block][None, :], ham, _NONE)
        col = torch.arange(rows.shape[0], device=q.device, dtype=torch.int32)
        key = (ham << 16) | col
        k1 = torch.amin(key, dim=1)
        k2 = torch.amin(key.masked_fill(key == k1[:, None],
                                        torch.iinfo(torch.int32).max), dim=1)
        cand = [best, second]
        for k in (k1, k2):
            h = (k >> 16).to(torch.int64)
            g = (k & 0xFFFF).to(torch.int64) + c0
            cand.append(torch.where(h < _NONE, (h << 32) | g, _I64_MAX))
        merged = torch.sort(torch.stack(cand, dim=1), dim=1).values
        best, second = merged[:, 0], merged[:, 1]

    def split(k):
        ok = k != _I64_MAX
        d = torch.where(ok, (k >> 32).to(torch.float32), BIG)
        return d, torch.where(ok, k & 0xFFFFFFFF, -1), ok
    d1, idx, _ = split(best)
    d2, _, _ = split(second)
    return d1, d2, idx


def best_query(rows: torch.Tensor, q: torch.Tensor, valid_q: torch.Tensor,
               bits: int | None = None) -> torch.Tensor:
    """For each database row, its nearest valid query, ties to the lowest
    (0 where no query is valid, as an argmin over an all-BIG row)."""
    dt = _dtype(q.device)
    ham = hamming(signs(rows, bits, dt), signs(q, bits, dt))
    ham = torch.where(valid_q[None, :], ham, _NONE)
    return torch.argmin(ham, dim=1)  # the first of equal minima


def match(q, valid_q, db, valid_db, ratio: float, ratio_test: bool = True,
          cross_check: bool = True, bits: int | None = None) -> dict:
    """Exact 2-NN with the ratio test and cross-check: {idx, distance,
    second_distance, mask} per query row. An invalid query reads (1e9,
    1e9, row 0, not kept)."""
    vq = valid_q.to(torch.bool)
    d1, d2, idx = top2(q, db, valid_db.to(torch.bool), bits)
    d1 = torch.where(vq, d1, BIG)
    d2 = torch.where(vq, d2, BIG)
    idx = torch.where(vq, torch.clamp(idx, min=0), 0)
    keep = vq & (d1 < BIG * 0.5)
    if ratio_test:
        keep = keep & (d1 < ratio * d2)
    if cross_check:
        back = best_query(db[idx], q, vq, bits)
        keep = keep & (back == torch.arange(q.shape[0], device=q.device))
    return {"idx": idx.to(torch.int32), "distance": d1,
            "second_distance": d2, "mask": keep}
