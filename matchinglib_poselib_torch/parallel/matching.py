"""Pod-wide kNN: descriptor matching against a database sharded over the
``db`` ranks (port of ``parallel/matching.py``).

Every rank searches the queries against its own block of the database
with the port's fused 2-NN kernels (K2a for binary words, K2b for float
descriptors; their plain versions on CPU tensors): each query's two best
shard rows. The per-shard candidates are merged after one ``all_gather``
over the ``db`` group into the exact 2-NN over the whole database. The
cross-check then searches in reverse only the rows the merged matches
name, at most N1 of them, each on the rank that owns it (each row's best
query), and a second ``all_gather`` of N1 ints hands every rank the
owners' answers. On the wire: 4 N1 S bytes per collective, (S, 3, N1)
candidates and (S, N1) reverse answers, never the distance matrix or a
per-row array. The JAX package scores its shard densely in XLA and takes
every shard row's best query; a row's best query depends on that row and
the queries alone, so the result is the same on every row, kept or not.
"""

from __future__ import annotations

import torch

from matchinglib_poselib_torch.config import LOWE_RATIO
from matchinglib_poselib_torch.ops.kernels import knn2 as _knn2
from matchinglib_poselib_torch.ops.matching import MatchResult
from matchinglib_poselib_torch.parallel import mesh as pmesh
from matchinglib_poselib_torch.utils import profiling

_BIG = 1e9


def sharded_match(
    mesh,
    desc_q: torch.Tensor,
    desc_db: torch.Tensor,
    valid_q: torch.Tensor,
    valid_db: torch.Tensor,
    binary: bool = True,
    ratio: float = LOWE_RATIO,
    ratio_test: bool = True,
    cross_check: bool = True,
) -> MatchResult:
    """Exact 2-NN of replicated queries against a database sharded over the
    ``db`` axis.

    desc_q (N1, W) int32 words (binary) or (N1, D) float descriptors, and
    valid_q (N1,), the same on every rank; desc_db (rows, W or D) and
    valid_db (rows,): this rank's block of the database (``mesh.db_block``
    of the full one; every rank's block has the same rows). Returns a
    MatchResult with global database indices, the same on every rank.
    On CUDA tensors, the forward search is one kernel call (one launch,
    or one per chunk of columns where a block is longer than one launch
    takes, ``ops/kernels/knn2.py``, so one card holds a map of any size
    its memory takes); with ``cross_check`` the reverse search is one
    more launch of at most N1 x N1. Two all-gathers with the cross-check,
    one without; no host sync.
    """
    with profiling.span("knn.sharded_match"):
        group = mesh.get_group(pmesh.DB_AXIS)
        rows = desc_db.shape[0]
        offset = pmesh.axis_index(mesh, pmesh.DB_AXIS) * rows
        vq = valid_q.to(torch.bool)
        vdb = valid_db.to(torch.bool)
        if binary:
            search = _knn2.knn2
        else:
            search = _knn2.knn2_l2
            desc_q = desc_q.to(torch.float32).contiguous()
            desc_db = desc_db.to(torch.float32).contiguous()
        n1 = desc_q.shape[0]
        with profiling.span("knn.forward", desc_q):
            d1, d2, idx = search(desc_q, desc_db, vdb)
        with profiling.span("knn.merge", desc_q):
            # an invalid query row is all _BIG in the JAX package: (1e9,
            # 1e9, 0); a row with no valid shard column comes back as
            # column -1 -> 0
            d1 = torch.where(vq, d1, _BIG)
            d2 = torch.where(vq, d2, _BIG)
            gidx = torch.where(vq, torch.clamp(idx, min=0), 0) + offset

            # merge the S shards' candidates: (S, 3, N1)
            cand = pmesh.all_gather(torch.stack(
                [d1.view(torch.int32), d2.view(torch.int32),
                 gidx.to(torch.int32)])[None], group)
            d1g = cand[:, 0].view(torch.float32)
            d2g = cand[:, 1].view(torch.float32)
            cand_d = torch.cat([d1g, d2g])  # (2S, N1)
            cand_i = torch.cat([cand[:, 2], torch.full_like(cand[:, 2], -1)])
            # stable, as jnp.argsort: ties go to the earlier shard, d1
            # before d2
            vals, order = torch.sort(cand_d, dim=0, stable=True)
            best_d, second_d = vals[0], vals[1]
            best_i = torch.gather(cand_i, 0, order[:1])[0]

            keep = vq & (best_d < _BIG * 0.5)
            if ratio_test:
                keep = keep & (best_d < ratio * second_d)
        profiling.count("knn.reverse_rows", n1 if cross_check else 0)
        if cross_check:
            with profiling.span("knn.reverse", desc_q):
                # each named row's best valid query (ties to the lowest),
                # searched on every rank at the row's local index (clamped
                # where another rank owns it) and read from the owner's
                # answers; -1 only where no query is valid, and then no
                # match is kept
                best = best_i.long()
                local = torch.clamp(best - offset, 0, rows - 1)
                _, _, back = search(desc_db.index_select(0, local), desc_q,
                                    vq)
                backg = pmesh.all_gather(back[None], group)
                owner = torch.div(best, rows, rounding_mode="floor")
                keep = keep & (torch.gather(backg, 0, owner[None])[0]
                               == torch.arange(n1, device=best.device))
        return MatchResult(idx=best_i, distance=best_d,
                           second_distance=second_d, mask=keep)
