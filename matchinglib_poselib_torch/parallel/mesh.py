"""Device mesh and collectives on torch.distributed (port of
``parallel/mesh.py``).

One ``DeviceMesh`` with two named dimensions over the default process
group, as the JAX package's ``Mesh`` has two axes:

- ``pairs``: data parallelism over image pairs and frame windows;
- ``db``: sharding of descriptor databases (pod-wide kNN) and of point
  blocks (distributed BA).

Ranks are laid out row-major, as ``np.asarray(devices).reshape(n // db,
db)`` lays out devices: rank r sits at (r // db, r % db). The package
never starts a world: the caller calls ``torch.distributed.
init_process_group`` in every rank (NCCL with one rank per card; gloo on
the CPU, and for ranks that share one card), as the JAX package's callers
call ``jax.distributed.initialize``.

A ``NamedSharding`` places equal contiguous blocks of axis 0 on the
devices along a mesh axis; ``block`` gives this rank's block, and
``all_gather`` over the same axis puts the blocks back together. gloo
takes CUDA tensors for both collectives used here (``all_reduce``,
``all_gather_into_tensor``), so every tensor stays on its device. Each
collective adds 1 to the counter ``collectives`` and the bytes of its
result on this rank to ``collective_bytes`` (``utils/profiling``): the
data the algorithm moves, whether or not it crosses a wire.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from matchinglib_poselib_torch.utils import profiling

PAIRS_AXIS = "pairs"
DB_AXIS = "db"


def mesh_shape(n: int, db_parallelism: int | None = None) -> tuple[int, int]:
    """(pairs, db) sizes of the mesh over n ranks: 2-way db when n >= 4,
    else 1, then decremented until it divides n (``make_mesh``'s rule in
    the JAX package)."""
    if n < 1:
        raise ValueError(f"mesh_shape: {n} ranks")
    if db_parallelism is None:
        db_parallelism = 2 if n >= 4 else 1
    if db_parallelism < 1:
        raise ValueError(f"mesh_shape: db_parallelism {db_parallelism}")
    while n % db_parallelism != 0:
        db_parallelism -= 1
    return n // db_parallelism, db_parallelism


def make_mesh(db_parallelism: int | None = None, device="cuda"):
    """The ("pairs", "db") ``DeviceMesh`` over the default process group,
    of ``device``'s type (the card unless the caller asks for the CPU).

    RuntimeError without an initialized process group, or for a CUDA
    device without a card (no fallback to the CPU). Every rank of the
    world calls it (its groups are made collectively)."""
    from torch.distributed.device_mesh import DeviceMesh

    from matchinglib_poselib_torch.apps.common import cli_device

    device = cli_device(device, "make_mesh")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call torch.distributed."
            "init_process_group in every rank first")
    n = dist.get_world_size()
    pairs, db = mesh_shape(n, db_parallelism)
    return DeviceMesh(device.type, torch.arange(n).reshape(pairs, db),
                      mesh_dim_names=(PAIRS_AXIS, DB_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def block(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """This rank's contiguous equal block of x along dim 0 over `axis` (a
    ``NamedSharding`` of ``P(axis)``); ValueError when the length does
    not divide the axis."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"block: {x.shape[0]} rows do not divide the "
                         f"{axis!r} axis of size {n}")
    rows = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * rows:(i + 1) * rows]


def pairs_block(mesh, x: torch.Tensor) -> torch.Tensor:
    """``pairs_sharding``: this rank's block of a batch of pairs."""
    return block(mesh, x, PAIRS_AXIS)


def db_block(mesh, x: torch.Tensor) -> torch.Tensor:
    """``db_sharding``: this rank's block of a database's rows."""
    return block(mesh, x, DB_AXIS)


def replicated(mesh, x: torch.Tensor) -> torch.Tensor:
    """``replicated``: every rank holds all of x."""
    return x


def _count(result: torch.Tensor) -> None:
    profiling.count("collectives")
    profiling.count("collective_bytes", result.numel() * result.element_size())


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the ranks of `group` (a new contiguous tensor when x
    is not contiguous; x itself, summed in place, otherwise)."""
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    _count(x)
    return x


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The blocks x (rows, ...) of the ranks of `group`, concatenated along
    dim 0 in rank order: (ranks * rows, ...). Every rank's x has the same
    shape."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    _count(out)
    return out


def gather_axis(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The inverse of ``block``: the full array from every rank's block
    along `axis`."""
    return all_gather(x, mesh.get_group(axis))


def sum_axis(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """x summed over the ranks along `axis` (``lax.psum``)."""
    return all_reduce(x, mesh.get_group(axis))
