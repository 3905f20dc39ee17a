"""The device mesh over the process group, and the batch's placement on it.

Port of ``molnextr_tpu/parallel/mesh.py``.  The JAX package jits its step
over a ``jax.sharding.Mesh`` whose ``data`` axis splits the batch; here each
rank is one process, ``make_mesh`` lays the ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` with named axes, and every
rank holds its contiguous rows of each global batch (``shard_batch``).  A
``model`` axis carries the decoder's tensor-parallel split
(``parallel/tp.py``); ranks along it hold the same rows.

With no process group (one device, a plain launch) ``make_mesh`` returns a
:class:`TrivialMesh` of one rank, and the train step then runs exactly the
single-device step: no collective at all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from molnextr_tpu_torch.parallel.distributed import process_count


@dataclass(frozen=True)
class TrivialMesh:
    """One rank and no process group, with the ``DeviceMesh`` attributes
    the port reads (``shape``, ``mesh_dim_names``, ``device_type``,
    ``get_local_rank``)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    device_type: str

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0


def make_mesh(shape: Sequence[int] = (-1,), axis_names: Sequence[str] = ("data",),
              device="cuda"):
    """Lay the world's ranks out as ``shape`` with ``axis_names``; a single
    -1 absorbs the rest of the world.  ``device`` is this rank's device
    (its type is the mesh's).  Raises when the shape's product is not the
    world size."""
    world = process_count()
    shape = list(shape)
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape[shape.index(-1)] = world // known
    if math.prod(shape) != world or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} != {world} ranks")
    device_type = torch.device(device).type
    if not (dist.is_available() and dist.is_initialized()):
        return TrivialMesh(tuple(shape), tuple(axis_names), device_type)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def has_group(mesh) -> bool:
    """Whether the mesh runs over a process group (even a group of one)."""
    return not isinstance(mesh, TrivialMesh)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for an axis the mesh lacks."""
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(axis)] if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; 0 for an axis the mesh lacks."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def axis_group(mesh, axis: str):
    """The process group along ``axis`` (None on a trivial mesh)."""
    return mesh.get_group(axis) if has_group(mesh) and axis in mesh.mesh_dim_names else None


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Sharding(NamedTuple):
    """How a tensor lies on the mesh, as a ``PartitionSpec``: ``spec[d]`` is
    the mesh axis that splits dim ``d``, or None (replicated along it)."""

    mesh: Any
    spec: Tuple[Optional[str], ...]

    def dim_of(self, axis: str) -> Optional[int]:
        """The tensor dim that ``axis`` splits, or None."""
        return self.spec.index(axis) if axis in self.spec else None


def data_sharding(mesh) -> Sharding:
    """The batch dim split over the ``data`` axis."""
    return Sharding(mesh, ("data",))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def _rows(mesh, n: int, dim: int) -> Tuple[slice, ...]:
    per = local_batch_size(n, mesh)
    r = axis_rank(mesh, data_sharding(mesh).spec[0])
    return (slice(None),) * dim + (slice(r * per, (r + 1) * per),)


def _place(tree, fn):
    if isinstance(tree, dict):
        return {k: _place(v, fn) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global host batch (numpy or tensors), on its
    device: rows ``[r * n / D, (r + 1) * n / D)`` for data rank ``r`` of
    ``D``.  Non-array leaves (the SMILES list) are sliced alike."""
    dev = mesh_device(mesh)

    def take(x):
        rows = _rows(mesh, len(x), 0)
        return x[rows[0]] if isinstance(x, list) else torch.as_tensor(x)[rows].to(dev)

    return _place(batch, take)


def shard_batch_group(mesh, group: Dict[str, Any]) -> Dict[str, Any]:
    """A stacked ``(K, batch, ...)`` dispatch group: the leading axis kept
    whole, the batch dim split over ``data`` as in :func:`shard_batch`."""
    dev = mesh_device(mesh)
    return _place(group, lambda x: torch.as_tensor(x)[_rows(mesh, x.shape[1], 1)].to(dev))


def local_batch_size(global_batch: int, mesh) -> int:
    """Rows a rank holds of a global batch; raises unless the data axis
    divides it."""
    n = axis_size(mesh, "data")
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} data ranks")
    return global_batch // n


def pad_to_devices(n: int, mesh) -> int:
    """Smallest multiple of the data axis's rank count >= n."""
    d = axis_size(mesh, "data")
    return ((n + d - 1) // d) * d
