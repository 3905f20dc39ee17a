"""Process-group start-up, rank queries and the collectives of the port.

Port of ``molnextr_tpu/parallel/distributed.py``: one process per device
over ``torch.distributed``.  ``initialize`` starts the process group from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) or from explicit arguments, and is a
no-op at world 1 with neither, so a plain launch runs one device with no
process group at all.

Backends are named, never chosen behind the caller's back: ``"nccl"`` for
CUDA ranks, ``"gloo"`` for CPU ranks, and ``"gloo"`` for CUDA ranks only
when the caller names it (two ranks that share one card: NCCL refuses a
duplicate GPU, gloo stages CUDA tensors through the host).  Evaluation
gathers numeric arrays as tensors (``gather_arrays``), never Python objects;
on a single process every helper here is the identity or a no-op.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# gradient buckets of the data-parallel reduction: 16 M float32 elements
# (64 MB) a collective, so the flat copy stays small beside the model
BUCKET_NUMEL = 1 << 24


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None, device="cuda") -> torch.device:
    """Start this process's rank and return its device.

    ``world_size``/``rank``/``local_rank`` default to torchrun's
    ``WORLD_SIZE``/``RANK``/``LOCAL_RANK``, ``init_method`` to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``).  With no ``world_size`` and no
    ``WORLD_SIZE`` nothing starts and ``torch.device(device)`` comes back.
    The device is ``cuda:LOCAL_RANK`` for ``device="cuda"``, the named card
    for ``"cuda:K"`` and the CPU for ``"cpu"``; ``backend`` defaults to
    ``"nccl"`` on CUDA and ``"gloo"`` on the CPU.  Ranks that would share a
    card under ``"nccl"`` raise, naming the card."""
    env = os.environ
    if world_size is None and "WORLD_SIZE" not in env:
        return torch.device(device)
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda', 'cuda:K' or 'cpu', got {device!r}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' needs CUDA ranks; CPU ranks take 'gloo'")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if dev.index >= count:
            raise RuntimeError(
                f"rank {rank} names cuda:{dev.index}, but this machine has {count} card(s)"
                + (": ranks would share a card, which NCCL refuses; name backend='gloo' "
                   "and the card to share it" if backend == "nccl" else ""))
        torch.cuda.set_device(dev)
        torch.cuda.init()  # a mesh built later keeps this device, never LOCAL_RANK's
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    if backend == "nccl" and world_size > 1:
        _refuse_shared_cards(dev)
    return dev


def _refuse_shared_cards(dev: torch.device) -> None:
    """Raise on every rank when two NCCL ranks of one host hold one card.
    The check runs over a short-lived gloo group: NCCL itself would hang or
    fail at its first collective instead of naming the card."""
    check = dist.new_group(backend="gloo")
    try:
        seen: List[Optional[tuple]] = [None] * dist.get_world_size()
        dist.all_gather_object(seen, (socket.gethostname(), dev.index), group=check)
    finally:
        dist.destroy_process_group(check)
    for r, key in enumerate(seen):
        if seen.index(key) != r:
            name = torch.cuda.get_device_name(key[1])
            dist.destroy_process_group()
            raise RuntimeError(
                f"ranks {seen.index(key)} and {r} share cuda:{key[1]} ({name}) on {key[0]}: "
                "NCCL refuses a duplicate GPU; name backend='gloo' to share a card")


def shutdown() -> None:
    """End this rank's process group, if one was started."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """The world size; 1 with no process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 with no process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def _collective_device() -> torch.device:
    """Where this rank's collectives take their tensors: its card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_arrays(x: np.ndarray) -> np.ndarray:
    """All-gather a per-process numeric array along axis 0 (every rank
    passes the same shape); the identity at world 1.  It goes through
    ``dist.all_gather`` on a tensor, never ``all_gather_object``."""
    if process_count() <= 1:
        return np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_collective_device())
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def barrier() -> None:
    """Every rank waits for the others; a no-op with no process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _bucketed(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on flat buckets of ``tensors`` (at most
    ``BUCKET_NUMEL`` elements of one dtype each; a larger tensor goes
    alone) and copy the results back."""
    pending: List[torch.Tensor] = []

    def flush():
        if not pending:
            return
        flat = torch.cat([t.reshape(-1) for t in pending])
        collective(flat)
        torch._foreach_copy_(pending, [f.view_as(t) for f, t in
                                       zip(flat.split([t.numel() for t in pending]), pending)])
        pending.clear()

    size = 0
    for t in tensors:
        if pending and (t.dtype != pending[0].dtype or size + t.numel() > BUCKET_NUMEL):
            flush()
            size = 0
        pending.append(t)
        size += t.numel()
    flush()


@torch.no_grad()
def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum ``tensors`` over ``group`` in place, one collective a bucket."""
    _bucketed(tensors, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group))


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with global rank ``src``'s, one collective a
    bucket."""
    _bucketed(tensors, lambda flat: dist.broadcast(flat, src=src))
