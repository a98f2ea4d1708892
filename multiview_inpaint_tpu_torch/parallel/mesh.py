"""Process-group helpers: the port's counterpart of
``multiview_inpaint_tpu/parallel/mesh.py``.

The JAX package shards arrays over a ``jax.sharding.Mesh`` and lets XLA
insert the collectives. Here every rank is one process on one device, and
the collectives are explicit ``torch.distributed`` calls in the parallel
modules. ``make_mesh``/``shard_batch``/``replicate`` map onto:

- ``init_from_env`` (torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``) or
  ``init`` (an explicit address, rank and world size), which create the
  default process group: NCCL for ``cuda``, gloo for ``cpu``;
- ``world`` and ``rank`` (1 and 0 without a process group, so every
  parallel function runs on one device as the plain loop does), of the
  default group or of a subgroup (``dist.new_group``) given as ``group``,
  as the frame-sharded path does;
- ``shard_batch``: the rank's slice of every tensor's leading dimension;
- ``replicate``: a broadcast from rank 0 into every tensor, in place;
- ``all_gather_rows``, ``all_reduce_sum`` and ``all_to_all_rows``: the
  collectives that XLA's partitioner inserted for the JAX package.

There is no ``Mesh`` object: the default group, or the subgroup passed as
``group``, is the one axis. Without a process group every helper is the
identity.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from ..utils.device import DEFAULT_DEVICE, resolve_device


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init(rank: int, world_size: int, init_method: str,
         device=DEFAULT_DEVICE) -> torch.device:
    """Create the default process group at ``init_method`` (for example
    ``tcp://localhost:29500``) and return this rank's device: ``cuda:rank
    % count`` on CUDA, the CPU otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            rank=rank, world_size=world_size)
    return dev


def init_from_env(device=DEFAULT_DEVICE) -> torch.device:
    """The process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), each rank on
    ``cuda:LOCAL_RANK``; without ``WORLD_SIZE`` nothing is created and
    the device is returned as it is (one process)."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://")
    return dev


def world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def frame_devices(t: int, world_size: int) -> int:
    """The ranks a clip of ``t`` frames is sharded over: the largest
    divisor of t that is at most the world size (the JAX CLI's rule)."""
    return max(k for k in range(1, min(t, world_size) + 1) if t % k == 0)


def _tree_map(fn, x):
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_tree_map(fn, v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def shard_batch(x: Any) -> Any:
    """This rank's slice of the leading dimension of every tensor in
    ``x`` (a tensor, or a tuple, NamedTuple, list, dict or dataclass of
    them); the
    leading dimension must divide by the world size, as the JAX
    sharding requires."""
    w, r = world(), rank()

    def cut(a):
        if a.shape[0] % w:
            raise ValueError(f"shard_batch: leading dim {a.shape[0]} does "
                             f"not divide by the world size {w}")
        n = a.shape[0] // w
        return a[r * n:(r + 1) * n]

    return _tree_map(cut, x)


def replicate(x: Any, group=None) -> Any:
    """The values of the group's rank 0 in every tensor of ``x``,
    broadcast in place (a no-op without a process group); returns ``x``."""
    if dist.is_initialized():
        src = 0 if group is None else dist.get_global_rank(group, 0)

        def bcast(a):
            dist.broadcast(a, src=src, group=group)
            return a

        _tree_map(bcast, x)
    return x


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[world * n, ...]: every rank's [n, ...] in rank order (x itself
    without a process group). Not differentiable."""
    if not dist.is_initialized():
        return x
    out = x.new_empty((world(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, in place (x itself without a
    process group); returns ``x``."""
    if dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [world * m, ...] -> [world * m, ...]: block q of the input goes to
    rank q, and block q of the output came from rank q (equal sizes; x
    itself without a process group). Not differentiable."""
    if not dist.is_initialized():
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out
