"""Data parallelism of the port over a ``torch.distributed`` process group (counterpart of
``diffsim_tpu/parallel/mesh.py``).

The JAX package is single-controller SPMD: one process, a ``('data', 'model')`` mesh, pairs
sharded over ``'data'`` and ``shard_map`` around each Pallas call (``ops/pallas/spmd.py``). The
port runs one process per card, in a process group that ``torchrun`` launches, as PyTorch and
the published DiT trainer (``dist.init_process_group("nccl")``) scale:

* :func:`init_from_env` replaces ``maybe_init_distributed``;
* :func:`shard_rows` and :func:`gather_rows` replace the ``P("data")`` sharding of the pair or
  batch axis after ``pad_to_multiple``: rank r takes the r-th contiguous block of
  ``ceil(n / size)`` rows, and the all-gather restores the global order;
* :func:`all_reduce_sum_` sums the training gradients.

``metrics/registry.over_ranks`` shards each scoring call over the ranks with these (the JAX
``build_metric(args, mesh)``).

Dropped: ``make_mesh``'s ``model`` axis (every backbone fits one card), ``kernel_jit`` and the
kernel SPMD dispatch, which exist because a Pallas custom call has no SPMD partitioning rule:
here each process launches K1-K4 on its own rows, on its own device and stream.

Without a group every function acts as a group of one rank: nothing is sharded and no
collective runs.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch import nn

# a collective that one rank never joins (a mismatched call) fails after this, not hangs
TIMEOUT = datetime.timedelta(minutes=5)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, size) of this process's group; (0, 1) without one."""
    if not in_group():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_leader() -> bool:
    return world()[0] == 0


def leader_print(*args, **kwargs) -> None:
    """``print`` on rank 0 (on every process outside a group); nothing on the other ranks."""
    if is_leader():
        print(*args, **kwargs)


def local_device(device=None) -> torch.device:
    """The device the caller names, else ``cuda:LOCAL_RANK`` (``cuda:0`` outside torchrun). The
    index matters: the current CUDA device is per host thread, so a tensor made on an index-less
    ``cuda`` from another thread would land on card 0."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_from_env(device=None) -> bool:
    """Join a process group: the caller's, if it already made one (used as it stands), else the
    one ``torchrun`` describes in ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (NCCL for a card,
    gloo for the CPU). Sets this rank's CUDA device and, on the card, builds the kernels once
    per host before any rank calls one. Returns whether this process is in a group.

    A failed init raises: running on as N independent jobs would race on the same outputs."""
    if in_group():
        return True
    if not all(k in os.environ for k in TORCHRUN_ENV):
        return False
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", timeout=TIMEOUT)
    if device.type == "cuda":
        from diffsim_tpu_torch.ops.kernels import build

        build.build_on_local_leader()
    return True


def run_hint(module: str) -> None:
    """Print how to use every visible card when a process outside a group sees several."""
    if not in_group() and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        print(f"[devices] {n} CUDA devices visible and this process uses one: run "
              f"torchrun --nproc_per_node {n} -m {module} ... to use them all")


def check_world_size(num_devices: int | None, module: str) -> None:
    """``--num_devices``: None takes the group's size (1 without torchrun); any other number
    must equal it, checked before a model is built."""
    size = world()[1]
    if num_devices is not None and num_devices != size:
        raise ValueError(
            f"--num_devices {num_devices}, but this process group has {size} rank(s): one "
            f"process runs on each card, so launch torchrun --nproc_per_node {num_devices} -m "
            f"{module} ...")


def barrier() -> None:
    if in_group():
        dist.barrier()


def _backend_device() -> torch.device:
    """Where this group's collectives take their tensors: the CPU for gloo, this rank's card for
    NCCL."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def shard_rows(n: int) -> slice:
    """This rank's contiguous block of ``n`` rows, in blocks of ``ceil(n / size)``; ranks past
    the end take an empty slice."""
    rank, size = world()
    block = -(-n // size)
    start = min(rank * block, n)
    return slice(start, min(start + block, n))


def gather_rows(local: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's :func:`shard_rows` block of ``n`` rows, all-gathered in the global order, on
    ``local``'s device. Each block is padded to ``ceil(n / size)`` rows for the collective (NCCL
    takes equal sizes) and the padding is stripped; an empty block still joins."""
    rank, size = world()
    if size == 1:
        return local
    block = -(-n // size)
    dev = _backend_device()
    padded = torch.zeros((block,) + tuple(local.shape[1:]), dtype=local.dtype, device=dev)
    padded[:local.shape[0]] = local.to(dev)
    parts = [torch.empty_like(padded) for _ in range(size)]
    dist.all_gather(parts, padded)
    rows = [parts[r][:max(0, min(block, n - r * block))] for r in range(size)]
    return torch.cat(rows).to(local.device)


def all_reduce_sum_(tensors) -> None:
    """Sum ``tensors`` across the ranks in place, one collective a tensor."""
    if world()[1] == 1:
        return
    dev = _backend_device()
    for t in tensors:
        if t.device == dev:
            dist.all_reduce(t)
        else:
            moved = t.to(dev)
            dist.all_reduce(moved)
            t.copy_(moved)


def _modules(obj, seen: set) -> list[nn.Module]:
    """The modules an object of the port holds, directly or through its own objects (a scorer's
    backbone, the FFA scorer's matting model)."""
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, nn.Module):
        return [obj]
    out = []
    for value in getattr(obj, "__dict__", {}).values():
        if isinstance(value, nn.Module) or type(value).__module__.startswith("diffsim_tpu_torch"):
            out += _modules(value, seen)
    return out


def check_same_weights(obj, what: str) -> None:
    """Raise unless every rank holds the same weights in ``obj`` (a scorer, a trainer): each
    floating tensor's sum and sum of squares in float64, all-gathered and compared exactly."""
    if world()[1] == 1:
        return
    tensors = [t for m in _modules(obj, set()) for t in (*m.parameters(), *m.buffers())
               if t.is_floating_point()]
    with torch.no_grad():
        sums = torch.stack([torch.stack([t.sum(dtype=torch.float64),
                                         t.double().square().sum()]) for t in tensors])
    every = gather_rows(sums.reshape(1, -1).cpu(), world()[1])
    if not bool((every == every[0]).all()):
        bad = int((every != every[0]).any(dim=0).nonzero()[0]) // 2
        raise RuntimeError(f"{what}: the ranks hold different weights (first at tensor {bad} "
                           f"of {len(tensors)}); every rank must build from the same seed or "
                           "the same converted file")
