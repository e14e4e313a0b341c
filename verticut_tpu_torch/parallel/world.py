"""The process world of the multi-device engines: one process per device.

The port runs a mesh as SPMD on ``torch.distributed``: every device has
its own process (its own interpreter, so each device's host dispatch runs
beside the others'), NCCL joins CUDA devices and gloo CPU processes. This
module stands where the reference calls ``jax.distributed.initialize``
(``tools/multiproc_demo.py``):

* :func:`init_world` joins the world this process belongs to: the one
  ``torchrun`` describes in the environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or the one given by an
  ``init_method`` URL (a ``file://`` store) with its rank and size;
* :func:`spawn` starts a world of ``world_size`` processes on this host
  with ``torch.multiprocessing``, rendezvousing through a file store in a
  temporary directory (no TCP port is reserved, so several worlds may
  start at once), runs ``fn(rank, *args)`` in each and returns their
  results.

A world on the card uses NCCL and a CPU world gloo; there is no fallback
from one to the other, so a CUDA tensor never passes through gloo.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Any, List, Optional

import torch
import torch.distributed as dist

#: how long a collective may wait for its peers before the world fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_device: Optional[torch.device] = None
#: the store directory of a world started by :func:`init_world_of_one`,
#: removed by :func:`close_world`
_store_dir: Optional[str] = None


def init_world(backend: Optional[str] = None, *,
               init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               local_rank: Optional[int] = None, device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT
               ) -> torch.device:
    """Join the process world and return this rank's device.

    Without ``init_method`` the world is the one ``torchrun`` describes
    in the environment (``env://``); with it, ``rank`` and ``world_size``
    must be given. ``device``: ``"cpu"`` for a CPU world, else the card
    (``cuda:LOCAL_RANK``, made the current device; raising where there is
    none). ``backend`` defaults to NCCL on the card and gloo on the CPU.
    A second call returns the device of the world already joined."""
    global _device
    if dist.is_initialized():
        return world_device()
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank or 0))
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the world runs on the card "
                               "by default; pass device='cpu' for a CPU "
                               "world")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("gloo" if cpu else "nccl")
    if init_method is None:
        dist.init_process_group(backend, timeout=timeout)
    else:
        if rank is None or world_size is None:
            raise ValueError("init_method needs rank and world_size")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    _device = dev
    return dev


def world_device() -> torch.device:
    """This rank's device in the world joined by :func:`init_world`."""
    if _device is None:
        raise RuntimeError("no world joined: call init_world() first")
    return _device


def init_world_of_one(device=None) -> torch.device:
    """Start a world of this process alone on ``device`` (by default the
    card, over NCCL; ``"cpu"`` over gloo), rendezvousing through a file
    store in a temporary directory that :func:`close_world` removes."""
    global _store_dir
    if dist.is_initialized():
        return world_device()
    store_dir = tempfile.mkdtemp(prefix="vt_world_")
    store = os.path.join(store_dir, "store")
    try:
        dev = init_world(init_method=f"file://{store}", rank=0,
                         world_size=1, device=device)
    except BaseException:
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    _store_dir = store_dir
    return dev


def close_world() -> None:
    """Leave the world (every rank calls it)."""
    global _device, _store_dir
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None
    if _store_dir is not None:
        shutil.rmtree(_store_dir, ignore_errors=True)
        _store_dir = None


def _rank_main(rank: int, fn, world_size: int, store_dir: str, device,
               threads: int, args) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_world(init_method=f"file://{os.path.join(store_dir, 'store')}",
               rank=rank, world_size=world_size, local_rank=rank,
               device=device)
    try:
        out = fn(rank, *args)
    finally:
        close_world()
    with open(os.path.join(store_dir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world_size: int, *args, device=None,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` in a new world of ``world_size`` processes
    and return each rank's result, by rank. ``fn`` must be importable by
    its module and name (a spawned process imports that module; keep it
    free of heavy imports). ``device``: by default the card (NCCL, rank r
    on card r; raising where this host has fewer than ``world_size``
    cards), ``"cpu"`` for a gloo world. ``threads``: intra-op threads per
    rank, by default this host's cores shared out among the ranks. A rank
    that raises ends the world and raises here."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have == 0:
            raise RuntimeError("no CUDA device: the world runs on the card "
                               "by default; pass device='cpu' for a CPU "
                               "world")
        if have < world_size:
            raise RuntimeError(
                f"a world of {world_size} ranks on the card needs "
                f"{world_size} CUDA devices, one per rank; this host has "
                f"{have}")
    device = "cpu" if cpu else "cuda"
    import torch.multiprocessing as mp
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    store_dir = tempfile.mkdtemp(prefix="vt_world_")
    try:
        mp.spawn(_rank_main, args=(fn, world_size, store_dir, device,
                                   threads, args),
                 nprocs=world_size, join=True)
        out = []
        for r in range(world_size):
            with open(os.path.join(store_dir, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
