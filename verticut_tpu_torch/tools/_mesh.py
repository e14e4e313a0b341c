"""The command-line tools' ``--mesh TxSxQ``: run a function on every rank
of a (table, shard, query) mesh of the port's process world.

* Under ``torchrun`` (``WORLD_SIZE`` in the environment) this process is
  one rank of the world torchrun describes: it joins it
  (``parallel.world.init_world``), and ``T*S*Q`` must equal its size.
* Otherwise ``T*S*Q`` ranks start on this host
  (``parallel.world.spawn``): on ``device="cuda"`` rank r runs on card r
  over NCCL, on ``device="cpu"`` the ranks are gloo CPU processes.

Only rank 0's result comes back, so only rank 0 prints: :func:`run`
returns ``None`` on every other rank of a torchrun world. ``fn`` must be
importable by its module and name (a spawned rank imports its module).
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional, Tuple

import torch


def parse(text: str) -> Tuple[int, int, int]:
    """``"TxSxQ"`` -> ``(T, S, Q)``."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"--mesh wants TxSxQ with positive sizes, got "
                         f"{text!r}")
    return shape


def _rank(rank: int, fn, shape, args) -> Any:
    from verticut_tpu_torch.parallel import make_mesh
    return fn(make_mesh(*shape), *args)


def run(fn, shape: Tuple[int, int, int], device: torch.device,
        *args) -> Optional[Any]:
    """``fn(mesh, *args)`` on every rank of a ``shape`` mesh; returns rank
    0's result (``None`` on the other ranks of a torchrun world)."""
    from verticut_tpu_torch.parallel import make_mesh, world
    need = math.prod(shape)
    kind = torch.device(device).type
    if "WORLD_SIZE" not in os.environ:
        return world.spawn(_rank, need, fn, shape, args, device=kind)[0]
    import torch.distributed as dist
    world.init_world(device="cpu" if kind == "cpu" else None)
    try:
        if dist.get_world_size() != need:
            raise ValueError(f"mesh {'x'.join(map(str, shape))} needs "
                             f"{need} ranks; torchrun started "
                             f"{dist.get_world_size()}")
        rank = dist.get_rank()
        out = fn(make_mesh(*shape), *args)
    finally:
        world.close_world()
    return out if rank == 0 else None
