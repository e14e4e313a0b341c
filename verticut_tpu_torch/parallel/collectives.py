"""Collective primitives — the ``mpi_coordinator`` analog on
``torch.distributed``.

Port of ``verticut_tpu/parallel/collectives.py``. Each function runs over
one process group of the mesh (``Mesh.model_group``, the (table, shard)
plane, for every collective of a search) and must be called by every rank
of that group, in the same order:

| reference (src/mpi_coordinator.cc)         | here                          |
|--------------------------------------------|-------------------------------|
| ``gather_vectors`` (Gather+Gatherv->MASTER)| :func:`gather_candidates`:    |
|                                            | fixed-capacity all_gather;    |
|                                            | the merge is replicated       |
| ``bcast`` of the stop flag (:26-28)        | replicated predicate /        |
|                                            | :func:`reduce_any`            |
| ``bitwise_or`` = MPI_Reduce(BOR) (:17-19)  | :func:`reduce_bitmap_or`      |
| ``synchronize`` = MPI_Barrier              | implicit in the collectives   |

gloo reduces neither ``bool`` nor ``uint32`` tensors, so flags travel as
int32 (as the reference's ``reduce_any`` sums them) and codes as the
port's int32 bit patterns.

Each collective runs in a span named by its operation
(``coll.all_gather``, ``coll.all_reduce``) and adds 1 to the counter
``coll.calls`` and this rank's input bytes to ``coll.bytes``, from the
shape the host holds (:mod:`verticut_tpu_torch.utils.timer`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from verticut_tpu_torch.utils.timer import count, span


def _counted(x: torch.Tensor) -> None:
    count("coll.calls")
    count("coll.bytes", x.numel() * x.element_size())


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[...] -> [D, ...]``, stacked in the group's rank order."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    with span("coll.all_gather"):
        _counted(x)
        dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """Reduce ``x`` across the group, in place."""
    with span("coll.all_reduce"):
        _counted(x)
        dist.all_reduce(x, op=op, group=group)


def _flatten_devices(g: torch.Tensor) -> torch.Tensor:
    """``[D, Q, C] -> [Q, D*C]``, device-major within each row."""
    return g.movedim(0, 1).reshape(g.shape[1], g.shape[0] * g.shape[2])


def gather_candidates(cand_dist: torch.Tensor, cand_id: torch.Tensor,
                      group) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather fixed-capacity candidate buffers over the group:
    ``[Q, C] -> [Q, D*C]`` on every rank (the reference's variable-length
    ``MPI_Gatherv`` to rank 0, ``mpi_coordinator.cc:34-69``, made fixed
    capacity with a replicated merge). Both buffers travel in one
    collective."""
    g = _all_gather(torch.stack([cand_dist, cand_id]), group)  # [D,2,Q,C]
    return _flatten_devices(g[:, 0]), _flatten_devices(g[:, 1])


def gather_strips(strips: torch.Tensor, group) -> torch.Tensor:
    """All-gather one pre-merged strip array ``[Q, S] -> [Q, D*S]``."""
    return _flatten_devices(_all_gather(strips, group))


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather row slices ``[R, ...] -> [D*R, ...]`` in rank order: the
    query axis's gather of a split batch (the reference's
    ``out_specs=P("query")``)."""
    g = _all_gather(x, group)
    return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))


def reduce_any(flag: torch.Tensor, group) -> torch.Tensor:
    """Logical OR of a boolean tensor across the group."""
    x = flag.to(torch.int32)
    _all_reduce(x, group)
    return x > 0


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum across the group (a new tensor; ``x`` is left as it is)."""
    x = x.clone()
    _all_reduce(x, group)
    return x


def reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Maximum across the group (a new tensor)."""
    x = x.clone()
    _all_reduce(x, group, dist.ReduceOp.MAX)
    return x


def reduce_bitmap_or(words: torch.Tensor, group,
                     disjoint: bool = False) -> torch.Tensor:
    """Bitwise OR of int32 bitmap words across the group (the
    ``MPI_Reduce(BOR)`` analog, ``mpi_coordinator.cc:17-19``).
    ``disjoint=True``: the ranks set no bit in common, so one sum is
    exact (no carries); otherwise all-gather and OR locally."""
    if disjoint:
        return reduce_sum(words, group)
    g = _all_gather(words, group)
    out = g[0].clone()
    for i in range(1, g.shape[0]):
        out |= g[i]
    return out
