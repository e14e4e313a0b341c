"""The (table, shard, query) device mesh over the process world.

Port of ``verticut_tpu/parallel/mesh.py``. The reference's topology — one
MPI rank per substring table, buckets spread over storage servers, query
fan-out at the front end — maps onto three axes:

* ``table`` — which substring tables a device's slice holds;
* ``shard`` — a contiguous partition of a table's rows (or, in the
  compact layout, of its prefix values);
* ``query`` — independent slices of the query batch.

Where the reference's ``Mesh`` holds every device, the port's
:class:`Mesh` is one rank's view of it: the axis sizes, this rank's
coordinates, its device, and the two process groups its collectives run
over — the (table, shard) plane of its query index (the model group:
every collective of a search) and the query line of its (table, shard)
(the query group: the results' final gather). Rank ``r`` of the world is
mesh device ``(t, s, q)`` with ``r = (t * n_shards + s) * n_query + q``,
the reference's ``reshape`` of its device list.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from verticut_tpu_torch.parallel import world

AXES = ("table", "shard", "query")


def mesh_axes() -> Sequence[str]:
    return AXES


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the mesh. ``coords`` is ``None`` on a rank the
    mesh leaves out (the reference builds a mesh over the first devices
    of the world); such a rank joins no collective of the mesh."""

    shape: Dict[str, int]
    coords: Optional[Tuple[int, int, int]]
    device: torch.device
    model_group: Optional[dist.ProcessGroup] = None
    query_group: Optional[dist.ProcessGroup] = None

    @property
    def member(self) -> bool:
        return self.coords is not None

    @property
    def n_model(self) -> int:
        """Devices of one (table, shard) plane."""
        return self.shape["table"] * self.shape["shard"]

    @property
    def model_index(self) -> int:
        """This rank's place in its (table, shard) plane, table-major:
        the reference's ``axis_index(("table", "shard"))``."""
        t, s, _ = self.coords
        return t * self.shape["shard"] + s


def make_mesh(n_tables: int, n_shards: int = 1, n_query: int = 1) -> Mesh:
    """Build the (table, shard, query) mesh over the first ``n_tables *
    n_shards * n_query`` ranks of the world. Every rank of the world must
    call it, in the same order as every other mesh: each group is made
    with ``dist.new_group`` on every rank, as torch requires."""
    need = n_tables * n_shards * n_query
    size = dist.get_world_size() if dist.is_initialized() else 0
    if size < need:
        raise ValueError(
            f"mesh {n_tables}x{n_shards}x{n_query} needs {need} devices, "
            f"have {size}")
    rank = dist.get_rank()

    def rk(t, s, q):
        return (t * n_shards + s) * n_query + q

    model_group = query_group = None
    for q in range(n_query):
        g = dist.new_group([rk(t, s, q) for t in range(n_tables)
                            for s in range(n_shards)])
        if rank < need and rank % n_query == q:
            model_group = g
    for t in range(n_tables):
        for s in range(n_shards):
            g = dist.new_group([rk(t, s, q) for q in range(n_query)])
            if rank < need and rank // n_query == t * n_shards + s:
                query_group = g
    coords = None
    if rank < need:
        coords = (rank // (n_shards * n_query), rank // n_query % n_shards,
                  rank % n_query)
    return Mesh(shape={"table": n_tables, "shard": n_shards,
                       "query": n_query},
                coords=coords, device=world.world_device(),
                model_group=model_group, query_group=query_group)


def single_device_mesh(device=None) -> Mesh:
    """1x1x1 mesh — lets the sharded code path run unmodified on one
    device. With no world joined it starts a one-rank world on
    ``device`` (by default the card, over NCCL; ``"cpu"`` over gloo)."""
    world.init_world_of_one(device)
    return make_mesh(1, 1, 1)
