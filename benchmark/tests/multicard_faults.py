"""Faults planted in the ranks of a multi-card run: each ``fault(rank)``
runs first in every rank's process (``multicard.rank_main``) and patches
the program there. A spawned rank imports this module to find the
function, so it imports neither pytest nor the tests."""

import torch

from benchmark import run
from verticut_tpu_torch.parallel import collectives
from verticut_tpu_torch.search import sharded, sharded_compact

ENGINES = ((sharded, "sharded_mih_search"),
           (sharded_compact, "sharded_compact_search"))


def _wrap(make):
    """Replace both engines' search by ``make(original)`` where the harness
    calls it; the engine's own calls of its search (the retry of
    overflowed rows) reach the original."""
    for mod, name in ENGINES:
        orig = getattr(mod, name)
        faulty, inside = make(orig), []

        def search(index, queries, scfg, _cap=None, orig=orig,
                   faulty=faulty, inside=inside):
            if inside:
                return orig(index, queries, scfg, _cap=_cap)
            inside.append(True)
            try:
                return faulty(index, queries, scfg)
            finally:
                inside.pop()
        setattr(mod, name, search)


def _altered(orig):
    def search(index, queries, scfg):
        res = orig(index, queries, scfg)
        res.ids[:, 0] += 1
        return res
    return search


def altered_rank0(rank):
    """Rank 0's answers altered where they are produced: each row's first
    id moved to the next code."""
    if rank == 0:
        _wrap(_altered)


def altered_rank1(rank):
    """The same on rank 1 alone: rank 0's answers stay right."""
    if rank == 1:
        _wrap(_altered)


def stale(rank):
    """A step that returns its state unchanged: every batch gets the
    first batch's answers, on every rank."""
    def make(orig):
        first = []

        def search(index, queries, scfg):
            res = orig(index, queries, scfg)
            first.append(first[0] if first else res)
            return first[-1]
        return search
    _wrap(make)


def half(rank):
    """Half of each batch left out, on every rank: the rest answered in
    its place."""
    def make(orig):
        def search(index, queries, scfg):
            res = orig(index, queries[:queries.shape[0] // 2], scfg)
            return type(res)(*(torch.cat([x, x]) for x in res))
        return search
    _wrap(make)


def no_exchange(rank):
    """The exchange between cards left out: each rank merges, and scans,
    only what it found itself."""
    collectives.gather_strips = lambda strips, group: strips
    collectives.gather_candidates = lambda d, i, group: (d, i)


def raises_rank1(rank):
    """Rank 1 raises at its first timed call, after rank 0 has dispatched
    the batch."""
    if rank != 1:
        return

    def make(orig):
        calls = []

        def search(index, queries, scfg):
            calls.append(1)
            if len(calls) > run.WARMUP_BATCHES:
                raise RuntimeError("a planted fault on rank 1")
            return orig(index, queries, scfg)
        return search
    _wrap(make)
