"""Per-component profile of the radius step at the bench's shapes: the
port's twin of ``tools/profile_stages.py`` (and, through
:mod:`.profile_stages2`, of ``tools/profile_stages2.py``).

Times each component of the range engine's radius step
(``search/single.radius_step``) on its own, at the shapes the 1M k = 10
and k = 100 cells give it: stage 1, ``[Q, 18]`` flip masks (radii 0 and 1
at 17-bit prefixes), and stage 2, ``[Q / 8, 136]`` (radius 2):

* ``range_lookup``: every table's directory ``range_lookup`` of every
  flipped prefix;
* ``chunk_descriptors``: ``ops/chunks.chunk_descriptors`` of the ranges;
* ``fetch_score``: ``chunks.fetch_score_blocks`` (inline rows) or
  ``fetch_score_idrows`` (the compact layout) of the descriptors, one
  launch of the fetch + score kernel a table on the card;
* ``strips+merge``: every table's top-k strip by ``topk.table_topk_packed``
  and the dedup merge ``merge_strips_packed`` into an empty pool; with
  ``chunkmin``, also by ``table_topk_chunkmin_packed``, the production
  path (the ``_pos`` selections where ids pass 2^24);

then the whole fused batch through ``mih_search_dispatch`` /
``mih_search_finalize`` at k = 10 and 100 (``full``) and with
``max_enum_radius=1`` (``r<=1-only``). Each row also carries, from one
more call under ``torch.profiler``, its kernel launches, device ms and
``cudaLaunchKernel`` host seconds (``profile``).

Timing: the best of ``--reps`` single calls, each ended by a device sync
(the JAX tool's protocol; ``profile_stages2`` takes the R-rep one).

Usage: python -m verticut_tpu_torch.tools.profile_stages [--n 1000000]
[--q 8192] [--reps 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from verticut_tpu_torch import bench
from verticut_tpu_torch.bits import entry_device, shr
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.index.directory import RangeDirectory
from verticut_tpu_torch.ops import chunks, topk
from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                       mih_search_finalize, single)
from verticut_tpu_torch.tools import _profile
from verticut_tpu_torch.tools._profile import Rows

#: radius groups of the two profiled stages
STAGES = {1: (0, 1), 2: (2,)}


def stage_tag(stage: int, nq: int, h: int, cap: int, chb: int) -> str:
    return f"s{stage}[{nq},{h}masks,cap{cap},chb{chb}]"


def components(index, queries: torch.Tensor, rows: Rows, timer, *,
               tag=stage_tag, chunkmin: bool = False) -> dict:
    """Time the radius step's components at both stages' shapes into
    ``rows`` with ``timer(fn) -> ms``. Returns the stages' shapes."""
    cfg = index.cfg
    dev = index.device
    tables = index.tables
    if not isinstance(tables[0].directory, RangeDirectory):
        raise ValueError("profile_stages profiles the range engine; the "
                         "index has a bucket directory")
    pbits = tables[0].directory.pbits
    shift = cfg.s_bits - pbits
    blk = index.fetch_block()
    compact = tables[0].entry_rows is None
    w = cfg.n_words
    packed = topk.can_pack(max(t.n_entries(w) for t in tables) - 1, 32 * w)
    q_subs = index.table_subs(queries)
    m = cfg.n_tables
    shapes = {}
    for stage, group in STAGES.items():
        nq = queries.shape[0] if stage == 1 else max(64, queries.shape[0] >> 3)
        masks = single._flip_masks(pbits, group, dev)
        h = masks.shape[0]
        scfg = SearchConfig(knn=10)
        cap = single._cap_for_radius(scfg, index.n, group, pbits, blk, True)
        chb = max(4, cap // blk)
        qs, qq = q_subs[:nq], queries[:nq]
        name = tag(stage, nq, h, cap, chb)
        shapes[f"s{stage}"] = {"nq": nq, "masks": h, "cap": cap, "chb": chb}
        _profile.log(f"stage {stage}: {name}")

        def lookup():
            return [t.directory.range_lookup(
                shr(qs[:, i], shift)[:, None] ^ masks[None, :])
                for i, t in enumerate(tables)]

        rows.add(f"{name} range_lookup x{m}", timer(lookup), lookup)
        lk = lookup()

        def descs():
            return [chunks.chunk_descriptors(
                s, c, blk=blk, chb=chb,
                n_blocks=(t.entry_idrows if compact
                          else t.entry_rows).shape[0])[:3]
                for t, (s, c) in zip(tables, lk)]

        rows.add(f"{name} chunk_descriptors x{m}", timer(descs), descs)
        dd = descs()

        def fetch():
            if compact:
                return [chunks.fetch_score_idrows(t.entry_idrows, index.codes,
                                                  b, lo, hi, qq)
                        for t, (b, lo, hi) in zip(tables, dd)]
            return [chunks.fetch_score_blocks(t.entry_rows, b, lo, hi, qq,
                                              blk=blk)
                    for t, (b, lo, hi) in zip(tables, dd)]

        rows.add(f"{name} fetch_score x{m}", timer(fetch), fetch)
        fs = fetch()

        kinds = [("", topk.table_topk_packed, topk.table_topk_pos)]
        if chunkmin:
            kinds.append(("chunkmin ",
                          lambda d, i, p: topk.table_topk_chunkmin_packed(
                              d, i, p, blk),
                          lambda d, i, p: topk.table_topk_chunkmin_pos(
                              d, i, p, blk)))
        for label, sel_packed, sel_pos in kinds:
            for k in (10, 100):
                pd, pi = topk.empty_pool(nq, k, dev)

                def merge(k=k, pd=pd, pi=pi, sp=sel_packed, sq=sel_pos):
                    if packed:
                        strips = torch.cat([sp(d, i, k) for d, i in fs], -1)
                        return topk.merge_strips_packed(pd, pi, strips,
                                                        n_copies=m + 1)
                    sd, si = zip(*[sq(d, i, k) for d, i in fs])
                    return topk.merge_strips_dedup_pos(
                        pd, pi, torch.cat(sd, -1), torch.cat(si, -1))

                rows.add(f"{name} {label}strips+merge k={k}", timer(merge),
                         merge)
        del fs, dd, lk
    return shapes


def full_batches(index, queries: torch.Tensor, rows: Rows, reps: int,
                 checks: dict) -> None:
    """The whole fused batch through dispatch / finalize, best of
    ``reps``, at k = 10 and 100 and with enumeration cut at radius 1; each
    result held equal to ``mih_search``'s."""
    dev = index.device
    for k in (10, 100):
        base = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
        r1 = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=1)
        for name, sc in ((f"full k={k}", base), (f"r<=1-only k={k}", r1)):
            out = {}

            def batch(sc=sc, out=out):
                h = mih_search_dispatch(index, queries, sc)
                if h is None:
                    raise ValueError(f"{name}: the fused driver declined")
                out["res"] = mih_search_finalize(h)

            rows.add(name, _profile.best_ms(batch, dev, reps), batch)
            want = mih_search(index, queries, sc)
            checks[f"{name} equals mih_search"] = all(
                torch.equal(getattr(out["res"], f), getattr(want, f))
                for f in want._fields)


def parse(argv, doc: str, r_flag: bool = False):
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--q", type=int, default=8192)
    if r_flag:
        ap.add_argument("--r", type=int, default=8)
    else:
        ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    return ap.parse_args(argv)


def run(args, metric: str, timer, *, tag=stage_tag, chunkmin=False,
        full_reps=0, left_out=None) -> dict:
    """Build the corpus, time the components (and with ``full_reps`` the
    whole batches), print the JSON line and return it; exit 1 when a
    check fails."""
    dev = entry_device(args.device)
    _profile.log(f"{metric}: building n={args.n}")
    index = bench.make_index(args.n, dev)[0]
    queries = _profile.perturbed(index, args.q)
    rows = Rows(dev)
    shapes = components(index, queries, rows, lambda fn: timer(fn, dev),
                        tag=tag, chunkmin=chunkmin)
    checks = {}
    if full_reps:
        _profile.release(dev)
        full_batches(index, queries, rows, full_reps, checks)
    rec = {"metric": metric, "n": args.n, "q": args.q,
           "pbits": index.tables[0].directory.pbits,
           "blk": index.fetch_block(), "ms": rows.ms,
           "profile": rows.prof, "stages": shapes, "checks": checks,
           "device": str(dev)}
    if left_out:
        rec["left_out"] = left_out
    print(json.dumps(rec), flush=True)
    if _profile.fail_on(checks, metric):
        raise SystemExit(1)
    return rec


def main(argv=None):
    args = parse(argv, __doc__)
    return run(args, "profile_stages",
               lambda fn, dev: _profile.best_ms(fn, dev, args.reps),
               full_reps=args.reps)


if __name__ == "__main__":
    main()
