"""Tier ablation of the fused pipeline: the port's twin of
``tools/profile_tiers.py``.

Times the whole fused pipeline (``tools/_profile.fused_variant``: the
packed result row of ``search/single._fused_row``, on the caller's
thread) with the overflow retry ladder and the scan ladder each on and
off, at k = 10 and k = 100, so that the differences attribute a batch's
time to the stages and to each tier. The JAX tool passes no dominance
gate and no merged ladder, and neither does this one. Per variant it
prints the rows the pipeline finished (``done``) and those whose
candidate budget overflowed (``overflow``), decoded from the packed
row's flags word (bits 0 and 1).

Timing: the best of ``--reps`` single calls, each ended by a device sync,
after a warm-up; one more call under ``torch.profiler`` gives each
variant's launches, device ms and ``cudaLaunchKernel`` host seconds. Each
variant's row, finished by the host fallbacks as finalize finishes it,
must equal ``mih_search``'s answer (dists and ids), or the tool exits 1.

The JAX tool's size is fixed at 1M codes and 8192 queries; here ``--n``
and ``--q`` take those defaults.

Usage: python -m verticut_tpu_torch.tools.profile_tiers [--n 1000000]
[--q 8192] [--reps 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from verticut_tpu_torch import bench
from verticut_tpu_torch.bits import entry_device
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.search import mih_search
from verticut_tpu_torch.tools import _profile
from verticut_tpu_torch.tools._profile import Rows

#: (retry, scan) of each variant, in the JAX tool's order
VARIANTS = ((True, True), (False, True), (True, False), (False, False))


def variant_kwargs(retry: bool, scan: bool) -> dict:
    """The variant's ``fused_variant`` switches: no dominance gate and no
    merged ladder, as the JAX tool runs ``fused_pipeline_packed``."""
    return dict(retry=retry, scan=scan, dominance=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    _profile.log(f"tiers: building n={args.n}")
    index = bench.make_index(args.n, dev)[0]
    queries = _profile.perturbed(index, args.q)
    rows = Rows(dev)
    done, overflow, checks = {}, {}, {}
    for k in (10, 100):
        scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
        want = mih_search(index, queries, scfg)
        for retry, scan in VARIANTS:
            name = f"k={k} retry={int(retry)} scan={int(scan)}"
            kw = variant_kwargs(retry, scan)

            def go(kw=kw):
                return _profile.fused_variant(index, queries, scfg, **kw)

            rows.add(name, _profile.best_ms(go, dev, args.reps), go)
            row = go()
            done[name], overflow[name] = _profile.tier_counts(index, row, k)
            checks[f"{name} exact after the fallbacks"] = \
                _profile.finalized_equal(index, queries, scfg, row, want)
            _profile.log(f"  {name:28s} done={done[name]} "
                         f"overflow={overflow[name]}")
    rec = {"metric": "profile_tiers", "n": args.n, "q": args.q,
           "ms": rows.ms, "done": done, "overflow": overflow,
           "profile": rows.prof, "checks": checks, "device": str(dev)}
    print(json.dumps(rec), flush=True)
    if _profile.fail_on(checks, "profile_tiers"):
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
