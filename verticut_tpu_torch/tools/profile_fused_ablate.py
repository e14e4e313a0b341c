"""Ablation profile of the whole fused pipeline: the port's twin of
``tools/profile_fused_ablate.py``.

Times the fused pipeline's packed result row
(``tools/_profile.fused_variant``) with pieces switched off, to attribute
a batch's cost that the per-component profile (:mod:`.profile_stages2`)
cannot see: compactions, the retry and scan ladders, the dominance gate,
the later stages. Seven variants per k, named as the JAX tool names them:

* ``full``: the fused driver as it runs;
* ``merged-ladder``: overflowed rows ride the scan ladder
  (``overflow_to_scan``) instead of a retry ladder;
* ``noscan``: no scan ladder; ``bare``: no scan and no retry ladder;
  ``bare stage1``: the same, cut to the first stage;
* ``uniform full`` and ``uniform nodom``: uniform queries
  (``random_codes(99, q)``), with and without the dominance gate.

The dominance gate's threshold is ``q // 2`` whenever the scan ladder
runs, as the JAX tool sets it (the search paths set it from 1024 queries
up). Timing: ``(t_R - t_1) / (R - 1)``, R calls back to back with one
device sync at the end against one (``_profile.rep_ms``); one more call
under ``torch.profiler`` gives each variant's launches, device ms and
``cudaLaunchKernel`` host seconds. Each variant's row, finished by the
host fallbacks as finalize finishes it, must equal ``mih_search``'s answer
in dists and ids, or the tool exits 1.

From ``--n`` 20M up the corpus is made and the index built on the card,
as ``verticut_tpu_torch/bench.py`` does.

Usage: python -m verticut_tpu_torch.tools.profile_fused_ablate
[--n 1000000] [--q 8192] [--r 8] [--k 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from verticut_tpu_torch import bench, codes
from verticut_tpu_torch.bits import as_codes, entry_device
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.search import mih_search
from verticut_tpu_torch.tools import _profile
from verticut_tpu_torch.tools._profile import Rows

#: name -> (``fused_variant`` switches, uniform queries), the JAX tool's
#: variants in its order
VARIANTS = {
    "full": ({}, False),
    "merged-ladder": ({"overflow_to_scan": True}, False),
    "noscan": ({"scan": False}, False),
    "bare": ({"scan": False, "retry": False}, False),
    "bare stage1": ({"scan": False, "retry": False, "n_stages": 1}, False),
    "uniform full": ({}, True),
    "uniform nodom": ({"dominance": False}, True),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--k", type=int, default=0, help="single k (0 = 10,100)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    _profile.log(f"ablate: building n={args.n}")
    index = bench.make_index(args.n, dev)[0]
    clustered = _profile.perturbed(index, args.q)
    uniform = as_codes(codes.random_codes(99, args.q, index.cfg.bits), dev)
    rows = Rows(dev)
    checks = {}
    for k in [args.k] if args.k else [10, 100]:
        _profile.log(f"k={k}")
        scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
        want = {u: mih_search(index, q, scfg)
                for u, q in ((False, clustered), (True, uniform))}
        for label, (kw, uni) in VARIANTS.items():
            name = f"k{k} {label}"
            qs = uniform if uni else clustered

            def go(kw=kw, qs=qs):
                return _profile.fused_variant(index, qs, scfg, **kw)

            rows.add(name, _profile.rep_ms(go, dev, args.r), go)
            checks[f"{name} exact after the fallbacks"] = \
                _profile.finalized_equal(index, qs, scfg, go(), want[uni])
    rec = {"metric": "profile_fused_ablate", "n": args.n, "q": args.q,
           "ms": rows.ms, "profile": rows.prof, "checks": checks,
           "device": str(dev)}
    print(json.dumps(rec), flush=True)
    if _profile.fail_on(checks, "profile_fused_ablate"):
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
