"""Paired approximate-vs-exact accuracy sweep on the port — the twin of
``tools/accuracy_test.py`` (the ``accuracy-test`` binary +
``test_approximate_accuracy.py`` analog, ``src/accuracy_test.cc:72-135``:
distance-sum ratio, inaccurate count, wall times; k in {3,100,500,1000}
per ``src/test_approximate_accuracy.py:12``), with the same flags:

    python -m verticut_tpu_torch.tools.accuracy_test --synth 1000000 -c 256 \
        [--uniform] [--ks 3,100,500,1000] [--no-fused] [--device cpu]

The corpus and the query draw are the reference tool's (numpy generators,
``default_rng(0)`` query ids), and the index is the port's device build
(held equal to the reference's native build), so every field but the
times equals the reference tool's on the same arguments. One JSON line per
k. Runs on the card unless ``--device`` names another device.
"""

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index")
    p.add_argument("--synth", type=int, default=0,
                   help="build an in-process clustered corpus of this size")
    p.add_argument("--uniform", action="store_true",
                   help="synth corpus uniform-random instead of clustered")
    p.add_argument("-c", "--count", type=int, default=256,
                   help="queries per k (reference protocol: 20 iters; more "
                        "here so warm batched timings mean something)")
    p.add_argument("--ks", default="3,100,500,1000")
    p.add_argument("--warm", action="store_true", default=True)
    p.add_argument("--no-fused", action="store_true",
                   help="use the per-radius loop driver")
    p.add_argument("--device", default=None,
                   help="device to search on (default: the card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from verticut_tpu_torch import codes
    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.config import MIHConfig, SearchConfig
    from verticut_tpu_torch.index import build_index, load_index
    from verticut_tpu_torch.search import mih_search

    device = entry_device(args.device)
    if args.synth:
        cfg = MIHConfig(bits=128, n_tables=4)
        if args.uniform:
            packed = codes.random_codes(0, args.synth, cfg.bits)
        else:
            packed = codes.clustered_codes(0, args.synth, cfg.bits,
                                           n_clusters=args.synth // 200,
                                           flip_p=0.02)
        index = build_index(packed, cfg, device=device)
    elif args.index:
        index = load_index(args.index, device=device)
    else:
        p.error("--index or --synth required")
    rng = np.random.default_rng(0)
    qids = rng.integers(0, index.n, args.count)
    queries = index.codes[torch.from_numpy(qids).to(index.device)]

    for k in (int(x) for x in args.ks.split(",")):
        fused = not args.no_fused
        se = SearchConfig(knn=k, fused=fused)
        sa = SearchConfig(knn=k, approximate=True, fused=fused)
        if args.warm:
            mih_search(index, queries, se)
            mih_search(index, queries, sa)
        # mih_search returns host tensors: each timed call ends in the
        # copy off the card, which waits for it
        t0 = time.time()
        exact = mih_search(index, queries, se)
        t_exact = time.time() - t0
        t0 = time.time()
        approx = mih_search(index, queries, sa)
        t_approx = time.time() - t0
        exact = {f: getattr(exact, f).numpy() for f in exact._fields}
        approx = {f: getattr(approx, f).numpy() for f in approx._fields}

        # accuracy_test.cc metrics
        valid = exact["ids"] >= 0
        dist_ratio = float((approx["dists"] * valid).sum()
                           / max((exact["dists"] * valid).sum(), 1))
        max_exact = np.where(valid.any(-1),
                             (exact["dists"] * valid).max(-1), 0)
        inaccurate = int(((approx["dists"] > max_exact[:, None])
                          & (approx["ids"] >= 0)).sum())
        accuracy = 1.0 - inaccurate / max(int(valid.sum()), 1)
        print(json.dumps({
            "k": k, "queries": args.count,
            "distance_ratio": round(dist_ratio, 4),
            "inaccurate_count": inaccurate,
            "accuracy": round(accuracy, 4),
            "exact_s": round(t_exact, 3), "approx_s": round(t_approx, 3),
            "mean_radius_exact": float(exact["radius"].mean()),
            "mean_radius_approx": float(approx["radius"].mean()),
        }), flush=True)


if __name__ == "__main__":
    main()
