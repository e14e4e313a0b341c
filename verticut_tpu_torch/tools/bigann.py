"""BIGANN/TexMex end to end on the port: feature vectors -> binary codes ->
MIH index -> K-NN search -> recall@k against exact ground truth — the
twin of ``tools/bigann.py``, with the same flags:

    python -m verticut_tpu_torch.tools.bigann --synth 1000000 --queries 1000 \
        --k 10 --shortlists 10,100,1000 [--json out.json] [--device cpu]
    python -m verticut_tpu_torch.tools.bigann --base sift_base.bvecs \
        --query sift_query.bvecs --gt sift_groundtruth.ivecs --k 100

Reads the standard ``.bvecs``/``.fvecs`` base and query files and the
``.ivecs`` ground truth (``utils/io.py``), or with ``--synth N`` makes a
SIFT-like clustered uint8 corpus (byte-equal to the reference tool's) and
computes its exact L2 ground truth on the device; trains the port's ITQ
encoder on a base sample (``--seed``, ``--train-sample``), encodes base
and queries, builds the index and reports recall@1 and recall@k of the
true neighbours within the Hamming top-R shortlist (the standard
binary-hashing evaluation) and the feature-space distance ratio. The ITQ
fit draws from a ``torch.Generator``, not ``jax.random``, so its codes and
recall are the port's own; given the same codes, :func:`evaluate` gives
the reference tool's figures. Runs on the card unless ``--device`` names
another device.
"""

import argparse
import json
import sys
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def synth_features(n, nq, dim, seed):
    """SIFT-like clustered uint8 features and queries near base points
    (numpy; the reference tool's draws, byte for byte)."""
    rng = np.random.default_rng(seed)
    n_clusters = max(8, n // 500)
    centers = rng.integers(0, 160, (n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    base = centers[assign] + rng.normal(0, 12.0, (n, dim))
    base = np.clip(base, 0, 255).astype(np.uint8)
    sel = rng.integers(0, n, nq)
    qf = base[sel].astype(np.float32) + rng.normal(0, 6.0, (nq, dim))
    return base, np.clip(qf, 0, 255).astype(np.uint8)


def l2_ground_truth(queries_f, base_f, k, device, chunk=65536):
    """Exact L2 top-k ids (numpy int64 ``[Q, k]``), ``||q||^2 - 2 q.b +
    ||b||^2`` per base chunk on ``device`` in float32 with TF32 off, merged
    by a stable sort (ties to the lower id). For integer features of dim
    128 every term stays below 2^24, so each distance is exact and the ids
    are the reference's; TF32 would round them."""
    from verticut_tpu_torch.models.lsh import _fp32

    def feats(x):
        return torch.from_numpy(np.asarray(x)).to(device, torch.float32)

    q = feats(queries_f)
    nq = q.shape[0]
    best_d = torch.full((nq, k), float("inf"), device=device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=device)
    with _fp32():
        qn = torch.sum(q * q, dim=1, keepdim=True)
        for lo in range(0, base_f.shape[0], chunk):
            b = feats(base_f[lo:lo + chunk])
            d2 = qn - 2.0 * (q @ b.T) + torch.sum(b * b, dim=1)[None, :]
            ids = torch.arange(lo, lo + b.shape[0], device=device)
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
            sel = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
            best_d = cat_d.gather(1, sel)
            best_i = cat_i.gather(1, sel)
    return best_i.cpu().numpy()


class Evaluation(NamedTuple):
    rows: List[dict]      # one artifact row per shortlist
    build_s: float        # the index build's seconds
    index: object         # the MIHIndex searched
    queries: object       # the query codes on the index's device
    results: Dict[int, object]   # shortlist -> SearchResult


def evaluate(base_codes, query_codes, base_f, query_f, gt, cfg, shortlists,
             device) -> Evaluation:
    """Build the index of ``base_codes`` on ``device``, search
    ``query_codes`` at each shortlist size R (a warm batch, then a timed
    one) and score the answers against the ground-truth ids ``gt
    [Q, k]`` as the reference tool does: recall@1 and recall@k of the true
    neighbours within the Hamming top-R, and the mean feature-space ratio
    of the first k found to the true k."""
    from verticut_tpu_torch.bench import sync
    from verticut_tpu_torch.bits import as_codes
    from verticut_tpu_torch.config import SearchConfig
    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.search import mih_search

    k = gt.shape[1]
    t0 = time.time()
    index = build_index(base_codes, cfg, device=device)
    sync(device)
    build_s = time.time() - t0
    qc = as_codes(query_codes, index.device)
    nq = qc.shape[0]
    bf = base_f.astype(np.float32)
    qf = query_f.astype(np.float32)
    d_true = np.linalg.norm(bf[gt] - qf[:, None, :], axis=-1)
    rows, results = [], {}
    for shortlist in shortlists:
        scfg = SearchConfig(knn=shortlist)
        mih_search(index, qc, scfg)        # warm (steady-state numbers)
        t0 = time.time()
        res = mih_search(index, qc, scfg)  # host tensors: synced
        search_s = time.time() - t0
        results[shortlist] = res
        ids = res.ids.numpy()

        # recall@1@R and recall@k@R: is the true neighbour inside the
        # Hamming top-R shortlist
        hits = 0
        hits1 = 0
        for i in range(nq):
            found = set(ids[i].tolist())
            hits += len(set(gt[i].tolist()) & found)
            hits1 += 1 if int(gt[i, 0]) in found else 0
        recall = hits / float(nq * k)
        recall1 = hits1 / float(nq)
        # reference-style distance ratio on the features
        # (accuracy_test.cc:118-126: mean of d(found)/d(true) per rank)
        found = np.clip(ids[:, :k], 0, len(base_f) - 1)
        d_found = np.linalg.norm(bf[found] - qf[:, None, :], axis=-1)
        ratio = float(np.mean(d_found / np.maximum(d_true, 1e-6)))
        rows.append({"shortlist": shortlist, "recall_at_1": round(recall1, 4),
                     f"recall_at_{k}": round(recall, 4),
                     "distance_ratio": round(ratio, 4),
                     "search_s": round(search_s, 3),
                     "qps": round(nq / max(search_s, 1e-9), 1)})
    return Evaluation(rows=rows, build_s=build_s, index=index, queries=qc,
                      results=results)


def main(argv=None) -> Evaluation:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", help=".bvecs/.fvecs base vectors")
    p.add_argument("--query", help=".bvecs/.fvecs query vectors")
    p.add_argument("--gt", help=".ivecs exact ground truth (else computed)")
    p.add_argument("--synth", type=int, default=0,
                   help="generate a synthetic corpus of this size instead")
    p.add_argument("--queries", type=int, default=1000)
    p.add_argument("--max-base", type=int, default=0)
    p.add_argument("--bits", type=int, default=128)
    p.add_argument("--tables", type=int, default=4)
    p.add_argument("--k", type=int, default=10,
                   help="ground-truth neighbors to recover")
    p.add_argument("--json", help="write a JSON artifact of the results")
    p.add_argument("--shortlists",
                   help="comma list of shortlist sizes to sweep (the "
                        "standard recall@k@R curve); overrides --shortlist")
    p.add_argument("--shortlist", type=int, default=0,
                   help="Hamming top-R shortlist (default: 10*k)")
    p.add_argument("--train-sample", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--device", default=None,
                   help="device to run on (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.models.lsh import ITQEncoder, encode_corpus
    from verticut_tpu_torch.utils import io as vio

    device = entry_device(args.device)
    if args.synth:
        log(f"bigann: synthesizing {args.synth} x {args.dim} uint8 features")
        base_f, query_f = synth_features(args.synth, args.queries, args.dim,
                                         args.seed)
        gt = None
    else:
        if not (args.base and args.query):
            p.error("--base/--query or --synth required")
        base_f = vio.read_vecs(args.base, max_rows=args.max_base)
        query_f = vio.read_vecs(args.query, max_rows=args.queries)
        gt = vio.read_vecs(args.gt)[:len(query_f)] if args.gt else None
    nq = len(query_f)
    log(f"bigann: base {base_f.shape} queries {query_f.shape}")

    if gt is None:
        log("bigann: computing exact L2 ground truth on device")
        gt = l2_ground_truth(query_f, base_f, args.k, device)
    gt = np.asarray(gt)[:, :args.k]

    t0 = time.time()
    rng = np.random.default_rng(args.seed)
    sample = base_f[rng.choice(len(base_f),
                               min(args.train_sample, len(base_f)),
                               replace=False)]
    enc = ITQEncoder.fit(sample.astype(np.float32), args.bits, seed=args.seed,
                         device=device)
    train_s = time.time() - t0
    t0 = time.time()
    base_codes = encode_corpus(enc, base_f.astype(np.float32))
    query_codes = encode_corpus(enc, query_f.astype(np.float32))
    encode_s = time.time() - t0
    log(f"bigann: ITQ train {train_s:.1f}s encode {encode_s:.1f}s")

    if args.shortlists:
        shortlists = [int(s) for s in args.shortlists.split(",")]
    else:
        shortlists = [args.shortlist or 10 * args.k]
    ev = evaluate(base_codes, query_codes, base_f, query_f, gt,
                  MIHConfig(bits=args.bits, n_tables=args.tables),
                  shortlists, device)
    for row in ev.rows:
        shortlist = row["shortlist"]
        print(f"recall@1 (shortlist {shortlist}): {row['recall_at_1']:.4f}")
        print(f"recall@{args.k} (shortlist {shortlist}): "
              f"{row[f'recall_at_{args.k}']:.4f}")
        print(f"distance ratio: {row['distance_ratio']:.4f}")
        print(f"train {train_s:.1f}s encode {encode_s:.1f}s "
              f"build {ev.build_s:.1f}s "
              f"search {row['search_s']:.2f}s ({row['qps']:.0f} qps)")

    if args.json:
        art = {"dataset": ("synthetic" if args.synth else args.base),
               "n_base": int(len(base_f)), "n_queries": int(nq),
               "dim": int(base_f.shape[1]), "bits": args.bits,
               "n_tables": args.tables, "k": args.k,
               "train_s": round(train_s, 1), "encode_s": round(encode_s, 1),
               "build_s": round(ev.build_s, 1), "sweep": ev.rows}
        with open(args.json, "w") as f:
            f.write(json.dumps(art) + "\n")
        log(f"bigann: wrote {args.json}")
    return ev


if __name__ == "__main__":
    main()
