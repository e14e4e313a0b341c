"""The port's oracle drive: the fused engine against an independent
brute-force oracle on one CUDA card, at several k.

Run on a machine with an NVIDIA GPU:

    python -m verticut_tpu_torch.oracle_drive
    VERTICUT_ORACLE_N=100000 python -m verticut_tpu_torch.oracle_drive

Coverage, as the reference's ``tools/oracle_drive.py``: a clustered and a
uniform corpus (1M codes by default, ``VERTICUT_ORACLE_N``), batches of
``VERTICUT_ORACLE_Q`` queries (1024), half corpus rows with 3 bit flips
(resolved by enumeration) and half uniform random codes (resolved by the
scan tier), at k in ``VERTICUT_ORACLE_K`` (10,100,500,1000). Each cell
passes when ``mih_search`` equals ``linear_search(method="popcount")``
(full distance matrices and sorts, sharing no selection code with the
engine) in dists and ids, the distance multisets are equal, and every
returned id's distance recomputed on the host with numpy equals the
returned one. Prints one JSON object; exits 0 iff every cell passed, and
non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import codes
from verticut_tpu_torch.bench import card, log, perturbed_queries, sync
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.search import linear_search, mih_search

CFG = MIHConfig(bits=128, n_tables=4)


def _host_dists(db: np.ndarray, queries: np.ndarray,
                ids: np.ndarray) -> np.ndarray:
    """Hamming distances of ``db[ids]`` to their queries, by numpy."""
    x = db[np.clip(ids, 0, len(db) - 1)] ^ queries[:, None, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def run_cells(n: int, q_batch: int, ks, device) -> list:
    """Every (corpus, k) cell on ``device``: a list of records."""
    rng = np.random.default_rng(7)
    corpora = {
        "clustered": codes.clustered_codes(1, n, CFG.bits,
                                           n_clusters=max(2, n // 200),
                                           flip_p=0.02),
        "uniform": codes.random_codes(2, n, CFG.bits)}
    cells = []
    for name, packed in corpora.items():
        index = build_index(packed, CFG, device=device)
        qp = perturbed_queries(rng, index.codes, q_batch // 2)
        qr = bits_lib.as_codes(codes.random_codes(
            3, q_batch - q_batch // 2, CFG.bits), device)
        queries = torch.cat([qp, qr])
        q_host = bits_lib.to_u32(queries)
        for k in ks:
            scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
            t0 = time.perf_counter()
            res = mih_search(index, queries, scfg)
            sync(device)
            eng_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            od, oi = linear_search(queries, index.codes, k,
                                   method="popcount")
            od, oi = od.cpu(), oi.cpu()
            orc_s = time.perf_counter() - t0
            ids = res.ids.numpy()
            hd = _host_dists(packed, q_host, ids)
            rec = {
                "corpus": name, "k": k, "n": n, "q": q_batch,
                "dists_equal": bool(torch.equal(res.dists, od)),
                "ids_equal": bool(torch.equal(res.ids, oi)),
                "multiset_equal": bool(torch.equal(
                    torch.sort(res.dists, -1).values,
                    torch.sort(od, -1).values)),
                "id_dist_equal": bool(np.all((hd == res.dists.numpy())
                                             | (ids < 0))),
                "engine_s": eng_s, "oracle_s": orc_s,
                "mean_radius": float(res.radius.float().mean())}
            rec["ok"] = (rec["dists_equal"] and rec["ids_equal"]
                         and rec["multiset_equal"] and rec["id_dist_equal"])
            log(f"oracle: {name} k={k} ok={rec['ok']} engine {eng_s:.2f} s "
                f"oracle {orc_s:.2f} s")
            cells.append(rec)
        del index
    return cells


def main() -> int:
    if not torch.cuda.is_available():
        log("oracle_drive: torch.cuda.is_available() is False; the drive "
            "checks the engine on a CUDA card")
        return 2
    env = os.environ
    cells = run_cells(
        n=int(env.get("VERTICUT_ORACLE_N", 1_000_000)),
        q_batch=int(env.get("VERTICUT_ORACLE_Q", 1024)),
        ks=tuple(int(x) for x in env.get("VERTICUT_ORACLE_K",
                                         "10,100,500,1000").split(",")),
        device=torch.device("cuda", 0))
    ok = all(c["ok"] for c in cells)
    print(json.dumps({"metric": "oracle_drive", "ok": ok, **card(),
                      "cells": cells}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
