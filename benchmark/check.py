"""What decides ``correct``: a sample of the window's answers, drawn from
the seed, held against the plain reference.

The guarantee held is the configuration's: exact K-NN, ties at one
distance to the smaller id. Every returned distance equals the
reference's, and so does every returned id, with one exception that the
configuration states: a row that the MIH stop rule finished at radius r
with its k-th distance equal to ``n_tables * (r + 1)`` (upstream's exact
stop rule, ``search_worker.cc:201-205``, stops there too) may leave codes
at that distance unenumerated. On such a boundary row every code strictly
closer than the k-th distance is returned, ordered by id within a
distance, and the rest are distinct codes at the k-th distance in
ascending id order.
"""

from __future__ import annotations

import collections
import importlib
import sys
from typing import Optional

import torch

from benchmark import gen

#: sample rows per stratum (see :class:`Keeper`)
SAMPLE = {"tier": 192, "boundary": 128, "random": 192}
#: rows of each finished batch kept as sample candidates, per stratum
KEEP_PER_BATCH = 4
#: share of the corpus, at its end, that the ``tail`` control leaves out
TAIL_SHARE = 64
#: wrong answers shown on standard error
SHOW_WRONG = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Keeper:
    """Sample candidates: a few rows of each finished batch per stratum.
    ``random``: any row. ``tier``: rows whose k-th distance the radius
    step could not have certified (``dist > n_tables * (radius + 1)``),
    answered by the scan tier or the linear fallback. ``boundary``: rows
    the stop rule finished at ``dist == n_tables * (radius + 1)``, where
    codes at the k-th distance may be left unenumerated."""

    def __init__(self, seed: int, k: int, n_tables: int):
        self.seed, self.k, self.m = seed, k, n_tables
        self.rows = {s: [] for s in SAMPLE}

    def take(self, i: int, res) -> None:
        g = torch.Generator().manual_seed(gen.derive(self.seed, gen.SAMPLE,
                                                     i))
        kth = res.dists[:, self.k - 1]
        cert = self.m * (res.radius + 1)
        boundary = kth == cert
        masks = {"random": torch.ones_like(kth, dtype=torch.bool),
                 "tier": kth > cert, "boundary": boundary}
        for stratum, mask in masks.items():
            rows = torch.nonzero(mask).flatten()
            pick = rows[torch.randperm(rows.shape[0], generator=g)
                        [:KEEP_PER_BATCH]]
            for r in pick.tolist():
                self.rows[stratum].append(
                    (i, r, res.dists[r].clone(), res.ids[r].clone(),
                     bool(boundary[r])))

    def sample(self) -> list:
        """``(batch, row, dists, ids, boundary, stratum)`` rows, drawn from
        the seed, without repeats."""
        g = torch.Generator().manual_seed(gen.derive(self.seed, gen.DRAW))
        out, seen = [], set()
        for stratum, n in SAMPLE.items():
            rows = self.rows[stratum]
            for j in torch.randperm(len(rows), generator=g)[:n].tolist():
                if rows[j][:2] not in seen:
                    seen.add(rows[j][:2])
                    out.append(rows[j] + (stratum,))
        return out


def judge(d, ids, rd, ri, true_d, n: int,
          boundary: bool) -> Optional[str]:
    """None where the answer ``(d, ids)`` keeps the guarantee against the
    reference's ``(rd, ri)``, else ``"dists"`` or ``"ids"``. ``true_d``:
    the distance of each returned id's code from the query; ``boundary``:
    the stop rule finished the row with its k-th distance equal to
    ``n_tables * (radius + 1)``, where the ids at that distance are
    open."""
    if not torch.equal(d, rd):
        return "dists"
    if not boundary:
        return None if torch.equal(ids, ri) else "ids"
    below = rd < rd[-1]
    if not torch.equal(ids[below], ri[below]):
        return "ids"
    at = ids[~below]
    if (at < 0).any() or (at >= n).any() or not (at[1:] > at[:-1]).all():
        return "ids"
    if not torch.equal(true_d[~below], d[~below]):
        return "ids"
    return None


def check(cell, seed: int, device, sample: list, failed: int,
          control: Optional[str] = None) -> dict:
    """Hold ``sample`` against the reference, over a corpus and queries
    made again from the seed: ``{name: (value, limit)}``. With
    ``control="tail"`` the answers held are the reference's over all but
    the last ``1 / TAIL_SHARE`` of the corpus."""
    k = int(cell.traffic["k"])
    ref = importlib.import_module(
        "benchmark.references." + cell.config["reference"])
    corpus = gen.corpus(cell.config, seed, device)
    n = corpus.shape[0]
    by_batch = collections.defaultdict(list)
    for j, (i, r, *_rest) in enumerate(sample):
        by_batch[i].append((j, r))
    queries = torch.empty((len(sample), corpus.shape[1]), dtype=torch.int32,
                          device=device)
    for i, rows in by_batch.items():
        b = gen.batch(cell.traffic, seed, i, corpus, cell.batch)
        queries[[j for j, _ in rows]] = b[[r for _, r in rows]]
    wrong = {"dists": 0, "ids": 0}
    ties = 0
    if sample:
        rd, ri = ref.topk(queries, corpus, k)
        if control == "tail":
            cd, ci = ref.topk(queries, corpus[:n - n // TAIL_SHARE], k)
            sample = [s[:2] + (cd[j], ci[j]) + s[4:]
                      for j, s in enumerate(sample)]
        got = torch.stack([s[3] for s in sample]).to(device)
        true_d = ref.hamming(corpus[got.clamp(0, n - 1).long()],
                             queries[:, None, :]).cpu()
    for j, (i, r, d, ids, boundary, stratum) in enumerate(sample):
        kind = judge(d, ids, rd[j], ri[j], true_d[j], n, boundary)
        if kind is None:
            ties += not torch.equal(ids, ri[j])
            continue
        wrong[kind] += 1
        if sum(wrong.values()) <= SHOW_WRONG:
            at = torch.nonzero((d != rd[j]) | (ids != ri[j])).flatten()
            log(f"bench: wrong {kind}: batch {i} row {r} ({stratum}) at "
                f"{at.tolist()}: answer {d[at].tolist()} "
                f"{ids[at].tolist()}, reference {rd[j][at].tolist()} "
                f"{ri[j][at].tolist()}")
    counts = collections.Counter(s[5] for s in sample)
    log(f"bench: sample {len(sample)} answers {dict(counts)}, "
        f"{sum(s[4] for s in sample)} of them boundary rows; {ties} boundary "
        "rows keep other codes at the k-th distance than the reference's "
        "smallest ids")
    return {"wrong_dists": (wrong["dists"], 0),
            "wrong_ids": (wrong["ids"], 0),
            "failed_queries": (failed, 0),
            "unchecked_window": (int(not sample), 0)}
