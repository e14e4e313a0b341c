"""Index integrity checking: every stored table array against the state
freshly derived from the codes.

Port of ``verticut_tpu/index/integrity.py``. The entry arrays of a table
are the stable ``(substring, id)`` sort of the corpus, and the directory
is a function of the sorted substrings. So a check recomputes that sort
from the code array (the build's own sort, run again) and compares:

1. every stored id column (the flat ``entry_ids``, the id lanes of the
   inline rows, the compact id rows) with the sorted ids, pad slots
   included: presence, multiplicity, bucket order and the ascending-id
   order within a bucket in one elementwise compare;
2. every code word of the inline rows and of a bucket table's
   ``entry_codes`` with ``codes`` at the sorted ids, in bounded chunks;
3. the directory with the sorted substrings: a range or dense directory
   rebuilt and compared; a sorted or prefix directory's keys (and a
   prefix directory's run ends and prefix offsets); a hash directory's
   lookup of every key against the key's run.

Together these imply the reference's per-code check (every ``(id, code)``
pair present exactly once in the bucket its substring maps to).
"""

from __future__ import annotations

from typing import Optional

import torch

from verticut_tpu_torch.config import MIHConfig
from verticut_tpu_torch.index import directory as dir_lib
from verticut_tpu_torch.index.mih import (ID_ROW_BLOCK, MIHIndex, MIHTable,
                                          entry_block_size, sort_table)


def _id_mismatches(stored: torch.Tensor, truth: torch.Tensor) -> int:
    """Blocked ids ``[NB, blk]`` (pad -1) against the sorted ids."""
    want = torch.full((stored.numel(),), -1, dtype=torch.int32,
                      device=stored.device)
    n = min(truth.shape[0], want.shape[0])
    want[:n] = truth[:n]
    bad = int((stored.reshape(-1) != want).sum())
    return bad + (truth.shape[0] - n)     # ids with no slot at all


def _code_mismatches(entry_rows: torch.Tensor, codes: torch.Tensor,
                     truth: torch.Tensor, chunk_entries: int) -> int:
    """Words 1..W of every inline entry against ``codes[truth]``; pad
    entries are the id check's business."""
    n, w = codes.shape
    blk = entry_block_size(w)
    rows = max(1, chunk_entries // blk)
    bad = 0
    for r0 in range(0, entry_rows.shape[0], rows):
        part = entry_rows[r0:r0 + rows]
        ids = truth[r0 * blk:(r0 + part.shape[0]) * blk]
        stored = part.reshape(part.shape[0], 1 + w, blk).transpose(1, 2)
        stored = stored.reshape(-1, 1 + w)[:ids.shape[0], 1:]
        bad += int((stored != codes[ids.long()]).sum())
    return bad


def _entry_code_mismatches(entry_codes: torch.Tensor, codes: torch.Tensor,
                           truth: torch.Tensor, chunk_entries: int) -> int:
    """A bucket table's per-entry code copies against ``codes[truth]``."""
    bad = 0
    for lo in range(0, truth.shape[0], chunk_entries):
        want = codes[truth[lo:lo + chunk_entries].long()]
        bad += int((entry_codes[lo:lo + chunk_entries] != want).sum())
    return bad


def _directory_mismatches(d, sk: torch.Tensor) -> int:
    """Mismatches of a directory against the sorted substrings ``sk``."""
    if isinstance(d, dir_lib.RangeDirectory):
        want = dir_lib.build_range(sk, d.s_bits, pbits=d.pbits).se
        return int((want != d.se).sum())
    if isinstance(d, dir_lib.DenseDirectory):
        return int((dir_lib.build_dense(sk, d.s_bits).offsets
                    != d.offsets).sum())
    if isinstance(d, dir_lib.SortedDirectory):
        return int((d.keys != sk).sum())
    if isinstance(d, dir_lib.PrefixDirectory):
        pbits = d.prefix_offsets.shape[0].bit_length() - 1
        want = dir_lib.build_prefix(sk, d.shift + pbits, pbits=pbits)
        return (int((d.keys != sk).sum())
                + int((d.run_end != want.run_end).sum())
                + int((d.prefix_offsets != want.prefix_offsets).sum()))
    if isinstance(d, dir_lib.HashDirectory):
        n = sk.shape[0]
        first = torch.ones(n, dtype=torch.bool, device=sk.device)
        first[1:] = sk[1:] != sk[:-1]
        idx = torch.arange(n, dtype=torch.int32, device=sk.device)
        run_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
        run_end = dir_lib.compute_run_end(sk)
        start, count = d.lookup(sk)
        return int(((start != run_start)
                    | (count != run_end - run_start)).sum())
    raise TypeError(f"unknown directory type {type(d).__name__}")


def check_table(codes: torch.Tensor, table: MIHTable, table_id: int,
                cfg: MIHConfig, chunk_entries: int = 5_000_000) -> dict:
    """Integrity report of one table: mismatch counts of its ids, stored
    codes and directory, and ``ok``."""
    sorted_subs, truth = sort_table(codes, table_id, cfg.s_bits)
    id_bad = None
    if table.entry_ids is not None:
        id_bad = (int((table.entry_ids != truth).sum())
                  if table.entry_ids.shape == truth.shape
                  else truth.shape[0])
    for rows, blk in ((table.entry_idrows, ID_ROW_BLOCK),
                      (table.entry_rows, entry_block_size(cfg.n_words))):
        if rows is not None:
            b = _id_mismatches(rows[:, :blk], truth)
            id_bad = b if id_bad is None else id_bad + b
    if id_bad is None:
        raise ValueError("table stores no id column in any layout")
    code_bad = (0 if table.entry_rows is None else
                _code_mismatches(table.entry_rows, codes, truth,
                                 chunk_entries))
    if table.entry_codes is not None:
        code_bad += _entry_code_mismatches(table.entry_codes, codes, truth,
                                           chunk_entries)
    dir_bad = _directory_mismatches(table.directory, sorted_subs)
    return {"table": table_id, "id_mismatches": id_bad,
            "code_mismatches": code_bad, "directory_mismatches": dir_bad,
            "ok": id_bad == 0 and code_bad == 0 and dir_bad == 0}


def check_index(index: MIHIndex,
                codes: Optional[torch.Tensor] = None) -> dict:
    """Integrity report of a whole index. ``codes`` overrides
    ``index.codes`` (for an index built without keeping them)."""
    codes = codes if codes is not None else index.codes
    if codes is None:
        raise ValueError("integrity check needs the code array")
    reports = [check_table(codes, t, i, index.cfg)
               for i, t in enumerate(index.tables)]
    return {"n": index.n, "tables": reports,
            "ok": all(r["ok"] for r in reports)}
