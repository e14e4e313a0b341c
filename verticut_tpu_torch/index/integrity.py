"""Index integrity checking: every stored table array against the state
freshly derived from the codes.

Port of the range-table part of ``verticut_tpu/index/integrity.py``. The
entry arrays of a table are the stable ``(substring, id)`` sort of the
corpus, and the directory is a function of the sorted substrings. So a
check recomputes that sort from the code array (the build's own sort, run
again) and compares:

1. every stored id column (the flat ``entry_ids``, the id lanes of the
   inline rows, the compact id rows) with the sorted ids, pad slots
   included: presence, multiplicity, bucket order and the ascending-id
   order within a bucket in one elementwise compare;
2. every code word of the inline rows with ``codes`` at the sorted ids,
   in bounded chunks;
3. the range directory with one rebuilt from the sorted substrings.

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


def check_table(codes: torch.Tensor, table: MIHTable, table_id: int,
                cfg: MIHConfig, chunk_entries: int = 5_000_000) -> dict:
    """Integrity report of one range table: mismatch counts of its ids,
    inline codes and directory, and ``ok``."""
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
    d = table.directory
    want = dir_lib.build_range(sorted_subs, cfg.s_bits, pbits=d.pbits).se
    dir_bad = int((want != d.se).sum())
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
