"""Inputs of the fetch + score kernel and its twins, and a scalar scorer,
shared by the CPU tests (``test_torch_fetch_score.py``) and the card's
(``test_torch_gpu.py``). No jax import.

A case is one table of either layout with pad ids ``-1``, descriptors made
by ``ops/chunks.chunk_descriptors`` (so slots past a query's chunk count
have ``lo == hi`` and a clipped ``blk_id``, and windows start past 0 and
end before ``blk``), and three slots per query set by hand: an empty
window ``lo == hi`` on a real block, an inverted one ``lo > hi``, and the
table's last block (pad entries) whole. The compact table also holds an
id past the codes, which every version reads at the last code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from verticut_tpu_torch.index.mih import ID_ROW_BLOCK, entry_block_size
from verticut_tpu_torch.ops import chunks

LAYOUTS = ("inline", "compact")


class Case(NamedTuple):
    layout: str
    blk: int
    rows: np.ndarray            # int32 inline [NB, blk*(W+1)] / id [NB, blk]
    codes: Optional[np.ndarray]  # int32 [N, W], compact only
    blk_id: np.ndarray          # int32 [Q, CHB]
    lo: np.ndarray
    hi: np.ndarray
    queries: np.ndarray         # int32 [Q, W]

    def tensors(self, device="cpu"):
        """The operands as int32 tensors on ``device``, in the order the
        layout's entry takes them (``blk`` apart)."""
        t = [torch.from_numpy(a).to(device) for a in (
            self.rows, self.blk_id, self.lo, self.hi, self.queries)]
        if self.layout == "compact":
            t.insert(1, torch.from_numpy(self.codes).to(device))
        return t


def make(layout: str, w: int, seed: int, nq: int = 13, chb: int = 9,
         nb: int = 30, h: int = 6, n_codes: int = 500) -> Case:
    rng = np.random.default_rng(seed)
    blk = ID_ROW_BLOCK if layout == "compact" else entry_block_size(w)
    if layout == "compact":
        ids = rng.integers(0, n_codes, nb * blk).astype(np.int32)
        ids[rng.integers(0, nb * blk)] = n_codes + 5    # past the codes
    else:
        ids = rng.permutation(nb * blk).astype(np.int32)
    ids[rng.random(nb * blk) < 0.05] = -1
    ids[-blk:] = -1                                     # the pad block
    if layout == "compact":
        codes = rng.integers(0, 1 << 32, (n_codes, w),
                             dtype=np.uint32).view(np.int32)
        rows = ids.reshape(nb, blk)
    else:
        codes = None
        words = rng.integers(0, 1 << 32, (nb * blk, w),
                             dtype=np.uint32).view(np.int32)
        words[ids < 0] = 0
        rows = np.concatenate([ids[:, None], words], axis=1).reshape(
            nb, blk, w + 1).transpose(0, 2, 1).reshape(nb, blk * (w + 1))
    starts = rng.integers(0, nb * blk, (nq, h)).astype(np.int32)
    counts = rng.integers(0, 3 * blk, (nq, h)).astype(np.int32)
    counts[rng.random((nq, h)) < 0.3] = 0
    counts = np.minimum(counts, nb * blk - starts).astype(np.int32)
    blk_id, lo, hi, _, _ = (np.ascontiguousarray(x.numpy()) for x in
                            chunks.chunk_descriptors(
                                torch.from_numpy(starts),
                                torch.from_numpy(counts), blk=blk, chb=chb,
                                n_blocks=nb))
    blk_id[:, 0], lo[:, 0], hi[:, 0] = 3, 5, 5          # empty window
    blk_id[:, 1], lo[:, 1], hi[:, 1] = 4, 9, 2          # inverted window
    blk_id[:, -1], lo[:, -1], hi[:, -1] = nb - 1, 0, blk
    queries = rng.integers(0, 1 << 32, (nq, w), dtype=np.uint32)
    queries[: nq // 2] |= np.uint32(0x80000000)
    return Case(layout, blk, np.ascontiguousarray(rows), codes, blk_id, lo,
                hi, queries.view(np.int32))


def scalar(case: Case):
    """Slot by slot in Python: ``(dist, id)`` int32 ``[Q, CHB*blk]``."""
    nq, chb = case.blk_id.shape
    blk = case.blk
    q_u = case.queries.view(np.uint32)
    dist = np.full((nq, chb * blk), 0x7FFFFFFF, np.int32)
    out = np.full((nq, chb * blk), -1, np.int32)
    for qi in range(nq):
        for c in range(chb):
            b = int(case.blk_id[qi, c])
            for r in range(int(case.lo[qi, c]), int(case.hi[qi, c])):
                e = int(case.rows[b, r])
                if e < 0:
                    continue
                if case.layout == "compact":
                    code = case.codes[min(e, len(case.codes) - 1)]
                else:
                    code = case.rows[b, blk + r::blk]       # words 1..W
                x = code.view(np.uint32) ^ q_u[qi]
                dist[qi, c * blk + r] = sum(bin(int(v)).count("1")
                                            for v in x)
                out[qi, c * blk + r] = e
    return dist, out


def run(case: Case, fn, device="cpu"):
    """``fn`` (a layout's entry or twin) on the case's tensors."""
    t = case.tensors(device)
    if case.layout == "compact":
        return fn(*t)
    return fn(*t, blk=case.blk)
