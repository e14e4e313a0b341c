"""The multi-index-hashing index: per-table entry arrays on the device.

Port of the range / inline-rows case of ``verticut_tpu/index/mih.py``. Per
table, one sort of ``(substring, id)`` pairs orders the entries; a range
directory maps substring prefixes to row ranges; the entries are stored as
blocked word-major ``(id, code)`` rows, ``entry_block_size(W)`` entries per
row (25 at W = 4), so one gathered row scores a whole block.

The reference also keeps ``codes_t`` (a transposed scan copy) and
``codes_rows`` (blocked rescore rows). Both work around TPU memory layouts:
Mosaic's (8, 128) tiling of a ``[N, 4]`` operand and the TPU's per-row
gather cost. The port scans and rescores off the row-major ``codes`` array,
the natural operand of a GPU kernel, so it has neither.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import codes as codes_lib
from verticut_tpu_torch.config import MIHConfig
from verticut_tpu_torch.index import directory as dir_lib


class MIHTable(NamedTuple):
    """One substring hash table."""

    entry_ids: Optional[torch.Tensor]  # int32[N] ids in substring order
    directory: dir_lib.RangeDirectory
    # int32[NB, blk*RW]: one row = one blk-entry block stored word-major
    # (lane w*blk + r = word w of entry r; word 0 = id, words 1..W = code;
    # pad entries carry id -1 and a zero code)
    entry_rows: torch.Tensor

    def n_entries(self, n_words: int) -> int:
        """Entry count (the padded row count when the flat ids are absent)."""
        if self.entry_ids is not None:
            return self.entry_ids.shape[0]
        blk = entry_block_size(n_words)
        lanes = self.entry_rows.shape[1]
        if blk * _row_width(n_words) != lanes:
            raise ValueError(
                f"entry-row lane count {lanes} does not match n_words="
                f"{n_words} (expected {blk * _row_width(n_words)})")
        return self.entry_rows.shape[0] * blk


def _row_width(n_words: int) -> int:
    """Words per entry: 1 id word + the code words, no padding."""
    return 1 + n_words


def entry_block_size(n_words: int) -> int:
    """Entries per fetch block: the largest blk with blk * row width <= 128
    words (one row <= 512 B)."""
    return 128 // _row_width(n_words)


def entry_row_align(n_words: int) -> int:
    """Entry-count alignment of the blocked layout: whole blocks, x8."""
    return entry_block_size(n_words) * 8


@dataclasses.dataclass
class MIHIndex:
    """m per-substring tables plus the id-ordered codes, all on one device."""

    cfg: MIHConfig
    tables: List[MIHTable]
    n: int                              # number of indexed codes
    codes: Optional[torch.Tensor]       # int32[N, W], row i = id i

    @property
    def device(self) -> torch.device:
        return self.tables[0].entry_rows.device

    def table_subs(self, queries: torch.Tensor) -> torch.Tensor:
        """Substring values of a query batch for every table: [Q, m]."""
        return codes_lib.all_substrings(queries, self.cfg.n_tables)


def make_entry_rows(sorted_ids: torch.Tensor, codes: torch.Tensor
                    ) -> torch.Tensor:
    """Blocked word-major ``(id, code)`` rows, padded as the JAX package's
    native build pads them (``index/build_native._host_entry_rows``):
    entries to a multiple of ``entry_row_align(W)``, pad ids -1."""
    n, w = codes.shape
    rw = _row_width(w)
    blk = entry_block_size(w)
    align = entry_row_align(w)
    npad = -(-max(n, 1) // align) * align
    rows = torch.zeros((npad, rw), dtype=torch.int32, device=codes.device)
    rows[n:, 0] = -1
    rows[:n, 0] = sorted_ids
    rows[:n, 1:] = codes[sorted_ids.long()]
    return rows.reshape(npad // blk, blk, rw).transpose(1, 2).reshape(
        npad // blk, blk * rw).contiguous()


def build_index(codes_arr, cfg: MIHConfig = MIHConfig(), *,
                device=None, directory: str = "range") -> MIHIndex:
    """Build the m-table index on ``device``.

    ``codes_arr``: ``uint32[N, W]`` numpy codes or an ``int32[N, W]``
    tensor; row i is id i. Each table is one ``torch.sort`` of the unique
    int64 keys ``substring << 32 | id`` (the reference's stable (substring,
    id) order), a ``searchsorted`` over prefixes for the directory, then
    the word-major entry rows. Only the range directory with inline rows is
    ported (ROADMAP.md, Queue 1 items 7 and 8 hold the rest). Rows are
    padded as the JAX package's native build pads them; its device build
    pads alike up to 5M codes and in 5M-entry chunks above."""
    if directory != "range":
        raise NotImplementedError(
            f"directory={directory!r}: only the range directory is ported; "
            "the legacy bucket directories are ROADMAP.md Queue 1 item 8")
    codes = bits_lib.as_codes(codes_arr, device).contiguous()
    if codes.ndim != 2 or codes.shape[-1] != cfg.n_words:
        raise ValueError(
            f"codes have shape {tuple(codes.shape)}, config wants "
            f"[N, {cfg.n_words}]")
    n = codes.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} codes do not fit int32 ids")
    ids = torch.arange(n, dtype=torch.int64, device=codes.device)
    pbits = dir_lib.pick_range_pbits(n, cfg.s_bits,
                                     entry_block_size(cfg.n_words))
    tables = []
    for t in range(cfg.n_tables):
        subs = codes_lib.substring(codes, t, cfg.s_bits)
        # the unsigned substring, biased by -2^31 so the key's signed
        # order is the unsigned (substring, id) order
        keys = (((subs.to(torch.int64) & 0xFFFFFFFF) - (1 << 31)) << 32) | ids
        keys = torch.sort(keys).values
        sorted_subs = (keys >> 32) + (1 << 31)
        sorted_ids = (keys & 0xFFFFFFFF).to(torch.int32)
        del keys
        d = dir_lib.build_range(sorted_subs, cfg.s_bits, pbits=pbits)
        tables.append(MIHTable(entry_ids=sorted_ids, directory=d,
                               entry_rows=make_entry_rows(sorted_ids, codes)))
    return MIHIndex(cfg=cfg, tables=tables, n=n, codes=codes)


def index_from_arrays(arrays: Mapping[str, np.ndarray],
                      device=None) -> MIHIndex:
    """The JAX package's index, as the numpy arrays its ``save_index``
    writes (``np.load`` of that file), as a port index on ``device``.

    Keys: ``n``, ``bits``, ``n_tables``, ``codes`` (optional), and per
    table ``t{t}_se``, ``t{t}_rows`` and ``t{t}_ids`` (optional). Range
    tables with inline rows only."""
    cfg = MIHConfig(bits=int(arrays["bits"]), n_tables=int(arrays["n_tables"]))
    n = int(arrays["n"])
    want = entry_block_size(cfg.n_words) * _row_width(cfg.n_words)
    tables = []
    for t in range(cfg.n_tables):
        if f"t{t}_se" not in arrays or f"t{t}_rows" not in arrays:
            raise NotImplementedError(
                f"table {t} is not a range table with inline entry rows; "
                "other layouts are ROADMAP.md Queue 1 items 7 and 8")
        rows = np.asarray(arrays[f"t{t}_rows"])
        if rows.ndim != 2 or rows.shape[1] != want:
            raise ValueError(f"t{t}_rows has shape {rows.shape}; the "
                             f"blocked layout has {want} words per row")
        se = torch.from_numpy(np.ascontiguousarray(arrays[f"t{t}_se"],
                                                   np.int32)).to(device)
        ids = (bits_lib.as_codes(arrays[f"t{t}_ids"], device)
               if f"t{t}_ids" in arrays else None)
        tables.append(MIHTable(
            entry_ids=ids,
            directory=dir_lib.RangeDirectory(se=se, s_bits=cfg.s_bits),
            entry_rows=bits_lib.as_codes(rows, device)))
    codes = (bits_lib.as_codes(arrays["codes"], device)
             if "codes" in arrays else None)
    return MIHIndex(cfg=cfg, tables=tables, n=n, codes=codes)
